"""Mixed-resolution corpora: bucket by geometry, one loader per bucket —
the counterpart of the JAX package's ``data/bucketed.py``.

One loader runs one batch shape, so :class:`BucketedClipLoader` groups the
files by geometry, builds one :class:`~.loader.VideoClipLoader` (or
``loader_cls``, e.g. :class:`~.mjpeg.MjpegClipLoader`) per bucket (each
with its own ring) and interleaves their batch streams by a pure
function of (seed, epoch): batches are drawn from the buckets in
proportion to their remaining size, and every file is consumed once per
epoch. A shared ``out_size`` makes every bucket emit one output shape.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .loader import VideoClipLoader

__all__ = ["BucketedClipLoader"]


class BucketedClipLoader:
    """Clip loader over a mixed-geometry corpus.

    Takes :class:`VideoClipLoader`'s keywords; ``out_size`` is required
    and ``output="packed"`` is refused (both keep the merged stream one
    shape). ``labels`` align with ``sources``. ``loader_cls``: the loader
    of each bucket, ``VideoClipLoader`` when None, or ``MjpegClipLoader``
    for MJPEG corpora (the same constructor contract). ``sharding=``
    passes to every bucket's loader: each bucket yields the same number
    of batches on every rank and the schedule is the same, so the ranks
    stay in lockstep.
    """

    def __init__(self, sources: Sequence[str], out_size: tuple,
                 labels: Optional[Sequence] = None,
                 lengths: Optional[Sequence[int]] = None, seed: int = 0,
                 loader_cls=None, **kw):
        if kw.get("output", "normalized") == "packed":
            raise ValueError(
                "packed output is per-geometry; use out_size-normalizing "
                "modes with BucketedClipLoader (or one VideoClipLoader per "
                "geometry)")
        from ..io.demuxer import FFmpegDemuxer

        sources = [str(s) for s in sources]
        buckets: dict = {}
        for i, src in enumerate(sources):
            d = FFmpegDemuxer(src)
            try:
                buckets.setdefault((d.width, d.height), []).append(i)
            finally:
                d.close()
        self.seed = int(seed)
        if loader_cls is None:
            loader_cls = VideoClipLoader
        self.loaders: list = []
        self.bucket_files: list = []
        for geo in sorted(buckets):
            idxs = buckets[geo]
            self.loaders.append(loader_cls(
                [sources[i] for i in idxs], out_size=out_size,
                labels=None if labels is None else [labels[i] for i in idxs],
                lengths=None if lengths is None else [lengths[i]
                                                      for i in idxs],
                seed=self.seed + len(self.loaders), **kw))
            self.bucket_files.append(idxs)
        self._epoch = 0
        self._resume_batches = 0

    def __len__(self) -> int:
        return sum(len(ld) for ld in self.loaders)

    @property
    def clips_per_epoch(self) -> int:
        return sum(ld.clips_per_epoch for ld in self.loaders)

    def _schedule(self, epoch: int) -> np.ndarray:
        """Deterministic interleave: a shuffled multiset of bucket ids,
        one entry a batch (the JAX package's, for the same seed)."""
        ids = np.concatenate([np.full(len(ld), i, np.int64)
                              for i, ld in enumerate(self.loaders)])
        rng = np.random.default_rng((self.seed, int(epoch), 0xB))
        return ids[rng.permutation(len(ids))]

    def epoch(self, epoch: Optional[int] = None):
        e = self._epoch if epoch is None else int(epoch)
        sched = self._schedule(e)
        skip = min(self._resume_batches, len(sched))
        self._resume_batches = 0
        # arm each sub-loader past its consumed clips; a bucket's last
        # batch can be ragged, so clamp to its shard-local clip count
        consumed = np.bincount(sched[:skip], minlength=len(self.loaders))
        for i, ld in enumerate(self.loaders):
            ld.load_state_dict({"epoch": e, "clips": min(
                int(consumed[i]) * ld.batch_size,
                ld._shard_clips(len(ld.sampler)))})
        self._pos = [e, skip]
        iters = [iter(ld.epoch()) for ld in self.loaders]
        for b in sched[skip:]:
            out = next(iters[b])
            self._pos[1] += 1
            yield out

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __iter__(self):
        it = self.epoch(self._epoch)
        self._epoch += 1
        return it

    def state_dict(self) -> dict:
        """Position after the last yielded batch (batch-granular)."""
        e, batches = getattr(self, "_pos", [self._epoch, 0])
        return {"epoch": int(e), "batches": int(batches)}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._resume_batches = int(state["batches"])
