"""Clip-sampling data loader: video corpus → batched device tensors — the
counterpart of the JAX package's ``data/loader.py``.

Per batch:

  sample (file, start) windows → seek + decode ``clip_len`` frames a clip
  into packed YUV420 slots of a host ring (the native decoder writes
  straight into the slot; on CUDA the ring is pinned memory) → ONE
  non-blocking host→device copy of the flat [B·T, rows, W] batch on a side
  stream → ONE post-processing call on the current stream (the fused CUDA
  kernel through ``FusedPipeline``, or ``AugmentPipeline``) → reshape to
  [B, T, ...].

A CUDA event recorded after the copy is the barrier before the slot is
decoded into again; the current stream waits on the same event before the
post-processing, so nothing on the host waits for the device except that
recycle. On the CPU the batch is copied out of the slot, since
``torch.from_numpy`` would alias it.

Determinism: sampling is a pure function of (seed, epoch); with worker
threads clips decode concurrently but are yielded in sample order, so the
batch stream is the same on any worker count, and equals the JAX package's
windows, frames and labels for the same (seed, epoch).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..core import geometry
from ..core.enums import ColorRange, ColorSpace, PixelFormat
from ..core.exceptions import UnseekableInputError
from ..utils.device import resolve_device, upload
from ..utils.tracing import StageTimer

__all__ = ["VideoCorpus", "ClipSampler", "VideoClipLoader", "HostClipLoader"]


@dataclass(frozen=True)
class StreamInfo:
    path: str
    width: int
    height: int
    num_frames: int
    color_space: ColorSpace
    color_range: ColorRange
    is_vfr: bool


class VideoCorpus:
    """Probe a set of video files once and pin the shared geometry.

    All files share (width, height): one loader runs one batch shape
    (bucket mixed sizes with :class:`~.bucketed.BucketedClipLoader`).
    Colorimetry may vary per file; the loader resolves it to one (space,
    range), the corpus majority unless overridden.

    ``lengths``: optional explicit frame counts (containers that declare
    no ``nb_frames`` probe as 0 and are rejected without one).
    """

    def __init__(self, sources: Sequence[str],
                 lengths: Optional[Sequence[int]] = None):
        from ..io.demuxer import FFmpegDemuxer

        if not sources:
            raise ValueError("empty corpus")
        streams = []
        for i, src in enumerate(sources):
            d = FFmpegDemuxer(src)
            try:
                n = int(d.num_frames)
                if lengths is not None and lengths[i]:
                    n = int(lengths[i])
                if n <= 0:
                    raise ValueError(
                        f"{src}: container declares no frame count; pass "
                        f"lengths=[...] to VideoCorpus")
                streams.append(StreamInfo(
                    path=src, width=d.width, height=d.height, num_frames=n,
                    color_space=d.color_space, color_range=d.color_range,
                    is_vfr=d.is_vfr))
            finally:
                d.close()
        self._set_streams(streams)

    @classmethod
    def from_streams(cls, streams: Sequence[StreamInfo]) -> "VideoCorpus":
        """A corpus of already-described streams (no probing)."""
        corpus = cls.__new__(cls)
        corpus._set_streams(list(streams))
        return corpus

    def _set_streams(self, streams: list) -> None:
        w0, h0 = streams[0].width, streams[0].height
        for s in streams:
            if (s.width, s.height) != (w0, h0):
                raise ValueError(
                    f"corpus geometry mismatch: {s.path} is "
                    f"{s.width}x{s.height}, expected {w0}x{h0} — bucket "
                    f"sources by size (one loader per bucket)")
        self.streams = streams
        self.width, self.height = w0, h0
        self._kf_cache: dict = {}

    def __len__(self) -> int:
        return len(self.streams)

    def keyframe_indices(self, file_index: int) -> np.ndarray:
        """Display-order frame indices of the stream's keyframes, from one
        demux-only pass (cached per file): packets arrive in decode order,
        so a keyframe's display index is its rank by pts."""
        if file_index in self._kf_cache:
            return self._kf_cache[file_index]
        from ..io.demuxer import FFmpegDemuxer

        d = FFmpegDemuxer(self.streams[file_index].path)
        pts, keys = [], []
        try:
            for r in d:
                pts.append(r.pkt_data.pts)
                keys.append(bool(r.pkt_data.key))
        finally:
            d.close()
        order = np.argsort(np.asarray(pts, np.int64), kind="stable")
        idx = np.flatnonzero(np.asarray(keys, bool)[order]).astype(np.int64)
        self._kf_cache[file_index] = idx
        return idx

    def majority_colorimetry(self) -> tuple:
        """Most common (space, range) pair; UNSPEC/UDEF resolve to the
        BT.601/MPEG defaults the reference's converters assume."""
        from collections import Counter

        pairs = Counter()
        for s in self.streams:
            sp = ColorSpace.BT_601 if s.color_space == ColorSpace.UNSPEC \
                else s.color_space
            rg = ColorRange.MPEG if s.color_range == ColorRange.UDEF \
                else s.color_range
            pairs[(sp, rg)] += 1
        return pairs.most_common(1)[0][0]


class ClipSampler:
    """Deterministic shuffled enumeration of clip windows.

    The index space is every (file, start) with ``start ∈ {0, hop, 2·hop,
    …}`` whose last frame ``start + (clip_len-1)·stride`` is in range (or
    the given ``starts_per_file``). ``epoch(e)`` permutes the windows by a
    pure function of ``(seed, e)`` — numpy's, as in the JAX package, so
    both give the same order.
    """

    def __init__(self, corpus: VideoCorpus, clip_len: int, stride: int = 1,
                 hop: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0, starts_per_file: Optional[Sequence] = None):
        if clip_len < 1 or stride < 1:
            raise ValueError("clip_len and stride must be >= 1")
        self.clip_len = clip_len
        self.stride = stride
        self.span = span = (clip_len - 1) * stride + 1
        self.hop = int(hop) if hop is not None else span
        if self.hop < 1:
            raise ValueError("hop must be >= 1")
        self.shuffle = shuffle
        self.seed = int(seed)
        windows = []
        for fi, s in enumerate(corpus.streams):
            last_start = s.num_frames - span
            if starts_per_file is not None:
                windows += [(fi, int(st)) for st in starts_per_file[fi]
                            if 0 <= int(st) <= last_start]
            else:
                windows += [(fi, st)
                            for st in range(0, last_start + 1, self.hop)]
        if not windows:
            raise ValueError(
                f"no clip of span {span} fits any corpus stream (shortest "
                f"has {min(s.num_frames for s in corpus.streams)} frames)")
        self._windows = np.asarray(windows, np.int64)

    def __len__(self) -> int:
        return len(self._windows)

    def epoch(self, epoch: int = 0) -> np.ndarray:
        """[(file_idx, start), …] for one epoch, shuffled per (seed, epoch)."""
        if not self.shuffle:
            return self._windows
        rng = np.random.default_rng((self.seed, int(epoch)))
        return self._windows[rng.permutation(len(self._windows))]


class _ClipReader:
    """One source: sequential-aware clip extraction.

    Tracks the next frame index, so back-to-back windows decode without a
    seek; any other start seeks to the previous keyframe and decodes to
    the target. An input that refuses the seek (UnseekableInputError: a
    raw elementary stream) is read forward instead, after reopening the
    session for a rewind; any other error propagates.
    """

    def __init__(self, path: str, out_format: PixelFormat, threads: int):
        self.path = path
        self.out_format = out_format
        self.threads = threads
        self._open()

    def _open(self) -> None:
        from ..io.decoder import VideoReader

        self.reader = VideoReader(self.path, threads=self.threads)
        self.reader.decoder.output_format = self.out_format
        self.next_idx = 0

    def _reopen(self) -> None:
        """A fresh session at frame 0: the rewind of an unseekable input."""
        self.reader.decoder.close()
        self.reader.demuxer.close()
        self._open()

    def read_clip(self, start: int, clip_len: int, stride: int,
                  out: np.ndarray) -> tuple:
        """Decode frames start, start+stride, … into ``out[t]``.

        Returns ``(kept, skipped, seeks)``: ``skipped`` counts frames
        decoded and discarded (stride gaps and the GOP replay of a
        seek)."""
        from ..core.packet import SeekContext

        t = seeks = skipped = pre_skip = 0
        if start != self.next_idx:
            seeks = 1
            ctx = SeekContext(seek_frame=int(start))
            try:
                f = self.reader.decode(seek_ctx=ctx, out=out[0])
            except UnseekableInputError:
                if start < self.next_idx:
                    self._reopen()
                pre_skip = start - self.next_idx
            else:
                if f is None:
                    raise RuntimeError(
                        f"{self.path}: seek to frame {start} hit EOF")
                skipped += max(0, int(ctx.num_frames_decoded) - 1)
                self.next_idx = start + 1
                t = 1
        n_want = clip_len - t
        if n_want > 0:
            skip_first = (stride - 1) if t else pre_skip
            kept = self._read_seq(out[t:], n_want, stride, skip_first)
            if kept < n_want:
                raise RuntimeError(
                    f"{self.path}: EOF inside clip [{start}, +{clip_len}x"
                    f"{stride}] — container frame count was optimistic; "
                    f"pass lengths= to VideoCorpus")
            self.next_idx += skip_first + 1 + (kept - 1) * stride
            skipped += skip_first + (kept - 1) * (stride - 1)
        return clip_len, skipped, seeks

    def _read_seq(self, dst: np.ndarray, n_want: int, stride: int,
                  skip_first: int) -> int:
        """One native call (``vpf_read_frames_seq``: demux → decode →
        pack) into ``dst``, a [n, rows, W] view of the ring slot."""
        import ctypes as C

        from ..core.exceptions import (
            BitstreamParserException,
            HwResetException,
        )
        from ..io import _lib

        lib = _lib.load()
        dec = self.reader.decoder
        r = lib.vpf_read_frames_seq(
            self.reader.demuxer._h, dec._h, int(dec.output_format),
            dst.ctypes.data_as(C.POINTER(C.c_uint8)), int(dst[0].nbytes),
            int(n_want), int(stride), int(skip_first))
        if r >= 0:
            return int(r)
        if r == _lib.ERR_PARSE:
            raise BitstreamParserException(_lib.last_error())
        if r == _lib.ERR_DECODE:
            lib.vpf_decoder_recreate(dec._h)
            raise HwResetException(_lib.last_error())
        raise RuntimeError(_lib.last_error())


class _ClipLoaderBase:
    """Shared epoch machinery of the clip loaders.

    Subclasses set ``self.corpus`` and provide
    ``_batches_of_clips(samples)`` yielding ``(slot, filled_count,
    file_indices)`` after writing the clips into ring slot ``slot`` (taken
    from ``self._free``). The base holds the sampler, the pipeline, the
    pinned ring, the dispatch (one upload + one post-processing call), the
    prefetch/recycle loop, labels, shard splitting and mid-epoch
    ``state_dict``/``load_state_dict``.
    """

    def _init_common(self, *, clip_len, frame_stride, batch_size, shuffle,
                     seed, hop, drop_last, workers, prefetch, device,
                     shard_index, shard_count, labels, sharding=None,
                     sampler_starts=None) -> None:
        self.sharding = sharding
        if sharding is not None:
            # one rank a device: this rank's loader is the shard at its
            # place on the batch axis, on its own device
            mine = (sharding.batch_index, sharding.batch_ranks)
            if (shard_index, shard_count) == (0, 1):
                shard_index, shard_count = mine
            elif (shard_index, shard_count) != mine:
                raise ValueError(
                    f"shard_index/shard_count ({shard_index}, {shard_count}) "
                    f"disagree with the sharding's {mine}")
            if device is None:
                from ..parallel.mesh import mesh_device

                device = mesh_device(sharding.mesh)
        if not (0 <= shard_index < shard_count):
            raise ValueError("need 0 <= shard_index < shard_count")
        self.sampler = ClipSampler(
            self.corpus, clip_len, frame_stride, hop=hop, shuffle=shuffle,
            seed=seed, starts_per_file=sampler_starts)
        self.clip_len = clip_len
        self.frame_stride = frame_stride
        self.batch_size = int(batch_size)
        self.drop_last = bool(drop_last)
        self.shard_index, self.shard_count = int(shard_index), int(shard_count)
        self.device = resolve_device(device)
        ncpu = os.cpu_count() or 1
        self.workers = (int(workers) if workers > 0
                        else (1 if ncpu == 1 else min(self.batch_size, ncpu)))
        self.prefetch = 1 if ncpu == 1 else max(1, int(prefetch))
        # frame-number seeks happen whenever a reader's access is not
        # strictly sequential
        needs_seek = (shuffle or self.sampler.hop != self.sampler.span
                      or self.workers > 1)
        vfr = [s.path for s in self.corpus.streams if s.is_vfr]
        if needs_seek and vfr:
            raise ValueError(
                "random clip access seeks by frame number, which VFR "
                "streams don't support (reference contract: 'Can't seek by "
                "frame number in VFR streams') — use shuffle=False with "
                f"contiguous hop and workers=1, or re-mux: {vfr}")
        if labels is not None and len(labels) != len(self.corpus):
            raise ValueError(
                f"{len(labels)} labels for {len(self.corpus)} corpus files")
        self.labels = np.asarray(labels) if labels is not None else None
        self._epoch = 0
        self._resume_clips = 0  # one-shot skip set by load_state_dict
        # decode (incl. GOP replay, counted apart), dispatch (upload +
        # post-processing enqueue) and drain (the slot-recycle barrier)
        self.timer = StageTimer("loader")
        self._lock = threading.Lock()
        self.frame_stats = {"kept": 0, "replayed": 0, "seeks": 0}
        self._slots: list = []
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def _init_packed_rows(self) -> None:
        """``self._rows``: rows of one packed YUV420 frame in the ring (the
        pixel loaders' layout; even dimensions only)."""
        w, h = self.corpus.width, self.corpus.height
        if w % 2 or h % 2:
            raise ValueError(
                f"YUV420 packing needs even dimensions, corpus is {w}x{h}")
        self._rows = geometry.host_frame_size(PixelFormat.YUV420, w, h) // w

    def _init_pipeline(self, *, out_size, output, method, kernel, compute,
                       augment, color_space, color_range, seed) -> None:
        """``self.pipeline``: None for ``packed``, an AugmentPipeline with
        ``augment``, else FusedPipeline(kernel)."""
        w, h = self.corpus.width, self.corpus.height
        sp, rg = self.corpus.majority_colorimetry()
        self.color_space = color_space if color_space is not None else sp
        self.color_range = color_range if color_range is not None else rg
        self._augmented = augment is not None
        oh, ow = out_size or (h, w)
        if output == "packed":
            if self._augmented:
                raise ValueError(
                    "augment= needs a postproc output mode (rgb_u8/rgb_f32/"
                    "normalized/normalized_nchw), not 'packed'")
            self.pipeline = None
        elif self._augmented:
            from ..ops.augment import AugmentPipeline, AugmentSpec

            if not isinstance(augment, AugmentSpec):
                raise TypeError(
                    f"augment must be an AugmentSpec, got {type(augment)!r}")
            if kernel == "cuda" or compute == "split_bf16":
                # per-clip matrices: the fused kernel (one matrix pair a
                # call) and the split-bf16 constant decomposition do not
                # apply
                raise ValueError(
                    "augment= runs the batched-matrix torch path in float32;"
                    " kernel='cuda' / compute='split_bf16' are not "
                    "available with it")
            self.pipeline = AugmentPipeline(
                PixelFormat.YUV420, self.color_space, self.color_range,
                out_size=(ow, oh), spec=augment, clip_len=self.clip_len,
                method=method, output=output, seed=seed, device=self.device)
        else:
            from ..ops.fused import FusedPipeline

            self.pipeline = FusedPipeline(
                PixelFormat.YUV420, self.color_space, self.color_range,
                out_size=(ow, oh), method=method, output=output,
                device=self.device, kernel=kernel, compute=compute)

    def _note_clip(self, kept: int, skipped: int, seeks: int) -> None:
        with self._lock:
            st = self.frame_stats
            st["kept"] += kept
            st["replayed"] += skipped
            st["seeks"] += seeks

    def stage_summary(self) -> dict:
        """Mean/total wall clock per stage plus the decode-side frame
        accounting (kept vs replayed-and-discarded)."""
        out = dict(self.timer.summary())
        kept, replayed = self.frame_stats["kept"], self.frame_stats["replayed"]
        out["frames"] = dict(self.frame_stats,
                             replay_overhead=replayed / kept if kept else 0.0,
                             decoded_total=kept + replayed)
        return out

    def _shard_clips(self, n: int) -> int:
        """Clips of an ``n``-clip epoch that this shard takes: every
        ``shard_count``-th; with ``sharding`` every rank takes the same
        number (the ranks stay in lockstep)."""
        if self.sharding is not None:
            return n // self.shard_count
        return (n - self.shard_index + self.shard_count - 1) // self.shard_count

    def __len__(self) -> int:
        """Batches per epoch for THIS shard."""
        mine = self._shard_clips(len(self.sampler))
        if self.drop_last:
            return mine // self.batch_size
        return (mine + self.batch_size - 1) // self.batch_size

    @property
    def clips_per_epoch(self) -> int:
        return len(self.sampler)

    # -- the host ring and the device stage ----------------------------------

    def _open_ring(self) -> list:
        """numpy views of the ring's ``prefetch + 1`` reusable [B, T,
        rows, W] uint8 slots (pinned on CUDA, so each batch's upload is
        one DMA straight from its slot), allocated once per loader; every
        slot starts free (``self._free``)."""
        count = self.prefetch + 1
        if len(self._slots) < count:
            shape = (self.batch_size, self.clip_len, self._rows,
                     self.corpus.width)
            pin = self.device.type == "cuda"
            self._slots = [torch.zeros(shape, dtype=torch.uint8,
                                       pin_memory=pin) for _ in range(count)]
        self._free = list(range(count))
        return [s.numpy() for s in self._slots]

    def _batch_labels(self, files: list):
        return (self.labels[np.asarray(files)]
                if self.labels is not None else None)

    def _dispatch(self, slot: int, count: int, files: list) -> tuple:
        """Slot → device (one copy) → the pipeline; returns ``(out,
        labels, count, slot, uploaded)``, where ``uploaded`` (an event on
        CUDA, else None) is the slot's recycle barrier."""
        labels = self._batch_labels(files)
        host = self._slots[slot][:count].view(-1, self._rows,
                                              self.corpus.width)
        (staged,), uploaded = upload([host], self.device, self._copy_stream)
        if self.pipeline is None:
            out = staged
        elif self._augmented:
            idx = self._dispatch_index
            self._dispatch_index += 1
            # globally unique across shards: shards share the seed
            # (disjoint samples need one permutation), so a bare batch
            # index would give every shard the same augmentations
            out = self.pipeline(
                staged, epoch=self._dispatch_epoch,
                batch_index=idx * self.shard_count + self.shard_index)
        else:
            out = self.pipeline(staged)
        return out, labels, count, slot, uploaded

    def epoch(self, epoch: Optional[int] = None) -> Iterator:
        """Yield ``[B, T, ...]`` device batches (``(batch, labels)`` pairs
        when the loader has labels) for one epoch."""
        e = self._epoch if epoch is None else int(epoch)
        samples = self.sampler.epoch(e)
        if self.shard_count > 1:
            samples = samples[self.shard_index::self.shard_count][
                :self._shard_clips(len(samples))]
        skip = min(self._resume_clips, len(samples))
        self._resume_clips = 0
        self._pos = [e, skip]
        # the augmentation counter resumes exactly: every resume point
        # sits after whole batches
        self._dispatch_epoch = e
        self._dispatch_index = skip // self.batch_size
        samples = samples[skip:]
        T = self.clip_len

        def finish(disp):
            out, labels, b, slot, uploaded = disp
            with self.timer.measure("drain"):
                if uploaded is not None:
                    uploaded.synchronize()  # the slot's copy is over
            self._free.append(slot)
            if isinstance(out, tuple):  # planes
                out = tuple(o.reshape((b, T) + tuple(o.shape[1:]))
                            for o in out)
            else:
                out = out.reshape((b, T) + tuple(out.shape[1:]))
            if self.sharding is not None:
                out, labels = self._globalize(out, labels)
            self._pos[1] += b
            return (out, labels) if labels is not None else out

        inflight: list = []
        try:
            for slot, count, files in self._batches_of_clips(samples):
                if count < self.batch_size and self.drop_last:
                    self._free.append(slot)
                    continue
                if count < self.batch_size and self.sharding is not None:
                    self._free.append(slot)
                    raise ValueError(
                        f"clip batch of {count} clips does not fill this "
                        f"rank's {self.batch_size}: every rank's batch of a "
                        "sharded loader must be full (use drop_last=True to "
                        "keep batches full)")
                with self.timer.measure("dispatch"):
                    inflight.append(self._dispatch(slot, count, files))
                if len(inflight) >= self.prefetch:
                    yield finish(inflight.pop(0))
            while inflight:
                yield finish(inflight.pop(0))
        finally:
            # an epoch left early: no slot is decoded into again while
            # its copy may still read it
            for disp in inflight:
                if disp[4] is not None:
                    disp[4].synchronize()

    def _globalize(self, out, labels):
        """This rank's batch (and labels) as ``DTensor``s sharded on dim 0
        over the batch axis: the global batch is every rank's batch in
        rank order."""
        from ..parallel.mesh import place_local, wrap_local

        sh = self.sharding
        out = (tuple(wrap_local(o, sh) for o in out)
               if isinstance(out, tuple) else wrap_local(out, sh))
        if labels is not None:
            labels = place_local(np.asarray(labels), sh)
        return out, labels

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator:
        it = self.epoch(self._epoch)
        self._epoch += 1
        return it

    # -- checkpoint/resume ---------------------------------------------------

    def state_dict(self) -> dict:
        """Position after the last yielded batch: resume-exact."""
        e, clips = getattr(self, "_pos", [self._epoch, 0])
        return {"epoch": int(e), "clips": int(clips)}

    def load_state_dict(self, state: dict) -> None:
        """Arm the loader so the next :meth:`epoch` / ``iter()`` resumes
        exactly after the checkpointed batch (same seed and
        configuration)."""
        self._epoch = int(state["epoch"])
        self._resume_clips = int(state["clips"])


class VideoClipLoader(_ClipLoaderBase):
    """Corpus → shuffled clip batches on ``device``: ``[B, T, ...]``.

    ``output``: a :class:`~..ops.fused.FusedPipeline` mode (``rgb_u8`` /
    ``rgb_f32`` / ``normalized`` / ``normalized_nchw``), run as one call
    over the flat [B·T] batch — the fused CUDA kernel on the card with
    ``kernel="auto"`` — or ``"packed"`` for the uploaded YUV420 batches.

    ``device``: CUDA by default; ``"cpu"`` runs the torch path on the CPU.

    ``shard_index``/``shard_count``: each process takes every
    ``shard_count``-th sample of the same epoch permutation.

    ``sharding``: a :class:`~..parallel.mesh.Sharding` (e.g.
    ``batch_sharding(mesh)``). Under one rank a device, each rank's loader
    is the shard at the rank's place on the batch axis (``shard_index``
    and ``shard_count`` from the mesh), on the rank's device; each batch
    (and its labels) comes out, after the pipeline, as a ``DTensor``
    sharded on dim 0: the global batch is the ranks' batches in rank
    order. Every rank takes the same number of clips an epoch, and a
    batch that is not full raises ``ValueError`` (use ``drop_last=True``).
    (The JAX package's ``sharding`` splits one process's batch over its
    local devices instead.)

    ``workers``: decode threads; 0 = min(batch, cores), serial on one
    core. The output is identical on every worker count.

    ``labels``: one per corpus file; batches are then ``(tensor,
    labels)`` pairs, the labels a host numpy array [B].

    ``augment``: an :class:`~..ops.augment.AugmentSpec` — random resized
    crop / h-flip / colour jitter in the post-processing, with per-clip
    params from (seed, epoch, batch index): deterministic and
    resume-exact. Needs a post-processing ``output``.

    :meth:`state_dict` / :meth:`load_state_dict` resume mid-epoch exactly.
    """

    def __init__(
        self,
        sources,
        clip_len: int = 8,
        frame_stride: int = 1,
        batch_size: int = 4,
        out_size: Optional[tuple] = None,  # (height, width)
        output: str = "normalized",
        method: str = "lanczos",
        shuffle: bool = True,
        seed: int = 0,
        hop: Optional[int] = None,
        drop_last: bool = False,
        workers: int = 0,
        prefetch: int = 2,
        device=None,
        shard_index: int = 0,
        shard_count: int = 1,
        color_space: Optional[ColorSpace] = None,
        color_range: Optional[ColorRange] = None,
        decode_threads: int = 0,
        kernel: str = "auto",
        compute: str = "auto",
        lengths: Optional[Sequence[int]] = None,
        labels: Optional[Sequence] = None,
        align_keyframes: bool = False,
        augment=None,
        sharding=None,
    ):
        if isinstance(sources, VideoCorpus):
            self.corpus = sources
        else:
            if isinstance(sources, (str, os.PathLike)):
                sources = [sources]
            self.corpus = VideoCorpus([str(s) for s in sources],
                                      lengths=lengths)
        starts = None
        if align_keyframes:
            # keyframe-aligned windows make every seek land on its first
            # frame (no GOP replay); one demux-only pass per file
            starts = [self.corpus.keyframe_indices(fi)
                      for fi in range(len(self.corpus))]
        self._init_common(
            clip_len=clip_len, frame_stride=frame_stride,
            batch_size=batch_size, shuffle=shuffle, seed=seed, hop=hop,
            drop_last=drop_last, workers=workers, prefetch=prefetch,
            device=device, shard_index=shard_index, shard_count=shard_count,
            labels=labels, sharding=sharding, sampler_starts=starts)
        self._init_packed_rows()
        self.decode_threads = decode_threads
        self._init_pipeline(
            out_size=out_size, output=output, method=method, kernel=kernel,
            compute=compute, augment=augment, color_space=color_space,
            color_range=color_range, seed=seed)

    def _reader_for(self, cache: dict, fi: int) -> _ClipReader:
        rd = cache.get(fi)
        if rd is None:
            rd = cache[fi] = _ClipReader(self.corpus.streams[fi].path,
                                         PixelFormat.YUV420,
                                         self.decode_threads)
        return rd

    def _batches_of_clips(self, samples: np.ndarray) -> Iterator:
        """Decode each batch straight into a free ring slot; ``epoch``
        returns the slot to ``self._free`` once its upload is over."""
        B, T = self.batch_size, self.clip_len
        slots = self._open_ring()
        free = self._free
        groups = [samples[i: i + B] for i in range(0, len(samples), B)]

        if self.workers <= 1:
            # readers persist across epochs: a session costs ~10-30 ms a
            # file, and the sequential no-seek path survives the boundary
            cache = getattr(self, "_reader_cache", None)
            if cache is None:
                cache = self._reader_cache = {}
            for grp in groups:
                if not free:
                    raise RuntimeError("batch ring exhausted")
                slot = free.pop(0)
                with self.timer.measure("decode"):
                    for s, (fi, start) in enumerate(grp):
                        self._note_clip(*self._reader_for(
                            cache, int(fi)).read_clip(
                            int(start), T, self.frame_stride, slots[slot][s]))
                yield slot, len(grp), [int(fi) for fi, _ in grp]
            return

        # the B clips of a batch decode concurrently (per-thread reader
        # caches; native decode releases the GIL)
        from concurrent.futures import ThreadPoolExecutor

        local = threading.local()

        def one(args):
            dst, fi, start = args
            cache = getattr(local, "cache", None)
            if cache is None:
                cache = local.cache = {}
            self._note_clip(*self._reader_for(cache, int(fi)).read_clip(
                int(start), T, self.frame_stride, dst))

        with ThreadPoolExecutor(max_workers=self.workers) as ex:
            for grp in groups:
                if not free:
                    raise RuntimeError("batch ring exhausted")
                slot = free.pop(0)
                with self.timer.measure("decode"):
                    list(ex.map(one, [(slots[slot][s], int(fi), int(start))
                                      for s, (fi, start) in enumerate(grp)]))
                yield slot, len(grp), [int(fi) for fi, _ in grp]


def seeded_frames(n: int, rows: int, width: int, seed: int) -> np.ndarray:
    """``n`` seeded packed YUV420 frames (n, rows, width) u8: noise over a
    coarse pattern of 27 × 32 blocks, so frames still differ after a
    resize to model size, as real ones do (noise alone averages to grey)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 128, (n, rows, width), np.uint8)
    coarse = rng.integers(0, 128, (n, 27, 32), np.uint8)
    frames += coarse[:, (np.arange(rows) * 27) // rows][
        :, :, (np.arange(width) * 32) // width]
    return frames


class HostClipLoader(_ClipLoaderBase):
    """The clip loader over seeded frames held in host memory: the same
    sampler, ring, upload, pipeline, prefetch and resume as
    :class:`VideoClipLoader`, with a copy of each window's frames into the
    ring slot where that loader decodes.

    It stands in for the decode stage where the libav runtime cannot be
    built, so the training path still runs at the real clip and frame
    size; it decodes nothing. Stream ``k`` holds ``frames_per_stream``
    frames drawn from seed ``seed + k`` (see :func:`seeded_frames`),
    BT.709 / MPEG, its luma a quarter of the range wide at a level of its
    own (40 to 190), so a model can learn which stream a clip came from.
    Takes :class:`VideoClipLoader`'s keywords from ``clip_len`` on, except
    the decode ones.
    """

    def __init__(self, width: int, height: int, n_streams: int,
                 frames_per_stream: int, clip_len: int = 8,
                 frame_stride: int = 1, batch_size: int = 4,
                 out_size: Optional[tuple] = None, output: str = "normalized",
                 method: str = "lanczos", shuffle: bool = True,
                 seed: int = 0, hop: Optional[int] = None,
                 drop_last: bool = False, prefetch: int = 2, device=None,
                 shard_index: int = 0, shard_count: int = 1,
                 kernel: str = "auto", compute: str = "auto",
                 labels: Optional[Sequence] = None, augment=None,
                 sharding=None):
        self.corpus = VideoCorpus.from_streams([
            StreamInfo(path=f"seeded:{seed + k}", width=width, height=height,
                       num_frames=frames_per_stream,
                       color_space=ColorSpace.BT_709,
                       color_range=ColorRange.MPEG, is_vfr=False)
            for k in range(n_streams)])
        self._init_common(
            clip_len=clip_len, frame_stride=frame_stride,
            batch_size=batch_size, shuffle=shuffle, seed=seed, hop=hop,
            drop_last=drop_last, workers=1, prefetch=prefetch, device=device,
            shard_index=shard_index, shard_count=shard_count, labels=labels,
            sharding=sharding)
        self._init_packed_rows()
        self.frames = np.stack([
            seeded_frames(frames_per_stream, self._rows, width, seed + k)
            for k in range(n_streams)])
        for k in range(n_streams):
            luma = self.frames[k, :, :height]
            luma[:] = luma // 4 + 40 + (150 * k) // max(1, n_streams - 1)
        self._init_pipeline(
            out_size=out_size, output=output, method=method, kernel=kernel,
            compute=compute, augment=augment, color_space=None,
            color_range=None, seed=seed)

    def _batches_of_clips(self, samples: np.ndarray) -> Iterator:
        B, T, step = self.batch_size, self.clip_len, self.frame_stride
        slots = self._open_ring()
        free = self._free
        for i in range(0, len(samples), B):
            grp = samples[i: i + B]
            if not free:
                raise RuntimeError("batch ring exhausted")
            slot = free.pop(0)
            with self.timer.measure("decode"):
                for s, (fi, start) in enumerate(grp):
                    slots[slot][s] = self.frames[fi, start:start + T * step:
                                                 step]
                    self._note_clip(T, 0, 0)
            yield slot, len(grp), [int(fi) for fi, _ in grp]
