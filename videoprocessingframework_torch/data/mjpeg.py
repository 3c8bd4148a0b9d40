"""Training clips from MJPEG corpora through the split codec — the
counterpart of the JAX package's ``data/mjpeg.py``.

Every MJPEG frame is a standalone JPEG, so a shuffled clip costs its own
frames only: a seek lands on its first frame with no replay, and frames a
``frame_stride`` skips are demuxed but never entropy-decoded. Packets
entropy-decode on the host (``libvpf_jpeg``, GIL-free) straight into
per-component int16 coefficient slots of a ring (pinned on CUDA); each
batch goes to the device by one copy a component on a side stream, and
one :class:`~..ops.jpeg.JpegDevicePipeline` call runs dequant + IDCT +
resize + CSC + normalize (the band kernel for 4:2:0 on the card) →
``[B, T, ...]``. The copy's CUDA event is the slot's recycle barrier.
Demuxing needs the libav runtime.
"""

from __future__ import annotations

import os
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..core.enums import CodecId, SeekMode
from ..core.packet import SeekContext
from ..utils.device import upload
from .loader import VideoCorpus, _ClipLoaderBase

__all__ = ["MjpegClipLoader"]


class _JpegClipReader:
    """One MJPEG source: random-access clip extraction to coefficients."""

    def __init__(self, path: str):
        from ..io.demuxer import FFmpegDemuxer
        from ..io.jpeg import JpegCoefDecoder

        self.dmx = FFmpegDemuxer(path)
        self.dec = JpegCoefDecoder()
        self.path = path
        self.next_idx = 0

    def _packet(self, seek_to: Optional[int]) -> np.ndarray:
        if seek_to is not None:
            res = self.dmx.seek(SeekContext(seek_frame=int(seek_to),
                                            mode=SeekMode.PREV_KEY_FRAME))
        else:
            res = self.dmx.demux()
        if res is None:
            raise RuntimeError(
                f"{self.path}: EOF during clip read (container frame count "
                f"was optimistic; pass lengths= to the loader)")
        return res.packet

    def read_clip(self, start: int, clip_len: int, stride: int,
                  dest) -> None:
        """Entropy-decode frames start, start+stride, … straight into
        ``dest(t)``, the per-component ``[blocks, 64]`` int16
        destinations of clip frame t. Skipped frames are demuxed only."""
        t = 0
        if start != self.next_idx:
            # all-intra: the PREV_KEY_FRAME seek lands on frame `start`
            self.dec.decode_into(self._packet(start), dest(0))
            self.next_idx = start + 1
            t = 1
        idx = self.next_idx
        want = start + t * stride
        while t < clip_len:
            pkt = self._packet(None)
            if idx == want:
                self.dec.decode_into(pkt, dest(t))
                t += 1
                want = start + t * stride
            idx += 1
        self.next_idx = idx


class MjpegClipLoader(_ClipLoaderBase):
    """Shuffled clip batches from MJPEG files, decoded by the split codec.

    The sampling of :class:`~.loader.VideoClipLoader` (deterministic per
    (seed, epoch), the same on any worker count, ``state_dict`` /
    ``load_state_dict`` resume, per-file ``labels``, shards), with the
    decode path of the split codec.

    All files share geometry, chroma sampling and quant tables (the
    tables fold into the device bases: one encoder configuration a
    corpus; bucket or re-encode otherwise). ``output`` is a fused mode
    (``rgb_u8`` / ``rgb_f32`` / ``normalized`` / ``normalized_nchw``) or
    ``"planes"`` for the (y, u, v) batches. ``augment``: an
    :class:`~..ops.augment.AugmentSpec`, per-clip params from the
    (seed, epoch, shard-unique batch index) counter. ``device``: CUDA by
    default, ``"cpu"`` for the CPU. ``sharding``: as
    :class:`~.loader.VideoClipLoader`'s (each rank's batch a ``DTensor``
    shard).
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
        compute: str = "auto",
        shuffle: bool = True,
        seed: int = 0,
        hop: Optional[int] = None,
        drop_last: bool = False,
        workers: int = 0,
        prefetch: int = 2,
        device=None,
        shard_index: int = 0,
        shard_count: int = 1,
        labels: Optional[Sequence] = None,
        lengths: Optional[Sequence[int]] = None,
        augment=None,
        sharding=None,
    ):
        from ..io.demuxer import FFmpegDemuxer
        from ..io.jpeg import JpegCoefDecoder, JpegStreamError, _snapshot
        from ..ops.jpeg import JpegDevicePipeline

        if isinstance(sources, (str, os.PathLike)):
            sources = [sources]
        sources = [str(s) for s in sources]
        # one open a file for the codec check and the first packet's
        # probe; one configuration a corpus
        snap0 = None
        for s in sources:
            d = FFmpegDemuxer(s)
            try:
                if d.codec != CodecId.MJPEG:
                    raise JpegStreamError(
                        f"{s}: codec is {d.codec.name}, not MJPEG — use "
                        "VideoClipLoader for inter-coded corpora")
                first = d.demux()
            finally:
                d.close()
            if first is None:
                raise JpegStreamError(f"{s}: empty MJPEG stream")
            dec = JpegCoefDecoder()
            dec.probe(first.packet)
            snap = _snapshot(dec.info)
            if snap0 is None:
                snap0 = snap
            elif (snap.hs, snap.vs, snap.qt) != (snap0.hs, snap0.vs,
                                                  snap0.qt):
                raise JpegStreamError(
                    f"{s}: sampling/quant tables differ from {sources[0]} "
                    "— one encoder configuration per corpus (bucket or "
                    "re-encode)")
        self.corpus = VideoCorpus(sources, lengths=lengths)
        self._init_common(
            clip_len=clip_len, frame_stride=frame_stride,
            batch_size=batch_size, shuffle=shuffle, seed=seed, hop=hop,
            drop_last=drop_last, workers=workers, prefetch=prefetch,
            device=device, shard_index=shard_index, shard_count=shard_count,
            labels=labels, sharding=sharding)
        self._augmented = augment is not None
        self.pipeline = JpegDevicePipeline(
            snap0, out_size=out_size, output=output, method=method,
            compute=compute, augment=augment, clip_len=clip_len, seed=seed,
            device=self.device)
        self.ncomp = self.pipeline.ncomp
        self._nblocks = [int(snap0.bh[c]) * int(snap0.bw[c])
                         for c in range(self.ncomp)]
        self._qt0 = tuple(snap0.qt[: self.ncomp])
        self._geo0 = (snap0.width, snap0.height, snap0.ncomp,
                      tuple(snap0.hs), tuple(snap0.vs))

    # -- decode --------------------------------------------------------------

    def _open_ring(self) -> list:
        """numpy views of the ring's ``prefetch + 1`` slots, each the
        per-component [B·T, blocks, 64] int16 coefficients (pinned on
        CUDA), allocated once per loader; every slot starts free."""
        count = self.prefetch + 1
        if len(self._slots) < count:
            n = self.batch_size * self.clip_len
            pin = self.device.type == "cuda"
            self._slots = [tuple(torch.zeros((n, nb, 64), dtype=torch.int16,
                                             pin_memory=pin)
                                 for nb in self._nblocks)
                           for _ in range(count)]
        self._free = list(range(count))
        return [tuple(c.numpy() for c in slot) for slot in self._slots]

    def _reader_for(self, cache: dict, fi: int) -> _JpegClipReader:
        rd = cache.get(fi)
        if rd is None:
            rd = cache[fi] = _JpegClipReader(self.corpus.streams[fi].path)
        return rd

    def _fill_one(self, cache, slot, s, fi, start) -> None:
        """Decode clip ``s`` of a batch into ``slot``, then hold the file
        to the pinned configuration: a geometry or sampling change breaks
        the slot layout, and frames quantized with other tables would
        decode silently wrong against the one table set in the bases."""
        from ..io.jpeg import JpegStreamError, _snapshot

        T = self.clip_len
        rd = self._reader_for(cache, fi)
        rd.read_clip(start, T, self.frame_stride,
                     lambda t: [c[s * T + t] for c in slot])
        self._note_clip(T, 0, 0)
        snap = _snapshot(rd.dec.info)
        path = self.corpus.streams[fi].path
        if (snap.width, snap.height, snap.ncomp, tuple(snap.hs),
                tuple(snap.vs)) != self._geo0:
            raise JpegStreamError(
                f"{path}: mid-stream geometry change inside a clip corpus")
        if tuple(snap.qt[: self.ncomp]) != self._qt0:
            raise JpegStreamError(
                f"{path}: quant tables changed mid-stream — MjpegClipLoader "
                "folds one table set into the device bases (re-encode, or "
                "decode this file with MjpegReader, which rebuilds the "
                "bases at each change)")

    def _batches_of_clips(self, samples: np.ndarray) -> Iterator:
        B = self.batch_size
        slots = self._open_ring()
        free = self._free
        groups = [samples[i: i + B] for i in range(0, len(samples), B)]

        if self.workers <= 1:
            cache: dict = {}
            for grp in groups:
                if not free:
                    raise RuntimeError("coefficient ring exhausted")
                slot = free.pop(0)
                with self.timer.measure("decode"):
                    for s, (fi, start) in enumerate(grp):
                        self._fill_one(cache, slots[slot], s, int(fi),
                                       int(start))
                yield slot, len(grp), [int(fi) for fi, _ in grp]
            return

        local = threading.local()

        def one(args):
            cache = getattr(local, "cache", None)
            if cache is None:
                cache = local.cache = {}
            self._fill_one(cache, *args)

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=self.workers) as ex:
            for grp in groups:
                if not free:
                    raise RuntimeError("coefficient ring exhausted")
                slot = free.pop(0)
                with self.timer.measure("decode"):
                    list(ex.map(one, [(slots[slot], s, int(fi), int(start))
                                      for s, (fi, start) in enumerate(grp)]))
                yield slot, len(grp), [int(fi) for fi, _ in grp]

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self, slot: int, count: int, files: list) -> tuple:
        """Slot → device (one copy a component on the side stream) → the
        pipeline; returns ``(out, labels, count, slot, uploaded)`` as the
        base's ``_dispatch``."""
        labels = self._batch_labels(files)
        n = count * self.clip_len
        staged, uploaded = upload([c[:n] for c in self._slots[slot]],
                                  self.device, self._copy_stream)
        if self._augmented:
            idx = self._dispatch_index
            self._dispatch_index += 1
            # shard-unique counter: shards share the seed, so a bare
            # index would give every shard the same augmentations
            out = self.pipeline(
                *staged, epoch=self._dispatch_epoch,
                batch_index=idx * self.shard_count + self.shard_index)
        else:
            out = self.pipeline(*staged)
        return out, labels, count, slot, uploaded
