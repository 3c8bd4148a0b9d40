"""Dynamic-batching inference serving over a model on a CUDA device — the
counterpart of the JAX package's ``serving.py``.

Callers submit single items (frames, clips, preprocessed arrays) from any
thread and get a Future; a collector thread groups requests into
batches, copies each into a staging tensor padded to a fixed bucket
size, calls ``infer_fn`` on it and resolves the futures when the results
are ready.

* **Buckets.** Batches are padded up to a small ladder of sizes (powers
  of two up to ``max_batch`` by default), so ``infer_fn`` sees a few
  shapes only; ``warmup()`` runs each once on the collector thread. That
  thread is where ``infer_fn`` runs, and cuBLAS and cuDNN keep one handle
  per thread: a warm-up on the caller's thread would leave the
  collector's first convolution to create its cuDNN handle (1.2 s on an
  H100). With ``torch.backends.cudnn.benchmark`` on, the warm-up is also
  where each bucket's convolution algorithms are picked.
* **Staging.** Each bucket has two staging tensors, pinned host memory
  on CUDA, used in turn: the collector copies the requests in with
  torch (whose copies of large rows run on several threads), and
  ``infer_fn`` receives the tensor and copies it to the device itself
  (``staging.to(device, non_blocking=True)``), so batch i+1 is staged
  while batch i computes.
* **Landing.** After ``infer_fn`` returns, the collector records a CUDA
  event on the current stream; landing a batch synchronises that event.
  ``infer_fn`` must therefore enqueue its work, the copy from the staging
  tensor included, on the current stream (or make the current stream
  wait for its own streams). A staging tensor is refilled only after the
  batch that last read it has landed, and asynchronous CUDA errors, which
  surface at that synchronise, resolve the batch's futures with the
  error instead of ending the collector.
* **Results.** Each future gets row ``i`` of the output tensor (or a
  tuple of rows for a tuple/list output), left on the device. Outputs
  must not alias the staging tensor.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .utils.device import resolve_device

__all__ = ["InferenceServer", "ServingQueueFull"]

#: queue entry asking the collector to run the bucket ladder once
_WARMUP = object()


def _fail(reqs, e: BaseException) -> None:
    for _a, fut, _t in reqs:
        try:
            fut.set_exception(e)
        except InvalidStateError:  # cancelled by its caller
            pass


class ServingQueueFull(RuntimeError):
    """Backpressure: the bounded request queue is full — retryable (the
    closed-server RuntimeError is not)."""


class _Stats:
    """End-to-end latency is recorded split: queue wait (t_submit →
    t_batch_dispatch: batching delay + head-of-line blocking behind the
    in-flight batch) and dispatch (t_batch_dispatch → results ready:
    staging copy + upload + compute). ``max_wait_ms`` and buckets are tuned
    on the first, the model and the link on the second."""

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.padded_items = 0
        self.latencies_ms: list[float] = []
        self.queue_ms: list[float] = []
        self.dispatch_ms: list[float] = []

    def record(self, n: int, pad: int, lat_ms: Sequence[float],
               queue_ms: Sequence[float] = (),
               dispatch_ms: Sequence[float] = ()) -> None:
        with self.lock:
            self.requests += n
            self.batches += 1
            self.padded_items += pad
            for buf, new in (
                (self.latencies_ms, lat_ms),
                (self.queue_ms, queue_ms),
                (self.dispatch_ms, dispatch_ms),
            ):
                buf.extend(new)
                if len(buf) > 10000:
                    del buf[:-5000]

    @staticmethod
    def _pcts(out: dict, key: str, vals: list) -> None:
        arr = np.asarray(vals[-5000:], np.float64)
        if arr.size:
            out[f"{key}_p50"] = float(np.percentile(arr, 50))
            out[f"{key}_p99"] = float(np.percentile(arr, 99))

    def snapshot(self) -> dict:
        with self.lock:
            out = {
                "requests": self.requests,
                "batches": self.batches,
                "padded_items": self.padded_items,
                "mean_batch": (
                    self.requests / self.batches if self.batches else 0.0
                ),
            }
            self._pcts(out, "latency_ms", self.latencies_ms)
            self._pcts(out, "queue_wait_ms", self.queue_ms)
            self._pcts(out, "dispatch_ms", self.dispatch_ms)
            return out


class InferenceServer:
    """Thread-safe dynamic batcher over ``infer_fn``.

    ``infer_fn(staging) -> out`` takes a host tensor with a leading batch
    axis of any bucket size (trailing shape ``item_shape``, ``dtype``)
    and returns a tensor (or tuple/list of tensors) with the same leading
    size.

    ``device``: where ``infer_fn`` computes (CUDA by default; ``"cpu"``
    runs without a card, with no pinning and no events).
    ``buckets``: ascending batch sizes to pad to; default powers of two
    up to ``max_batch``.
    ``max_wait_ms``: how long the collector holds the first request of a
    batch hoping for co-arrivals (0 = dispatch at once).
    ``max_queue``: bound on pending requests (``ServingQueueFull`` past
    it); None = unbounded.
    """

    def __init__(
        self,
        infer_fn: Callable,
        item_shape: tuple,
        dtype=np.uint8,
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        buckets: Optional[Sequence[int]] = None,
        max_queue: Optional[int] = None,
        device=None,
    ):
        self.infer_fn = infer_fn
        self.item_shape = tuple(item_shape)
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        if buckets is None:
            buckets, b = [], 1
            while b < max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(max_batch)
        self.buckets = sorted(set(int(b) for b in buckets))
        self.max_batch = self.buckets[-1]
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.stats = _Stats()
        if max_queue is not None and int(max_queue) < 1:
            raise ValueError("max_queue must be >= 1 (or None = unbounded)")
        self.max_queue = int(max_queue) if max_queue is not None else 0
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()
        # persistent padded staging tensors, two per bucket, used in turn
        # (one batch in flight: staging i+1 never overwrites in-flight i)
        tdtype = torch.from_numpy(np.empty(0, self.dtype)).dtype
        pin = self.device.type == "cuda"
        self._staging = {
            b: [torch.zeros((b,) + self.item_shape, dtype=tdtype,
                            pin_memory=pin) for _ in range(2)]
            for b in self.buckets
        }
        self._flip = {b: 0 for b in self.buckets}
        self._worker = threading.Thread(
            target=self._run, daemon=True, name="vpf-serving"
        )
        self._worker.start()

    # -- client API ----------------------------------------------------------

    def _item(self, item) -> np.ndarray:
        a = np.asarray(item, self.dtype)
        if a.shape != self.item_shape:
            raise ValueError(
                f"item shape {a.shape} != server shape {self.item_shape}"
            )
        return a

    def submit(self, item) -> Future:
        """Enqueue one item; returns a Future resolving to its output."""
        a = self._item(item)
        fut: Future = Future()
        # the closed-check and enqueue are one atomic step against
        # close(): a submit racing close() could otherwise land behind
        # the shutdown sentinel and its future never resolve
        with self._submit_lock:
            self._admit([(a, fut)])
        return fut

    def _admit(self, pairs) -> None:
        """Enqueue under the held submit lock; all-or-nothing against the
        capacity bound and the shutdown sentinel."""
        if self._closed:
            raise RuntimeError("server is closed")
        if self.max_queue and (
            self._q.qsize() + len(pairs) > self.max_queue
        ):
            raise ServingQueueFull(
                f"serving queue full ({self.max_queue} pending)"
            )
        now = time.perf_counter()
        for a, fut in pairs:
            self._q.put((a, fut, now))

    def submit_many(self, items) -> list[Future]:
        """Atomic batch submit: every item is admitted (futures returned
        for all) or none is (ServingQueueFull)."""
        staged = [(self._item(item), Future()) for item in items]
        with self._submit_lock:
            self._admit(staged)
        return [fut for _a, fut in staged]

    def infer(self, item, timeout: Optional[float] = None):
        """Blocking convenience: submit + wait."""
        return self.submit(item).result(timeout=timeout)

    def warmup(self) -> None:
        """Run every bucket size once on the collector thread and wait for
        it (per-thread library handles, allocations, algorithm choices),
        before taking traffic. Raises what ``infer_fn`` raised."""
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._q.put((_WARMUP, fut, 0.0))
        fut.result()

    def _warm(self, fut: Future) -> None:
        try:
            for b in self.buckets:
                self.infer_fn(self._staging[b][0])
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        except Exception as e:
            fut.set_exception(e)
        else:
            fut.set_result(None)

    def snapshot(self) -> dict:
        return self.stats.snapshot()

    def close(self) -> None:
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # wake the collector
        self._worker.join(timeout=30.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- collector -----------------------------------------------------------

    def _collect(self):
        """Block for the first request, then gather co-arrivals up to
        max_batch or max_wait. Returns list of (item, future, t_submit),
        a warm-up entry alone, or None at shutdown."""
        first = self._q.get()
        if first is None or first[0] is _WARMUP:
            return first
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            left = deadline - time.perf_counter()
            try:
                nxt = (
                    self._q.get_nowait() if left <= 0
                    else self._q.get(timeout=left)
                )
            except queue.Empty:
                break
            if nxt is None or nxt[0] is _WARMUP:
                self._q.put(nxt)  # shutdown or warm-up after this batch
                break
            batch.append(nxt)
        return batch

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _dispatched(self) -> Optional[torch.cuda.Event]:
        """An event after the work ``infer_fn`` enqueued (CUDA only)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _land(self, disp) -> None:
        out, ready, reqs, pad, t_disp = disp
        try:
            # asynchronous device errors (out of memory, kernel faults,
            # failed copies) surface here, not at dispatch: they resolve
            # the batch's futures instead of ending the collector
            if ready is not None:
                ready.synchronize()
        except Exception as e:
            _fail(reqs, e)
            return
        t_done = time.perf_counter()
        lats, qlats = [], []
        for i, (_a, fut, t_sub) in enumerate(reqs):
            try:
                if isinstance(out, (tuple, list)):
                    fut.set_result(tuple(o[i] for o in out))
                else:
                    fut.set_result(out[i])
            except InvalidStateError:  # cancelled by its caller
                pass
            lats.append((t_done - t_sub) * 1e3)
            qlats.append((t_disp - t_sub) * 1e3)
        # dispatch latency is per batch (shared by its requests)
        self.stats.record(
            len(reqs), pad, lats, qlats, [(t_done - t_disp) * 1e3]
        )

    def _run(self):
        inflight = None  # (out, event, requests, padded_count, t_dispatch)
        while True:
            reqs = self._collect()
            if reqs is None or reqs[0] is _WARMUP:
                if inflight is not None:
                    self._land(inflight)
                    inflight = None
                if reqs is None:
                    return
                self._warm(reqs[1])
                continue
            n = len(reqs)
            b = self._bucket_for(n)
            buf = self._staging[b][self._flip[b]]
            self._flip[b] ^= 1
            t_disp = time.perf_counter()  # queue wait ends here
            for i, (a, _f, _t) in enumerate(reqs):
                buf[i].copy_(torch.from_numpy(a))
            try:
                out = self.infer_fn(buf)
                ready = self._dispatched()
            except Exception as e:
                _fail(reqs, e)
                # the dispatch failed: revert the flip so the next batch
                # reuses this buffer, not the one a batch still in flight
                # may be reading
                self._flip[b] ^= 1
                if inflight is not None and self._q.empty():
                    self._land(inflight)
                    inflight = None
                continue
            if inflight is not None:
                self._land(inflight)
            inflight = (out, ready, reqs, b - n, t_disp)
            if self._q.empty():
                # no pending traffic: land now rather than holding results
                # hostage to the next arrival
                self._land(inflight)
                inflight = None
