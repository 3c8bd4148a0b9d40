"""Offline (batch) inference, a closed loop: a ring of seeded host batches
through the port's ``_RingFeed.batches`` (pinned staging copy, one upload
a batch on a side stream, events, ``depth`` batches in flight) with the
pre-processing as its post-processing, and the model on each batch it
yields, for ``--seconds``.

``frames_per_s`` counts the frames whose logits were produced in the
window, over the window's seconds; the window ends in
``torch.cuda.synchronize()``. ``peak_mem_gib`` is the device memory's
high-water mark over the window, as the allocator holds it for tensors.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

from .. import frames
from ..check import (
    Reservoir,
    logit_gap,
    reference_input,
    reference_logits,
)
from ..harness import FRAMES, TRAFFIC, WEIGHTS, Outcome, strict_float32
from ..tracing import Stretches


def _ring(slots, width, height, batch, device):
    from videoprocessingframework_torch.io.pool import HostBatchRing

    class SeededRing(HostBatchRing):
        """The port's ``HostBatchRing`` (its loop, staging, upload and
        events) over the benchmark's frames; ``order`` holds the slot of
        each batch acquired and not yet taken by the consumer."""

        def __init__(self):
            # the parent's __init__ would draw its own slot contents
            self.device = torch.device(device)
            self.width, self.height, self.batch_size = width, height, batch
            self.plane_major = True
            self.frame_bytes = height * width * 3 // 2
            self._n_buffers = len(slots)
            self._ring = slots
            self.held = 0
            self.order = deque()
            self.rewind(0)

        def _acquire_raw(self):
            k = self._next
            slot, n = super()._acquire_raw()
            if slot is not None:
                self.order.append(k)
            return slot, n

    return SeededRing()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> Outcome:
    cell, p, dev, rec = ctx.cell, ctx.cell.params, ctx.device, ctx.record
    batch, h, w = p["batch"], p["height"], p["width"]
    weights = cell.model.weights(cell.config, ctx.sub_seed(WEIGHTS), dev)
    model = ctx.program.model(cell.model, cell.config, weights)
    pipe = ctx.program.pipeline(p, dev)
    ctx.mark("model and pipeline built")
    y, u, v = frames.yuv420(p["ring_slots"] * batch, h, w,
                            ctx.sub_seed(FRAMES), dev)
    slots = frames.ring_slots(y, u, v, batch)
    del y, u, v
    ctx.mark("frames made")
    ring = _ring(slots, w, h, batch, dev)
    rng = np.random.default_rng(ctx.sub_seed(TRAFFIC))
    kept_inputs = Reservoir(p["check_input_batches"], rng)
    kept_logits = Reservoir(p["check_batches"], rng)
    tracer = Stretches(ctx.trace)
    in_window = False

    def post(*planes):
        with record_function("vpfbench.preprocess"):
            out = pipe(*planes)
        if in_window:
            slot = ring.order[-1]
            kept_inputs.offer(lambda: (slot, out.clone()))
        return out

    ring.rewind(1 << 62)  # serves until the loop closes it
    feed = ring.batches(post, depth=p["depth"])

    def step():
        with record_function("vpfbench.feed"):
            x = next(feed)
        slot = ring.order.popleft()
        t = time.perf_counter()
        with record_function("vpfbench.model"):
            logits = model(x)
        return len(x), slot, logits, time.perf_counter() - t

    with torch.no_grad():
        for _ in range(p["warmup_batches"]):
            step()
        ctx.mark("warmed up")
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        timer = ring.timer
        base = (timer.totals.get("dispatch", 0.0),
                timer.counts.get("dispatch", 0))
        t_w0 = time.perf_counter()
        in_window = True
        tracer.start(t_w0, ctx.seconds)
        n = batches = 0
        last = base[0]
        while True:
            k, slot, logits, dt = step()
            rec.add("model.enqueue", dt)
            dispatched = timer.totals.get("dispatch", 0.0)
            kept_logits.offer(lambda: (slot, logits))
            n += k
            batches += 1
            now = time.perf_counter()
            rec.batches.append((now, k, dt, dispatched - last))
            last = dispatched
            if now - t_w0 >= ctx.seconds:
                break
            tracer.tick(now)
        _sync(dev)
        t_w1 = time.perf_counter()
        in_window = False
        rec.add("feed.dispatch",
                timer.totals.get("dispatch", 0.0) - base[0],
                timer.counts.get("dispatch", 0) - base[1])
        rec.trace = tracer.finish()
        feed.close()
    window = t_w1 - t_w0
    rec.t_window0 = t_w0
    rec.profiled = tracer.profiled
    rec.preprocess_frames = [batch] * len(rec.trace.device_s("preprocess")) \
        if rec.trace else []
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx.say(f"window {window:.3f} s: {n} frames in {batches} batches, "
            f"{n / window:.1f} frames/s; model enqueue "
            f"{rec.mean_ms('model.enqueue'):.3f} ms, feed dispatch "
            f"{rec.mean_ms('feed.dispatch'):.3f} ms a batch (host clock)")

    del feed, ring, model, pipe, logits
    checks = _check(ctx, slots, weights, kept_inputs.items,
                    kept_logits.items)
    return Outcome(attempted=n, failed=0,
                   end_to_end={"setup_s": t_w0 - ctx.t0,
                               "frames_per_s": n / window,
                               "peak_mem_gib": peak / 2 ** 30},
                   checks=checks, memory_peak=peak)


def _check(ctx, slots, weights, inputs, logits) -> dict:
    """The pre-processing's largest error (normalised units) over the
    sampled batches' inputs, and the logits' widest gap over the sampled
    batches, each against the reference recomputed from the slot's
    frames."""
    cell, p, dev = ctx.cell, ctx.cell.params, ctx.device
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    h, w, batch = p["height"], p["width"], p["batch"]
    cache = {}

    def want_input(slot):
        if slot not in cache:
            cache[slot] = reference_input(
                frames.slot_planes(slots[slot], batch, h, w), p, dev)
        return cache[slot]

    with torch.no_grad(), strict_float32():
        pre = max((float((got - want_input(s)).abs().amax())
                   for s, got in inputs), default=float("inf"))
        got = [lg for _, lg in logits]
        want = [reference_logits(cell, weights, want_input(s))
                for s, _ in logits]
        gap = logit_gap(torch.cat(got), torch.cat(want)) if got \
            else float("inf")
        if got:
            ctx.say(f"witness: the sampled rows rolled by one read a gap of "
                    f"{logit_gap(torch.cat(got).roll(1, 0), torch.cat(want))}")
    lim = cell.limits
    return {"preprocess_err": (pre, lim["preprocess_err"]),
            "logit_gap": (gap, lim["logit_gap"])}
