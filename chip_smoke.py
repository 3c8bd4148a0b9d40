#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (videoprocessingframework_torch) on
one NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py            # needs one CUDA device; no arguments

Phases, each of which raises on failure:

1. Device: CUDA must be available; prints the card's name and power limit.
2. Build: the CUDA kernel library (nvcc, sm_90a) and, where the libav
   development files exist, the native host library; both at once, beside
   an ``nvcc -Xptxas -v`` compile of fused_resize_csc.cu whose registers,
   shared memory and spills are printed per kernel.
3. fused_resize_csc (the band kernel) vs its first version (the direct
   entry point: 0 codes, 0.0), vs its plain version and vs the float64
   golden, planar and NV12 × rgb_u8 / rgb_f32 / normalized, at
   1080p→224² ×32, 2160p→224² ×4 and 464×848→61×45 ×2.
4. Timings (CUDA events, warm-up, median): the direct and band kernels
   in turns (direct, band, band, direct), planar: at 1080p→224² and
   2160p→224² ×32 beside the plain version and the kernel="torch" path;
   at 1080p→224² ×1, 464×848→61×45 ×32 and the upscale
   240×320→1080×1920 ×32; each beside the bound and, where the windows
   skip source rows, a bound that counts only the rows they read.
5. Main path: decode pool → FusedPipeline(kernel="cuda", normalized) →
   ResNet-50 (bf16, seeded weights), with the kernel's launch count taken
   over that run alone. Without libav the pool's upload loop is fed
   seeded 1080p batches from host memory instead of decoded frames.
6. Converter path: the full-resolution NV12 / YUV420 → planar RGB kernel
   (csc_rgb_planar) vs its plain version (0 codes) and the float64
   golden (≤1 code) at 1080p ×32, 2160p ×4, 270×482 ×2 and 30×100 ×2,
   swap on and off; one seeded 1080p NV12 frame through FrameUploader →
   SurfaceConverter(NV12 → RGB_PLANAR).Execute → SurfaceDownloader vs the
   golden; 48 seeded 1080p batches of 32, NV12 (BT.709) and YUV420
   (BT.601), through DoubleBufferedUploader(depth=2) → run_planes →
   surface_to_torch, with the kernel's launch count taken over each run
   alone; kernel timings beside the bound and the plain version.
7. Timings of fused_resize_csc on NV12 input at 1080p→224² ×32 (direct
   and band in turns, as phase 4).

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

KERNEL_SOURCE = "videoprocessingframework_torch/csrc/fused_resize_csc.cu"
REPLACES = "videoprocessingframework_tpu/ops/pallas_fused.py:948"
CSC_SOURCE = "videoprocessingframework_torch/csrc/csc_rgb_planar.cu"
CSC_REPLACES = "videoprocessingframework_tpu/ops/pallas_kernels.py:96"
BATCH = 32
SRC_W, SRC_H = 1920, 1080
OUT = 224
#: (batch, height, width) of the csc_rgb_planar checks (phase 6); the
#: kernel takes 8 columns a thread at the first two, 2 at 270×482 and 4
#: at 30×100
CSC_CHECKS = [(BATCH, SRC_H, SRC_W), (4, 2160, 3840), (2, 270, 482),
              (2, 30, 100)]
# kernel vs plain tolerances: u8 may flip one code at a rounding boundary;
# float outputs carry float32 summation-order noise (~1e-4 of a code),
# ×1/255, ×1/std (≈4.4) for normalized
TOL = {"rgb_u8": 1.0, "rgb_f32": 2e-5, "normalized": 1e-4}


def log(*a):
    print(*a, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# ---- phase 1 -------------------------------------------------------------------


def device_info() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    return {"smi": smi, "kind": name, "count": torch.cuda.device_count()}


def peak_rates(name: str):
    """(memory bytes/s, float32 FLOP/s) from the card's data sheet."""
    if "H200" in name:
        return 4.8e12, 67e12
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    if "H100" in name:
        return 3.35e12, 67e12  # SXM (80GB HBM3)
    raise RuntimeError(f"no published peak rates for {name!r}")


# ---- phase 2 -------------------------------------------------------------------


def ptxas_report() -> list:
    """One line per kernel of fused_resize_csc.cu: registers, static
    shared memory and spills, from ``nvcc -Xptxas -v`` with the build's
    own flags (the band kernel's shared memory is dynamic: its plan
    sizes it, and phase 4 prints it)."""
    from videoprocessingframework_torch.csrc import build as kbuild

    src = kbuild._HERE / "fused_resize_csc.cu"
    flags = [f for f in kbuild.NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        res = subprocess.run(
            [kbuild.nvcc(), *flags, "-Xptxas", "-v", "-c", str(src), "-o",
             f"{tmp}/ptxas.o"],
            capture_output=True, text=True, timeout=600, check=True)
    lines, name, spill = [], "?", ""
    for line in res.stderr.splitlines():
        m = re.search(r"entry function '\S*?\d(fused_resize_csc(?:_band)?"
                      r"_kernel)ILi(\d)ELi(\d)E", line)
        if m:
            name = f"{m.group(1)}<STEP={m.group(2)},MODE={m.group(3)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"ptxas {name}: {m.group(1)} registers, static "
                         f"smem {smem.group(1) if smem else 0} B, {spill}")
    return lines


def build_all() -> str:
    """Build the kernel library and the native host library in parallel,
    beside the ptxas report; returns '' or why the host library was not
    built."""
    from videoprocessingframework_torch.csrc import build as kbuild
    from videoprocessingframework_torch.io import build as hbuild

    missing = hbuild.libav_missing()
    results = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            results[name] = (fn(), time.perf_counter() - t0)
        except BaseException as e:  # re-raised below, in this thread
            results[name] = (e, time.perf_counter() - t0)

    jobs = [("kernels", kbuild.load_kernels), ("ptxas", ptxas_report)]
    if not missing:
        jobs.append(("host", hbuild.build))
    threads = [threading.Thread(target=run, args=j) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, (res, dt) in results.items():
        if isinstance(res, BaseException):
            raise res
        log(f"build {name}: {dt:.1f} s")
    for line in results["ptxas"][0]:
        log(line)
    if missing:
        log(f"build host: not built: libav development files absent "
            f"({missing})")
    return missing


# ---- phase 3 -------------------------------------------------------------------


def _golden(y, u, v, out_h, out_w):
    """float64 golden (B, 3, H', W') on numpy planes."""
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
    )
    from videoprocessingframework_torch.ops import colorspace as cs
    from videoprocessingframework_torch.ops.resize import resize_matrix

    h, w = y.shape[-2:]
    rm = resize_matrix(h, out_h).astype(np.float64)
    cm = resize_matrix(w, out_w).astype(np.float64)

    def rsz(p):
        return np.matmul(np.matmul(rm, p.astype(np.float64)), cm.T)

    up = lambda c: np.repeat(np.repeat(c, 2, 1), 2, 2)  # noqa: E731
    m, off = cs.rgb_from_ycbcr_matrix(ColorSpace.BT_709, ColorRange.MPEG)
    ycc = np.stack([rsz(y) - off[0], rsz(up(u)) - off[1],
                    rsz(up(v)) - off[2]], 1)
    return np.clip(np.rint(np.einsum("nc...,dc->nd...", ycc, m)), 0, 255)


def _seeded_yuv(b, h, w, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    y = torch.randint(0, 256, (b, h, w), generator=g, dtype=torch.uint8)
    u = torch.randint(0, 256, (b, h // 2, w // 2), generator=g,
                      dtype=torch.uint8)
    v = torch.randint(0, 256, (b, h // 2, w // 2), generator=g,
                      dtype=torch.uint8)
    return y.to(device), u.to(device), v.to(device)


def _interleave(u, v):
    return torch.stack([u, v], dim=-1).flatten(-2)


def check_kernel(device) -> float:
    """Band kernel vs direct kernel (all modes, exact), vs plain (all
    modes, TOL) and vs golden (rgb_u8, two frames). Returns the largest
    u8 error seen against the plain version."""
    from videoprocessingframework_torch.ops import fused_cuda as fc

    worst, worst_direct = 0.0, 0.0
    for b, h, w, oh, ow in [(BATCH, SRC_H, SRC_W, OUT, OUT),
                            (4, 2160, 3840, OUT, OUT), (2, 464, 848, 61, 45)]:
        y, u, v = _seeded_yuv(b, h, w, seed=h, device=device)
        uv = _interleave(u, v)
        gold = _golden(*(p[:2].cpu().numpy() for p in (y, u, v)), oh, ow)
        for layout in ("planar", "nv12"):
            chroma = (u, v) if layout == "planar" else (uv,)
            for out in ("rgb_u8", "rgb_f32", "normalized"):
                kw = dict(out_h=oh, out_w=ow, output=out)
                if layout == "planar":
                    got = fc.fused_yuv420_resize_rgb(y, u, v, **kw)
                    want = fc.fused_yuv420_resize_rgb_ref(y, u, v, **kw)
                else:
                    got = fc.fused_nv12_resize_rgb(y, uv, **kw)
                    want = fc.fused_nv12_resize_rgb_ref(y, uv, **kw)
                direct = fc._direct_resize_rgb(y, *chroma, **kw)
                torch.cuda.synchronize()
                require(got.shape == (b, 3, oh, ow), f"shape {got.shape}")
                err = (got.float() - want.float()).abs().max().item()
                derr = (got.float() - direct.float()).abs().max().item()
                line = (f"check {layout} {h}x{w}->{oh}x{ow} b{b} {out}: "
                        f"max|band-direct| {derr:.3g} (tol 0), "
                        f"max|band-plain| {err:.3g} (tol {TOL[out]})")
                if out == "rgb_u8":
                    gerr = np.abs(got[:2].cpu().numpy().astype(np.int64)
                                  - gold).max()
                    line += f", max|band-golden| {gerr} (tol 1)"
                    require(gerr <= 1, line)
                    worst = max(worst, err)
                log(line)
                worst_direct = max(worst_direct, derr)
                require(err <= TOL[out] and bool(torch.equal(got, direct)),
                        line)
    log(f"phase 3: band kernel equals the direct kernel at every check "
        f"(largest difference {worst_direct:.3g})")
    return worst


# ---- phase 4 -------------------------------------------------------------------


def _sleep_cycles_per_ms() -> float:
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    torch.cuda._sleep(10_000_000)
    e.record()
    torch.cuda.synchronize()
    return 10_000_000 / s.elapsed_time(e)


def cuda_ms(fn, warmup=3, reps=20) -> float:
    """Median device time of one call, by CUDA events.

    A device-side sleep holds the stream while the host enqueues every
    timed call, so the events bracket device work only: without it, a
    call whose host-side enqueue outlasts its device time (a small
    kernel's Python wrapper, an eager model's hundreds of ops) would be
    timed at the host's pace.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * (2 * reps * host_ms + 5)))
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def _flops(b, h, w, oh, ow):
    """FLOPs of one call, from the tap counts."""
    from videoprocessingframework_torch.ops.fused_cuda import tap_tables

    t = tap_tables(h, w, oh, ow, "lanczos")
    k = {name: wt.shape[1] for name, (_, wt) in t.items()}
    macs = (k["rows_y"] * (k["cols_y"] + 1)
            + 2 * k["rows_c"] * (k["cols_c"] + 1) + 9)
    return 2.0 * macs * b * oh * ow


def kernel_bound(b, h, w, oh, ow, out_bytes, mem_rate, flop_rate):
    """(bound ms, bound_by, bytes) of one call: each input byte read once,
    each output byte written once; FLOPs from the tap counts."""
    flops = _flops(b, h, w, oh, ow)
    nbytes = b * (h * w + 2 * (h // 2) * (w // 2)) + b * 3 * oh * ow * \
        out_bytes
    t_bytes, t_ops = nbytes / mem_rate, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations"), nbytes


def window_bound(b, h, w, oh, ow, out_bytes, mem_rate, flop_rate):
    """(bound ms, bytes) of one planar call counting only what the
    windows read: the source rows that hold a nonzero weight, in the
    32-byte sectors (from each row's start) that hold a nonzero column,
    and each output byte once. Where the windows skip source rows, as at
    2160p→224², this is below ``kernel_bound``."""
    from videoprocessingframework_torch.ops.resize import (
        chroma_collapse,
        resize_matrix,
    )

    def plane(rm, cm):
        rows = np.count_nonzero((rm != 0).any(0))
        cols = np.flatnonzero((cm != 0).any(0))
        return rows * 32 * len(np.unique(cols // 32))

    rm, cm = resize_matrix(h, oh), resize_matrix(w, ow)
    nbytes = b * (plane(rm, cm)
                  + 2 * plane(chroma_collapse(rm), chroma_collapse(cm))) \
        + b * 3 * oh * ow * out_bytes
    t_bytes, t_ops = nbytes / mem_rate, _flops(b, h, w, oh, ow) / flop_rate
    return 1e3 * max(t_bytes, t_ops), nbytes


def _plan_line(y, chroma, oh, ow) -> str:
    """The band plan the wrapper takes for these planes, with the blocks
    an SM's shared memory holds."""
    from videoprocessingframework_torch.ops import fused_cuda as fc

    p = fc.plan_for(y, *chroma, out_h=oh, out_w=ow)
    return (f"plan: {p.rows} rows x {p.cols} cols per block, "
            f"{p.n_bands * p.n_tiles * y.shape[0]} blocks of {p.threads} "
            f"threads ({fc.PRODUCERS} producer warps), chunks of {p.chunk} "
            f"rows x {fc.STAGES} stages, copies of {p.vec_y} / {p.vec_c} B, "
            f"{p.smem} B shared (an SM's shared memory holds "
            f"{233_472 // (p.smem + 1024)} such blocks)")


def time_kernel(device, rates, layout="planar", b=BATCH, h=SRC_H, w=SRC_W,
                oh=OUT, ow=OUT, others=True) -> dict:
    """The direct and band kernels in turns (direct, band, band, direct)
    at h×w→oh×ow ×b, beside the bound and, with ``others``, the plain
    version and the kernel="torch" path."""
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
        PixelFormat,
    )
    from videoprocessingframework_torch.ops import fused_cuda as fc
    from videoprocessingframework_torch.ops.fused import FusedPipeline
    from videoprocessingframework_torch.ops.normalize import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )

    y, u, v = _seeded_yuv(b, h, w, seed=7, device=device)
    if layout == "planar":
        fmt, chroma = PixelFormat.YUV420, (u, v)
        kern = fc.fused_yuv420_resize_rgb
        plain_fn = fc.fused_yuv420_resize_rgb_ref
    else:
        fmt, chroma = PixelFormat.NV12, (_interleave(u, v),)
        kern = fc.fused_nv12_resize_rgb
        plain_fn = fc.fused_nv12_resize_rgb_ref
    log(f"time {layout} {h}x{w}->{oh}x{ow} {_plan_line(y, chroma, oh, ow)}")
    rec = {}
    for out in ("rgb_u8", "normalized"):
        kw = dict(out_h=oh, out_w=ow, output=out, mean=IMAGENET_MEAN,
                  std=IMAGENET_STD)
        direct = [cuda_ms(lambda: fc._direct_resize_rgb(y, *chroma, **kw))]
        band = [cuda_ms(lambda: kern(y, *chroma, **kw)) for _ in range(2)]
        direct.append(cuda_ms(lambda: fc._direct_resize_rgb(y, *chroma,
                                                             **kw)))
        out_bytes = 1 if out == "rgb_u8" else 4
        bound, by, nbytes = kernel_bound(b, h, w, oh, ow, out_bytes, *rates)
        ms, direct_ms = min(band), min(direct)
        line = (f"time {layout} {out} {h}x{w}->{oh}x{ow} b{b}: band "
                f"{band[0]:.4f} / {band[1]:.4f} ms per batch "
                f"({1e3 * ms / b:.3f} us/frame), "
                f"{nbytes / ms / 1e6:.1f} GB/s, {100 * bound / ms:.1f}% of "
                f"bound {bound:.4f} ms ({by}); direct {direct[0]:.4f} / "
                f"{direct[1]:.4f} ms ({100 * bound / direct_ms:.1f}% of "
                f"bound); band {direct_ms / ms:.2f}x faster than direct "
                f"({'yes' if ms < direct_ms else 'NO'})")
        rec[out] = dict(ms=ms, direct_ms=direct_ms, bound_ms=bound,
                        bound_by=by)
        if layout == "planar":
            wbound, wbytes = window_bound(b, h, w, oh, ow, out_bytes,
                                          *rates)
            if wbytes < nbytes:
                line += (f"; bound from the rows the windows read "
                         f"{wbound:.4f} ms ({wbytes} B): band "
                         f"{100 * wbound / ms:.1f}%, direct "
                         f"{100 * wbound / direct_ms:.1f}% of it")
                rec[out]["window_bound_ms"] = wbound
        if others:
            pipe = FusedPipeline(fmt, ColorSpace.BT_709, ColorRange.MPEG,
                                 (oh, ow), output=out, kernel="torch",
                                 compute="highest")
            rec[out]["plain_ms"] = cuda_ms(lambda: plain_fn(y, *chroma, **kw))
            rec[out]["torch_path_ms"] = cuda_ms(lambda: pipe(y, *chroma))
            line += (f"; plain {rec[out]['plain_ms']:.4f} ms; "
                     f"kernel='torch' path {rec[out]['torch_path_ms']:.4f} "
                     f"ms; library: none (no single PyTorch call computes "
                     f"4:2:0 Lanczos resize + CSC)")
        log(line)
    return rec


# ---- phase 5 -------------------------------------------------------------------


def _resnet(device, dtype=torch.bfloat16):
    from videoprocessingframework_torch.models import resnet50

    torch.manual_seed(0)
    model = resnet50(dtype=dtype).eval()
    with torch.no_grad():  # bn3 scales start at 0 (Flax init): make the
        for name, p in model.named_parameters():  # residual branches live
            if name.endswith("bn3.weight"):
                p.uniform_(0.5, 1.5)
    return model.to(device, memory_format=torch.channels_last)


def _throughput(feed, consume) -> float:
    """frames/s of ``consume`` over every batch of ``feed``."""
    n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for out in feed:
        n += consume(out)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def main_path(device, libav_missing: str, tmpdir: str) -> dict:
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
        PixelFormat,
    )
    from videoprocessingframework_torch.io import (
        HostBatchRing,
        NativeDecodePool,
    )
    from videoprocessingframework_torch.ops import fused_cuda as fc
    from videoprocessingframework_torch.ops.fused import FusedPipeline

    n_batches = 48
    if libav_missing:
        src = "host ring"
        log(f"main path: host decode stage did not run: libav development "
            f"files are absent ({libav_missing}); the pool's upload loop "
            f"is fed seeded {SRC_W}x{SRC_H} YUV420 batches from host memory")
        ring = HostBatchRing(SRC_W, SRC_H, BATCH, 0, n_buffers=3, seed=1,
                             device=device)

        def feed(n):
            return ring.rewind(n)
    else:
        from videoprocessingframework_torch.io.encoder import make_clip

        src = "decode"
        clip = make_clip(f"{tmpdir}/clip_1080p.h264", SRC_W, SRC_H,
                         BATCH * 8)

        def feed(n):
            return NativeDecodePool([str(clip)], batch_size=BATCH,
                                    out_format=PixelFormat.YUV420,
                                    plane_major=True, loop=True,
                                    max_frames_per_stream=n * BATCH,
                                    device=device)
        fps = _throughput(_host_decode(feed(n_batches)), lambda n: n)
        log(f"decode-only fps: {fps:.1f} (host libav, {SRC_W}x{SRC_H})")

    # the synthetic frames carry no colorimetry: BT.709/MPEG, as the JAX
    # package's bench headline
    space, rng = ColorSpace.BT_709, ColorRange.MPEG
    pipe = FusedPipeline(PixelFormat.YUV420, space, rng, (OUT, OUT),
                         output="normalized", device=device, kernel="cuda")
    model = _resnet(device)
    first = {}

    def post(y, u, v):
        out = pipe(y, u, v)
        if not first:
            first.update(planes=(y.clone(), u.clone(), v.clone()),
                         out=out.clone())
        return out

    def run(postproc, consume, n):
        f = feed(n)
        fps = _throughput(f.batches(postproc, depth=2), consume)
        stages = ", ".join(f"{k} {v['mean_ms']:.2f}"
                           for k, v in f.timer.summary().items())
        return fps, stages

    with torch.no_grad():
        logits_seen = []
        stages = {
            "device upload": (None, lambda p: p[0].shape[0]),
            "kernel": (pipe, lambda o: o.shape[0]),
            "kernel->ResNet-50": (
                post, lambda o: logits_seen.append(model(o)) or o.shape[0]),
        }
        for name, (postproc, consume) in stages.items():
            run(postproc, consume, 3)  # warm-up: allocations, cuDNN plans
            logits_seen.clear()
            fc.reset_launches()
            fps, st = run(postproc, consume, n_batches)
            launches = fc.LAUNCHES["fused_resize_csc"]
            log(f"{src}->{name} fps: {fps:.1f} over {n_batches} batches of "
                f"{BATCH} (per batch ms: {st}); fused_resize_csc launches "
                f"in this run: {launches}")
        require(launches >= n_batches, f"{launches} kernel launches")

        logits = torch.cat(logits_seen)
        require(logits.shape == (BATCH * n_batches, 1000),
                f"logits {tuple(logits.shape)}")
        require(bool(torch.isfinite(logits).all()), "non-finite logits")

        x = first["out"]
        want = fc.fused_yuv420_resize_rgb_ref(
            *first["planes"], out_h=OUT, out_w=OUT, space=space, rng=rng,
            output="normalized", mean=pipe.mean, std=pipe.std,
        ).permute(0, 2, 3, 1)
        err = (x - want).abs().max().item()
        log(f"first batch kernel vs plain (normalized): max abs {err:.3g} "
            f"(tol {TOL['normalized']})")
        require(err <= TOL["normalized"], "first batch kernel vs plain")

        # bf16 model vs the same weights in float32 on the first batch
        ref = _resnet(device, torch.float32)
        ref.load_state_dict(model.state_dict())
        torch.backends.cudnn.allow_tf32 = False
        l32 = ref(x)
        torch.backends.cudnn.allow_tf32 = True
        l16 = model(x)
        rel = ((l16 - l32).abs().max() / l32.abs().max()).item()
        log(f"ResNet-50 bf16 vs float32 logits on the first batch: max abs "
            f"diff / max |logit| = {rel:.4f} (tol 0.05)")
        require(rel <= 0.05, "bf16 vs float32 logits")

        # device-resident: the pipeline's own output layout as input
        # 3 calls keep ~900 launches queued behind the sleep, inside the
        # device's launch queue
        ms = cuda_ms(lambda: model(x), warmup=3, reps=3)
        log(f"ResNet-50 bf16 device-resident: {ms:.3f} ms per batch of "
            f"{BATCH}, {1e3 * BATCH / ms:.1f} fps")
    return {"launches": launches, "max_abs_err": err}


def _host_decode(pool):
    """Iterate a pool's batches on the host only (decode-only ceiling)."""
    while True:
        b = pool.acquire_planes()
        if b is None:
            pool.close()
            return
        n = b[0].shape[0]
        pool.release()
        yield n


# ---- phase 6 -------------------------------------------------------------------


def _csc_golden(y, u, v, space, rng):
    """float64 golden (B, 3, H, W) of the full-resolution conversion."""
    from videoprocessingframework_torch.ops import golden

    out = np.stack([golden.yuv420_to_rgb(y[i], u[i], v[i], space, rng)
                    for i in range(len(y))])
    return np.moveaxis(out, -1, 1).astype(np.int64)


def check_csc(device) -> None:
    """csc_rgb_planar vs its plain version (0 codes) and vs the golden
    (≤1 code, first two frames), NV12 and planar chroma, swap on and off,
    every column width the kernel takes."""
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
    )
    from videoprocessingframework_torch.ops import csc_cuda as cc

    all_combos = [(s, r) for s in (ColorSpace.BT_709, ColorSpace.BT_601)
                  for r in (ColorRange.MPEG, ColorRange.JPEG)]
    for b, h, w in CSC_CHECKS:
        y, u, v = _seeded_yuv(b, h, w, seed=h + 1, device=device)
        uv = _interleave(u, v)
        # every combination at the small size, two at the large ones
        combos = all_combos if h < 1000 else all_combos[::2]
        for space, rng in combos:
            gold = _csc_golden(*(p[:2].cpu().numpy() for p in (y, u, v)),
                               space, rng)
            for layout in ("nv12", "planar"):
                for swap in (False, True):
                    kw = dict(space=space, rng=rng, swap=swap)
                    if layout == "nv12":
                        got = cc.nv12_to_rgb_planar(y, uv, **kw)
                        want = cc.nv12_to_rgb_planar_ref(y, uv, **kw)
                    else:
                        got = cc.yuv420_to_rgb_planar(y, u, v, **kw)
                        want = cc.yuv420_to_rgb_planar_ref(y, u, v, **kw)
                    torch.cuda.synchronize()
                    require(got.shape == (b, 3, h, w), f"shape {got.shape}")
                    err = (got.int() - want.int()).abs().max().item()
                    g = gold[:, ::-1] if swap else gold
                    gerr = np.abs(got[:2].cpu().numpy().astype(np.int64)
                                  - g).max()
                    line = (f"check csc {layout} {h}x{w} b{b} {space.name}/"
                            f"{rng.name} swap={swap}: max|kernel-plain| "
                            f"{err} (tol 0), max|kernel-golden| {gerr} "
                            f"(tol 1)")
                    log(line)
                    require(err == 0 and gerr <= 1, line)


def csc_bound(b, h, w, mem_rate, flop_rate):
    """(bound ms, bound_by, bytes) of one conversion: each input byte read
    once, each output byte written once; per output pixel 3 × (3 mul +
    2 add) plus the luma offset, per chroma sample its two offsets."""
    nbytes = b * (h * w + 2 * (h // 2) * (w // 2)) + b * 3 * h * w
    flops = b * (16 * h * w + 2 * (h // 2) * (w // 2))
    t_bytes, t_ops = nbytes / mem_rate, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations"), nbytes


def converter_per_frame(device) -> None:
    """The README's shape: one 1080p NV12 host frame → FrameUploader →
    SurfaceConverter(NV12 → RGB_PLANAR).Execute → SurfaceDownloader."""
    from videoprocessingframework_torch import (
        ColorRange,
        ColorSpace,
        ColorspaceConversionContext,
        PixelFormat,
        Surface,
        SurfaceConverter,
    )
    from videoprocessingframework_torch.interop import (
        FrameUploader,
        SurfaceDownloader,
    )
    from videoprocessingframework_torch.ops import csc_cuda as cc
    from videoprocessingframework_torch.ops import golden

    fmt, w, h = PixelFormat.NV12, SRC_W, SRC_H
    frame = np.random.default_rng(11).integers(0, 256, w * h * 3 // 2,
                                               np.uint8)
    up = FrameUploader(w, h, fmt, device=device)
    conv = SurfaceConverter(w, h, fmt, PixelFormat.RGB_PLANAR)
    down = SurfaceDownloader(w, h, PixelFormat.RGB_PLANAR)
    ctx = ColorspaceConversionContext(ColorSpace.BT_709, ColorRange.MPEG)
    down(conv.Execute(up(frame), ctx))  # warm-up
    n = 30
    cc.reset_launches()
    t0 = time.perf_counter()
    for _ in range(n):
        out = down(conv.Execute(up(frame), ctx))
    fps = n / (time.perf_counter() - t0)
    launches = cc.LAUNCHES["csc_rgb_planar"]
    require(launches == n, f"per-frame path: {launches} launches for {n}")
    host = Surface.from_host_frame(frame, fmt, w, h)
    gold = np.moveaxis(golden.nv12_to_rgb(*host.planes, ColorSpace.BT_709,
                                          ColorRange.MPEG), -1, 0)
    err = np.abs(out.reshape(3, h, w).astype(np.int64) - gold).max()
    log(f"per-frame path FrameUploader->SurfaceConverter.Execute->"
        f"SurfaceDownloader, 1080p NV12 BT_709/MPEG: {fps:.1f} fps over {n} "
        f"frames (host clock, each frame synchronised), csc_rgb_planar "
        f"launches {launches}; max|result-golden| {err} (tol 1)")
    require(err <= 1, "per-frame path vs golden")


def converter_batched(device, fmt_name: str, n_batches: int = 48) -> dict:
    """Seeded 1080p batches of 32 through DoubleBufferedUploader(depth=2)
    → SurfaceConverter.run_planes → surface_to_torch, per frame."""
    from videoprocessingframework_torch import (
        ColorRange,
        ColorSpace,
        ColorspaceConversionContext,
        PixelFormat,
        Surface,
        SurfaceConverter,
    )
    from videoprocessingframework_torch.interop import (
        DoubleBufferedUploader,
        surface_to_torch,
    )
    from videoprocessingframework_torch.ops import csc_cuda as cc

    rng = np.random.default_rng(12)
    b, h, w = BATCH, SRC_H, SRC_W

    def u8(*shape):
        return rng.integers(0, 256, shape, np.uint8)

    if fmt_name == "NV12":
        fmt, space = PixelFormat.NV12, ColorSpace.BT_709
        host = [(u8(b, h, w), u8(b, h // 2, w)) for _ in range(3)]
        plain = cc.nv12_to_rgb_planar_ref
    else:  # yuv420 pairs allow BT.601 only (ops/colorspace.py)
        fmt, space = PixelFormat.YUV420, ColorSpace.BT_601
        host = [(u8(b, h, w), u8(b, h // 2, w // 2), u8(b, h // 2, w // 2))
                for _ in range(3)]
        plain = cc.yuv420_to_rgb_planar_ref
    ctx = ColorspaceConversionContext(space, ColorRange.MPEG)
    conv = SurfaceConverter(w, h, fmt, PixelFormat.RGB_PLANAR)
    up = DoubleBufferedUploader(device=device, depth=2)
    first = {}

    def consume(planes) -> int:
        out = conv.run_planes(planes, ctx)[0]
        if not first:
            first.update(planes=planes, out=out)
        for k in range(out.shape[0]):
            t = surface_to_torch(Surface(PixelFormat.RGB_PLANAR, w, h,
                                         [out[k]]))
            require(t.data_ptr() == out[k].data_ptr(), "zero-copy export")
        return out.shape[0]

    def run(n) -> float:
        frames = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            got = up.put(host[i % len(host)])
            if got is not None:
                frames += consume(got)
        for got in up.drain():
            frames += consume(got)
        torch.cuda.synchronize()
        require(frames == n * b, f"{frames} frames out of {n * b}")
        return frames / (time.perf_counter() - t0)

    run(3)  # warm-up: pinned staging, allocations
    first.clear()
    cc.reset_launches()
    fps = run(n_batches)
    launches = cc.LAUNCHES["csc_rgb_planar"]
    want = plain(*first["planes"], space=space, rng=ColorRange.MPEG)
    err = (first["out"].view(b, 3, h, w).int() - want.int()).abs().max()
    err = int(err.item())
    log(f"batched {fmt_name} {space.name}/MPEG: DoubleBufferedUploader -> "
        f"run_planes -> surface_to_torch: {fps:.1f} fps over {n_batches} "
        f"batches of {b}; csc_rgb_planar launches in this run: {launches}; "
        f"first batch kernel vs plain max abs {err} (tol 0)")
    require(launches >= n_batches, f"{launches} csc_rgb_planar launches")
    require(err == 0, "first batch kernel vs plain")
    return {"launches": launches, "max_abs_err": err, "fps": fps}


def time_csc(device, rates) -> dict:
    """csc_rgb_planar at 1080p ×32 beside its bound and plain version."""
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
    )
    from videoprocessingframework_torch.ops import csc_cuda as cc

    y, u, v = _seeded_yuv(BATCH, SRC_H, SRC_W, seed=9, device=device)
    uv = _interleave(u, v)
    bound, by, nbytes = csc_bound(BATCH, SRC_H, SRC_W, *rates)
    rec = {}
    for layout, kern, plain_fn, planes, space in [
        ("nv12", cc.nv12_to_rgb_planar, cc.nv12_to_rgb_planar_ref, (y, uv),
         ColorSpace.BT_709),
        ("planar", cc.yuv420_to_rgb_planar, cc.yuv420_to_rgb_planar_ref,
         (y, u, v), ColorSpace.BT_601),
    ]:
        kw = dict(space=space, rng=ColorRange.MPEG)
        ms = cuda_ms(lambda: kern(*planes, **kw))
        plain = cuda_ms(lambda: plain_fn(*planes, **kw), reps=5)
        ms2 = cuda_ms(lambda: kern(*planes, **kw))
        kernel_ms = min(ms, ms2)
        log(f"time csc {layout} 1080p b{BATCH}: kernel {ms:.4f} / {ms2:.4f} "
            f"ms per batch ({1e3 * kernel_ms / BATCH:.3f} us/frame), "
            f"{nbytes / BATCH:.0f} B/frame, "
            f"{nbytes / kernel_ms / 1e6:.1f} GB/s vs bound {bound:.4f} ms "
            f"({by}; {100 * bound / kernel_ms:.1f}% of bound); plain "
            f"{plain:.4f} ms; library: none (no single PyTorch call "
            f"computes 4:2:0 upsample + CSC + u8 store)")
        rec[layout] = dict(ms=kernel_ms, plain_ms=plain, bound_ms=bound,
                           bound_by=by)
    return rec


def converter_path(device, rates) -> dict:
    check_csc(device)
    log("phase 6 checks ok: csc_rgb_planar equals its plain version")
    converter_per_frame(device)
    runs = [converter_batched(device, name) for name in ("NV12", "YUV420")]
    times = time_csc(device, rates)
    return {"launches": sum(r["launches"] for r in runs),
            "max_abs_err": max(r["max_abs_err"] for r in runs),
            "times": times}


# ---- main ----------------------------------------------------------------------


def main() -> int:
    t_start = time.perf_counter()
    dev_info = device_info()
    device = torch.device("cuda", 0)
    # the plain version and the kernel="torch" path are full float32;
    # cuDNN may use TF32 (the ResNet runs in bf16, where it does not apply)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    rates = peak_rates(dev_info["kind"])

    missing = build_all()
    worst_u8 = check_kernel(device)
    log(f"phase 3 ok: worst u8 kernel-vs-plain error {worst_u8:.0f}")
    times = time_kernel(device, rates)
    time_kernel(device, rates, h=2160, w=3840)
    for b, h, w, oh, ow in ((1, SRC_H, SRC_W, OUT, OUT),
                            (BATCH, 464, 848, 61, 45),
                            (BATCH, 240, 320, SRC_H, SRC_W)):
        time_kernel(device, rates, b=b, h=h, w=w, oh=oh, ow=ow, others=False)
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        run = main_path(device, missing, tmp)
    conv = converter_path(device, rates)
    time_kernel(device, rates, layout="nv12")  # phase 7

    t = times["normalized"]
    c = conv["times"]["nv12"]
    record = {"kernels": [{
        "name": "fused_resize_csc",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": run["launches"],
        "max_abs_err": run["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "direct_ms": t["direct_ms"],
        "torch_path_ms": t["torch_path_ms"],
    }, {
        "name": "csc_rgb_planar",
        "route": "cuda",
        "source": CSC_SOURCE,
        "replaces": CSC_REPLACES,
        "launches": conv["launches"],
        "max_abs_err": conv["max_abs_err"],
        "ms": c["ms"],
        "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"],
        "library_ms": None,
    }]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
