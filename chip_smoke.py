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
   1080p→224² ×32, 2160p→224² ×4, 464×848→61×45 ×2, and at the shapes
   the serving path launches (phase 8): 1080p→224² at every smaller
   bucket (×1-16, where the plan cuts shorter bands) and 1080p→512² ×8
   (the FCN's input); each line names the plan it took.
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
8. Serving path: InferenceServer (pinned staging, CUDA events) over
   seeded packed 1080p YUV420 frames → FusedPipeline(kernel="cuda",
   normalized) → ViT-S (bf16), 4 clients × 64 requests, max_batch 32; and
   over 8-frame clips → video-ResNet-50 (attention head, bf16), 2 clients
   × 16 clips, max_batch 4. Each run: finite logits of the right shape,
   the kernel's launches (counted over that run alone) ≥ its batches,
   served logits vs a direct call, bf16 vs float32, requests/s and the
   latency / queue-wait / dispatch p50 and p99. Direct forwards of
   VideoViT-S and FCN-ResNet (8 frames from the kernel at 512²), bf16 vs
   float32, with device ms per batch.
9. Analysis ops on seeded 1080p luma with known whole-pixel motion, one
   cut and jitter: lucas_kanade_flow / global_translations recover the
   shifts (≤0.1 px), warp_image reaches ≥35 dB, detect_cuts finds the
   cut, stabilize_clip reduces the jitter; every op on CUDA against the
   same function on the CPU at 270×480 (cuDNN TF32 off for the CUDA
   side); the 1080p checks and ms per call (CUDA events) at torch's
   default, cuDNN TF32 on.

The line before the last is the per-kernel JSON record (launches of
fused_resize_csc counted over phases 5 and 8); the last line is
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
#: FCN input size (phase 8), from the kernel at SEG×SEG
SEG = 512
#: (batch, height, width, out height, out width) of the fused_resize_csc
#: checks (phase 3): the main path, 4K, a small frame, then what the
#: serving path launches (phase 8): every smaller bucket of the image
#: server (the clip server's kernel batches are 8, 16 and 32 frames),
#: whose plans cut shorter bands, and the FCN's 8 frames at SEG²
KERNEL_CHECKS = [(BATCH, SRC_H, SRC_W, OUT, OUT), (4, 2160, 3840, OUT, OUT),
                 (2, 464, 848, 61, 45)] + [
    (b, SRC_H, SRC_W, OUT, OUT) for b in (1, 2, 4, 8, 16)] + [
    (8, SRC_H, SRC_W, SEG, SEG)]
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
    for b, h, w, oh, ow in KERNEL_CHECKS:
        y, u, v = _seeded_yuv(b, h, w, seed=h + b + oh, device=device)
        uv = _interleave(u, v)
        gold = _golden(*(p[:2].cpu().numpy() for p in (y, u, v)), oh, ow)
        for layout in ("planar", "nv12"):
            chroma = (u, v) if layout == "planar" else (uv,)
            p = fc.plan_for(y, *chroma, out_h=oh, out_w=ow)
            log(f"check {layout} {h}x{w}->{oh}x{ow} b{b}: plan {p.rows} "
                f"rows x {p.cols} cols, {p.n_bands} bands x {p.n_tiles} "
                f"tiles")
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


#: logits as max |diff| / max |logit|: served under load vs the same
#: items served again as one batch (the same bucket and the collector's
#: own thread and library handles, and every op computes each row alone:
#: the same bits); served vs a direct ``infer_fn`` call on the caller's
#: thread (a batch of the same size, but other cuBLAS / cuDNN handles,
#: which may take other algorithms, so bf16 rounds differently); bf16 vs
#: float32
SERVED_TOL = 0.0
DIRECT_TOL = 0.03
BF16_TOL = 0.05


def _seeded_model(build, device, seed):
    """``build(dtype)`` under a fixed seed, in bf16, with a float32 copy
    of the same weights; ResNet bn3 scales start at 0 (Flax init), so
    they are drawn to keep the residual branches live."""
    torch.manual_seed(seed)
    model = build(torch.bfloat16).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bn3.weight"):
                p.uniform_(0.5, 1.5)
    ref = build(torch.float32).eval()
    ref.load_state_dict(model.state_dict())
    return (model.to(device, memory_format=torch.channels_last),
            ref.to(device, memory_format=torch.channels_last))


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()
            ).item()


def _bf16_vs_f32(name, model, ref, x) -> float:
    """bf16 logits vs float32 logits (TF32 off) on the same input."""
    with torch.no_grad():
        got = model(x)
        torch.backends.cudnn.allow_tf32 = False
        try:
            want = ref(x)
        finally:
            torch.backends.cudnn.allow_tf32 = True
    rel = _rel(got, want)
    log(f"{name} bf16 vs float32: max abs diff / max |logit| = {rel:.4f} "
        f"(tol {BF16_TOL})")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    require(rel <= BF16_TOL, f"{name} bf16 vs float32")
    return rel


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
    from videoprocessingframework_torch.models import resnet50
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
    model, ref = _seeded_model(lambda dt: resnet50(dtype=dt), device, 0)
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
        _bf16_vs_f32("ResNet-50", model, ref, x)

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


# ---- phase 8 -------------------------------------------------------------------


def _serve(name, srv, items, clients, out_shape) -> dict:
    """``clients`` threads submit their share of ``items`` (all at once,
    then wait); the kernel's launches are counted over this run alone."""
    from videoprocessingframework_torch.ops import fused_cuda as fc

    results = [None] * len(items)
    errors = []
    share = -(-len(items) // clients)

    def client(lo, hi):
        try:
            futs = [(i, srv.submit(items[i])) for i in range(lo, hi)]
            for i, f in futs:
                results[i] = f.result(timeout=300)
        except Exception as e:  # reported below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=client,
                                args=(k * share,
                                      min(len(items), (k + 1) * share)))
               for k in range(clients)]
    torch.cuda.synchronize()
    fc.reset_launches()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = fc.LAUNCHES["fused_resize_csc"]
    require(not errors, f"{name}: {errors[:1]}")
    require(not any(t.is_alive() for t in threads), f"{name}: client hung")
    snap = srv.snapshot()
    require(snap["requests"] == len(items), f"{name}: {snap['requests']} "
            f"requests served of {len(items)}")
    for r in results:
        require(tuple(r.shape) == out_shape
                and r.device.type == srv.device.type,
                f"{name}: result {tuple(r.shape)} on {r.device}")
    require(bool(torch.isfinite(torch.stack(results)).all()),
            f"{name}: non-finite logits")
    require(launches >= snap["batches"],
            f"{name}: {launches} kernel launches for {snap['batches']} "
            f"batches")
    rps = len(items) / wall
    log(f"{name}: {snap['requests']} requests from {clients} clients in "
        f"{snap['batches']} batches (mean batch {snap['mean_batch']:.2f}, "
        f"padded items {snap['padded_items']}), {rps:.1f} requests/s "
        f"(host clock); latency p50 {snap['latency_ms_p50']:.2f} ms p99 "
        f"{snap['latency_ms_p99']:.2f} ms; queue wait p50 "
        f"{snap['queue_wait_ms_p50']:.2f} p99 {snap['queue_wait_ms_p99']:.2f}"
        f" ms; dispatch p50 {snap['dispatch_ms_p50']:.2f} p99 "
        f"{snap['dispatch_ms_p99']:.2f} ms; fused_resize_csc launches "
        f"{launches}; dispatch ms per batch: "
        f"{', '.join(f'{d:.1f}' for d in srv.stats.dispatch_ms)}")
    return dict(snap, launches=launches, requests_per_s=rps,
                results=results)


def _served_vs_direct(name, srv, served, items, infer_fn) -> None:
    """``served`` (the first results of the load run) against the same
    ``items`` served again as one batch, and against a direct
    ``infer_fn`` call on this thread; each beside a control (the served
    rows rolled by one item), which must exceed SERVED_TOL: a server that
    handed a future another request's row fails the exact check. (The
    direct check alone need not catch that: the clip model's logits of
    different clips can lie closer than DIRECT_TOL.)"""
    served = torch.stack(served)
    again = torch.stack([f.result(timeout=300)
                         for f in srv.submit_many(items)])
    direct = infer_fn(torch.from_numpy(np.stack(items)).pin_memory())
    rolled = served.roll(1, 0)
    for ref, what, tol in ((again, "served again as one batch", SERVED_TOL),
                           (direct, "a direct infer_fn call", DIRECT_TOL)):
        rel, ctrl = _rel(served, ref), _rel(rolled, ref)
        log(f"{name}: served logits of the first {len(items)} items vs "
            f"{what}: max abs diff / max |logit| = {rel:.3g} (tol {tol}); "
            f"control, rows rolled by one: {ctrl:.3g}")
        require(rel <= tol, f"{name}: served vs {what}")
        require(ctrl > SERVED_TOL, f"{name}: the control equals {what}: "
                f"the check cannot tell items apart")


def _packed_frames(n, rows, w, seed) -> np.ndarray:
    """``n`` seeded packed YUV420 frames (n, rows, w) u8: noise over a
    coarse pattern of 27 × 32 blocks a frame, so that frames still differ
    after the resize to 224², as real ones do (noise alone averages to a
    flat grey)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 128, (n, rows, w), np.uint8)
    coarse = rng.integers(0, 128, (n, 27, 32), np.uint8)
    frames += coarse[:, (np.arange(rows) * 27) // rows][
        :, :, (np.arange(w) * 32) // w]
    return frames


def _pipe_vs_plain(pipe, packed, got) -> None:
    """``got``, ``pipe``'s output on packed YUV420 frames, against the
    kernel's plain version on the same planes (TOL)."""
    from videoprocessingframework_torch.core.enums import PixelFormat
    from videoprocessingframework_torch.ops import fused_cuda as fc
    from videoprocessingframework_torch.ops.fused import unpack_yuv_planes

    y, u, v, _, _ = unpack_yuv_planes(PixelFormat.YUV420,
                                      (packed.to(got.device),))
    want = fc.fused_yuv420_resize_rgb_ref(
        y, u, v, out_h=pipe.out_h, out_w=pipe.out_w, output="normalized",
        mean=pipe.mean, std=pipe.std).permute(0, 2, 3, 1)
    err = (got - want).abs().max().item()
    line = (f"FusedPipeline on {tuple(packed.shape)} packed YUV420 -> "
            f"{pipe.out_h}x{pipe.out_w} normalized vs plain: max abs diff "
            f"{err:.3g} (tol {TOL['normalized']})")
    log(line)
    require(tuple(got.shape) == tuple(want.shape)
            and err <= TOL["normalized"], line)


def _host_ms(fn, reps=5) -> float:
    """Median host time of ``fn`` (its return, not its device work),
    from an idle device."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def serving_path(device) -> dict:
    """Phase 8: InferenceServer → FusedPipeline (the band kernel) → ViT-S
    on 1080p frames, and → video-ResNet-50 on 8-frame clips; then direct
    forwards of VideoViT-S and FCN."""
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
        PixelFormat,
    )
    from videoprocessingframework_torch.models import (
        fcn_resnet,
        video_resnet50,
        video_vit_small,
        vit_small,
    )
    from videoprocessingframework_torch.ops.fused import FusedPipeline
    from videoprocessingframework_torch.serving import InferenceServer

    rows, frames_per_clip = SRC_H * 3 // 2, 8
    n_images, n_clips = 256, 32
    pipe = FusedPipeline(PixelFormat.YUV420, ColorSpace.BT_709,
                         ColorRange.MPEG, (OUT, OUT), output="normalized",
                         device=device, kernel="cuda")
    frames = _packed_frames(n_images, rows, SRC_W, seed=21)
    vit, vit32 = _seeded_model(
        lambda dt: vit_small(1000, dtype=dt, image_size=(OUT, OUT)), device,
        1)
    vres, vres32 = _seeded_model(
        lambda dt: video_resnet50(400, "attention", dtype=dt,
                                  frames=frames_per_clip), device, 2)

    def infer_image(staging):
        with torch.no_grad():
            return vit(pipe(staging.to(device, non_blocking=True)))

    def infer_clip(staging):
        b = staging.shape[0]
        x = staging.to(device, non_blocking=True).view(-1, rows, SRC_W)
        with torch.no_grad():
            return vres(pipe(x).view(b, frames_per_clip, OUT, OUT, 3))

    out = {}
    first = torch.from_numpy(frames[:BATCH]).pin_memory()
    with InferenceServer(infer_image, (rows, SRC_W), np.uint8,
                         max_batch=BATCH, max_wait_ms=5, device=device) as s:
        t0 = time.perf_counter()
        s.warmup()
        log(f"image server warm-up ({len(s.buckets)} buckets): "
            f"{time.perf_counter() - t0:.1f} s")
        img = _serve("image server 1080p->fused_resize_csc->ViT-S bf16", s,
                     list(frames), 4, (1000,))
        _served_vs_direct("image server", s, img.pop("results")[:BATCH],
                          list(frames[:BATCH]), infer_image)
    x = pipe(first.to(device))
    _pipe_vs_plain(pipe, first, x)
    _bf16_vs_f32("ViT-S", vit, vit32, x)
    with torch.no_grad():
        img["model_ms"] = cuda_ms(lambda: vit(x), reps=5)
    log(f"ViT-S bf16 device-resident: {img['model_ms']:.3f} ms per batch "
        f"of {BATCH}")
    spare = torch.empty(first.shape, dtype=torch.uint8).pin_memory()
    copy_ms = _host_ms(lambda: [spare[i].copy_(torch.from_numpy(frames[i]))
                                for i in range(BATCH)])
    enqueue_ms = _host_ms(lambda: infer_image(first))
    h2d_ms = cuda_ms(lambda: first.to(device, non_blocking=True), reps=5)
    log(f"image server stages per batch of {BATCH}: the collector's copy "
        f"into pinned staging {copy_ms:.2f} ms and infer_fn's enqueue "
        f"{enqueue_ms:.2f} ms (host clock, median of 5); H2D {h2d_ms:.3f} "
        f"ms, kernel: phase 4, ViT-S {img['model_ms']:.3f} ms (CUDA events)")
    out["image"] = img

    clips = frames.reshape(n_images // frames_per_clip, frames_per_clip,
                           rows, SRC_W)[:n_clips]
    with InferenceServer(infer_clip, clips.shape[1:], np.uint8, max_batch=4,
                         max_wait_ms=5, device=device) as s:
        t0 = time.perf_counter()
        s.warmup()
        log(f"clip server warm-up ({len(s.buckets)} buckets): "
            f"{time.perf_counter() - t0:.1f} s")
        clip = _serve("clip server 8x1080p->fused_resize_csc->video-"
                      "ResNet-50 bf16", s, list(clips), 2, (400,))
        _served_vs_direct("clip server", s, clip.pop("results")[:4],
                          list(clips[:4]), infer_clip)
    xc = x.view(4, frames_per_clip, OUT, OUT, 3)
    _bf16_vs_f32("video-ResNet-50 (attention head)", vres, vres32, xc)
    with torch.no_grad():
        clip["model_ms"] = cuda_ms(lambda: vres(xc), reps=3)
    log(f"video-ResNet-50 bf16 device-resident: {clip['model_ms']:.3f} ms "
        f"per batch of 4 clips x {frames_per_clip} frames")
    out["clip"] = clip

    vvit, vvit32 = _seeded_model(
        lambda dt: video_vit_small(400, dtype=dt, frames=frames_per_clip,
                                   image_size=(OUT, OUT)), device, 3)
    _bf16_vs_f32("VideoViT-S", vvit, vvit32, xc)
    with torch.no_grad():
        ms = cuda_ms(lambda: vvit(xc), reps=5)
    log(f"VideoViT-S bf16 device-resident: {ms:.3f} ms per batch of 4 "
        f"clips x {frames_per_clip} frames")
    pipe_seg = FusedPipeline(PixelFormat.YUV420, ColorSpace.BT_709,
                             ColorRange.MPEG, (SEG, SEG), output="normalized",
                             device=device, kernel="cuda")
    xs = pipe_seg(first[:8].to(device))
    _pipe_vs_plain(pipe_seg, first[:8], xs)
    fcn, fcn32 = _seeded_model(lambda dt: fcn_resnet(21, dtype=dt), device, 4)
    with torch.no_grad():
        seg = fcn(xs)
    require(tuple(seg.shape) == (8, SEG, SEG, 21),
            f"FCN output {tuple(seg.shape)}")
    _bf16_vs_f32("FCN-ResNet", fcn, fcn32, xs)
    with torch.no_grad():
        ms = cuda_ms(lambda: fcn(xs), reps=5)
    log(f"FCN-ResNet bf16 device-resident: {ms:.3f} ms per batch of 8 at "
        f"{SEG}x{SEG} (output (8, {SEG}, {SEG}, 21))")
    return out


# ---- phase 9 -------------------------------------------------------------------

#: (dx, dy) of frame k+1 against frame k, whole pixels
SHIFTS = [(3, -2), (-4, 1), (2, 2), (0, -3), (5, 0), (-1, -1), (1, 4),
          (-3, 3)]


def _texture(h, w, seed):
    """Smooth seeded luma texture (0-255 float32, CPU): noise on a grid 8×
    coarser, bicubic up, contrast set by its spread."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((1, 1, h // 8 + 4, w // 8 + 4), generator=g)
    up = torch.nn.functional.interpolate(coarse, scale_factor=8,
                                         mode="bicubic", align_corners=False)
    t = up[0, 0, 16:16 + h, 16:16 + w]
    t = (t - t.mean()) / t.std()
    return (128.0 + 45.0 * t).clamp(0.0, 255.0)


def _moving(h, w, offsets, seed, pad=32):
    """u8 frames cut from one texture at the given whole-pixel offsets:
    frame k holds the texture moved by offsets[k]."""
    tex = _texture(h + 2 * pad, w + 2 * pad, seed)
    return torch.stack([tex[pad - dy:pad - dy + h, pad - dx:pad - dx + w]
                        for dx, dy in offsets]).round().to(torch.uint8)


def _analysis_inputs(h, w):
    """The seeded inputs of phase 9 at h×w, on the CPU."""
    rng = np.random.default_rng(31)
    path = np.cumsum([(0, 0)] + SHIFTS, axis=0)
    jitter = rng.integers(-3, 4, (32, 2))
    jitter[0] = 0
    pan = [(k, 0) for k in range(16)]
    shots = torch.cat([_moving(h, w, pan, 33),
                       _moving(h, w, [(0, k) for k in range(16)], 34)])
    return dict(seq=_moving(h, w, [tuple(p) for p in path], 32),
                shots=shots, jittered=_moving(h, w, jitter.tolist(), 35))


def _analysis_ops(inp, dev):
    """Every analysis op once on ``inp`` moved to ``dev``."""
    from videoprocessingframework_torch.ops import (
        flow,
        metrics,
        scenecut,
        stabilize,
    )

    seq = inp["seq"].to(dev)
    prev, nxt = seq[:-1], seq[1:]
    fl = flow.lucas_kanade_flow(prev, nxt)
    warped = flow.warp_image(nxt, fl)
    out = dict(flow=fl, warped=warped,
               mid=flow.interpolate_midpoint(prev[:2], nxt[:2]),
               steps=stabilize.global_translations(seq),
               psnr=metrics.psnr(warped, prev),
               ssim=metrics.ssim(warped, prev),
               ms_ssim=metrics.ms_ssim(warped, prev),
               scores=scenecut.scene_cut_scores(inp["shots"].to(dev)))
    stab, corr = stabilize.stabilize_clip(inp["jittered"].numpy(), sigma=4.0,
                                          device=dev)
    out.update(stabilized=torch.from_numpy(stab),
               correction=torch.from_numpy(corr))
    return out


#: CUDA vs CPU at 270×480 (float32 both; cuDNN TF32 off for the CUDA run):
#: pixels of flow, codes of u8 frames (a rounding boundary), and for the
#: metrics and scores an error relative to the largest value
ANALYSIS_TOL = {"flow": 1e-3, "steps": 1e-3, "correction": 1e-3,
                "warped": 1, "mid": 1, "stabilized": 1}
ANALYSIS_REL_TOL = {"psnr": 1e-4, "ssim": 1e-4, "ms_ssim": 1e-4,
                    "scores": 1e-4}


def analysis_path(device) -> None:
    """Phase 9: the analysis ops on seeded 1080p luma with known motion,
    cuts and jitter; each against the same port function on the CPU at
    270×480; ms per call by CUDA events."""
    from videoprocessingframework_torch.ops import (
        flow,
        metrics,
        scenecut,
        stabilize,
    )

    small = _analysis_inputs(270, 480)
    # float32 on both sides: the separable convolutions without TF32 for
    # the comparison alone; the 1080p checks and timings below run at
    # torch's default (cuDNN TF32 on), as users call the ops
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = _analysis_ops(small, device)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    want = _analysis_ops(small, torch.device("cpu"))
    for k, tol in {**ANALYSIS_TOL, **ANALYSIS_REL_TOL}.items():
        a, b = got[k].cpu().double(), want[k].double()
        err = (a - b).abs().max().item()
        rel = k in ANALYSIS_REL_TOL
        if rel:
            err /= b.abs().max().item()
        log(f"analysis {k} 270x480: CUDA (TF32 off) vs CPU max "
            f"{'relative ' if rel else ''}diff {err:.3g} (tol {tol})")
        require(err <= tol, f"analysis {k}: CUDA vs CPU")

    tf32 = "on" if torch.backends.cudnn.allow_tf32 else "off"
    inp = {k: v.to(device) for k, v in
           _analysis_inputs(SRC_H, SRC_W).items()}
    seq, m = inp["seq"], 16
    prev, nxt = seq[:-1], seq[1:]
    fl = flow.lucas_kanade_flow(prev, nxt)
    want = torch.tensor(SHIFTS, dtype=torch.float32, device=device)
    med = stabilize.median(fl[:, m:-m, m:-m].reshape(len(SHIFTS), -1, 2))
    steps = stabilize.global_translations(seq)
    ferr = (med - want).abs().max().item()
    serr = (steps - want).abs().max().item()
    log(f"analysis 1080p (cuDNN TF32 {tf32}): "
        f"lucas_kanade_flow on {len(SHIFTS)} pairs, interior median vs the "
        f"known shift: max error {ferr:.4f} px; global_translations: "
        f"{serr:.4f} px (tol 0.1)")
    require(ferr <= 0.1 and serr <= 0.1, "recovered shift")
    warped = flow.warp_image(nxt, fl)
    p = metrics.psnr(warped[:, m:-m, m:-m], prev[:, m:-m, m:-m])
    log(f"analysis 1080p: warp_image(next, flow) vs prev on the "
        f"interior: PSNR min {p.min().item():.2f} dB (tol 35)")
    require(p.min().item() >= 35.0, "warp PSNR")
    mid = flow.interpolate_midpoint(prev[:2], nxt[:2])
    require(mid.shape == prev[:2].shape and mid.dtype == torch.uint8,
            "interpolate_midpoint shape")
    s = metrics.ssim(prev, prev)
    require(bool(torch.isinf(metrics.psnr(prev, prev)).all())
            and (s - 1).abs().max().item() < 1e-5
            and bool((metrics.ms_ssim(warped, prev) < 1).all()),
            "metrics on equal and unequal frames")
    cuts = scenecut.detect_cuts(scenecut.scene_cut_scores(inp["shots"]))
    log(f"analysis 1080p: scene cuts in 32 frames: {cuts} (want [15])")
    require(cuts == [15], "scene cut")
    jit = inp["jittered"]
    stab, _ = stabilize.stabilize_clip(jit.cpu().numpy(), sigma=4.0,
                                       device=device)
    raw = stabilize.global_translations(jit).abs().mean().item()
    res = stabilize.global_translations(
        torch.from_numpy(stab).to(device)).abs().mean().item()
    log(f"analysis 1080p: stabilize_clip on 32 jittered frames: mean "
        f"|frame-to-frame shift| {raw:.3f} px -> {res:.3f} px")
    require(res < 0.35 * raw, "stabilisation removes jitter")

    times = {
        f"lucas_kanade_flow ({len(SHIFTS)} pairs)":
            lambda: flow.lucas_kanade_flow(prev, nxt),
        f"warp_image ({len(SHIFTS)} frames)":
            lambda: flow.warp_image(nxt, fl),
        "interpolate_midpoint (2 pairs)":
            lambda: flow.interpolate_midpoint(prev[:2], nxt[:2]),
        f"global_translations ({len(SHIFTS) + 1} frames)":
            lambda: stabilize.global_translations(seq),
        f"psnr ({len(SHIFTS)} pairs)": lambda: metrics.psnr(warped, prev),
        f"ssim ({len(SHIFTS)} pairs)": lambda: metrics.ssim(warped, prev),
        f"ms_ssim ({len(SHIFTS)} pairs)":
            lambda: metrics.ms_ssim(warped, prev),
        "scene_cut_scores (32 frames)":
            lambda: scenecut.scene_cut_scores(inp["shots"]),
    }
    line = ", ".join(f"{k} {cuda_ms(fn, reps=5):.3f}"
                     for k, fn in times.items())
    log(f"analysis 1080p ms per call (CUDA events, cuDNN TF32 {tf32}): "
        f"{line}")


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
    served = serving_path(device)
    analysis_path(device)

    t = times["normalized"]
    c = conv["times"]["nv12"]
    record = {"kernels": [{
        "name": "fused_resize_csc",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": run["launches"] + served["image"]["launches"]
        + served["clip"]["launches"],
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
