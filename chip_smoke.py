#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (videoprocessingframework_torch) on
one NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py            # needs one CUDA device; no arguments

Phases, each of which raises on failure:

1. Device: CUDA must be available; prints the card's name and power limit.
2. Build: the CUDA kernel library (nvcc, sm_90a), the JPEG entropy coder
   (libvpf_jpeg, g++ only) and, where the libav development files exist,
   the native host library; all at once, beside
   an ``nvcc -Xptxas -v`` compile of fused_resize_csc.cu whose registers,
   shared memory and spills are printed per kernel. Without the libav
   development files it prints which libav runtime libraries the dynamic
   linker knows (``ldconfig -p``).
3. fused_resize_csc (the band kernel) vs its first version (the direct
   entry point: 0 codes, 0.0), vs its plain version and vs the float64
   golden (rgb_u8 and rgb_f32, in codes), planar and NV12 × rgb_u8 /
   rgb_f32 / normalized, at 1080p→224² ×32, 2160p→224² ×4, 464×848→61×45
   ×2, at the shapes the serving path launches (phase 8): 1080p→224² at
   every smaller bucket (×1-16, where the plan cuts shorter bands) and
   1080p→512² ×8 (the FCN's input), and at the device-transcode chain's
   1080p→1080p ×4 (phase 11a); then 1080p→224² ×32 at full-range BT.601
   (the JPEG convention, phase 12); each line names the plan it took.
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

10. Training path: (a) the clip loader (pinned ring, one upload a batch
   on a side stream) → FusedPipeline(kernel="cuda", normalized) at
   1080p→224², 4 clips × 8 frames a batch → video-ResNet-50 (attention
   head, bf16 compute, float32 params) → make_train_step, SGD 0.01
   momentum 0.9, 20 steps; (b) the same clips → AugmentPipeline (crop,
   flip, brightness/contrast/saturation, hue) → mixup_cutmix →
   video-ViT-S, Adam 1e-3, 10 steps. Without libav the loader is
   HostClipLoader, seeded 1080p streams through the same ring, upload and
   pipeline (no decode). Checks: kernel launches ≥ steps in (a), finite
   losses that fall in both, the first batch vs the plain version, one
   augmented batch vs the same params on the CPU, one float32 train step
   on CUDA vs the CPU (video-ResNet-18-like at 64², TF32 off); prints step
   ms, clips/s, the kernel's share of a step and peak memory.
11. Encode side: (a) the device-transcode chain of
   samples/sample_device_transcode.py at 1080p: seeded YUV420 batches of 4
   (HostBatchRing) → FusedPipeline(kernel="cuda", rgb_f32, 1:1) → the rows
   H/3…H/2 darkened → encode_feed to 720p, then to 1080p with no resize →
   planes_to_host_packed → VideoEncoder → StreamMuxer (the last two where
   libav builds); encode_feed and encode_feed_gray on CUDA vs the CPU and
   the float64 golden (≤1 code), the kernel's launches ≥ batches, CUDA-event
   ms of the kernel and of encode_feed beside its arithmetic floor, frames/s
   of the chain. (b) The PyNvCodec namespace (compat): PyFrameUploader →
   PySurfaceConverter(NV12 → RGB_PLANAR, csc_rgb_planar) → PySurfaceResizer
   → PySurfaceDownloader at 1080p vs the golden and the plain resize,
   GpuMem() as data_ptr() across an in-place copy, csc_rgb_planar's
   launches over this phase. (c) Where libav builds: MultiStreamPipeline,
   Transcoder, PyNvDecoder and PyNvEncoder; else one line each.
12. The split MJPEG codec (no libav needed), 32 seeded, textured 1080p
   RGB frames: (a) JpegDeviceEncoder (q90, 4:2:0) on the card vs the CPU
   and golden_encode on the same planes (≤1, the share that differs
   printed), then JpegCoefEncoder → 32 JPEGs; (b) JpegCoefDecoder gives
   the coefficients back exactly, JpegDevicePipeline planes vs
   golden_decode and the CPU (≤1 code), normalized / rgb_u8 at 224²
   through the band kernel (one launch a batch) vs
   FusedPipeline(kernel="torch") on the same planes (phase 3's bars),
   small 4:2:2 and gray streams through the torch route vs the CPU;
   (c) JpegDeviceTranscoder to 720p q75 vs the CPU (≤1), re-encoded,
   decoded back, luma PSNR vs the source; (d) MjpegWriter's raw stream
   split at SOI/EOI and decoded; MjpegReader, MjpegTranscoder and
   MjpegClipLoader where libav builds, else one line each. Then host
   entropy ms a frame at 1 and the default workers, the dequant + IDCT
   ms (CUDA events) beside its bound, the band kernel on these planes,
   and the decode and encode chains in frames/s (host clock).

13. The parallel layer (parallel/mesh.py, multidevice.py, multihost.py,
   the dp × tp step) in a world of one, NCCL, mesh (1, 1) ("data",
   "model"), FileStore rendezvous in the run's temp dir, 60 s timeout:
   (a) ShardedVideoPipeline(FusedPipeline(YUV420, BT.709, MPEG, 224²,
   lanczos, normalized, kernel="cuda")) over 48 seeded 1080p ×32 batches
   of HostBatchRing: the local shard bit-equal to the single-device
   FusedPipeline, sharded_batch_matches_single_device, the kernel's
   launches ≥ batches, ms a batch beside phase 4's kernel ms; (b)
   GlobalBatchAssembler over the same ring through the same pipeline;
   (c) phase 10 (a)'s trainer as the dp × tp step (the loader with
   sharding=, video-ResNet-50, bf16, SGD 0.01 momentum 0.9, 20 steps):
   losses finite and falling, launches ≥ steps, step ms, host enqueue,
   device busy and peak memory beside phase 10 (a)'s; one float32 step
   of resnet18_like at 64² on the mesh vs the single-device step (TF32
   off, phase 10's bars); (d) where libav builds, MultiDeviceStreamPipeline
   over [cuda:0] and MultiHostVideoPipeline, else one line each; (e) two
   gloo ranks on the one card, mesh (2, 1), the dp step of resnet18_like
   vs the single-device step — or the error, on a line of its own, where
   gloo refuses a CUDA collective the step needs.

14. The samples (videoprocessingframework_torch/samples), each through
   its own ``run`` on seeded frames, since the card's machine has no libav
   to decode tests/assets/test.mp4 with: (a) sample_resnet.run at full
   width, 8 batches of 32 seeded 1080p NV12 frames → FusedPipeline
   (normalized, 224², the NV12 instantiation of fused_resize_csc, whose
   first path this is) → ResNet-50 bf16: frames/s (host clock), ResNet-50
   ms a batch (CUDA events), the kernel's launches over this run alone
   (≥ batches), and one batch in float32 on CUDA (TF32 off) vs run on the
   CPU (top-1 equal, logits within SAMPLE_LOGIT_TOL); (b) sample_segmentation
   (8 frames, one a call, NV12 → FCN), sample_serving (64 packed 1080p
   YUV420 requests from 4 clients → ResNet18-like), sample_aot_compile
   (torch.export, save and load of ResNet-50 on the card; the reloaded
   program against eager; a wrong batch refused), the device half of
   sample_device_transcode (to 720p; vs the CPU ≤1 code) and of
   sample_torch (Surface ↔ tensor, exact), sample_remap (vs the CPU ≤1
   code), sample_scenecut (the cut of phase 9's shots), sample_stabilize
   (jitter reduced) and sample_flow_interp (a known pan recovered, the
   midpoint beating frame repeat); (c) sample_train_video.run on phase
   10's seeded source on a mesh (1, 1), 8 steps with a checkpoint that a
   fresh model, optimizer and loader resume from with equal weights;
   (d) every sample's main() on tests/assets/test.mp4 where libav builds,
   else one line a sample naming the missing library. Prints the NV12
   instantiation's launches (14a and the segmentation run) on a line of
   its own. Phase 14 runs at torch's default cuDNN setting (no benchmark
   search at each new shape), as a sample does; 14c times its first step
   apart.

15. The model layer's kernels (models/layers_cuda.py): LayerNorm
   (csrc/layer_norm.cu) and MoonViT's RoPE of q and k (csrc/rope2d.cu)
   against their plain versions at the shapes the cells run (MoonViT's
   32,768 × 1152 rows and pre_norm's (8, 1024, 4, 1152) bf16 → bf16;
   ViT-S/16's 32·197 × 384 rows and class-token rows bf16 → float32;
   RoPE of an (8, 4096, 3, 16, 72) bf16 QKV output on the 64×64 grid and
   of an 8-frame 6×10 grid): bf16 stores within one bf16 ulp, float32
   within 1e-5 of the largest value; each timed beside its bound (each
   byte read once and written once) and the plain chain's time, and
   LayerNorm beside ``F.layer_norm`` on bf16 rows where that one call
   computes the same function. (b) The published MoonViT
   (``kimi_vl_moonvit()``) at the cell's 8 frames of 896², one eager
   forward, counted alone: 56 LayerNorm and 27 RoPE launches, in
   ``csrc/launch.py``'s ``LAUNCHES`` and in ``vision_stats``; then the same
   forward on the plain versions, its output's largest gap from the
   kernels' and both forwards' CUDA-event times.

The line before the last is the per-kernel JSON record (launches of
fused_resize_csc counted over phases 5, 8, 10 (a), 11a, 11c, 12, 13 and
14 (a)-(c), of csc_rgb_planar over phases 6 and 11b; of layer_norm and
rope2d counted a path at a time, each path's own count under
``launches_by_path``: the models of phases 5-14, what the count gained
over each path, and 15 (b)); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import pathlib
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
#: whose plans cut shorter bands, and the FCN's 8 frames at SEG²; then
#: the device-transcode chain's 1:1 batch (phase 11a: 18 column tiles,
#: the last ragged); then the MoonViT cell's 8 frames at 896² (8 tiles of
#: 112 columns)
KERNEL_CHECKS = [(BATCH, SRC_H, SRC_W, OUT, OUT), (4, 2160, 3840, OUT, OUT),
                 (2, 464, 848, 61, 45)] + [
    (b, SRC_H, SRC_W, OUT, OUT) for b in (1, 2, 4, 8, 16)] + [
    (8, SRC_H, SRC_W, SEG, SEG), (4, SRC_H, SRC_W, SRC_H, SRC_W),
    (8, SRC_H, SRC_W, 896, 896)]
#: checks at full-range BT.601, the JPEG convention: what the split MJPEG
#: decoder (phase 12) launches
JPEG_KERNEL_CHECKS = [(BATCH, SRC_H, SRC_W, OUT, OUT)]
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

    jobs = [("kernels", kbuild.load_kernels), ("ptxas", ptxas_report),
            ("jpeg", hbuild.build_jpeg)]
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
            f"({missing}); libav runtime libraries (ldconfig -p): "
            f"{libav_runtime()}")
    return missing


def libav_runtime() -> str:
    """The libav shared libraries the dynamic linker knows, or 'none'."""
    for exe in ("ldconfig", "/sbin/ldconfig"):
        try:
            out = subprocess.run([exe, "-p"], capture_output=True, text=True,
                                 timeout=60).stdout
            break
        except FileNotFoundError:
            out = ""
    names = sorted({line.split()[0] for line in out.splitlines()
                    if re.match(r"\s*lib(avcodec|avformat|avutil)\.so",
                                line)})
    return ", ".join(names) or "none"


# ---- phase 3 -------------------------------------------------------------------


def _colorimetry(jpeg: bool) -> tuple:
    """(space, range): full-range BT.601 for JPEG, else BT.709 / MPEG."""
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
    )

    if jpeg:
        return ColorSpace.BT_601, ColorRange.JPEG
    return ColorSpace.BT_709, ColorRange.MPEG


def _golden(y, u, v, out_h, out_w, jpeg=False):
    """float64 golden (B, 3, H', W') on numpy planes."""
    from videoprocessingframework_torch.ops import colorspace as cs
    from videoprocessingframework_torch.ops.resize import resize_matrix

    h, w = y.shape[-2:]
    rm = resize_matrix(h, out_h).astype(np.float64)
    cm = resize_matrix(w, out_w).astype(np.float64)

    def rsz(p):
        return np.matmul(np.matmul(rm, p.astype(np.float64)), cm.T)

    up = lambda c: np.repeat(np.repeat(c, 2, 1), 2, 2)  # noqa: E731
    m, off = cs.rgb_from_ycbcr_matrix(*_colorimetry(jpeg))
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
    modes, TOL) and vs golden (rgb_u8 and rgb_f32 in codes, two frames).
    Returns the largest u8 error seen against the plain version."""
    from videoprocessingframework_torch.ops import fused_cuda as fc

    worst, worst_direct = 0.0, 0.0
    checks = ([(c, False) for c in KERNEL_CHECKS]
              + [(c, True) for c in JPEG_KERNEL_CHECKS])
    for (b, h, w, oh, ow), jpeg in checks:
        y, u, v = _seeded_yuv(b, h, w, seed=h + b + oh, device=device)
        uv = _interleave(u, v)
        gold = _golden(*(p[:2].cpu().numpy() for p in (y, u, v)), oh, ow,
                       jpeg)
        space, rng = _colorimetry(jpeg)
        tag = f"{h}x{w}->{oh}x{ow} b{b}{' BT601/JPEG' if jpeg else ''}"
        for layout in ("planar", "nv12"):
            chroma = (u, v) if layout == "planar" else (uv,)
            p = fc.plan_for(y, *chroma, out_h=oh, out_w=ow)
            log(f"check {layout} {tag}: plan {p.rows} "
                f"rows x {p.cols} cols, {p.n_bands} bands x {p.n_tiles} "
                f"tiles")
            for out in ("rgb_u8", "rgb_f32", "normalized"):
                kw = dict(out_h=oh, out_w=ow, output=out, space=space,
                          rng=rng)
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
                line = (f"check {layout} {tag} {out}: "
                        f"max|band-direct| {derr:.3g} (tol 0), "
                        f"max|band-plain| {err:.3g} (tol {TOL[out]})")
                if out in ("rgb_u8", "rgb_f32"):
                    codes = got[:2].cpu().numpy().astype(np.float64)
                    if out == "rgb_f32":
                        codes *= 255.0
                    gerr = np.abs(codes - gold).max()
                    line += f", max|band-golden| {gerr:.3g} codes (tol 1)"
                    require(gerr <= 1, line)
                if out == "rgb_u8":
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
    from videoprocessingframework_torch.csrc import launch
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
        return fps, stages, f.upload_stats

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
            counted = launch.LAUNCHES["fused_resize_csc"]
            fps, st, up = run(postproc, consume, n_batches)
            launches = launch.LAUNCHES["fused_resize_csc"] - counted
            log(f"{src}->{name} fps: {fps:.1f} over {n_batches} batches of "
                f"{BATCH} (per batch ms: {st}); upload_stats {up}; "
                f"fused_resize_csc launches in this run: {launches}")
            # on the card, every batch copied straight from its
            # page-locked slot
            require(device.type != "cuda" or (up["direct"] == n_batches
                                              and up["staged"] == 0),
                    f"{src}->{name}: upload_stats {up}")
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
    from videoprocessingframework_torch.csrc import launch
    from videoprocessingframework_torch.interop import (
        FrameUploader,
        SurfaceDownloader,
    )
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
    counted = launch.LAUNCHES["csc_rgb_planar"]
    t0 = time.perf_counter()
    for _ in range(n):
        out = down(conv.Execute(up(frame), ctx))
    fps = n / (time.perf_counter() - t0)
    launches = launch.LAUNCHES["csc_rgb_planar"] - counted
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
    from videoprocessingframework_torch.csrc import launch
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
    counted = launch.LAUNCHES["csc_rgb_planar"]
    fps = run(n_batches)
    launches = launch.LAUNCHES["csc_rgb_planar"] - counted
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
    from videoprocessingframework_torch.csrc import launch

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
    counted = launch.LAUNCHES["fused_resize_csc"]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = launch.LAUNCHES["fused_resize_csc"] - counted
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
    from videoprocessingframework_torch.data.loader import seeded_frames
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
    frames = seeded_frames(n_images, rows, SRC_W, seed=21)
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


# ---- phase 10 ------------------------------------------------------------------

#: the fed training loop: TRAIN_B clips of TRAIN_T frames a batch, from
#: TRAIN_STREAMS streams of TRAIN_FRAMES 1080p frames, labelled per
#: stream. One window a stream puts every label in every batch once, so
#: batch losses compare from step to step (with 4 windows a stream a
#: batch's labels vary, and its loss with them: 0.73-11.72 on the card)
TRAIN_B, TRAIN_T = 4, 8
TRAIN_STREAMS, TRAIN_FRAMES = 4, 8
TRAIN_LABELS = [3, 101, 250, 399]
PLAIN_STEPS, AUG_STEPS = 20, 10
#: steps of the fed loop before its clips/s window opens (cuDNN plans,
#: allocations)
TRAIN_WARM = 3
#: one float32 train step (TF32 off) on CUDA vs the CPU from the same
#: weights (video-ResNet-18-like at 64²): loss relative, parameters
#: relative to each tensor's largest magnitude
STEP_LOSS_TOL, STEP_PARAM_TOL = 1e-4, 1e-3
#: an augmented batch on CUDA vs the same params applied on the CPU
#: (float32 both, TF32 off; normalized units)
AUG_TOL = 1e-4


def _train_source(device, libav_missing: str, tmpdir: str):
    """``make_loader(**kw)``: VideoClipLoader over make_clip files where
    the host library builds; without libav, HostClipLoader over seeded
    1080p streams (the same ring, upload and pipeline; no decode)."""
    from videoprocessingframework_torch.data import (
        HostClipLoader,
        VideoClipLoader,
    )

    common = dict(clip_len=TRAIN_T, batch_size=TRAIN_B, out_size=(OUT, OUT),
                  output="normalized", labels=TRAIN_LABELS, seed=41,
                  device=device)
    if libav_missing:
        log(f"training path: host decode stage did not run: libav "
            f"development files are absent ({libav_missing}); the loader's "
            f"ring, upload and pipeline are fed {TRAIN_STREAMS} seeded "
            f"{SRC_W}x{SRC_H} YUV420 streams of {TRAIN_FRAMES} frames from "
            f"host memory (HostClipLoader)")
        return lambda **kw: HostClipLoader(
            SRC_W, SRC_H, TRAIN_STREAMS, TRAIN_FRAMES, **{**common, **kw})
    from videoprocessingframework_torch.io.encoder import make_clip

    # a luma level a stream (as HostClipLoader's), so the labels are
    # learnable
    paths = [str(make_clip(f"{tmpdir}/train_{k}.h264", SRC_W, SRC_H,
                           TRAIN_FRAMES, level=40 + 50 * k))
             for k in range(TRAIN_STREAMS)]
    log(f"training path: VideoClipLoader decodes {TRAIN_STREAMS} make_clip "
        f"streams of {TRAIN_FRAMES} {SRC_W}x{SRC_H} frames")
    return lambda **kw: VideoClipLoader(
        paths, lengths=[TRAIN_FRAMES] * TRAIN_STREAMS, shuffle=False,
        workers=1, **{**common, **kw})


def _first_packed(make_loader) -> torch.Tensor:
    """The packed frames (B·T, rows, W) of epoch 0's first batch."""
    x, _ = next(iter(make_loader(output="packed").epoch(0)))
    return x.reshape(-1, *x.shape[2:])


def _fed_loop(loader, step, n_steps, prepare):
    """``n_steps`` train steps over the loader's epochs 0, 1, …; returns
    the losses (host), the first batch and its labels, and the wall
    seconds of the steps after the first TRAIN_WARM (host clock,
    synchronised at both ends of that window)."""
    losses, first = [], {}
    epoch = 0
    while len(losses) < n_steps:
        for x, labels in loader.epoch(epoch):
            if not first:
                first.update(x=x.clone(), labels=labels)
            if len(losses) == TRAIN_WARM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            image, label = prepare(x, labels, len(losses))
            losses.append(step({"image": image, "label": label})["loss"])
            if len(losses) == n_steps:
                break
        epoch += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return torch.stack(losses).float().cpu(), first, wall


def _step_ms(step, batch, reps=5) -> float:
    """Median time of one train step on a device-resident batch, by CUDA
    events around each step (the device's time, gaps while it waits for
    the host's enqueue included)."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    step(batch)
    torch.cuda.synchronize()
    for s, e in ev:
        s.record()
        step(batch)
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def _device_profile(fn, reps=3):
    """(device-busy ms per call, the five longest kernels as (name, ms per
    call)) over ``reps`` calls, from a torch.profiler trace of the card
    (the sum of the kernels' and copies' device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / reps)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(t for _, t in rows), rows[:5]


def _top(rows) -> str:
    return "; ".join(f"{k[:60]} {t:.3f}" for k, t in rows)


def _train_report(name, losses, wall, loader, step, batch, kernel_ms):
    """Print and check one trainer's run; returns its numbers."""
    require(bool(torch.isfinite(losses).all()), f"{name}: non-finite loss")
    require(losses[-1] < losses[0], f"{name}: loss did not fall "
            f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = _step_ms(step, batch)
    enqueue = _host_ms(lambda: step(batch))
    busy, top = _device_profile(lambda: step(batch))
    clips = (len(losses) - TRAIN_WARM) * TRAIN_B / wall
    stages = ", ".join(f"{k} {v['mean_ms']:.2f}"
                       for k, v in loader.timer.summary().items())
    log(f"{name}: losses {', '.join(f'{v:.4f}' for v in losses.tolist())}")
    log(f"{name}: {len(losses)} steps of {TRAIN_B} clips x {TRAIN_T} frames; "
        f"after {TRAIN_WARM} warm-up steps {clips:.2f} clips/s of the fed "
        f"loop (host clock; loader ms per batch: {stages}); step {ms:.2f} ms "
        f"(CUDA events, device-resident batch, median of 5), host enqueue of "
        f"a step {enqueue:.2f} ms (host clock); device busy {busy:.2f} ms a "
        f"step ({100 * (1 - busy / ms):.1f}% idle; torch.profiler); peak "
        f"memory {peak:.2f} GiB (torch.cuda.max_memory_allocated)"
        + (f"; fused_resize_csc {kernel_ms:.4f} ms = "
           f"{100 * kernel_ms / ms:.2f}% of the step" if kernel_ms else ""))
    log(f"{name}: longest kernels of a step (ms): {_top(top)}")
    return {"step_ms": ms, "clips_per_s": clips, "peak_gib": peak,
            "enqueue_ms": enqueue, "busy_ms": busy}


def check_train_step(device) -> None:
    """One float32 step (TF32 off) of video-ResNet-18-like at 64² on CUDA
    against the same step on the CPU from the same weights."""
    from videoprocessingframework_torch.models import video_resnet18_like
    from videoprocessingframework_torch.parallel import make_train_step

    torch.manual_seed(11)
    cpu = video_resnet18_like(8, "attention", dtype=torch.float32,
                              frames=TRAIN_T)
    gpu = video_resnet18_like(8, "attention", dtype=torch.float32,
                              frames=TRAIN_T)
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(device)
    g = torch.Generator().manual_seed(12)
    x = torch.randn((2, TRAIN_T, 64, 64, 3), generator=g)
    labels = torch.tensor([1, 5])

    def sgd(m):
        return torch.optim.SGD(m.parameters(), lr=0.01, momentum=0.9)

    torch.backends.cudnn.allow_tf32 = False
    try:
        got = make_train_step(gpu, sgd(gpu))(
            {"image": x.to(device), "label": labels.to(device)})
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    want = make_train_step(cpu, sgd(cpu))({"image": x, "label": labels})
    loss_rel = _rel(got["loss"].cpu(), want["loss"])
    params_rel = max(_rel(a.cpu(), b) for a, b in zip(
        gpu.state_dict().values(), cpu.state_dict().values())
        if a.is_floating_point())
    line = (f"train step video-ResNet-18-like 64x64 float32 (TF32 off), CUDA "
            f"vs CPU from the same weights: loss {got['loss'].item():.6f} vs "
            f"{want['loss'].item():.6f}, relative {loss_rel:.3g} (tol "
            f"{STEP_LOSS_TOL}); parameters and running statistics after the "
            f"step, largest relative difference {params_rel:.3g} (tol "
            f"{STEP_PARAM_TOL})")
    log(line)
    require(loss_rel <= STEP_LOSS_TOL and params_rel <= STEP_PARAM_TOL, line)


def train_plain(device, make_loader) -> dict:
    """(a) the fed loop through the band kernel → video-ResNet-50
    (attention head, bf16 compute, float32 params), SGD 0.01 momentum
    0.9."""
    from videoprocessingframework_torch.core.enums import PixelFormat
    from videoprocessingframework_torch.csrc import launch
    from videoprocessingframework_torch.models import video_resnet50
    from videoprocessingframework_torch.ops import fused_cuda as fc
    from videoprocessingframework_torch.ops.fused import unpack_yuv_planes
    from videoprocessingframework_torch.parallel import make_train_step

    loader = make_loader(kernel="cuda")
    torch.manual_seed(10)
    model = video_resnet50(400, "attention", dtype=torch.bfloat16,
                           frames=TRAIN_T).to(device,
                                              memory_format=torch.channels_last)
    step = make_train_step(model, torch.optim.SGD(
        model.parameters(), lr=0.01, momentum=0.9))
    torch.cuda.reset_peak_memory_stats()
    counted = launch.LAUNCHES["fused_resize_csc"]
    losses, first, wall = _fed_loop(loader, step, PLAIN_STEPS,
                                    lambda x, labels, i: (x, labels))
    launches = launch.LAUNCHES["fused_resize_csc"] - counted
    log(f"(a) loader -> fused_resize_csc -> video-ResNet-50 train step: "
        f"fused_resize_csc launches in this run: {launches}")
    require(launches >= PLAIN_STEPS,
            f"{launches} kernel launches for {PLAIN_STEPS} steps")

    packed = _first_packed(make_loader)
    y, u, v, _, _ = unpack_yuv_planes(PixelFormat.YUV420, (packed,))
    pipe = loader.pipeline
    want = fc.fused_yuv420_resize_rgb_ref(
        y, u, v, out_h=OUT, out_w=OUT, space=pipe.space, rng=pipe.range,
        output="normalized", mean=pipe.mean, std=pipe.std,
    ).permute(0, 2, 3, 1)
    err = (first["x"].reshape(want.shape) - want).abs().max().item()
    log(f"(a) first batch from the kernel vs its plain version "
        f"(normalized): max abs {err:.3g} (tol {TOL['normalized']})")
    require(err <= TOL["normalized"], "first training batch vs plain")

    kernel_ms = cuda_ms(lambda: pipe(packed), reps=10)
    batch = {"image": first["x"], "label": first["labels"]}
    rec = _train_report("(a) plain trainer", losses, wall, loader, step,
                        batch, kernel_ms)
    return dict(rec, launches=launches, max_abs_err=err,
                kernel_ms=kernel_ms)


def train_augmented(device, make_loader) -> dict:
    """(b) the fed loop through AugmentPipeline → mixup_cutmix →
    video-ViT-S (stat-less, bf16 compute), Adam 1e-3."""
    from videoprocessingframework_torch.core.enums import PixelFormat
    from videoprocessingframework_torch.models import video_vit_small
    from videoprocessingframework_torch.ops.augment import (
        AugmentSpec,
        augment_postproc,
        counter_seed,
        mixup_cutmix,
        sample_mixup_params,
    )
    from videoprocessingframework_torch.parallel import make_train_step

    spec = AugmentSpec(crop=True, crop_scale=(0.5, 1.0), hflip=0.5,
                       brightness=0.3, contrast=0.3, saturation=0.3, hue=0.1)
    loader = make_loader(augment=spec)
    torch.manual_seed(20)
    model = video_vit_small(400, dtype=torch.bfloat16, frames=TRAIN_T,
                            image_size=(OUT, OUT)).to(device)
    step = make_train_step(model, torch.optim.Adam(model.parameters(),
                                                   lr=1e-3))

    def mix(x, labels, i):
        params = sample_mixup_params(TRAIN_B, np.random.default_rng(
            counter_seed(41, 0, i)))
        return mixup_cutmix(x, torch.from_numpy(np.asarray(labels)), params,
                            num_classes=400)

    torch.cuda.reset_peak_memory_stats()
    losses, first, wall = _fed_loop(loader, step, AUG_STEPS, mix)

    # the first augmented batch against the same params on the CPU
    packed = _first_packed(make_loader).cpu()
    pipe = loader.pipeline
    want = augment_postproc(
        packed, params=pipe.sample(TRAIN_B, SRC_H, SRC_W, 0, 0),
        src_format=PixelFormat.YUV420, space=pipe.space, rng=pipe.range,
        out_h=OUT, out_w=OUT, output="normalized", spec=spec,
        clip_len=TRAIN_T)
    err = (first["x"].reshape(want.shape).cpu() - want).abs().max().item()
    log(f"(b) first augmented batch on CUDA vs the same params on the CPU "
        f"(normalized): max abs {err:.3g} (tol {AUG_TOL})")
    require(err <= AUG_TOL, "augmented batch CUDA vs CPU")
    image, label = mix(first["x"], first["labels"], 0)
    require(tuple(label.shape) == (TRAIN_B, 400)
            and bool(torch.isfinite(image).all()), "mixup output")
    packed = packed.to(device)
    aug_ms = cuda_ms(lambda: pipe(packed), reps=5)
    aug_host = _host_ms(lambda: pipe(packed))
    busy, top = _device_profile(lambda: pipe(packed))
    log(f"(b) AugmentPipeline on {TRAIN_B} clips x {TRAIN_T} frames "
        f"{SRC_W}x{SRC_H} -> {OUT}x{OUT}: {aug_ms:.3f} ms (CUDA events), "
        f"host {aug_host:.2f} ms (host clock), device busy {busy:.3f} ms "
        f"(torch.profiler); longest kernels (ms): {_top(top)}")
    rec = _train_report("(b) augmented trainer", losses, wall, loader, step,
                        {"image": image, "label": label}, None)
    return dict(rec, augment_ms=aug_ms, max_abs_err=err)


def training_path(device, libav_missing: str, tmpdir: str) -> dict:
    """Phase 10: (a) and (b) over one clip source, then the CUDA-vs-CPU
    train step."""
    make_loader = _train_source(device, libav_missing, tmpdir)
    plain = train_plain(device, make_loader)
    aug = train_augmented(device, make_loader)
    check_train_step(device)
    return {"plain": plain, "augmented": aug}


# ---- phase 11 ------------------------------------------------------------------


#: the device-transcode chain (phase 11a): batches of XC_BATCH seeded
#: 1080p frames, the band H/3…H/2 darkened, then the encoder feed at each
#: target (height, width): 720p, then 1080p with no resize
XC_BATCH, XC_BATCHES = 4, 24
XC_TARGETS = [(720, 1280), (SRC_H, SRC_W)]
#: compat chain (phase 11b) output size
XC_SMALL = 224


def _golden_feed(rgb, oh, ow, space, rng):
    """float64 golden encoder feed of float RGB frames (N, H, W, 3) in
    [0, 1]: the resize matrices per channel, then golden.rgb_to_yuv420's
    matrix, 2×2 chroma mean and rounding."""
    from videoprocessingframework_torch.ops import colorspace as cs
    from videoprocessingframework_torch.ops import golden
    from videoprocessingframework_torch.ops.resize import resize_matrix

    x = rgb.astype(np.float64) * 255.0
    n, h, w, _ = x.shape
    if (h, w) != (oh, ow):
        rm = resize_matrix(h, oh).astype(np.float64)
        cm = resize_matrix(w, ow).astype(np.float64)
        x = np.stack([np.stack([rm @ x[i, :, :, c] @ cm.T for c in range(3)],
                               -1) for i in range(n)])
    m, off = cs.ycbcr_from_rgb_matrix(space, rng)
    ycc = x @ m.T + off
    return (golden._round_u8(ycc[..., 0]),
            golden._round_u8(golden.downsample_chroma_420(ycc[..., 1])),
            golden._round_u8(golden.downsample_chroma_420(ycc[..., 2])))


def _feed_macs(h, w, oh, ow) -> int:
    """Multiply-adds of encode_feed's resize for one channel-frame, the
    order it takes (the cheaper axis first)."""
    if (h, w) == (oh, ow):
        return 0
    return min(oh * h * w + oh * w * ow, h * w * ow + oh * h * ow)


def _check_feed(rgb, space, rng) -> None:
    """encode_feed / encode_feed_gray on CUDA vs the same call on the CPU
    (two frames) and vs the float64 golden (one frame), at every target:
    ≤1 code."""
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
    )
    from videoprocessingframework_torch.ops import colorspace as cs
    from videoprocessingframework_torch.ops import golden
    from videoprocessingframework_torch.ops.fused import (
        encode_feed,
        encode_feed_gray,
    )
    from videoprocessingframework_torch.ops.resize import resize_matrix

    x = rgb[:2]
    host = x.cpu()
    for oh, ow in XC_TARGETS:
        kw = dict(out_h=oh, out_w=ow, space=space, rng=rng)
        got = [p.cpu().numpy() for p in encode_feed(x, **kw)]
        cpu = [p.numpy() for p in encode_feed(host, **kw)]
        gold = _golden_feed(host[:1].numpy(), oh, ow, space, rng)
        e_cpu = max(_maxdiff(g, c) for g, c in zip(got, cpu))
        e_gold = max(_maxdiff(g[:1], w) for g, w in zip(got, gold))
        gkw = dict(out_h=oh, out_w=ow, space=ColorSpace.BT_601,
                   rng=ColorRange.JPEG)
        gy = encode_feed_gray(x, **gkw).cpu().numpy()
        gy_cpu = encode_feed_gray(host, **gkw).numpy()
        m, off = cs.ycbcr_from_rgb_matrix(ColorSpace.BT_601, ColorRange.JPEG)
        f = host[0].numpy().astype(np.float64) * 255.0
        if (oh, ow) != tuple(f.shape[:2]):
            rm = resize_matrix(f.shape[0], oh).astype(np.float64)
            cm = resize_matrix(f.shape[1], ow).astype(np.float64)
            f = np.stack([rm @ f[..., c] @ cm.T for c in range(3)], -1)
        gy_gold = golden._round_u8(f @ m[0] + off[0])
        e_gcpu, e_ggold = _maxdiff(gy, gy_cpu), _maxdiff(gy[0], gy_gold)
        line = (f"encode_feed {SRC_H}x{SRC_W}->{oh}x{ow}: max|cuda-cpu| "
                f"{e_cpu}, max|cuda-golden| {e_gold}; encode_feed_gray: "
                f"max|cuda-cpu| {e_gcpu}, max|cuda-golden| {e_ggold} "
                f"(tol 1 each)")
        log(line)
        require(max(e_cpu, e_gold, e_gcpu, e_ggold) <= 1, line)


def _maxdiff(a, b) -> int:
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def device_transcode(device, rates, libav_missing: str, tmpdir: str) -> dict:
    """Phase 11a: the chain of samples/sample_device_transcode.py on the
    port, at 1080p: HostBatchRing → FusedPipeline(kernel="cuda", rgb_f32,
    1:1) → a darkened band → encode_feed → planes_to_host_packed →
    VideoEncoder → StreamMuxer (where libav builds)."""
    from videoprocessingframework_torch.core.enums import (
        CodecId,
        ColorRange,
        ColorSpace,
        PixelFormat,
    )
    from videoprocessingframework_torch.csrc import launch
    from videoprocessingframework_torch.io import HostBatchRing
    from videoprocessingframework_torch.ops.fused import (
        FusedPipeline,
        encode_feed,
        planes_to_host_packed,
    )

    space, rng = ColorSpace.BT_709, ColorRange.MPEG
    ring = HostBatchRing(SRC_W, SRC_H, XC_BATCH, 0, n_buffers=3, seed=5,
                         device=device)
    pipe = FusedPipeline(PixelFormat.YUV420, space, rng, (SRC_W, SRC_H),
                         output="rgb_f32", device=device, kernel="cuda")
    band = torch.ones(SRC_H, 1, 1, device=device)
    band[SRC_H // 3: SRC_H // 2] = 0.5
    if libav_missing:
        log(f"device transcode: the encoder and muxer stage did not run: "
            f"libav development files are absent ({libav_missing}); the "
            f"chain ends at planes_to_host_packed")
    rec = {"launches": 0}
    for oh, ow in XC_TARGETS:
        enc = mux = None
        if not libav_missing:
            from videoprocessingframework_torch.io import (
                StreamMuxer,
                VideoEncoder,
            )

            enc = VideoEncoder({"codec": "h264", "preset": "P1",
                                "fmt": "YUV420", "s": f"{ow}x{oh}",
                                "bitrate": "8M", "gop": "30"})
            mux = StreamMuxer(f"{tmpdir}/xcode_{oh}p.mp4", CodecId.H264, ow,
                              oh, fps=30)
        first = {}
        frames = packets = 0
        counted = launch.LAUNCHES["fused_resize_csc"]
        ring.rewind(XC_BATCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for rgb in ring.batches(pipe, depth=2):
            rgb = torch.clamp(rgb * band, 0.0, 1.0)
            if not first:
                first["rgb"] = rgb.clone()
            planes = encode_feed(rgb, out_h=oh, out_w=ow, space=space,
                                 rng=rng)
            for frame in planes_to_host_packed(*planes):
                out = enc.encode(frame) if enc is not None else None
                if out is not None:
                    mux.write(*out)
                    packets += 1
                frames += 1
        if enc is not None:
            for out in enc.flush():
                mux.write(*out)
                packets += 1
            mux.close()
        fps = frames / (time.perf_counter() - t0)
        launches = launch.LAUNCHES["fused_resize_csc"] - counted
        rec["launches"] += launches
        require(frames == XC_BATCH * XC_BATCHES, f"{frames} frames")
        require(launches >= XC_BATCHES,
                f"{launches} kernel launches in {XC_BATCHES} batches")
        if enc is not None:
            require(packets == frames, f"{packets} packets, {frames} frames")
        x = first["rgb"]
        require(x.shape == (XC_BATCH, SRC_H, SRC_W, 3)
                and bool(torch.isfinite(x).all()), "the chain's RGB batch")
        if oh == XC_TARGETS[0][0]:
            _check_feed(x, space, rng)
            y, u, v = _seeded_yuv(XC_BATCH, SRC_H, SRC_W, seed=5,
                                  device=device)
            kernel_ms = cuda_ms(lambda: pipe(y, u, v))
            bound, by, nbytes = kernel_bound(XC_BATCH, SRC_H, SRC_W, SRC_H,
                                             SRC_W, 4, *rates)
            log(f"time fused_resize_csc {SRC_H}x{SRC_W}->{SRC_H}x{SRC_W} "
                f"rgb_f32 b{XC_BATCH} (1:1 Lanczos, "
                f"{_plan_line(y, (u, v), SRC_H, SRC_W)}): {kernel_ms:.4f} ms "
                f"per batch, {nbytes / kernel_ms / 1e6:.1f} GB/s, "
                f"{100 * bound / kernel_ms:.1f}% of bound {bound:.4f} ms "
                f"({by})")
            rec.update(kernel_ms=kernel_ms, bound_ms=bound)
        feed_ms = cuda_ms(lambda: encode_feed(x, out_h=oh, out_w=ow,
                                              space=space, rng=rng), reps=10)
        macs = _feed_macs(SRC_H, SRC_W, oh, ow)
        flop = 2.0 * macs * 3 * XC_BATCH
        floor = 1e3 * flop / rates[1]
        log(f"device transcode {SRC_H}x{SRC_W}->{oh}x{ow} b{XC_BATCH}: "
            f"{fps:.1f} frames/s over {frames} frames (host clock, "
            f"ring->kernel->band->encode_feed->host"
            f"{'->encoder->mp4' if enc is not None else ''}), "
            f"{packets} packets; fused_resize_csc launches in this run "
            f"{launches}; encode_feed {feed_ms:.3f} ms per batch (CUDA "
            f"events; " + (
                f"resize {macs / 1e9:.2f} G multiply-adds a channel-frame, "
                f"{flop / 1e9:.1f} GFLOP a batch in float32, no call under "
                f"{floor:.3f} ms at {rates[1] / 1e12:.0f} TFLOP/s)" if macs
                else "no resize: the colour matrix and the 4:2:0 fold)"))
        rec[f"{oh}p"] = dict(fps=fps, feed_ms=feed_ms, floor_ms=floor)
    return rec


def compat_chain(device) -> dict:
    """Phase 11b: the PyNvCodec namespace on the card: PyFrameUploader →
    PySurfaceConverter(NV12 → RGB_PLANAR) → PySurfaceResizer →
    PySurfaceDownloader at 1080p, held to the golden and the plain resize;
    GpuMem() addresses."""
    import videoprocessingframework_torch.compat as nvc
    from videoprocessingframework_torch.core.surface import Surface
    from videoprocessingframework_torch.csrc import launch
    from videoprocessingframework_torch.ops import golden
    from videoprocessingframework_torch.ops.resize import SurfaceResizer

    n = nvc.GetNumGpus()
    require(n == torch.cuda.device_count(), f"GetNumGpus() {n}")
    gpu = 0 if device.type == "cuda" else "cpu"  # "cpu" for a rehearsal
    P = nvc.PixelFormat
    w, h, s = SRC_W, SRC_H, XC_SMALL
    frame = np.random.default_rng(12).integers(0, 256, w * h * 3 // 2,
                                               np.uint8)
    counted = launch.LAUNCHES["csc_rgb_planar"]
    surf = nvc.PyFrameUploader(w, h, P.NV12, gpu).UploadSingleFrame(frame)
    ctx = nvc.ColorspaceConversionContext(nvc.ColorSpace.BT_709,
                                          nvc.ColorRange.MPEG)
    rgb = nvc.PySurfaceConverter(w, h, P.NV12, P.RGB_PLANAR,
                                 gpu).Execute(surf, ctx)
    small = nvc.PySurfaceResizer(s, s, P.RGB_PLANAR, gpu).Execute(rgb)
    out, full = np.ndarray(0, np.uint8), np.ndarray(0, np.uint8)
    require(nvc.PySurfaceDownloader(s, s, P.RGB_PLANAR,
                                    gpu).DownloadSingleSurface(small, out),
            "compat download")
    require(nvc.PySurfaceDownloader(w, h, P.RGB_PLANAR,
                                    gpu).DownloadSingleSurface(rgb, full),
            "compat download at 1080p")
    launches = launch.LAUNCHES["csc_rgb_planar"] - counted
    host = Surface.from_host_frame(frame, P.NV12, w, h)
    gold = np.moveaxis(golden.nv12_to_rgb(*host.planes, nvc.ColorSpace.BT_709,
                                          nvc.ColorRange.MPEG), -1, 0)
    e_gold = _maxdiff(full.reshape(3, h, w), gold)
    plain = SurfaceResizer(s, s, P.RGB_PLANAR).run(rgb.core.to_device("cpu"))
    e_resize = _maxdiff(out.reshape(3 * s, s), plain.planes[0].numpy())
    plane = rgb.PlanePtr(0)
    addr = plane.GpuMem()
    other = nvc.Surface.Make(P.RGB_PLANAR, w, h, gpu)
    rgb.CopyFrom(other)
    same = (addr == rgb.core.planes[0].data_ptr()
            == rgb.PlanePtr(0).GpuMem())
    line = (f"compat chain PyFrameUploader->PySurfaceConverter(NV12->"
            f"RGB_PLANAR)->PySurfaceResizer({s}x{s})->PySurfaceDownloader, "
            f"{w}x{h} BT_709/MPEG: GetNumGpus {n}; max|converter-golden| "
            f"{e_gold} (tol 1); max|resize-plain resize| {e_resize} (tol 1); "
            f"GpuMem {'equals' if same else 'DIFFERS FROM'} data_ptr and "
            f"holds across CopyFrom; csc_rgb_planar launches in this phase "
            f"{launches}")
    log(line)
    require(e_gold <= 1 and e_resize <= 1 and same and launches >= 1, line)
    buf = nvc.PyBufferUploader(1, 4096, gpu).UploadSingleBuffer(
        frame[:4096])
    baddr = buf.GpuMem()
    buf.CopyFrom(nvc.CudaBuffer.Make(1, 4096, gpu))
    require(buf.GpuMem() == baddr and int(buf.to_numpy().max()) == 0,
            "CudaBuffer.CopyFrom in place")
    return {"launches": launches}


def libav_paths(device, libav_missing: str, tmpdir: str) -> dict:
    """Phase 11c: MultiStreamPipeline, Transcoder, PyNvDecoder and
    PyNvEncoder over a make_clip stream, where libav builds; else one line
    each saying why not."""
    what = ("MultiStreamPipeline", "Transcoder", "PyNvDecoder",
            "PyNvEncoder")
    if libav_missing:
        for name in what:
            log(f"{name}: did not run: libav development files are absent "
                f"({libav_missing})")
        return {"launches": 0}
    import videoprocessingframework_torch.compat as nvc
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
        PixelFormat,
    )
    from videoprocessingframework_torch.csrc import launch
    from videoprocessingframework_torch.io import Transcoder
    from videoprocessingframework_torch.io.encoder import make_clip
    from videoprocessingframework_torch.ops.fused import FusedPipeline
    from videoprocessingframework_torch.parallel import MultiStreamPipeline

    gpu = 0 if device.type == "cuda" else "cpu"  # "cpu" for a rehearsal
    w, h, nf = 640, 360, 32
    clip = str(make_clip(f"{tmpdir}/streams.h264", w, h, nf))
    counted = launch.LAUNCHES["fused_resize_csc"]
    pipe = MultiStreamPipeline(
        [clip, clip], batch_size=8, device=device,
        postproc=FusedPipeline(PixelFormat.NV12, ColorSpace.BT_709,
                               ColorRange.MPEG, (OUT, OUT), device=device))
    frames = sum(b.shape[0] for b in pipe.batches())
    launches = launch.LAUNCHES["fused_resize_csc"] - counted
    log(f"MultiStreamPipeline: 2 streams of {nf} {w}x{h} frames, "
        f"{frames} frames at {pipe.stats.fps:.1f} fps, fused_resize_csc "
        f"(NV12) launches {launches}")
    require(frames == 2 * nf, "MultiStreamPipeline frames")
    st = Transcoder(clip, {"preset": "P1"}).run()
    log(f"Transcoder: {st.frames} frames, {st.out_bytes} B, "
        f"{st.fps:.1f} fps")
    require(st.frames == nf, "Transcoder frames")
    dec = nvc.PyNvDecoder(clip, gpu)
    got = 0
    while not dec.DecodeSingleSurface().Empty():
        got += 1
    enc = nvc.PyNvEncoder({"codec": "h264", "preset": "P1",
                           "s": f"{w}x{h}"}, gpu)
    surf = nvc.PyFrameUploader(w, h, nvc.PixelFormat.NV12, gpu)\
        .UploadSingleFrame(np.full(w * h * 3 // 2, 90, np.uint8))
    pkt = np.ndarray(0, np.uint8)
    sent = sum(enc.EncodeSingleSurface(surf, pkt) for _ in range(4))
    while enc.FlushSinglePacket(pkt):
        sent += 1
    log(f"PyNvDecoder: {got} surfaces on {device}; PyNvEncoder: {sent} "
        f"packets from 4 surfaces on {device}")
    require(got == nf and sent == 4, "PyNvDecoder / PyNvEncoder")
    return {"launches": launches}


def transcode_path(device, rates, libav_missing: str, tmpdir: str) -> dict:
    """Phase 11: 11a, 11b and 11c."""
    t0 = time.perf_counter()
    xcode = device_transcode(device, rates, libav_missing, tmpdir)
    comp = compat_chain(device)
    host = libav_paths(device, libav_missing, tmpdir)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return {"transcode": xcode, "compat": comp, "libav": host}


# ---- phase 12 ------------------------------------------------------------------


#: the split MJPEG codec (phase 12): MJ_BATCH seeded, textured 1080p RGB
#: frames encoded at quality MJ_QUALITY (4:2:0), transcoded to MJ_XC at
#: quality MJ_XC_QUALITY; the 4:2:2 and gray cases at MJ_SMALL (batch,
#: height, width) to MJ_SMALL_OUT²; the raw writer's MJ_RAW frames; the
#: chains timed over MJ_REPS passes of the batch
MJ_BATCH, MJ_QUALITY = 32, 90
MJ_XC, MJ_XC_QUALITY = (720, 1280), 75
MJ_SMALL, MJ_SMALL_OUT = (4, 270, 480), 112
MJ_RAW, MJ_REPS = 8, 3


def _textured_rgb(b, h, w, seed, device) -> torch.Tensor:
    """``b`` seeded RGB frames (b, h, w, 3) u8 on ``device``: a gradient,
    a coarse block pattern a channel and fine noise, so they compress like
    pictures and still differ after a resize to 224²."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    coarse = torch.randint(0, 96, (b, 27, 48, 3), generator=g,
                           dtype=torch.uint8).to(device)
    noise = torch.randint(0, 32, (b, h, w, 3), generator=g,
                          dtype=torch.uint8).to(device)
    rows = (torch.arange(h, device=device) * 27) // h
    cols = (torch.arange(w, device=device) * 48) // w
    grad = ((torch.arange(h, device=device)[:, None] * 64) // h
            + (torch.arange(w, device=device)[None, :] * 64) // w)
    return noise + coarse[:, rows][:, :, cols] + \
        grad[None, :, :, None].to(torch.uint8)


def _diff(a, b) -> tuple:
    """(max |a-b|, the share of entries that differ) of integer arrays."""
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    return int(d.max()), np.count_nonzero(d) / d.size


def _diffs(got, want) -> tuple:
    """The largest max and share of :func:`_diff` over pairs of arrays."""
    ds = [_diff(g, w) for g, w in zip(got, want)]
    return max(d[0] for d in ds), max(d[1] for d in ds)


def _host(ts) -> list:
    return [t.cpu().numpy() for t in ts]


def _psnr(a, b) -> float:
    err = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(10 * np.log10(255.0 ** 2 / max((err ** 2).mean(), 1e-12)))


def _threaded(fn, items, workers) -> list:
    """``fn(state, item)`` over ``items`` on ``workers`` threads, in order;
    ``state`` is a dict of the calling thread's own (its coder)."""
    from videoprocessingframework_torch.io.jpeg import _bounded_ordered_map

    local = threading.local()

    def one(item):
        if not hasattr(local, "state"):
            local.state = {}
        return fn(local.state, item)

    return list(_bounded_ordered_map(one, items, workers))


def _entropy_timings(jpegs, frames, quant_tables, workers) -> dict:
    """Host entropy decode and encode of the batch, ms a frame, at one
    worker and at ``workers`` threads (the native calls drop the GIL)."""
    from videoprocessingframework_torch.io.jpeg import (
        JpegCoefDecoder,
        JpegCoefEncoder,
    )

    def dec(state, data):
        return state.setdefault("c", JpegCoefDecoder()).decode(data)

    def enc(state, f):
        return state.setdefault("c", JpegCoefEncoder(
            SRC_W, SRC_H, quant_tables=quant_tables)).encode(*f)

    rec = {}
    for name, fn, items in (("decode", dec, jpegs), ("encode", enc, frames)):
        for w in sorted({1, workers}):
            _threaded(fn, items[:w], w)  # warm-up: each thread's scratch
            t0 = time.perf_counter()
            out = _threaded(fn, items, w)
            rec[f"{name}_{w}"] = 1e3 * (time.perf_counter() - t0) / len(out)
    return rec


def _idct_bound(coeffs, planes, mem_rate, flop_rate) -> tuple:
    """(bound ms, bound_by) of the dequant + IDCT + assembly of a batch:
    the int16 coefficients read once, the u8 planes written once, and
    2·64·64 float32 operations a block."""
    blocks = sum(c.shape[0] * c.shape[1] for c in coeffs)
    nbytes = 2 * 64 * blocks + sum(p.numel() for p in planes)
    t_bytes, t_ops = nbytes / mem_rate, 2.0 * 64 * 64 * blocks / flop_rate
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations"), nbytes


def _small_route(device, sampling, seed) -> None:
    """A small 4:2:2 or gray stream: device encode → host encode → host
    decode → JpegDevicePipeline(rgb_u8) on the card vs the CPU; the band
    kernel must not launch (FusedPipeline's gate takes 4:2:0 only)."""
    from videoprocessingframework_torch.csrc import launch
    from videoprocessingframework_torch.io.jpeg import (
        JpegCoefDecoder,
        JpegCoefEncoder,
    )
    from videoprocessingframework_torch.ops.jpeg import (
        JpegDeviceEncoder,
        JpegDevicePipeline,
    )

    b, h, w = MJ_SMALL
    rgb = _textured_rgb(b, h, w, seed, device)
    y = rgb[..., 0].contiguous()
    planes = (y,) if sampling == "gray" else (
        y, rgb[:, :, 0::2, 1].contiguous(), rgb[:, :, 1::2, 2].contiguous())
    enc = JpegDeviceEncoder(h, w, quality=MJ_QUALITY, subsampled=sampling,
                            device=device)
    coder = JpegCoefEncoder(w, h, subsampled=sampling,
                            quant_tables=enc.quant_tables)
    dec = JpegCoefDecoder()
    coeffs = dec.decode_batch(coder.encode_batch(*enc.encode_planes(*planes)))
    kw = dict(out_size=(MJ_SMALL_OUT, MJ_SMALL_OUT), output="rgb_u8")
    before = launch.LAUNCHES["fused_resize_csc"]
    got = JpegDevicePipeline(dec.info, device=device, **kw)(*coeffs)
    launched = launch.LAUNCHES["fused_resize_csc"] - before
    cpu = JpegDevicePipeline(dec.info, device="cpu", **kw)(*coeffs)
    e, share = _diff(got.cpu().numpy(), cpu.numpy())
    line = (f"mjpeg {sampling} {h}x{w}->{MJ_SMALL_OUT}² b{b}: route torch "
            f"(decode_postproc: FusedPipeline's CUDA gate takes 4:2:0), "
            f"band kernel launches {launched}; rgb_u8 CUDA vs CPU max "
            f"{e} code ({100 * share:.4f}% differ; tol 1)")
    log(line)
    require(got.shape == (b, MJ_SMALL_OUT, MJ_SMALL_OUT, 3) and e <= 1
            and launched == 0, line)


def _split_jpegs(data: bytes) -> list:
    """Raw MJPEG → its images, split at SOI … EOI (entropy-coded data
    stuffs every 0xFF, so 0xFFD9 marks an image's end only)."""
    out, start = [], 0
    while start < len(data):
        require(data[start:start + 2] == b"\xff\xd8", "raw MJPEG: SOI")
        end = data.index(b"\xff\xd9", start) + 2
        out.append(data[start:end])
        start = end
    return out


def _mjpeg_libav_paths(device, libav_missing, tmpdir, rgb) -> int:
    """MjpegReader, MjpegTranscoder and MjpegClipLoader over an AVI from
    MjpegWriter, where libav builds (else one line each); returns the
    band kernel's launches."""
    what = ("MjpegReader", "MjpegTranscoder", "MjpegClipLoader")
    if libav_missing:
        for name in what:
            log(f"{name}: did not run: libav development files are absent "
                f"({libav_missing}); it demuxes through FFmpegDemuxer")
        return 0
    from videoprocessingframework_torch.csrc import launch
    from videoprocessingframework_torch.data import MjpegClipLoader
    from videoprocessingframework_torch.io import (
        MjpegReader,
        MjpegTranscoder,
        MjpegWriter,
    )

    n = rgb.shape[0]
    path = f"{tmpdir}/clip.avi"
    with MjpegWriter(path, SRC_W, SRC_H, quality=MJ_QUALITY,
                     container="avi", device=device) as wr:
        wr.write_rgb(rgb)
    before = launch.LAUNCHES["fused_resize_csc"]
    rd = MjpegReader(path, out_size=(OUT, OUT), output="normalized",
                     batch=4, device=device)
    frames = sum(b.shape[0] for b in rd.batches())
    st = MjpegTranscoder(path, quality=MJ_XC_QUALITY, out_size=MJ_XC,
                         batch=4, device=device).run()
    ld = MjpegClipLoader(path, clip_len=2, batch_size=2, out_size=(OUT, OUT),
                         device=device)
    clips = sum(b.shape[0] for b in ld.epoch(0))
    launches = launch.LAUNCHES["fused_resize_csc"] - before
    log(f"MjpegReader: {frames} frames; MjpegTranscoder: {st.frames} frames, "
        f"{st.out_bytes} B, {st.fps:.1f} fps; MjpegClipLoader: {clips} clips;"
        f" fused_resize_csc launches {launches}")
    require(frames == n and st.frames == n and clips == n // 2
            and launches >= 1, "MJPEG libav paths")
    return launches


def mjpeg_path(device, rates, libav_missing: str, tmpdir: str) -> dict:
    """Phase 12: the split MJPEG codec at 1080p, batch 32 (see the module
    docstring)."""
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
        PixelFormat,
    )
    from videoprocessingframework_torch.csrc import launch
    from videoprocessingframework_torch.io.jpeg import (
        JpegCoefDecoder,
        JpegCoefEncoder,
        MjpegWriter,
    )
    from videoprocessingframework_torch.ops import fused_cuda as fc
    from videoprocessingframework_torch.ops.fused import (
        FusedPipeline,
        encode_feed,
    )
    from videoprocessingframework_torch.ops.jpeg import (
        JpegDeviceEncoder,
        JpegDevicePipeline,
        JpegDeviceTranscoder,
        golden_decode,
        golden_encode,
    )
    from videoprocessingframework_torch.ops.normalize import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from videoprocessingframework_torch.ops.resize import resize_matrix

    t_start = time.perf_counter()
    b, h, w = MJ_BATCH, SRC_H, SRC_W
    space, rng = ColorSpace.BT_601, ColorRange.JPEG
    rgb = _textured_rgb(b, h, w, 12, device)
    counted = launch.LAUNCHES["fused_resize_csc"]

    # (a) device encode, then host encode
    enc = JpegDeviceEncoder(h, w, quality=MJ_QUALITY, subsampled="420",
                            device=device)
    qts = (enc.quant_tables[0], enc.quant_tables[1], enc.quant_tables[1])
    coeffs = enc.encode_rgb(rgb)
    require(tuple(c.shape[0] for c in coeffs) == (b,) * 3
            and all(c.dtype == torch.int16 for c in coeffs), "encode_rgb")
    planes2 = encode_feed(rgb[:2], out_h=h, out_w=w, space=space, rng=rng)
    host2 = _host(planes2)
    c2 = _host(enc.encode_planes(*planes2))
    cpu_enc = JpegDeviceEncoder(h, w, quality=MJ_QUALITY, subsampled="420",
                                device="cpu")
    e_cpu, s_cpu = _diffs(c2, _host(cpu_enc.encode_planes(*host2)))
    e_gold, s_gold = _diffs(c2, golden_encode(host2, qts, enc.geometry))
    e_feed, _ = _diffs(host2, _host(encode_feed(
        rgb[:2].cpu(), out_h=h, out_w=w, space=space, rng=rng)))
    coder = JpegCoefEncoder(w, h, quant_tables=enc.quant_tables)
    coeffs_host = _host(coeffs)
    jpegs = coder.encode_batch(*coeffs_host)
    sizes = [len(j) for j in jpegs]
    line = (f"mjpeg (a) JpegDeviceEncoder {h}x{w} q{MJ_QUALITY} 4:2:0 b{b}: "
            f"coefficients CUDA vs CPU on the same planes max {e_cpu} "
            f"({100 * s_cpu:.4f}% differ), vs golden_encode max {e_gold} "
            f"({100 * s_gold:.4f}% differ) (tol 1 each); encode_feed CUDA vs "
            f"CPU max {e_feed} code (tol 1); JpegCoefEncoder: {len(jpegs)} "
            f"JPEGs of {min(sizes)}-{max(sizes)} B (mean "
            f"{sum(sizes) / len(sizes):.0f} B)")
    log(line)
    require(max(e_cpu, e_gold, e_feed) <= 1 and len(jpegs) == b, line)

    # (b) host decode, then device decode
    dec = JpegCoefDecoder()
    back = dec.decode_batch(jpegs)
    same = all(np.array_equal(x, y) for x, y in zip(back, coeffs_host))
    log(f"mjpeg (b) JpegCoefDecoder.decode_batch: coefficients "
        f"{'equal' if same else 'DIFFER FROM'} (a)'s (entropy round trip)")
    require(same, "entropy round trip")
    info = dec.info
    planes_pipe = JpegDevicePipeline(info, output="planes", device=device)
    planes = planes_pipe(*back)
    got2 = _host(p[:2] for p in planes)
    gold = golden_decode([c[:2] for c in back], qts, planes_pipe.geometry)
    cpu = _host(JpegDevicePipeline(info, output="planes", device="cpu")(
        *(c[:2] for c in back)))
    e_pg, s_pg = _diffs(got2, gold)
    e_pc, s_pc = _diffs(got2, cpu)
    line = (f"mjpeg (b) JpegDevicePipeline planes {h}x{w} b{b}: vs "
            f"golden_decode max {e_pg} code ({100 * s_pg:.4f}% differ), vs "
            f"CPU max {e_pc} ({100 * s_pc:.4f}% differ) (tol 1 each)")
    log(line)
    require(planes[0].shape == (b, h, w) and planes[1].shape ==
            (b, h // 2, w // 2) and max(e_pg, e_pc) <= 1, line)
    fused = {}
    for out in ("normalized", "rgb_u8"):
        pipe = JpegDevicePipeline(info, out_size=(OUT, OUT), output=out,
                                  device=device)
        before = launch.LAUNCHES["fused_resize_csc"]
        got = pipe(*back)
        launched = launch.LAUNCHES["fused_resize_csc"] - before
        plain = FusedPipeline(PixelFormat.YUV420, space, rng, (OUT, OUT),
                              output=out, kernel="torch", compute="highest",
                              device=device)(*planes)
        err = (got.float() - plain.float()).abs().max().item()
        line = (f"mjpeg (b) JpegDevicePipeline {out} {h}x{w}->{OUT}² b{b}: "
                f"route band kernel, launches {launched}; vs "
                f"FusedPipeline(kernel='torch') on the same planes max "
                f"{err:.3g} (tol {TOL[out]})")
        log(line)
        require(got.shape == (b, OUT, OUT, 3) and launched == 1
                and err <= TOL[out], line)
        fused[out] = pipe
    for sampling, seed in (("422", 13), ("gray", 14)):
        _small_route(device, sampling, seed)

    # (c) transcode to 720p, re-encode, decode back
    oh, ow = MJ_XC
    xc = JpegDeviceTranscoder(info, quality=MJ_XC_QUALITY, out_size=MJ_XC,
                              device=device)
    xout = xc(*back)
    x2 = _host(c[:2] for c in xout)
    xcpu = JpegDeviceTranscoder(info, quality=MJ_XC_QUALITY, out_size=MJ_XC,
                                device="cpu")(*(c[:2] for c in back))
    e_xc, s_xc = _diffs(x2, _host(xcpu))
    xjpegs = JpegCoefEncoder(ow, oh, quant_tables=xc.quant_tables)\
        .encode_batch(*xout)
    xdec = JpegCoefDecoder()
    xback = xdec.decode_batch(xjpegs)
    y720 = JpegDevicePipeline(xdec.info, output="planes", device=device)(
        *(c[:2] for c in xback))[0].cpu().numpy()
    rm, cm = resize_matrix(h, oh).astype(np.float64), \
        resize_matrix(w, ow).astype(np.float64)
    src = np.clip(np.rint(rm @ got2[0].astype(np.float64) @ cm.T), 0, 255)
    psnr = min(_psnr(y720[i], src[i]) for i in range(2))
    line = (f"mjpeg (c) JpegDeviceTranscoder {h}x{w}->{oh}x{ow} "
            f"q{MJ_QUALITY}->q{MJ_XC_QUALITY} b{b}: CUDA vs CPU coefficients "
            f"max {e_xc} ({100 * s_xc:.4f}% differ; tol 1); re-encoded "
            f"{sum(len(j) for j in xjpegs) // len(xjpegs)} B a frame, decoded "
            f"back: luma PSNR vs the source resized {psnr:.2f} dB (bar 30)")
    log(line)
    require(xout[0].shape[0] == b and e_xc <= 1 and psnr > 30.0, line)

    # (d) raw writer; the libav-only paths
    raw = f"{tmpdir}/raw.mjpeg"
    with MjpegWriter(raw, w, h, quality=MJ_QUALITY, device=device) as wr:
        wr.write_rgb(rgb[:MJ_RAW])
    with open(raw, "rb") as f:
        images = _split_jpegs(f.read())
    rdec = JpegCoefDecoder()
    rframes = [rdec.decode(j) for j in images]
    line = (f"mjpeg (d) MjpegWriter(container=None): {len(images)} JPEGs in "
            f"{raw.rsplit('/', 1)[-1]}, each decodes at "
            f"{rdec.info.width}x{rdec.info.height}")
    log(line)
    require(len(rframes) == MJ_RAW and (rdec.info.width, rdec.info.height)
            == (w, h), line)
    libav_launches = _mjpeg_libav_paths(device, libav_missing, tmpdir,
                                        rgb[:MJ_RAW])

    # the chains, host clock: bytes → host decode (default workers) →
    # device → normalized 224²; RGB on the card → coefficients → bytes
    workers = min(8, os.cpu_count() or 1)
    pipe = fused["normalized"]

    def dec_one(state, data):
        return state.setdefault("c", JpegCoefDecoder()).decode(data)

    def enc_one(state, i):
        return state.setdefault("c", JpegCoefEncoder(
            w, h, quant_tables=enc.quant_tables)).encode(
                *(c[i] for c in host_c))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MJ_REPS):
        frames = _threaded(dec_one, jpegs, workers)
        out = pipe(*(np.stack([f[c] for f in frames]) for c in range(3)))
        torch.cuda.synchronize()
    dec_fps = MJ_REPS * b / (time.perf_counter() - t0)
    launches = launch.LAUNCHES["fused_resize_csc"] - counted
    require(bool(torch.isfinite(out).all()), "chain output")
    t0 = time.perf_counter()
    for _ in range(MJ_REPS):
        host_c = _host(enc.encode_rgb(rgb))
        encoded = _threaded(enc_one, range(b), workers)
    enc_fps = MJ_REPS * b / (time.perf_counter() - t0)
    require(encoded == jpegs, "encode chain bytes")
    log(f"mjpeg chains (host clock, {MJ_REPS} passes of {b}, {workers} "
        f"workers): JPEG bytes->host decode->device->normalized {OUT}² "
        f"{dec_fps:.1f} frames/s; RGB on the card->coefficients->JPEG bytes "
        f"{enc_fps:.1f} frames/s; fused_resize_csc launches in phase 12 "
        f"{launches + libav_launches}")
    require(launches >= 2 + MJ_REPS, f"{launches} kernel launches")

    # timings
    ent = _entropy_timings(jpegs, [tuple(c[i] for c in coeffs_host)
                                   for i in range(b)], enc.quant_tables,
                           workers)
    log(f"mjpeg host entropy ms a frame ({h}x{w} q{MJ_QUALITY}): decode "
        f"{ent['decode_1']:.3f} at 1 worker, {ent[f'decode_{workers}']:.3f} "
        f"at {workers}; encode {ent['encode_1']:.3f} at 1, "
        f"{ent[f'encode_{workers}']:.3f} at {workers}")
    dev_c = coeffs
    idct_ms = cuda_ms(lambda: planes_pipe.planes(*dev_c))
    bound, by, nbytes = _idct_bound(dev_c, planes, *rates)
    gflop = 2 * 64 * 64 * sum(c.shape[0] * c.shape[1] for c in dev_c) / 1e9
    kern_ms = cuda_ms(lambda: fc.fused_yuv420_resize_rgb(
        *planes, out_h=OUT, out_w=OUT, space=space, rng=rng,
        output="normalized", mean=IMAGENET_MEAN, std=IMAGENET_STD))
    kbound, kby, _ = kernel_bound(b, h, w, OUT, OUT, 4, *rates)
    fdct_ms = cuda_ms(lambda: enc.encode_planes(*planes))
    log(f"time mjpeg dequant+IDCT+assembly {h}x{w} b{b} (3 torch.matmul in "
        f"float32, TF32 off): {idct_ms:.4f} ms per batch, "
        f"{100 * bound / idct_ms:.1f}% of bound {bound:.4f} ms ({by}; "
        f"{nbytes / 1e6:.1f} MB, {gflop:.1f} GFLOP); "
        f"level shift+fDCT+quant of the same planes {fdct_ms:.4f} ms; "
        f"fused_resize_csc on these planes (normalized {OUT}²) "
        f"{kern_ms:.4f} ms, {100 * kbound / kern_ms:.1f}% of bound "
        f"{kbound:.4f} ms ({kby})")
    secs = time.perf_counter() - t_start
    log(f"phase 12: {secs:.1f} s")
    return {"launches": launches + libav_launches, "idct_ms": idct_ms,
            "idct_bound_ms": bound, "kernel_ms": kern_ms,
            "decode_fps": dec_fps, "encode_fps": enc_fps, **ent}


# ---- phase 13 ------------------------------------------------------------------


#: phase 13: batches of the sharded pipeline's and the assembler's runs
SHARD_BATCHES = 48
#: init and collective timeout of every world (s): a collective that
#: hangs fails by it
DIST_TIMEOUT_S = 60
#: the two-rank world on the one card (13e): join timeout (s)
TWO_RANK_TIMEOUT_S = 240
#: a gloo error that says it does not take CUDA tensors for a collective
GLOO_REFUSAL = re.compile(r"gloo|not supported|unsupported|only.*cpu",
                          re.IGNORECASE)


def _start_world(backend: str, store_path: str, rank: int, world: int):
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))


def _sharded_pipe(device, mesh, what, n_batches, run_one):
    """``run_one(planes) -> local output`` over ``n_batches`` seeded 1080p
    batches of BATCH from HostBatchRing; returns (launches, host ms a
    batch, first planes, first output)."""
    from videoprocessingframework_torch.csrc import launch
    from videoprocessingframework_torch.io import HostBatchRing

    ring = HostBatchRing(SRC_W, SRC_H, BATCH, 3, n_buffers=3, seed=1,
                         device=device)
    for planes in iter(ring.acquire_planes, None):  # warm-up
        run_one(planes)
        ring.release()
    ring.rewind(n_batches)
    first = {}
    counted = launch.LAUNCHES["fused_resize_csc"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for planes in iter(ring.acquire_planes, None):
        out = run_one(planes)
        # the upload copied the slot into pinned staging before returning
        ring.release()
        if not first:
            first.update(planes=planes, out=out)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n_batches
    launches = launch.LAUNCHES["fused_resize_csc"] - counted
    log(f"{what}: {n_batches} batches of {BATCH} {SRC_W}x{SRC_H} -> "
        f"{OUT}x{OUT} normalized, {ms:.2f} ms a batch (host clock, upload "
        f"included); fused_resize_csc launches in this run: {launches}")
    require(launches >= n_batches, f"{what}: {launches} kernel launches "
            f"for {n_batches} batches")
    return launches, ms, first["planes"], first["out"]


def sharded_pipelines(device, mesh, kernel_ms) -> dict:
    """13 (a) ShardedVideoPipeline and (b) GlobalBatchAssembler over
    HostBatchRing, through FusedPipeline(kernel="cuda") on the mesh."""
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
        PixelFormat,
    )
    from videoprocessingframework_torch.ops.fused import FusedPipeline
    from videoprocessingframework_torch.parallel.multidevice import (
        ShardedVideoPipeline,
        sharded_batch_matches_single_device,
    )
    from videoprocessingframework_torch.parallel.multihost import (
        GlobalBatchAssembler,
    )

    post = FusedPipeline(PixelFormat.YUV420, ColorSpace.BT_709,
                         ColorRange.MPEG, (OUT, OUT), method="lanczos",
                         output="normalized", kernel="cuda")
    sharded = ShardedVideoPipeline(post, mesh=mesh)

    def single(planes):
        return post(*[torch.from_numpy(p).to(device) for p in planes])

    launches_a, ms_a, planes, out = _sharded_pipe(
        device, mesh, "(13a) ShardedVideoPipeline", SHARD_BATCHES,
        lambda p: sharded(p).to_local())
    same = torch.equal(out, single(planes))
    matches = sharded_batch_matches_single_device(post, planes, mesh)
    call_ms = cuda_ms(lambda: sharded(planes), reps=10)
    log(f"(13a) local shard vs the single-device FusedPipeline on the same "
        f"planes: bit-equal {same}; sharded_batch_matches_single_device "
        f"{matches}; {call_ms:.3f} ms a call (CUDA events: the upload's wait "
        f"and the kernel), the kernel alone {kernel_ms:.4f} ms (phase 4)")
    require(same and matches, "sharded pipeline vs single device")

    asm = GlobalBatchAssembler(mesh)

    def assembled(planes):
        g = asm.global_batch(planes)
        return post(*[p.to_local() for p in g])

    launches_b, ms_b, planes, out = _sharded_pipe(
        device, mesh, "(13b) GlobalBatchAssembler -> FusedPipeline",
        SHARD_BATCHES, assembled)
    same = torch.equal(out, single(planes))
    log(f"(13b) local shard vs the single-device FusedPipeline: bit-equal "
        f"{same}")
    require(same, "assembled batch vs single device")
    return {"launches": launches_a + launches_b, "ms_a": ms_a, "ms_b": ms_b,
            "call_ms": call_ms}


def _host_profile(fn, reps=2):
    """(host ms per call, the ten ops of the longest self host time as
    (name, calls per call, ms per call)) over ``reps`` calls, from a
    torch.profiler trace of the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = 1e3 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
    rows = [(e.key, e.count // reps, e.self_cpu_time_total / 1e3 / reps)
            for e in prof.key_averages()]
    rows.sort(key=lambda r: -r[2])
    return ms, rows[:10]


def _mesh_step_vs_single(device, mesh, n_images, label):
    """One float32 step (TF32 off) of resnet18_like at 64² on ``mesh``
    against the single-device step on the whole batch, from the same
    weights: (loss relative, parameters relative) after printing them."""
    from videoprocessingframework_torch.models import resnet18_like
    from videoprocessingframework_torch.parallel.train import (
        full_state_dict,
        make_train_step,
    )

    torch.manual_seed(13)
    single = resnet18_like(8, torch.float32).to(device)
    meshed = resnet18_like(8, torch.float32).to(device)
    meshed.load_state_dict(single.state_dict())
    g = torch.Generator().manual_seed(14)
    x = torch.randn((n_images, 64, 64, 3), generator=g).to(device)
    labels = torch.arange(n_images).remainder(8).to(device)

    def sgd(m):
        return torch.optim.SGD(m.parameters(), lr=0.01, momentum=0.9)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = make_train_step(meshed, sgd(meshed), mesh)(
            {"image": x, "label": labels})
        want = make_train_step(single, sgd(single))(
            {"image": x, "label": labels})
        sd = full_state_dict(meshed)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    loss_rel = _rel(got["loss"], want["loss"])
    params_rel = max(_rel(sd[k], v) for k, v in single.state_dict().items()
                     if v.is_floating_point())
    line = (f"{label}: one float32 step (TF32 off) of resnet18_like 64x64 "
            f"batch {n_images}, mesh {tuple(mesh.shape)} vs the single-device "
            f"step on the whole batch: loss {got['loss'].item():.6f} vs "
            f"{want['loss'].item():.6f}, relative {loss_rel:.3g} (tol "
            f"{STEP_LOSS_TOL}); parameters and running statistics, largest "
            f"relative difference {params_rel:.3g} (tol {STEP_PARAM_TOL})")
    log(line)
    require(loss_rel <= STEP_LOSS_TOL and params_rel <= STEP_PARAM_TOL, line)
    return loss_rel, params_rel


def sharded_trainer(device, mesh, make_loader, plain) -> dict:
    """13 (c): phase 10 (a)'s trainer as the dp × tp step on the mesh, fed
    by the loader with sharding=; then the float32 step check."""
    from videoprocessingframework_torch.csrc import launch
    from videoprocessingframework_torch.models import video_resnet50
    from videoprocessingframework_torch.parallel import make_train_step
    from videoprocessingframework_torch.parallel.mesh import batch_sharding

    loader = make_loader(kernel="cuda", sharding=batch_sharding(mesh))
    torch.manual_seed(10)
    model = video_resnet50(400, "attention", dtype=torch.bfloat16,
                           frames=TRAIN_T).to(device,
                                              memory_format=torch.channels_last)
    step = make_train_step(model, torch.optim.SGD(
        model.parameters(), lr=0.01, momentum=0.9), mesh)
    torch.cuda.reset_peak_memory_stats()
    counted = launch.LAUNCHES["fused_resize_csc"]
    losses, first, wall = _fed_loop(loader, step, PLAIN_STEPS,
                                    lambda x, labels, i: (x, labels))
    launches = launch.LAUNCHES["fused_resize_csc"] - counted
    log(f"(13c) sharded loader -> fused_resize_csc -> video-ResNet-50 dp x tp "
        f"step on mesh {tuple(mesh.shape)}: fused_resize_csc launches in "
        f"this run: {launches}")
    require(launches >= PLAIN_STEPS,
            f"{launches} kernel launches for {PLAIN_STEPS} steps")
    batch = {"image": first["x"], "label": first["labels"]}
    rec = _train_report("(13c) dp x tp trainer", losses, wall, loader, step,
                        batch, plain["kernel_ms"])
    log(f"(13c) beside phase 10 (a), same run: step {rec['step_ms']:.2f} vs "
        f"{plain['step_ms']:.2f} ms (CUDA events), host enqueue "
        f"{rec['enqueue_ms']:.2f} vs {plain['enqueue_ms']:.2f} ms, device busy "
        f"{rec['busy_ms']:.2f} vs {plain['busy_ms']:.2f} ms, peak memory "
        f"{rec['peak_gib']:.2f} vs {plain['peak_gib']:.2f} GiB")
    host_ms, rows = _host_profile(lambda: step(batch))
    log(f"(13c) host time of a step under torch.profiler {host_ms:.2f} ms; "
        f"ops of the longest self host time (calls, ms a step): "
        + "; ".join(f"{k[:48]} {n} {t:.2f}" for k, n, t in rows))
    del model, step, loader, first, batch
    torch.cuda.empty_cache()
    loss_rel, params_rel = _mesh_step_vs_single(device, mesh, 8, "(13c)")
    return dict(rec, launches=launches, loss_rel=loss_rel,
                params_rel=params_rel)


def multi_device_paths(device, mesh, libav_missing, tmpdir) -> int:
    """13 (d): MultiDeviceStreamPipeline over [device] and
    MultiHostVideoPipeline over a make_clip stream, where libav builds;
    else one line each. Returns the kernel's launches."""
    if libav_missing:
        for name in ("MultiDeviceStreamPipeline", "MultiHostVideoPipeline"):
            log(f"(13d) {name}: did not run: libav development files are "
                f"absent ({libav_missing})")
        return 0
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
        PixelFormat,
    )
    from videoprocessingframework_torch.csrc import launch
    from videoprocessingframework_torch.io.encoder import make_clip
    from videoprocessingframework_torch.ops.fused import FusedPipeline
    from videoprocessingframework_torch.parallel import (
        MultiDeviceStreamPipeline,
        MultiHostVideoPipeline,
    )

    frames = BATCH * 4
    clip = str(make_clip(f"{tmpdir}/multi_1080p.h264", SRC_W, SRC_H, frames))
    post = FusedPipeline(PixelFormat.YUV420, ColorSpace.BT_709,
                         ColorRange.MPEG, (OUT, OUT), output="normalized",
                         kernel="cuda")
    total = 0
    for name, make in (
            ("MultiDeviceStreamPipeline", lambda: MultiDeviceStreamPipeline(
                [clip], post, batch_size=BATCH, devices=[device])),
            ("MultiHostVideoPipeline", lambda: MultiHostVideoPipeline(
                [clip], post, mesh=mesh, batch_size_per_host=BATCH))):
        counted = launch.LAUNCHES["fused_resize_csc"]
        pipe = make()
        t0 = time.perf_counter()
        n = sum(o.shape[0] for o in pipe.batches())
        torch.cuda.synchronize()
        fps = n / (time.perf_counter() - t0)
        pipe.close()
        launches = launch.LAUNCHES["fused_resize_csc"] - counted
        total += launches
        log(f"(13d) {name}: {n} of {frames} decoded frames, {fps:.1f} "
            f"frames/s (host clock); fused_resize_csc launches: {launches}")
        require(n == frames and launches >= frames // BATCH, name)
    return total


def _two_rank_worker(rank: int, tmpdir: str, device_name: str) -> None:
    """One rank of 13 (e): gloo world of 2 on the one card, mesh (2, 1)."""
    import torch.distributed as dist

    from videoprocessingframework_torch.parallel.mesh import make_mesh

    device = torch.device(device_name)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        _start_world("gloo", f"{tmpdir}/store2", rank, 2)
        mesh = make_mesh(2, ("data", "model"), shape=(2, 1),
                         device_type=device.type)
        out["loss_rel"], out["params_rel"] = _mesh_step_vs_single(
            device, mesh, 8, f"(13e) rank {rank}")
    except RuntimeError as e:
        out["error"] = f"{type(e).__name__}: {e}".splitlines()[0][:400]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        with open(f"{tmpdir}/two_rank{rank}.json", "w") as f:
            json.dump(out, f)


def two_ranks_one_card(device, tmpdir) -> dict:
    """13 (e): two processes on the one card (NCCL refuses two ranks on
    one device, gloo's all-reduce takes CUDA tensors): the dp step of
    resnet18_like against the single-device step. A gloo refusal of a
    CUDA collective the step needs is printed, and (e) is left out."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_two_rank_worker,
                         args=(r, tmpdir, str(device))) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TWO_RANK_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    require(not alive, f"(13e) two-rank world still running after "
            f"{TWO_RANK_TIMEOUT_S} s")
    res = []
    for r in range(2):
        with open(f"{tmpdir}/two_rank{r}.json") as f:
            res.append(json.load(f))
    errors = [x["error"] for x in res if "error" in x]
    if errors:
        log(f"(13e) left out: gloo refused a CUDA collective the step needs: "
            f"{errors[0]}")
        require(all(GLOO_REFUSAL.search(e) for e in errors),
                f"(13e) failed: {errors}")
        return {"error": errors[0]}
    require(all(p.exitcode == 0 for p in procs), "(13e) rank exit codes")
    log(f"(13e) two ranks on one card (gloo, mesh (2, 1)): both ranks within "
        f"the bars of the single-device step")
    return res[0]


def parallel_path(device, libav_missing: str, tmpdir: str, kernel_ms: float,
                  plain: dict) -> dict:
    """Phase 13: a world of one (NCCL on the card), mesh (1, 1): (a)-(d) on
    it, then (e) two gloo ranks on the one card."""
    import torch.distributed as dist

    from videoprocessingframework_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    backend = "nccl" if device.type == "cuda" else "gloo"
    _start_world(backend, f"{tmpdir}/store", 0, 1)
    try:
        mesh = make_mesh(axes=("data", "model"), shape=(1, 1),
                         device_type=device.type)
        log(f"phase 13: world of {dist.get_world_size()} ({dist.get_backend()}"
            f"), mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on {device}")
        pipes = sharded_pipelines(device, mesh, kernel_ms)
        make_loader = _train_source(device, libav_missing, tmpdir)
        train = sharded_trainer(device, mesh, make_loader, plain)
        multi = multi_device_paths(device, mesh, libav_missing, tmpdir)
    finally:
        dist.destroy_process_group()
    two = two_ranks_one_card(device, tmpdir)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    return {"launches": pipes["launches"] + train["launches"] + multi,
            "pipes": pipes, "train": train, "two_ranks": two}


# ---- phase 14 ------------------------------------------------------------------


#: sample_resnet at full width: batches of BATCH seeded 1080p NV12 frames
SAMPLE_BATCHES = 8
#: sample_resnet on CUDA vs CPU, one batch in float32 (TF32 off): logits as
#: max |diff| / max |logit| (the kernel's normalized output is within 1e-4
#: of the plain version's, phase 3)
SAMPLE_LOGIT_TOL = 1e-3
#: sample_aot_compile: the reloaded program's confidences vs eager
AOT_CONF_TOL = 1e-3
#: the samples' main() on tests/assets/test.mp4 where libav builds: each
#: sample with the arguments of its test in tests/test_torch_samples_*.py
SAMPLE_MAINS = [
    ("sample_decode", ["{mp4}", "{tmp}/o.nv12"]),
    ("sample_decode", ["{mp4}", "{tmp}/o.nv12", "--mode", "standalone"]),
    ("sample_decode", ["{mp4}", "{tmp}/o.nv12", "--mode", "seek",
                       "--seek-frame", "50"]),
    ("sample_decode_sw", ["{mp4}", "{tmp}/o.yuv"]),
    ("sample_demux_decode", ["{mp4}"]),
    ("sample_decode_rtsp", ["{mp4}", "--seconds", "30"]),
    ("sample_encode", ["{tmp}/o.nv12", "{tmp}/e.h264", "848", "464",
                       "--preset", "P1"]),
    ("sample_encode_multi_thread", ["--threads", "2", "--frames", "10"]),
    ("sample_transcode", ["{mp4}", "{tmp}/t.h264", "--scale", "424x232"]),
    ("sample_dlpack", ["{mp4}"]),
    ("sample_torch", ["{mp4}", "--frames", "3"]),
    ("sample_remap", ["{mp4}", "--frames", "2"]),
    ("sample_display", ["{mp4}", "--frames", "3"]),
    ("sample_resnet", ["{mp4}", "--frames", "4", "--batch", "2"]),
    ("sample_segmentation", ["{mp4}", "--frames", "2"]),
    ("sample_serving", ["{mp4}", "--clients", "2", "--frames", "8",
                        "--max-batch", "4"]),
    ("sample_batch_inference", ["{mp4}", "--streams", "1", "--batch", "4"]),
    ("sample_decode_multi_thread", ["{mp4}", "--streams", "2"]),
    ("sample_aot_compile", ["{mp4}", "--batch", "4", "--engine",
                            "{tmp}/engine.pt2"]),
    ("sample_device_transcode", ["{mp4}", "{tmp}/d.h264", "--size",
                                 "424x232", "--frames", "24"]),
    ("sample_dataloader", ["{mp4}", "--clip-len", "4", "--batch", "2",
                           "--size", "64", "--workers", "1"]),
    ("sample_dataloader", ["--mjpeg", "--clip-len", "2", "--batch", "2",
                           "--size", "48", "--workers", "1"]),
    ("sample_train_video", ["{mp4}", "--clip-len", "2", "--batch", "2",
                            "--size", "32", "--steps", "2"]),
    ("sample_scenecut", ["{mp4}", "--frames", "32", "--batch", "16"]),
    ("sample_stabilize", ["{mp4}", "--frames", "8", "--jitter", "2"]),
    ("sample_flow_interp", ["{mp4}", "--triplets", "1", "--mv"]),
    ("sample_measure_video_quality", ["{mp4}", "--frames", "16"]),
    ("sample_mjpeg_transcode", ["synth", "{tmp}/t.mjpeg", "--size",
                                "160x120"]),
]


def _nv12_batches(n, seed):
    """``n`` seeded 1080p NV12 host batches of BATCH frames (two distinct
    batches in turn; a coarse pattern under the noise, see phase 8)."""
    from videoprocessingframework_torch.data.loader import seeded_frames

    two = [seeded_frames(BATCH, SRC_H * 3 // 2, SRC_W, seed=seed + k)
           for k in range(2)]
    # contiguous planes, as the sample's decoder gives them
    two = [(np.ascontiguousarray(f[:, :SRC_H]),
            np.ascontiguousarray(f[:, SRC_H:])) for f in two]
    return [two[k % 2] for k in range(n)]


def _launched(fn):
    """(fn's result, fused_resize_csc launches during it): what the
    count gained from just before ``fn`` to just after."""
    from videoprocessingframework_torch.csrc import launch

    counted = launch.LAUNCHES["fused_resize_csc"]
    out = fn()
    return out, launch.LAUNCHES["fused_resize_csc"] - counted


def sample_resnet_path(device) -> dict:
    """14 (a): sample_resnet.run at full width, seeded 1080p NV12 ×BATCH →
    the NV12 instantiation → ResNet-50 (bf16, the sample's dtype)."""
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
    )
    from videoprocessingframework_torch.models import resnet50
    from videoprocessingframework_torch.samples import sample_resnet

    space, rng = ColorSpace.BT_709, ColorRange.MPEG
    batches = _nv12_batches(SAMPLE_BATCHES, seed=61)
    model, ref = _seeded_model(lambda dt: resnet50(dtype=dt), device, 3)
    kw = dict(space=space, rng=rng, device=device)
    sample_resnet.run(batches[:1], model, **kw)  # warm-up: cuDNN plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, launches = _launched(
        lambda: sample_resnet.run(batches, model, **kw))
    torch.cuda.synchronize()
    fps = BATCH * SAMPLE_BATCHES / (time.perf_counter() - t0)
    require(logits.shape == (BATCH * SAMPLE_BATCHES, 1000)
            and bool(torch.isfinite(logits).all()), "sample_resnet logits")
    require(launches >= SAMPLE_BATCHES,
            f"sample_resnet: {launches} NV12 kernel launches")
    x = sample_resnet.preprocess(space, rng, device)(*batches[0])
    with torch.no_grad():
        model_ms = cuda_ms(lambda: model(x), warmup=2, reps=3)
    log(f"(14a) sample_resnet.run 1080p NV12 x{BATCH} -> fused_resize_csc "
        f"(NV12) -> ResNet-50 bf16: {fps:.1f} frames/s over "
        f"{SAMPLE_BATCHES} batches (host clock), ResNet-50 {model_ms:.3f} "
        f"ms a batch (CUDA events); NV12 kernel launches in this run: "
        f"{launches}")

    # CUDA vs CPU on one batch, float32 weights (TF32 off on both ops)
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = sample_resnet.run(batches[:1], ref, **kw).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    cpu = torch.device("cpu")
    want = sample_resnet.run(batches[:1], ref.to(cpu), space=space, rng=rng,
                             device=cpu)
    rel = _rel(got, want)
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    log(f"(14a) sample_resnet.run one batch float32, CUDA vs CPU: top-1 "
        f"equal on all {BATCH}: {same}; max abs diff / max |logit| "
        f"{rel:.3g} (tol {SAMPLE_LOGIT_TOL})")
    require(same and rel <= SAMPLE_LOGIT_TOL, "sample_resnet CUDA vs CPU")
    return {"launches": launches, "fps": fps, "model_ms": model_ms}


def sample_device_paths(device, tmpdir: str) -> dict:
    """14 (b): the other samples' device stages through their ``run`` on
    seeded frames; returns fused_resize_csc's launches (NV12 and planar)."""
    from videoprocessingframework_torch import compat as nvc
    from videoprocessingframework_torch.core.enums import (
        ColorRange,
        ColorSpace,
        PixelFormat,
    )
    from videoprocessingframework_torch.core.surface import Surface
    from videoprocessingframework_torch.data.loader import seeded_frames
    from videoprocessingframework_torch.models import (
        fcn_resnet,
        resnet18_like,
        resnet50,
    )
    from videoprocessingframework_torch.ops.fused import FusedPipeline
    from videoprocessingframework_torch.samples import (
        sample_aot_compile,
        sample_device_transcode,
        sample_flow_interp,
        sample_remap,
        sample_scenecut,
        sample_segmentation,
        sample_serving,
        sample_stabilize,
        sample_torch,
    )

    space, rng = ColorSpace.BT_709, ColorRange.MPEG
    cpu = torch.device("cpu")
    rows = SRC_H * 3 // 2
    rec = {"nv12": 0, "planar": 0}

    # sample_segmentation: one 1080p NV12 frame a call, as the sample has it
    fcn, _ = _seeded_model(lambda dt: fcn_resnet(dtype=dt), device, 4)
    one = [(f[None, :SRC_H], f[None, SRC_H:])
           for f in seeded_frames(8, rows, SRC_W, seed=71)]
    masks, n = _launched(lambda: sample_segmentation.run(
        one, fcn, space=space, rng=rng, device=device))
    rec["nv12"] += n
    m = torch.cat(masks)
    require(m.shape == (8, OUT, OUT) and int(m.min()) >= 0
            and int(m.max()) < 21 and n >= 8, "sample_segmentation")
    log(f"(14b) sample_segmentation: 8 seeded 1080p NV12 frames -> "
        f"fused_resize_csc (NV12) -> FCN bf16: masks {tuple(m.shape)}, "
        f"{int(m.unique().numel())} classes seen; NV12 launches {n}")

    # sample_serving: packed 1080p YUV420 → the planar kernel → ResNet18
    r18 = _seeded_model(lambda dt: resnet18_like(10, dtype=dt), device, 5)[0]
    packed = list(seeded_frames(64, rows, SRC_W, seed=72))
    (out, snap, dt), n = _launched(lambda: sample_serving.run(
        packed, r18, space=space, rng=rng, device=device, clients=4,
        max_batch=8, wait_ms=5.0))
    rec["planar"] += n
    require(all(o is not None and o.shape == (10,)
                and bool(torch.isfinite(o).all()) for o in out)
            and n >= snap["batches"], "sample_serving")
    log(f"(14b) sample_serving: {snap['requests']} requests from 4 clients "
        f"in {snap['batches']} batches, {snap['requests'] / dt:.1f} req/s, "
        f"p50 {snap['latency_ms_p50']:.2f} ms p99 "
        f"{snap['latency_ms_p99']:.2f} ms; planar launches {n} (warm-up "
        f"included)")

    # sample_aot_compile: export, save, load on the card
    r50 = _seeded_model(lambda dt: resnet50(dtype=dt), device, 6)[0]
    t0 = time.perf_counter()
    engine = sample_aot_compile.build_engine(r50, 8, pathlib.Path(
        f"{tmpdir}/resnet50.pt2"), device)
    export_s = time.perf_counter() - t0
    norm = FusedPipeline(PixelFormat.YUV420, space, rng, (OUT, OUT),
                         output="normalized", device=device, kernel="cuda")
    yuv = torch.from_numpy(seeded_frames(8, rows, SRC_W, seed=73))
    x, n = _launched(lambda: norm(yuv.to(device)))
    rec["planar"] += n
    (served, top), _ = _launched(lambda: sample_aot_compile.run(
        [x, x[:3]], engine, 8))
    with torch.no_grad():
        cls, conf = sample_aot_compile.Serve(r50)(x)
        got_cls, got_conf = engine(x)
    err = (got_conf - conf).abs().max().item()
    try:
        engine(x[:4])
        refused = False
    except Exception:  # the program's input check
        refused = True
    require(served == 8 and bool((got_cls == cls).all())
            and err <= AOT_CONF_TOL and refused, "sample_aot_compile")
    log(f"(14b) sample_aot_compile: torch.export + save + load of "
        f"ResNet-50 bf16 for (8, 224, 224, 3) in {export_s:.1f} s; the "
        f"reloaded program vs eager: top-1 equal, confidence max abs diff "
        f"{err:.3g} (tol {AOT_CONF_TOL}); a batch of 4 refused: {refused}")

    # sample_device_transcode's device half: 1:1 RGB → band → encode_feed
    to_rgb = sample_device_transcode.to_rgb(SRC_W, SRC_H, space, rng, device)
    xc = [torch.from_numpy(seeded_frames(4, rows, SRC_W, seed=74 + k))
          for k in range(4)]
    fed, n = _launched(lambda: list(sample_device_transcode.run(
        (to_rgb(b.to(device)) for b in xc), out_w=1280, out_h=720,
        space=space, rng=rng)))
    rec["planar"] += n
    want = next(sample_device_transcode.run(
        [sample_device_transcode.to_rgb(SRC_W, SRC_H, space, rng, cpu)(
            xc[0])], out_w=1280, out_h=720, space=space, rng=rng))
    diff = _maxdiff(fed[0], want)
    require(len(fed) == 4 and fed[0].shape == (4, 1080, 1280) and n >= 4
            and diff <= 1, "sample_device_transcode")
    log(f"(14b) sample_device_transcode device half: 4 batches of 4 seeded "
        f"1080p YUV420 -> fused_resize_csc rgb_f32 1:1 -> band -> "
        f"encode_feed 720p -> planes_to_host_packed {fed[0].shape}; vs the "
        f"CPU: max {diff} code(s) (tol 1); planar launches {n}")

    # sample_torch's device half: the luma dimmed through torch
    nv = seeded_frames(4, rows, SRC_W, seed=75)
    surfs = [Surface.from_host_frame(f, PixelFormat.NV12, SRC_W,
                                     SRC_H).to_device(device) for f in nv]
    dimmed = list(sample_torch.run(surfs))
    ok = all(d.is_on_device and torch.equal(
        d.planes[0], (s.planes[0].float() * 0.9).byte())
        and torch.equal(d.planes[1], s.planes[1])
        for d, s in zip(dimmed, surfs))
    require(ok, "sample_torch")
    log("(14b) sample_torch device half: 4 seeded 1080p NV12 Surfaces -> "
        "luma x0.9 in torch -> Surfaces on the card: luma and chroma exact")

    # sample_remap: NV12 → RGB → barrel remap, vs the CPU
    xmap, ymap = sample_remap.barrel_maps(SRC_W, SRC_H)
    cc = nvc.ColorspaceConversionContext(space, rng)
    up = nvc.PyFrameUploader(SRC_W, SRC_H, nvc.PixelFormat.NV12, device)
    up_cpu = nvc.PyFrameUploader(SRC_W, SRC_H, nvc.PixelFormat.NV12, "cpu")
    got = list(sample_remap.run([up.UploadSingleFrame(f.reshape(-1))
                                 for f in nv[:2]], xmap, ymap, cc, device))
    want = list(sample_remap.run([up_cpu.UploadSingleFrame(f.reshape(-1))
                                  for f in nv[:2]], xmap, ymap, cc, "cpu"))
    diff = max(_maxdiff(g.core.download(), w.core.download())
               for g, w in zip(got, want))
    require(len(got) == 2 and got[0].Width() == SRC_W and diff <= 1,
            "sample_remap")
    log(f"(14b) sample_remap: 2 seeded 1080p NV12 frames -> RGB -> barrel "
        f"remap on the card vs the CPU: max {diff} code(s) (tol 1)")

    # the analysis samples on phase 9's seeded luma at 1080p
    inp = _analysis_inputs(SRC_H, SRC_W)
    shots = sample_scenecut.run(inp["shots"].numpy(), batch=16,
                                min_score=0.18, device=device)
    require(shots == [(0, 16), (16, 32)], f"sample_scenecut {shots}")
    log(f"(14b) sample_scenecut: 32 seeded 1080p frames, a cut after 16: "
        f"shots {shots}")
    _, corr, raw, res = sample_stabilize.run(inp["jittered"][:16].numpy(),
                                             sigma=4.0, device=device)
    require(res < 0.35 * raw, "sample_stabilize")
    log(f"(14b) sample_stabilize: 16 jittered 1080p frames: mean "
        f"|frame-to-frame motion| {raw:.3f} px -> {res:.3f} px, max "
        f"correction {float(np.abs(corr).max()):.2f} px")
    move = [(0, 0), (2, 1), (4, 2)]  # a steady pan: mid lies halfway
    prev, mid, nxt = _moving(SRC_H, SRC_W, move, 36).numpy()
    fl = sample_flow_interp.run(prev, mid, nxt, levels=3, iters=4,
                                device=device)
    shift = float(np.hypot(*move[2]))
    log(f"(14b) sample_flow_interp: 1080p triplet panning {move[2]} px: "
        f"median |flow| {fl['flow']:.3f} px (want {shift:.3f}, tol 0.1), "
        f"midpoint PSNR {fl['synth']:.2f} dB vs frame-repeat "
        f"{fl['repeat']:.2f} dB")
    require(abs(fl["flow"] - shift) <= 0.1 and fl["synth"] > fl["repeat"],
            "sample_flow_interp")
    return rec


def sample_train_path(device, libav_missing: str, tmpdir: str) -> int:
    """14 (c): sample_train_video.run on phase 10's seeded source, on a
    mesh (1, 1) of a world of one, with a checkpoint that a fresh model,
    optimizer and loader resume from."""
    from videoprocessingframework_torch.models import video_resnet18_like
    from videoprocessingframework_torch.parallel.mesh import batch_sharding
    from videoprocessingframework_torch.parallel.train import (
        full_state_dict,
        make_train_step,
    )
    from videoprocessingframework_torch.samples import sample_train_video
    from videoprocessingframework_torch.samples._utils import (
        seeded,
        world_mesh,
    )

    steps, nclass = 8, len(TRAIN_LABELS)
    make_loader = _train_source(device, libav_missing, tmpdir)
    ckdir = pathlib.Path(f"{tmpdir}/train_ck")
    ckdir.mkdir()
    with world_mesh(device, ("data", "model"), (1, 1)) as mesh:
        def parts():
            loader = make_loader(clip_len=4, batch_size=2, out_size=(64, 64),
                                 output="rgb_f32", drop_last=True,
                                 sharding=batch_sharding(mesh),
                                 labels=list(range(nclass)))
            model = seeded(lambda: video_resnet18_like(
                num_classes=nclass, frames=4)).to(device)
            opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
            return loader, model, opt

        loader, model, opt = parts()
        step = make_train_step(model, opt, mesh)
        kw = dict(num_classes=nclass, checkpoint=(ckdir, model, opt),
                  save_every=4)
        _, _, first = sample_train_video.run(loader, step, 1, **kw)
        (done, metrics, secs), n = _launched(lambda: sample_train_video.run(
            loader, step, steps, done=1, **kw))
        require(done == steps and np.isfinite(metrics["loss"])
                and n >= steps - 1, "sample_train_video")
        loader2, model2, opt2 = parts()
        make_train_step(model2, opt2, mesh)
        resumed = sample_train_video.restore(ckdir, model2, opt2, loader2)
        same = all(torch.equal(a, b) for a, b in zip(
            full_state_dict(model).values(),
            full_state_dict(model2).values()))
        require(resumed == steps and same, "sample_train_video resume")
    log(f"(14c) sample_train_video.run: video-ResNet-18-like (2 clips x 4 "
        f"frames at 64², rgb_f32) on mesh (1, 1): the first step "
        f"{first:.2f} s, steps 2-{steps} in {secs:.2f} s (host clock), final "
        f"loss {metrics['loss']:.4f}; planar launches in steps 2-{steps} "
        f"{n}; resumed from the step-{resumed} checkpoint with equal weights")
    return n


def sample_mains(device, libav_missing: str, tmpdir: str) -> None:
    """14 (d): every sample's main() on tests/assets/test.mp4 where libav
    builds; else one line a sample."""
    import importlib

    if libav_missing:
        for name in dict.fromkeys(n for n, _ in SAMPLE_MAINS):
            log(f"(14d) {name}.main did not run: it reads or writes its "
                f"video through libav, whose development files are absent "
                f"({libav_missing})")
        return
    mp4 = str(pathlib.Path(__file__).resolve().parent / "tests" / "assets"
              / "test.mp4")
    for name, args in SAMPLE_MAINS:
        mod = importlib.import_module(
            f"videoprocessingframework_torch.samples.{name}")
        argv = [a.format(mp4=mp4, tmp=tmpdir) for a in args]
        t0 = time.perf_counter()
        rc = mod.main(argv + ["--device", str(device)])
        require(rc == 0, f"{name}.main({argv}) returned {rc}")
        log(f"(14d) {name}.main {' '.join(args)}: ok in "
            f"{time.perf_counter() - t0:.1f} s")


def samples_path(device, libav_missing: str, tmpdir: str) -> dict:
    """Phase 14: the samples (videoprocessingframework_torch/samples), at
    torch's default cuDNN setting, as a sample runs (no benchmark search
    at each new shape)."""
    t0 = time.perf_counter()
    torch.backends.cudnn.benchmark = False
    try:
        resnet = sample_resnet_path(device)
        dev = sample_device_paths(device, tmpdir)
        train = sample_train_path(device, libav_missing, tmpdir)
        sample_mains(device, libav_missing, tmpdir)
    finally:
        torch.backends.cudnn.benchmark = True
    nv12 = resnet["launches"] + dev["nv12"]
    log(f"fused_resize_csc NV12 instantiation launches (phase 14: "
        f"sample_resnet and sample_segmentation): {nv12}")
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    return {"launches": nv12 + dev["planar"] + train, "nv12": nv12,
            "resnet": resnet}


# ---- phase 15 ------------------------------------------------------------------

LAYERS_SOURCES = {
    kind: f"videoprocessingframework_torch/csrc/{kind}.cu"
    for kind in ("layer_norm", "rope2d")}
#: (name, leading shape, width, input dtype, output dtype, ε, class-token
#: rows) of the LayerNorm checks: what the MoonViT and ViT-S/16 cells run
LN_CHECKS = [
    ("moonvit 32768x1152", (32768,), 1152, torch.bfloat16, torch.bfloat16,
     1e-5, False),
    ("pre_norm 8x1024x4x1152", (8, 1024, 4), 1152, torch.bfloat16,
     torch.bfloat16, 1e-5, False),
    ("vit 6304x384", (32 * 197,), 384, torch.bfloat16, torch.float32, 1e-6,
     False),
    ("vit cls 32x384", (32, 197), 384, torch.bfloat16, torch.float32, 1e-6,
     True),
]
#: (name, batch, grid, heads, head_dim) of the RoPE checks, bf16
ROPE_CHECKS = [("moonvit 8x64x64", 8, (64, 64), 16, 72),
               ("moonvit 8x6x10", 8, (6, 10), 16, 72)]


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v|, no finer than at 2^-8 (near zero the two
    versions' float32 sums can round an output that cancels more than its
    own ulp apart; tests/test_torch_layers_cuda.py holds the same)."""
    m = v.float().abs().clamp_min(2.0 ** -8)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def _layer_err(got, want) -> float:
    """bf16: the largest |kernel − plain| in bf16 ulps of the plain
    value (≤ 1 required); float32: over the largest |value| (< 1e-5)."""
    require(got.dtype == want.dtype and got.shape == want.shape,
            f"{got.dtype} {tuple(got.shape)} vs {want.dtype} "
            f"{tuple(want.shape)}")
    d = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        err = float((d / _bf16_ulp(want)).max())
        require(err <= 1.0, f"bf16 stores {err} ulp from the plain version")
    else:
        err = float(d.max() / want.float().abs().max())
        require(err < 1e-5, f"float32 stores {err:.2e} from the plain version")
    return err


def _layer_line(kind, name, ms, ms2, plain, nbytes, mem_rate, extra=""):
    kernel_ms = min(ms, ms2)
    bound = 1e3 * nbytes / mem_rate
    log(f"(15) {kind} {name}: kernel {ms:.4f} / {ms2:.4f} ms, "
        f"{nbytes / 1e6:.1f} MB, {nbytes / kernel_ms / 1e6:.1f} GB/s vs "
        f"bound {bound:.4f} ms (bytes; {100 * bound / kernel_ms:.1f}% of "
        f"bound); plain {plain:.4f} ms{extra}")
    return dict(ms=kernel_ms, plain_ms=plain, bound_ms=bound,
                bound_by="bytes")


def model_layers_path(device, rates) -> dict:
    """Phase 15: the LayerNorm and RoPE kernels against their plain
    versions at the cells' shapes, each timed beside its bound."""
    import torch.nn.functional as F

    from videoprocessingframework_torch.models import layers_cuda as lc
    from videoprocessingframework_torch.models.moonvit import (
        rope2d,
        rope_freqs,
    )

    mem_rate = rates[0]
    g = torch.Generator(device=device).manual_seed(15)
    rec = {"layer_norm": {}, "rope2d": {},
           "worst": {"layer_norm": 0.0, "rope2d": 0.0}}
    for name, lead, d, dt, out_dt, eps, cls in LN_CHECKS:
        w = 1.0 + 0.1 * torch.randn(d, device=device, generator=g)
        b = 0.1 * torch.randn(d, device=device, generator=g)
        x = (3.0 * torch.randn(*lead, d, device=device, generator=g)
             + torch.randn(*lead, 1, device=device, generator=g)).to(dt)
        if cls:
            x = x[:, 0]  # rows 197·384 apart, as ViT's final norm reads
        with torch.no_grad():
            def kern():
                return lc.layer_norm(x, w, b, eps, out_dt)

            def plain():
                return F.layer_norm(x.float(), (d,), w, b, eps).to(out_dt)

            err = _layer_err(kern(), plain())
            rec["worst"]["layer_norm"] = max(rec["worst"]["layer_norm"], err)
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain, reps=5)
            ms2 = cuda_ms(kern)
            extra, library = "", None
            if dt == out_dt == torch.bfloat16:
                # one PyTorch call on bf16 rows (it takes γ and β only in
                # the rows' dtype): the speed yardstick, not the function
                wb, bb = w.bfloat16(), b.bfloat16()
                library = cuda_ms(lambda: F.layer_norm(x, (d,), wb, bb, eps))
                extra = (f"; library F.layer_norm on bf16 rows, bf16 γ, β "
                         f"{library:.4f} ms")
        rows = x.numel() // d
        nbytes = rows * d * (x.element_size() + out_dt.itemsize) + 8 * d
        r = _layer_line("layer_norm", name, ms, ms2, plain_ms, nbytes,
                        mem_rate, f"; err {err:.3g}{extra}")
        rec["layer_norm"][name] = dict(r, library_ms=library)
    for name, n, grid, heads, hd in ROPE_CHECKS:
        length = grid[0] * grid[1]
        qkv = torch.randn(n, length, 3 * heads * hd, device=device,
                          generator=g).bfloat16().view(n, length, 3, heads,
                                                       hd)
        freqs = rope_freqs(grid, hd, 10000.0, device)
        with torch.no_grad():
            def kern():
                return lc.rope2d(qkv, freqs)

            def plain():
                return rope2d(qkv[:, :, 0], freqs), rope2d(qkv[:, :, 1],
                                                           freqs)

            err = max(_layer_err(a, p) for a, p in zip(kern(), plain()))
            rec["worst"]["rope2d"] = max(rec["worst"]["rope2d"], err)
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain, reps=5)
            ms2 = cuda_ms(kern)
        # q and k read once and written once, the table read once
        nbytes = 4 * n * length * heads * hd * 2 + length * hd * 4
        rec["rope2d"][name] = _layer_line(
            "rope2d", name, ms, ms2, plain_ms, nbytes, mem_rate,
            f"; err {err:.3g}; library: none")
    rec["moonvit"] = moonvit_forward(device, g)
    log(f"phase 15 ok: worst kernel-vs-plain error {rec['worst']} "
        f"(bf16 ulps, or float32 relative)")
    return rec


def moonvit_forward(device, g) -> dict:
    """Phase 15 (b): one eager forward of the published MoonViT at the
    cell's batch, its kernel launches counted alone; then on the plain
    versions."""
    from videoprocessingframework_torch.csrc import launch
    from videoprocessingframework_torch.models import kimi_vl_moonvit
    from videoprocessingframework_torch.models import layers_cuda as lc

    torch.manual_seed(15)
    m = kimi_vl_moonvit().to(device).eval()
    x = torch.randn(8, 896, 896, 3, device=device, generator=g)
    with torch.no_grad():
        counted = dict(launch.LAUNCHES)
        got = m._forward(x)
        torch.cuda.synchronize()
        launches = {k: launch.LAUNCHES[k] - counted[k]
                    for k in ("layer_norm", "rope2d")}
        stats = {k: m.vision_stats[k]
                 for k in ("norm_launches", "rope_launches")}
        ms = cuda_ms(lambda: m._forward(x), warmup=1, reps=3)
        takes = lc.takes_kernel
        lc.takes_kernel = lambda *a: False  # every call on the plain chain
        try:
            want = m._forward(x)
            plain_ms = cuda_ms(lambda: m._forward(x), warmup=1, reps=3)
        finally:
            lc.takes_kernel = takes
    gap = float((got - want).abs().max() / want.abs().max())
    log(f"(15b) kimi_vl_moonvit() 8 x 896²: launches {launches}, "
        f"vision_stats {stats}; eager forward {ms:.2f} ms, on the plain "
        f"versions {plain_ms:.2f} ms; output gap {gap:.3g} of the largest "
        f"|value|")
    require(launches == {"layer_norm": 56, "rope2d": 27}
            and stats == {"norm_launches": 56, "rope_launches": 27},
            f"MoonViT forward launched {launches} ({stats}), not 56 and 27")
    require(bool(torch.isfinite(got).all()), "non-finite MoonViT output")
    return {"launches": launches, "forward_ms": ms,
            "plain_forward_ms": plain_ms, "output_gap": gap}


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
    from videoprocessingframework_torch.csrc import launch
    layer_counts = {}  # path → its own LayerNorm and RoPE launches

    def path(name, fn, *args):
        """Run one phase's path and keep that path's own launch counts
        (what ``LAUNCHES`` gained over it)."""
        counted = dict(launch.LAUNCHES)
        out = fn(*args)
        layer_counts[name] = {k: n - counted[k]
                              for k, n in launch.LAUNCHES.items()}
        return out

    worst_u8 = check_kernel(device)
    log(f"phase 3 ok: worst u8 kernel-vs-plain error {worst_u8:.0f}")
    times = time_kernel(device, rates)
    time_kernel(device, rates, h=2160, w=3840)
    for b, h, w, oh, ow in ((1, SRC_H, SRC_W, OUT, OUT),
                            (BATCH, 464, 848, 61, 45),
                            (BATCH, 240, 320, SRC_H, SRC_W)):
        time_kernel(device, rates, b=b, h=h, w=w, oh=oh, ow=ow, others=False)
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        run = path("5 main", main_path, device, missing, tmp)
    conv = path("6 converter", converter_path, device, rates)
    time_kernel(device, rates, layout="nv12")  # phase 7
    served = path("8 serving", serving_path, device)
    path("9 analysis", analysis_path, device)
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        train = path("10 training", training_path, device, missing, tmp)
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        xcode = path("11 transcode", transcode_path, device, rates, missing,
                     tmp)
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        mjpeg = path("12 mjpeg", mjpeg_path, device, rates, missing, tmp)
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        par = path("13 parallel", parallel_path, device, missing, tmp,
                   times["normalized"]["ms"], train["plain"])
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        samples = path("14 samples", samples_path, device, missing, tmp)
    log(f"LayerNorm and RoPE kernel launches by path (phases 5-14): "
        f"{layer_counts}")
    require(layer_counts["8 serving"]["layer_norm"] > 0,
            "the served ViT-S and VideoViT-S launched no LayerNorm kernel")
    require(all(c["rope2d"] == 0 for c in layer_counts.values()),
            "a path with no MoonViT launched the RoPE kernel")
    layers = model_layers_path(device, rates)
    layer_counts["15b moonvit"] = layers["moonvit"]["launches"]

    t = times["normalized"]
    c = conv["times"]["nv12"]
    record = {"kernels": [{
        "name": "fused_resize_csc",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": run["launches"] + served["image"]["launches"]
        + served["clip"]["launches"] + train["plain"]["launches"]
        + xcode["transcode"]["launches"] + xcode["libav"]["launches"]
        + mjpeg["launches"] + par["launches"] + samples["launches"],
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
        "launches": conv["launches"] + xcode["compat"]["launches"],
        "max_abs_err": conv["max_abs_err"],
        "ms": c["ms"],
        "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"],
        "library_ms": None,
    }] + [{
        "name": kind,
        "route": "cuda",
        "source": LAYERS_SOURCES[kind],
        "replaces": None,
        "launches": sum(c[kind] for c in layer_counts.values()),
        "launches_by_path": {name: c[kind] for name, c in layer_counts.items()
                             if c[kind]},
        "max_err": layers["worst"][kind],
        "at": layers[kind],
    } for kind in ("layer_norm", "rope2d")]}
    log(f"total {time.perf_counter() - t_start:.1f} s on {dev_info['smi']}")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
