// Fused 4:2:0 YUV (planar or NV12) u8 -> separable resize -> CSC -> planar RGB.
//
// Replaces the Pallas kernels of videoprocessingframework_tpu/ops/pallas_fused.py:
// fused_yuv420_resize_rgb_pallas (whole-frame _fused_planar_factory, and the
// two-pass _k1p_striped_factory + _k2p_factory pair used for 4K-class
// frames) and fused_nv12_resize_rgb_pallas (_k1_banded_factory / _k1_factory
// + _k2_factory). The TPU split that one function into several kernels only
// to fit VMEM; here one launch per batch computes it.
//
// Bound: memory. At 1080p -> 224x224 rgb_u8 a frame reads 3,110,400 B of
// planes and writes 150,528 B, about 3.26 MB, for some 70 flops per output
// pixel, far below the card's operations-per-byte line.
//
// Design (first, simple version): one thread per output pixel computes all
// three channels. The resize matrices have a contiguous support of at most
// 6 source pixels per output row and column, so the wrapper hands compact
// tap tables (start index + K float32 weights per output row / column,
// taken from the dense matrix); chroma tables come from the half-grid
// collapsed matrix, so 4:2:0 chroma is read at its native resolution. Each
// plane is a float32 separable sum (columns inside rows), then the offsets
// are subtracted, the 3x3 CSC applied, and the store rounds half-to-even
// (rintf) and clamps, or scales to [0,1] and normalizes. Neighbouring
// threads read neighbouring source windows, so a warp's loads fall on a
// few cache lines per source row; shared-memory row windows and wide
// loads are later work.
//
// Plain C interface, loaded with ctypes (videoprocessingframework_torch/
// csrc/build.py). The caller launches on its current stream and checks the
// returned cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#define VPF_KERNEL_API extern "C" __attribute__((visibility("default")))

namespace {

struct Taps {
  const int32_t* start;  // (n_out,) first source index of the window
  const float* w;        // (n_out, k) weights, row-major
  int k;
};

struct Args {
  const uint8_t* y;
  const uint8_t* u;
  const uint8_t* v;
  int64_t y_bs, y_rs;  // luma batch / row strides (bytes)
  int64_t c_bs, c_rs;  // chroma batch / row strides (bytes)
  Taps ry, rc, cy, cc;  // rows luma / chroma, cols luma / chroma
  void* out;            // (B, 3, out_h, out_w) u8 or f32
  int out_h, out_w;
  float m[9];        // CSC rows in output channel order (swap applied)
  float off[3];      // Y/Cb/Cr offsets
  float mean[3];     // per output channel (normalized mode)
  float inv_std[3];
};

// Separable resample of one plane at output pixel (oy, ox). STEP is the
// element step within a row: 1 for planar planes, 2 for NV12's UV.
template <int STEP>
__device__ __forceinline__ float resample(const uint8_t* plane, int64_t rs,
                                          const Taps& r, const Taps& c,
                                          int oy, int ox) {
  const int r0 = __ldg(r.start + oy);
  const int c0 = __ldg(c.start + ox);
  const float* rw = r.w + (int64_t)oy * r.k;
  const float* cw = c.w + (int64_t)ox * c.k;
  float acc = 0.f;
  for (int i = 0; i < r.k; ++i) {
    const float wr = __ldg(rw + i);
    if (wr == 0.f) continue;
    const uint8_t* row = plane + (int64_t)(r0 + i) * rs + (int64_t)c0 * STEP;
    float h = 0.f;
    for (int j = 0; j < c.k; ++j)
      h = fmaf(__ldg(cw + j), (float)__ldg(row + j * STEP), h);
    acc = fmaf(wr, h, acc);
  }
  return acc;
}

template <int MODE>
__device__ __forceinline__ void store(void* out, int64_t idx, float val,
                                      float mean, float inv_std) {
  if (MODE == 0) {  // rgb_u8: round half to even, saturate
    const float q = fminf(fmaxf(rintf(val), 0.f), 255.f);
    static_cast<uint8_t*>(out)[idx] = (uint8_t)q;
  } else {  // rgb_f32 / normalized
    float x = fminf(fmaxf(val * (1.0f / 255.0f), 0.f), 1.f);
    if (MODE == 2) x = (x - mean) * inv_std;
    static_cast<float*>(out)[idx] = x;
  }
}

template <int STEP, int MODE>
__global__ void __launch_bounds__(256)
fused_resize_csc_kernel(const Args a) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  const int64_t b = blockIdx.z;
  if (ox >= a.out_w || oy >= a.out_h) return;

  const float yv =
      resample<1>(a.y + b * a.y_bs, a.y_rs, a.ry, a.cy, oy, ox) - a.off[0];
  const float uv =
      resample<STEP>(a.u + b * a.c_bs, a.c_rs, a.rc, a.cc, oy, ox) - a.off[1];
  const float vv =
      resample<STEP>(a.v + b * a.c_bs, a.c_rs, a.rc, a.cc, oy, ox) - a.off[2];

  const int64_t plane = (int64_t)a.out_h * a.out_w;
  const int64_t base = b * 3 * plane + (int64_t)oy * a.out_w + ox;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float val = a.m[3 * i] * yv + a.m[3 * i + 1] * uv + a.m[3 * i + 2] * vv;
    store<MODE>(a.out, base + i * plane, val, a.mean[i], a.inv_std[i]);
  }
}

template <int STEP, int MODE>
void launch(const Args& a, int batch, cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid((a.out_w + 31) / 32, (a.out_h + 7) / 8, batch);
  fused_resize_csc_kernel<STEP, MODE><<<grid, block, 0, s>>>(a);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
VPF_KERNEL_API int vpf_fused_resize_csc(
    const uint8_t* y, const uint8_t* u, const uint8_t* v, int chroma_step,
    int batch, int64_t y_bs, int64_t y_rs, int64_t c_bs, int64_t c_rs,
    const int32_t* rs_y, const float* rw_y, int kr_y,
    const int32_t* rs_c, const float* rw_c, int kr_c,
    const int32_t* cs_y, const float* cw_y, int kc_y,
    const int32_t* cs_c, const float* cw_c, int kc_c,
    void* out, int out_h, int out_w, int mode, const float* csc,
    void* stream) {
  if (batch <= 0 || batch > 65535 || out_h <= 0 || out_w <= 0 ||
      (chroma_step != 1 && chroma_step != 2) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.y = y;
  a.u = u;
  a.v = v;
  a.y_bs = y_bs;
  a.y_rs = y_rs;
  a.c_bs = c_bs;
  a.c_rs = c_rs;
  a.ry = Taps{rs_y, rw_y, kr_y};
  a.rc = Taps{rs_c, rw_c, kr_c};
  a.cy = Taps{cs_y, cw_y, kc_y};
  a.cc = Taps{cs_c, cw_c, kc_c};
  a.out = out;
  a.out_h = out_h;
  a.out_w = out_w;
  for (int i = 0; i < 9; ++i) a.m[i] = csc[i];
  for (int i = 0; i < 3; ++i) {
    a.off[i] = csc[9 + i];
    a.mean[i] = csc[12 + i];
    a.inv_std[i] = csc[15 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chroma_step == 1) {
    if (mode == 0) launch<1, 0>(a, batch, s);
    else if (mode == 1) launch<1, 1>(a, batch, s);
    else launch<1, 2>(a, batch, s);
  } else {
    if (mode == 0) launch<2, 0>(a, batch, s);
    else if (mode == 1) launch<2, 1>(a, batch, s);
    else launch<2, 2>(a, batch, s);
  }
  return (int)cudaGetLastError();
}

VPF_KERNEL_API const char* vpf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
