// Full-resolution 4:2:0 YUV (NV12 or planar) u8 -> CSC -> planar RGB u8.
//
// Replaces the Pallas kernel of videoprocessingframework_tpu/ops/
// pallas_kernels.py: nv12_to_rgb_planar_pallas (pallas_call at :96, body
// _kernel_factory), which yuv420_to_rgb_planar_pallas also reaches after an
// XLA U/V interleave. Here planar U and V are read directly (STEP 1): the
// interleave was a workaround for the TPU's lane layout.
//
//   out[b, c, i, j] = clip(rint((m[c,0]*y' + m[c,1]*u') + m[c,2]*v'), 0, 255)
//   y' = y[i, j] - off0, u' = U[i/2, j/2] - off1, v' = V[i/2, j/2] - off2
//
// in float32, each product and sum rounded on its own (__fmul_rn /
// __fadd_rn): nvcc would otherwise contract a*b + c into an FMA, and one
// rounding fewer can flip a code at a rounding boundary against the plain
// PyTorch version (ops/csc_cuda.py), which this kernel equals exactly.
// rintf rounds half to even, as torch.round.
//
// Bound: memory. At 1080p a frame reads 3,110,400 B (Y 2,073,600 + chroma
// 1,036,800) and writes 6,220,800 B, 9,331,200 B in all, for about 18
// flops per output pixel (far below the card's operations-per-byte line).
// At the H100 SXM's 3.35 TB/s that is 2.79 us per frame, 0.0891 ms per
// batch of 32.
//
// Design: every byte is used once, so no shared memory and no TMA. One
// thread takes VEC (8; 4 or 2 where the frame width or the alignment of
// the planes does not allow more) luma columns of one row pair, and the
// VEC/2 chroma samples they share: one vector load per luma row and per
// chroma plane (NV12's interleaved UVUV is one load), then 3 channels x 2
// rows vector stores. Neighbouring threads take neighbouring columns, so a
// warp's loads and stores are contiguous runs. The grid is flat over one
// frame's (row pair, column run) pairs, with the batch on grid.y, so no
// block idles at a row's end. Byte offsets are int64 (a 2160p x 32 output
// is 796 MB). The TPU kernel's row-parity reshape and lane-roll
// deinterleave were layout devices for its vector unit and are not ported.
//
// Plain C interface, loaded with ctypes (videoprocessingframework_torch/
// csrc/build.py). The caller launches on its current stream and checks the
// returned cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define VPF_KERNEL_API extern "C" __attribute__((visibility("default")))

namespace {

struct CscArgs {
  const uint8_t* y;
  const uint8_t* u;  // NV12: the interleaved UV plane
  const uint8_t* v;  // NV12: unused
  int64_t y_bs, y_rs;  // luma batch / row strides (bytes)
  int64_t c_bs, c_rs;  // chroma batch / row strides (bytes)
  uint8_t* out;        // (B, 3, height, width), contiguous
  int height, width;
  float m[9];    // CSC rows in output channel order (swap applied)
  float off[3];  // Y/Cb/Cr offsets
};

template <int N> struct VecOf;
template <> struct VecOf<1> { using T = uint8_t; };
template <> struct VecOf<2> { using T = uchar2; };
template <> struct VecOf<4> { using T = uchar4; };
template <> struct VecOf<8> { using T = uint2; };

// N bytes from an N-aligned address in one load (or store).
template <int N>
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint8_t* d) {
  const typename VecOf<N>::T v =
      *reinterpret_cast<const typename VecOf<N>::T*>(p);
  memcpy(d, &v, N);
}

template <int N>
__device__ __forceinline__ void store_bytes(uint8_t* p, const uint8_t* s) {
  typename VecOf<N>::T v;
  memcpy(&v, s, N);
  *reinterpret_cast<typename VecOf<N>::T*>(p) = v;
}

__device__ __forceinline__ uint8_t csc_channel(float m0, float m1, float m2,
                                               float y, float u, float v) {
  const float val = __fadd_rn(__fadd_rn(__fmul_rn(m0, y), __fmul_rn(m1, u)),
                              __fmul_rn(m2, v));
  return (uint8_t)fminf(fmaxf(rintf(val), 0.f), 255.f);
}

// STEP: chroma element step (2 NV12, 1 planar). VEC: luma columns a thread.
template <int STEP, int VEC>
__global__ void __launch_bounds__(256) csc_rgb_planar_kernel(const CscArgs a) {
  constexpr int C = VEC / 2;  // chroma samples a thread
  const int runs = a.width / VEC;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)(a.height / 2) * runs) return;
  const int ci = (int)(t / runs);            // chroma row = luma row pair
  const int j0 = (int)(t - (int64_t)ci * runs) * VEC;  // first luma column
  const int64_t b = blockIdx.y;

  float cu[C], cv[C];
  {
    const int64_t crow = b * a.c_bs + (int64_t)ci * a.c_rs;
    if constexpr (STEP == 2) {
      uint8_t uv[VEC];  // U V U V ...
      load_bytes<VEC>(a.u + crow + j0, uv);
#pragma unroll
      for (int k = 0; k < C; ++k) {
        cu[k] = __fsub_rn((float)uv[2 * k], a.off[1]);
        cv[k] = __fsub_rn((float)uv[2 * k + 1], a.off[2]);
      }
    } else {
      uint8_t uu[C], vv[C];
      load_bytes<C>(a.u + crow + j0 / 2, uu);
      load_bytes<C>(a.v + crow + j0 / 2, vv);
#pragma unroll
      for (int k = 0; k < C; ++k) {
        cu[k] = __fsub_rn((float)uu[k], a.off[1]);
        cv[k] = __fsub_rn((float)vv[k], a.off[2]);
      }
    }
  }

  const int64_t plane = (int64_t)a.height * a.width;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 2 * ci + r;
    uint8_t ly[VEC];
    load_bytes<VEC>(a.y + b * a.y_bs + (int64_t)row * a.y_rs + j0, ly);
    float yv[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) yv[e] = __fsub_rn((float)ly[e], a.off[0]);
    uint8_t* o = a.out + b * 3 * plane + (int64_t)row * a.width + j0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint8_t res[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        res[e] = csc_channel(a.m[3 * c], a.m[3 * c + 1], a.m[3 * c + 2],
                             yv[e], cu[e / 2], cv[e / 2]);
      store_bytes<VEC>(o + c * plane, res);
    }
  }
}

template <int STEP, int VEC>
void launch(const CscArgs& a, int batch, cudaStream_t s) {
  const int64_t n = (int64_t)(a.height / 2) * (a.width / VEC);
  const dim3 grid((unsigned)((n + 255) / 256), (unsigned)batch);
  csc_rgb_planar_kernel<STEP, VEC><<<grid, 256, 0, s>>>(a);
}

bool aligned(const void* p, int64_t a, int64_t b, int n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0 && a % n == 0 &&
         b % n == 0;
}

}  // namespace

// vec: 8, 4 or 2 luma columns a thread. It needs width % vec == 0, luma base
// and strides aligned to vec, NV12 chroma aligned to vec and planar chroma
// to vec / 2 (the wrapper picks it; checked again here).
// csc: m[9] (rows in output channel order) then off[3].
// Returns the cudaError_t of the launch (0 on success).
VPF_KERNEL_API int vpf_csc_rgb_planar(
    const uint8_t* y, const uint8_t* u, const uint8_t* v, int chroma_step,
    int batch, int height, int width, int64_t y_bs, int64_t y_rs,
    int64_t c_bs, int64_t c_rs, uint8_t* out, int vec, const float* csc,
    void* stream) {
  if (batch <= 0 || batch > 65535 || height < 2 || width < 2 ||
      height % 2 || width % 2 || (chroma_step != 1 && chroma_step != 2) ||
      (vec != 2 && vec != 4 && vec != 8) || width % vec)
    return (int)cudaErrorInvalidValue;
  const int cvec = chroma_step == 2 ? vec : vec / 2;
  if (!aligned(y, y_bs, y_rs, vec) || !aligned(u, c_bs, c_rs, cvec) ||
      (chroma_step == 1 && !aligned(v, c_bs, c_rs, cvec)) ||
      !aligned(out, 0, width, vec))
    return (int)cudaErrorMisalignedAddress;
  CscArgs a;
  a.y = y;
  a.u = u;
  a.v = v;
  a.y_bs = y_bs;
  a.y_rs = y_rs;
  a.c_bs = c_bs;
  a.c_rs = c_rs;
  a.out = out;
  a.height = height;
  a.width = width;
  for (int i = 0; i < 9; ++i) a.m[i] = csc[i];
  for (int i = 0; i < 3; ++i) a.off[i] = csc[9 + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chroma_step == 2) {
    if (vec == 8) launch<2, 8>(a, batch, s);
    else if (vec == 4) launch<2, 4>(a, batch, s);
    else launch<2, 2>(a, batch, s);
  } else {
    if (vec == 8) launch<1, 8>(a, batch, s);
    else if (vec == 4) launch<1, 4>(a, batch, s);
    else launch<1, 2>(a, batch, s);
  }
  return (int)cudaGetLastError();
}
