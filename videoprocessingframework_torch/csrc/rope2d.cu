// MoonViT's 2-D rotary embedding of the queries and keys, read in place from
// the QKV projection's output and written in its own dtype, the turn in
// float32 registers.
//
// Replaces no Pallas kernel: the JAX package has no MoonViT and no RoPE.
// The port's plain version (models/moonvit.py rope2d: a strided .float() of
// the q or k slice, a complex64 product, then .to(bf16)) makes three passes
// each for q and k and sends two float32 copies through device memory; this
// kernel is one pass over both.
//
//   out[w, n, l, h, 2p]   = a * cos(l, p) - b * sin(l, p)
//   out[w, n, l, h, 2p+1] = a * sin(l, p) + b * cos(l, p)
//   a, b = qkv[n, l, w, h, 2p], qkv[n, l, w, h, 2p+1], w = 0 (q), 1 (k)
//
// cos and sin are read, not recomputed: the float32 (L, head_dim/2, 2) view
// of the complex64 table rope_freqs made (1.2 MB at 4,096 positions and head
// dim 72, so it stays in L2), which keeps the numbers those of the plain
// version. The product is the complex product's, rounded once at the store.
//
// Bound: memory. q and k are read once and written once: at MoonViT's
// (8, 4096, 3, 16, 72) bf16 QKV output, 151 MB in and 151 MB out, 302 MB a
// block, 90 us at the H100 SXM's 3.35 TB/s; the plain version moves about
// 1.5 GB.
//
// Design: a thread takes one VEC-element run of one head of one position,
// for q and for k, with one table load for both (a run's pairs share their
// angles across q and k). VEC is 8 for bf16 and float16 (16-byte loads) and
// 4 for float32 (16 bytes too) and float64, or 4 where head_dim or the
// alignment does not allow 8. A block takes one position (144 runs, 160 threads, at MoonViT's
// widths): its q and its k each lie in one contiguous stretch of the QKV row
// (3 * heads * head_dim elements), so a warp's loads are contiguous runs, and
// the block finds its position and table row with one division. The output
// is one (2, N, L, heads, head_dim) buffer: q and k each contiguous (N, L,
// heads, head_dim), the layout the plain version returns, so the attention's
// inputs keep their strides.
//
// Plain C interface, loaded with ctypes (videoprocessingframework_torch/
// csrc/build.py). The caller launches on its current stream and checks the
// returned cudaError_t.

#include "vec_io.cuh"

namespace {

using namespace vpf;

struct RopeArgs {
  const void* qkv;
  int64_t s_n, s_l, s_w, s_h;  // element strides of (N, L, 3, heads, .)
  const float* freqs;          // (L, head_dim / 2, 2): cos, sin
  void* out;                   // (2, N, L, heads, head_dim)
  int64_t positions;           // N * L
  int length, heads, head_dim;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(1024) rope2d_kernel(const RopeArgs a) {
  const unsigned pos = blockIdx.x;  // n * L + l
  const unsigned n = pos / (unsigned)a.length;
  const unsigned l = pos - n * (unsigned)a.length;
  const int per_head = a.head_dim / VEC;
  const int runs = a.heads * per_head;  // runs a position, q or k
  const T* src0 = static_cast<const T*>(a.qkv) + n * a.s_n + l * a.s_l;
  T* dst0 = static_cast<T*>(a.out) + (int64_t)pos * a.heads * a.head_dim;
  const int64_t plane = a.positions * a.heads * (int64_t)a.head_dim;
  const float* fl = a.freqs + (int64_t)l * a.head_dim;
  for (int j = threadIdx.x; j < runs; j += blockDim.x) {
    const int h = j / per_head;
    const int c = (j - h * per_head) * VEC;  // first channel of the run
    float f[VEC];  // cos, sin of the run's VEC / 2 pairs
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(fl + c + k);
      f[k] = v.x;
      f[k + 1] = v.y;
      f[k + 2] = v.z;
      f[k + 3] = v.w;
    }
    const T* src = src0 + h * a.s_h + c;
    float v[2][VEC];
    load_vec<T, VEC>(src, v[0]);
    load_vec<T, VEC>(src + a.s_w, v[1]);
    T* dst = dst0 + h * a.head_dim + c;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      float o[VEC];
#pragma unroll
      for (int k = 0; k < VEC; k += 2) {
        const float re = v[w][k], im = v[w][k + 1];
        o[k] = re * f[k] - im * f[k + 1];
        o[k + 1] = re * f[k + 1] + im * f[k];
      }
      store_vec<T, VEC>(dst + w * plane, o);
    }
  }
}

template <typename T, int VEC>
void launch(const RopeArgs& a, cudaStream_t s) {
  const int runs = a.heads * (a.head_dim / VEC);
  const int threads = runs >= 1024 ? 1024 : (runs + 31) / 32 * 32;
  rope2d_kernel<T, VEC><<<(unsigned)a.positions, threads, 0, s>>>(a);
}

}  // namespace

// qkv: (N, L, 3, heads, head_dim) with element strides s_n, s_l, s_w, s_h
// and a contiguous last dimension; freqs: (L, head_dim / 2, 2) float32
// contiguous, 16-byte aligned; out: (2, N, L, heads, head_dim) contiguous.
// dtype (qkv and out): 0 float32, 1 bfloat16, 2 float16, 3 float64
// (vec_io.cuh). vec: 8 (16-bit types) or 4 elements a thread; head_dim % vec
// == 0 and qkv, its strides and out aligned to vec elements (the wrapper
// picks it; checked again here). Returns the cudaError_t of the launch.
VPF_KERNEL_API int vpf_rope2d(const void* qkv, int dtype, int64_t s_n,
                              int64_t s_l, int64_t s_w, int64_t s_h,
                              const float* freqs, void* out, int batch,
                              int length, int heads, int head_dim, int vec,
                              void* stream) {
  if (batch <= 0 || length <= 0 || heads <= 0 || head_dim <= 0 ||
      !valid_dtype(dtype) || (vec != 4 && vec != 8) || head_dim % vec)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)batch * length > 0x7fffffff ||
      (vec == 8 && dtype_bytes(dtype) != 2))
    return (int)cudaErrorInvalidValue;
  const int eb = vec * dtype_bytes(dtype);
  if (!aligned(qkv, eb) || !aligned(out, eb) || !aligned(freqs, 16) ||
      s_n % vec || s_l % vec || s_w % vec || s_h % vec)
    return (int)cudaErrorMisalignedAddress;
  RopeArgs a;
  a.qkv = qkv;
  a.s_n = s_n;
  a.s_l = s_l;
  a.s_w = s_w;
  a.s_h = s_h;
  a.freqs = freqs;
  a.out = out;
  a.positions = (int64_t)batch * length;
  a.length = length;
  a.heads = heads;
  a.head_dim = head_dim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch<float, 4>(a, s); break;
    case kBF16:
      if (vec == 8) launch<__nv_bfloat16, 8>(a, s);
      else launch<__nv_bfloat16, 4>(a, s);
      break;
    case kF16:
      if (vec == 8) launch<__half, 8>(a, s);
      else launch<__half, 4>(a, s);
      break;
    default: launch<double, 4>(a, s);
  }
  return (int)cudaGetLastError();
}
