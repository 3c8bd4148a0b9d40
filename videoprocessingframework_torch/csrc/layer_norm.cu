// LayerNorm over the last dimension: float32, bf16, float16 or float64 rows
// in, one store in any of the four out, float32 in registers in between.
//
// Replaces no Pallas kernel: the JAX package leaves LayerNorm to XLA, which
// fuses the cast, the statistics and the affine step into one pass over the
// rows. The port's plain chain (models/vit.py LayerNorm: x.float(), then
// F.layer_norm in float32, then .to(out_dtype)) makes three passes and sends
// a float32 copy of the rows through device memory twice; this kernel is the
// one pass.
//
//   mean = sum(x) / D,  var = sum((x - mean)^2) / D,  r = 1 / sqrt(var + eps)
//   y = gamma * (r * (x - mean)) + beta        (float32; rounded once, at
//                                               the store)
//
// The statistics are two passes over the registers, as F.layer_norm's are
// float32 over the same row; the order of the sums differs, so a bf16 store
// may differ from the plain chain's by one unit in the last place.
//
// Bound: memory. A row is read once and written once; gamma and beta (D
// floats each) stay in L1/L2. At MoonViT's 32,768 rows x 1152, bf16 in and
// out, that is 151 MB a call, 45 us at the H100 SXM's 3.35 TB/s; the plain
// chain moves 755 MB.
//
// Design: one warp a row, held in registers a chunk at a time. A lane takes
// NV vectors of VEC elements, lane-interleaved so that each of a warp's
// loads is one contiguous run: a chunk is 32 * NV * VEC elements. VEC is 4
// (8 bytes of bf16, 16 of float32) where the width, the row stride and the
// pointers allow it, else 1. NV is the smallest of 3, 4, 9 and 16 that
// covers the row (D = 384, 512, 1152, 2048: exact; D = 192: 3, half
// masked); with scalar loads it is 16. A row no wider than its chunk (the
// package's models at their own widths) is read once: its statistics are
// the two passes over the registers, and its store reads the registers. A
// wider row takes each chunk's mean and squared deviations the same way,
// merges them by Chan, Golub and LeVeque's pairwise formula, and reads the
// row a second time for the store. The sums are warp shuffles: no shared memory, no
// block barrier. Rows take a row stride (ViT's class-token rows x[:, 0]);
// the output is contiguous. Four rows a block. The input type is a template
// parameter of the kernel, the output's one uniform branch around the row
// (a branch at each store ran 5% slower at 32,768 x 1152): one kernel for
// each input type and vector shape, 20 in all.
//
// Plain C interface, loaded with ctypes (videoprocessingframework_torch/
// csrc/build.py). The caller launches on its current stream and checks the
// returned cudaError_t.

#include "vec_io.cuh"

namespace {

using namespace vpf;

constexpr int kRowsPerBlock = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This lane's elements of the chunk of n elements at xr, in v.
template <typename Tin, int VEC, int NV>
__device__ __forceinline__ void load_chunk(const Tin* xr, int n, int lane,
                                           float (&v)[NV][VEC]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (lane + 32 * i) * VEC;
    if (c < n) load_vec<Tin, VEC>(xr + c, v[i]);
  }
}

// The row at xr into yr: the chunks' statistics, then the store.
template <typename Tin, typename Tout, int VEC, int NV>
__device__ __forceinline__ void norm_row(const Tin* __restrict__ xr,
                                         Tout* __restrict__ yr,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         int dim, float eps, int lane) {
  constexpr int kChunk = 32 * NV * VEC;
  float v[NV][VEC];
  float mean = 0.f, m2 = 0.f;  // of the chunks so far
  for (int base = 0; base < dim; base += kChunk) {
    const int n = min(kChunk, dim - base);
    load_chunk<Tin, VEC, NV>(xr + base, n, lane, v);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((lane + 32 * i) * VEC < n) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) sum += v[i][k];
      }
    }
    const float cm = warp_sum(sum) / (float)n;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((lane + 32 * i) * VEC < n) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float d = v[i][k] - cm;
          sq += d * d;
        }
      }
    }
    const float cm2 = warp_sum(sq);
    if (base == 0) {
      mean = cm;
      m2 = cm2;
    } else {  // merge with the base elements before this chunk
      const float na = (float)base, nb = (float)n, nt = na + nb;
      const float delta = cm - mean;
      mean += delta * (nb / nt);
      m2 += cm2 + delta * delta * (na * nb / nt);
    }
  }
  const float r = rsqrtf(m2 / (float)dim + eps);

  for (int base = 0; base < dim; base += kChunk) {
    const int n = min(kChunk, dim - base);
    if (dim > kChunk) load_chunk<Tin, VEC, NV>(xr + base, n, lane, v);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (lane + 32 * i) * VEC;
      if (c < n) {
        float g[VEC], b[VEC], o[VEC];
        load_vec<float, VEC>(gamma + base + c, g);
        load_vec<float, VEC>(beta + base + c, b);
#pragma unroll
        for (int k = 0; k < VEC; ++k) o[k] = g[k] * (r * (v[i][k] - mean)) + b[k];
        store_vec<Tout, VEC>(yr + base + c, o);
      }
    }
  }
}

// One warp a row; the output's type is one uniform branch, outside the row.
template <typename Tin, int VEC, int NV>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    layer_norm_kernel(const Tin* __restrict__ x, int64_t row_stride,
                      void* __restrict__ y, int y_dtype,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, int64_t rows, int dim,
                      float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const Tin* xr = x + row * row_stride;
  const int64_t yo = row * (int64_t)dim;
  switch (y_dtype) {
    case kF32:
      norm_row<Tin, float, VEC, NV>(xr, static_cast<float*>(y) + yo, gamma,
                                    beta, dim, eps, lane);
      break;
    case kBF16:
      norm_row<Tin, __nv_bfloat16, VEC, NV>(
          xr, static_cast<__nv_bfloat16*>(y) + yo, gamma, beta, dim, eps,
          lane);
      break;
    case kF16:
      norm_row<Tin, __half, VEC, NV>(xr, static_cast<__half*>(y) + yo, gamma,
                                     beta, dim, eps, lane);
      break;
    default:
      norm_row<Tin, double, VEC, NV>(xr, static_cast<double*>(y) + yo, gamma,
                                     beta, dim, eps, lane);
  }
}

template <typename Tin, int VEC, int NV>
void launch_nv(const void* x, int64_t rs, void* y, int yt, const float* g,
               const float* b, int64_t rows, int dim, float eps,
               cudaStream_t s) {
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_kernel<Tin, VEC, NV><<<(unsigned)blocks, kRowsPerBlock * 32, 0,
                                    s>>>(static_cast<const Tin*>(x), rs, y,
                                         yt, g, b, rows, dim, eps);
}

template <typename Tin>
void launch(const void* x, int64_t rs, void* y, int yt, const float* g,
            const float* b, int64_t rows, int dim, float eps, cudaStream_t s) {
  const bool vec4 = dim % 4 == 0 && rs % 4 == 0 &&
                    aligned(x, 4 * sizeof(Tin)) &&
                    aligned(y, 4 * dtype_bytes(yt)) && aligned(g, 16) &&
                    aligned(b, 16);
  const int need = (dim + 127) / 128;  // vectors of 4 a lane
  if (!vec4) launch_nv<Tin, 1, 16>(x, rs, y, yt, g, b, rows, dim, eps, s);
  else if (need <= 3) launch_nv<Tin, 4, 3>(x, rs, y, yt, g, b, rows, dim, eps, s);
  else if (need <= 4) launch_nv<Tin, 4, 4>(x, rs, y, yt, g, b, rows, dim, eps, s);
  else if (need <= 9) launch_nv<Tin, 4, 9>(x, rs, y, yt, g, b, rows, dim, eps, s);
  else launch_nv<Tin, 4, 16>(x, rs, y, yt, g, b, rows, dim, eps, s);
}

}  // namespace

// x: rows of dim elements, row_stride elements apart, the last dimension
// contiguous; y: (rows, dim) contiguous; gamma, beta: dim float32. dtypes:
// 0 float32, 1 bfloat16, 2 float16, 3 float64 (vec_io.cuh). Any width, any
// stride, any alignment of the elements' own size; the kernel takes 4-element
// vectors where all of them allow it. Returns the cudaError_t of the launch.
VPF_KERNEL_API int vpf_layer_norm(const void* x, int x_dtype,
                                  int64_t row_stride, void* y, int y_dtype,
                                  const float* gamma, const float* beta,
                                  int64_t rows, int dim, float eps,
                                  void* stream) {
  if (rows <= 0 || dim <= 0 || !valid_dtype(x_dtype) ||
      !valid_dtype(y_dtype) ||
      (rows + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (!aligned(x, dtype_bytes(x_dtype)) || !aligned(y, dtype_bytes(y_dtype)) ||
      !aligned(gamma, 4) || !aligned(beta, 4))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      launch<float>(x, row_stride, y, y_dtype, gamma, beta, rows, dim, eps, s);
      break;
    case kBF16:
      launch<__nv_bfloat16>(x, row_stride, y, y_dtype, gamma, beta, rows, dim,
                            eps, s);
      break;
    case kF16:
      launch<__half>(x, row_stride, y, y_dtype, gamma, beta, rows, dim, eps, s);
      break;
    default:
      launch<double>(x, row_stride, y, y_dtype, gamma, beta, rows, dim, eps,
                     s);
  }
  return (int)cudaGetLastError();
}
