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
// The resize matrices have a contiguous support of at most 6 source pixels
// per output row and column (4 on the half-grid chroma), so the wrapper
// hands compact tap tables: a start index and K float32 weights per output
// row / column, taken from the dense matrix; chroma tables come from the
// half-grid collapsed matrix, so 4:2:0 chroma is read at its native
// resolution. Each plane is a float32 separable sum (columns inside rows),
// then the offsets are subtracted, the 3x3 CSC applied, and the store
// rounds half-to-even (rintf) and clamps, or scales to [0,1] and normalizes.
//
// Two entry points compute the same function, value for value:
//
// * vpf_fused_resize_csc (the path's kernel): one block per (frame, band of
//   output rows, tile of output columns), planned by the wrapper
//   (ops/fused_cuda.py:band_plan). What held the first version was not
//   DRAM but load instructions: one thread per output pixel made about
//   150 one-byte loads (every source sample and every column weight), the
//   horizontal sum of a source row was computed again by every output row
//   whose window held it, and NV12's U and V were two strided walks over
//   one interleaved row. Here each source row a band needs is copied once
//   into shared memory, and every tap loop runs on chip:
//   - producer warps copy the band's rows in chunks with the widest
//     cp.async the planes' alignment allows (16, 8 or 4 bytes; plain loads
//     below that) into a ring of buffers, a full and an empty mbarrier per
//     slot, so copies run ahead of the sums and no block-wide barrier
//     stalls either side;
//   - consumer threads, one per output column with its column taps in
//     registers, take each staged row's window in three 4-byte shared
//     loads, turn its bytes into floats exactly (byte permute into
//     2^23 + byte, less 2^23), and write H[row][column] (float32, shared)
//     once per staged row;
//   - then the vertical pass, CSC and store run from shared memory, stores
//     coalesced along the columns.
//   Each H value is the very sum the first version computes for that
//   (source row, column), and the vertical sum keeps its order, so the two
//   entry points agree exactly. What holds it now is instruction
//   throughput: on the card the sums alone take longer than the copies
//   alone, and blocks overlap the two only in part (PERF.md).
// * vpf_fused_resize_csc_direct: the first version (one thread per output
//   pixel, every tap read through the cache), kept as the same-call
//   baseline that chip_smoke.py times the band kernel against.
//
// Plain C interface, loaded with ctypes (videoprocessingframework_torch/
// csrc/build.py). The caller launches on its current stream and checks the
// returned cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#define VPF_KERNEL_API extern "C" __attribute__((visibility("default")))

namespace {

constexpr int KY_MAX = 6;  // luma taps (rows, columns) the band kernel holds
constexpr int KC_MAX = 4;  // chroma taps (half-grid collapsed)
constexpr int MAX_THREADS = 512;
// Ring depth and producer warps of the band kernel (ops/fused_cuda.py:
// STAGES, PRODUCERS; its plan lays shared memory out for these).
constexpr int STAGES = 2;
constexpr int PRODUCERS = 2;

struct Taps {
  const int32_t* start;  // (n_out,) first source index of the window
  const float* w;        // (n_out, k) weights, row-major
  int k;
};

struct Args {
  const uint8_t* y;
  const uint8_t* u;     // NV12: the interleaved UV plane
  const uint8_t* v;     // NV12: u + 1
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

// The band plan's scalars, in the order of ops/fused_cuda.py:PLAN_FIELDS.
enum PlanField {
  P_ROWS, P_COLS, P_N_BANDS, P_N_TILES, P_CHUNK, P_VEC_Y, P_VEC_C,
  P_PITCH_Y, P_PITCH_C, P_STAGE_BYTES, P_BAND_STRIDE, P_MAX_ROWS_Y,
  P_OFF_HY, P_OFF_HU, P_OFF_HV, P_OFF_TAB, P_TAB_WORDS, P_OFF_ROWS,
  P_OFF_BAR, P_SMEM, P_THREADS, P_COUNT
};

struct Band {
  const int32_t* band_rows;  // (n_bands, band_stride): n_y, n_c, luma rows
                             // (max_rows_y), chroma rows
  const int32_t* band_tab;   // (n_bands, tab_words): row weights (rows x 8
                             // luma, rows x 4 chroma, float bits), then the
                             // H row of each output row's luma / chroma
                             // window (rows each)
  const int32_t* tile_cols;  // (n_tiles, 4): staged bytes lo, count; luma
                             // then chroma (NV12: interleaved UV bytes)
  int rows, cols;            // output rows per band, columns per tile
  int chunk;                 // source rows per staged chunk
  int vec_y, vec_c;          // copy width (bytes)
  int pitch_y, pitch_c;      // shared bytes per staged row (its span + 16)
  int stage_bytes, band_stride, max_rows_y, tab_words;
  int off_hy, off_hu, off_hv, off_tab, off_rows, off_bar;  // shared bytes
};

// ---- shared by both entry points ---------------------------------------------

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

// Offsets, 3x3 CSC and store of one output pixel from its resampled planes.
template <int MODE>
__device__ __forceinline__ void csc_store(const Args& a, int64_t base,
                                          int64_t plane, float ys, float us,
                                          float vs) {
  const float yv = ys - a.off[0];
  const float uv = us - a.off[1];
  const float vv = vs - a.off[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float val = a.m[3 * i] * yv + a.m[3 * i + 1] * uv + a.m[3 * i + 2] * vv;
    store<MODE>(a.out, base + i * plane, val, a.mean[i], a.inv_std[i]);
  }
}

// ---- direct entry point (first version, the baseline) ------------------------

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

template <int STEP, int MODE>
__global__ void __launch_bounds__(256)
fused_resize_csc_kernel(const Args a) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  const int64_t b = blockIdx.z;
  if (ox >= a.out_w || oy >= a.out_h) return;

  const float ys = resample<1>(a.y + b * a.y_bs, a.y_rs, a.ry, a.cy, oy, ox);
  const float us =
      resample<STEP>(a.u + b * a.c_bs, a.c_rs, a.rc, a.cc, oy, ox);
  const float vs =
      resample<STEP>(a.v + b * a.c_bs, a.c_rs, a.rc, a.cc, oy, ox);

  const int64_t plane = (int64_t)a.out_h * a.out_w;
  csc_store<MODE>(a, b * 3 * plane + (int64_t)oy * a.out_w + ox, plane, ys,
                  us, vs);
}

template <int STEP, int MODE>
void launch_direct(const Args& a, int batch, cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid((a.out_w + 31) / 32, (a.out_h + 7) / 8, batch);
  fused_resize_csc_kernel<STEP, MODE><<<grid, block, 0, s>>>(a);
}

// ---- band entry point ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int VEC>
__device__ __forceinline__ void copy_vec(uint8_t* dst, const uint8_t* src) {
  if (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  } else if (VEC == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  } else if (VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  } else if (VEC == 2) {  // below cp.async's 4 bytes: a plain load and store
    *reinterpret_cast<uint16_t*>(dst) =
        __ldg(reinterpret_cast<const unsigned short*>(src));
  } else {
    *dst = __ldg(src);
  }
}

// mbarriers in shared memory: the ring's "full" and "empty" signals
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// Arrive once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Copy `nbytes` (a multiple of VEC) of each of `nr` source rows listed in
// shared memory, from `src` on, into rows `pitch` bytes apart: one warp a
// row, its lanes on neighbouring vectors.
template <int VEC>
__device__ __forceinline__ void stage_rows_vec(uint8_t* dst, int pitch,
                                               const uint8_t* src, int64_t rs,
                                               const int32_t* rows, int nr,
                                               int nbytes, int warp, int nw,
                                               int lane) {
#pragma unroll 1
  for (int r = warp; r < nr; r += nw) {
    const uint8_t* s = src + (int64_t)rows[r] * rs;
    uint8_t* d = dst + r * pitch;
#pragma unroll 1
    for (int q = lane * VEC; q < nbytes; q += 32 * VEC)
      copy_vec<VEC>(d + q, s + q);
  }
}

// The producer warps copy rows warp, warp + nw, ... of a chunk.
__device__ __forceinline__ void stage_rows(uint8_t* dst, int pitch,
                                           const uint8_t* src, int64_t rs,
                                           const int32_t* rows, int nr,
                                           int nbytes, int vec, int warp,
                                           int nw, int lane) {
  switch (vec) {
    case 16:
      stage_rows_vec<16>(dst, pitch, src, rs, rows, nr, nbytes, warp, nw,
                         lane);
      break;
    case 8:
      stage_rows_vec<8>(dst, pitch, src, rs, rows, nr, nbytes, warp, nw,
                        lane);
      break;
    case 4:
      stage_rows_vec<4>(dst, pitch, src, rs, rows, nr, nbytes, warp, nw,
                        lane);
      break;
    case 2:
      stage_rows_vec<2>(dst, pitch, src, rs, rows, nr, nbytes, warp, nw,
                        lane);
      break;
    default:
      stage_rows_vec<1>(dst, pitch, src, rs, rows, nr, nbytes, warp, nw,
                        lane);
      break;
  }
}

// Bytes [off, off + 8) of a staged row as two words (byte 0 lowest), from
// three 4-byte shared loads at the 4-byte boundary below `off`. A window
// ends inside the row's staged span, so these loads end at most 11 bytes
// past it; the plan pads every staged row's pitch by 16 bytes, which no
// thread writes, so the loads never leave the row.
__device__ __forceinline__ void window8(const uint8_t* row, int off,
                                        uint32_t& w0, uint32_t& w1) {
  const uint32_t* q = reinterpret_cast<const uint32_t*>(row + (off & ~3));
  const uint32_t x = q[0], y = q[1], z = q[2];
  const int sh = (off & 3) * 8;
  w0 = __funnelshift_r(x, y, sh);
  w1 = __funnelshift_r(y, z, sh);
}

// Byte k of w as an exact float: 2^23 + byte, built by a byte permute, less
// 2^23.
__device__ __forceinline__ float byte_f(uint32_t w, int k) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + k)) -
         8388608.f;
}

// One block per (frame, band of output rows, tile of output columns). Its
// last PRODUCERS warps copy: the band's table, then the band's luma rows
// and then its chroma rows in chunks, into a ring of STAGES shared-memory
// buffers, as fast as the consumers free them. The other warps consume:
// each chunk's horizontal pass as it lands, then the vertical pass. A full
// and an empty mbarrier per ring slot order the two sides; no block-wide
// barrier stops either. (At most 64 registers a thread, so that the five
// 192-thread blocks the plan sizes shared memory for also fit an SM's
// registers.)
template <int STEP, int MODE>
__global__ void __launch_bounds__(MAX_THREADS, 2)
fused_resize_csc_band_kernel(const Args a, const Band p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nct = blockDim.x - 32 * PRODUCERS;  // consumer threads
  const int ox0 = blockIdx.x * p.cols;
  const int oy0 = blockIdx.y * p.rows;
  const int64_t b = blockIdx.z;
  const int ncols = min(p.cols, a.out_w - ox0);
  const int nrows = min(p.rows, a.out_h - oy0);
  const int chunk = p.chunk;

  const int32_t* br = p.band_rows + (int64_t)blockIdx.y * p.band_stride;
  const int ny = __ldg(br), nc = __ldg(br + 1);
  const int4 tc = __ldg(reinterpret_cast<const int4*>(p.tile_cols) +
                        blockIdx.x);  // luma lo, bytes; chroma lo, bytes
  const int ncy = (ny + chunk - 1) / chunk;
  const int n = ncy + (nc + chunk - 1) / chunk;
  float* hy = reinterpret_cast<float*>(smem + p.off_hy);
  float* hu = reinterpret_cast<float*>(smem + p.off_hu);
  float* hv = reinterpret_cast<float*>(smem + p.off_hv);
  float* twy = reinterpret_cast<float*>(smem + p.off_tab);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.off_bar);
  uint64_t* empty = full + STAGES;
  uint64_t* tab_ready = empty + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32 * PRODUCERS);
      mbar_init(&empty[s], nct);
    }
    mbar_init(tab_ready, 32);
  }
  __syncthreads();

  if (threadIdx.x >= nct) {  // the producer warps
    const int pt = threadIdx.x - nct, lane = pt & 31, warp = pt >> 5;
    const int nw = PRODUCERS;
    // the band's table (row weights, window positions; the first producer
    // warp), and its source row list, which the copies read row by row
    if (warp == 0) {
      const int4* tab = reinterpret_cast<const int4*>(
          p.band_tab + (int64_t)blockIdx.y * p.tab_words);
      for (int q = lane; q < p.tab_words / 4; q += 32)
        reinterpret_cast<int4*>(twy)[q] = __ldg(tab + q);
      mbar_arrive(tab_ready);
    }
    int32_t* rows_y = reinterpret_cast<int32_t*>(smem + p.off_rows);
    for (int q = pt; q < p.band_stride - 2; q += 32 * nw)
      rows_y[q] = __ldg(br + 2 + q);
    asm volatile("bar.sync 2, %0;\n" ::"r"(32 * nw) : "memory");
    const int32_t* rows_c = rows_y + p.max_rows_y;
    const uint8_t* ysrc = a.y + b * a.y_bs + tc.x;
    const int64_t coff = b * a.c_bs + tc.z;
    for (int c = 0; c < n; ++c) {
      const int slot = c % STAGES;
      if (c >= STAGES)  // the slot's last chunk has been resampled
        mbar_wait(&empty[slot], (c / STAGES - 1) & 1);
      uint8_t* buf = smem + slot * p.stage_bytes;
      int vec;
      if (c < ncy) {  // luma rows first, then chroma (planar: U, V blocks)
        const int r0 = c * chunk;
        vec = p.vec_y;
        stage_rows(buf, p.pitch_y, ysrc, a.y_rs, rows_y + r0,
                   min(chunk, ny - r0), tc.y, vec, warp, nw, lane);
      } else {
        const int r0 = (c - ncy) * chunk;
        const int nr = min(chunk, nc - r0);
        vec = p.vec_c;
        stage_rows(buf, p.pitch_c, a.u + coff, a.c_rs, rows_c + r0, nr,
                   tc.w, vec, warp, nw, lane);
        if (STEP == 1)
          stage_rows(buf + chunk * p.pitch_c, p.pitch_c, a.v + coff,
                     a.c_rs, rows_c + r0, nr, tc.w, vec, warp, nw, lane);
      }
      // cp.async copies signal as they land; plain stores (below 4-byte
      // alignment) are done, and the arrive releases them
      if (vec >= 4) mbar_arrive_copies(&full[slot]);
      else mbar_arrive(&full[slot]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumers: thread col takes output column col; its column taps sit in
  // registers
  const int col = threadIdx.x;
  const int ky = a.ry.k, kc = a.rc.k;
  const int kcy = a.cy.k, kcc = a.cc.k;
  float cwy[KY_MAX], cwc[KC_MAX];
  int sy = 0, sc = 0;  // the window's first byte in the staged rows
  if (col < ncols) {
    const int ox = ox0 + col;
    sy = __ldg(a.cy.start + ox) - tc.x;
    sc = __ldg(a.cc.start + ox) * STEP - tc.z;
#pragma unroll
    for (int j = 0; j < KY_MAX; ++j)
      cwy[j] = j < kcy ? __ldg(a.cy.w + (int64_t)ox * kcy + j) : 0.f;
#pragma unroll
    for (int j = 0; j < KC_MAX; ++j)
      cwc[j] = j < kcc ? __ldg(a.cc.w + (int64_t)ox * kcc + j) : 0.f;
  }

  for (int i = 0; i < n; ++i) {
    const int slot = i % STAGES;
    mbar_wait(&full[slot], (i / STAGES) & 1);
    const uint8_t* buf = smem + slot * p.stage_bytes;
    // horizontal pass, H[row][column]: each window's bytes come from three
    // 4-byte shared loads (byte loads cost a shared-memory wavefront each)
    if (col < ncols && i < ncy) {
      const int r0 = i * chunk;
      const int nr = min(chunk, ny - r0);
      for (int rr = 0; rr < nr; ++rr) {
        uint32_t w0, w1;
        window8(buf + rr * p.pitch_y, sy, w0, w1);
        float h = 0.f;
#pragma unroll
        for (int j = 0; j < KY_MAX; ++j)
          if (j < kcy) h = fmaf(cwy[j], byte_f(j < 4 ? w0 : w1, j & 3), h);
        hy[(r0 + rr) * p.cols + col] = h;
      }
    } else if (col < ncols) {
      const int r0 = (i - ncy) * chunk;
      const int nr = min(chunk, nc - r0);
      for (int rr = 0; rr < nr; ++rr) {
        const uint8_t* row = buf + rr * p.pitch_c;
        uint32_t u0, u1, v0, v1;
        window8(row, sc, u0, u1);
        if (STEP == 1)  // planar: the V rows sit a block after the U rows
          window8(row + chunk * p.pitch_c, sc, v0, v1);
        float hu_ = 0.f, hv_ = 0.f;
#pragma unroll
        for (int j = 0; j < KC_MAX; ++j) {
          if (j < kcc) {
            if (STEP == 1) {
              hu_ = fmaf(cwc[j], byte_f(u0, j), hu_);
              hv_ = fmaf(cwc[j], byte_f(v0, j), hv_);
            } else {  // NV12: U, V, U, V, ... from byte 0
              const uint32_t w = j < 2 ? u0 : u1;
              hu_ = fmaf(cwc[j], byte_f(w, (j & 1) * 2), hu_);
              hv_ = fmaf(cwc[j], byte_f(w, (j & 1) * 2 + 1), hv_);
            }
          }
        }
        hu[(r0 + rr) * p.cols + col] = hu_;
        hv[(r0 + rr) * p.cols + col] = hv_;
      }
    }
    mbar_arrive(&empty[slot]);
  }
  mbar_wait(tab_ready, 0);
  asm volatile("bar.sync 1, %0;\n" ::"r"(nct) : "memory");  // H complete

  if (col >= ncols) return;
  // vertical pass, CSC and store of this column's output rows. The direct
  // kernel skips a zero row weight; fmaf(0, h, s) is s itself
  // here (s starts at +0 and stays finite), so the sums agree exactly.
  const float* twc = twy + p.rows * 8;
  const int* pos = reinterpret_cast<const int*>(twc + p.rows * 4);
  const int ox = ox0 + col;
  const int64_t plane = (int64_t)a.out_h * a.out_w;
  for (int t = 0; t < nrows; ++t) {
    const float4 wy0 = *reinterpret_cast<const float4*>(twy + t * 8);
    const float4 wy1 = *reinterpret_cast<const float4*>(twy + t * 8 + 4);
    const float4 wc4 = *reinterpret_cast<const float4*>(twc + t * 4);
    const float wy[8] = {wy0.x, wy0.y, wy0.z, wy0.w,
                         wy1.x, wy1.y, wy1.z, wy1.w};
    const float wc[4] = {wc4.x, wc4.y, wc4.z, wc4.w};
    const float* col_y = hy + pos[t] * p.cols + col;
    const int pcy = pos[p.rows + t] * p.cols + col;
    float ys = 0.f, us = 0.f, vs = 0.f;
#pragma unroll
    for (int i = 0; i < KY_MAX; ++i)
      if (i < ky) ys = fmaf(wy[i], col_y[i * p.cols], ys);
#pragma unroll
    for (int i = 0; i < KC_MAX; ++i) {
      if (i < kc) {
        us = fmaf(wc[i], hu[pcy + i * p.cols], us);
        vs = fmaf(wc[i], hv[pcy + i * p.cols], vs);
      }
    }
    csc_store<MODE>(a, b * 3 * plane + (int64_t)(oy0 + t) * a.out_w + ox,
                    plane, ys, us, vs);
  }
}

template <int STEP, int MODE>
cudaError_t launch_band(const Args& a, const Band& p, const int32_t* plan,
                        int batch, cudaStream_t s) {
  auto kern = fused_resize_csc_band_kernel<STEP, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, plan[P_SMEM]);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch is refused, not run
    return e;
  }
  const dim3 grid(plan[P_N_TILES], plan[P_N_BANDS], batch);
  kern<<<grid, plan[P_THREADS], plan[P_SMEM], s>>>(a, p);
  return cudaGetLastError();
}

bool make_args(Args& a, const uint8_t* y, const uint8_t* u, const uint8_t* v,
               int chroma_step, int batch, int64_t y_bs, int64_t y_rs,
               int64_t c_bs, int64_t c_rs, const int32_t* rs_y,
               const float* rw_y, int kr_y, const int32_t* rs_c,
               const float* rw_c, int kr_c, const int32_t* cs_y,
               const float* cw_y, int kc_y, const int32_t* cs_c,
               const float* cw_c, int kc_c, void* out, int out_h, int out_w,
               int mode, const float* csc) {
  if (batch <= 0 || batch > 65535 || out_h <= 0 || out_w <= 0 ||
      (chroma_step != 1 && chroma_step != 2) || mode < 0 || mode > 2)
    return false;
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
  return true;
}

bool valid_vec(int v) { return v == 1 || v == 2 || v == 4 || v == 8 || v == 16; }

}  // namespace

#define VPF_FUSED_PARAMS                                                      \
  const uint8_t *y, const uint8_t *u, const uint8_t *v, int chroma_step,      \
      int batch, int64_t y_bs, int64_t y_rs, int64_t c_bs, int64_t c_rs,      \
      const int32_t *rs_y, const float *rw_y, int kr_y, const int32_t *rs_c,  \
      const float *rw_c, int kr_c, const int32_t *cs_y, const float *cw_y,    \
      int kc_y, const int32_t *cs_c, const float *cw_c, int kc_c, void *out,  \
      int out_h, int out_w, int mode, const float *csc
#define VPF_FUSED_ARGS                                                        \
  y, u, v, chroma_step, batch, y_bs, y_rs, c_bs, c_rs, rs_y, rw_y, kr_y,      \
      rs_c, rw_c, kr_c, cs_y, cw_y, kc_y, cs_c, cw_c, kc_c, out, out_h,       \
      out_w, mode, csc

// The band kernel. `plan` holds P_COUNT host ints (ops/fused_cuda.py:
// PLAN_FIELDS); band_rows, band_tab and tile_cols are device arrays of the
// same plan. Returns the cudaError_t of the launch (0 on success).
VPF_KERNEL_API int vpf_fused_resize_csc(VPF_FUSED_PARAMS, const int32_t* plan,
                                        const int32_t* band_rows,
                                        const int32_t* band_tab,
                                        const int32_t* tile_cols,
                                        void* stream) {
  Args a;
  if (!make_args(a, VPF_FUSED_ARGS) || kr_y > KY_MAX || kc_y > KY_MAX ||
      kr_c > KC_MAX || kc_c > KC_MAX || plan[P_ROWS] <= 0 ||
      plan[P_COLS] <= 0 || plan[P_THREADS] % 32 != 0 ||
      plan[P_THREADS] - 32 * PRODUCERS < plan[P_COLS] ||
      plan[P_OFF_BAR] % 8 != 0 ||
      plan[P_THREADS] > MAX_THREADS || plan[P_CHUNK] <= 0 ||
      !valid_vec(plan[P_VEC_Y]) ||
      !valid_vec(plan[P_VEC_C]) || plan[P_TAB_WORDS] % 4 != 0 ||
      plan[P_N_BANDS] > 65535 || plan[P_N_BANDS] * plan[P_ROWS] < out_h ||
      plan[P_N_TILES] * plan[P_COLS] < out_w)
    return (int)cudaErrorInvalidValue;
  Band p;
  p.band_rows = band_rows;
  p.band_tab = band_tab;
  p.tile_cols = tile_cols;
  p.rows = plan[P_ROWS];
  p.cols = plan[P_COLS];
  p.chunk = plan[P_CHUNK];
  p.vec_y = plan[P_VEC_Y];
  p.vec_c = plan[P_VEC_C];
  p.pitch_y = plan[P_PITCH_Y];
  p.pitch_c = plan[P_PITCH_C];
  p.stage_bytes = plan[P_STAGE_BYTES];
  p.band_stride = plan[P_BAND_STRIDE];
  p.max_rows_y = plan[P_MAX_ROWS_Y];
  p.tab_words = plan[P_TAB_WORDS];
  p.off_hy = plan[P_OFF_HY];
  p.off_hu = plan[P_OFF_HU];
  p.off_hv = plan[P_OFF_HV];
  p.off_tab = plan[P_OFF_TAB];
  p.off_rows = plan[P_OFF_ROWS];
  p.off_bar = plan[P_OFF_BAR];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (chroma_step == 1) {
    if (mode == 0) e = launch_band<1, 0>(a, p, plan, batch, s);
    else if (mode == 1) e = launch_band<1, 1>(a, p, plan, batch, s);
    else e = launch_band<1, 2>(a, p, plan, batch, s);
  } else {
    if (mode == 0) e = launch_band<2, 0>(a, p, plan, batch, s);
    else if (mode == 1) e = launch_band<2, 1>(a, p, plan, batch, s);
    else e = launch_band<2, 2>(a, p, plan, batch, s);
  }
  return (int)e;
}

// The first version, kept as the baseline. Returns the cudaError_t of the
// launch (0 on success).
VPF_KERNEL_API int vpf_fused_resize_csc_direct(VPF_FUSED_PARAMS, void* stream) {
  Args a;
  if (!make_args(a, VPF_FUSED_ARGS)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chroma_step == 1) {
    if (mode == 0) launch_direct<1, 0>(a, batch, s);
    else if (mode == 1) launch_direct<1, 1>(a, batch, s);
    else launch_direct<1, 2>(a, batch, s);
  } else {
    if (mode == 0) launch_direct<2, 0>(a, batch, s);
    else if (mode == 1) launch_direct<2, 1>(a, batch, s);
    else launch_direct<2, 2>(a, batch, s);
  }
  return (int)cudaGetLastError();
}

VPF_KERNEL_API const char* vpf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
