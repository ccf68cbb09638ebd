// Fused Engram gated fusion for Hopper (sm_90a):
//     out = h + sigmoid(h @ Wg) * (e @ Wp)
// h (T, d), e (T, F), Wg (d, d), Wp (F, d), out (T, d), all row-major, in
// bf16 or float32. Both products accumulate in f32 registers and the
// epilogue runs in f32; out is written once, in h's type.
//
// Replaces the TPU kernel src/repro/kernels/gated_fuse/gated_fuse.py,
// function gated_fuse (body _fuse_kernel), which keeps the full contraction
// depth of a (BT, BD) tile in VMEM. Shared memory on Hopper is far smaller,
// so here each block owns a (BT, BD) = (32, 64) output tile and walks K in
// (BK = 64) slabs through shared memory, first over d for h·Wg, then over F
// for e·Wp, keeping two f32 accumulators per output in registers (a 16 x 16
// thread grid, 2 x 4 outputs per thread) and applying the sigmoid-multiply-
// add epilogue before the one store. Ragged edges (T, and any d or F that
// is not a tile multiple) are masked in the kernel: loads outside the
// matrices read zeros and stores outside are skipped.
//
// What bounds it on the H100: bytes. At decode T is the live batch (8 or
// fewer) and the kernel must stream Wg + Wp once: 78.6 MB in bf16 at
// engram-27b's d = 5120, F = 2560, about 23 us at 3.35 TB/s, against
// 0.63 GFLOP that the tensor cores would finish in under 1 us. This first
// version is the simple form: 16-byte vector loads where the pointers and
// widths allow (scalar loads otherwise), CUDA-core FMAs and no cp.async,
// TMA or wgmma pipelining, so it reaches only a fraction of the memory
// rate; chip_smoke.py records its time beside the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 32;        // output rows per block
constexpr int BD = 64;        // output columns per block
constexpr int BK = 64;        // contraction slab
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int TM = 2;         // rows per thread
constexpr int TN = 4;         // columns per thread, strided by 16
constexpr int LDA = BK + 4;   // padded A row: rows ty*TM + i fall in
                              // distinct banks, rows stay 16-byte aligned

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Stage the (ROWS, COLS) tile at (r0, c0) of a row-major (n_rows, n_cols)
// matrix with leading dimension ld into shared memory as f32, zero-filled
// outside the matrix. VEC: 16-byte loads; the caller guarantees 16-byte
// aligned rows and n_cols a multiple of the vector width, so a vector is
// either wholly inside or wholly outside. LDS is the shared row length.
template <typename T, bool VEC, int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_tile(float (*dst)[LDS],
                                          const T* __restrict__ src,
                                          int64_t ld, int n_rows, int n_cols,
                                          int r0, int c0) {
  if constexpr (VEC) {
    constexpr int VE = 16 / sizeof(T);
    constexpr int PER_ROW = COLS / VE;
    for (int v = threadIdx.x; v < ROWS * PER_ROW; v += THREADS) {
      const int r = v / PER_ROW, c = (v % PER_ROW) * VE;
      const int gr = r0 + r, gc = c0 + c;
      float vals[VE];
      if (gr < n_rows && gc < n_cols) {
        const uint4 raw =
            __ldg(reinterpret_cast<const uint4*>(src + gr * ld + gc));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < VE; ++i) vals[i] = to_f32(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < VE; ++i) vals[i] = 0.f;
      }
      float4* d4 = reinterpret_cast<float4*>(&dst[r][c]);
#pragma unroll
      for (int q = 0; q < VE / 4; ++q)
        d4[q] = make_float4(vals[4 * q], vals[4 * q + 1], vals[4 * q + 2],
                            vals[4 * q + 3]);
    }
  } else {
    for (int v = threadIdx.x; v < ROWS * COLS; v += THREADS) {
      const int r = v / COLS, c = v % COLS;
      const int gr = r0 + r, gc = c0 + c;
      dst[r][c] = (gr < n_rows && gc < n_cols) ? to_f32(src[gr * ld + gc])
                                               : 0.f;
    }
  }
}

// acc[i][j] += sum_k As[ty*TM + i][k] * Bs[k][tx + 16*j]
__device__ __forceinline__ void slab_product(float (*As)[LDA], float (*Bs)[BD],
                                             int ty, int tx,
                                             float (*acc)[TN]) {
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[ty * TM + i][k];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
gated_fuse_kernel(const T* __restrict__ h, const T* __restrict__ e,
                  const T* __restrict__ wg, const T* __restrict__ wp,
                  T* __restrict__ out, int n_t, int d, int F) {
  __shared__ __align__(16) float As[BT][LDA];
  __shared__ __align__(16) float Bs[BK][BD];
  const int row0 = blockIdx.y * BT;
  const int col0 = blockIdx.x * BD;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float g[TM][TN] = {};
  float p[TM][TN] = {};

  for (int k0 = 0; k0 < d; k0 += BK) {          // g = h · Wg
    load_tile<T, VEC, BT, BK, LDA>(As, h, d, n_t, d, row0, k0);
    load_tile<T, VEC, BK, BD, BD>(Bs, wg, d, d, d, k0, col0);
    __syncthreads();
    slab_product(As, Bs, ty, tx, g);
    __syncthreads();
  }
  for (int k0 = 0; k0 < F; k0 += BK) {          // p = e · Wp
    load_tile<T, VEC, BT, BK, LDA>(As, e, F, n_t, F, row0, k0);
    load_tile<T, VEC, BK, BD, BD>(Bs, wp, d, F, d, k0, col0);
    __syncthreads();
    slab_product(As, Bs, ty, tx, p);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= n_t) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= d) continue;
      const int64_t at = (int64_t)r * d + c;
      const float gate = 1.f / (1.f + expf(-g[i][j]));
      out[at] = from_f32<T>(to_f32(h[at]) + gate * p[i][j]);
    }
  }
}

template <typename T>
void launch(const void* h, const void* e, const void* wg, const void* wp,
            void* out, int n_t, int d, int F, cudaStream_t stream) {
  constexpr int VE = 16 / sizeof(T);
  const uint64_t bits = (uint64_t)(uintptr_t)h | (uint64_t)(uintptr_t)e |
                        (uint64_t)(uintptr_t)wg | (uint64_t)(uintptr_t)wp;
  const bool vec = (bits & 15) == 0 && d % VE == 0 && F % VE == 0;
  const dim3 grid((d + BD - 1) / BD, (n_t + BT - 1) / BT);
  const T* ht = static_cast<const T*>(h);
  const T* et = static_cast<const T*>(e);
  const T* gt = static_cast<const T*>(wg);
  const T* pt = static_cast<const T*>(wp);
  T* ot = static_cast<T*>(out);
  if (vec)
    gated_fuse_kernel<T, true><<<grid, THREADS, 0, stream>>>(ht, et, gt, pt,
                                                             ot, n_t, d, F);
  else
    gated_fuse_kernel<T, false><<<grid, THREADS, 0, stream>>>(ht, et, gt, pt,
                                                              ot, n_t, d, F);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int gated_fuse_launch(int dtype, const void* h, const void* e,
                                 const void* wg, const void* wp, void* out,
                                 int64_t n_t, int64_t d, int64_t F,
                                 void* stream) {
  if (n_t <= 0 || d <= 0) return 0;
  if (n_t > (1LL << 30) || d > (1LL << 30) || F > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch<__nv_bfloat16>(h, e, wg, wp, out, (int)n_t, (int)d, (int)F, s);
  else if (dtype == 0)
    launch<float>(h, e, wg, wp, out, (int)n_t, (int)d, (int)F, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
