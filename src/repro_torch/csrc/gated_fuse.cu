// Fused Engram gated fusion for Hopper (sm_90a):
//     out = h + sigmoid(h @ Wg) * (e @ Wp)
// h (T, d), e (T, F), Wg (d, d), Wp (F, d), out (T, d), all row-major, in
// bf16 or float32. Both products accumulate in f32 and the epilogue runs
// in f32; out is written once, in h's type.
//
// Replaces the TPU kernel src/repro/kernels/gated_fuse/gated_fuse.py,
// function gated_fuse (body _fuse_kernel), which keeps the full contraction
// depth of a (BT, BD) tile in VMEM and walks the grid in order on one core.
//
// What bounds it on the H100: bytes at decode, operations at prefill. At
// decode T is the live batch (8 or fewer) and the kernel must stream
// Wg + Wp once: 78.6 MB in bf16 at engram-27b's d = 5120, F = 2560, about
// 23 us at 3.35 TB/s, against 0.63 GFLOP. At an 8 x 32 prefill (T = 256)
// the same bytes carry 20 GFLOP, 236 FLOP per byte, near the card's ridge.
//
// bf16 (the serving path) runs on the tensor cores, designed for that:
//  - Operands swapped so T is the MMA's N dimension: a block computes a
//    (BM = 64 columns) x (BN tokens) tile of out^T as Wg[:, cols]^T h^T and
//    Wp[:, cols]^T e^T with mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//    The weight slab is the A operand, read transposed from shared memory
//    by ldmatrix.trans; h / e are B, N = 8 at decode (T padded to 8 in
//    shared memory only) and up to 128 at prefill: one kernel, BN chosen
//    from T by the wrapper.
//  - Weights stream through a ring of 4 shared-memory stages filled by
//    cp.async (16-byte, L2-only, zero-fill past the matrix edges), so three
//    slabs per block are in flight while the fourth is multiplied.
//  - The contraction is split when column and token tiles alone would
//    leave SMs idle: d's slabs (for g) and F's slabs (for p) are cut into
//    parts of whole slabs, one part per block along gridDim.z (the wrapper
//    plans the split; at decode 5 parts, 400 blocks for 132 SMs). Each
//    block writes its f32 partial to a workspace; the last block of a tile
//    to arrive (an atomic tile counter, which it resets for the next call)
//    sums the partials in part order (deterministic, no float atomics),
//    applies h + sigmoid(g) * p in f32 and stores once in bf16.
//  - Ragged T, d and F are masked in the kernel; when d or F is not a
//    multiple of 8, or a pointer is not 16-byte aligned, the same pipeline
//    fills its stages with element loads instead of cp.async.
// cp.async and mma.sync, not TMA and wgmma: a bytes-bound decode needs
// loads in flight, not the last 2x of tensor rate, and this form needs no
// tensor maps or descriptors (see PERF.md).
//
// float32 keeps the CUDA-core kernel of the first port (64-row slabs, FMAs):
// the tensor cores have no full-f32 mode, and TF32 would not reproduce the
// CPU's f32 results.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ===================================================== float32: CUDA cores
namespace simt {

constexpr int BT = 32;        // output rows per block
constexpr int BD = 64;        // output columns per block
constexpr int BK = 64;        // contraction slab
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int TM = 2;         // rows per thread
constexpr int TN = 4;         // columns per thread, strided by 16
constexpr int LDA = BK + 4;   // padded A row: rows ty*TM + i fall in
                              // distinct banks, rows stay 16-byte aligned

// Stage the (ROWS, COLS) tile at (r0, c0) of a row-major (n_rows, n_cols)
// float matrix with leading dimension ld into shared memory, zero-filled
// outside the matrix. VEC: 16-byte loads; the caller guarantees 16-byte
// aligned rows and n_cols a multiple of 4, so a vector is either wholly
// inside or wholly outside. LDS is the shared row length.
template <bool VEC, int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_tile(float (*dst)[LDS],
                                          const float* __restrict__ src,
                                          int64_t ld, int n_rows, int n_cols,
                                          int r0, int c0) {
  if constexpr (VEC) {
    constexpr int PER_ROW = COLS / 4;
    for (int v = threadIdx.x; v < ROWS * PER_ROW; v += THREADS) {
      const int r = v / PER_ROW, c = (v % PER_ROW) * 4;
      const int gr = r0 + r, gc = c0 + c;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < n_rows && gc < n_cols)
        val = __ldg(reinterpret_cast<const float4*>(src + gr * ld + gc));
      *reinterpret_cast<float4*>(&dst[r][c]) = val;
    }
  } else {
    for (int v = threadIdx.x; v < ROWS * COLS; v += THREADS) {
      const int r = v / COLS, c = v % COLS;
      const int gr = r0 + r, gc = c0 + c;
      dst[r][c] = (gr < n_rows && gc < n_cols) ? src[gr * ld + gc] : 0.f;
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

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gated_fuse_f32(const float* __restrict__ h, const float* __restrict__ e,
               const float* __restrict__ wg, const float* __restrict__ wp,
               float* __restrict__ out, int n_t, int d, int F) {
  __shared__ __align__(16) float As[BT][LDA];
  __shared__ __align__(16) float Bs[BK][BD];
  const int row0 = blockIdx.y * BT;
  const int col0 = blockIdx.x * BD;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float g[TM][TN] = {};
  float p[TM][TN] = {};

  for (int k0 = 0; k0 < d; k0 += BK) {          // g = h · Wg
    load_tile<VEC, BT, BK, LDA>(As, h, d, n_t, d, row0, k0);
    load_tile<VEC, BK, BD, BD>(Bs, wg, d, d, d, k0, col0);
    __syncthreads();
    slab_product(As, Bs, ty, tx, g);
    __syncthreads();
  }
  for (int k0 = 0; k0 < F; k0 += BK) {          // p = e · Wp
    load_tile<VEC, BT, BK, LDA>(As, e, F, n_t, F, row0, k0);
    load_tile<VEC, BK, BD, BD>(Bs, wp, d, F, d, k0, col0);
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
      out[at] = h[at] + gate * p[i][j];
    }
  }
}

int launch(const float* h, const float* e, const float* wg, const float* wp,
           float* out, int n_t, int d, int F, cudaStream_t stream) {
  const uint64_t bits = (uint64_t)(uintptr_t)h | (uint64_t)(uintptr_t)e |
                        (uint64_t)(uintptr_t)wg | (uint64_t)(uintptr_t)wp;
  const bool vec = (bits & 15) == 0 && d % 4 == 0 && F % 4 == 0;
  const dim3 grid((d + BD - 1) / BD, (n_t + BT - 1) / BT);
  if (vec)
    gated_fuse_f32<true><<<grid, THREADS, 0, stream>>>(h, e, wg, wp, out,
                                                       n_t, d, F);
  else
    gated_fuse_f32<false><<<grid, THREADS, 0, stream>>>(h, e, wg, wp, out,
                                                        n_t, d, F);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ===================================================== bf16: tensor cores
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;        // output columns per block (the MMA's M)
constexpr int BK = 64;        // contraction slab
constexpr int STAGES = 4;     // shared-memory ring depth
constexpr int THREADS = 128;  // four warps
constexpr int LDW = BM + 8;   // shared row of a weight slab: 144 bytes, so
constexpr int LDX = BK + 8;   // ldmatrix's eight 16-byte rows hit distinct
                              // banks (and an activation row likewise)

// The contraction split: g's slabs in parts of q_g (s_g parts), then p's
// slabs in parts of q_p (s_p parts); blockIdx.z is the part.
struct Plan {
  int q_g, s_g, q_p, s_p;
};

template <int BN>
constexpr int smem_bytes() {
  return STAGES * (BK * LDW + BN * LDX) * (int)sizeof(bf16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const bf16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Fill one stage: the (BK, BM) weight slab at (k0, col0) of W (K, d) into
// ws_[BK][LDW], and the (BN, BK) activation slab at (tok0, k0) of X (n_t, K)
// into xs_[BN][LDX]; zeros outside the matrices. VEC: 16-byte cp.async (the
// caller guarantees d and K multiples of 8 and 16-byte aligned bases, so a
// chunk is wholly inside or wholly outside); else element loads.
template <int BN, bool VEC>
__device__ __forceinline__ void load_slab(bf16* ws_, bf16* xs_,
                                          const bf16* __restrict__ W,
                                          const bf16* __restrict__ X, int K,
                                          int d, int n_t, int k0, int col0,
                                          int tok0) {
  if constexpr (VEC) {
#pragma unroll
    for (int v = threadIdx.x; v < BK * (BM / 8); v += THREADS) {
      const int r = v / (BM / 8), c = (v % (BM / 8)) * 8;
      const bool ok = k0 + r < K && col0 + c < d;
      cp_async16(ws_ + r * LDW + c,
                 ok ? W + (int64_t)(k0 + r) * d + col0 + c : W, ok);
    }
    for (int v = threadIdx.x; v < BN * (BK / 8); v += THREADS) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const bool ok = tok0 + r < n_t && k0 + c < K;
      cp_async16(xs_ + r * LDX + c,
                 ok ? X + (int64_t)(tok0 + r) * K + k0 + c : X, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int v = threadIdx.x; v < BK * BM; v += THREADS) {
      const int r = v / BM, c = v % BM;
      ws_[r * LDW + c] = (k0 + r < K && col0 + c < d)
                             ? W[(int64_t)(k0 + r) * d + col0 + c] : zero;
    }
    for (int v = threadIdx.x; v < BN * BK; v += THREADS) {
      const int r = v / BK, c = v % BK;
      xs_[r * LDX + c] = (tok0 + r < n_t && k0 + c < K)
                             ? X[(int64_t)(tok0 + r) * K + k0 + c] : zero;
    }
  }
}

// acc += this warp's (MT*16 columns) x (NT*8 tokens) of the slab product.
// A (16 columns x 16 k) comes from the weight slab, stored [k][column], by
// ldmatrix.trans: matrices (k 0-7 | 8-15) x (columns 0-7 | 8-15) in the
// order a0a1, a2a3 (columns +8), a4a5 (k +8), a6a7. B (16 k x 8 tokens)
// from the activation slab, stored [token][k], by plain ldmatrix.
template <int MT, int NT>
__device__ __forceinline__ void mma_slab(const bf16* ws_, const bf16* xs_,
                                         int m_base, int n_base,
                                         float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4_trans(a[mt], ws_ + (kk + (lane >> 4) * 8 + (lane & 7)) * LDW
                                   + m_base + mt * 16 + ((lane >> 3) & 1) * 8);
    uint32_t b[NT][2];
    if constexpr (NT == 1) {
      ldmatrix_x2(b[0], xs_ + (n_base + (lane & 7)) * LDX + kk
                            + ((lane >> 3) & 1) * 8);
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, xs_ + (n_base + nt * 8 + (lane >> 4) * 8 + (lane & 7))
                                 * LDX + kk + ((lane >> 3) & 1) * 8);
        b[nt][0] = r[0];
        b[nt][1] = r[1];
        b[nt + 1][0] = r[2];
        b[nt + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// Four warps tile the block's 64 x BN output: WM = 4 / MT along columns
// (MT m16 tiles each), MT along tokens (NT n8 tiles each).
template <int BN, int MT, bool VEC>
__global__ void __launch_bounds__(THREADS)
gated_fuse_bf16(const bf16* __restrict__ h, const bf16* __restrict__ e,
                const bf16* __restrict__ wg, const bf16* __restrict__ wp,
                bf16* __restrict__ out, float* __restrict__ ws,
                int* __restrict__ counters, int n_t, int d, int F,
                Plan plan) {
  constexpr int WM = 4 / MT;
  constexpr int NT = BN / (8 * MT);
  static_assert(WM * MT * 16 == BM && MT * NT * 8 == BN, "warp tiling");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int is_last;
  bf16* wsm = reinterpret_cast<bf16*>(smem);          // [STAGES][BK][LDW]
  bf16* xsm = wsm + STAGES * BK * LDW;                 // [STAGES][BN][LDX]

  const int col0 = blockIdx.x * BM, tok0 = blockIdx.y * BN;
  const int part = blockIdx.z;
  const bool is_g = part < plan.s_g;
  const bf16* W = is_g ? wg : wp;
  const bf16* X = is_g ? h : e;
  const int K = is_g ? d : F;
  const int q = is_g ? plan.q_g : plan.q_p;
  const int s0 = (is_g ? part : part - plan.s_g) * q;
  const int n = min(q, (K + BK - 1) / BK - s0);       // slabs in this part
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m_base = (warp % WM) * MT * 16, n_base = (warp / WM) * NT * 8;
  float acc[MT][NT][4] = {};

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n)
      load_slab<BN, VEC>(wsm + s * BK * LDW, xsm + s * BN * LDX, W, X, K, d,
                         n_t, (s0 + s) * BK, col0, tok0);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();     // slab i has landed
    __syncthreads();                 // ... for every thread; slab i-1 done
    const int nxt = i + STAGES - 1;  // refill slab i-1's stage
    if (nxt < n)
      load_slab<BN, VEC>(wsm + (nxt % STAGES) * BK * LDW,
                         xsm + (nxt % STAGES) * BN * LDX, W, X, K, d, n_t,
                         (s0 + nxt) * BK, col0, tok0);
    cp_async_commit();
    mma_slab<MT, NT>(wsm + (i % STAGES) * BK * LDW,
                     xsm + (i % STAGES) * BN * LDX, m_base, n_base, acc);
  }
  cp_async_wait<0>();

  // this part's partial: ws[part][token][column], padded to whole tiles
  const int Tp = gridDim.y * BN, dp = gridDim.x * BM;
  const size_t plane = (size_t)Tp * dp;
  float* mine = ws + part * plane;
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m_base + mt * 16 + g + (r >> 1) * 8;
        const int t = n_base + nt * 8 + q4 * 2 + (r & 1);
        mine[(size_t)(tok0 + t) * dp + col0 + m] = acc[mt][nt][r];
      }
  __threadfence();
  __syncthreads();
  const int S = plan.s_g + plan.s_p;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) {
    is_last = atomicAdd(counters + tile, 1) == S - 1;
    if (is_last) counters[tile] = 0;   // every part has arrived: reset
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The tile's last block: sum the parts in order, then the epilogue.
  // Each thread takes U slots of four columns at a time and issues the U
  // float4 loads of a part together, so a part costs one L2 round trip
  // per U slots, not one per element.
  constexpr int SLOTS = BM * BN / (4 * THREADS);     // float4 slots/thread
  constexpr int U = SLOTS < 4 ? SLOTS : 4;
#pragma unroll
  for (int j0 = 0; j0 < SLOTS; j0 += U) {
    float4 gs[U], ps[U];
    size_t at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int slot = (j0 + u) * THREADS + threadIdx.x;
      at[u] = (size_t)(tok0 + slot / (BM / 4)) * dp + col0 + slot % (BM / 4)
              * 4;
      gs[u] = ps[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 2
    for (int z = 0; z < S; ++z) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = __ldcg(reinterpret_cast<const float4*>(ws + z * plane + at[u]));
      if (z < plan.s_g) {
#pragma unroll
        for (int u = 0; u < U; ++u) add4(gs[u], v[u]);
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) add4(ps[u], v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int slot = (j0 + u) * THREADS + threadIdx.x;
      const int t = tok0 + slot / (BM / 4);
      const float gv[4] = {gs[u].x, gs[u].y, gs[u].z, gs[u].w};
      const float pv[4] = {ps[u].x, ps[u].y, ps[u].z, ps[u].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = col0 + slot % (BM / 4) * 4 + k;
        if (t >= n_t || c >= d) continue;
        const int64_t o = (int64_t)t * d + c;
        const float gate = 1.f / (1.f + expf(-gv[k]));
        out[o] = __float2bfloat16(__bfloat162float(h[o]) + gate * pv[k]);
      }
    }
  }
}

template <int BN, int MT, bool VEC>
int launch_tile(const bf16* h, const bf16* e, const bf16* wg, const bf16* wp,
                bf16* out, float* ws, int* counters, int n_t, int d, int F,
                Plan plan, cudaStream_t stream) {
  constexpr int SMEM = smem_bytes<BN>();
  static bool configured = false;    // above 48 KB needs the opt-in, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gated_fuse_bf16<BN, MT, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((d + BM - 1) / BM, (n_t + BN - 1) / BN,
                  plan.s_g + plan.s_p);
  gated_fuse_bf16<BN, MT, VEC><<<grid, THREADS, SMEM, stream>>>(
      h, e, wg, wp, out, ws, counters, n_t, d, F, plan);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch(int bn, const bf16* h, const bf16* e, const bf16* wg,
           const bf16* wp, bf16* out, float* ws, int* counters, int n_t, int d,
           int F, Plan plan, cudaStream_t s) {
  switch (bn) {
    case 8:
      return launch_tile<8, 1, VEC>(h, e, wg, wp, out, ws, counters, n_t, d,
                                    F, plan, s);
    case 16:
      return launch_tile<16, 1, VEC>(h, e, wg, wp, out, ws, counters, n_t, d,
                                     F, plan, s);
    case 32:
      return launch_tile<32, 1, VEC>(h, e, wg, wp, out, ws, counters, n_t, d,
                                     F, plan, s);
    case 64:
      return launch_tile<64, 2, VEC>(h, e, wg, wp, out, ws, counters, n_t, d,
                                     F, plan, s);
    case 128:
      return launch_tile<128, 2, VEC>(h, e, wg, wp, out, ws, counters, n_t,
                                      d, F, plan, s);
  }
  return (int)cudaErrorInvalidValue;
}

// A plan covers each kind's slabs exactly once with no empty part.
bool plan_ok(int64_t slabs, int64_t q, int64_t s) {
  if (slabs == 0) return s == 0;
  return q >= 1 && s >= 1 && s * q >= slabs && (s - 1) * q < slabs;
}

}  // namespace tc

}  // namespace

// float32: the CUDA-core kernel; ws, counters and the plan are unused.
// Returns cudaGetLastError().
extern "C" int gated_fuse_f32_launch(const void* h, const void* e,
                                     const void* wg, const void* wp,
                                     void* out, int64_t n_t, int64_t d,
                                     int64_t F, void* stream) {
  if (n_t <= 0 || d <= 0) return 0;
  if (n_t > (1LL << 30) || d > (1LL << 30) || F > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  return simt::launch(
      static_cast<const float*>(h), static_cast<const float*>(e),
      static_cast<const float*>(wg), static_cast<const float*>(wp),
      static_cast<float*>(out), (int)n_t, (int)d, (int)F,
      static_cast<cudaStream_t>(stream));
}

// bfloat16: the tensor-core kernel with token tile bn (8, 16, 32, 64 or
// 128) and the contraction split (q_g, s_g, q_p, s_p) the wrapper planned.
// ws: f32 workspace of (s_g + s_p) x ceil(n_t / bn) * bn x ceil(d / 64) * 64;
// counters: one int per (column, token) tile, zero between calls (the
// kernel leaves them zero). Returns cudaGetLastError().
extern "C" int gated_fuse_bf16_launch(const void* h, const void* e,
                                      const void* wg, const void* wp,
                                      void* out, void* ws, void* counters,
                                      int64_t n_t, int64_t d, int64_t F,
                                      int bn, int q_g, int s_g, int q_p,
                                      int s_p, void* stream) {
  if (n_t <= 0 || d <= 0) return 0;
  if (n_t > (1LL << 30) || d > (1LL << 30) || F < 0 || F > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int64_t slabs_g = (d + tc::BK - 1) / tc::BK;
  const int64_t slabs_p = (F + tc::BK - 1) / tc::BK;
  if (!tc::plan_ok(slabs_g, q_g, s_g) || !tc::plan_ok(slabs_p, q_p, s_p) ||
      s_g + s_p > 65535)
    return (int)cudaErrorInvalidValue;
  using tc::bf16;
  const uint64_t bits = (uint64_t)(uintptr_t)h | (uint64_t)(uintptr_t)e |
                        (uint64_t)(uintptr_t)wg | (uint64_t)(uintptr_t)wp;
  const bool vec = (bits & 15) == 0 && d % 8 == 0 && F % 8 == 0;
  const tc::Plan plan{q_g, s_g, q_p, s_p};
  const bf16* hb = static_cast<const bf16*>(h);
  const bf16* eb = static_cast<const bf16*>(e);
  const bf16* gb = static_cast<const bf16*>(wg);
  const bf16* pb = static_cast<const bf16*>(wp);
  bf16* ob = static_cast<bf16*>(out);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    return tc::launch<true>(bn, hb, eb, gb, pb, ob, wsf, cnt, (int)n_t,
                            (int)d, (int)F, plan, s);
  return tc::launch<false>(bn, hb, eb, gb, pb, ob, wsf, cnt, (int)n_t,
                           (int)d, (int)F, plan, s);
}
