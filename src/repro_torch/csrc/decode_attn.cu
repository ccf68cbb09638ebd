// Flash-decode attention for GQA decode steps on Hopper (sm_90a), K3.
// For each row b of a decode wave (one new token a row):
//   1. the new k and v rows are written into the caches at
//      at_b = clamp(pos_b, 0, S - 1), as models/attention.write_rows does;
//   2. each query head attends the keys lo_b .. hi_b of its KV head, where
//      hi_b = min(pos_b, S - 1) and lo_b = max(0, pos_b - window + 1) on a
//      local layer (0 otherwise): the keys models/attention.decode_attention's
//      mask lets through. A row whose mask lets none through weighs every
//      key equally, as the plain route's softmax over NEG_INF scores does;
//   3. score = (q . k) / sqrt(D), f32 sums of the operands' exact products,
//      then softcap * tanh(score / softcap) where the layer has a softcap;
//      an online softmax and the value sum in f32; the output is rounded
//      to the cache's type once, at the end.
//
// Replaces no TPU kernel: the reference attends with XLA's dot products,
// and the port's plain route (models/attention._sdpa) made f32 copies of
// the whole cache every layer and attended every one of its positions.
//
// What bounds it on the H100: bytes. A decode wave reads each row's live K
// and V once, about 8 FLOP per byte, far below the card's ridge; at
// engram-27b's pool.chat shape (32 rows, 8 KV heads of 128, 1227 live keys
// a row on average) a layer's live KV is 160 MB, 48 us at 3.35 TB/s. So:
//  - the cache is read in place, in its own type (bf16 or f32), and only
//    the keys the row attends;
//  - the g query heads of a KV head share every K and V load (one block
//    per KV head, g <= 8), so each byte of the cache is read once;
//  - a row's keys are cut into splits of `chunk` positions, so a wave of
//    few rows still fills 132 SMs (one task a split and KV head); blocks
//    are persistent, and each numbers the tasks of every row from the
//    positions (a scan over the rows in shared memory) and takes every
//    gridDim.x-th: only keys some row attends are dealt out, evenly,
//    whatever the rows' lengths;
//  - lanes lie across D, eight elements each (16-byte loads of a bf16 row),
//    D / 8 lanes a key, so a warp reads whole rows; each lane loads 4 keys
//    of K and V before it computes, for loads in flight; the score's sum
//    over D is a butterfly of shuffles over the key's lanes, which then
//    all hold the score, so the value sum needs no shared memory;
//  - bf16 at head dims 64 to 256 (the served models) compiles the group
//    size in: a head's loop then has no branch, the chains of every head
//    interleave, and the registers hold only g heads (168 registers, three
//    blocks an SM); at a run-time group each head's work is a branch;
//  - each lane group keeps an online softmax (running max, sum and value
//    sum) in registers; the groups of a warp, the warps of a block and the
//    splits of a row are merged by the same rule. The last block of a row's
//    splits to arrive (an arrival counter per (row, KV head), which it
//    resets) merges the splits' partials in split order: no float atomics,
//    the same result whatever the order of arrival, and one launch a layer;
//  - exponentials are base 2 (ex2.approx) of scores taken into log2 units,
//    about 2 ulp of f32.
// The tensor cores are not used: the value product needs the
// probabilities in f32; the score product could take them (bf16 operands
// summed in f32, no shuffles), the next step for this kernel.
//
// The caches are (B, S, Hc, D) with any strides whose rows are 16-byte
// aligned; q (B, Hq, D) in the cache's type or f32, the new rows (B, Hc, D)
// in the cache's type, positions int32 or int64 (B,). Query head i reads
// KV head (i + qoff) / group of the cache, so one launch serves a rank's
// block of heads under a mesh (qoff = h0 - c0 * group). The kernel
// allocates nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 8;  // query heads a KV head serves, at most
constexpr int NB = 4;    // keys a lane group loads before it computes
constexpr int MAXB = 1024;  // rows a launch takes, at most
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* kn;
  const void* vn;
  void* kc;
  void* vc;
  const void* pos;
  void* out;
  float* ws;
  int* cnt;
  int64_t q_sb, q_sh, kn_sb, kn_sh, vn_sb, vn_sh;
  int64_t kc_sb, kc_ss, kc_sh, vc_sb, vc_ss, vc_sh;
  int B, Hq, Hc, S, group, qoff, window, chunk, nsplit, q_f32, pos64;
  float softcap, scale;
};

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// eight elements of a row: one 16-byte load in bf16, two in f32
template <typename T>
struct Chunk {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Chunk<T> load8(const T* p) {
  Chunk<T> c;
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) c.u[i] = s[i];
  return c;
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const Chunk<T>& c) {
  uint4* d = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) d[i] = c.u[i];
}

__device__ __forceinline__ void unpack(const Chunk<__nv_bfloat16>& c,
                                       float (&x)[8]) {
  const uint32_t w[4] = {c.u[0].x, c.u[0].y, c.u[0].z, c.u[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const Chunk<float>& c, float (&x)[8]) {
  const uint32_t w[8] = {c.u[0].x, c.u[0].y, c.u[0].z, c.u[0].w,
                         c.u[1].x, c.u[1].y, c.u[1].z, c.u[1].w};
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __uint_as_float(w[i]);
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_f32(float x) {
  return x;
}

// the weight of a partial with running max m in a merge whose max is mx
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : ex2(m - mx);
}

// row b's attended keys [lo, hi] and its write position at; uniform: no
// key is valid, so every key weighs the same (lo = 0, hi = S - 1)
struct Range {
  int lo, hi, at;
  bool uniform;
};

__device__ __forceinline__ Range row_range(const Params& p, int b) {
  const int64_t pos = p.pos64 ? static_cast<const int64_t*>(p.pos)[b]
                              : (int64_t) static_cast<const int*>(p.pos)[b];
  int64_t lo = p.window > 0 ? pos - p.window + 1 : 0;
  if (lo < 0) lo = 0;
  const int64_t hi = pos < p.S - 1 ? pos : p.S - 1;
  Range r;
  r.uniform = hi < lo;  // pos < 0 among them
  r.lo = r.uniform ? 0 : (int)lo;
  r.hi = r.uniform ? p.S - 1 : (int)hi;
  r.at = pos < 0 ? 0 : (int)hi;  // clamp(pos, 0, S - 1)
  return r;
}

// q's smem layout: lane c's eight elements d = 8c .. 8c + 7 as two float4
// at 4c and D/2 + 4c, so a quarter warp's 16-byte reads hit distinct banks
template <int D>
__device__ __forceinline__ int q_slot(int d) {
  return ((d & 7) < 4 ? 0 : D / 2) + (d >> 3) * 4 + (d & 3);
}

// LPK lanes a key (D = 8 * LPK). GT: the group size compiled in (the
// query heads a block computes, rows past a block's own G zero), or 0: G
// read at run time, up to GMAX, a branch a head
template <typename T, int LPK, int GT>
__global__ void __launch_bounds__(THREADS, 3)
decode_attn_kernel(const Params p) {
  constexpr int D = 8 * LPK;
  constexpr int GA = GT ? GT : GMAX;  // heads the registers hold
  constexpr int KPW = 32 / LPK;          // keys a warp reads at once
  constexpr int STEP = WARPS * NB * KPW;  // keys a block reads at once
  __shared__ __align__(16) float qs[GMAX][D];
  __shared__ __align__(16) float red_acc[WARPS][GMAX][D];
  __shared__ float red_m[WARPS][GMAX], red_l[WARPS][GMAX];
  __shared__ int task0[MAXB + 1], warp_sum[WARPS], last_flag;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / LPK, c = lane % LPK;

  // the tasks: row b's splits first / chunk .. hi / chunk, each for every
  // KV head, numbered from task0[b]; every block numbers them alike and
  // takes every gridDim.x-th, so only keys a row attends are dealt out
  const int per = (p.B + THREADS - 1) / THREADS;  // rows a thread counts
  int own = 0;
  for (int b = tid * per; b < min(p.B, (tid + 1) * per); ++b) {
    const Range r = row_range(p, b);
    own += (r.hi / p.chunk - r.lo / p.chunk + 1) * p.Hc;
  }
  int incl = own;  // inclusive scan of the threads' counts
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += x;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = incl - own;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  for (int b = tid * per; b < min(p.B, (tid + 1) * per); ++b) {
    task0[b] = before;
    const Range r = row_range(p, b);
    before += (r.hi / p.chunk - r.lo / p.chunk + 1) * p.Hc;
  }
  if (tid == THREADS - 1) task0[p.B] = before;
  __syncthreads();
  const int n_tasks = task0[p.B];

  for (int task = blockIdx.x; task < n_tasks; task += gridDim.x) {
    int b = 0;  // the last row whose tasks start at or before this one
    for (int step = MAXB; step > 0; step >>= 1)
      if (b + step < p.B && task0[b + step] <= task) b += step;
    const Range r = row_range(p, b);
    const int lo = r.lo, hi = r.hi, at = r.at;
    const bool uniform = r.uniform;
    const int first = lo / p.chunk, last = hi / p.chunk;
    const int rel = task - task0[b];
    const int split = first + rel / p.Hc, j = rel % p.Hc;
    const int bj = b * p.Hc + j;
    const int k0 = max(split * p.chunk, lo);
    const int n = min((split + 1) * p.chunk - 1, hi) - k0 + 1;

    T* kc = static_cast<T*>(p.kc) + b * p.kc_sb + j * p.kc_sh;
    T* vc = static_cast<T*>(p.vc) + b * p.vc_sb + j * p.vc_sh;
    __syncthreads();  // the last task's readers of shared memory are done
    // 1. the new rows, by the block whose split holds their position
    if (at / p.chunk == split) {
      if (tid < LPK)
        store8(kc + at * p.kc_ss + 8 * tid,
               load8(static_cast<const T*>(p.kn) + b * p.kn_sb +
                     j * p.kn_sh + 8 * tid));
      else if (tid < 2 * LPK)
        store8(vc + at * p.vc_ss + 8 * (tid - LPK),
               load8(static_cast<const T*>(p.vn) + b * p.vn_sb +
                     j * p.vn_sh + 8 * (tid - LPK)));
    }
    const int qa = max(0, j * p.group - p.qoff);
    const int G = min(p.Hq, (j + 1) * p.group - p.qoff) - qa;
    if (G <= 0) continue;  // a KV head of the cache no query head reads
    for (int i = tid; i < (GT ? GA : G) * D; i += THREADS) {
      const int h = i / D, d = i - h * D;
      const int64_t off = b * p.q_sb + (qa + h) * p.q_sh + d;
      if (h >= G) {
        if (GT) qs[h][d] = 0.f;  // a compiled-in head this block lacks
        continue;
      }
      qs[h][q_slot<D>(d)] = p.q_f32 ? static_cast<const float*>(p.q)[off]
                                    : to_f32(static_cast<const T*>(p.q)[off]);
    }
    __syncthreads();  // q and the new rows visible to the block

    // 2. this warp's keys: k0 + base + t * KPW + grp
    float m[GA], l[GA], acc[GA][8];
#pragma unroll
    for (int h = 0; h < GA; ++h) {
      m[h] = -INFINITY;
      l[h] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[h][e] = 0.f;
    }
    for (int base = warp * NB * KPW; base < n; base += STEP) {
      Chunk<T> kr[NB], vr[NB];
      bool ok[NB];
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        const int kk = base + t * KPW + grp;
        ok[t] = kk < n;
        const int64_t key = k0 + (ok[t] ? kk : 0);
        kr[t] = load8(kc + key * p.kc_ss + 8 * c);
        vr[t] = load8(vc + key * p.vc_ss + 8 * c);
      }
      float f[NB][8];  // K's elements, then V's
#pragma unroll
      for (int t = 0; t < NB; ++t) unpack(kr[t], f[t]);
      // a head's NB scores are independent chains: one branch holds them
      float s[GA][NB];
#pragma unroll
      for (int h = 0; h < GA; ++h) {
        if (GT || h < G) {
          const float4 a = *reinterpret_cast<const float4*>(&qs[h][4 * c]);
          const float4 z =
              *reinterpret_cast<const float4*>(&qs[h][D / 2 + 4 * c]);
          float x[NB];
#pragma unroll
          for (int t = 0; t < NB; ++t) {
            x[t] = a.x * f[t][0];
            x[t] = fmaf(a.y, f[t][1], x[t]);
            x[t] = fmaf(a.z, f[t][2], x[t]);
            x[t] = fmaf(a.w, f[t][3], x[t]);
            x[t] = fmaf(z.x, f[t][4], x[t]);
            x[t] = fmaf(z.y, f[t][5], x[t]);
            x[t] = fmaf(z.z, f[t][6], x[t]);
            x[t] = fmaf(z.w, f[t][7], x[t]);
          }
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
            for (int t = 0; t < NB; ++t)
              x[t] += __shfl_xor_sync(0xffffffffu, x[t], off);
          }
#pragma unroll
          for (int t = 0; t < NB; ++t) {
            float y = x[t] * p.scale;
            if (p.softcap > 0.f) y = p.softcap * tanhf(y / p.softcap);
            s[h][t] = uniform ? 0.f : y * LOG2E;
          }
        }
      }
#pragma unroll
      for (int t = 0; t < NB; ++t) unpack(vr[t], f[t]);
#pragma unroll
      for (int h = 0; h < GA; ++h) {
        if (GT || h < G) {
          float mx = m[h];
#pragma unroll
          for (int t = 0; t < NB; ++t)
            if (ok[t]) mx = fmaxf(mx, s[h][t]);
          const float a = weight(m[h], mx);
          float pr[NB];
          float sum = 0.f;
#pragma unroll
          for (int t = 0; t < NB; ++t) {
            pr[t] = ok[t] ? ex2(s[h][t] - mx) : 0.f;
            sum += pr[t];
          }
          l[h] = l[h] * a + sum;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float y = acc[h][e] * a;
#pragma unroll
            for (int t = 0; t < NB; ++t) y = fmaf(pr[t], f[t][e], y);
            acc[h][e] = y;
          }
          m[h] = mx;
        }
      }
    }
    // 3. merge the warp's lane groups (lanes of one d-chunk), then the warps
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
      for (int h = 0; h < GA; ++h) {
        if (GT || h < G) {
          const float m2 = __shfl_xor_sync(0xffffffffu, m[h], off);
          const float l2 = __shfl_xor_sync(0xffffffffu, l[h], off);
          const float mx = fmaxf(m[h], m2);
          const float a1 = weight(m[h], mx), a2 = weight(m2, mx);
          l[h] = l[h] * a1 + l2 * a2;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[h][e] = acc[h][e] * a1 +
                        __shfl_xor_sync(0xffffffffu, acc[h][e], off) * a2;
          m[h] = mx;
        }
      }
    }
    if (grp == 0) {
#pragma unroll
      for (int h = 0; h < GA; ++h) {
        if (GT || h < G) {
#pragma unroll
          for (int e = 0; e < 8; ++e) red_acc[warp][h][8 * c + e] = acc[h][e];
          if (c == 0) {
            red_m[warp][h] = m[h];
            red_l[warp][h] = l[h];
          }
        }
      }
    }
    __syncthreads();
    const bool alone = first == last;
    const int64_t slot = 2 * GMAX + GMAX * D;  // floats of one partial
    float* part = p.ws + ((int64_t)bj * p.nsplit + split) * slot;
    for (int i = tid; i < G * D; i += THREADS) {
      const int h = i / D, d = i - h * D;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red_m[w][h]);
      float ls = 0.f, as = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float a = weight(red_m[w][h], mx);
        ls += red_l[w][h] * a;
        as += red_acc[w][h][d] * a;
      }
      if (alone) {
        static_cast<T*>(p.out)[((int64_t)b * p.Hq + qa + h) * D + d] =
            from_f32<T>(as / ls);
      } else {
        if (d == 0) {
          part[h] = mx;
          part[GMAX + h] = ls;
        }
        part[2 * GMAX + h * D + d] = as;
      }
    }
    if (alone) continue;
    // 4. the last of the row's splits to arrive merges them, in split order
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last_flag = atomicAdd(p.cnt + bj, 1) == last - first;
    __syncthreads();
    if (!last_flag) continue;
    __threadfence();
    const float* row = p.ws + (int64_t)bj * p.nsplit * slot;
    for (int i = tid; i < G * D; i += THREADS) {
      const int h = i / D, d = i - h * D;
      float mx = -INFINITY;
      for (int s2 = first; s2 <= last; ++s2)
        mx = fmaxf(mx, __ldcg(row + s2 * slot + h));
      float ls = 0.f, as = 0.f;
      for (int s2 = first; s2 <= last; ++s2) {
        const float* q2 = row + s2 * slot;
        const float a = ex2(__ldcg(q2 + h) - mx);
        ls += __ldcg(q2 + GMAX + h) * a;
        as += __ldcg(q2 + 2 * GMAX + h * D + d) * a;
      }
      static_cast<T*>(p.out)[((int64_t)b * p.Hq + qa + h) * D + d] =
          from_f32<T>(as / ls);
    }
    if (tid == 0) p.cnt[bj] = 0;
  }
}

template <typename T, int LPK, int GT>
int launch(const Params& p, cudaStream_t stream) {
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_attn_kernel<T, LPK, GT>, THREADS, 0);
    if (per_sm < 1) per_sm = 1;
  }
  const int64_t most = (int64_t)p.nsplit * p.B * p.Hc;  // tasks at most
  const int64_t grid = most < (int64_t)per_sm * sms ? most
                                                    : (int64_t)per_sm * sms;
  decode_attn_kernel<T, LPK, GT><<<(unsigned)grid, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// bf16 at head dims 64 to 256 (the served models) compiles the group in;
// other instances read it at run time
template <typename T, int LPK>
int launch_g(const Params& p, cudaStream_t s) {
  if constexpr (sizeof(T) == 2 && LPK >= 8) {
    switch (p.group) {
      case 1: return launch<T, LPK, 1>(p, s);
      case 2: return launch<T, LPK, 2>(p, s);
      case 3: return launch<T, LPK, 3>(p, s);
      case 4: return launch<T, LPK, 4>(p, s);
      case 5: return launch<T, LPK, 5>(p, s);
      case 6: return launch<T, LPK, 6>(p, s);
      case 7: return launch<T, LPK, 7>(p, s);
      case 8: return launch<T, LPK, 8>(p, s);
    }
  }
  return launch<T, LPK, 0>(p, s);
}

template <typename T>
int launch_d(const Params& p, int D, cudaStream_t s) {
  switch (D) {
    case 8: return launch_g<T, 1>(p, s);
    case 16: return launch_g<T, 2>(p, s);
    case 64: return launch_g<T, 8>(p, s);
    case 128: return launch_g<T, 16>(p, s);
    case 256: return launch_g<T, 32>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One decode step's attention for a layer, in one launch (see the top of
// the file). strides: 12 element strides, q (b, h), k_new (b, h), v_new
// (b, h), k_cache (b, s, h), v_cache (b, s, h); D is unit-stride
// everywhere. out (B, Hq, D) contiguous, in the cache's type. ws: f32
// workspace of B * Hc * nsplit * (16 + 8 * D) floats, nsplit = ceil(S /
// chunk); counters: B * Hc ints, zero between calls (the kernel leaves
// them zero). dtype 0: float32 caches, 1: bfloat16. Returns
// cudaGetLastError().
extern "C" int decode_attn_launch(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, const void* positions, void* out, void* ws,
    void* counters, const int64_t* strides, int64_t B, int64_t Hq,
    int64_t Hc, int64_t S, int64_t D, int group, int q_offset, int window,
    float softcap, float scale, int chunk, int dtype, int q_f32, int pos64,
    void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (Hc <= 0 || S <= 0 || group < 1 || group > GMAX || q_offset < 0 ||
      chunk < 1 || window < 0 || B > MAXB || S > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int64_t nsplit = (S + chunk - 1) / chunk;
  if (nsplit * B * Hc >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.kn = k_new;
  p.vn = v_new;
  p.kc = k_cache;
  p.vc = v_cache;
  p.pos = positions;
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.cnt = static_cast<int*>(counters);
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.kn_sb = strides[2];
  p.kn_sh = strides[3];
  p.vn_sb = strides[4];
  p.vn_sh = strides[5];
  p.kc_sb = strides[6];
  p.kc_ss = strides[7];
  p.kc_sh = strides[8];
  p.vc_sb = strides[9];
  p.vc_ss = strides[10];
  p.vc_sh = strides[11];
  p.B = (int)B;
  p.Hq = (int)Hq;
  p.Hc = (int)Hc;
  p.S = (int)S;
  p.group = group;
  p.qoff = q_offset;
  p.window = window;
  p.chunk = chunk;
  p.nsplit = (int)nsplit;
  p.q_f32 = q_f32;
  p.pos64 = pos64;
  p.softcap = softcap;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, (int)D, s);
  if (dtype == 0) return launch_d<float>(p, (int)D, s);
  return (int)cudaErrorInvalidValue;
}
