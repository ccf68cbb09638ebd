// Engram row gather for Hopper (sm_90a): out[i] = table[gid[i]].
//
// Replaces the TPU kernel src/repro/kernels/engram_gather/engram_gather.py,
// function gather_rows (body _copy_kernel): there the grid runs one row per
// step and scalar-prefetches each row's address into the BlockSpec index
// map. This is the paper's own wide-grid cxl2vram_copy shape again: a flat
// grid over (row, 16-byte chunk) pairs, so neighbouring threads copy
// neighbouring chunks of one row (a 320-byte engram-27b row is twenty
// 16-byte loads and stores, spread over twenty threads of a warp).
//
// What bounds it on the H100: bytes. Each row is read once and written
// once; at a decode wave (16 tables x 8 slots = 128 rows of 320 B) that is
// about 80 KB, a few tens of nanoseconds at 3.35 TB/s, so the launch
// itself sets the time. The design keeps every access a full 16-byte
// vector when the row width, row stride and both base pointers allow it
// (every engram-27b table), and copies byte by byte otherwise, in the
// same kernel, never a host-side fallback.
//
// The table is a base pointer plus a row stride in bytes, so the same
// kernel can read rows from any addressable memory (device memory here;
// pinned, mapped host memory for the paper's CXL-to-VRAM copy). Row ids
// are int64. A row id outside [0, n_rows) traps: the wrapper cannot check
// device-resident ids without a host sync, and a silent zero row would
// hide the fault. The kernel allocates nothing and launches on the
// caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void __launch_bounds__(256)
gather_rows_kernel(const char* __restrict__ table, int64_t row_stride,
                   int64_t n_rows, const int64_t* __restrict__ gid, int64_t n,
                   char* __restrict__ out, int64_t row_bytes) {
  const int64_t per_row = row_bytes / (int64_t)sizeof(V);
  const int64_t total = n * per_row;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += step) {
    const int64_t i = t / per_row;
    const int64_t j = t - i * per_row;
    const int64_t r = gid[i];
    if (r < 0 || r >= n_rows) __trap();
    const V* src = reinterpret_cast<const V*>(table + r * row_stride);
    reinterpret_cast<V*>(out + i * row_bytes)[j] = src[j];
  }
}

template <typename V>
void launch(const void* table, int64_t row_stride, int64_t n_rows,
            const int64_t* gid, int64_t n, void* out, int64_t row_bytes,
            cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n * (row_bytes / (int64_t)sizeof(V));
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;  // grid-stride loop covers the rest
  gather_rows_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const char*>(table), row_stride, n_rows, gid, n,
      static_cast<char*>(out), row_bytes);
}

}  // namespace

// out (n, row_bytes) <- rows gid[0..n) of the table at `table` whose rows
// start every `row_stride` bytes. Returns cudaGetLastError().
extern "C" int engram_gather_rows(const void* table, int64_t row_stride,
                                  int64_t n_rows, const int64_t* gid,
                                  int64_t n, void* out, int64_t row_bytes,
                                  void* stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  const uint64_t bits = (uint64_t)(uintptr_t)table | (uint64_t)(uintptr_t)out |
                        (uint64_t)row_stride | (uint64_t)row_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((bits & 15) == 0)
    launch<uint4>(table, row_stride, n_rows, gid, n, out, row_bytes, s);
  else
    launch<unsigned char>(table, row_stride, n_rows, gid, n, out, row_bytes, s);
  return (int)cudaGetLastError();
}
