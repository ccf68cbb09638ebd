// Engram row gather for Hopper (sm_90a), over up to 8 tables in one launch:
//     out[t][i] = table_t[gid[t][i]]        t < n_tables, i < n_per_table
//
// Replaces the TPU kernel src/repro/kernels/engram_gather/engram_gather.py,
// function gather_rows (body _copy_kernel): there the grid runs one row per
// step and scalar-prefetches each row's address into the BlockSpec index
// map. Here one launch serves a whole decode wave, every Engram layer's
// table at once (the single-table gather is the one-table case).
//
// What bounds it on the H100: latency, not bytes. A decode wave moves 2
// layers x 128 rows x 320 B, about 160 KB, tens of nanoseconds at
// 3.35 TB/s; what a row costs is two dependent round trips to memory,
// first its id and then its bytes, plus the launch. So the design keeps
// that chain short and every row's chain in flight at once:
//  - a flat grid of 128-thread blocks over (row, 16-byte chunk) pairs:
//    neighbouring threads copy neighbouring chunks of one row (a 320-byte
//    row is 20 lanes), and every lane of a row loads the row's id itself,
//    one address, so one transaction per warp and no shuffle in the chain
//    (on the H100 this beat one lane loading the id and broadcasting it
//    with __shfl_sync, at a decode wave's 128 and 256 rows);
//  - the table's fields are selected with constant indices, so they are
//    read straight from the launch's parameter bank (a dynamic index would
//    be a memory load, in series with the id's);
//  - plain loads for table rows (on the H100 they beat read-only,
//    L1-non-allocating ones here); (row, chunk) arithmetic is 32-bit, and
//    only the byte offset of a row in its table is 64-bit.
// Every access is a 16-byte vector when the row width, every row stride
// and every base pointer allow it (every engram-27b table); otherwise the
// same kernel copies byte by byte, never a host-side fallback.
//
// Each table is a base pointer plus a row stride in bytes and a row count,
// so the kernel reads rows from any memory the card can address: device
// memory, or pinned, device-mapped host memory, the paper's CXL-to-VRAM
// copy (Listing 2: a CXL expander shows up to the host as memory, and the
// card reads it as it reads mapped host memory, over the host link). That
// host path is served (strategy pooled_host) and checked against the plain
// version by the wrapper's tests and chip_smoke.py. Over the link a row
// costs one PCIe round trip instead of one to HBM, so keeping every row's
// chain in flight at once matters more there, not less. The host entries at
// the end register an existing host buffer and return its device address,
// which is what the kernel is given. Row
// ids are int64, laid out [table][row]. A row id outside [0, n_rows) traps:
// the wrapper cannot check device-resident ids without a host sync, and a
// silent zero row would hide the fault. The kernel allocates nothing and
// launches on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_TABLES = 8;
constexpr int THREADS = 128;

struct Tables {
  const char* base[MAX_TABLES];
  int64_t row_stride[MAX_TABLES];  // bytes
  int64_t n_rows[MAX_TABLES];
};

template <typename V>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const Tables tabs, const int64_t* __restrict__ gid,
                   int n_per_table, int n_total, char* __restrict__ out,
                   int row_bytes) {
  const int per_row = row_bytes / (int)sizeof(V);
  const int total = n_total * per_row;
  for (int x = blockIdx.x * THREADS + threadIdx.x; x < total;
       x += gridDim.x * THREADS) {
    const int i = x / per_row, j = x - i * per_row;
    const int t = i / n_per_table;
    const int64_t r = gid[i];
    const char* base = tabs.base[0];
    int64_t stride = tabs.row_stride[0], rows = tabs.n_rows[0];
#pragma unroll
    for (int k = 1; k < MAX_TABLES; ++k)
      if (t == k) {
        base = tabs.base[k];
        stride = tabs.row_stride[k];
        rows = tabs.n_rows[k];
      }
    if (r < 0 || r >= rows) __trap();
    reinterpret_cast<V*>(out + (size_t)i * row_bytes)[j] =
        reinterpret_cast<const V*>(base + r * stride)[j];
  }
}

}  // namespace

// out (n_tables, n_per_table, row_bytes) <- for each table t, the rows
// gid[t * n_per_table + i] of the table at bases[t], whose rows start every
// row_strides[t] bytes and number n_rows[t]. Returns cudaGetLastError().
extern "C" int engram_gather_tables(const void* const* bases,
                                    const int64_t* row_strides,
                                    const int64_t* n_rows, int n_tables,
                                    const int64_t* gid, int64_t n_per_table,
                                    void* out, int64_t row_bytes,
                                    void* stream) {
  if (n_tables < 1 || n_tables > MAX_TABLES || n_per_table < 0 ||
      row_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n_total = n_tables * n_per_table;
  if (n_total == 0 || row_bytes == 0) return 0;
  if (n_total >= (1LL << 31) || row_bytes >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Tables tabs = {};
  uint64_t bits = (uint64_t)(uintptr_t)out | (uint64_t)row_bytes;
  for (int t = 0; t < n_tables; ++t) {
    tabs.base[t] = static_cast<const char*>(bases[t]);
    tabs.row_stride[t] = row_strides[t];
    tabs.n_rows[t] = n_rows[t];
    bits |= (uint64_t)(uintptr_t)bases[t] | (uint64_t)row_strides[t];
  }
  const bool vec = (bits & 15) == 0;
  const int64_t chunks = n_total * (vec ? row_bytes / 16 : row_bytes);
  if (chunks >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  int64_t blocks = (chunks + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;  // the chunk loop covers the rest
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    gather_rows_kernel<uint4><<<(unsigned)blocks, THREADS, 0, s>>>(
        tabs, gid, (int)n_per_table, (int)n_total, static_cast<char*>(out),
        (int)row_bytes);
  else
    gather_rows_kernel<unsigned char><<<(unsigned)blocks, THREADS, 0, s>>>(
        tabs, gid, (int)n_per_table, (int)n_total, static_cast<char*>(out),
        (int)row_bytes);
  return (int)cudaGetLastError();
}

// Host tables. Register the host buffer [ptr, ptr + nbytes) as pinned and
// mapped into every context (cudaHostRegisterMapped | Portable) and pass
// back the address through which the card reads it: a table in that buffer
// is handed to the kernel at this address, which equals the host address
// only where cudaDevAttrCanUseHostPointerForRegisteredMem says so. A failed
// call's error is cleared here, so it does not surface at the next launch's
// cudaGetLastError().
extern "C" int engram_host_register(void* ptr, int64_t nbytes,
                                    void** dev_ptr) {
  if (ptr == nullptr || nbytes <= 0 || dev_ptr == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaHostRegister(
      ptr, (size_t)nbytes, cudaHostRegisterMapped | cudaHostRegisterPortable);
  if (e == cudaSuccess) {
    e = cudaHostGetDevicePointer(dev_ptr, ptr, 0);
    if (e != cudaSuccess) cudaHostUnregister(ptr);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// Unregister a buffer registered by engram_host_register (by its base).
extern "C" int engram_host_unregister(void* ptr) {
  const cudaError_t e = cudaHostUnregister(ptr);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
