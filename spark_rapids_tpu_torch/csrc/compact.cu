// Stream compaction: the stable-partition permutation of a keep mask (kept
// rows first, in order, then the rest, in order) and the kept total.
//
// Replaces the TPU kernel spark_rapids_tpu/ops/pallas_kernels.py
// _dual_prefix_kernel (:68), launched by _dual_prefix_pallas (:114); public
// entry compact_permutation (:180).
//
// The TPU kernel walks a sequential grid, carries the two running counts in
// SMEM and scans each (16, 128) block by MXU matmul, exact only while a block
// holds <= 2048 rows. None of that carries over: blocks run in parallel, in
// no order, and int32 counts are exact. Three launches:
//   1. tile_count: each block counts the kept rows of its tile (4096 rows:
//      256 threads x one 16-byte load each);
//   2. scan_tiles: one block scans the tile counts (exclusive) and writes the
//      kept total;
//   3. tile_write: each block rescans its tile and writes perm directly,
//      dest = keep ? kept_ex : total + dead_ex, with dead_ex = i - kept_ex.
// What bounds it on an H100: bytes. The function reads the keep mask (1 B a
// row) and writes perm (4 B a row); this design reads the mask twice, so it
// moves 6 B a row against the bound's 5. A single-pass decoupled look-back
// scan would read it once; that is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // rows per thread: one 16-byte load
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ void load_items(const uint8_t* keep, long long n,
                                           long long first,
                                           uint8_t (&k)[kItems]) {
  if (first + kItems <= n &&
      (reinterpret_cast<uintptr_t>(keep + first) & 15) == 0) {
    uint4 v = *reinterpret_cast<const uint4*>(keep + first);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
    for (int j = 0; j < kItems; ++j) k[j] = b[j] != 0;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      long long g = first + j;
      k[j] = (g < n) ? (keep[g] != 0) : 0;
    }
  }
}

// Exclusive scan of one int per thread across the block; the block total is
// stored to *total for every thread.
template <int THREADS>
__device__ int block_exclusive_scan(int x, int* total) {
  constexpr int kWarps = THREADS / 32;
  __shared__ int warp_off[kWarps];
  __shared__ int block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_off[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kWarps) warp_off[lane] = wi - w;
    if (lane == 31) block_total = wi;
  }
  __syncthreads();
  int ex = warp_off[warp] + incl - x;
  *total = block_total;
  __syncthreads();  // the shared arrays may be reused by the next call
  return ex;
}

__global__ void tile_count(const uint8_t* __restrict__ keep, long long n,
                           int* __restrict__ tile_tot) {
  uint8_t k[kItems];
  long long first = static_cast<long long>(blockIdx.x) * kTile +
                    static_cast<long long>(threadIdx.x) * kItems;
  load_items(keep, n, first, k);
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) c += k[j];
  int total;
  block_exclusive_scan<kThreads>(c, &total);
  if (threadIdx.x == 0) tile_tot[blockIdx.x] = total;
}

__global__ void scan_tiles(const int* __restrict__ tile_tot, int ntiles,
                           int* __restrict__ tile_off,
                           int* __restrict__ total_out) {
  int carry = 0;
  for (int base = 0; base < ntiles; base += kScanThreads) {
    int i = base + static_cast<int>(threadIdx.x);
    int x = i < ntiles ? tile_tot[i] : 0;
    int tot;
    int ex = block_exclusive_scan<kScanThreads>(x, &tot);
    if (i < ntiles) tile_off[i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) *total_out = carry;
}

__global__ void tile_write(const uint8_t* __restrict__ keep, long long n,
                           const int* __restrict__ tile_off,
                           const int* __restrict__ total_ptr,
                           int* __restrict__ perm) {
  uint8_t k[kItems];
  long long first = static_cast<long long>(blockIdx.x) * kTile +
                    static_cast<long long>(threadIdx.x) * kItems;
  load_items(keep, n, first, k);
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) c += k[j];
  int tot;
  int kept = tile_off[blockIdx.x] + block_exclusive_scan<kThreads>(c, &tot);
  const int total = *total_ptr;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    long long g = first + j;
    if (g >= n) break;
    int gi = static_cast<int>(g);
    perm[k[j] ? kept : total + (gi - kept)] = gi;
    kept += k[j];
  }
}

}  // namespace

extern "C" int srt_compact_tile_rows() { return kTile; }

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// keep: n bytes (0/1); tile_tot, tile_off: ceil(n / tile_rows) ints of
// scratch; total: one int; perm: n ints. n < 2^31.
extern "C" int srt_compact_permutation(const uint8_t* keep, long long n,
                                       int* tile_tot, int* tile_off,
                                       int* total, int* perm,
                                       cudaStream_t stream) {
  const int ntiles = static_cast<int>((n + kTile - 1) / kTile);
  cudaError_t err;
  if (ntiles > 0) {
    tile_count<<<ntiles, kThreads, 0, stream>>>(keep, n, tile_tot);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  scan_tiles<<<1, kScanThreads, 0, stream>>>(tile_tot, ntiles, tile_off,
                                             total);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (ntiles > 0) {
    tile_write<<<ntiles, kThreads, 0, stream>>>(keep, n, tile_off, total,
                                                perm);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}
