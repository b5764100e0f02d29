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
// no order, and int32 counts are exact.
//
// What bounds it on an H100: bytes. The function reads the mask (1 B a row)
// and writes perm (4 B a row): 5 B a row from HBM, 0.0125 ms at 2^23 rows.
// The mask is read twice, but the second read is served by the 50 MB L2 as
// long as the mask fits there (up to about 50M rows), so HBM sees ~5 B a row.
// What cost the time is the write, and at small n the launches:
//   * perm is written through shared memory. Each block ranks the kept and
//     dead rows of its 4096-row tile (one 16-byte mask load a thread, a
//     block scan of the per-thread counts), places the row indices in
//     shared memory, kept rows at [0, kc) and dead rows at [kc, 4096), and
//     writes the two runs to perm[kept_off ...] and perm[total + dead_off
//     ...] with neighbouring threads on neighbouring addresses, so each warp
//     store fills whole 32-byte sectors. (A thread storing its own 16 rows
//     straight to perm touches about a sector per row at density 0.5: 8x
//     the L2 transactions.)
//   * Two launches. count_scan counts four tiles a block; the last block to
//     finish (a ticket taken with atomicAdd after __threadfence) scans the
//     tile counts into tile offsets and the total and resets the ticket for
//     the next call on the stream. tile_write then places the rows. Nothing
//     waits for the host between them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // rows per thread: one 16-byte load
constexpr int kTile = kThreads * kItems;
constexpr int kGroup = 4;  // tiles a count block counts

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
__device__ int block_exclusive_scan(int x, int* total) {
  constexpr int kWarps = kThreads / 32;
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

__device__ __forceinline__ int count_items(const uint8_t (&k)[kItems]) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) c += k[j];
  return c;
}

// Pass 1: kept rows per tile; the last block to finish scans them into
// tile_off (exclusive) and the total. A block counts kGroup tiles, each
// thread one 16-byte load in each, all loads in flight at once: a quarter
// of the blocks (one wave at 2^23 rows), and a quarter of the fences and
// ticket atomics, of one block per tile.
__global__ void count_scan(const uint8_t* __restrict__ keep, long long n,
                           int ntiles, int* __restrict__ tile_tot,
                           int* __restrict__ tile_off,
                           int* __restrict__ total_out,
                           unsigned int* __restrict__ ticket) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int warp_cnt[kGroup][kWarps];
  __shared__ bool last;
  const long long first = static_cast<long long>(blockIdx.x) * kGroup *
                              kTile +
                          static_cast<long long>(threadIdx.x) * kItems;
  int c[kGroup];
#pragma unroll
  for (int t = 0; t < kGroup; ++t) {
    uint8_t k[kItems];
    load_items(keep, n, first + static_cast<long long>(t) * kTile, k);
    c[t] = count_items(k);
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < kGroup; ++t) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      c[t] += __shfl_xor_sync(0xffffffffu, c[t], o);
    }
    if (lane == 0) warp_cnt[t][threadIdx.x >> 5] = c[t];
  }
  __syncthreads();
  if (threadIdx.x < kGroup) {
    const int tile = static_cast<int>(blockIdx.x) * kGroup +
                     static_cast<int>(threadIdx.x);
    if (tile < ntiles) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += warp_cnt[threadIdx.x][w];
      tile_tot[tile] = sum;
    }
    __threadfence();  // the counts are visible before the ticket is taken
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int carry = 0;
  for (int base = 0; base < ntiles; base += kTile) {
    const int i0 = base + static_cast<int>(threadIdx.x) * kItems;
    int v[kItems];
    int s = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      // L2, not L1: the counts were written by other blocks
      v[j] = i0 + j < ntiles ? __ldcg(tile_tot + i0 + j) : 0;
      s += v[j];
    }
    int chunk;
    int run = carry + block_exclusive_scan(s, &chunk);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (i0 + j < ntiles) tile_off[i0 + j] = run;
      run += v[j];
    }
    carry += chunk;
  }
  if (threadIdx.x == 0) {
    *total_out = carry;
    *ticket = 0u;  // ready for the next call on this stream
  }
}

// Pass 2: rank the tile's rows, stage the row indices in shared memory as
// [kept..., dead...], then write both runs with coalesced stores.
__global__ void tile_write(const uint8_t* __restrict__ keep, long long n,
                           const int* __restrict__ tile_off,
                           const int* __restrict__ total_ptr,
                           int* __restrict__ perm) {
  __shared__ int rows[kTile];
  uint8_t k[kItems];
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long first = tile0 + static_cast<long long>(threadIdx.x) * kItems;
  load_items(keep, n, first, k);
  int kc;  // kept rows of the tile
  int kept = block_exclusive_scan(count_items(k), &kc);
  // dead rows of this tile before this thread's rows, placed after the kept
  int dead = kc + static_cast<int>(threadIdx.x) * kItems - kept;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long g = first + j;
    if (g < n) {
      if (k[j]) {
        rows[kept++] = static_cast<int>(g);
      } else {
        rows[dead++] = static_cast<int>(g);
      }
    }
  }
  __syncthreads();
  const long long left = n - tile0;
  const int tile_rows = left < kTile ? static_cast<int>(left) : kTile;
  const int kept_off = tile_off[blockIdx.x];
  // dead rows before the tile: every earlier row not kept
  const int dead_off = *total_ptr + static_cast<int>(tile0) - kept_off;
  for (int i = threadIdx.x; i < tile_rows; i += kThreads) {
    perm[i < kc ? kept_off + i : dead_off + (i - kc)] = rows[i];
  }
}

}  // namespace

extern "C" int srt_compact_tile_rows() { return kTile; }

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// keep: n bytes (0/1); tile_tot, tile_off: max(1, ceil(n / tile_rows)) ints
// of scratch; total: one int; ticket: one unsigned int, zero before the
// first call and left zero by each call (one per stream: concurrent calls
// must not share it); perm: n ints. n < 2^31.
extern "C" int srt_compact_permutation(const uint8_t* keep, long long n,
                                       int* tile_tot, int* tile_off,
                                       int* total, unsigned int* ticket,
                                       int* perm, cudaStream_t stream) {
  long long tiles = (n + kTile - 1) / kTile;
  const int ntiles = static_cast<int>(tiles < 1 ? 1 : tiles);
  count_scan<<<(ntiles + kGroup - 1) / kGroup, kThreads, 0, stream>>>(
      keep, n, ntiles, tile_tot, tile_off, total, ticket);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n <= 0) return err;
  tile_write<<<ntiles, kThreads, 0, stream>>>(keep, n, tile_off, total, perm);
  return cudaGetLastError();
}
