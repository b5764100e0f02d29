// One-pass open-addressing grouped aggregation: every live row claims (or
// joins) the slot of its key and folds each job's value into that slot's
// accumulators.
//
// Replaces the TPU kernel spark_rapids_tpu/ops/pallas_kernels.py
// _hash_agg_kernel (:619), launched by _hash_agg_pallas (:701); public entry
// hash_grouped_aggregate (:799).
//
// The TPU kernel inserts rows one at a time on a single-step grid with the
// whole table in VMEM, which caps the table at _PALLAS_MAX_TABLE (:476) and
// routes larger ones to the jnp twin (:815-817). Here one thread takes one
// row and the table lives in device memory, so no cap applies:
//   * slot = (splitmix64 chain over the k key words + probe) & (T - 1),
//     linear probing, load <= 1/2 (the caller sizes T);
//   * a per-slot state word makes a k-word key appear atomically (the
//     claim/publish probe of hash_table.cuh, shared with hash_join.cu);
//   * count: atomicAdd; rep: atomicMin of the row index, which is the first
//     arrival (the jnp twin's segment_min, :738-739);
//   * per job, where eligible: the eligible count, then sum by atomicAdd
//     (int64 as unsigned wrap-around, float64 native), integer min/max by
//     atomicMin/atomicMax, float64 min/max by a CAS loop (NaN wins).
// Slot order and the order of float additions differ from the TPU kernel;
// callers compact used slots and compare groups by key.
// What bounds it on an H100: bytes, dominated by random 32-byte sectors a row
// touches in the table: at least one for the claim state with the key words
// (a packed slot of 4 + 8k bytes), then count, rep, and per job the
// accumulator and the eligible count. This layout keeps the state and each
// key word in arrays of their own, so a row pays k sectors above that
// minimum; packing them into one slot is later work. Each row does those
// touches once when its first probe hits; every touch is one atomic or load.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_table.cuh"

namespace {

using srt::kMaxKeys;
using srt::load_word;
constexpr int kThreads = 256;
// job table row: kind, dtype, data ptr, eligible ptr, acc ptr, nel ptr
constexpr int kJobFields = 6;
enum Kind { kSum = 0, kMin = 1, kMax = 2 };
enum Dtype { kI64 = 0, kF64 = 1, kI32 = 2 };

// min (want_less) or max of a float64 accumulator; NaN is sticky, as in the
// segment ops of the plain version
__device__ void atomic_minmax_f64(double* addr, double v, bool want_less) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = load_word(a);
  while (true) {
    double cur = __longlong_as_double(static_cast<long long>(old));
    if (isnan(cur)) return;
    bool better = isnan(v) || (want_less ? v < cur : v > cur);
    if (!better) return;
    unsigned long long prev = atomicCAS(
        a, old, static_cast<unsigned long long>(__double_as_longlong(v)));
    if (prev == old) return;
    old = prev;
  }
}

__device__ void accumulate(const long long* __restrict__ job, int row,
                           int slot) {
  const uint8_t* elig = reinterpret_cast<const uint8_t*>(job[3]);
  if (!elig[row]) return;
  atomicAdd(reinterpret_cast<int*>(job[5]) + slot, 1);
  const int kind = static_cast<int>(job[0]);
  switch (static_cast<int>(job[1])) {
    case kI64: {
      long long d = reinterpret_cast<const long long*>(job[2])[row];
      long long* acc = reinterpret_cast<long long*>(job[4]) + slot;
      if (kind == kSum) {
        atomicAdd(reinterpret_cast<unsigned long long*>(acc),
                  static_cast<unsigned long long>(d));
      } else if (kind == kMin) {
        atomicMin(acc, d);
      } else {
        atomicMax(acc, d);
      }
      break;
    }
    case kF64: {
      double d = reinterpret_cast<const double*>(job[2])[row];
      double* acc = reinterpret_cast<double*>(job[4]) + slot;
      if (kind == kSum) {
        atomicAdd(acc, d);
      } else {
        atomic_minmax_f64(acc, d, kind == kMin);
      }
      break;
    }
    default: {  // kI32
      int d = reinterpret_cast<const int*>(job[2])[row];
      int* acc = reinterpret_cast<int*>(job[4]) + slot;
      if (kind == kSum) {
        atomicAdd(acc, d);
      } else if (kind == kMin) {
        atomicMin(acc, d);
      } else {
        atomicMax(acc, d);
      }
      break;
    }
  }
}

__global__ void hash_agg(const unsigned long long* __restrict__ keys, int k,
                         int n, const uint8_t* __restrict__ valid,
                         unsigned long long* table, int* state,
                         unsigned long long mask, int T,
                         int* __restrict__ counts, int* __restrict__ rep,
                         const long long* __restrict__ jobs, int nj) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (!valid[i]) continue;
    unsigned long long key[kMaxKeys];
    const unsigned long long h = srt::load_key(keys, k, n, i, key);
    const int s = srt::claim_or_find(key, k, h, table, state, mask, T);
    atomicAdd(&counts[s], 1);
    atomicMin(&rep[s], i);
    for (int j = 0; j < nj; ++j) accumulate(jobs + j * kJobFields, i, s);
  }
}

}  // namespace

extern "C" int srt_hash_agg_max_keys() { return kMaxKeys; }

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// keys: (k, n) uint64 images, row-major; valid: n bytes; table: (k, T)
// words of scratch; state: T ints, zeroed; counts: T ints, zeroed; rep: T
// ints set to n; jobs: (nj, 6) int64 job table whose accumulators the caller
// initialized (0 for sum, the type's max for min, its min for max) and whose
// eligible counts are zeroed. T is a power of two above the live key count.
extern "C" int srt_hash_agg(const unsigned long long* keys, int k, int n,
                            const uint8_t* valid, unsigned long long* table,
                            int* state, int T, int* counts, int* rep,
                            const long long* jobs, int nj,
                            cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    hash_agg<<<blocks, kThreads, 0, stream>>>(
        keys, k, n, valid, table, state,
        static_cast<unsigned long long>(T - 1), T, counts, rep, jobs, nj);
  }
  return cudaGetLastError();
}
