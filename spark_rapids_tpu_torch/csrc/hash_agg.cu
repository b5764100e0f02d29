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
//   * count: atomicAdd; rep: atomicMin of the row index, which is the first
//     arrival (the jnp twin's segment_min, :738-739);
//   * per job, where eligible: the eligible count, then sum by atomicAdd
//     (int64 as unsigned wrap-around, float64 native), integer min/max by
//     atomicMin/atomicMax, float64 min/max by a CAS loop (NaN wins).
// Slot order and the order of float additions differ from the TPU kernel;
// callers compact used slots and compare groups by key.
//
// What bounds it on an H100: bytes, dominated by the random 32-byte sectors
// a live row touches in the table. With a large table (Q18's partial: 2^23
// slots, 3.8M groups) no sector stays in the 50 MB L2, so every array a row
// touches costs one DRAM sector read and written back. So each slot is one
// record holding everything a row updates: its k key words, count, rep and
// each job's accumulator and eligible count (the wrapper's layout, 8-byte
// fields first, a stride that is a multiple of 16 bytes). At Q18's shape
// (k = 2, one float64 sum) that is 36 bytes at a 48-byte stride: two
// sectors a row, where key words, state, count, rep, accumulator and
// eligible count in arrays of their own cost seven.
//
// The claim:
//   * k <= 2, agg_on_key: every record's key words start as kFill (all
//     ones) and a row claims its slot with one CAS of all its key words,
//     64-bit at k = 1, 16-byte at k = 2, from the fill to its key. The CAS
//     returns the old words, which settle the slot at once: the fill
//     (claimed), the key (found) or another key (step on). A key never
//     changes once claimed, so nothing is published and nothing waits: no
//     state word, no fence. A load first spares a key already present the
//     atomic; a loaded record with a kFill word may be torn and goes to the
//     CAS. A row whose key is all fill words cannot claim that way: it
//     folds into the spare record T, and place_fill_key, a one-thread
//     launch that returns at once when that record is unused, moves the
//     spare's count, rep and accumulators into the first slot of that key's
//     chain still holding the fill, after every other key is placed (as
//     hash_join.cu's place_fill_key does), without a second pass over the
//     rows;
//   * k > 2, agg_on_state: the claim/publish probe of hash_table.cuh on a
//     state word kept in the record beside the key words.
// The fill launch writes every record's initial pattern (the wrapper's
// template: the fill, rep = n, each accumulator's neutral, zero counts).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_table.cuh"

namespace {

using srt::kMaxKeys;
using srt::load_word;
constexpr int kThreads = 256;
constexpr int kFillBlocks = 132 * 8;  // fill_records' grid
constexpr int kMaxJobs = 16;
// the largest record: 8 key words, the state word (8 bytes with its pad),
// and per job an 8-byte accumulator and an eligible count, then count and
// rep: 272 bytes
constexpr int kMaxRecordWords = 34;
constexpr unsigned long long kFill = ~0ull;  // key word of an unused slot
enum Kind { kSum = 0, kMin = 1, kMax = 2 };
enum Dtype { kI64 = 0, kF64 = 1, kI32 = 2 };

struct AggJob {
  const void* data;
  const uint8_t* elig;
  int kind, dtype;
  int acc, nel;  // byte offsets in the record
};

// Everything a launch needs, by value (no descriptor copy to the card);
// 16-byte aligned for fill_records' loads of init.
struct alignas(16) AggArgs {
  unsigned long long init[kMaxRecordWords];  // a record's initial pattern
  const unsigned long long* keys[kMaxKeys];
  AggJob job[kMaxJobs];
  const uint8_t* valid;
  unsigned char* rec;  // T + 1 records; record T is the spare
  unsigned long long mask;
  int n, k, T, nj;
  int stride;              // bytes, a multiple of 16
  int state, count, rep;   // byte offsets; state < 0 for k <= 2
};

__device__ __forceinline__ unsigned char* record(const AggArgs& a, int s) {
  return a.rec + static_cast<size_t>(s) * a.stride;
}

__device__ __forceinline__ unsigned long long hash_of(
    const unsigned long long* key, int k) {
  unsigned long long h = srt::kSeed;
  for (int j = 0; j < k; ++j) h = srt::splitmix64(h ^ key[j]);
  return h;
}

__global__ void fill_records(const __grid_constant__ AggArgs a) {
  const int q = a.stride / 16;  // 16-byte chunks a record
  const long long chunks = static_cast<long long>(a.T + 1) * q;
  const uint4* init = reinterpret_cast<const uint4*>(a.init);
  uint4* out = reinterpret_cast<uint4*>(a.rec);
  for (long long c = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       c < chunks; c += static_cast<long long>(gridDim.x) * blockDim.x) {
    out[c] = init[c % q];
  }
}

// min (want_less) or max of a float64 accumulator; NaN is sticky, as in the
// segment ops of the plain version
__device__ void atomic_minmax_f64(double* addr, double v, bool want_less) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = load_word(p);
  while (true) {
    double cur = __longlong_as_double(static_cast<long long>(old));
    if (isnan(cur)) return;
    bool better = isnan(v) || (want_less ? v < cur : v > cur);
    if (!better) return;
    unsigned long long prev = atomicCAS(
        p, old, static_cast<unsigned long long>(__double_as_longlong(v)));
    if (prev == old) return;
    old = prev;
  }
}

// Row i's count, rep and eligible jobs, folded into record r.
__device__ void update(const AggArgs& a, unsigned char* r, int i) {
  atomicAdd(reinterpret_cast<int*>(r + a.count), 1);
  atomicMin(reinterpret_cast<int*>(r + a.rep), i);
  for (int j = 0; j < a.nj; ++j) {
    const AggJob& job = a.job[j];
    if (!job.elig[i]) continue;
    atomicAdd(reinterpret_cast<int*>(r + job.nel), 1);
    switch (job.dtype) {
      case kI64: {
        const long long d = static_cast<const long long*>(job.data)[i];
        long long* acc = reinterpret_cast<long long*>(r + job.acc);
        if (job.kind == kSum) {
          atomicAdd(reinterpret_cast<unsigned long long*>(acc),
                    static_cast<unsigned long long>(d));
        } else if (job.kind == kMin) {
          atomicMin(acc, d);
        } else {
          atomicMax(acc, d);
        }
        break;
      }
      case kF64: {
        const double d = static_cast<const double*>(job.data)[i];
        double* acc = reinterpret_cast<double*>(r + job.acc);
        if (job.kind == kSum) {
          atomicAdd(acc, d);
        } else {
          atomic_minmax_f64(acc, d, job.kind == kMin);
        }
        break;
      }
      default: {  // kI32
        const int d = static_cast<const int*>(job.data)[i];
        int* acc = reinterpret_cast<int*>(r + job.acc);
        if (job.kind == kSum) {
          atomicAdd(acc, d);
        } else if (job.kind == kMin) {
          atomicMin(acc, d);
        } else {
          atomicMax(acc, d);
        }
        break;
      }
    }
  }
}

// The slot of a key of K <= 2 words, claimed on the key words; T for the
// all-fill key (the spare record).
template <int K>
__device__ __forceinline__ int claim_on_key(const AggArgs& a,
                                            const unsigned long long* key,
                                            unsigned long long probe) {
  if (key[0] == kFill && (K == 1 || key[1] == kFill)) return a.T;
  while (true) {
    const int s = static_cast<int>(probe & a.mask);
    unsigned long long* w = reinterpret_cast<unsigned long long*>(
        record(a, s));
    if (K == 1) {
      unsigned long long cur = __ldcg(w);
      if (cur == kFill) cur = atomicCAS(w, kFill, key[0]);
      if (cur == kFill || cur == key[0]) return s;
    } else {
      const ulonglong2 seen = __ldcg(reinterpret_cast<const ulonglong2*>(w));
      unsigned long long c0 = seen.x, c1 = seen.y;
      if (c0 == kFill || c1 == kFill) {
        const unsigned __int128 fill = ~static_cast<unsigned __int128>(0);
        const unsigned __int128 old = atomicCAS(
            reinterpret_cast<unsigned __int128*>(w), fill,
            (static_cast<unsigned __int128>(key[1]) << 64) | key[0]);
        c0 = static_cast<unsigned long long>(old);
        c1 = static_cast<unsigned long long>(old >> 64);
      }
      if ((c0 == kFill && c1 == kFill) || (c0 == key[0] && c1 == key[1])) {
        return s;
      }
    }
    ++probe;
  }
}

template <int K>
__global__ void agg_on_key(const __grid_constant__ AggArgs a) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += gridDim.x * blockDim.x) {
    if (!a.valid[i]) continue;
    unsigned long long key[K];
    for (int j = 0; j < K; ++j) key[j] = a.keys[j][i];
    const int s = claim_on_key<K>(a, key, hash_of(key, K));
    update(a, record(a, s), i);
  }
}

__global__ void agg_on_state(const __grid_constant__ AggArgs a) {
  const srt::Slots slots{reinterpret_cast<unsigned long long*>(a.rec), 1,
                         static_cast<size_t>(a.stride / 8),
                         reinterpret_cast<int*>(a.rec + a.state),
                         static_cast<size_t>(a.stride / 4)};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += gridDim.x * blockDim.x) {
    if (!a.valid[i]) continue;
    unsigned long long key[kMaxKeys];
    for (int j = 0; j < a.k; ++j) key[j] = a.keys[j][i];
    const int s = srt::claim_or_find(key, a.k, hash_of(key, a.k), slots,
                                     a.mask);
    update(a, record(a, s), i);
  }
}

// The spare record's rows (the all-fill key) take the first slot of that
// key's chain still holding the fill. Every other key is placed by then,
// so the chain up to that slot is final and no other key's chain crosses
// it. The slot's key words are the key already; the rest of the spare
// record (count, rep, accumulators) moves in.
__global__ void place_fill_key(const __grid_constant__ AggArgs a) {
  const unsigned long long* spare =
      reinterpret_cast<const unsigned long long*>(record(a, a.T));
  if (reinterpret_cast<const int*>(record(a, a.T) + a.count)[0] == 0) return;
  unsigned long long key[2] = {kFill, kFill};
  unsigned long long probe = hash_of(key, a.k);
  const unsigned long long* w;
  while (true) {
    w = reinterpret_cast<const unsigned long long*>(
        record(a, static_cast<int>(probe & a.mask)));
    if (w[0] == kFill && (a.k == 1 || w[1] == kFill)) break;
    ++probe;
  }
  unsigned long long* dst = const_cast<unsigned long long*>(w);
  for (int j = a.k; j < a.stride / 8; ++j) dst[j] = spare[j];
}

}  // namespace

extern "C" int srt_hash_agg_max_keys() { return kMaxKeys; }

extern "C" int srt_hash_agg_max_jobs() { return kMaxJobs; }

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// desc, int64: n, k, T, nj, valid, rec, stride, state, count, rep (byte
// offsets in a record, state -1 for k <= 2), then the k key pointers (each
// n uint64 images), then nj rows of {kind, dtype, data, eligible (n bytes),
// acc offset, nel offset}, then stride / 8 words: a record's initial
// pattern. rec: (T + 1) * stride bytes, 16-byte aligned. T is a power of
// two above the live key count. Three launches: the fill, the rows, and
// (k <= 2) place_fill_key.
extern "C" int srt_hash_agg(const long long* desc, cudaStream_t stream) {
  AggArgs a;
  a.n = static_cast<int>(desc[0]);
  a.k = static_cast<int>(desc[1]);
  a.T = static_cast<int>(desc[2]);
  a.nj = static_cast<int>(desc[3]);
  a.valid = reinterpret_cast<const uint8_t*>(desc[4]);
  a.rec = reinterpret_cast<unsigned char*>(desc[5]);
  a.stride = static_cast<int>(desc[6]);
  a.state = static_cast<int>(desc[7]);
  a.count = static_cast<int>(desc[8]);
  a.rep = static_cast<int>(desc[9]);
  a.mask = static_cast<unsigned long long>(a.T - 1);
  if (a.k < 1 || a.k > kMaxKeys || a.nj < 0 || a.nj > kMaxJobs ||
      a.stride <= 0 || a.stride % 16 || a.stride > 8 * kMaxRecordWords ||
      (a.k > 2) != (a.state >= 0) || (desc[5] & 15)) {
    return cudaErrorInvalidValue;
  }
  const long long* p = desc + 10;
  for (int j = 0; j < a.k; ++j) {
    a.keys[j] = reinterpret_cast<const unsigned long long*>(*p++);
  }
  for (int j = 0; j < a.nj; ++j, p += 6) {
    a.job[j] = AggJob{reinterpret_cast<const void*>(p[2]),
                      reinterpret_cast<const uint8_t*>(p[3]),
                      static_cast<int>(p[0]), static_cast<int>(p[1]),
                      static_cast<int>(p[4]), static_cast<int>(p[5])};
  }
  for (int j = 0; j < a.stride / 8; ++j) {
    a.init[j] = static_cast<unsigned long long>(p[j]);
  }
  const long long chunks = static_cast<long long>(a.T + 1) * (a.stride / 16);
  const long long fill_blocks = (chunks + kThreads - 1) / kThreads;
  fill_records<<<fill_blocks < kFillBlocks ? static_cast<int>(fill_blocks)
                                           : kFillBlocks,
                 kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n <= 0) return err;
  const int blocks = (a.n + kThreads - 1) / kThreads;
  if (a.k == 1) {
    agg_on_key<1><<<blocks, kThreads, 0, stream>>>(a);
  } else if (a.k == 2) {
    agg_on_key<2><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    agg_on_state<<<blocks, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  place_fill_key<<<1, 1, 0, stream>>>(a);
  return cudaGetLastError();
}
