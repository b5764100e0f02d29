// Hash join table build (B3) and probe (B4) over exact 64-bit key images.
//
// Replaces the TPU kernels spark_rapids_tpu/ops/pallas_kernels.py
// _hash_build_kernel (:335), launched by _hash_build_pallas (:438), and
// _hash_probe_kernel (:391), launched by _hash_probe_pallas (:457); public
// entries hash_table_build (:522) and hash_table_probe (:539), composed by
// hash_join_probe (:553).
//
// The TPU build inserts rows one at a time on a single-step grid with the
// whole table in VMEM, which caps the table at _PALLAS_MAX_TABLE (:476) and
// routes larger tables to the jnp twin (:530-531, :544-545). Its sequential
// walk also yields each row's exact arrival rank within its slot. Here one
// thread takes one row and the table lives in device memory, so no cap
// applies. Claim order is not arrival order, so no rank is returned: the
// caller groups build rows by a stable sort on the slot, as the jnp twin
// does (:581-585). Slot positions differ from the plain version's
// round-based claiming; callers compare the table by key.
//
// What bounds the build on an H100: bytes. The keys and the valid byte read
// once, the slot written once, the T-wide key words and counts initialised
// once, and per valid row two random 32-byte sectors: its key word and its
// count. At Q3's build (T = 2^27, 1.5 GB of table) no sector stays in the
// 50 MB L2, so each further array a row touches costs one more DRAM sector
// read and written back. The one-word build (Q3's and Q4's joins) therefore
// keeps no state array and claims a slot on the word the row touches anyway:
//   * k = 1, build_on_key: the key words are filled with kFill (all ones)
//     and a row claims slot s with one 64-bit CAS kFill -> key. The CAS
//     returns the old word, which settles the slot at once: kFill (claimed),
//     the key (found) or another key (step on); a plain load first spares a
//     key already present the atomic. A word never changes once claimed, so
//     nothing is published and nothing waits. Then one atomicAdd on the
//     count. A row whose image is kFill itself (INT64_MAX's image only)
//     cannot claim that way: it adds to counts[T], and place_fill_key, a
//     second launch that returns at once when counts[T] is 0, gives the
//     key the first slot of its chain still holding kFill, after every
//     other key is placed, so no other key's chain crosses it;
//   * k > 1, build_on_state: a key of several words cannot be claimed with
//     one CAS, so the row claims (or finds) its slot with the claim/publish
//     probe of hash_table.cuh (shared with hash_agg.cu) on a T-wide state
//     array, then adds 1 to the count.
// The probe (B4) is read-only, after the build on the same stream. A row
// follows its chain to an empty slot (absent -> T) or to its key (-> the
// slot); invalid rows get T. Its bound: keys, valid and slot once and one
// random sector per valid row. Since the build leaves kFill in every
// unused key word, a step reads the key word alone: one sector, where
// reading the count first cost two. The join's lookup
// (hash_join_lookup: each stream row's match count and first bperm
// position) runs in the same launch and reads a hit's count and start,
// two more sectors a hit, in place of a slot array and eight launches of
// gathers and selects after the probe.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_table.cuh"

namespace {

using srt::kMaxKeys;
constexpr int kThreads = 256;
constexpr int kFixBlocks = 132 * 2;  // place_fill_key's grid
constexpr unsigned long long kFill = ~0ull;  // key word of an unused slot

__global__ void build_on_key(const unsigned long long* __restrict__ keys,
                             int n, const uint8_t* __restrict__ valid,
                             unsigned long long* table,
                             unsigned long long mask, int T,
                             int* __restrict__ counts,
                             int* __restrict__ slot) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (!valid[i]) {
      slot[i] = T;
      continue;
    }
    unsigned long long key;
    unsigned long long probe = srt::load_key(keys, 1, n, i, &key);
    if (key == kFill) {  // placed by place_fill_key
      atomicAdd(&counts[T], 1);
      continue;
    }
    int s;
    while (true) {
      s = static_cast<int>(probe & mask);
      unsigned long long w = __ldcg(&table[s]);
      if (w == kFill) w = atomicCAS(&table[s], kFill, key);
      if (w == kFill || w == key) break;
      ++probe;
    }
    atomicAdd(&counts[s], 1);
    slot[i] = s;
  }
}

// The counts[T] rows whose image is kFill take the first slot of kFill's
// chain still holding kFill. Every other key is placed by then, so the
// chain up to that slot is final, and a probe for any other key stopped
// before it.
__global__ void place_fill_key(const unsigned long long* __restrict__ keys,
                               int n, const uint8_t* __restrict__ valid,
                               const unsigned long long* __restrict__ table,
                               unsigned long long mask, int T, int* counts,
                               int* __restrict__ slot) {
  const int m = counts[T];
  if (m == 0) return;
  const unsigned long long fill = kFill;
  unsigned long long word;
  unsigned long long probe = srt::load_key(&fill, 1, 1, 0, &word);
  while (table[probe & mask] != kFill) ++probe;
  const int s = static_cast<int>(probe & mask);
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[s] = m;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (valid[i] && keys[i] == kFill) slot[i] = s;
  }
}

__global__ void build_on_state(const unsigned long long* __restrict__ keys,
                               int k, int n,
                               const uint8_t* __restrict__ valid,
                               unsigned long long* table, int* state,
                               unsigned long long mask, int T,
                               int* __restrict__ counts,
                               int* __restrict__ slot) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (!valid[i]) {
      slot[i] = T;
      continue;
    }
    unsigned long long key[kMaxKeys];
    const unsigned long long h = srt::load_key(keys, k, n, i, key);
    const int s = srt::claim_or_find(
        key, k, h, srt::Slots{table, static_cast<size_t>(T), 1, state, 1},
        mask);
    atomicAdd(&counts[s], 1);
    slot[i] = s;
  }
}

// The slot of row i's key in a table that build_on_key or build_on_state
// built, or T where it is absent. Precondition: the table was built on the
// card, so every unused slot's key words hold kFill; a table whose unused
// words hold 0 (the plain build's) would give key image 0 a false hit.
// A chain step reads the slot's word 0 first: for k = 1 it settles the
// step alone (the key: a hit; kFill: the empty slot that ends the chain;
// another word: step on). Only a probe for a key that holds kFill reads
// counts[s], where its word says "maybe empty": at k = 1 the kFill key has
// the first kFill slot of its chain (place_fill_key) or is absent.
__device__ __forceinline__ int find_slot(
    const unsigned long long* __restrict__ table,
    const int* __restrict__ counts,
    const unsigned long long* __restrict__ keys, int k, int n, int i,
    unsigned long long mask, int T) {
  unsigned long long key[kMaxKeys];
  unsigned long long probe = srt::load_key(keys, k, n, i, key);
  if (k == 1) {
    while (true) {
      const int s = static_cast<int>(probe & mask);
      const unsigned long long w = table[s];
      if (w == key[0]) {
        return key[0] != kFill || counts[s] > 0 ? s : T;
      }
      if (w == kFill) return T;
      ++probe;
    }
  }
  while (true) {
    const int s = static_cast<int>(probe & mask);
    const unsigned long long w = table[s];
    if (w == kFill && counts[s] == 0) return T;  // an empty slot
    if (w == key[0]) {
      bool eq = true;
      for (int j = 1; j < k && eq; ++j) {
        eq = table[static_cast<size_t>(j) * T + s] == key[j];
      }
      if (eq) return s;
    }
    ++probe;
  }
}

// kLookup = false: slot[i] = the slot of row i's key, T where it is absent
// or the row invalid. kLookup = true (hash_join_lookup): match[i] =
// counts[s] and first[i] = starts[s] at a hit, both 0 otherwise; counts
// and starts are read only at a hit and no slot is written.
template <bool kLookup>
__global__ void hash_probe(const unsigned long long* __restrict__ table,
                           const int* __restrict__ counts,
                           const int* __restrict__ starts,
                           const unsigned long long* __restrict__ keys, int k,
                           int n, const uint8_t* __restrict__ valid,
                           unsigned long long mask, int T,
                           int* __restrict__ slot, int* __restrict__ match,
                           int* __restrict__ first) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int s = valid[i] ? find_slot(table, counts, keys, k, n, i, mask, T)
                           : T;
    if (kLookup) {
      const bool hit = s < T;
      match[i] = hit ? counts[s] : 0;
      first[i] = hit ? starts[s] : 0;
    } else {
      slot[i] = s;
    }
  }
}

}  // namespace

extern "C" int srt_hash_join_max_keys() { return kMaxKeys; }

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// keys: (k, n) uint64 images, row-major; valid: n bytes; table: (k, T)
// words, every one kFill; state: T ints, zeroed, for k > 1 (unused, and may
// be null, for k = 1); counts: T + 1 ints, zeroed (counts[T] is scratch);
// slot: n ints. T is a power of two above the valid row count.
extern "C" int srt_hash_build(const unsigned long long* keys, int k, int n,
                              const uint8_t* valid, unsigned long long* table,
                              int* state, int T, int* counts, int* slot,
                              cudaStream_t stream) {
  if (k < 1 || k > kMaxKeys || (k > 1 && state == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (n <= 0) return cudaSuccess;
  const int blocks = (n + kThreads - 1) / kThreads;
  const unsigned long long mask = static_cast<unsigned long long>(T - 1);
  if (k == 1) {
    build_on_key<<<blocks, kThreads, 0, stream>>>(keys, n, valid, table,
                                                  mask, T, counts, slot);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    place_fill_key<<<blocks < kFixBlocks ? blocks : kFixBlocks, kThreads, 0,
                     stream>>>(keys, n, valid, table, mask, T, counts, slot);
  } else {
    build_on_state<<<blocks, kThreads, 0, stream>>>(
        keys, k, n, valid, table, state, mask, T, counts, slot);
  }
  return cudaGetLastError();
}

// table, counts: a build's outputs; keys: (k, n) stream images; valid: n
// bytes. With starts (each slot's first bperm position) null: slot, n ints
// (match and first unused). Otherwise the lookup: match and first, n ints
// each (slot unused).
extern "C" int srt_hash_probe(const unsigned long long* table,
                              const int* counts, const int* starts,
                              const unsigned long long* keys, int k, int n,
                              const uint8_t* valid, int T, int* slot,
                              int* match, int* first, cudaStream_t stream) {
  if (k < 1 || k > kMaxKeys) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const int blocks = (n + kThreads - 1) / kThreads;
  const unsigned long long mask = static_cast<unsigned long long>(T - 1);
  if (starts == nullptr) {
    hash_probe<false><<<blocks, kThreads, 0, stream>>>(
        table, counts, nullptr, keys, k, n, valid, mask, T, slot, nullptr,
        nullptr);
  } else {
    hash_probe<true><<<blocks, kThreads, 0, stream>>>(
        table, counts, starts, keys, k, n, valid, mask, T, nullptr, match,
        first);
  }
  return cudaGetLastError();
}
