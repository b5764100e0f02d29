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
// The probe (B4) reads counts[s] == 0 as an empty slot and compares the k
// words otherwise: read-only, after the build on the same stream. A row
// follows its chain to an empty slot (absent -> T) or to its key (-> the
// slot). Invalid rows get T. Probe bound: keys, valid and slot once and one
// random sector per valid row; its layout (key words and count in arrays
// of their own) costs k + 1 sectors a row.
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
    const int s = srt::claim_or_find(key, k, h, table, state, mask, T);
    atomicAdd(&counts[s], 1);
    slot[i] = s;
  }
}

__global__ void hash_probe(const unsigned long long* __restrict__ table,
                           const int* __restrict__ counts,
                           const unsigned long long* __restrict__ keys, int k,
                           int n, const uint8_t* __restrict__ valid,
                           unsigned long long mask, int T,
                           int* __restrict__ slot) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    int out = T;
    if (valid[i]) {
      unsigned long long key[kMaxKeys];
      unsigned long long probe = srt::load_key(keys, k, n, i, key);
      while (true) {
        const int s = static_cast<int>(probe & mask);
        if (counts[s] == 0) break;  // an empty slot ends the chain
        bool eq = true;
        for (int j = 0; j < k && eq; ++j) {
          eq = table[static_cast<size_t>(j) * T + s] == key[j];
        }
        if (eq) {
          out = s;
          break;
        }
        ++probe;
      }
    }
    slot[i] = out;
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
// bytes; slot: n ints.
extern "C" int srt_hash_probe(const unsigned long long* table,
                              const int* counts,
                              const unsigned long long* keys, int k, int n,
                              const uint8_t* valid, int T, int* slot,
                              cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    hash_probe<<<blocks, kThreads, 0, stream>>>(
        table, counts, keys, k, n, valid,
        static_cast<unsigned long long>(T - 1), T, slot);
  }
  return cudaGetLastError();
}
