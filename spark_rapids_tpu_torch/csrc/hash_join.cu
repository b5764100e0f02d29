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
// applies:
//   * build: every valid row claims (or finds) its key's slot with the
//     claim/publish probe of hash_table.cuh (shared with hash_agg.cu), then
//     atomicAdd's the slot's count. Claim order is not arrival order, so no
//     rank is returned: the caller groups build rows by a stable sort on the
//     slot, as the jnp twin does (:581-585);
//   * probe: read-only, after the build on the same stream. A row follows
//     its chain to a slot whose count is 0 (absent -> T) or whose words
//     equal its key (-> the slot). Invalid rows get T.
// Slot positions differ from the plain version's round-based claiming;
// callers compare the table by key.
// What bounds them on an H100: bytes. Build: keys and the valid byte read
// once, the slot written once, the T-wide state, count and key words
// initialised once, and per valid row one random 32-byte sector for the
// claim or compare and one for the count. Probe: keys, valid and slot once
// and one random sector per valid row. The layout keeps the state, the
// count and each key word in arrays of their own, so a row pays about k + 1
// sectors where the bound counts one; packing a slot is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_table.cuh"

namespace {

using srt::kMaxKeys;
constexpr int kThreads = 256;

__global__ void hash_build(const unsigned long long* __restrict__ keys, int k,
                           int n, const uint8_t* __restrict__ valid,
                           unsigned long long* table, int* state,
                           unsigned long long mask, int T,
                           int* __restrict__ counts, int* __restrict__ slot) {
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
// words, zeroed; state: T ints, zeroed; counts: T ints, zeroed; slot: n
// ints. T is a power of two above the valid row count.
extern "C" int srt_hash_build(const unsigned long long* keys, int k, int n,
                              const uint8_t* valid, unsigned long long* table,
                              int* state, int T, int* counts, int* slot,
                              cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    hash_build<<<blocks, kThreads, 0, stream>>>(
        keys, k, n, valid, table, state,
        static_cast<unsigned long long>(T - 1), T, counts, slot);
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
