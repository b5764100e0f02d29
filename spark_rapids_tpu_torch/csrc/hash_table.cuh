// Open-addressing slot table shared by the hash aggregation (hash_agg.cu,
// B2) and the hash join build and probe (hash_join.cu, B3 and B4).
//
// A key is k 64-bit words (k <= kMaxKeys); the table keeps word j of slot s
// at table[j * T + s] beside one state word per slot. The slot chain of a
// key is (h + p) & (T - 1), p = 0, 1, ..., with h the seeded splitmix64
// chain over the key words: bit-equal to the port's plain versions
// (ops/kernels.py _mix_images) and to the JAX package's _mix_images.
//
// Many threads insert at once and a key is several words, so a slot cannot
// be claimed with one CAS. The state word makes a key appear atomically:
// CAS empty -> claiming, write the key words, __threadfence, publish. A
// reader that finds a slot claiming spins until it is published, then
// compares all k words.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace srt {

constexpr int kMaxKeys = 8;
constexpr unsigned long long kSeed = 0x243F6A8885A308D3ull;
constexpr int kEmpty = 0;
constexpr int kClaiming = 1;
constexpr int kPublished = 2;

__device__ __forceinline__ unsigned long long splitmix64(unsigned long long x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__device__ __forceinline__ int load_state(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// Loads row i's k key words from the (k, n) row-major key array into key[]
// and returns the key's hash.
__device__ __forceinline__ unsigned long long load_key(
    const unsigned long long* __restrict__ keys, int k, int n, int i,
    unsigned long long* key) {
  unsigned long long h = kSeed;
  for (int j = 0; j < k; ++j) {
    key[j] = keys[static_cast<size_t>(j) * n + i];
    h = splitmix64(h ^ key[j]);
  }
  return h;
}

// The slot holding key[] after this call: the first slot of the key's
// chain that already holds it, or the first empty one, which this thread
// claims and publishes. The caller sizes T above the number of distinct
// keys, so the chain always reaches one of the two.
__device__ __forceinline__ int claim_or_find(const unsigned long long* key,
                                             int k, unsigned long long h,
                                             unsigned long long* table,
                                             int* state,
                                             unsigned long long mask, int T) {
  unsigned long long probe = h;
  while (true) {
    const int s = static_cast<int>(probe & mask);
    int st = load_state(&state[s]);
    if (st == kEmpty) {
      st = atomicCAS(&state[s], kEmpty, kClaiming);
      if (st == kEmpty) {
        for (int j = 0; j < k; ++j) {
          table[static_cast<size_t>(j) * T + s] = key[j];
        }
        __threadfence();
        atomicExch(&state[s], kPublished);
        return s;
      }
    }
    while (st == kClaiming) st = load_state(&state[s]);
    __threadfence();
    bool eq = true;
    for (int j = 0; j < k && eq; ++j) {
      eq = load_word(&table[static_cast<size_t>(j) * T + s]) == key[j];
    }
    if (eq) return s;
    ++probe;
  }
}

}  // namespace srt
