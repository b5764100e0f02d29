// Open-addressing slot table shared by the hash aggregation (hash_agg.cu,
// B2) and the hash join build and probe (hash_join.cu, B3 and B4).
//
// A key is k 64-bit words (k <= kMaxKeys). The slot chain of a key is
// (h + p) & (T - 1), p = 0, 1, ..., with h the seeded splitmix64 chain over
// the key words: bit-equal to the port's plain versions (ops/kernels.py
// _mix_images) and to the JAX package's _mix_images.
//
// Where a key is more words than one CAS covers (k > 1 in the join build,
// k > 2 in the aggregation), the claim/publish probe (claim_or_find) keeps
// one state word per slot and makes a key appear atomically: CAS empty ->
// claiming, write the key words, __threadfence, publish. A reader that
// finds a slot claiming spins until it is published, then compares all k
// words. A Slots value says where a slot's words and state lie: the join
// build keeps word j of slot s at table[j * T + s] and the states in an
// array of their own; the aggregation keeps both in the slot's record.
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

// Where claim_or_find finds slot s's key words and state: word j at
// table[j * word + s * slot], the state at state[s * state_slot] (strides
// in elements).
struct Slots {
  unsigned long long* table;
  size_t word, slot;
  int* state;
  size_t state_slot;
};

// The slot holding key[] after this call: the first slot of the key's
// chain that already holds it, or the first empty one, which this thread
// claims and publishes. The caller sizes T above the number of distinct
// keys, so the chain always reaches one of the two.
__device__ __forceinline__ int claim_or_find(const unsigned long long* key,
                                             int k, unsigned long long h,
                                             const Slots& t,
                                             unsigned long long mask) {
  unsigned long long probe = h;
  while (true) {
    const int s = static_cast<int>(probe & mask);
    unsigned long long* words = t.table + s * t.slot;
    int* state = t.state + s * t.state_slot;
    int st = load_state(state);
    if (st == kEmpty) {
      st = atomicCAS(state, kEmpty, kClaiming);
      if (st == kEmpty) {
        for (int j = 0; j < k; ++j) words[j * t.word] = key[j];
        __threadfence();
        atomicExch(state, kPublished);
        return s;
      }
    }
    while (st == kClaiming) st = load_state(state);
    __threadfence();
    bool eq = true;
    for (int j = 0; j < k && eq; ++j) {
      eq = load_word(&words[j * t.word]) == key[j];
    }
    if (eq) return s;
    ++probe;
  }
}

}  // namespace srt
