// The epoch-index law (SPEC.md §1-§3) as __device__ functions, shared by
// index_kernels.cu and mixture_kernels.cu.  Every operation keeps the order
// of ops/core.py: uint32 wrap-around arithmetic throughout, partner =
// K_r + (m - x) then -m if >= m, the canonical member as an unsigned max by
// select, the decision bit mix32(c ^ key2 ^ r*RC_BIT) & 1, m <= 1 returns x.
//
// The build of each source hashes this header too (ops/cuda_kernel.py
// library_path), so an edit here rebuilds both libraries.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t RC_BIT = 0x7FEB352Du;
constexpr uint32_t C_SEED_HI = 0x85EBCA6Bu;
constexpr uint32_t C_EPOCH = 0xC2B2AE35u;
constexpr uint32_t C_OUTER = 0xA5A5A5A5u;
constexpr uint32_t C_INNER = 0x5A5A5A5Au;
constexpr uint32_t C_TAIL = 0x3C3C3C3Cu;
constexpr uint32_t C_WIN = 0x27D4EB2Fu;
constexpr uint32_t C_BIT = 0x94D049BBu;
constexpr uint32_t C_PAIR = 0x165667B1u;

constexpr uint32_t INT32_MAX_U = 0x7FFFFFFFu;
// The most swap-or-not rounds any kernel takes (ops/cuda_kernel.py
// MAX_ROUNDS is the same number): the index kernels hold three schedules of
// `rounds` words in dynamic shared memory, 48 KB at 4,096 rounds beside the
// amortized kernel's 16 KB of window ids, within the 227 KB a block may
// use.  SPEC.md §2 cites ~102 and ~121 rounds for the production domains.
constexpr int MAX_ROUNDS = 4096;
// Up to this many rounds the index kernels keep their schedules in fixed
// shared arrays (the compiler then addresses them as constants).
constexpr int STATIC_ROUNDS = 64;
// Shared memory a block gets without the opt-in attribute.
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The seed half of the epoch key (SPEC.md §1), before the epoch is folded.
__device__ __forceinline__ uint32_t seed_key(uint32_t lo, uint32_t hi) {
  return mix32(mix32(lo ^ GOLDEN) ^ mix32(hi ^ C_SEED_HI));
}

// The epoch key from the seed half: derive_epoch_key((lo, hi), ep).
__device__ __forceinline__ uint32_t epoch_key(uint32_t seed_k, uint32_t ep) {
  return mix32(seed_k ^ mix32(ep ^ C_EPOCH));
}

// Per-source-window key of the inner bijection.
__device__ __forceinline__ uint32_t inner_key(uint32_t ek, uint32_t wid) {
  return mix32(ek ^ C_INNER ^ mix32(wid ^ C_WIN));
}

// The pairing constant K_r = mix32(pair ^ r*GOLDEN) mod m of round r.  A
// domain of m <= 1 never reads its schedule (swap_or_not returns x), so it
// is 0 there and m = 0 never divides.
__device__ __forceinline__ uint32_t round_key(uint32_t pair, uint32_t m,
                                              int r) {
  return m > 1 ? mix32(pair ^ ((uint32_t)r * GOLDEN)) % m : 0u;
}

// Block-cooperative: K_r for r < rounds into `ks`.
__device__ __forceinline__ void load_round_keys(uint32_t *ks, uint32_t pair,
                                                uint32_t m, int rounds) {
  for (int r = threadIdx.x; r < rounds; r += blockDim.x)
    ks[r] = round_key(pair, m, r);
}

// The decision key of a bijection as its rounds read it.
__device__ __forceinline__ uint32_t decision_key2(uint32_t key) {
  return mix32(key ^ C_BIT);
}

// Swap-or-not keyed bijection on [0, m) with the decision key already
// mixed (`key2 = decision_key2(key)`), pairing constants `ks`: the round
// loop alone, for callers that derive key2 once for many elements.
__device__ __forceinline__ uint32_t swap_or_not_k2(uint32_t x, uint32_t m,
                                                   const uint32_t *ks,
                                                   uint32_t key2,
                                                   int rounds) {
  if (m <= 1) return x;
  for (int r = 0; r < rounds; ++r) {
    uint32_t partner = ks[r] + (m - x);
    partner = partner >= m ? partner - m : partner;
    const uint32_t c = x > partner ? x : partner;
    const uint32_t b = mix32(c ^ key2 ^ ((uint32_t)r * RC_BIT));
    x = (b & 1u) ? partner : x;
  }
  return x;
}

// Swap-or-not keyed bijection on [0, m), decision key `key`, pairing
// constants `ks` (SPEC.md §2; ops/core.py swap_or_not).
__device__ __forceinline__ uint32_t swap_or_not(uint32_t x, uint32_t m,
                                                const uint32_t *ks,
                                                uint32_t key, int rounds) {
  if (m <= 1) return x;
  return swap_or_not_k2(x, m, ks, decision_key2(key), rounds);
}

// Floor division by an invariant divisor d >= 1 as a multiply-high
// (Granlund and Montgomery 1994, fig. 4.1): with l = ceil(log2 d), mult =
// floor(2^N (2^l - d) / d) + 1, s1 = min(l, 1), s2 = max(l - 1, 0), every
// N-bit n gives n / d = (t + ((n - t) >> s1)) >> s2, t = mulhi(n, mult).
// The host computes (mult, s1, s2): ops/fastdiv.py.
struct Magic32 {
  uint32_t mult, s1, s2;
};
struct Magic64 {
  uint64_t mult;
  uint32_t s1, s2;
};

__device__ __forceinline__ uint32_t magic_div(uint32_t n, const Magic32 &d) {
  const uint32_t t = __umulhi(n, d.mult);
  return (t + ((n - t) >> d.s1)) >> d.s2;
}

__device__ __forceinline__ uint64_t magic_div(uint64_t n, const Magic64 &d) {
  const uint64_t t = __umul64hi(n, d.mult);
  return (t + ((n - t) >> d.s1)) >> d.s2;
}

// The resident blocks of the card: BLOCKS_PER_SM per SM.
inline uint64_t resident_blocks() {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (uint64_t)sms * BLOCKS_PER_SM;
}

// Blocks for a loop over `blocks` units of block work: one per unit, at
// most the resident blocks.
inline unsigned grid_cap(uint64_t blocks) {
  const uint64_t cap = resident_blocks();
  return (unsigned)(blocks < cap ? blocks : cap);
}

// Blocks for a grid-stride loop over `count` elements: one per THREADS
// elements, at most the resident blocks.
inline unsigned grid_for(uint64_t count) {
  return grid_cap((count + THREADS - 1) / THREADS);
}

}  // namespace
