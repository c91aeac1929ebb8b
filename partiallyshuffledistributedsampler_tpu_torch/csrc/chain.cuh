// The elastic reshard chain (SPEC.md §6) as __device__ functions, shared by
// index_kernels.cu (index_positions) and sampling_kernels.cu
// (weighted_stream): an ordinal q over the innermost remainder is mapped
// out through the reshard layers, innermost first, each followed by a mod
// (the next layer's remaining count, and the epoch's length after the
// outermost).  A layer maps
//   strided: q -> q + consumed*world
//   blocked: q -> (q / gap)*ns + consumed + q % gap,  gap = ns - consumed
// in Pos arithmetic: uint32 positions wrap at 2^32 as the reference's
// uint32 ones do (the host refuses narrow constants of 2^32 or more, as the
// reference's uint32 casts do), uint64 ones do not wrap.  Every / and % is a
// multiply-high by the divisor's magic number (law.cuh magic_div), in 32
// or 64 bits by Pos; the host computes the divisors and their magic numbers
// once per chain (ops/cuda_kernel.py chain_table).
//
// Where the chain lives: a table of LAYER_WORDS uint64 words a layer in
// device memory, built once per chain and cached by the caller, so a regen
// copies nothing to the card.  A chain has no depth limit: a block stages
// its first STAGE_LAYERS layers (4 KB) in shared memory beside the
// schedules, and a deeper layer is read through the read-only cache, the
// same address for every lane of a warp.  One layer costs a lane 7
// (strided) to 14 (blocked) operations against the hundreds of its
// bijection rounds, so the chain hardly moves the bound; launch arguments
// would have capped the depth.
//
// The build of each source that includes it hashes this header too
// (ops/cuda_kernel.py library_path).

#pragma once

#include "law.cuh"

namespace {

constexpr int LAYER_WORDS = 8;
enum LayerWord : int {
  L_ADD,         // consumed*world (strided) or consumed (blocked)
  L_NS,          // the layer's num_samples (blocked)
  L_GAP,         // ns - consumed (blocked)
  L_GAP_MULT,    // its magic multiplier
  L_GAP_SHIFT,   // s1 | s2 << 8
  L_MOD,         // the modulus after the layer
  L_MOD_MULT,
  L_MOD_SHIFT,
};
constexpr uint32_t STAGE_LAYERS = 64;

// x / d for a divisor given by its magic multiplier and packed shifts.
template <typename Pos>
__device__ __forceinline__ Pos quotient(Pos x, uint64_t mult,
                                        uint64_t shift) {
  const uint32_t s1 = (uint32_t)shift & 0xFFu, s2 = (uint32_t)(shift >> 8);
  if constexpr (sizeof(Pos) == 4) {
    return magic_div((uint32_t)x, Magic32{(uint32_t)mult, s1, s2});
  } else {
    return magic_div((uint64_t)x, Magic64{mult, s1, s2});
  }
}

template <typename Pos>
__device__ __forceinline__ Pos remainder(Pos x, uint64_t d, uint64_t mult,
                                         uint64_t shift) {
  return x - quotient<Pos>(x, mult, shift) * (Pos)d;
}

// Block-cooperative: the chain's first STAGE_LAYERS layers into `staged`
// (STAGE_LAYERS * LAYER_WORDS words); the caller waits at a barrier
// before reading them.
__device__ __forceinline__ void stage_layers(uint64_t *staged,
                                             const uint64_t *layers,
                                             uint32_t depth) {
  const uint32_t nstaged = depth < STAGE_LAYERS ? depth : STAGE_LAYERS;
  const unsigned long long *src = (const unsigned long long *)layers;
  for (uint32_t i = threadIdx.x; i < nstaged * LAYER_WORDS; i += blockDim.x)
    staged[i] = __ldg(src + i);
}

// q (already mod the innermost remaining count) mapped out through the
// `depth` layers of the table `layers` (innermost first), the first
// STAGE_LAYERS of them read from `staged`.
template <typename Pos>
__device__ __forceinline__ Pos compose_chain(Pos q, const uint64_t *staged,
                                             const uint64_t *layers,
                                             uint32_t depth, bool strided) {
  for (uint32_t i = 0; i < depth; ++i) {
    const uint64_t *L = i < STAGE_LAYERS ? staged + i * LAYER_WORDS : nullptr;
    auto word = [&](int f) -> uint64_t {
      return L != nullptr
                 ? L[f]
                 : (uint64_t)__ldg((const unsigned long long *)layers +
                                   (uint64_t)i * LAYER_WORDS + f);
    };
    if (strided) {
      q = q + (Pos)word(L_ADD);
    } else {
      const Pos qd = quotient<Pos>(q, word(L_GAP_MULT), word(L_GAP_SHIFT));
      q = qd * (Pos)word(L_NS) + (Pos)word(L_ADD) + (q - qd * (Pos)word(L_GAP));
    }
    q = remainder<Pos>(q, word(L_MOD), word(L_MOD_MULT), word(L_MOD_SHIFT));
  }
  return q;
}

}  // namespace
