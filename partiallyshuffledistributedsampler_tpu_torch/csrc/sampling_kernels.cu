// Hand-written CUDA kernel for the weighted (alias-table) stream on Hopper.
//
//   weighted_stream       -> replaces the XLA program of the JAX package
//   weighted_stream_wide     partiallyshuffledistributedsampler_tpu/sampling/
//                            alias.py weighted_stream_at_generic (under
//                            weighted_epoch_indices_jax and
//                            weighted_elastic_indices_jax): one thread per
//                            draw ordinal, the whole alias law per lane.
//
// What one lane computes (alias.py weighted_stream_at_generic, draw for
// draw): the epoch key ek from the seed and the epoch (law.cuh seed_key,
// epoch_key), with a dedup retry round folded in when retry != 0; the base
// hash of the ordinal's low and high words; the column draw j = h % S; the
// accept draw (a 32-bit hash % total, or a 64-bit word % total when total
// passes 2^31 - 1) against the column's threshold, else its alias; the
// local draw inside the chosen source (32-bit % n_j, or a 64-bit word when
// a source passes 2^31 - 1); for a lane in the source's full windows, the
// in-window offset through swap_or_not(off, W, ks, inner_key(eks_j, win))
// with the pairing constants ks of inner_pair_key(ek) and eks_j =
// mix32(ek ^ mix32(j ^ C_SRC)); the source's first id plus the local id.
//
// Where the ordinals come from (the template parameter kSrc):
//   SRC_RANK    the rank's strided or blocked positions, mod the epoch
//               length T (uint32 positions wrap at 2^32 first, as the
//               reference's do);
//   SRC_CHAIN   the elastic remainder: the rank's positions over the
//               innermost remaining count, mapped out through the reshard
//               chain (chain.cuh, the table index_positions reads), whose
//               outermost modulus is T;
//   SRC_BUFFER  an int64 buffer read as uint64 bits (random access, the
//               wide kernel only), taken as given.
// The narrow form takes uint32 ordinals (T < 2^31), the wide form uint64;
// an ordinal below 2^32 gives the same id in both (its high word is 0).
// Ids are int32, or int64 once the sources total 2^31 or more.
//
// What bounds it: integer operations, not bytes.  A lane runs `rounds`
// (24) swap-or-not rounds of ~13 int32 operations and ~110 more (ten to
// twelve mix32 hashes, four or five magic-number divisions, the table
// reads, the combine; chip_smoke.py W_*_OPS counts them); it reads two
// table columns (from shared memory or the L1) and writes 4 or 8 bytes.
// The design follows from that: one lane per thread with a grid-stride
// loop; every division by a runtime divisor
// (S, total, n_j, W, T and the chain's moduli) is a multiply-high by its
// magic number (law.cuh magic_div), computed on the host; the per-source
// constants are one table of COL_WORDS uint64 words a column, built once
// per (table, sizes, window) and cached by the caller, staged in shared
// memory when S <= STAGE_COLS and read through the read-only cache
// otherwise (S reaches 4,096, 256 KB, which would cost occupancy); the
// pairing constants depend on (seed, epoch) only and are computed once per
// block into shared memory (a fixed array up to STATIC_ROUNDS rounds, 16-
// byte aligned as the index kernels' are; dynamic shared memory above).
// mix32(j ^ C_SRC) is seed-free, so it rides in the table and eks_j costs
// one mix32 a lane.
//
// Build (plain C ABI, loaded with ctypes by ops/cuda_kernel.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libpsds_sampling_kernels.so sampling_kernels.cu
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success).

#include "chain.cuh"
#include "law.cuh"

namespace {

// the alias law's round constants (sampling/alias.py)
constexpr uint32_t C_POS = 0x7FEB352Du;
constexpr uint32_t C_POSH = 0x846CA68Bu;
constexpr uint32_t C_SEL = 0x9E485565u;
constexpr uint32_t C_ACC = 0xAF36D01Eu;
constexpr uint32_t C_ACC2 = 0x4A7B92D5u;
constexpr uint32_t C_LOC = 0x6C62272Eu;
constexpr uint32_t C_LOC2 = 0x35A4E1B1u;
constexpr uint32_t C_RETRY = 0x68E31DA4u;

// The most alias columns (sampling/alias.py _MAX_SOURCES).
constexpr uint32_t MAX_SOURCES = 4096;
// One alias column of the device table (ops/cuda_kernel.py weighted_plan).
constexpr int COL_WORDS = 8;
enum ColWord : int {
  COL_PROB,       // acceptance threshold in [0, total]
  COL_ALIAS,      // alias column | mix32(j ^ C_SRC) << 32
  COL_N,          // the source's size n_j
  COL_N_MULT,     // its magic multiplier (32 or 64 bits, by loc64)
  COL_N_SHIFT,    // s1 | s2 << 8
  COL_OFF,        // the source's first global id
  COL_BODY,       // (n_j / W) * W: the source's full windows
};
// Columns a block stages in shared memory at most (16 KB).
constexpr uint32_t STAGE_COLS = 256;

enum Source : int { SRC_RANK, SRC_CHAIN, SRC_BUFFER };

// The launch constants.
struct WParams {
  uint64_t lanes;                   // ordinals of the launch
  uint64_t first, first_mult;       // the first position's modulus: T or R
  uint64_t first_shift;             // (rank and chain sources)
  uint32_t world, rank, depth;      // the rank's partition, chain depth
  int strided;
  uint64_t total;                   // the table's mass total
  Magic32 total32, s_magic, w32;    // total, S and W as 32-bit divisors
  Magic64 total64, w64;             // total and W as 64-bit divisors
  uint32_t S, window;
  uint32_t seed_lo, seed_hi, epoch, retry;
  int shuffle, acc64, loc64, staged, rounds;
};

__device__ __forceinline__ uint64_t word64(uint32_t hi, uint32_t lo) {
  return ((uint64_t)hi << 32) | lo;
}

// The alias law for one ordinal p: the global id it draws.
template <typename Pos>
__device__ __forceinline__ uint64_t weighted_lane(Pos p, uint32_t ek,
                                                  const WParams &P,
                                                  const uint64_t *cols,
                                                  const uint32_t *ks) {
  const uint32_t p_lo = (uint32_t)p;
  const uint32_t p_hi =
      sizeof(Pos) == 8 ? (uint32_t)((uint64_t)p >> 32) : 0u;
  const uint32_t base =
      mix32(ek ^ mix32(p_lo ^ C_POS) ^ mix32(p_hi ^ C_POSH));
  // the column draw and the exact-integer accept test
  const uint32_t h = mix32(base ^ C_SEL);
  uint32_t j = h - magic_div(h, P.s_magic) * P.S;
  const uint64_t *c = cols + (uint64_t)j * COL_WORDS;
  uint64_t u;
  if (P.acc64) {
    const uint64_t w = word64(mix32(base ^ C_ACC), mix32(base ^ C_ACC2));
    u = w - magic_div(w, P.total64) * P.total;
  } else {
    const uint32_t v = mix32(base ^ C_ACC);
    u = v - magic_div(v, P.total32) * (uint32_t)P.total;
  }
  if (u >= c[COL_PROB]) {
    j = (uint32_t)c[COL_ALIAS];
    c = cols + (uint64_t)j * COL_WORDS;
  }
  // the within-source draw
  const uint64_t n = c[COL_N], mult = c[COL_N_MULT], shift = c[COL_N_SHIFT];
  const uint32_t s1 = (uint32_t)shift & 0xFFu, s2 = (uint32_t)(shift >> 8);
  uint64_t local;
  if (P.loc64) {
    const uint64_t w = word64(mix32(base ^ C_LOC), mix32(base ^ C_LOC2));
    local = w - magic_div(w, Magic64{mult, s1, s2}) * n;
  } else {
    const uint32_t v = mix32(base ^ C_LOC);
    local = v - magic_div(v, Magic32{(uint32_t)mult, s1, s2}) * (uint32_t)n;
  }
  // full-window lanes route their offset through the in-window bijection
  // under the source-and-window key; tail lanes keep the hashed draw
  if (P.shuffle && local < c[COL_BODY]) {
    uint32_t win, off;
    if (P.loc64) {
      win = (uint32_t)magic_div(local, P.w64);
      off = (uint32_t)(local - (uint64_t)win * P.window);
    } else {
      win = magic_div((uint32_t)local, P.w32);
      off = (uint32_t)local - win * P.window;
    }
    const uint32_t eks = mix32(ek ^ (uint32_t)(c[COL_ALIAS] >> 32));
    local = (uint64_t)win * P.window +
            swap_or_not(off, P.window, ks, inner_key(eks, win), P.rounds);
  }
  return c[COL_OFF] + local;
}

template <typename Pos, typename Out, int kSrc, bool kDyn>
__global__ void __launch_bounds__(THREADS)
    weighted_stream_kernel(Out *__restrict__ out, WParams P,
                           const uint64_t *__restrict__ cols_g,
                           const uint64_t *__restrict__ layers,
                           const int64_t *__restrict__ positions) {
  // the pairing constants: a fixed array, 16-byte aligned so that the
  // unrolled round loop reads four a load, or past STATIC_ROUNDS the tail of
  // the dynamic shared memory; the staged chain layers; and in the dynamic
  // shared memory the staged columns
  __shared__ __align__(16) uint32_t sched_fixed[kDyn ? 4 : STATIC_ROUNDS];
  __shared__ uint64_t staged_layers[kSrc == SRC_CHAIN
                                        ? STAGE_LAYERS * LAYER_WORDS
                                        : 1];
  extern __shared__ uint64_t dyn[];
  uint32_t ek = epoch_key(seed_key(P.seed_lo, P.seed_hi), P.epoch);
  if (P.retry != 0u) ek = mix32(ek ^ mix32(P.retry ^ C_RETRY));
  const uint32_t ncols = P.staged ? P.S : 0u;
  for (uint32_t i = threadIdx.x; i < ncols * COL_WORDS; i += blockDim.x)
    dyn[i] = (uint64_t)__ldg((const unsigned long long *)cols_g + i);
  const uint64_t *cols = P.staged ? dyn : cols_g;
  uint32_t *ks = kDyn ? (uint32_t *)(dyn + ncols * COL_WORDS) : sched_fixed;
  if (P.shuffle) load_round_keys(ks, mix32(ek ^ C_PAIR), P.window, P.rounds);
  if (kSrc == SRC_CHAIN) stage_layers(staged_layers, layers, P.depth);
  __syncthreads();
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < P.lanes; t += stride) {
    Pos p;
    if (kSrc == SRC_BUFFER) {
      p = (Pos)(uint64_t)positions[t];
    } else {
      p = P.strided ? (Pos)P.rank + (Pos)P.world * (Pos)t
                    : (Pos)P.rank * (Pos)P.lanes + (Pos)t;
      p = remainder<Pos>(p, P.first, P.first_mult, P.first_shift);
      if (kSrc == SRC_CHAIN)
        p = compose_chain<Pos>(p, staged_layers, layers, P.depth, P.strided);
    }
    out[t] = (Out)weighted_lane<Pos>(p, ek, P, cols, ks);
  }
}

template <typename Pos, typename Out, int kSrc>
void launch_body(void *out, const WParams &P, const void *cols,
                 const void *layers, const void *positions,
                 cudaStream_t st) {
  const bool dyn = P.rounds > STATIC_ROUNDS;
  const size_t smem = (P.staged ? (size_t)P.S * COL_WORDS * 8 : 0) +
                      (dyn ? (size_t)P.rounds * sizeof(uint32_t) : 0);
  const unsigned grid = grid_for(P.lanes);
  if (dyn)
    weighted_stream_kernel<Pos, Out, kSrc, true><<<grid, THREADS, smem, st>>>(
        (Out *)out, P, (const uint64_t *)cols, (const uint64_t *)layers,
        (const int64_t *)positions);
  else
    weighted_stream_kernel<Pos, Out, kSrc, false><<<grid, THREADS, smem, st>>>(
        (Out *)out, P, (const uint64_t *)cols, (const uint64_t *)layers,
        (const int64_t *)positions);
}

template <typename Pos, typename Out>
void dispatch(void *out, const WParams &P, const void *cols,
              const void *layers, const void *positions, cudaStream_t st) {
  if constexpr (sizeof(Pos) == 8) {
    if (positions != nullptr) {
      launch_body<Pos, Out, SRC_BUFFER>(out, P, cols, layers, positions, st);
      return;
    }
  }
  if (layers != nullptr)
    launch_body<Pos, Out, SRC_CHAIN>(out, P, cols, layers, positions, st);
  else
    launch_body<Pos, Out, SRC_RANK>(out, P, cols, layers, positions, st);
}

Magic32 magic32(uint64_t mult, uint32_t shift) {
  return Magic32{(uint32_t)mult, shift & 0xFFu, shift >> 8};
}

Magic64 magic64(uint64_t mult, uint32_t shift) {
  return Magic64{mult, shift & 0xFFu, shift >> 8};
}

// `positions` null: the rank source (`layers` null; `first` = T) or the
// chain source (`layers`, `depth`; `first` = the innermost remaining
// count), `lanes` the rank's num_samples; else the buffer source (the wide
// form only).  Divisors come as their magic multipliers and packed shifts
// (s1 | s2 << 8): total and W in 64 bits where acc64 / loc64 say so.
template <typename Pos>
int launch(void *out, const void *positions, uint64_t lanes,
           const void *cols, uint32_t S, int staged, uint64_t first,
           uint64_t first_mult, uint32_t first_shift, uint32_t world,
           uint32_t rank, int strided, const void *layers, uint32_t depth,
           uint64_t total, uint64_t total_mult, uint32_t total_shift,
           uint32_t s_mult, uint32_t s_shift, uint32_t window,
           uint64_t w_mult, uint32_t w_shift, uint32_t seed_lo,
           uint32_t seed_hi, uint32_t epoch, uint32_t retry, int shuffle,
           int acc64, int loc64, int out64, int rounds, void *stream) {
  const bool buffer = positions != nullptr;
  if (lanes == 0 || cols == nullptr || S == 0 || S > MAX_SOURCES ||
      (staged && S > STAGE_COLS) || total == 0 || rounds < 0 ||
      rounds > MAX_ROUNDS || window == 0 || window > INT32_MAX_U ||
      (buffer && sizeof(Pos) != 8) ||
      (!buffer && (first == 0 || world == 0 || rank >= world ||
                   (layers != nullptr && depth == 0))))
    return (int)cudaErrorInvalidValue;
  WParams P;
  P.lanes = lanes;
  P.first = first;
  P.first_mult = first_mult;
  P.first_shift = first_shift;
  P.world = world;
  P.rank = rank;
  P.depth = layers != nullptr ? depth : 0;
  P.strided = strided;
  P.total = total;
  P.total32 = magic32(total_mult, total_shift);
  P.total64 = magic64(total_mult, total_shift);
  P.s_magic = magic32(s_mult, s_shift);
  P.w32 = magic32(w_mult, w_shift);
  P.w64 = magic64(w_mult, w_shift);
  P.S = S;
  P.window = window;
  P.seed_lo = seed_lo;
  P.seed_hi = seed_hi;
  P.epoch = epoch;
  P.retry = retry;
  P.shuffle = shuffle;
  P.acc64 = acc64;
  P.loc64 = loc64;
  P.staged = staged;
  P.rounds = rounds;
  const cudaStream_t st = (cudaStream_t)stream;
  if (out64)
    dispatch<Pos, int64_t>(out, P, cols, layers, positions, st);
  else
    dispatch<Pos, int32_t>(out, P, cols, layers, positions, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psds_weighted_stream(
    void *out, const void *positions, uint64_t lanes, const void *cols,
    uint32_t S, int staged, uint64_t first, uint64_t first_mult,
    uint32_t first_shift, uint32_t world, uint32_t rank, int strided,
    const void *layers, uint32_t depth, uint64_t total, uint64_t total_mult,
    uint32_t total_shift, uint32_t s_mult, uint32_t s_shift, uint32_t window,
    uint64_t w_mult, uint32_t w_shift, uint32_t seed_lo, uint32_t seed_hi,
    uint32_t epoch, uint32_t retry, int shuffle, int acc64, int loc64,
    int out64, int rounds, void *stream) {
  return launch<uint32_t>(out, positions, lanes, cols, S, staged, first,
                          first_mult, first_shift, world, rank, strided,
                          layers, depth, total, total_mult, total_shift,
                          s_mult, s_shift, window, w_mult, w_shift, seed_lo,
                          seed_hi, epoch, retry, shuffle, acc64, loc64, out64,
                          rounds, stream);
}

extern "C" int psds_weighted_stream_wide(
    void *out, const void *positions, uint64_t lanes, const void *cols,
    uint32_t S, int staged, uint64_t first, uint64_t first_mult,
    uint32_t first_shift, uint32_t world, uint32_t rank, int strided,
    const void *layers, uint32_t depth, uint64_t total, uint64_t total_mult,
    uint32_t total_shift, uint32_t s_mult, uint32_t s_shift, uint32_t window,
    uint64_t w_mult, uint32_t w_shift, uint32_t seed_lo, uint32_t seed_hi,
    uint32_t epoch, uint32_t retry, int shuffle, int acc64, int loc64,
    int out64, int rounds, void *stream) {
  return launch<uint64_t>(out, positions, lanes, cols, S, staged, first,
                          first_mult, first_shift, world, rank, strided,
                          layers, depth, total, total_mult, total_shift,
                          s_mult, s_shift, window, w_mult, w_shift, seed_lo,
                          seed_hi, epoch, retry, shuffle, acc64, loc64, out64,
                          rounds, stream);
}
