// Hand-written CUDA kernels for the epoch-index law (SPEC.md) on Hopper.
//
// Six kernels over the law's __device__ functions in law.cuh:
//
//   index_general         -> replaces the Pallas kernel
//                            partiallyshuffledistributedsampler_tpu/ops/
//                            pallas_kernel.py _index_kernel: one thread per
//                            output lane, the full windowed permutation.
//   index_amortized       -> replaces the Pallas kernel
//                            partiallyshuffledistributedsampler_tpu/ops/
//                            pallas_kernel.py _amortized_kernel (+ its
//                            _expand_window_ids) together with the
//                            window-order pre-pass that feeds it there,
//                            ops/xla.py _window_order_ids (XLA, not Pallas):
//                            one launch per regen.  A block takes a tile of
//                            body lanes, computes the source windows of the
//                            slots they span, swap_or_not(j, nw,
//                            outer_key(ek)), into shared memory, and each
//                            lane then runs only the inner bijection; lanes
//                            t >= body (tail window, wrap padding) take the
//                            general law in the same launch.
//   index_general_wide    -> the same two kernel bodies for index spaces
//   index_amortized_wide     n >= 2^31, int64 output.  They replace XLA code
//                            of the JAX package (its Pallas kernels stop at
//                            2^31): ops/core.py epoch_indices_generic with
//                            uint64 positions, and ops/xla.py
//                            _epoch_indices_amortized (its `big` branch).
//   index_positions       -> the general law on positions from another
//   index_positions_wide     source than rank + world*t, replacing the XLA
//                            programs ops/xla.py _compiled_elastic_indices /
//                            elastic_indices_jax (the elastic remainder,
//                            SPEC.md §6) and stream_indices_at_jax (random
//                            access, SPEC.md §4).  The chain source composes
//                            the reshard chain per lane in registers; the
//                            buffer source reads int64 positions.  See
//                            index_positions_kernel.
//
// The narrow and the wide forms are one kernel body templated on the
// position type Pos (uint32 / uint64) and the output type Out (int32 /
// int64).  Positions of the wide forms are uint64 with no wrap:
// (rank + world*t) % n and rank*num_samples + t are taken in uint64, where
// the narrow forms wrap at 2^32 before the mod n as the uint32 reference
// does.  The bijection domains stay uint32 in both: window ids, in-window
// offsets and tail offsets are below 2^31, so j = p / W and r0 = p % W are
// taken in Pos and narrowed, and only the combines kw*W + rho and
// body_len + rho_t widen.  The general wide kernel counts lanes in uint64
// (num_samples exceeds 2^32 at world 1 or 2 of a 10B space); the amortized
// wide kernel keeps a uint32 counter, since its gate bounds ceil(n/world)
// below 2^31.
//
// The seed triple (seed_lo, seed_hi, epoch) comes either as launch
// arguments or, when `seeds` is not null, from three uint32 words in device
// memory: the output of a collective that agreed on it, so no host read is
// needed between the agreement and the launch.
//
// What bounds them: integer operations, not bytes.  A bijection costs
// `rounds` (24) rounds of ~18 int32 operations per element (add, wrap
// compare/subtract/select, max, two xors, the 8-operation mix32, bit test
// and select); the general law runs two bijections per element, the
// amortized one plus one outer bijection per window slot (nw per regen).
// Each element writes 4 bytes (8 in the wide forms) and reads none.  The
// design follows from that: no input tiles, one lane per thread with a
// grid-stride loop (tile-stride in the amortized kernels); shared memory
// holds the per-round pairing constants K_r
// = mix32(pair ^ r*GOLDEN) mod m, which depend on scalars only and are
// computed once per block, never per element, and in the amortized kernels
// the window ids of the block's current tile.  Up to STATIC_ROUNDS (64)
// rounds the three schedules are fixed shared arrays of 3 x 64 words; above
// that (kDyn) they take 3 * rounds words of dynamic shared memory (48 KB at
// MAX_ROUNDS = 4,096), and past the 48 KB a block gets by default the
// launch opts in with cudaFuncSetAttribute, up to the card's 227 KB.  Two
// forms, because the dynamic one was 3.5 % slower at 24 rounds on the H100
// (PERF.md §6): with the schedules' stride known and 16-byte
// alignment the unrolled round loop reads its constants as LDS.128, four a
// load; with a runtime stride it reads them one or two at a time.
//
// The amortized tile.  Its TILE_MAX + 2 ids (16 KB) beside the schedules
// (768 B up to 64 rounds) leave room for 8 resident blocks per SM.  A tile
// of lanes [a, b) spans the slots a/m .. (b-1)/m; the block computes those ids, waits at a
// barrier, runs the tile's lanes, and waits again before the next tile.  A
// slot cut by a tile edge is computed by both tiles: at most one bijection
// more per tile, against the nw*4 bytes of a separate pre-pass written and
// read back and its launch (a bound under the launch time).  The tile is
// not fixed: the launch takes tile = num_samples / resident blocks, rounded
// up to a warp and capped at TILE_MAX, so a regen of fewer than TILE_MAX *
// resident blocks lanes is one tile per block, and every SM gets the lanes
// the grid-stride loop would give it.  (Rounded up to THREADS instead, the
// tiles of the 1B/world-256 regen were 3840 lanes and some SMs held 8 of
// them against 7 on others, which was slower in trials on the H100; a
// fixed 4096-lane tile leaves the same imbalance.  2 to 16 tiles per block
// were slower too: each tile's ids are computed while the block's other
// warps wait.)
//
// Division and modulo by the runtime m, W and n are plain `/` and `%` (in
// uint64 for wide positions, a software sequence on the GPU); fast-divmod
// magic numbers are a known next step.
//
// Every operation keeps the order of ops/core.py (law.cuh), and the index
// clips of the window id and the tail offset.
//
// Build (plain C ABI, loaded with ctypes by ops/cuda_kernel.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libpsds_index_kernels.so index_kernels.cu
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success).

#include "chain.cuh"
#include "law.cuh"

namespace {

// The static configuration and the per-call scalars of one launch.
struct LawParams {
  uint64_t n, num_samples, body_len;  // body_len = nw * window
  uint32_t window, world, rank;
  uint32_t nw, tail_len;  // n / window, n - body_len
  uint32_t seed_lo, seed_hi, epoch;
  int rounds, shuffle, order_windows, strided;
};

// Keys that depend on (seed, epoch) only.
struct Keys {
  uint32_t ek, okey, tkey, pair_inner;
};

// Pairing constants of the three bijections, shared by the block: views
// on 3 * rounds words of dynamic shared memory.
struct Schedules {
  const uint32_t *outer, *inner, *tail;
};

// `seeds` (nullable): the triple in device memory, read in place of the
// launch arguments.
__device__ __forceinline__ Keys make_keys(const LawParams &P,
                                          const uint32_t *seeds) {
  uint32_t lo = P.seed_lo, hi = P.seed_hi, ep = P.epoch;
  if (seeds != nullptr) {
    lo = __ldg(seeds);
    hi = __ldg(seeds + 1);
    ep = __ldg(seeds + 2);
  }
  const uint32_t k = epoch_key(seed_key(lo, hi), ep);
  Keys keys;
  keys.ek = k;
  keys.okey = mix32(k ^ C_OUTER);
  keys.tkey = mix32(k ^ C_TAIL);
  keys.pair_inner = mix32(k ^ C_PAIR);
  return keys;
}

// The windowed permutation pi(p) for one position p in [0, n)
// (ops/core.py windowed_perm).  The reference evaluates the body and the
// tail law on every lane and selects by p < body_len; a lane here
// evaluates only the law it selects, which gives the same value.
template <typename Pos>
__device__ __forceinline__ Pos windowed_perm(Pos p, const LawParams &P,
                                             const Keys &k,
                                             const Schedules &s) {
  const Pos body_len = (Pos)P.body_len;
  if (p < body_len) {
    uint32_t j = (uint32_t)(p / P.window);
    j = j > P.nw - 1 ? P.nw - 1 : j;
    const uint32_t r0 = (uint32_t)(p % P.window);
    const uint32_t kw = (P.order_windows && P.nw > 1)
                            ? swap_or_not(j, P.nw, s.outer, k.okey, P.rounds)
                            : j;
    return (Pos)kw * P.window +
           swap_or_not(r0, P.window, s.inner, inner_key(k.ek, kw), P.rounds);
  }
  uint32_t tpos = (uint32_t)(p - body_len);
  tpos = tpos > P.tail_len - 1 ? P.tail_len - 1 : tpos;
  return body_len +
         swap_or_not(tpos, P.tail_len, s.tail, k.tkey, P.rounds);
}

// Stream position of output lane t, mod n.  uint32 positions wrap at 2^32
// before the mod n, as the reference does (pallas_kernel.py _index_kernel);
// uint64 positions do not wrap.
template <typename Pos>
__device__ __forceinline__ Pos stream_position(Pos t, const LawParams &P) {
  const Pos p = P.strided ? (Pos)P.rank + (Pos)P.world * t
                          : (Pos)P.rank * (Pos)P.num_samples + t;
  return p % (Pos)P.n;
}

// Block-cooperative: the three schedules into `smem`, `stride` words
// apart; the caller waits at a barrier before reading them.
__device__ __forceinline__ Schedules load_schedules(uint32_t *smem,
                                                    int stride,
                                                    const LawParams &P,
                                                    const Keys &k) {
  uint32_t *outer = smem, *inner = smem + stride, *tail = smem + 2 * stride;
  load_round_keys(outer, k.okey, P.nw, P.rounds);
  load_round_keys(inner, k.pair_inner, P.window, P.rounds);
  load_round_keys(tail, k.tkey, P.tail_len, P.rounds);
  return Schedules{outer, inner, tail};
}

// Dynamic shared memory of a launch: the three schedules past
// STATIC_ROUNDS, else none.
inline size_t schedule_bytes(int rounds) {
  return rounds > STATIC_ROUNDS ? 3 * (size_t)rounds * sizeof(uint32_t) : 0;
}

// Lanes of an amortized tile: at most TILE_MAX, a multiple of WARP.
constexpr uint32_t TILE_MAX = 4096;
constexpr uint32_t WARP = 32;

// Pos is also the lane counter: uint64 where num_samples may pass 2^32.
template <typename Pos, typename Out, bool kDyn>
__global__ void __launch_bounds__(THREADS)
    index_general_kernel(Out *__restrict__ out, LawParams P,
                         const uint32_t *__restrict__ seeds) {
  // the schedules: fixed arrays, 16-byte aligned so that the unrolled
  // round loop reads four constants a load, or past STATIC_ROUNDS the
  // launch's dynamic shared memory
  __shared__ __align__(16) uint32_t sched_fixed[kDyn ? 4 : 3 * STATIC_ROUNDS];
  extern __shared__ uint32_t sched_dyn[];
  const Keys k = make_keys(P, seeds);
  const Schedules s = kDyn ? load_schedules(sched_dyn, P.rounds, P, k)
                           : load_schedules(sched_fixed, STATIC_ROUNDS, P, k);
  __syncthreads();
  const Pos stride = (Pos)gridDim.x * blockDim.x;
  const Pos num_samples = (Pos)P.num_samples;
  for (Pos t = (Pos)blockIdx.x * blockDim.x + threadIdx.x; t < num_samples;
       t += stride) {
    const Pos p = stream_position<Pos>(t, P);
    out[t] = (Out)(P.shuffle ? windowed_perm<Pos>(p, P, k, s) : p);
  }
}

// Strided, shuffled, window % world == 0, nw >= 1: lane t < body = nw * m
// sits in output window slot t / m at in-window offset
// rank + world * (t % m), so its source window is the outer bijection of
// slot t / m, computed once per tile into `kid`, and only the inner
// bijection remains per element.  num_samples < 2^31 (the gate), `tile` a
// multiple of WARP in [WARP, TILE_MAX].
template <typename Pos, typename Out, bool kDyn>
__global__ void __launch_bounds__(THREADS)
    index_amortized_kernel(Out *__restrict__ out, LawParams P, uint32_t m,
                           uint32_t body, uint32_t tile,
                           const uint32_t *__restrict__ seeds) {
  // the schedules (16-byte aligned: see index_general_kernel), then the
  // window ids of the tile's slots: at most (tile - 1) / m + 2 of them
  __shared__ __align__(16) uint32_t sched_fixed[kDyn ? 4 : 3 * STATIC_ROUNDS];
  __shared__ uint32_t kid[TILE_MAX + 2];
  extern __shared__ uint32_t sched_dyn[];
  const Keys k = make_keys(P, seeds);
  const Schedules s = kDyn ? load_schedules(sched_dyn, P.rounds, P, k)
                           : load_schedules(sched_fixed, STATIC_ROUNDS, P, k);
  __syncthreads();
  const bool permute = P.order_windows && P.nw > 1;
  const uint32_t num_samples = (uint32_t)P.num_samples;
  // block-uniform loop: every thread reaches the barriers equally often
  for (uint32_t a = blockIdx.x * tile; a < num_samples;
       a += gridDim.x * tile) {
    const uint32_t b = num_samples - a < tile ? num_samples : a + tile;
    const uint32_t s0 = a / m;
    if (a < body) {
      const uint32_t slots = ((b < body ? b : body) - 1) / m - s0 + 1;
      for (uint32_t j = threadIdx.x; j < slots; j += blockDim.x)
        kid[j] = permute
                     ? swap_or_not(s0 + j, P.nw, s.outer, k.okey, P.rounds)
                     : s0 + j;
    }
    __syncthreads();  // the tile's ids
    for (uint32_t t = a + threadIdx.x; t < b; t += blockDim.x) {
      Pos v;
      if (t < body) {
        const uint32_t slot = t / m;
        const uint32_t kex = kid[slot - s0];
        const uint32_t r0 = P.rank + P.world * (t - slot * m);
        v = (Pos)kex * P.window + swap_or_not(r0, P.window, s.inner,
                                              inner_key(k.ek, kex), P.rounds);
      } else {
        v = windowed_perm<Pos>(stream_position<Pos>((Pos)t, P), P, k, s);
      }
      out[t] = (Out)v;
    }
    __syncthreads();  // every lane has read kid before it is overwritten
  }
}

// ------------------------------------------------------------ positions
// The remainder law (SPEC.md §6): lane t of the new world's rank takes the
// ordinal q = rank_position(t) mod R over the innermost remainder, maps it
// out through the reshard layers (chain.cuh compose_chain, the table
// staged by stage_layers) and then runs the windowed permutation:
// ops/core.py rank_positions, compose_remainder_chain and
// stream_indices_at_generic, one lane a thread, with no position written to
// or read from device memory.
//
// The buffer source (random access) reads one int64 position a lane: its
// low 32 bits (uint32 positions) or all 64 as uint64, as the reference
// casts them, then mod n.  Lanes are counted in uint64 in both sources.

// The lanes' position source.
struct PosSource {
  const int64_t *positions;   // buffer source (null for the chain)
  const uint64_t *layers;     // chain table, innermost layer first
  uint32_t depth;             // layers in the chain
  uint64_t first, first_mult, first_shift;  // the modulus of the first
                                            // position: R or n
};

// kChain: positions from the reshard chain, else from S.positions.
template <typename Pos, typename Out, bool kDyn, bool kChain>
__global__ void __launch_bounds__(THREADS)
    index_positions_kernel(Out *__restrict__ out, LawParams P, PosSource S,
                           const uint32_t *__restrict__ seeds) {
  __shared__ __align__(16) uint32_t sched_fixed[kDyn ? 4 : 3 * STATIC_ROUNDS];
  __shared__ uint64_t staged[kChain ? STAGE_LAYERS * LAYER_WORDS : 1];
  extern __shared__ uint32_t sched_dyn[];
  const Keys k = make_keys(P, seeds);
  const Schedules s = kDyn ? load_schedules(sched_dyn, P.rounds, P, k)
                           : load_schedules(sched_fixed, STATIC_ROUNDS, P, k);
  if (kChain) stage_layers(staged, S.layers, S.depth);
  __syncthreads();
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < P.num_samples; t += stride) {
    Pos q;
    if (kChain) {
      q = P.strided ? (Pos)P.rank + (Pos)P.world * (Pos)t
                    : (Pos)P.rank * (Pos)P.num_samples + (Pos)t;
      q = remainder<Pos>(q, S.first, S.first_mult, S.first_shift);
      q = compose_chain<Pos>(q, staged, S.layers, S.depth, P.strided);
    } else {
      q = remainder<Pos>((Pos)(uint64_t)S.positions[t], S.first,
                         S.first_mult, S.first_shift);
    }
    out[t] = (Out)(P.shuffle ? windowed_perm<Pos>(q, P, k, s) : q);
  }
}

LawParams make_params(uint64_t n, uint32_t window, uint32_t world,
                      uint64_t num_samples, uint32_t rank, uint32_t seed_lo,
                      uint32_t seed_hi, uint32_t epoch, int shuffle,
                      int order_windows, int strided, int rounds) {
  LawParams P;
  P.n = n;
  P.window = window;
  P.world = world;
  P.num_samples = num_samples;
  P.rank = rank;
  P.nw = (uint32_t)(n / window);
  P.body_len = (uint64_t)P.nw * window;
  P.tail_len = (uint32_t)(n - P.body_len);
  P.seed_lo = seed_lo;
  P.seed_hi = seed_hi;
  P.epoch = epoch;
  P.rounds = rounds;
  P.shuffle = shuffle;
  P.order_windows = order_windows;
  P.strided = strided;
  return P;
}

// What every kernel refuses: n = 0, a window or a window count outside
// [1, 2^31), a round count above MAX_ROUNDS.
bool bad_config(uint64_t n, uint32_t window, int rounds) {
  return n == 0 || window == 0 || window > INT32_MAX_U ||
         n / window > INT32_MAX_U || rounds < 0 || rounds > MAX_ROUNDS;
}

// A narrow launch takes n < 2^31, a wide one n >= 2^31.
bool bad_width(uint64_t n, bool wide) { return wide != (n > INT32_MAX_U); }

bool bad_rank(uint32_t world, uint32_t rank, uint64_t num_samples) {
  return world == 0 || world > INT32_MAX_U || rank >= world ||
         num_samples == 0;
}

template <typename Pos, typename Out>
int launch_general(bool wide, void *out, uint64_t n, uint32_t window,
                   uint32_t world, uint64_t num_samples, uint32_t rank,
                   uint32_t seed_lo, uint32_t seed_hi, uint32_t epoch,
                   const void *seeds, int shuffle, int order_windows,
                   int strided, int rounds, void *stream) {
  if (bad_config(n, window, rounds) || bad_width(n, wide) ||
      bad_rank(world, rank, num_samples) ||
      (!wide && num_samples > INT32_MAX_U))
    return (int)cudaErrorInvalidValue;
  const LawParams P =
      make_params(n, window, world, num_samples, rank, seed_lo, seed_hi,
                  epoch, shuffle, order_windows, strided, rounds);
  const size_t smem = schedule_bytes(rounds);
  const cudaStream_t st = (cudaStream_t)stream;
  if (smem == 0) {
    index_general_kernel<Pos, Out, false>
        <<<grid_for(num_samples), THREADS, 0, st>>>((Out *)out, P,
                                                    (const uint32_t *)seeds);
  } else {
    if (smem > SMEM_DEFAULT)
      cudaFuncSetAttribute(index_general_kernel<Pos, Out, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    index_general_kernel<Pos, Out, true>
        <<<grid_for(num_samples), THREADS, smem, st>>>(
            (Out *)out, P, (const uint32_t *)seeds);
  }
  return (int)cudaGetLastError();
}

template <typename Pos, typename Out>
int launch_amortized(bool wide, void *out, uint64_t n, uint32_t window,
                     uint32_t world, uint64_t num_samples, uint32_t rank,
                     uint32_t seed_lo, uint32_t seed_hi, uint32_t epoch,
                     const void *seeds, int order_windows, int rounds,
                     void *stream) {
  if (bad_config(n, window, rounds) || bad_width(n, wide) ||
      bad_rank(world, rank, num_samples) || num_samples > INT32_MAX_U ||
      window % world != 0 || n / window == 0)
    return (int)cudaErrorInvalidValue;
  const LawParams P =
      make_params(n, window, world, num_samples, rank, seed_lo, seed_hi,
                  epoch, 1, order_windows, 1, rounds);
  const uint32_t m = window / world;
  const uint32_t body = P.nw * m;
  // a tile per resident block where that fits, in whole warps
  const uint64_t cap = resident_blocks();
  uint64_t tile = (num_samples + cap - 1) / cap;
  tile = (tile + WARP - 1) / WARP * WARP;
  tile = tile < TILE_MAX ? tile : TILE_MAX;
  const unsigned grid = grid_cap((num_samples + tile - 1) / tile);
  const size_t smem = schedule_bytes(rounds);
  const cudaStream_t st = (cudaStream_t)stream;
  if (smem == 0) {
    index_amortized_kernel<Pos, Out, false><<<grid, THREADS, 0, st>>>(
        (Out *)out, P, m, body, (uint32_t)tile, (const uint32_t *)seeds);
  } else {
    // the dynamic schedules beside the static window ids
    if (smem + (TILE_MAX + 2) * sizeof(uint32_t) > SMEM_DEFAULT)
      cudaFuncSetAttribute(index_amortized_kernel<Pos, Out, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    index_amortized_kernel<Pos, Out, true><<<grid, THREADS, smem, st>>>(
        (Out *)out, P, m, body, (uint32_t)tile, (const uint32_t *)seeds);
  }
  return (int)cudaGetLastError();
}

template <typename Pos, typename Out, bool kChain>
void launch_positions_body(Out *out, const LawParams &P, const PosSource &S,
                           const uint32_t *seeds, cudaStream_t st) {
  const size_t smem = schedule_bytes(P.rounds);
  const unsigned grid = grid_for(P.num_samples);
  if (smem == 0) {
    index_positions_kernel<Pos, Out, false, kChain>
        <<<grid, THREADS, 0, st>>>(out, P, S, seeds);
    return;
  }
  // the dynamic schedules beside the static staged layers
  const size_t fixed = 16 + (kChain ? STAGE_LAYERS * LAYER_WORDS : 1) * 8;
  if (smem + fixed > SMEM_DEFAULT)
    cudaFuncSetAttribute(index_positions_kernel<Pos, Out, true, kChain>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  index_positions_kernel<Pos, Out, true, kChain>
      <<<grid, THREADS, smem, st>>>(out, P, S, seeds);
}

// `positions` null: the chain source (`layers`, `depth`, rank and world,
// `lanes` the rank's num_samples, `first` the innermost remaining count);
// else the buffer source (`first` = n).
template <typename Pos, typename Out>
int launch_positions(bool wide, void *out, const void *positions,
                     uint64_t lanes, uint64_t n, uint32_t window,
                     uint32_t world, uint32_t rank, const void *layers,
                     uint32_t depth, uint64_t first, uint64_t first_mult,
                     uint32_t first_shift, uint32_t seed_lo,
                     uint32_t seed_hi, uint32_t epoch, const void *seeds,
                     int shuffle, int order_windows, int strided, int rounds,
                     void *stream) {
  const bool chain = positions == nullptr;
  if (bad_config(n, window, rounds) || bad_width(n, wide) || lanes == 0 ||
      first == 0 || (!wide && first > 0xFFFFFFFFull) ||
      (chain && (bad_rank(world, rank, lanes) || depth == 0 ||
                 layers == nullptr)))
    return (int)cudaErrorInvalidValue;
  const LawParams P =
      make_params(n, window, chain ? world : 1, lanes, chain ? rank : 0,
                  seed_lo, seed_hi, epoch, shuffle, order_windows, strided,
                  rounds);
  const PosSource S{(const int64_t *)positions, (const uint64_t *)layers,
                    chain ? depth : 0, first, first_mult, first_shift};
  const cudaStream_t st = (cudaStream_t)stream;
  if (chain)
    launch_positions_body<Pos, Out, true>((Out *)out, P, S,
                                          (const uint32_t *)seeds, st);
  else
    launch_positions_body<Pos, Out, false>((Out *)out, P, S,
                                           (const uint32_t *)seeds, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psds_index_general(void *out, uint64_t n, uint32_t window,
                                  uint32_t world, uint64_t num_samples,
                                  uint32_t rank, uint32_t seed_lo,
                                  uint32_t seed_hi, uint32_t epoch,
                                  const void *seeds, int shuffle,
                                  int order_windows, int strided, int rounds,
                                  void *stream) {
  return launch_general<uint32_t, int32_t>(
      false, out, n, window, world, num_samples, rank, seed_lo, seed_hi,
      epoch, seeds, shuffle, order_windows, strided, rounds, stream);
}

extern "C" int psds_index_general_wide(void *out, uint64_t n,
                                       uint32_t window, uint32_t world,
                                       uint64_t num_samples, uint32_t rank,
                                       uint32_t seed_lo, uint32_t seed_hi,
                                       uint32_t epoch, const void *seeds,
                                       int shuffle, int order_windows,
                                       int strided, int rounds,
                                       void *stream) {
  return launch_general<uint64_t, int64_t>(
      true, out, n, window, world, num_samples, rank, seed_lo, seed_hi,
      epoch, seeds, shuffle, order_windows, strided, rounds, stream);
}

extern "C" int psds_index_amortized(void *out, uint64_t n, uint32_t window,
                                    uint32_t world, uint64_t num_samples,
                                    uint32_t rank, uint32_t seed_lo,
                                    uint32_t seed_hi, uint32_t epoch,
                                    const void *seeds, int order_windows,
                                    int rounds, void *stream) {
  return launch_amortized<uint32_t, int32_t>(
      false, out, n, window, world, num_samples, rank, seed_lo, seed_hi,
      epoch, seeds, order_windows, rounds, stream);
}

extern "C" int psds_index_amortized_wide(void *out, uint64_t n,
                                         uint32_t window, uint32_t world,
                                         uint64_t num_samples, uint32_t rank,
                                         uint32_t seed_lo, uint32_t seed_hi,
                                         uint32_t epoch, const void *seeds,
                                         int order_windows, int rounds,
                                         void *stream) {
  return launch_amortized<uint64_t, int64_t>(
      true, out, n, window, world, num_samples, rank, seed_lo, seed_hi,
      epoch, seeds, order_windows, rounds, stream);
}

extern "C" int psds_index_positions(
    void *out, const void *positions, uint64_t lanes, uint64_t n,
    uint32_t window, uint32_t world, uint32_t rank, const void *layers,
    uint32_t depth, uint64_t first, uint64_t first_mult,
    uint32_t first_shift, uint32_t seed_lo, uint32_t seed_hi, uint32_t epoch,
    const void *seeds, int shuffle, int order_windows, int strided,
    int rounds, void *stream) {
  return launch_positions<uint32_t, int32_t>(
      false, out, positions, lanes, n, window, world, rank, layers, depth,
      first, first_mult, first_shift, seed_lo, seed_hi, epoch, seeds,
      shuffle, order_windows, strided, rounds, stream);
}

extern "C" int psds_index_positions_wide(
    void *out, const void *positions, uint64_t lanes, uint64_t n,
    uint32_t window, uint32_t world, uint32_t rank, const void *layers,
    uint32_t depth, uint64_t first, uint64_t first_mult,
    uint32_t first_shift, uint32_t seed_lo, uint32_t seed_hi, uint32_t epoch,
    const void *seeds, int shuffle, int order_windows, int strided,
    int rounds, void *stream) {
  return launch_positions<uint64_t, int64_t>(
      true, out, positions, lanes, n, window, world, rank, layers, depth,
      first, first_mult, first_shift, seed_lo, seed_hi, epoch, seeds,
      shuffle, order_windows, strided, rounds, stream);
}
