// Hand-written CUDA kernels for the weighted mixture stream (SPEC.md §8) on
// Hopper.  They replace the XLA program _fused_mixture_eval of the JAX
// package (partiallyshuffledistributedsampler_tpu/ops/mixture.py, with its
// _swap_or_not_lanes and _lane_divmod); the JAX package has no Pallas
// kernel for the mixture.
//
//   mixture_source_keys -> the keys buffer of a regen whose keys are too
//                          many to fold (below): the rotation key, the
//                          epoch, and per source s its seed key and the
//                          pairing constants of its three bijections (outer,
//                          inner, tail; each `rounds` long), from the
//                          pass-free per-source epoch key.  They depend on
//                          the seed, so they are derived on the card: a seed
//                          triple agreed by a collective never visits the
//                          host.  One thread per word (source_key_word).
//   mixture_fused       -> one thread per output lane: the slot, the source,
//                          its pass and in-pass offset, the pass-folded
//                          decision key, then the §3 law with the source's
//                          (n_s, W_s, nw_s, tail_s), plus the source's base.
//                          With a null keys buffer, every block derives the
//                          keys itself into shared memory in its prologue
//                          (source_key_word, from the scalars or the device
//                          triple), so a regen is one launch.
//   mixture_fused_wide  -> the same kernel's Wide instantiation, the law for
//                          any source size: it replaces the masked
//                          per-source loop of the JAX package (ops/mixture.py
//                          mixture_stream_at_generic, the fused=False branch,
//                          with _amortized_source_perm and
//                          core.windowed_perm), the only route there for a
//                          source of 2^31 or more.  It computes per lane
//                          what the loop computes (not its S passes or its
//                          pass tables): n_s and body_s as uint64 from the
//                          32-bit nw_s, W_s and tail_s of the same source
//                          table (SPEC.md §3 keeps those below 2^31), the
//                          pass and the in-source offset u by a 64-bit
//                          divide, then the window and in-window offset of u.
//                          The bijections stay uint32; idx is uint64.
//
// The fold.  A separate mixture_source_keys launch took 0.0025 ms for 221
// words at M1 against a bound of 0.0000007 ms (H100): it is all launch.
// Folded, each of up to 1,056 blocks derives the words again, ~80 int32
// operations a word, which is small beside its lanes' work while the words
// are few.  The kernel can derive any keys it stages; the wrapper folds
// while keys + source table take at most ops/cuda_kernel.py FOLD_WORDS_CAP
// = 576 staged words (M1: 245, the six-source M3: 488), and a larger spec
// (12 sources: 974 words; 300 sources: 24,302) or a high round count keeps
// the two launches.  On the H100 (chip_smoke.py, PERF.md §6) the
// fold saved 0.0011-0.0016 ms a regen at 245 words, 0.0004-0.0006 at 488,
// and cost 0.0017-0.0022 at 974.
//
// Keys buffer (uint32): [0] rk, [1] epoch, then per source s a row of
// 1 + 3*rounds words: seed_key(lo_s, hi_s), K_outer[rounds],
// K_inner[rounds], K_tail[rounds].  Source table (uint32 [S, 8]): n, W, nw,
// tail, k (quota), body = nw*W, base lo, base hi.  Pattern int32 [B],
// prefix int32 [B*S] (C_s(slot), draws of s before slot in a block).
//
// Per lane, with p its stream position (uint32 or uint64, the Pos type):
//   blk = p / B, t = p % B; v2 shuffled streams rotate the slot by
//   rot = mix32(rk ^ (uint32)blk) % B (rk from the UNSOURCED seed's epoch
//   key, blk mod 2^32); s = pattern[slot];
//   cnt = prefix[slot, s] (+ k_s if the rotated slot wrapped) - prefix[rot, s]
//   in int32 (non-negative only with the wrap term); j = blk*k_s + cnt;
//   pass = j / n_s (uint32), u = j % n_s;
//   ek = epoch_key(seed_key_s, mix32(ep ^ mix32(pass ^ C_PASS)));
//   body lanes: kw = outer(u / W_s), rho = inner(u % W_s, inner_key(ek, kw));
//   tail lanes: rho = tail(u - body_s); out = base_s + idx.
// Decision keys fold the pass in; pairing constants do not (they come from
// the pass-free key), so they are per (source, round) only.  The Wide
// instantiation differs only in widths: body_s = nw_s*W_s and n_s = body_s +
// tail_s in uint64, pass = (uint32)(j / n_s) and u = j % n_s in uint64,
// win = u / W_s and r0 = u % W_s (both below 2^31), idx = kw*W_s + rho (or
// body_s + rho) in uint64.  An unshuffled stream takes idx = u.
//
// What bounds mixture_fused: integer operations, as the index kernels (two
// 24-round bijections per body lane, plus the per-lane key derivation and
// the table lookups); each lane writes 4 or 8 bytes and reads none.  One
// lane per thread, a grid-stride loop; the keys and the source table are
// staged in shared memory when they fit (S = 3 at 24 rounds: 2.0 KB), else
// read through the read-only cache.  Divisions by the runtime B, n_s and
// W_s are plain `/` and `%` (64-bit ones for uint64 positions); fast divmod
// and a per-(source, pass) window-order pre-pass are later steps.  The Wide
// instantiation is bound the same way; its 64-bit `/` and `%` by n_s and
// W_s run as 32-bit ones where both operands fit (wide_divmod), so a source
// below 2^32 at positions below 2^32 pays no 64-bit divide.
//
// Build (plain C ABI, loaded with ctypes by ops/cuda_kernel.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libpsds_mixture_kernels.so mixture_kernels.cu
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success).

#include <type_traits>

#include "law.cuh"

namespace {

constexpr uint32_t C_PASS = 0x632BE5ABu;
constexpr uint32_t C_ROT = 0x6A09E667u;
constexpr uint64_t MIX_SEED_STRIDE = 0xB5297A4D2C7E9FD3ull;
constexpr int SRC_COLS = 8;
constexpr int KEY_HEAD = 2;  // rk, epoch
// Words of keys + source table staged in shared memory at most (48 KB, the
// limit without an opt-in attribute; ops/cuda_kernel.py STAGE_WORDS_CAP).
// A launch that derives its keys needs them staged.
constexpr int STAGE_WORDS_CAP = 12288;

struct MixParams {
  uint64_t lanes, rank, world;
  uint32_t block, S;
  int rounds, strided, shuffle, order_windows, rotated, stage;
};

__host__ __device__ __forceinline__ int key_stride(int rounds) {
  return 1 + 3 * rounds;
}

// Words a launch stages: the keys buffer and the source table.
inline uint64_t staged_words(int S, int rounds) {
  return KEY_HEAD + (uint64_t)S * key_stride(rounds) + (uint64_t)S * SRC_COLS;
}

// The seed triple of a launch: the scalars, or the three words `seeds`
// points at in device memory.
struct SeedTriple {
  uint32_t lo, hi, ep;
};

__device__ __forceinline__ SeedTriple seed_triple(uint32_t seed_lo,
                                                  uint32_t seed_hi,
                                                  uint32_t epoch,
                                                  const uint32_t *seeds) {
  if (seeds != nullptr) return {__ldg(seeds), __ldg(seeds + 1),
                                __ldg(seeds + 2)};
  return {seed_lo, seed_hi, epoch};
}

// Word i of the keys buffer (layout in the note above): the rotation key,
// the epoch, or a source's seed key or pairing constant.  `src` is the
// source table, in global or shared memory.
__device__ __forceinline__ uint32_t source_key_word(uint32_t i,
                                                   const uint32_t *src,
                                                   int rounds,
                                                   const SeedTriple &k) {
  if (i == 0) return mix32(epoch_key(seed_key(k.lo, k.hi), k.ep) ^ C_ROT);
  if (i == 1) return k.ep;
  const int stride_k = key_stride(rounds);
  const uint32_t e = i - KEY_HEAD;
  const uint32_t s = e / stride_k;
  const int c = (int)(e % stride_k);
  const uint64_t d = MIX_SEED_STRIDE + s;
  const uint32_t sk =
      seed_key(k.lo ^ (uint32_t)d, k.hi ^ (uint32_t)(d >> 32));
  if (c == 0) return sk;
  const uint32_t ek0 = epoch_key(sk, k.ep);  // pass-free
  const int kind = (c - 1) / rounds, r = (c - 1) % rounds;
  const uint32_t *row = src + (size_t)s * SRC_COLS;
  const uint32_t m = kind == 0 ? row[2]    // nw
                     : kind == 1 ? row[1]  // W
                                 : row[3];  // tail
  const uint32_t pair =
      mix32(ek0 ^ (kind == 0 ? C_OUTER : kind == 1 ? C_PAIR : C_TAIL));
  return round_key(pair, m, r);
}

__global__ void __launch_bounds__(THREADS)
    mixture_source_keys_kernel(uint32_t *__restrict__ keys,
                               const uint32_t *__restrict__ src, int S,
                               int rounds, uint32_t seed_lo, uint32_t seed_hi,
                               uint32_t epoch,
                               const uint32_t *__restrict__ seeds) {
  const SeedTriple k = seed_triple(seed_lo, seed_hi, epoch, seeds);
  const uint32_t total = KEY_HEAD + (uint32_t)S * key_stride(rounds);
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x)
    keys[i] = source_key_word(i, src, rounds, k);
}

// Stages the source table and the keys buffer in shared memory (`staged`)
// when P.stage, the keys copied from `keys_g` or, where it is null, derived
// from the scalars or the device triple; points `keys` and `src` at the
// staged copies, else at global memory.
__device__ __forceinline__ void stage_tables(const MixParams &P,
                                             uint32_t *staged,
                                             const uint32_t *src_g,
                                             const uint32_t *keys_g,
                                             const SeedTriple &seed_args,
                                             const uint32_t *seeds,
                                             const uint32_t *&keys,
                                             const uint32_t *&src) {
  const uint32_t key_words = KEY_HEAD + P.S * key_stride(P.rounds);
  keys = keys_g;
  src = src_g;
  if (!P.stage) return;
  // the source table first: the derived key words read it
  for (uint32_t i = threadIdx.x; i < P.S * SRC_COLS; i += blockDim.x)
    staged[key_words + i] = __ldg(src_g + i);
  if (keys_g == nullptr) {
    __syncthreads();
    const SeedTriple k =
        seed_triple(seed_args.lo, seed_args.hi, seed_args.ep, seeds);
    for (uint32_t i = threadIdx.x; i < key_words; i += blockDim.x)
      staged[i] = source_key_word(i, staged + key_words, P.rounds, k);
  } else {
    for (uint32_t i = threadIdx.x; i < key_words; i += blockDim.x)
      staged[i] = __ldg(keys_g + i);
  }
  __syncthreads();
  keys = staged;
  src = staged + key_words;
}

// Lane t's stream position: the given one, or the rank's own.
template <typename Pos>
__device__ __forceinline__ Pos lane_position(Pos t, const MixParams &P,
                                             const int64_t *positions) {
  return positions != nullptr
             ? (Pos)positions[t]
             : (P.strided ? (Pos)P.rank + (Pos)P.world * t
                          : (Pos)P.rank * (Pos)P.lanes + t);
}

// What position p draws: its source s, the source's table row, and j, the
// source's own stream position (draws of s in the blocks before p's and in
// p's block before its slot), in Pos arithmetic.
template <typename Pos>
struct Draw {
  const uint32_t *row;
  uint32_t s;
  Pos j;
};

template <typename Pos>
__device__ __forceinline__ Draw<Pos> lane_draw(Pos p, const MixParams &P,
                                               uint32_t rk,
                                               const int32_t *pattern,
                                               const int32_t *prefix,
                                               const uint32_t *src) {
  const Pos B = (Pos)P.block;
  const Pos blk = p / B;
  const uint32_t tt = (uint32_t)(p - blk * B);
  uint32_t slot = tt, rot = 0;
  bool wrap = false;
  if (P.rotated) {
    rot = mix32(rk ^ (uint32_t)blk) % P.block;
    const uint32_t a = tt + rot;
    wrap = a >= P.block;
    slot = wrap ? a - P.block : a;
  }
  const uint32_t s = (uint32_t)__ldg(pattern + slot);
  const uint32_t *row = src + s * SRC_COLS;
  const uint32_t k_s = row[4];
  int32_t cnt = __ldg(prefix + (size_t)slot * P.S + s);
  if (P.rotated)
    cnt = cnt + (wrap ? (int32_t)k_s : 0) -
          __ldg(prefix + (size_t)rot * P.S + s);
  return {row, s, blk * (Pos)k_s + (Pos)(uint32_t)cnt};
}

// q = a / b, r = a % b for b >= 1: a 32-bit divide where both fit in 32
// bits, else a 64-bit one.
__device__ __forceinline__ void wide_divmod(uint64_t a, uint64_t b,
                                            uint64_t &q, uint64_t &r) {
  if (((a | b) >> 32) == 0) {
    const uint32_t q32 = (uint32_t)a / (uint32_t)b;
    q = q32;
    r = (uint32_t)a - q32 * (uint32_t)b;
  } else {
    q = a / b;
    r = a - q * b;
  }
}

// Pos: position type and lane counter (uint64 where positions reach 2^31);
// Out: id type (int64 where the sources total 2^31 or more).  Wide is
// mixture_fused_wide: n_s and body_s derived in uint64 from the table's
// 32-bit nw, W and tail (its n and body columns hold the low words only),
// u and idx in uint64; else mixture_fused, every source below 2^31.
template <typename Pos, typename Out, bool Wide>
__global__ void __launch_bounds__(THREADS)
    mixture_fused_kernel(Out *__restrict__ out,
                         const int64_t *__restrict__ positions, MixParams P,
                         const int32_t *__restrict__ pattern,
                         const int32_t *__restrict__ prefix,
                         const uint32_t *__restrict__ src_g,
                         const uint32_t *__restrict__ keys_g,
                         SeedTriple seed_args,
                         const uint32_t *__restrict__ seeds) {
  using U = std::conditional_t<Wide, uint64_t, uint32_t>;
  extern __shared__ uint32_t staged[];
  const int stride_k = key_stride(P.rounds);
  const uint32_t *keys, *src;
  stage_tables(P, staged, src_g, keys_g, seed_args, seeds, keys, src);
  const uint32_t rk = keys[0], ep = keys[1];
  const Pos stride = (Pos)gridDim.x * blockDim.x;
  for (Pos t = (Pos)blockIdx.x * blockDim.x + threadIdx.x; t < (Pos)P.lanes;
       t += stride) {
    const Draw<Pos> d = lane_draw(lane_position(t, P, positions), P, rk,
                                  pattern, prefix, src);
    const uint32_t *row = d.row;
    const uint32_t W = row[1], nw = row[2], tail = row[3];
    U body, u;
    uint32_t pas;
    if constexpr (Wide) {
      body = (uint64_t)nw * W;
      uint64_t q;
      wide_divmod((uint64_t)d.j, body + tail, q, u);
      pas = (uint32_t)q;
    } else {
      body = row[5];
      const uint32_t n_s = row[0];
      const Pos q = d.j / (Pos)n_s;
      u = (uint32_t)(d.j - q * (Pos)n_s);
      pas = (uint32_t)q;
    }
    U idx = u;
    if (P.shuffle) {
      const uint32_t *ks = keys + KEY_HEAD + d.s * stride_k;
      const uint32_t ep_u = mix32(ep ^ mix32(pas ^ C_PASS));
      const uint32_t ek = epoch_key(ks[0], ep_u);
      if (u < body) {
        uint32_t win, r0;
        if constexpr (Wide) {
          uint64_t q, r;
          wide_divmod(u, W, q, r);
          win = (uint32_t)q;
          r0 = (uint32_t)r;
        } else {
          win = u / W;
          r0 = u - win * W;
        }
        const uint32_t kw =
            P.order_windows
                ? swap_or_not(win, nw, ks + 1, mix32(ek ^ C_OUTER), P.rounds)
                : win;
        idx = (U)kw * W + swap_or_not(r0, W, ks + 1 + P.rounds,
                                      inner_key(ek, kw), P.rounds);
      } else {
        idx = body + swap_or_not((uint32_t)(u - body), tail,
                                 ks + 1 + 2 * P.rounds, mix32(ek ^ C_TAIL),
                                 P.rounds);
      }
    }
    const uint64_t base = (uint64_t)row[6] | ((uint64_t)row[7] << 32);
    out[t] = (Out)(base + idx);
  }
}

template <typename Pos, typename Out>
void launch_fused(bool wide_law, void *out, const void *positions,
                  const MixParams &P, size_t smem, const void *pattern,
                  const void *prefix, const void *src, const void *keys,
                  const SeedTriple &k, const void *seeds,
                  cudaStream_t stream) {
  auto kernel = wide_law ? mixture_fused_kernel<Pos, Out, true>
                         : mixture_fused_kernel<Pos, Out, false>;
  kernel<<<grid_for(P.lanes), THREADS, smem, stream>>>(
      (Out *)out, (const int64_t *)positions, P, (const int32_t *)pattern,
      (const int32_t *)prefix, (const uint32_t *)src, (const uint32_t *)keys,
      k, (const uint32_t *)seeds);
}

// The launch of mixture_fused (wide_law 0) or mixture_fused_wide (1).
int launch_mixture(bool wide_law, void *out, const void *positions,
                   uint64_t lanes, uint64_t rank, uint64_t world, int strided,
                   uint32_t block, int S, const void *pattern,
                   const void *prefix, const void *src, const void *keys,
                   uint32_t seed_lo, uint32_t seed_hi, uint32_t epoch,
                   const void *seeds, int rounds, int shuffle,
                   int order_windows, int rotated, int wide_pos, int wide_out,
                   void *stream) {
  if (lanes == 0 || S < 1 || block < (uint32_t)S || block > INT32_MAX_U ||
      rounds < 0 || rounds > MAX_ROUNDS || (!wide_pos && lanes > INT32_MAX_U) ||
      (positions == nullptr && (world == 0 || rank >= world)) ||
      (keys == nullptr && staged_words(S, rounds) > STAGE_WORDS_CAP))
    return (int)cudaErrorInvalidValue;
  MixParams P;
  P.lanes = lanes;
  P.rank = rank;
  P.world = world;
  P.block = block;
  P.S = (uint32_t)S;
  P.rounds = rounds;
  P.strided = strided;
  P.shuffle = shuffle;
  P.order_windows = order_windows;
  P.rotated = rotated;
  const uint64_t words = staged_words(S, rounds);
  P.stage = words <= STAGE_WORDS_CAP;
  const size_t smem = P.stage ? words * sizeof(uint32_t) : 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const SeedTriple k{seed_lo, seed_hi, epoch};
  if (wide_pos && wide_out)
    launch_fused<uint64_t, int64_t>(wide_law, out, positions, P, smem,
                                    pattern, prefix, src, keys, k, seeds, st);
  else if (wide_pos)
    launch_fused<uint64_t, int32_t>(wide_law, out, positions, P, smem,
                                    pattern, prefix, src, keys, k, seeds, st);
  else if (wide_out)
    launch_fused<uint32_t, int64_t>(wide_law, out, positions, P, smem,
                                    pattern, prefix, src, keys, k, seeds, st);
  else
    launch_fused<uint32_t, int32_t>(wide_law, out, positions, P, smem,
                                    pattern, prefix, src, keys, k, seeds, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psds_mixture_source_keys(void *keys, const void *src, int S,
                                        int rounds, uint32_t seed_lo,
                                        uint32_t seed_hi, uint32_t epoch,
                                        const void *seeds, void *stream) {
  if (S < 1 || rounds < 0 || rounds > MAX_ROUNDS)
    return (int)cudaErrorInvalidValue;
  const uint64_t total = KEY_HEAD + (uint64_t)S * key_stride(rounds);
  mixture_source_keys_kernel<<<grid_for(total), THREADS, 0,
                               (cudaStream_t)stream>>>(
      (uint32_t *)keys, (const uint32_t *)src, S, rounds, seed_lo, seed_hi,
      epoch, (const uint32_t *)seeds);
  return (int)cudaGetLastError();
}

// `positions` (nullable): int64 stream positions, one per lane, in place of
// the rank's own (rank, world, strided) positions.  `keys` (nullable): the
// mixture_source_keys buffer of this regen; null folds the key derivation
// into the kernel's prologue, from the scalars or from `seeds` (nullable,
// the device triple), which takes staged keys (STAGE_WORDS_CAP).
extern "C" int psds_mixture_fused(void *out, const void *positions,
                                  uint64_t lanes, uint64_t rank,
                                  uint64_t world, int strided, uint32_t block,
                                  int S, const void *pattern,
                                  const void *prefix, const void *src,
                                  const void *keys, uint32_t seed_lo,
                                  uint32_t seed_hi, uint32_t epoch,
                                  const void *seeds, int rounds, int shuffle,
                                  int order_windows, int rotated, int wide_pos,
                                  int wide_out, void *stream) {
  return launch_mixture(false, out, positions, lanes, rank, world, strided,
                        block, S, pattern, prefix, src, keys, seed_lo,
                        seed_hi, epoch, seeds, rounds, shuffle, order_windows,
                        rotated, wide_pos, wide_out, stream);
}

// The arguments of psds_mixture_fused; the same source table, whose n and
// body columns the kernel recomputes in uint64 from nw, W and the tail.
extern "C" int psds_mixture_fused_wide(
    void *out, const void *positions, uint64_t lanes, uint64_t rank,
    uint64_t world, int strided, uint32_t block, int S, const void *pattern,
    const void *prefix, const void *src, const void *keys, uint32_t seed_lo,
    uint32_t seed_hi, uint32_t epoch, const void *seeds, int rounds,
    int shuffle, int order_windows, int rotated, int wide_pos, int wide_out,
    void *stream) {
  return launch_mixture(true, out, positions, lanes, rank, world, strided,
                        block, S, pattern, prefix, src, keys, seed_lo,
                        seed_hi, epoch, seeds, rounds, shuffle, order_windows,
                        rotated, wide_pos, wide_out, stream);
}
