// Hand-written CUDA kernels for the epoch-index law (SPEC.md) on Hopper.
//
// Three kernels, one set of __device__ functions for the law:
//
//   window_order_ids  -> replaces the window-order pre-pass
//                        partiallyshuffledistributedsampler_tpu/ops/xla.py
//                        _window_order_ids (XLA there, not Pallas): one
//                        thread per window slot j writes
//                        ku[j] = swap_or_not(j, nw, outer_key(ek)).
//   index_general     -> replaces the Pallas kernel
//                        partiallyshuffledistributedsampler_tpu/ops/
//                        pallas_kernel.py _index_kernel: one thread per
//                        output lane, the full windowed permutation.
//   index_amortized   -> replaces the Pallas kernel
//                        partiallyshuffledistributedsampler_tpu/ops/
//                        pallas_kernel.py _amortized_kernel (+ its
//                        _expand_window_ids): body lanes read their source
//                        window ku[t / m] straight from global memory and run
//                        only the inner bijection; lanes t >= body (tail
//                        window, wrap padding) take the general law in the
//                        same launch.
//
// What bounds them: integer operations, not bytes.  A bijection costs
// `rounds` (24) rounds of ~18 int32 operations per element (add, wrap
// compare/subtract/select, max, two xors, the 8-operation mix32, bit test
// and select); the general law runs two bijections per element, the
// amortized one.  Each element writes 4 bytes and reads none (the amortized
// kernel reads 4 bytes per m elements).  The design follows from that: no
// input tiles, no shared-memory staging of data, one lane per thread with
// a grid-stride loop; the only shared memory holds the per-round pairing
// constants K_r = mix32(pair ^ r*GOLDEN) mod m, which depend on scalars
// only and are computed once per block (at most 3 schedules x 64 rounds),
// never per element.  Division and modulo by the runtime m, W and n are
// plain `/` and `%` (fast-divmod magic numbers are a known next step).
//
// Every operation keeps the order of ops/core.py: uint32 wrap-around
// arithmetic throughout, partner = K_r + (m - x) then -m if >= m, the
// canonical member as an unsigned max by select, the decision bit
// mix32(c ^ key2 ^ r*RC_BIT) & 1, m <= 1 returns x, and the index clips of
// the window id and the tail offset.
//
// Build (plain C ABI, loaded with ctypes by ops/cuda_kernel.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libpsds_index_kernels.so index_kernels.cu
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success).

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

constexpr int MAX_ROUNDS = 64;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

// The static configuration and the per-call scalars of one launch.
struct LawParams {
  uint32_t n, window, world, num_samples, rank;
  uint32_t nw, body_len, tail_len;  // n / window, nw * window, n - body_len
  uint32_t seed_lo, seed_hi, epoch;
  int rounds, shuffle, order_windows, strided;
};

// Keys that depend on (seed, epoch) only.
struct Keys {
  uint32_t ek, okey, tkey, pair_inner;
};

// Pairing constants of the three bijections, shared by the block.
struct Schedules {
  uint32_t outer[MAX_ROUNDS], inner[MAX_ROUNDS], tail[MAX_ROUNDS];
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ Keys make_keys(const LawParams &P) {
  uint32_t k = mix32(P.seed_lo ^ GOLDEN);
  k = mix32(k ^ mix32(P.seed_hi ^ C_SEED_HI));
  k = mix32(k ^ mix32(P.epoch ^ C_EPOCH));
  Keys keys;
  keys.ek = k;
  keys.okey = mix32(k ^ C_OUTER);
  keys.tkey = mix32(k ^ C_TAIL);
  keys.pair_inner = mix32(k ^ C_PAIR);
  return keys;
}

// Block-cooperative: K_r for r < rounds.  A domain of m <= 1 never reads
// its schedule (swap_or_not returns x), so it is left at 0 and m = 0 never
// divides.
__device__ __forceinline__ void load_round_keys(uint32_t *ks, uint32_t pair,
                                                uint32_t m, int rounds) {
  for (int r = threadIdx.x; r < rounds; r += blockDim.x)
    ks[r] = m > 1 ? mix32(pair ^ ((uint32_t)r * GOLDEN)) % m : 0u;
}

// Swap-or-not keyed bijection on [0, m), decision key `key`, pairing
// constants `ks` (SPEC.md §2; ops/core.py swap_or_not).
__device__ __forceinline__ uint32_t swap_or_not(uint32_t x, uint32_t m,
                                                const uint32_t *ks,
                                                uint32_t key, int rounds) {
  if (m <= 1) return x;
  const uint32_t key2 = mix32(key ^ C_BIT);
  for (int r = 0; r < rounds; ++r) {
    uint32_t partner = ks[r] + (m - x);
    partner = partner >= m ? partner - m : partner;
    const uint32_t c = x > partner ? x : partner;
    const uint32_t b = mix32(c ^ key2 ^ ((uint32_t)r * RC_BIT));
    x = (b & 1u) ? partner : x;
  }
  return x;
}

__device__ __forceinline__ uint32_t inner_key(const Keys &k, uint32_t wid) {
  return mix32(k.ek ^ C_INNER ^ mix32(wid ^ C_WIN));
}

// The windowed permutation pi(p) for one position p in [0, n)
// (ops/core.py windowed_perm).  The reference evaluates the body and the
// tail law on every lane and selects by p < body_len; a lane here
// evaluates only the law it selects, which gives the same value.
__device__ __forceinline__ uint32_t windowed_perm(uint32_t p,
                                                  const LawParams &P,
                                                  const Keys &k,
                                                  const Schedules &s) {
  if (p < P.body_len) {
    uint32_t j = p / P.window;
    j = j > P.nw - 1 ? P.nw - 1 : j;
    const uint32_t r0 = p % P.window;
    const uint32_t kw = (P.order_windows && P.nw > 1)
                            ? swap_or_not(j, P.nw, s.outer, k.okey, P.rounds)
                            : j;
    return kw * P.window +
           swap_or_not(r0, P.window, s.inner, inner_key(k, kw), P.rounds);
  }
  uint32_t tpos = p - P.body_len;
  tpos = tpos > P.tail_len - 1 ? P.tail_len - 1 : tpos;
  return P.body_len + swap_or_not(tpos, P.tail_len, s.tail, k.tkey, P.rounds);
}

// Stream position of output lane t, with the uint32 wrap of the reference
// (pallas_kernel.py _index_kernel) before the mod n.
__device__ __forceinline__ uint32_t stream_position(uint32_t t,
                                                    const LawParams &P) {
  const uint32_t p =
      P.strided ? P.rank + P.world * t : P.rank * P.num_samples + t;
  return p % P.n;
}

__device__ __forceinline__ void load_schedules(Schedules &s,
                                               const LawParams &P,
                                               const Keys &k) {
  load_round_keys(s.outer, k.okey, P.nw, P.rounds);
  load_round_keys(s.inner, k.pair_inner, P.window, P.rounds);
  load_round_keys(s.tail, k.tkey, P.tail_len, P.rounds);
}

__global__ void __launch_bounds__(THREADS)
    window_order_ids_kernel(uint32_t *__restrict__ ku, LawParams P) {
  __shared__ uint32_t ks[MAX_ROUNDS];
  const Keys k = make_keys(P);
  load_round_keys(ks, k.okey, P.nw, P.rounds);
  __syncthreads();
  const bool permute = P.order_windows && P.nw > 1;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < P.nw;
       j += stride)
    ku[j] = permute ? swap_or_not(j, P.nw, ks, k.okey, P.rounds) : j;
}

__global__ void __launch_bounds__(THREADS)
    index_general_kernel(int32_t *__restrict__ out, LawParams P) {
  __shared__ Schedules s;
  const Keys k = make_keys(P);
  load_schedules(s, P, k);
  __syncthreads();
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < P.num_samples;
       t += stride) {
    const uint32_t p = stream_position(t, P);
    out[t] = (int32_t)(P.shuffle ? windowed_perm(p, P, k, s) : p);
  }
}

// Strided, shuffled, window % world == 0, nw >= 1: lane t < body = nw * m
// sits in output window slot t / m at in-window offset
// rank + world * (t % m), so its source window is ku[t / m] and only the
// inner bijection remains per element.
__global__ void __launch_bounds__(THREADS)
    index_amortized_kernel(int32_t *__restrict__ out,
                           const uint32_t *__restrict__ ku, LawParams P,
                           uint32_t m, uint32_t body) {
  __shared__ Schedules s;
  const Keys k = make_keys(P);
  load_schedules(s, P, k);
  __syncthreads();
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < P.num_samples;
       t += stride) {
    uint32_t v;
    if (t < body) {
      const uint32_t slot = t / m;
      const uint32_t kex = __ldg(ku + slot);
      const uint32_t r0 = P.rank + P.world * (t % m);
      v = kex * P.window +
          swap_or_not(r0, P.window, s.inner, inner_key(k, kex), P.rounds);
    } else {
      v = windowed_perm(stream_position(t, P), P, k, s);
    }
    out[t] = (int32_t)v;
  }
}

LawParams make_params(uint32_t n, uint32_t window, uint32_t world,
                      uint32_t num_samples, uint32_t rank, uint32_t seed_lo,
                      uint32_t seed_hi, uint32_t epoch, int shuffle,
                      int order_windows, int strided, int rounds) {
  LawParams P;
  P.n = n;
  P.window = window;
  P.world = world;
  P.num_samples = num_samples;
  P.rank = rank;
  P.nw = n / window;
  P.body_len = P.nw * window;
  P.tail_len = n - P.body_len;
  P.seed_lo = seed_lo;
  P.seed_hi = seed_hi;
  P.epoch = epoch;
  P.rounds = rounds;
  P.shuffle = shuffle;
  P.order_windows = order_windows;
  P.strided = strided;
  return P;
}

bool bad_config(uint32_t n, uint32_t window, int rounds) {
  return n == 0 || n > 0x7FFFFFFFu || window == 0 || rounds < 0 ||
         rounds > MAX_ROUNDS;
}

unsigned grid_for(uint32_t count) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const uint64_t need = ((uint64_t)count + THREADS - 1) / THREADS;
  const uint64_t cap = (uint64_t)sms * BLOCKS_PER_SM;
  return (unsigned)(need < cap ? need : cap);
}

}  // namespace

extern "C" int psds_window_order_ids(void *ku, uint32_t n, uint32_t window,
                                     uint32_t seed_lo, uint32_t seed_hi,
                                     uint32_t epoch, int order_windows,
                                     int rounds, void *stream) {
  if (bad_config(n, window, rounds) || n / window == 0)
    return (int)cudaErrorInvalidValue;
  const LawParams P = make_params(n, window, 1, 0, 0, seed_lo, seed_hi,
                                  epoch, 1, order_windows, 1, rounds);
  window_order_ids_kernel<<<grid_for(P.nw), THREADS, 0,
                            (cudaStream_t)stream>>>((uint32_t *)ku, P);
  return (int)cudaGetLastError();
}

extern "C" int psds_index_general(void *out, uint32_t n, uint32_t window,
                                  uint32_t world, uint32_t num_samples,
                                  uint32_t rank, uint32_t seed_lo,
                                  uint32_t seed_hi, uint32_t epoch,
                                  int shuffle, int order_windows, int strided,
                                  int rounds, void *stream) {
  if (bad_config(n, window, rounds) || world == 0 || rank >= world ||
      num_samples == 0)
    return (int)cudaErrorInvalidValue;
  const LawParams P =
      make_params(n, window, world, num_samples, rank, seed_lo, seed_hi,
                  epoch, shuffle, order_windows, strided, rounds);
  index_general_kernel<<<grid_for(num_samples), THREADS, 0,
                         (cudaStream_t)stream>>>((int32_t *)out, P);
  return (int)cudaGetLastError();
}

extern "C" int psds_index_amortized(void *out, const void *ku, uint32_t n,
                                    uint32_t window, uint32_t world,
                                    uint32_t num_samples, uint32_t rank,
                                    uint32_t seed_lo, uint32_t seed_hi,
                                    uint32_t epoch, int order_windows,
                                    int rounds, void *stream) {
  if (bad_config(n, window, rounds) || world == 0 || rank >= world ||
      window % world != 0 || n / window == 0 || num_samples == 0)
    return (int)cudaErrorInvalidValue;
  const LawParams P =
      make_params(n, window, world, num_samples, rank, seed_lo, seed_hi,
                  epoch, 1, order_windows, 1, rounds);
  const uint32_t m = window / world;
  const uint32_t body = P.nw * m;
  index_amortized_kernel<<<grid_for(num_samples), THREADS, 0,
                           (cudaStream_t)stream>>>(
      (int32_t *)out, (const uint32_t *)ku, P, m, body);
  return (int)cudaGetLastError();
}
