// Hand-written CUDA kernels for shard-index mode (SPEC.md §7) on Hopper.
// They replace the XLA programs of the JAX package's shard expansion
// (partiallyshuffledistributedsampler_tpu/sampler/shard_mode.py): the
// per-size-class programs _class_expand_jit over _batched_shard_orders, the
// power-of-two buckets _bucket_expand_jit with _rowwise_swap, the donated
// scatter _bucket_scatter_jit, and the per-row key columns of
// _shard_epoch_keys.  The JAX package has no Pallas kernel for them.
//
//   shard_row_keys -> the record of each row of the rank's shard stream
//                     (one selected shard): from the seed and the row's
//                     shard id the folded shard seed (seed ^ (STRIDE +
//                     sid), the 64-bit add carried in uint32 halves), its
//                     epoch key, the inner pairing key and the tail key,
//                     the body length, and the pairing constants of the
//                     row's two bijections (inner over W_row, tail over
//                     m - body).  A block takes ROW_BLOCK consecutive rows:
//                     one thread per row derives the row's head into shared
//                     memory, then the whole block sweeps the rows' record
//                     words, one thread per RUN consecutive words.
//   shard_expand   -> one thread per output lane t, in the rank's stream
//                     order: the row i with start_i <= t < start_i + m_i
//                     (t / m for uniform sizes, else a binary search over
//                     the inclusive prefix `ends`, which skips zero-size
//                     rows), u = t - start_i, the §7.2 within-shard law at
//                     u with the row's keys, plus the shard's offset.
//
// Row record (uint32, ROW_HEAD + 2*rounds words): ek, inner pair key, tail
// key, body = nw*W_row (m where W_row <= 1), K_inner[rounds], K_tail[rounds]
// with K_r = mix32(pair ^ r*GOLDEN) mod domain (0 where the domain is <= 1).
// W_row = m for the full in-shard shuffle, min(w, m) for a window w (w = 0
// is sequential); W_row <= 1 leaves the row in storage order.
//
// Per lane, with W = W_row: u < body takes win = u / W (0 in full mode),
// idx = win*W + swap_or_not(u mod W, W, K_inner, inner_key(ek, win)); a tail
// lane takes idx = body + swap_or_not(u - body, m - body, K_tail, tk), the
// tail key serving as decision and pairing key (shard_mode.py:422-425).
//
// What bounds shard_expand: integer operations (one 24-round bijection per
// lane, its inner key, and for mixed sizes ~log2(R) cached loads of the
// binary search); each lane writes 4 or 8 bytes and reads a row record that
// its neighbours share.  The row records live in a global [R, 4 + 2*rounds]
// table read through the cache: a block of 256 lanes spans one row at
// m = 1000, so the constants are read by the whole block from L1.
//
// What bounds shard_row_keys: the bytes of the table it writes, 4*(4 +
// 2*rounds) per row (208 at 24 rounds: 20.8 MB at 100,000 rows, 6 us at
// 3.35 TB/s), against ~11 int32 operations per pairing constant counting a
// `%` as one; at 12,500 rows (2.6 MB) the launch itself.  So the stores
// must coalesce and the grid must fill the card.  A block's ROW_BLOCK rows
// are one contiguous range of ROW_BLOCK*(4 + 2*rounds) words.  Phase 1:
// ROW_BLOCK threads each load one row's shard id and size and derive its
// head (seed fold, ek, pair, tail key, W_row, body, m - body) into shared
// memory, and write m_of.  Phase 2, after a barrier: the block's threads
// walk its rows' units, consecutive threads on consecutive units.  A unit
// is a row's head, or a run of RUN pairing constants of one of its
// schedules, round_key(pair or tk, W_row or m - body, r..r+3): the four
// share their modulus, so the reciprocal that the compiler's `%` sequence
// derives from it is taken once, not four times, and a unit is one 16-byte
// store when rounds % RUN == 0 (24 rounds: 13 units a row).  No thread
// derives a row's keys twice, and 12,500 rows make 391 blocks (with one
// thread per row they were 49 blocks writing 208 bytes apart).  One word
// a thread, each with its own `%`, was slower in trials on the H100; so
// were a 64-bit multiply-shift remainder in place of `%`, and 8 or 16 rows
// a block.  What keeps it from its byte bound at 100,000 rows is the `%`
// by a runtime divisor, a sequence of a reciprocal, a multiply-high and
// corrections where the bound counts one operation (chip_smoke.py times a
// fill of the same table beside the kernel).
//
// Build (plain C ABI, loaded with ctypes by ops/cuda_kernel.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libpsds_shard_kernels.so shard_kernels.cu
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success).

#include "law.cuh"

namespace {

constexpr uint64_t SHARD_SEED_STRIDE = 0x9E3779B97F4A7C15ull;
constexpr int ROW_HEAD = 4;  // ek, inner pair key, tail key, body
constexpr int ROW_BLOCK = 32;  // rows per block of shard_row_keys
constexpr int RUN = 4;  // record words per thread of shard_row_keys
static_assert(RUN == ROW_HEAD, "a head unit is one run of words");

// A read-only 64-bit load through the cache (__ldg's overload is long long).
__device__ __forceinline__ int64_t ld64(const int64_t *p) {
  return (int64_t)__ldg((const long long *)p);
}

struct ExpandParams {
  uint64_t lanes, rows;
  uint32_t m_uniform, w;
  int full, rounds;
};

__global__ void __launch_bounds__(THREADS)
    shard_row_keys_kernel(uint32_t *__restrict__ rowtab,
                          int64_t *__restrict__ m_of,
                          const int32_t *__restrict__ sids, uint64_t rows,
                          const int64_t *__restrict__ sizes, uint32_t w,
                          int full, int rounds, uint32_t seed_lo,
                          uint32_t seed_hi, uint32_t epoch,
                          const uint32_t *__restrict__ seeds) {
  // per row of the block: the four head words, then W_row and m - body
  __shared__ uint32_t head[ROW_BLOCK][ROW_HEAD + 2];
  uint32_t lo = seed_lo, hi = seed_hi, ep = epoch;
  if (seeds != nullptr) {
    lo = __ldg(seeds);
    hi = __ldg(seeds + 1);
    ep = __ldg(seeds + 2);
  }
  const uint32_t stride = ROW_HEAD + 2 * (uint32_t)rounds;
  const uint32_t runs = ((uint32_t)rounds + RUN - 1) / RUN;  // per schedule
  const uint32_t units = 1 + 2 * runs;                        // per row
  // block-uniform loop: every thread reaches both barriers equally often
  for (uint64_t base = (uint64_t)blockIdx.x * ROW_BLOCK; base < rows;
       base += (uint64_t)gridDim.x * ROW_BLOCK) {
    const uint32_t nr =
        rows - base < ROW_BLOCK ? (uint32_t)(rows - base) : ROW_BLOCK;
    if (threadIdx.x < nr) {
      const uint64_t i = base + threadIdx.x;
      const uint32_t sid = (uint32_t)__ldg(sids + i);
      const uint32_t m = (uint32_t)ld64(sizes + sid);
      const uint32_t sum_lo = (uint32_t)SHARD_SEED_STRIDE + sid;
      const uint32_t carry = sum_lo < sid ? 1u : 0u;
      const uint32_t s_lo = lo ^ sum_lo;
      const uint32_t s_hi =
          hi ^ ((uint32_t)(SHARD_SEED_STRIDE >> 32) + carry);
      const uint32_t ek = epoch_key(seed_key(s_lo, s_hi), ep);
      const uint32_t W = full ? m : (w < m ? w : m);
      const uint32_t body = W > 1 ? (m / W) * W : m;
      uint32_t *h = head[threadIdx.x];
      h[0] = ek;
      h[1] = mix32(ek ^ C_PAIR);
      h[2] = mix32(ek ^ C_TAIL);
      h[3] = body;
      h[4] = W;
      h[5] = m - body;
      if (m_of != nullptr) m_of[i] = (int64_t)m;
    }
    __syncthreads();
    // unit u of the block: row u / units, then its head or a run of up to
    // RUN constants of one schedule, which share their modulus
    for (uint32_t u = threadIdx.x; u < nr * units; u += blockDim.x) {
      const uint32_t r = u / units, x = u - r * units;
      const uint32_t *h = head[r];
      uint32_t v[RUN] = {h[0], h[1], h[2], h[3]}, n = RUN, c = 0;
      if (x > 0) {
        const bool tail = x > runs;
        const uint32_t r0 = RUN * (tail ? x - 1 - runs : x - 1);
        const uint32_t pair = h[tail ? 2 : 1], d = h[tail ? 5 : 4];
        n = (uint32_t)rounds - r0 < RUN ? (uint32_t)rounds - r0 : RUN;
        c = ROW_HEAD + (tail ? (uint32_t)rounds : 0u) + r0;
#pragma unroll
        for (int j = 0; j < RUN; ++j) v[j] = round_key(pair, d, (int)r0 + j);
      }
      uint32_t *dst = rowtab + (base + r) * stride + c;
      if (n == RUN && rounds % RUN == 0)  // then every unit is 16-byte aligned
        *reinterpret_cast<uint4 *>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      else
        for (uint32_t j = 0; j < n; ++j) dst[j] = v[j];
    }
    __syncthreads();
  }
}

// Lane: lane counter and row arithmetic (uint64 where the lanes reach 2^31);
// Out: index type (int64 where the whole shard space sums past 2^31).
template <typename Lane, typename Out>
__global__ void __launch_bounds__(THREADS)
    shard_expand_kernel(Out *__restrict__ out,
                        const int32_t *__restrict__ sids,
                        const int64_t *__restrict__ offsets,
                        const int64_t *__restrict__ ends,
                        const uint32_t *__restrict__ rowtab, ExpandParams P) {
  const uint64_t stride = ROW_HEAD + 2 * (uint64_t)P.rounds;
  const Lane step = (Lane)gridDim.x * blockDim.x;
  for (Lane t = (Lane)blockIdx.x * blockDim.x + threadIdx.x; t < (Lane)P.lanes;
       t += step) {
    Lane i, start;
    uint32_t m;
    if (ends == nullptr) {
      i = t / (Lane)P.m_uniform;
      start = i * (Lane)P.m_uniform;
      m = P.m_uniform;
    } else {
      // the first row whose inclusive end passes t: zero-size rows share
      // their predecessor's end and are never chosen
      Lane a = 0, b = (Lane)(P.rows - 1);
      while (a < b) {
        const Lane mid = a + (b - a) / 2;
        if ((Lane)ld64(ends + mid) > t)
          b = mid;
        else
          a = mid + 1;
      }
      i = a;
      start = i ? (Lane)ld64(ends + i - 1) : (Lane)0;
      m = (uint32_t)((Lane)ld64(ends + i) - start);
    }
    const uint32_t u = (uint32_t)(t - start);
    const uint32_t W = P.full ? m : (P.w < m ? P.w : m);
    uint32_t idx = u;
    if (W > 1) {
      const uint32_t *row = rowtab + (uint64_t)i * stride;
      const uint32_t body = __ldg(row + 3);
      if (u < body) {
        const uint32_t win = P.full ? 0u : u / W;
        idx = win * W + swap_or_not(u - win * W, W, row + ROW_HEAD,
                                    inner_key(__ldg(row), win), P.rounds);
      } else {
        idx = body + swap_or_not(u - body, m - body,
                                 row + ROW_HEAD + P.rounds, __ldg(row + 2),
                                 P.rounds);
      }
    }
    out[t] = (Out)(ld64(offsets + __ldg(sids + i)) + (int64_t)idx);
  }
}

template <typename Lane, typename Out>
void launch_expand(void *out, const void *sids, const void *offsets,
                   const void *ends, const void *rowtab,
                   const ExpandParams &P, cudaStream_t stream) {
  shard_expand_kernel<Lane, Out><<<grid_for(P.lanes), THREADS, 0, stream>>>(
      (Out *)out, (const int32_t *)sids, (const int64_t *)offsets,
      (const int64_t *)ends, (const uint32_t *)rowtab, P);
}

}  // namespace

// `m_of` (nullable): int64 [rows], each row's shard size, for the prefix of
// mixed sizes.  `seeds` (nullable): the uint32 triple (seed_lo, seed_hi,
// epoch) in device memory, in place of the scalars.
extern "C" int psds_shard_row_keys(void *rowtab, void *m_of, const void *sids,
                                   uint64_t rows, const void *sizes,
                                   uint32_t w, int full, int rounds,
                                   uint32_t seed_lo, uint32_t seed_hi,
                                   uint32_t epoch, const void *seeds,
                                   void *stream) {
  if (rows == 0 || rounds < 0 || rounds > MAX_ROUNDS)
    return (int)cudaErrorInvalidValue;
  const uint64_t blocks = (rows + ROW_BLOCK - 1) / ROW_BLOCK;
  shard_row_keys_kernel<<<grid_cap(blocks), THREADS, 0,
                          (cudaStream_t)stream>>>(
      (uint32_t *)rowtab, (int64_t *)m_of, (const int32_t *)sids, rows,
      (const int64_t *)sizes, w, full, rounds, seed_lo, seed_hi, epoch,
      (const uint32_t *)seeds);
  return (int)cudaGetLastError();
}

// `ends` (nullable): int64 [rows], the inclusive prefix of the rows' sizes;
// null means every row has `m_uniform` lanes.
extern "C" int psds_shard_expand(void *out, const void *sids,
                                 const void *offsets, const void *ends,
                                 const void *rowtab, uint64_t lanes,
                                 uint64_t rows, uint32_t m_uniform, uint32_t w,
                                 int full, int rounds, int wide_out,
                                 void *stream) {
  if (lanes == 0 || rows == 0 || rounds < 0 || rounds > MAX_ROUNDS ||
      (ends == nullptr && (m_uniform == 0 || lanes != rows * m_uniform)))
    return (int)cudaErrorInvalidValue;
  ExpandParams P;
  P.lanes = lanes;
  P.rows = rows;
  P.m_uniform = m_uniform;
  P.w = w;
  P.full = full;
  P.rounds = rounds;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool wide_lane = lanes > INT32_MAX_U;
  if (wide_lane && wide_out)
    launch_expand<uint64_t, int64_t>(out, sids, offsets, ends, rowtab, P, st);
  else if (wide_lane)
    launch_expand<uint64_t, int32_t>(out, sids, offsets, ends, rowtab, P, st);
  else if (wide_out)
    launch_expand<uint32_t, int64_t>(out, sids, offsets, ends, rowtab, P, st);
  else
    launch_expand<uint32_t, int32_t>(out, sids, offsets, ends, rowtab, P, st);
  return (int)cudaGetLastError();
}
