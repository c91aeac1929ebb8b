// Hand-written CUDA kernels for shard-index mode (SPEC.md §7) on Hopper.
// They replace the XLA programs of the JAX package's shard expansion
// (partiallyshuffledistributedsampler_tpu/sampler/shard_mode.py): the
// per-size-class programs _class_expand_jit over _batched_shard_orders, the
// power-of-two buckets _bucket_expand_jit with _rowwise_swap, the donated
// scatter _bucket_scatter_jit, and the per-row key columns of
// _shard_epoch_keys.  The JAX package has no Pallas kernel for them.
//
//   shard_row_keys -> one thread per row of the rank's shard stream (one
//                     selected shard): from the seed and the row's shard id
//                     the folded shard seed (seed ^ (STRIDE + sid), the
//                     64-bit add carried in uint32 halves), its epoch key,
//                     the inner pairing key and the tail key, the body
//                     length, and the pairing constants of the row's two
//                     bijections (inner over W_row, tail over m - body).
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
// shard_row_keys is O(rows): 2*rounds modular round keys per row.
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
  uint32_t lo = seed_lo, hi = seed_hi, ep = epoch;
  if (seeds != nullptr) {
    lo = __ldg(seeds);
    hi = __ldg(seeds + 1);
    ep = __ldg(seeds + 2);
  }
  const uint64_t stride = ROW_HEAD + 2 * (uint64_t)rounds;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; i < rows;
       i += (uint64_t)gridDim.x * blockDim.x) {
    const uint32_t sid = (uint32_t)__ldg(sids + i);
    const uint32_t m = (uint32_t)ld64(sizes + sid);
    const uint32_t sum_lo = (uint32_t)SHARD_SEED_STRIDE + sid;
    const uint32_t carry = sum_lo < sid ? 1u : 0u;
    const uint32_t s_lo = lo ^ sum_lo;
    const uint32_t s_hi = hi ^ ((uint32_t)(SHARD_SEED_STRIDE >> 32) + carry);
    const uint32_t ek = epoch_key(seed_key(s_lo, s_hi), ep);
    const uint32_t pair = mix32(ek ^ C_PAIR);
    const uint32_t tk = mix32(ek ^ C_TAIL);
    const uint32_t W = full ? m : (w < m ? w : m);
    const uint32_t body = W > 1 ? (m / W) * W : m;
    uint32_t *row = rowtab + i * stride;
    row[0] = ek;
    row[1] = pair;
    row[2] = tk;
    row[3] = body;
    for (int r = 0; r < rounds; ++r) {
      row[ROW_HEAD + r] = round_key(pair, W, r);
      row[ROW_HEAD + rounds + r] = round_key(tk, m - body, r);
    }
    if (m_of != nullptr) m_of[i] = (int64_t)m;
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
  shard_row_keys_kernel<<<grid_for(rows), THREADS, 0, (cudaStream_t)stream>>>(
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
