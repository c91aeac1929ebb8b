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
//   shard_expand   -> every output lane t, in the rank's stream order: the
//                     row i with start_i <= t < start_i + m_i, u = t -
//                     start_i, the §7.2 within-shard law at u with the
//                     row's keys, plus the shard's offset.  Sequential mode
//                     (no window: W <= 1 in every row) is a copy kernel that
//                     reads no record.
//
// Row record (uint32, ROW_HEAD + 2*rounds words): ek, inner pair key, tail
// key, body = nw*W_row (m where W_row <= 1), K_inner[rounds], K_tail[rounds]
// with K_r = mix32(pair ^ r*GOLDEN) mod domain (0 where the domain is <= 1).
// W_row = m for the full in-shard shuffle, min(w, m) for a window w (w = 0
// is sequential); W_row <= 1 leaves the row in storage order.
//
// Per lane, with W = W_row: u < body takes win = u / W (0 where W = m: the
// full shuffle, or m <= w), idx = win*W + swap_or_not(u mod W, W, K_inner,
// inner_key(ek, win)); a tail lane takes idx = body + swap_or_not(u - body,
// m - body, K_tail, tk), the tail key serving as decision and pairing key
// (shard_mode.py:422-425).
//
// What bounds shard_expand: integer operations, one 24-round bijection per
// lane (13 counted operations a round); each lane writes 4 or 8 bytes.  So
// everything a lane does besides its round loop is overhead, and the first
// design (one thread per lane) did a lot of it: a runtime division
// t / m to find the row (a binary search over the global `ends`, ~17
// dependent cached loads, for mixed sizes), a second one, u / W, in window
// mode, the decision key (inner_key and key2: 21 operations) that a whole
// row or window shares, the pairing constants read from global memory in
// every round, and two dependent loads for the shard's offset.  It ran at
// 63.8 % of its bound at S1 (100,000 x 1,000, world 8), 35 % in sequential
// mode.  This design, on the H100:
//
// - Lane tiles.  A block walks tiles of `tile` lanes (the lanes over the
//   resident blocks' whole rounds of tiles, rounded up to a warp, at most
//   EXP_TILE_MAX = 4,096: every block walks as many tiles).  At a tile's
//   start one thread finds its first row, by one division or one binary
//   search over `ends`.
// - The tile's rows in shared memory (stage_tile).  Up to STAGE_ROWS = 64
//   rows, one thread each: the row's end and size, its shard's offset, body,
//   the decision key2 of window 0 and of the tail, and with the block, the
//   rows' pairing constants (2 * rounds words each, while SCHED_WORDS =
//   3,072 hold them: 64 rows at 24 rounds) and, in window mode, the key2 of
//   every window of w lanes the tile cuts (one warp scans the rows' window
//   counts).  At S1 a tile of 3,968 lanes spans 4 to 5 rows.  Rows beyond
//   the budget (tiles of tiny rows, or rounds past 1,536) are read from the
//   record table per lane, as before, their row found by a binary search
//   that starts past the staged rows.
// - No runtime `/` or `%` per lane.  A staged lane's row is t / m as a
//   multiply-high by a magic number (uniform sizes) or a binary search over
//   at most 64 staged ends in shared memory (mixed sizes); u / w is a
//   multiply-high too.  The host computes the magic numbers of m and w
//   (ops/fastdiv.py); a row of m <= w is one window, so w is the only
//   window divisor.
// - The round loop is all the per-lane work that is left:
//   swap_or_not_k2 takes the staged key2, and the constants come from
//   shared memory.
// - Sequential mode copies: a thread writes 4 lanes (int32; 2 int64) with
//   one 16-byte store where they lie in one row, and no shard_row_keys
//   launch precedes it (sampler/shard_mode.py _expand).
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

// ------------------------------------------------------------ shard_expand
// Lanes of a tile: at most EXP_TILE_MAX, a multiple of WARP.
constexpr uint32_t EXP_TILE_MAX = 4096;
constexpr uint32_t WARP = 32;
// Rows a tile stages at most (their heads; the scan of their window counts
// is one warp's, two rows a thread).
constexpr uint32_t STAGE_ROWS = 2 * WARP;
// Pairing constants a tile stages at most (12 KB): 2 * rounds words a row,
// 64 rows at 24 rounds, none past 1,536 rounds.
constexpr uint32_t SCHED_WORDS = 3072;
// Window keys a tile stages: a row cut to the tile holds at most
// len / w + 2 windows of w >= 2 lanes, so a tile's staged rows hold at most
// EXP_TILE_MAX / 2 + 2 * STAGE_ROWS.
constexpr uint32_t WKEY_WORDS = EXP_TILE_MAX / 2 + 2 * STAGE_ROWS;

struct ExpandParams {
  uint64_t lanes, rows;
  uint32_t m_uniform, w, tile;
  int full, rounds;
  Magic32 m32, w32;  // t / m_uniform (uint32 lanes), u / w
  Magic64 m64;       // t / m_uniform (uint64 lanes)
};

__device__ __forceinline__ uint32_t div_m(uint32_t t, const ExpandParams &P) {
  return magic_div(t, P.m32);
}
__device__ __forceinline__ uint64_t div_m(uint64_t t, const ExpandParams &P) {
  return magic_div(t, P.m64);
}

// The row of lane t among rows [lo, hi]: t / m for uniform sizes (ends
// null), else the first row whose inclusive end passes t (zero-size rows
// share their predecessor's end and are never chosen).
template <typename Lane>
__device__ __forceinline__ Lane row_of(Lane t, const ExpandParams &P,
                                       const int64_t *ends, Lane lo,
                                       Lane hi) {
  if (ends == nullptr) return div_m(t, P);
  while (lo < hi) {
    const Lane mid = lo + (hi - lo) / 2;
    if ((Lane)ld64(ends + mid) > t)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// Warp-cooperative row_of over `ends` for a warp-uniform t: 32 probes a
// step, so a search over R rows takes log32(R) dependent loads where one
// thread's takes log2(R).  Every lane returns the row.
template <typename Lane>
__device__ __forceinline__ Lane warp_row_of(Lane t, const int64_t *ends,
                                            Lane lo, Lane hi) {
  const uint32_t lane = threadIdx.x & (WARP - 1);
  while (lo < hi) {  // the row lies in [lo, hi]
    const Lane step = (hi - lo + WARP - 2) / (WARP - 1);
    const Lane k = lo + (Lane)lane * step;  // lane 31 probes hi or past it
    const bool past = k >= hi || (Lane)ld64(ends + k) > t;
    const uint32_t f = __ffs(__ballot_sync(0xFFFFFFFFu, past)) - 1;
    const Lane kf = lo + (Lane)f * step;
    lo = f == 0 ? lo : kf - step + 1;
    hi = kf < hi ? kf : hi;
  }
  return lo;
}

// First lane of row i.
template <typename Lane>
__device__ __forceinline__ Lane row_start(Lane i, const ExpandParams &P,
                                          const int64_t *ends) {
  if (ends == nullptr) return i * (Lane)P.m_uniform;
  return i ? (Lane)ld64(ends + i - 1) : (Lane)0;
}

// The rows of a tile as the block stages them (row j is row first + j).
template <typename Lane>
struct TileRows {
  Lane end[STAGE_ROWS];      // exclusive end lane
  int64_t off[STAGE_ROWS];   // the shard's first global index
  uint32_t m[STAGE_ROWS], body[STAGE_ROWS];
  uint32_t kin2[STAGE_ROWS];  // key2 of window 0 (full, or m <= w)
  uint32_t kt2[STAGE_ROWS];   // key2 of the tail bijection
  uint32_t ek[STAGE_ROWS];    // epoch key: the window keys derive from it
  uint32_t wlo[STAGE_ROWS];   // first of the row's windows in the tile
  uint32_t kb[STAGE_ROWS + 1];  // its window count, then their prefix
  uint32_t wkb[STAGE_ROWS];   // kb - wlo: window win's key is wkey[wkb + win]
  uint32_t sched[SCHED_WORDS];  // K_inner, K_tail of each staged row
  uint32_t wkey[WKEY_WORDS];    // key2 of each staged window (w < m)
  Lane first, stage_end;
  uint32_t staged;
};

// Block-cooperative: the tile [a, b)'s first row, and its first `staged`
// rows' heads (and, with `records`, their pairing constants and window
// keys) into T.  Lanes in [a, T.stage_end) lie in staged rows; every
// thread returns after a barrier.  `sched_rows`: how many rows' schedules
// SCHED_WORDS holds.
template <typename Lane>
__device__ __forceinline__ void stage_tile(TileRows<Lane> &T, Lane a, Lane b,
                                           const ExpandParams &P,
                                           const int32_t *sids,
                                           const int64_t *offsets,
                                           const int64_t *ends,
                                           const uint32_t *rowtab,
                                           bool records, uint32_t sched_rows) {
  const uint32_t R = (uint32_t)P.rounds;
  const uint64_t stride = ROW_HEAD + 2 * (uint64_t)R;
  if (threadIdx.x < WARP) {
    const Lane r = ends == nullptr
                       ? div_m(a, P)
                       : warp_row_of<Lane>(a, ends, 0, (Lane)(P.rows - 1));
    if (threadIdx.x == 0) T.first = r;
  }
  __syncthreads();
  const Lane r0 = T.first;
  const uint32_t j = threadIdx.x;
  bool in_tile = false;
  uint32_t nwin = 0;
  if (j < STAGE_ROWS && (uint64_t)r0 + j < P.rows) {
    const Lane i = r0 + j;
    const Lane start = row_start<Lane>(i, P, ends);
    in_tile = start < b;
    if (in_tile) {
      const Lane end =
          ends == nullptr ? start + (Lane)P.m_uniform : (Lane)ld64(ends + i);
      const uint32_t m = (uint32_t)(end - start);
      T.end[j] = end;
      T.m[j] = m;
      T.off[j] = ld64(offsets + __ldg(sids + i));
      const uint32_t W = P.full ? m : (P.w < m ? P.w : m);
      uint32_t body = m;
      if (records && W > 1) {
        const uint32_t *row = rowtab + (uint64_t)i * stride;
        const uint32_t ek = __ldg(row);
        body = __ldg(row + 3);
        T.ek[j] = ek;
        T.kin2[j] = decision_key2(inner_key(ek, 0u));
        T.kt2[j] = decision_key2(__ldg(row + 2));
        if (!P.full && P.w < m) {  // windows of w: those the tile cuts
          const Lane lo = a > start ? a : start;
          const Lane hi = b < end ? b : end;
          const uint32_t ulo = (uint32_t)(lo - start);
          const uint32_t uhi = (uint32_t)(hi - start);
          if (ulo < body) {
            T.wlo[j] = magic_div(ulo, P.w32);
            nwin = magic_div((uhi < body ? uhi : body) - 1, P.w32) -
                   T.wlo[j] + 1;
          }
        }
      }
      T.body[j] = body;
    }
  }
  if (j < STAGE_ROWS) T.kb[j] = nwin;
  // in-tile rows are a prefix of the candidates: starts only grow
  const uint32_t nr = (uint32_t)__syncthreads_count(in_tile);
  if (threadIdx.x < WARP) {  // exclusive prefix of the window counts
    const uint32_t l = threadIdx.x;
    const uint32_t x0 = T.kb[2 * l], x1 = T.kb[2 * l + 1];
    uint32_t inc = x0 + x1;
    for (uint32_t d = 1; d < WARP; d *= 2) {
      const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, inc, d);
      if (l >= d) inc += v;
    }
    T.kb[2 * l] = inc - x0 - x1;
    T.kb[2 * l + 1] = inc - x1;
    if (l == WARP - 1) T.kb[STAGE_ROWS] = inc;
  }
  const uint32_t staged = nr < sched_rows ? nr : sched_rows;
  __syncthreads();
  if (records) {
    for (uint32_t q = threadIdx.x; q < staged * 2 * R; q += blockDim.x) {
      const uint32_t jj = q / (2 * R);
      T.sched[q] = __ldg(rowtab + (uint64_t)(r0 + jj) * stride + ROW_HEAD +
                         (q - jj * 2 * R));
    }
    if (!P.full && threadIdx.x < staged) T.wkb[j] = T.kb[j] - T.wlo[j];
    if (!P.full)
      for (uint32_t q = threadIdx.x; q < T.kb[staged]; q += blockDim.x) {
        uint32_t lo = 0, hi = staged - 1;  // the last row with kb <= q
        while (lo < hi) {
          const uint32_t mid = (lo + hi + 1) / 2;
          if (T.kb[mid] <= q)
            lo = mid;
          else
            hi = mid - 1;
        }
        T.wkey[q] =
            decision_key2(inner_key(T.ek[lo], T.wlo[lo] + q - T.kb[lo]));
      }
  }
  if (threadIdx.x == 0) {
    T.staged = staged;
    T.stage_end = staged == 0 ? a : (T.end[staged - 1] < b ? T.end[staged - 1]
                                                            : b);
  }
  __syncthreads();
}

// Row j of the staged ones that holds lane t (T.first <= row < stage_end).
template <typename Lane>
__device__ __forceinline__ uint32_t staged_row(const TileRows<Lane> &T,
                                               Lane t, const ExpandParams &P,
                                               const int64_t *ends) {
  if (ends == nullptr) return (uint32_t)(div_m(t, P) - T.first);
  uint32_t lo = 0, hi = T.staged - 1;  // the first staged row ending past t
  while (lo < hi) {
    const uint32_t mid = (lo + hi) / 2;
    if (T.end[mid] > t)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// Tile of a launch over `lanes` lanes: the lanes over the resident blocks'
// whole rounds of tiles, rounded up to a warp, at most EXP_TILE_MAX, so
// that every block walks the same number of tiles.
inline uint32_t expand_tile(uint64_t lanes) {
  const uint64_t cap = resident_blocks();
  const uint64_t per_round = cap * EXP_TILE_MAX;
  const uint64_t tiles_per_block = (lanes + per_round - 1) / per_round;
  uint64_t tile = (lanes + cap * tiles_per_block - 1) / (cap * tiles_per_block);
  tile = (tile + WARP - 1) / WARP * WARP;
  return (uint32_t)(tile < EXP_TILE_MAX ? tile : EXP_TILE_MAX);
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
  __shared__ TileRows<Lane> T;
  const uint32_t R = (uint32_t)P.rounds;
  const uint64_t stride = ROW_HEAD + 2 * (uint64_t)R;
  const uint32_t sched_rows = R == 0 ? STAGE_ROWS : SCHED_WORDS / (2 * R);
  const Lane lanes = (Lane)P.lanes;
  // block-uniform loop: every thread reaches the barriers equally often
  for (Lane a = (Lane)blockIdx.x * P.tile; a < lanes;
       a += (Lane)gridDim.x * P.tile) {
    const Lane b = lanes - a < (Lane)P.tile ? lanes : a + (Lane)P.tile;
    stage_tile<Lane>(T, a, b, P, sids, offsets, ends, rowtab, true,
                     sched_rows);
    const Lane stage_end = T.stage_end;
    for (Lane t = a + threadIdx.x; t < b; t += blockDim.x) {
      uint32_t idx;
      int64_t off;
      if (t < stage_end) {  // the row from shared memory
        const uint32_t j = staged_row<Lane>(T, t, P, ends);
        const uint32_t m = T.m[j];
        const uint32_t u = (uint32_t)(t - (T.end[j] - (Lane)m));
        const uint32_t W = P.full ? m : (P.w < m ? P.w : m);
        const uint32_t body = T.body[j];
        // one round loop for body and tail lanes, so that a warp across a
        // row's tail runs it once: its domain, key2, constants and base
        const uint32_t *ks = T.sched + j * 2 * R;
        uint32_t x = u, dom = 1, key2 = 0, base = 0;
        if (W > 1 && u >= body) {
          x = u - body;
          dom = m - body;
          key2 = T.kt2[j];
          ks += R;
          base = body;
        } else if (W > 1 && W == m) {  // one window: full, or m <= w
          dom = W;
          key2 = T.kin2[j];
        } else if (W > 1) {
          const uint32_t win = magic_div(u, P.w32);
          base = win * W;
          x = u - base;
          dom = W;
          key2 = T.wkey[T.wkb[j] + win];
        }
        idx = base + swap_or_not_k2(x, dom, ks, key2, R);
        off = T.off[j];
      } else {  // a row past the staged budget: its record, as read
        const Lane i = row_of<Lane>(t, P, ends, T.first + T.staged,
                                    (Lane)(P.rows - 1));
        const Lane start = row_start<Lane>(i, P, ends);
        const uint32_t m = ends == nullptr
                               ? P.m_uniform
                               : (uint32_t)((Lane)ld64(ends + i) - start);
        const uint32_t u = (uint32_t)(t - start);
        const uint32_t W = P.full ? m : (P.w < m ? P.w : m);
        idx = u;
        if (W > 1) {
          const uint32_t *row = rowtab + (uint64_t)i * stride;
          const uint32_t body = __ldg(row + 3);
          if (u < body) {
            const uint32_t win = W == m ? 0u : magic_div(u, P.w32);
            idx = win * W + swap_or_not(u - win * W, W, row + ROW_HEAD,
                                        inner_key(__ldg(row), win), R);
          } else {
            idx = body + swap_or_not(u - body, m - body, row + ROW_HEAD + R,
                                     __ldg(row + 2), R);
          }
        }
        off = ld64(offsets + __ldg(sids + i));
      }
      out[t] = (Out)(off + (int64_t)idx);
    }
    __syncthreads();  // every lane has read T before the next tile's
  }
}

// Store of VEC consecutive outputs, 16 bytes.
__device__ __forceinline__ void store16(int32_t *p, int64_t v) {
  *reinterpret_cast<int4 *>(p) =
      make_int4((int32_t)v, (int32_t)(v + 1), (int32_t)(v + 2),
                (int32_t)(v + 3));
}
__device__ __forceinline__ void store16(int64_t *p, int64_t v) {
  *reinterpret_cast<longlong2 *>(p) = make_longlong2(v, v + 1);
}

// Sequential mode (no window, W <= 1 in every row): out[t] = offset of t's
// shard + t's offset in it.  A copy: no record is read, and each thread
// writes VEC = 16 / sizeof(Out) consecutive lanes with one 16-byte store
// where they lie in one row (tiles start at multiples of WARP, so every
// group of VEC is aligned), else lane by lane.
template <typename Lane, typename Out>
__global__ void __launch_bounds__(THREADS)
    shard_copy_kernel(Out *__restrict__ out, const int32_t *__restrict__ sids,
                      const int64_t *__restrict__ offsets,
                      const int64_t *__restrict__ ends, ExpandParams P) {
  constexpr uint32_t VEC = 16 / sizeof(Out);
  __shared__ TileRows<Lane> T;
  const Lane lanes = (Lane)P.lanes;
  for (Lane a = (Lane)blockIdx.x * P.tile; a < lanes;
       a += (Lane)gridDim.x * P.tile) {
    const Lane b = lanes - a < (Lane)P.tile ? lanes : a + (Lane)P.tile;
    stage_tile<Lane>(T, a, b, P, sids, offsets, ends, nullptr, false,
                     STAGE_ROWS);
    const Lane stage_end = T.stage_end;
    for (Lane g = a + VEC * threadIdx.x; g < b; g += VEC * blockDim.x) {
      if (g + VEC <= stage_end) {
        const uint32_t j = staged_row<Lane>(T, g, P, ends);
        if (g + VEC <= T.end[j]) {  // one row: one store
          store16(out + g, T.off[j] + (int64_t)(g - (T.end[j] - T.m[j])));
          continue;
        }
      }
      for (Lane t = g; t < g + VEC && t < b; ++t) {
        Lane start;
        int64_t off;
        if (t < stage_end) {
          const uint32_t j = staged_row<Lane>(T, t, P, ends);
          start = T.end[j] - (Lane)T.m[j];
          off = T.off[j];
        } else {
          const Lane i = row_of<Lane>(t, P, ends, T.first + T.staged,
                                      (Lane)(P.rows - 1));
          start = row_start<Lane>(i, P, ends);
          off = ld64(offsets + __ldg(sids + i));
        }
        out[t] = (Out)(off + (int64_t)(t - start));
      }
    }
    __syncthreads();
  }
}

template <typename Lane, typename Out>
void launch_expand(void *out, const void *sids, const void *offsets,
                   const void *ends, const void *rowtab,
                   const ExpandParams &P, cudaStream_t stream) {
  const unsigned grid = grid_cap((P.lanes + P.tile - 1) / P.tile);
  if (rowtab == nullptr)
    shard_copy_kernel<Lane, Out><<<grid, THREADS, 0, stream>>>(
        (Out *)out, (const int32_t *)sids, (const int64_t *)offsets,
        (const int64_t *)ends, P);
  else
    shard_expand_kernel<Lane, Out><<<grid, THREADS, 0, stream>>>(
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
// null means every row has `m_uniform` lanes.  (m_mult, m_s1, m_s2) divide
// by m_uniform in the lane width (64 bits where lanes > 2^31 - 1, else 32),
// (w_mult, w_s1, w_s2) by w (32 bits): ops/fastdiv.py.  `rowtab` null is
// sequential mode (not full, w <= 1), which reads no record.
extern "C" int psds_shard_expand(void *out, const void *sids,
                                 const void *offsets, const void *ends,
                                 const void *rowtab, uint64_t lanes,
                                 uint64_t rows, uint32_t m_uniform,
                                 uint64_t m_mult, uint32_t m_s1,
                                 uint32_t m_s2, uint32_t w, uint32_t w_mult,
                                 uint32_t w_s1, uint32_t w_s2, int full,
                                 int rounds, int wide_out, void *stream) {
  if (lanes == 0 || rows == 0 || rounds < 0 || rounds > MAX_ROUNDS ||
      (ends == nullptr && (m_uniform == 0 || lanes != rows * m_uniform)) ||
      ((rowtab == nullptr) != (!full && w <= 1)))
    return (int)cudaErrorInvalidValue;
  ExpandParams P;
  P.lanes = lanes;
  P.rows = rows;
  P.m_uniform = m_uniform;
  P.w = w;
  P.tile = expand_tile(lanes);
  P.full = full;
  P.rounds = rounds;
  P.m32 = Magic32{(uint32_t)m_mult, m_s1, m_s2};
  P.m64 = Magic64{m_mult, m_s1, m_s2};
  P.w32 = Magic32{w_mult, w_s1, w_s2};
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
