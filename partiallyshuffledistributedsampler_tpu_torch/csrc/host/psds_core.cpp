// Native host implementation of the SPEC.md permutation law: the
// partiallyshuffledistributedsampler_tpu_torch package's own copy, served
// as backend='native'.
//
// Must stay bit-identical to the package's plain law (ops/core.py,
// ops/mixture.py, sampler/shard_mode.py): the shared law is frozen in
// SPEC.md, and tests/test_torch_port_native.py holds every entry point
// against the numpy reference and the package's CPU route.
//
// Build: ops/native.py runs `g++ -O3 -fPIC -shared -std=c++17` into the
// package's csrc/build/ at first use, named by a hash of this file and the
// flags; loaded there via ctypes over the C ABI below.  A failed build
// raises: backend='native' never serves another route.

#include <cstdint>
#include <vector>

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

inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// SPEC.md §2: swap-or-not with scalar pairing key.  Round keys K_r depend
// only on (pair_key, r, m) — the caller precomputes them once per domain.
struct SonSchedule {
  uint32_t k[64];      // K_r per round (rounds <= 64 enforced by wrapper)
  uint32_t rc_bit[64]; // r * RC_BIT
  uint32_t rounds;
  uint32_t m;
};

inline void make_schedule(SonSchedule &s, uint32_t m, uint32_t pair_key,
                          uint32_t rounds) {
  s.m = m;
  s.rounds = rounds;
  for (uint32_t r = 0; r < rounds; ++r) {
    s.k[r] = mix32(pair_key ^ (uint32_t)(r * GOLDEN)) % m;
    s.rc_bit[r] = (uint32_t)(r * RC_BIT);
  }
}

inline uint32_t son_apply(const SonSchedule &s, uint32_t x, uint32_t key2) {
  const uint32_t m = s.m;
  for (uint32_t r = 0; r < s.rounds; ++r) {
    uint32_t partner = s.k[r] + (m - x);
    if (partner >= m) partner -= m;
    uint32_t c = x > partner ? x : partner;
    uint32_t b = mix32(c ^ key2 ^ s.rc_bit[r]);
    if (b & 1u) x = partner;
  }
  return x;
}

// one-shot variant for the outer/tail bijections (scalar key == pair key)
inline uint32_t son(uint32_t x, uint32_t m, uint32_t key, uint32_t rounds) {
  if (m <= 1) return x;
  SonSchedule s;
  make_schedule(s, m, key, rounds);
  return son_apply(s, x, mix32(key ^ C_BIT));
}

// Round-major batch: apply the schedule to cnt elements sharing key2
// (one window's run of consecutive positions).  The element loop is
// branchless select arithmetic with no cross-element dependence, so the
// compiler vectorizes it — measured ~4x the element-major son_apply at
// production window sizes.  Bit-identical per element by construction
// (same ops, different order of the independent element axis).
inline void son_apply_batch(const SonSchedule &s, uint32_t *x, uint32_t cnt,
                            uint32_t key2) {
  for (uint32_t r = 0; r < s.rounds; ++r) {
    const uint32_t kr = s.k[r], rc = s.rc_bit[r] ^ key2, m = s.m;
    for (uint32_t i = 0; i < cnt; ++i) {
      const uint32_t xi = x[i];
      uint32_t partner = kr + (m - xi);
      partner = partner >= m ? partner - m : partner;
      const uint32_t c = xi > partner ? xi : partner;
      const uint32_t b = mix32(c ^ rc);
      x[i] = (b & 1u) ? partner : xi;
    }
  }
}

//: run-buffer length for the batched body loops (32 KB of uint32)
constexpr uint32_t SON_BATCH = 8192;

inline uint32_t derive_epoch_key(uint32_t seed_lo, uint32_t seed_hi,
                                 uint32_t epoch) {
  uint32_t k = mix32(seed_lo ^ GOLDEN);
  k = mix32(k ^ mix32(seed_hi ^ C_SEED_HI));
  k = mix32(k ^ mix32(epoch ^ C_EPOCH));
  return k;
}

template <typename OutT>
int epoch_indices_impl(uint64_t n, uint32_t window, uint32_t seed_lo,
                       uint32_t seed_hi, uint32_t epoch, uint64_t rank,
                       uint64_t world, int shuffle, int order_windows,
                       int strided, uint32_t rounds, uint64_t num_samples,
                       OutT *out) {
  if (n == 0 || world == 0 || rank >= world || window == 0) return -1;
  if (rounds > 64) return -2;
  if (window > 0x7FFFFFFFu) return -3;
  const uint64_t nw_full = n / window;
  if (nw_full > 0x7FFFFFFFull) return -3;
  const uint64_t body_len = nw_full * window;
  const uint32_t tail_len = (uint32_t)(n - body_len);

  if (!shuffle) {
    for (uint64_t i = 0; i < num_samples; ++i) {
      uint64_t p = strided ? rank + world * i : rank * num_samples + i;
      out[i] = (OutT)(p % n);
    }
    return 0;
  }

  const uint32_t ek = derive_epoch_key(seed_lo, seed_hi, epoch);
  const uint32_t okey = mix32(ek ^ C_OUTER);
  const uint32_t tkey = mix32(ek ^ C_TAIL);
  const uint32_t pair_inner = mix32(ek ^ C_PAIR);
  const bool do_outer = order_windows && nw_full > 1;

  SonSchedule inner_sched;
  if (nw_full > 0) make_schedule(inner_sched, window, pair_inner, rounds);

  // cache the last output slot's resolved window: consecutive positions of a
  // rank usually fall in the same slot (always, for blocked partition) —
  // and BATCH each window's run through the round-major vectorized loop
  uint64_t cached_j = ~0ull;
  uint32_t cached_k = 0, cached_key2 = 0;
  uint32_t r0buf[SON_BATCH];

  uint64_t i = 0;
  while (i < num_samples) {
    uint64_t p = (strided ? rank + world * i : rank * num_samples + i) % n;
    if (p >= body_len) {
      const uint32_t t = (uint32_t)(p - body_len);
      out[i] = (OutT)(body_len + son(t, tail_len, tkey, rounds));
      ++i;
      continue;
    }
    const uint64_t j = p / window;
    if (j != cached_j) {
      cached_j = j;
      cached_k = do_outer ? son((uint32_t)j, (uint32_t)nw_full, okey, rounds)
                          : (uint32_t)j;
      const uint32_t kin = mix32(ek ^ C_INNER ^ mix32(cached_k ^ C_WIN));
      cached_key2 = mix32(kin ^ C_BIT);
    }
    // collect this window's run of consecutive positions
    uint32_t cnt = 0;
    const uint64_t i0 = i;
    while (i < num_samples && cnt < SON_BATCH) {
      const uint64_t p2 =
          (strided ? rank + world * i : rank * num_samples + i) % n;
      if (p2 >= body_len || p2 / window != j) break;
      r0buf[cnt++] = (uint32_t)(p2 % window);
      ++i;
    }
    son_apply_batch(inner_sched, r0buf, cnt, cached_key2);
    const uint64_t kbase = (uint64_t)cached_k * window;
    for (uint32_t t = 0; t < cnt; ++t)
      out[i0 + t] = (OutT)(kbase + r0buf[t]);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// SPEC.md §8: the weighted mixture stream (v1 and v2 pattern laws).
// Mirrors ops/mixture.py bit-for-bit; cross-checked by
// tests/test_torch_port_native.py.
// ---------------------------------------------------------------------------

constexpr uint64_t MIX_SEED_STRIDE = 0xB5297A4D2C7E9FD3ull;
constexpr uint32_t C_PASS = 0x632BE5ABu;
constexpr uint32_t C_ROT = 0x6A09E667u;

// Per-source state: §8.3 seeds/keys plus the pairing schedules (all from
// the pass-FREE key ek0, per the spec's split key schedule) and the
// per-(pass, window) decision-key caches — consecutive draws of a source
// walk the same pass and usually the same window, so the amortization
// mirrors epoch_indices_impl's cached_j trick.
struct MixSrc {
  uint64_t n, body, base;
  uint32_t W, nw, tail;
  uint32_t lo, hi;
  bool do_outer;
  SonSchedule outer_pair, inner_pair, tail_pair;
  uint64_t cur_pas;
  uint32_t ek, okey2, tkey2;
  uint64_t cached_win;
  uint32_t cached_k, cached_inner_key2;
};

template <typename OutT>
int mixture_indices_impl(uint32_t S, const uint64_t *sources,
                         const uint32_t *windows, const int32_t *pattern,
                         const int64_t *prefix, const uint64_t *quotas,
                         uint32_t B, int rotated, uint32_t seed_lo,
                         uint32_t seed_hi, uint32_t epoch, uint64_t rank,
                         uint64_t world, int shuffle, int order_windows,
                         int strided, uint32_t rounds, uint64_t num_samples,
                         const int64_t *positions, OutT *out) {
  // positions != null: evaluate the stream AT those positions (random
  // access — the elastic remainder path composes them host-side);
  // positions == null: generate the rank's §8.4 epoch positions
  if (S == 0 || world == 0 || rank >= world || B == 0) return -1;
  if (rounds > 64) return -2;
  std::vector<MixSrc> src(S);
  uint64_t base = 0;
  for (uint32_t s = 0; s < S; ++s) {
    MixSrc &st = src[s];
    st.n = sources[s];
    st.W = windows[s];
    if (st.n == 0 || st.W == 0 || st.W > st.n) return -1;
    if (st.W > 0x7FFFFFFFu) return -3;
    const uint64_t nw64 = st.n / st.W;
    if (nw64 > 0x7FFFFFFFull) return -3;
    st.nw = (uint32_t)nw64;
    st.body = nw64 * st.W;
    st.tail = (uint32_t)(st.n - st.body);
    st.base = base;
    base += st.n;
    const uint64_t d = MIX_SEED_STRIDE + s;  // 64-bit wrap, as in python
    st.lo = seed_lo ^ (uint32_t)d;
    st.hi = seed_hi ^ (uint32_t)(d >> 32);
    const uint32_t ek0 = derive_epoch_key(st.lo, st.hi, epoch);
    st.do_outer = order_windows && st.nw > 1;
    if (st.do_outer)
      make_schedule(st.outer_pair, st.nw, mix32(ek0 ^ C_OUTER), rounds);
    if (st.W > 1)
      make_schedule(st.inner_pair, st.W, mix32(ek0 ^ C_PAIR), rounds);
    if (st.tail > 1)
      make_schedule(st.tail_pair, st.tail, mix32(ek0 ^ C_TAIL), rounds);
    st.cur_pas = ~0ull;
    st.cached_win = ~0ull;
  }
  const uint32_t rk =
      rotated ? mix32(derive_epoch_key(seed_lo, seed_hi, epoch) ^ C_ROT) : 0;

  for (uint64_t i = 0; i < num_samples; ++i) {
    // §8.4 positions are NOT wrapped: the stream is total
    uint64_t p;
    if (positions) {
      if (positions[i] < 0) return -1;
      p = (uint64_t)positions[i];
    } else {
      p = strided ? rank + world * i : rank * num_samples + i;
    }
    const uint32_t t = (uint32_t)(p % B);
    const uint64_t blk = p / B;
    uint32_t slot = t;
    int64_t cnt;
    uint32_t s_id;
    if (rotated) {
      // §8.2a: rotation keys on blk mod 2^32, like the vectorized paths
      const uint32_t r = mix32(rk ^ (uint32_t)blk) % B;
      const uint32_t a = t + r;
      const bool wrap = a >= B;
      slot = wrap ? a - B : a;
      s_id = (uint32_t)pattern[slot];
      cnt = prefix[(uint64_t)slot * S + s_id] -
            prefix[(uint64_t)r * S + s_id] +
            (wrap ? (int64_t)quotas[s_id] : 0);
    } else {
      s_id = (uint32_t)pattern[slot];
      cnt = prefix[(uint64_t)slot * S + s_id];
    }
    MixSrc &st = src[s_id];
    const uint64_t j = blk * quotas[s_id] + (uint64_t)cnt;
    const uint64_t pas = j / st.n;
    const uint64_t u = j % st.n;
    uint64_t idx;
    if (!shuffle) {
      idx = u;
    } else {
      if (pas != st.cur_pas) {
        st.cur_pas = pas;
        // §8.3 pass-folded epoch; pas truncates to uint32 like the
        // vectorized paths' .astype(uint32)
        const uint32_t ep_u = mix32(epoch ^ mix32((uint32_t)pas ^ C_PASS));
        st.ek = derive_epoch_key(st.lo, st.hi, ep_u);
        st.okey2 = mix32(mix32(st.ek ^ C_OUTER) ^ C_BIT);
        st.tkey2 = mix32(mix32(st.ek ^ C_TAIL) ^ C_BIT);
        st.cached_win = ~0ull;
      }
      if (u < st.body) {
        const uint64_t win = u / st.W;
        const uint32_t r0 = (uint32_t)(u % st.W);
        if (win != st.cached_win) {
          st.cached_win = win;
          st.cached_k = st.do_outer ? son_apply(st.outer_pair, (uint32_t)win,
                                                st.okey2)
                                    : (uint32_t)win;
          const uint32_t kin =
              mix32(st.ek ^ C_INNER ^ mix32(st.cached_k ^ C_WIN));
          st.cached_inner_key2 = mix32(kin ^ C_BIT);
        }
        idx = (uint64_t)st.cached_k * st.W +
              (st.W > 1 ? son_apply(st.inner_pair, r0, st.cached_inner_key2)
                        : 0u);
      } else {
        const uint32_t tpos = (uint32_t)(u - st.body);
        idx = st.body +
              (st.tail > 1 ? son_apply(st.tail_pair, tpos, st.tkey2) : tpos);
      }
    }
    out[i] = (OutT)(st.base + idx);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// SPEC.md §7: shard-index mode — expand a shard-id stream into global
// sample indices, each shard §3-permuted under its spec'd per-shard seed.
// Mirrors sampler/shard_mode.expand_shard_indices_np bit-for-bit.
// ---------------------------------------------------------------------------

constexpr uint64_t SHARD_SEED_STRIDE = 0x9E3779B97F4A7C15ull;

template <typename OutT>
int expand_shards_impl(const int64_t *sid_stream, uint64_t n_sids,
                       const int64_t *sizes, const int64_t *offsets,
                       uint64_t num_shards, uint32_t seed_lo,
                       uint32_t seed_hi, uint32_t epoch, int full_shuffle,
                       uint32_t w_int, uint32_t rounds, OutT *out) {
  if (rounds > 64) return -2;
  uint64_t k = 0;
  for (uint64_t si = 0; si < n_sids; ++si) {
    const int64_t sid = sid_stream[si];
    if (sid < 0 || (uint64_t)sid >= num_shards) return -1;
    const int64_t m64 = sizes[sid];
    if (m64 < 0 || m64 > 0x7FFFFFFFll) return -3;
    const uint32_t m = (uint32_t)m64;
    const int64_t off = offsets[sid];
    if (m == 0) continue;
    // §7 resolved window: True -> whole shard; int w capped at m;
    // w <= 1 -> sequential (identity)
    const uint32_t W = full_shuffle ? m : (w_int < m ? w_int : m);
    if (W <= 1) {
      for (uint32_t u = 0; u < m; ++u) out[k++] = (OutT)(off + u);
      continue;
    }
    // the spec'd per-shard seed: fold(seed) XOR split halves of
    // (STRIDE + sid), exactly _shard_epoch_keys' decomposition
    const uint64_t d = SHARD_SEED_STRIDE + (uint64_t)sid;
    const uint32_t lo = seed_lo ^ (uint32_t)d;
    const uint32_t hi = seed_hi ^ (uint32_t)(d >> 32);
    const uint32_t ek = derive_epoch_key(lo, hi, epoch);
    // order_windows is True only for the full shuffle (bounded windows
    // stay put so displacement stays < W) — and full shuffle has nw=1,
    // so the outer bijection never actually runs; §3 body+tail follow
    const uint32_t nw = m / W;
    const uint64_t body = (uint64_t)nw * W;
    const uint32_t tail = (uint32_t)(m - body);
    const uint32_t okey = mix32(ek ^ C_OUTER);
    const uint32_t tkey = mix32(ek ^ C_TAIL);
    const bool do_outer = full_shuffle && nw > 1;  // nw==1 when full
    SonSchedule inner_sched;
    make_schedule(inner_sched, W, mix32(ek ^ C_PAIR), rounds);
    // batched: u walks windows in full runs of consecutive r0, so each
    // window (chunked at SON_BATCH) rides the round-major vectorized loop
    uint32_t r0buf[SON_BATCH];
    for (uint64_t wstart = 0; wstart < body; wstart += W) {
      const uint64_t j = wstart / W;
      const uint32_t kw = do_outer ? son((uint32_t)j, nw, okey, rounds)
                                   : (uint32_t)j;
      const uint32_t kin = mix32(ek ^ C_INNER ^ mix32(kw ^ C_WIN));
      const uint32_t key2 = mix32(kin ^ C_BIT);
      const uint64_t kbase = (uint64_t)kw * W;
      for (uint32_t c0 = 0; c0 < W; c0 += SON_BATCH) {
        const uint32_t cnt = (W - c0) < SON_BATCH ? (W - c0) : SON_BATCH;
        for (uint32_t t = 0; t < cnt; ++t) r0buf[t] = c0 + t;
        son_apply_batch(inner_sched, r0buf, cnt, key2);
        for (uint32_t t = 0; t < cnt; ++t)
          out[k + t] = (OutT)(off + (int64_t)(kbase + r0buf[t]));
        k += cnt;
      }
    }
    for (uint32_t t = 0; t < tail; ++t)
      out[k++] = (OutT)(off + (int64_t)(body + son(t, tail, tkey, rounds)));
  }
  return 0;
}

} // namespace

extern "C" {

// Fills out[0..num_samples) with rank's epoch indices.  out_width selects
// the element type: 4 (int32, requires n <= 2^31-1) or 8 (int64) — writing
// int32 directly avoids a second pass over the buffer on the host hot path.
// Returns 0 on success, negative on argument errors.  All domain checks
// mirror ops/core.py (window < 2^31, n/window < 2^31).
int psds_epoch_indices(uint64_t n, uint32_t window, uint32_t seed_lo,
                       uint32_t seed_hi, uint32_t epoch, uint64_t rank,
                       uint64_t world, int shuffle, int order_windows,
                       int strided, uint32_t rounds, uint64_t num_samples,
                       int out_width, void *out) {
  if (out_width == 4) {
    if (n > 0x7FFFFFFFull) return -4;
    return epoch_indices_impl<int32_t>(n, window, seed_lo, seed_hi, epoch,
                                       rank, world, shuffle, order_windows,
                                       strided, rounds, num_samples,
                                       (int32_t *)out);
  }
  if (out_width == 8)
    return epoch_indices_impl<int64_t>(n, window, seed_lo, seed_hi, epoch,
                                       rank, world, shuffle, order_windows,
                                       strided, rounds, num_samples,
                                       (int64_t *)out);
  return -5;
}

// Fills out[0..num_samples) with rank's §8 mixture-epoch GLOBAL ids.
// pattern is the spec's [B] int32 table, prefix the [B, S] row-major int64
// prefix-count table, quotas/sources/windows the per-source vectors (the
// caller passes the spec's own capped windows).  rotated selects the
// §8.2a v2 per-block rotation (pattern_version >= 2 and shuffle).
// out_width as in psds_epoch_indices (4 requires sum(sources) <= 2^31-1).
int psds_mixture_indices(uint32_t S, const uint64_t *sources,
                         const uint32_t *windows, const int32_t *pattern,
                         const int64_t *prefix, const uint64_t *quotas,
                         uint32_t B, int rotated, uint32_t seed_lo,
                         uint32_t seed_hi, uint32_t epoch, uint64_t rank,
                         uint64_t world, int shuffle, int order_windows,
                         int strided, uint32_t rounds, uint64_t num_samples,
                         int out_width, void *out) {
  if (out_width == 4) {
    uint64_t total = 0;
    for (uint32_t s = 0; s < S; ++s) total += sources[s];
    if (total > 0x7FFFFFFFull) return -4;
    return mixture_indices_impl<int32_t>(
        S, sources, windows, pattern, prefix, quotas, B, rotated, seed_lo,
        seed_hi, epoch, rank, world, shuffle, order_windows, strided, rounds,
        num_samples, nullptr, (int32_t *)out);
  }
  if (out_width == 8)
    return mixture_indices_impl<int64_t>(
        S, sources, windows, pattern, prefix, quotas, B, rotated, seed_lo,
        seed_hi, epoch, rank, world, shuffle, order_windows, strided, rounds,
        num_samples, nullptr, (int64_t *)out);
  return -5;
}

// Random access into the §8 stream: out[i] = mix(positions[i]) — the
// elastic remainder path composes base-epoch positions host-side (tiny,
// O(len) arithmetic) and evaluates them here.  Same tables/flags as
// psds_mixture_indices.
int psds_mixture_stream_at(uint32_t S, const uint64_t *sources,
                           const uint32_t *windows, const int32_t *pattern,
                           const int64_t *prefix, const uint64_t *quotas,
                           uint32_t B, int rotated, uint32_t seed_lo,
                           uint32_t seed_hi, uint32_t epoch,
                           int shuffle, int order_windows, uint32_t rounds,
                           uint64_t n_positions, const int64_t *positions,
                           int out_width, void *out) {
  if (out_width == 4) {
    uint64_t total = 0;
    for (uint32_t s = 0; s < S; ++s) total += sources[s];
    if (total > 0x7FFFFFFFull) return -4;
    return mixture_indices_impl<int32_t>(
        S, sources, windows, pattern, prefix, quotas, B, rotated, seed_lo,
        seed_hi, epoch, 0, 1, shuffle, order_windows, 1, rounds,
        n_positions, positions, (int32_t *)out);
  }
  if (out_width == 8)
    return mixture_indices_impl<int64_t>(
        S, sources, windows, pattern, prefix, quotas, B, rotated, seed_lo,
        seed_hi, epoch, 0, 1, shuffle, order_windows, 1, rounds,
        n_positions, positions, (int64_t *)out);
  return -5;
}

// Expands a shard-id stream (SPEC.md §7) into out[0..sum(sizes[sid]))
// global sample indices, each shard permuted under its per-shard seed.
// full_shuffle selects the whole-shard §3 permutation; otherwise w_int is
// the bounded within-shard window (<= 1 means sequential).  out_width as
// above (4 requires the total sample space <= 2^31-1 — the caller
// guarantees it, matching expand_shard_indices_np's int64/int32 law).
int psds_expand_shards(const int64_t *sid_stream, uint64_t n_sids,
                       const int64_t *sizes, const int64_t *offsets,
                       uint64_t num_shards, uint32_t seed_lo,
                       uint32_t seed_hi, uint32_t epoch, int full_shuffle,
                       uint32_t w_int, uint32_t rounds, int out_width,
                       void *out) {
  if (out_width == 4)
    return expand_shards_impl<int32_t>(sid_stream, n_sids, sizes, offsets,
                                       num_shards, seed_lo, seed_hi, epoch,
                                       full_shuffle, w_int, rounds,
                                       (int32_t *)out);
  if (out_width == 8)
    return expand_shards_impl<int64_t>(sid_stream, n_sids, sizes, offsets,
                                       num_shards, seed_lo, seed_hi, epoch,
                                       full_shuffle, w_int, rounds,
                                       (int64_t *)out);
  return -5;
}

} // extern "C"
