// Hand-written CUDA kernels around the held experts' grouped GEMMs of a
// DeepSeek-V2 MoE layer (models/deepseek_v2.py MoE._routed) on Hopper.  The
// JAX package has no MoE layer and so no Pallas kernel here: they replace
// the PyTorch ops of the routed path, which ran over every row of the
// buffer (the gather's index_select and torch.where, F.silu(g) * u, the
// combine's torch.where, .float(), multiply, torch.zeros and index_add_,
// and their backwards: a bf16 index_add of atomics among them).
//
// The buffer (models/deepseek_v2.py route_plan).  A layer's (token, slot)
// pairs are sorted by held expert: expert g's pairs take rows [start_g,
// start_g + counts[g]) of a buffer of N*k + held*(ALIGN - 1) rows, with
// start_g = ends[g - 1] (0 for g = 0), and rows [start_g + counts[g],
// ends[g]) pad the group to a multiple of ALIGN.  row[t*k + s] is the buffer
// row of token t's slot s, or -1 where the slot names an expert held on
// another GPU.  ends (int32 [held]) and counts (int64 [held]) lie on the
// card and no host reads them, so every kernel is launched for the worst
// case and bounds its work by what it reads there:
//
// - Token kernels (gather, gather_backward, combine, combine_backward), a
//   warp a token: they touch the rows that `row` names, the filled ones.
// - Row kernels (swiglu, swiglu_backward), a warp a row: they walk the rows
//   below ends[held - 1] and no others.
// - The padding rows of `rows` (gather), `h` (swiglu), `dgu` (swiglu
//   backward) and `dy` (combine backward) get exact zeros, so they pass
//   through the grouped GEMMs and their backward and add 0 to every weight
//   gradient.  Rows at or past ends[held - 1] are never read or written.
//
//   gather            rows[row[t,s]] = x[t]                  (a copy)
//   gather_backward   dx[t] = sum_s drows[row[t,s]]          (float32, slot
//                                                             order, one
//                                                             rounding)
//   swiglu            h[r] = silu(g[r]) * u[r], gu = [g | u] (silu rounded to
//                                                             the dtype first,
//                                                             as F.silu(g) * u)
//   swiglu_backward   dgu[r] = [dh u silu'(g) | dh silu(g)]  (the roundings
//                                                             of autograd's)
//   combine           out[t] = sum_s w[t,s] y[row[t,s]]      (float32 [N, D],
//                                                             every token, 0
//                                                             where none held)
//   combine_backward  dy[row[t,s]] = dtype(w[t,s] dout[t])
//                     dw[t,s] = <dout[t], y[row[t,s]]>       (float32, 0 where
//                                                             held elsewhere)
//
// What bounds them: bytes.  Each reads the filled rows of its inputs once
// and writes its outputs once (a token's input row again per held slot,
// from the cache), 16 bytes a lane a load: every row is a multiple of 16
// bytes (the wrapper checks).  A token's slots are summed by the token's own
// warp, in slot order: no atomics, and every run gives the same bits.  The
// products that PyTorch rounds before a sum are rounded here too
// (__fmul_rn), so the combine and both parts of its backward but dw equal the
// PyTorch ops bit for bit.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr unsigned WARP = 32;

// 16 bytes of a row: 8 bf16 or 4 float32.
template <typename T> struct alignas(16) Pack {
  static constexpr int V = 16 / sizeof(T);
  T e[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ Pack<T> zero_pack() {
  Pack<T> p;
  for (int e = 0; e < Pack<T>::V; ++e) p.e[e] = from_f<T>(0.0f);
  return p;
}

// PyTorch's silu and its sigmoid, in float32: x / (1 + exp(-x)).
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

// A warp takes one item at a time; `lanes` is 32, or the block's width
// where a block is narrower than a warp.
struct Warps {
  uint64_t id, count;
  unsigned lane, lanes;
};

__device__ __forceinline__ Warps warps() {
  Warps w;
  w.lanes = blockDim.x < WARP ? blockDim.x : WARP;
  w.lane = threadIdx.x % w.lanes;
  w.id = ((uint64_t)blockIdx.x * blockDim.x + threadIdx.x) / w.lanes;
  w.count = (uint64_t)gridDim.x * blockDim.x / w.lanes;
  return w;
}

__device__ __forceinline__ float warp_sum(float v, unsigned lanes) {
  for (unsigned o = lanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ uint64_t group_start(int g, const int32_t *ends) {
  return g ? (uint64_t)__ldg(ends + g - 1) : 0;
}

// Whether row r < ends[held - 1] holds a pair: its group is the least g
// with r < ends[g].
__device__ __forceinline__ bool filled(uint64_t r, const int32_t *ends,
                                       const int64_t *counts, int held) {
  int lo = 0, hi = held - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (r < (uint64_t)__ldg(ends + mid))
      hi = mid;
    else
      lo = mid + 1;
  }
  return r - group_start(lo, ends) < (uint64_t)__ldg(counts + lo);
}

// Zeros into group g's padding rows, `packs` packs a row.
template <typename T>
__device__ void zero_padding(Pack<T> *buf, uint64_t packs, int g,
                             const int32_t *ends, const int64_t *counts,
                             const Warps &w) {
  const uint64_t end = (uint64_t)__ldg(ends + g);
  for (uint64_t r = group_start(g, ends) + __ldg(counts + g); r < end; ++r)
    for (uint64_t v = w.lane; v < packs; v += w.lanes)
      buf[r * packs + v] = zero_pack<T>();
}

// Items tokens .. tokens + held - 1 of a token kernel zero the groups'
// padding rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    gather_kernel(Pack<T> *rows, const Pack<T> *x, const int32_t *row,
                  const int32_t *ends, const int64_t *counts,
                  uint64_t tokens, int k, int held, uint64_t packs) {
  const Warps w = warps();
  for (uint64_t t = w.id; t < tokens + held; t += w.count) {
    if (t >= tokens) {
      zero_padding(rows, packs, (int)(t - tokens), ends, counts, w);
      continue;
    }
    for (int s = 0; s < k; ++s) {
      const int32_t r = __ldg(row + t * k + s);
      if (r < 0) continue;
      for (uint64_t v = w.lane; v < packs; v += w.lanes)
        rows[(uint64_t)r * packs + v] = x[t * packs + v];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gather_backward_kernel(Pack<T> *dx, const Pack<T> *drows,
                           const int32_t *row, uint64_t tokens, int k,
                           uint64_t packs) {
  constexpr int V = Pack<T>::V;
  const Warps w = warps();
  for (uint64_t t = w.id; t < tokens; t += w.count) {
    for (uint64_t v = w.lane; v < packs; v += w.lanes) {
      float acc[V] = {};
      for (int s = 0; s < k; ++s) {
        const int32_t r = __ldg(row + t * k + s);
        if (r < 0) continue;
        const Pack<T> p = drows[(uint64_t)r * packs + v];
        for (int e = 0; e < V; ++e) acc[e] += to_f(p.e[e]);
      }
      Pack<T> o;
      for (int e = 0; e < V; ++e) o.e[e] = from_f<T>(acc[e]);
      dx[t * packs + v] = o;
    }
  }
}

// packs: of one half (f), so a row of gu is 2 * packs.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    swiglu_kernel(Pack<T> *h, const Pack<T> *gu, const int32_t *ends,
                  const int64_t *counts, int held, uint64_t packs) {
  constexpr int V = Pack<T>::V;
  const Warps w = warps();
  const uint64_t limit = (uint64_t)__ldg(ends + held - 1);
  for (uint64_t r = w.id; r < limit; r += w.count) {
    const bool fill = filled(r, ends, counts, held);
    const Pack<T> *g = gu + r * 2 * packs, *u = g + packs;
    for (uint64_t v = w.lane; v < packs; v += w.lanes) {
      Pack<T> o = zero_pack<T>();
      if (fill) {
        const Pack<T> pg = g[v], pu = u[v];
        for (int e = 0; e < V; ++e)
          o.e[e] = from_f<T>(
              __fmul_rn(to_f(from_f<T>(silu(to_f(pg.e[e])))), to_f(pu.e[e])));
      }
      h[r * packs + v] = o;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    swiglu_backward_kernel(Pack<T> *dgu, const Pack<T> *gu, const Pack<T> *dh,
                           const int32_t *ends, const int64_t *counts,
                           int held, uint64_t packs) {
  constexpr int V = Pack<T>::V;
  const Warps w = warps();
  const uint64_t limit = (uint64_t)__ldg(ends + held - 1);
  for (uint64_t r = w.id; r < limit; r += w.count) {
    const bool fill = filled(r, ends, counts, held);
    const Pack<T> *g = gu + r * 2 * packs, *u = g + packs;
    Pack<T> *dg = dgu + r * 2 * packs, *du = dg + packs;
    for (uint64_t v = w.lane; v < packs; v += w.lanes) {
      Pack<T> og = zero_pack<T>(), ou = zero_pack<T>();
      if (fill) {
        const Pack<T> pg = g[v], pu = u[v], pd = dh[r * packs + v];
        for (int e = 0; e < V; ++e) {
          const float x = to_f(pg.e[e]), d = to_f(pd.e[e]);
          const float s = sigmoid(x);
          // mul's backward: d silu = dh * u, du = dh * silu(g), each rounded
          const float dsilu = to_f(from_f<T>(__fmul_rn(d, to_f(pu.e[e]))));
          ou.e[e] = from_f<T>(__fmul_rn(d, to_f(from_f<T>(silu(x)))));
          og.e[e] = from_f<T>(dsilu * s * (1.0f + x * (1.0f - s)));
        }
      }
      dg[v] = og;
      du[v] = ou;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    combine_kernel(Pack<float> *out, const Pack<T> *y, const float *wts,
                   const int32_t *row, uint64_t tokens, int k,
                   uint64_t packs) {
  constexpr int V = Pack<T>::V, F = V / 4;  // F float32 packs a pack of y
  const Warps w = warps();
  for (uint64_t t = w.id; t < tokens; t += w.count) {
    for (uint64_t v = w.lane; v < packs; v += w.lanes) {
      float acc[V] = {};
      for (int s = 0; s < k; ++s) {
        const int32_t r = __ldg(row + t * k + s);
        if (r < 0) continue;
        const float wv = __ldg(wts + t * k + s);
        const Pack<T> p = y[(uint64_t)r * packs + v];
        for (int e = 0; e < V; ++e) acc[e] += __fmul_rn(to_f(p.e[e]), wv);
      }
      for (int f = 0; f < F; ++f) {
        Pack<float> o;
        for (int e = 0; e < 4; ++e) o.e[e] = acc[f * 4 + e];
        out[(t * packs + v) * F + f] = o;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    combine_backward_kernel(Pack<T> *dy, float *dw, const Pack<T> *y,
                            const float *wts, const int32_t *row,
                            const Pack<float> *dout, const int32_t *ends,
                            const int64_t *counts, uint64_t tokens, int k,
                            int held, uint64_t packs) {
  constexpr int V = Pack<T>::V, F = V / 4;
  const Warps w = warps();
  for (uint64_t t = w.id; t < tokens + held; t += w.count) {
    if (t >= tokens) {
      zero_padding(dy, packs, (int)(t - tokens), ends, counts, w);
      continue;
    }
    for (int s = 0; s < k; ++s) {
      const int32_t r = __ldg(row + t * k + s);
      float dot = 0.0f;
      if (r >= 0) {
        const float wv = __ldg(wts + t * k + s);
        for (uint64_t v = w.lane; v < packs; v += w.lanes) {
          const Pack<T> p = y[(uint64_t)r * packs + v];
          Pack<T> o;
          for (int f = 0; f < F; ++f) {
            const Pack<float> d = dout[(t * packs + v) * F + f];
            for (int e = 0; e < 4; ++e) {
              o.e[f * 4 + e] = from_f<T>(__fmul_rn(d.e[e], wv));
              dot += d.e[e] * to_f(p.e[f * 4 + e]);
            }
          }
          dy[(uint64_t)r * packs + v] = o;
        }
        dot = warp_sum(dot, w.lanes);
      }
      if (w.lane == 0) dw[t * k + s] = dot;
    }
  }
}

// Blocks for a loop over `items` warp items: at most the resident blocks.
unsigned grid_for(uint64_t items) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const uint64_t per_block = THREADS / WARP;
  const uint64_t blocks = (items + per_block - 1) / per_block;
  const uint64_t cap = (uint64_t)sms * BLOCKS_PER_SM;
  return (unsigned)(blocks < cap ? blocks : cap);
}

// `width` elements a row must fill whole packs.
bool whole_packs(uint64_t width, int bf16) {
  return width % (bf16 ? Pack<__nv_bfloat16>::V : Pack<float>::V) == 0;
}

}  // namespace

// Every entry point takes bf16 (1) or float32 (0) activations, widths in
// elements, and launches on `stream`; it returns the launch's CUDA error
// (cudaErrorInvalidValue for arguments it does not take).  `held` >= 1.

extern "C" int psds_moe_gather(void *rows, const void *x, const void *row,
                               const void *ends, const void *counts,
                               uint64_t tokens, int k, int held, uint64_t d,
                               int bf16, void *stream) {
  if (k < 1 || held < 1 || !whole_packs(d, bf16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = grid_for(tokens + held);
  if (bf16)
    gather_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (Pack<__nv_bfloat16> *)rows, (const Pack<__nv_bfloat16> *)x,
        (const int32_t *)row, (const int32_t *)ends, (const int64_t *)counts,
        tokens, k, held, d / Pack<__nv_bfloat16>::V);
  else
    gather_kernel<float><<<grid, THREADS, 0, st>>>(
        (Pack<float> *)rows, (const Pack<float> *)x, (const int32_t *)row,
        (const int32_t *)ends, (const int64_t *)counts, tokens, k, held,
        d / Pack<float>::V);
  return (int)cudaGetLastError();
}

extern "C" int psds_moe_gather_backward(void *dx, const void *drows,
                                        const void *row, uint64_t tokens,
                                        int k, uint64_t d, int bf16,
                                        void *stream) {
  if (k < 1 || tokens == 0 || !whole_packs(d, bf16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = grid_for(tokens);
  if (bf16)
    gather_backward_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (Pack<__nv_bfloat16> *)dx, (const Pack<__nv_bfloat16> *)drows,
        (const int32_t *)row, tokens, k, d / Pack<__nv_bfloat16>::V);
  else
    gather_backward_kernel<float><<<grid, THREADS, 0, st>>>(
        (Pack<float> *)dx, (const Pack<float> *)drows, (const int32_t *)row,
        tokens, k, d / Pack<float>::V);
  return (int)cudaGetLastError();
}

// rows: the buffer's rows (the most any launch walks); f: the width of h,
// half of gu's.
extern "C" int psds_moe_swiglu(void *h, const void *gu, const void *ends,
                               const void *counts, uint64_t rows, int held,
                               uint64_t f, int bf16, void *stream) {
  if (held < 1 || rows == 0 || !whole_packs(f, bf16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = grid_for(rows);
  if (bf16)
    swiglu_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (Pack<__nv_bfloat16> *)h, (const Pack<__nv_bfloat16> *)gu,
        (const int32_t *)ends, (const int64_t *)counts, held,
        f / Pack<__nv_bfloat16>::V);
  else
    swiglu_kernel<float><<<grid, THREADS, 0, st>>>(
        (Pack<float> *)h, (const Pack<float> *)gu, (const int32_t *)ends,
        (const int64_t *)counts, held, f / Pack<float>::V);
  return (int)cudaGetLastError();
}

extern "C" int psds_moe_swiglu_backward(void *dgu, const void *gu,
                                        const void *dh, const void *ends,
                                        const void *counts, uint64_t rows,
                                        int held, uint64_t f, int bf16,
                                        void *stream) {
  if (held < 1 || rows == 0 || !whole_packs(f, bf16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = grid_for(rows);
  if (bf16)
    swiglu_backward_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (Pack<__nv_bfloat16> *)dgu, (const Pack<__nv_bfloat16> *)gu,
        (const Pack<__nv_bfloat16> *)dh, (const int32_t *)ends,
        (const int64_t *)counts, held, f / Pack<__nv_bfloat16>::V);
  else
    swiglu_backward_kernel<float><<<grid, THREADS, 0, st>>>(
        (Pack<float> *)dgu, (const Pack<float> *)gu, (const Pack<float> *)dh,
        (const int32_t *)ends, (const int64_t *)counts, held,
        f / Pack<float>::V);
  return (int)cudaGetLastError();
}

extern "C" int psds_moe_combine(void *out, const void *y, const void *w,
                                const void *row, uint64_t tokens, int k,
                                uint64_t d, int bf16, void *stream) {
  if (k < 1 || tokens == 0 || !whole_packs(d, bf16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = grid_for(tokens);
  if (bf16)
    combine_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (Pack<float> *)out, (const Pack<__nv_bfloat16> *)y, (const float *)w,
        (const int32_t *)row, tokens, k, d / Pack<__nv_bfloat16>::V);
  else
    combine_kernel<float><<<grid, THREADS, 0, st>>>(
        (Pack<float> *)out, (const Pack<float> *)y, (const float *)w,
        (const int32_t *)row, tokens, k, d / Pack<float>::V);
  return (int)cudaGetLastError();
}

extern "C" int psds_moe_combine_backward(void *dy, void *dw, const void *y,
                                         const void *w, const void *row,
                                         const void *dout, const void *ends,
                                         const void *counts, uint64_t tokens,
                                         int k, int held, uint64_t d,
                                         int bf16, void *stream) {
  if (k < 1 || held < 1 || tokens == 0 || !whole_packs(d, bf16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = grid_for(tokens + held);
  if (bf16)
    combine_backward_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (Pack<__nv_bfloat16> *)dy, (float *)dw,
        (const Pack<__nv_bfloat16> *)y, (const float *)w,
        (const int32_t *)row, (const Pack<float> *)dout,
        (const int32_t *)ends, (const int64_t *)counts, tokens, k, held,
        d / Pack<__nv_bfloat16>::V);
  else
    combine_backward_kernel<float><<<grid, THREADS, 0, st>>>(
        (Pack<float> *)dy, (float *)dw, (const Pack<float> *)y,
        (const float *)w, (const int32_t *)row, (const Pack<float> *)dout,
        (const int32_t *)ends, (const int64_t *)counts, tokens, k, held,
        d / Pack<float>::V);
  return (int)cudaGetLastError();
}
