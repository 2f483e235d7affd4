// QAT quantize-dequantize along K for Hopper (sm_90a) and its clipped
// straight-through backward, plain C ABI.
//
// Forward: replaces the TPU kernel src/repro/kernels/fake_quant.py::_kernel
// (fake_quant): every element of x is divided by its scale, snapped to the
// p-bit SMOL grid of its 16-channel group along K, multiplied back and
// rounded to x's dtype:
//   h = 2^(1-p), u = clip(rint((x/s/h + 2^p - 1) / 2), 0, 2^p - 1),
//   y = (2u - (2^p - 1)) * h * s.
// Backward: replaces the custom VJP src/repro/backend/base.py::
// _fake_quant_bwd (jnp, fused by XLA on the TPU): dx = g * in_range, with
// in_range = 1 where |x / s| <= 2 - 2^(1-p), else 0, in x's dtype. The
// mask is rebuilt from x with the forward's element arithmetic; dx is the
// product g * mask, as the reference computes it, so -0, inf * 0 and NaN
// come out as they do there.
// The scale is per row of the non-K index (a per-token or broadcast
// per-tensor activation scale, [M]) or per group of K ([K/G], the weight
// scale). K is either the fast dimension (x [M, K], the reference's
// layout) or the slow one (w [K, N]: the reference quantizes swapaxes(w),
// these kernels read w in place, so no transposed copy is made; every
// element's arithmetic is the same).
//
// Expert banks: x is [E, R, C], E slices of [R, C] back to back, each
// with its own precisions (pbits [E, K/G]) and scales (per group [E, K/G],
// per row [E * R] for activations, [E * C] for a weight). Rows of the
// [E * R, C] view are walked as one grid, row r belonging to expert r / R,
// so a bank is one launch; a single tensor is the bank of one.
//
// What bounds both on the H100: bytes. The forward reads and writes each
// element once (4 + 4 B in fp32, 2 + 2 B in bf16) with ~12 float
// operations between; the backward reads x and g and writes dx (12 B in
// fp32, 6 B in bf16) with ~5. Each block takes a 1,024-column strip of a
// row (forward: four elements a thread) or 16 bytes of each operand a
// thread (backward: four fp32 or eight bf16 elements), so loads and stores
// are coalesced; p and the scale come from tiny arrays that stay in L1.
//
// Numerics: bit-equal with the reference's _fake_quant_fwd_impl. The
// division by the scale is an IEEE division (__fdiv_rn), the powers of
// two are exact (ldexpf of an integer p), rounding is half to even (rintf),
// every other step is one correctly rounded operation that nvcc may not
// contract (__fmul_rn / __fadd_rn), and bf16 results round to nearest
// even (__float2bfloat16_rn).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;

template <typename T, int N = VEC>
struct alignas(N * sizeof(T)) Pack {
  T v[N];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float fake_quant_elem(float x, float p, float s) {
  const int pi = __float2int_rn(p);
  const float h = ldexpf(1.0f, 1 - pi);       // 2^(1-p): half step
  const float inv_h = ldexpf(1.0f, pi - 1);   // x / h is exact as x * inv_h
  const float top = ldexpf(1.0f, pi) - 1.0f;  // 2^p - 1
  const float xs = __fdiv_rn(x, s);
  float u = rintf(__fmul_rn(__fadd_rn(__fmul_rn(xs, inv_h), top), 0.5f));
  u = fminf(fmaxf(u, 0.0f), top);
  const float q = __fmul_rn(__fsub_rn(__fmul_rn(2.0f, u), top), h);
  return __fmul_rn(q, s);
}

// 1 where |x / s| lies inside the p-bit grid's range 2 - 2^(1-p), else 0.
__device__ __forceinline__ float in_range_elem(float x, float p, float s) {
  const int pi = __float2int_rn(p);
  const float top = __fsub_rn(2.0f, ldexpf(1.0f, 1 - pi));
  return fabsf(__fdiv_rn(x, s)) <= top ? 1.0f : 0.0f;
}

// The operands of one row of the [E * R, C] view: its expert's pbits and
// scales, the row within the expert and the row's scale offset.
struct RowOps {
  const float* pbits;
  const float* scale;
  int k_row;   // the row within its expert (K's index when K_ROWS)
};

template <bool K_ROWS, bool ROW_SCALE>
__device__ __forceinline__ RowOps row_ops(const float* pbits,
                                          const float* scale, int r, int R,
                                          int C, int groups) {
  const int e = r / R;
  RowOps o;
  o.k_row = r - e * R;
  o.pbits = pbits + (size_t)e * groups;
  if (ROW_SCALE)
    o.scale = K_ROWS ? scale + (size_t)e * C : scale + r;
  else
    o.scale = scale + (size_t)e * groups;
  return o;
}

// x [E * R, C] row-major: E slices of R rows. K_ROWS: K is the row index
// within a slice (w [K, N]); else the column index (x [M, K]). ROW_SCALE:
// one scale per non-K index (of the slice); else one per group of K.
template <typename T, bool K_ROWS, bool ROW_SCALE, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
fake_quant_kernel(const T* __restrict__ x, const float* __restrict__ pbits,
                  const float* __restrict__ scale, T* __restrict__ out,
                  int rows, int R, int C, int group) {
  const int c0 = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (c0 >= C) return;
  const int groups = (K_ROWS ? R : C) / group;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const RowOps o = row_ops<K_ROWS, ROW_SCALE>(pbits, scale, r, R, C,
                                                groups);
    const size_t base = (size_t)r * C + c0;
    float xv[VEC];
    if (ALIGNED) {
      const Pack<T> pk = *reinterpret_cast<const Pack<T>*>(x + base);
#pragma unroll
      for (int j = 0; j < VEC; ++j) xv[j] = to_f32(pk.v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        xv[j] = (c0 + j < C) ? to_f32(x[base + j]) : 0.0f;
    }
    Pack<T> res;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = c0 + j;
      const int kidx = K_ROWS ? o.k_row : c;
      const int g = kidx / group;
      const float p = o.pbits[g];
      const float s = ROW_SCALE ? o.scale[K_ROWS ? c : 0] : o.scale[g];
      res.v[j] = (c < C) ? from_f32<T>(fake_quant_elem(xv[j], p, s))
                         : from_f32<T>(0.0f);
    }
    if (ALIGNED) {
      *reinterpret_cast<Pack<T>*>(out + base) = res;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (c0 + j < C) out[base + j] = res.v[j];
    }
  }
}

template <typename T, bool K_ROWS, bool ROW_SCALE>
void launch(const void* x, const float* pb, const float* sc, void* out,
            int E, int R, int C, int group, bool aligned, cudaStream_t s) {
  const int rows = E * R;
  const dim3 grid((C + THREADS * VEC - 1) / (THREADS * VEC),
                  rows < 65535 ? rows : 65535);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (aligned)
    fake_quant_kernel<T, K_ROWS, ROW_SCALE, true>
        <<<grid, THREADS, 0, s>>>(xt, pb, sc, ot, rows, R, C, group);
  else
    fake_quant_kernel<T, K_ROWS, ROW_SCALE, false>
        <<<grid, THREADS, 0, s>>>(xt, pb, sc, ot, rows, R, C, group);
}

template <typename T>
void dispatch(const void* x, const float* pb, const float* sc, void* out,
              int E, int R, int C, int group, int k_rows, int row_scale,
              bool aligned, cudaStream_t s) {
  if (k_rows) {
    if (row_scale)
      launch<T, true, true>(x, pb, sc, out, E, R, C, group, aligned, s);
    else
      launch<T, true, false>(x, pb, sc, out, E, R, C, group, aligned, s);
  } else {
    if (row_scale)
      launch<T, false, true>(x, pb, sc, out, E, R, C, group, aligned, s);
    else
      launch<T, false, false>(x, pb, sc, out, E, R, C, group, aligned, s);
  }
}

// dx = g * in_range(x), all [E * R, C] row-major of one dtype; layouts as
// fake_quant_kernel. Each thread takes 16 bytes of each operand.
template <typename T, bool K_ROWS, bool ROW_SCALE, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
fake_quant_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ pbits,
                      const float* __restrict__ scale, T* __restrict__ dx,
                      int rows, int R, int C, int group) {
  constexpr int V = 16 / sizeof(T);
  const int c0 = (blockIdx.x * THREADS + threadIdx.x) * V;
  if (c0 >= C) return;
  const int groups = (K_ROWS ? R : C) / group;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const RowOps o = row_ops<K_ROWS, ROW_SCALE>(pbits, scale, r, R, C,
                                                groups);
    const size_t base = (size_t)r * C + c0;
    float xv[V], gv[V];
    if (ALIGNED) {
      const Pack<T, V> px = *reinterpret_cast<const Pack<T, V>*>(x + base);
      const Pack<T, V> pg = *reinterpret_cast<const Pack<T, V>*>(g + base);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        xv[j] = to_f32(px.v[j]);
        gv[j] = to_f32(pg.v[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const bool in = c0 + j < C;
        xv[j] = in ? to_f32(x[base + j]) : 0.0f;
        gv[j] = in ? to_f32(g[base + j]) : 0.0f;
      }
    }
    Pack<T, V> res;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = c0 + j;
      const int kidx = K_ROWS ? o.k_row : c;
      const int grp = kidx / group;
      const float p = (c < C) ? o.pbits[grp] : 0.0f;
      const float s = (c < C) ? (ROW_SCALE ? o.scale[K_ROWS ? c : 0]
                                           : o.scale[grp])
                              : 1.0f;
      res.v[j] = from_f32<T>(__fmul_rn(gv[j], in_range_elem(xv[j], p, s)));
    }
    if (ALIGNED) {
      *reinterpret_cast<Pack<T, V>*>(dx + base) = res;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (c0 + j < C) dx[base + j] = res.v[j];
    }
  }
}

template <typename T, bool K_ROWS, bool ROW_SCALE>
void launch_bwd(const void* x, const void* g, const float* pb,
                const float* sc, void* dx, int E, int R, int C, int group,
                bool aligned, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int rows = E * R;
  const dim3 grid((C + THREADS * V - 1) / (THREADS * V),
                  rows < 65535 ? rows : 65535);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  if (aligned)
    fake_quant_bwd_kernel<T, K_ROWS, ROW_SCALE, true>
        <<<grid, THREADS, 0, s>>>(xt, gt, pb, sc, dt, rows, R, C, group);
  else
    fake_quant_bwd_kernel<T, K_ROWS, ROW_SCALE, false>
        <<<grid, THREADS, 0, s>>>(xt, gt, pb, sc, dt, rows, R, C, group);
}

template <typename T>
void dispatch_bwd(const void* x, const void* g, const float* pb,
                  const float* sc, void* dx, int E, int R, int C, int group,
                  int k_rows, int row_scale, bool aligned, cudaStream_t s) {
  if (k_rows) {
    if (row_scale)
      launch_bwd<T, true, true>(x, g, pb, sc, dx, E, R, C, group, aligned,
                                s);
    else
      launch_bwd<T, true, false>(x, g, pb, sc, dx, E, R, C, group, aligned,
                                 s);
  } else {
    if (row_scale)
      launch_bwd<T, false, true>(x, g, pb, sc, dx, E, R, C, group, aligned,
                                 s);
    else
      launch_bwd<T, false, false>(x, g, pb, sc, dx, E, R, C, group,
                                  aligned, s);
  }
}

bool bad_shape(int E, int R, int C, int group, int k_rows, int dtype) {
  const int K = k_rows ? R : C;
  return E <= 0 || R <= 0 || C <= 0 || group <= 0 || K % group ||
         (long long)E * R > 0x7fffffffLL || (dtype != 0 && dtype != 1);
}

}  // namespace

// out[E, R, C] = fake_quant of each of x's E slices [R, C] (x contiguous,
// pbits[E, K/group] fp32 integral precisions, scale fp32: [E, non-K
// extent] if row_scale else [E, K/group]); E = 1 is a single tensor.
// dtype: 0 fp32, 1 bf16 (x and out). k_rows: K = R (else K = C). Returns
// the CUDA error code of the launch (0 on success).
extern "C" int soniq_fake_quant(const void* x, const void* pbits,
                                const void* scale, void* out, int E, int R,
                                int C, int group, int k_rows, int row_scale,
                                int dtype, void* stream) {
  if (bad_shape(E, R, C, group, k_rows, dtype))
    return (int)cudaErrorInvalidValue;
  const size_t esize = dtype == 0 ? 4 : 2;
  const bool aligned = (C % VEC == 0) &&
                       (reinterpret_cast<uintptr_t>(x) % (VEC * esize) == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % (VEC * esize) == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pb = static_cast<const float*>(pbits);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    dispatch<float>(x, pb, sc, out, E, R, C, group, k_rows, row_scale,
                    aligned, s);
  else
    dispatch<__nv_bfloat16>(x, pb, sc, out, E, R, C, group, k_rows,
                            row_scale, aligned, s);
  return (int)cudaGetLastError();
}

// dx[E, R, C] = g * in_range(x) for x, g [E, R, C] contiguous of one
// dtype (0 fp32, 1 bf16), with pbits, scale, group, k_rows and row_scale
// as soniq_fake_quant takes them. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int soniq_fake_quant_bwd(const void* x, const void* g,
                                    const void* pbits, const void* scale,
                                    void* dx, int E, int R, int C,
                                    int group, int k_rows, int row_scale,
                                    int dtype, void* stream) {
  if (bad_shape(E, R, C, group, k_rows, dtype))
    return (int)cudaErrorInvalidValue;
  const int v = dtype == 0 ? 4 : 8;   // elements in 16 bytes
  const bool aligned = (C % v == 0) &&
                       ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dx)) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pb = static_cast<const float*>(pbits);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    dispatch_bwd<float>(x, g, pb, sc, dx, E, R, C, group, k_rows, row_scale,
                        aligned, s);
  else
    dispatch_bwd<__nv_bfloat16>(x, g, pb, sc, dx, E, R, C, group, k_rows,
                                row_scale, aligned, s);
  return (int)cudaGetLastError();
}
