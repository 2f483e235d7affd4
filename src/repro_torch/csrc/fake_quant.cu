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
// per row [E * R] for activations, [E * C] for a weight). The forward puts
// the expert on the grid's z axis, the backward walks rows of the
// [E * R, C] view (row r belonging to expert r / R), so a bank is one
// launch either way; a single tensor is the bank of one.
//
// What bounds the forward on the H100: bytes. It reads and writes each
// element once (4 + 4 B in fp32, 2 + 2 B in bf16), and at 3.35 TB/s it
// must keep ~2-3 MB of loads in flight across the card. An element-wise
// form (the group by an integer division, three ldexpf, p and s loaded
// for each element) runs ~140-180 SASS instructions an element with one
// 4-element load a thread in flight (PERF.md). This one:
//   - Takes everything that is constant over a group or a row once a
//     thread or once a row, never once an element: a thread owns one
//     16-byte column vector (8 bf16 or 4 fp32 elements, inside one
//     16-channel group) across all its rows, so with K fast its group's
//     precision, grid constants (and a per-group scale) are set up once;
//     with K slow they are set up once a row. The group size is a template
//     constant (16), with a generic instance for a layer narrower than a
//     group, so no integer division is left in the inner loop.
//   - Builds the grid's powers of two from exponent bits, not ldexpf, and
//     computes (x / s / h + 2^p - 1) / 2 and (2u - (2^p - 1)) h as one FMA
//     each: the exact values the reference rounds once (below).
//   - Keeps loads in flight through occupancy: registers capped so that
//     MIN_BLOCKS blocks of THREADS stay resident an SM, each thread
//     issuing its chunk's loads (ROWS 16-byte vectors) before it
//     computes, over a grid of a few waves that strides over the chunks.
//     On the card, one row a chunk ran faster than two or four (more
//     registers, fewer threads resident) and than a cp.async ring in
//     shared memory that kept each thread's next chunks in flight.
// The division stays __fdiv_rn: a row's reciprocal with one residual
// correction, bitwise __fdiv_rn over every pair of significands where its
// intermediates are normal (checked on the card), was no faster.
//
// Numerics: bit-equal with the reference's _fake_quant_fwd_impl for
// integral precisions 1 <= p <= 24 (the config's are 1, 2 and 4). x / s
// is an IEEE division (__fdiv_rn); rounding is half to even (rintf).
// xs * 2^(p-1) is exact, and the reference's (xs * 2^(p-1) + 2^p - 1)
// rounded and halved is the rounding of (xs * 2^(p-2) + (2^p - 1) / 2),
// which one FMA gives (the sum is never subnormal: near -(2^p - 1) it is
// exact, a multiple of 2^-23). Where xs * 2^(p-1) overflows, the FMA's
// larger finite value clamps to the same code. (2u - (2^p - 1)) h is a
// grid value, exact however it is formed. The clamp propagates NaN as the
// reference's clip does. bf16 results round to nearest even
// (__float2bfloat16_rn and its packed form). The backward keeps its
// element-wise arithmetic (in_range_elem).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// The forward's launch shape (tools/kernel_ab.py --set NAME=VALUE times
// other values; none changes a bit of the result): rows of its column
// vector a thread loads before it computes, blocks an SM the registers
// must allow, and the grid's cap in waves of 2,048 / THREADS blocks an
// SM (the kernel strides over the rest).
constexpr int ROWS = 1;
constexpr int MIN_BLOCKS = 4;
constexpr int WAVES = 4;

template <typename T, int N>
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

// 2^e for -126 <= e <= 127, from its exponent bits.
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

// The p-bit grid's constants, exact for an integral 1 <= p <= 24.
struct Grid {
  float half_inv_h;   // 2^(p-2)
  float half_top;     // (2^p - 1) / 2
  float top;          // 2^p - 1
  float two_h;        // 2^(2-p) = 2h
  float neg_top_h;    // -(2^p - 1) 2^(1-p)
};

__device__ __forceinline__ Grid make_grid(float p) {
  const int pi = __float2int_rn(p);
  Grid g;
  g.top = __fsub_rn(pow2(pi), 1.0f);
  g.half_top = __fmul_rn(g.top, 0.5f);
  g.half_inv_h = pow2(pi - 2);
  g.two_h = pow2(2 - pi);
  g.neg_top_h = -__fmul_rn(g.top, pow2(1 - pi));
  return g;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// One element: x / s snapped to the grid and scaled back (fp32).
__device__ __forceinline__ float fake_quant_elem(float x, const Grid& g,
                                                 float s) {
  const float xs = __fdiv_rn(x, s);
  float u = rintf(__fmaf_rn(xs, g.half_inv_h, g.half_top));
  u = min_nan(max_nan(u, 0.0f), g.top);
  return __fmul_rn(__fmaf_rn(u, g.two_h, g.neg_top_h), s);
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

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* out, const float (&y)[V]);
template <>
__device__ __forceinline__ void store_vec<float, 4>(float* out,
                                                    const float (&y)[4]) {
  *reinterpret_cast<float4*>(out) = make_float4(y[0], y[1], y[2], y[3]);
}
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 8>(
    __nv_bfloat16* out, const float (&y)[8]) {
  Pack<__nv_bfloat162, 4> pk;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    pk.v[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
  *reinterpret_cast<Pack<__nv_bfloat162, 4>*>(out) = pk;
}

// A thread's constants for its column vector c0 (V lanes): with K fast,
// its lanes' grids (one when GROUP is 16: the vector lies inside one
// group) and, for a scale per group, their scales; with K slow and a
// scale per column, its lanes' scales. row() then quantizes one row's V
// elements, given the row's precision p (K slow) and scale s (K slow with
// a scale per group, or K fast with a scale per row).
template <typename T, bool K_ROWS, bool ROW_SCALE, int GROUP>
struct Lanes {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int L = GROUP ? 1 : V;
  Grid grid[K_ROWS ? 1 : L];
  float s[V];   // the entries the layout reads are set, the rest unused

  __device__ __forceinline__ Lanes(const float* pbits, const float* scale,
                                   int c0, int C, int grp) {
    if constexpr (!K_ROWS) {
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int g = min(c0 + i, C - 1) / grp;
        grid[i] = make_grid(pbits[g]);
        if constexpr (!ROW_SCALE) s[i] = scale[g];
      }
    } else if constexpr (ROW_SCALE) {
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] = scale[min(c0 + i, C - 1)];
    }
  }

  __device__ __forceinline__ void row(const float (&x)[V], float p,
                                      float s_row, float (&y)[V]) const {
    if constexpr (K_ROWS) {
      const Grid g = make_grid(p);
#pragma unroll
      for (int i = 0; i < V; ++i)
        y[i] = fake_quant_elem(x[i], g, ROW_SCALE ? s[i] : s_row);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        y[i] = fake_quant_elem(x[i], grid[GROUP ? 0 : i],
                               ROW_SCALE ? s_row : s[GROUP ? 0 : i]);
    }
  }
};

// Expert blockIdx.z's slice x [R, C] row-major. K_ROWS: K is the row
// index (w [K, N]); else the column index (x [M, K]). ROW_SCALE: one
// scale per non-K index; else one per group of K. GROUP: the group size
// when it is 16, 0 for any other (``group``: a layer narrower than 16
// channels). ALIGNED: C is a multiple of the 16-byte vector and x, out
// are 16-byte aligned (else element loads and stores). Thread (tx, ty)
// owns column vector blockIdx.x * blockDim.x + tx and row chunks of ROWS
// rows, chunk blockIdx.y * blockDim.y + ty and every gridDim.y *
// blockDim.y-th after it; it issues a chunk's loads before it computes.
template <typename T, bool K_ROWS, bool ROW_SCALE, int GROUP, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fake_quant_kernel(const T* __restrict__ x, const float* __restrict__ pbits,
                  const float* __restrict__ scale, T* __restrict__ out,
                  int R, int C, int group) {
  using Thread = Lanes<T, K_ROWS, ROW_SCALE, GROUP>;
  constexpr int V = Thread::V;
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c0 >= C) return;
  const int grp = GROUP ? GROUP : group;
  const int groups = (K_ROWS ? R : C) / grp;
  const size_t slice = (size_t)blockIdx.z * R * C;
  x += slice;
  out += slice;
  pbits += (size_t)blockIdx.z * groups;
  scale += (size_t)blockIdx.z * (ROW_SCALE ? (K_ROWS ? C : R) : groups);
  const Thread lanes(pbits, scale, c0, C, grp);

  const int step = gridDim.y * blockDim.y * ROWS;
  for (int r0 = (blockIdx.y * blockDim.y + threadIdx.y) * ROWS; r0 < R;
       r0 += step) {
    Pack<T, V> in[ROWS];
    float p[ROWS], s[ROWS];   // the row's precision and scale, if per row
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int r = r0 + j;
      if (r >= R) break;
      const T* src = x + (size_t)r * C + c0;
      if constexpr (ALIGNED) {
        in[j] = *reinterpret_cast<const Pack<T, V>*>(src);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          in[j].v[i] = c0 + i < C ? src[i] : from_f32<T>(0.0f);
      }
      p[j] = K_ROWS ? pbits[r / grp] : 0.0f;
      s[j] = K_ROWS != ROW_SCALE ? scale[K_ROWS ? r / grp : r] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int r = r0 + j;
      if (r >= R) break;
      float xv[V], y[V];
#pragma unroll
      for (int i = 0; i < V; ++i) xv[i] = to_f32(in[j].v[i]);
      lanes.row(xv, p[j], s[j], y);
      T* dst = out + (size_t)r * C + c0;
      if constexpr (ALIGNED) {
        store_vec<T, V>(dst, y);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (c0 + i < C) dst[i] = from_f32<T>(y[i]);
      }
    }
  }
}

int sm_count() {
  static int count[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = count[dev & 63];
  if (n <= 0 && cudaDeviceGetAttribute(
                    &n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    n = 132;
  return n;
}

// Blocks of THREADS threads, tx wide over the column vectors (32 to
// THREADS) and THREADS / tx tall; the grid covers the vectors and, in y,
// the row chunks up to a cap of WAVES waves of 2,048 / THREADS blocks an
// SM (the kernel strides over the rest); the expert on z.
template <typename T, bool K_ROWS, bool ROW_SCALE, int GROUP>
void launch(const void* x, const float* pb, const float* sc, void* out,
            int E, int R, int C, int group, bool aligned, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int vecs = (C + V - 1) / V;
  int tx = 32;
  while (tx < vecs && tx < THREADS) tx *= 2;
  const dim3 block(tx, THREADS / tx);
  const long long gx = (vecs + tx - 1) / tx;
  const long long chunks = (R + ROWS - 1) / ROWS;
  long long gy = (chunks + block.y - 1) / block.y;
  const long long cap = (long long)sm_count() * (2048 / THREADS) * WAVES /
                        (gx * E);
  gy = gy < cap ? gy : (cap > 0 ? cap : 1);
  gy = gy < 65535 ? gy : 65535;
  const dim3 grid((unsigned)gx, (unsigned)gy, E);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (aligned)
    fake_quant_kernel<T, K_ROWS, ROW_SCALE, GROUP, true>
        <<<grid, block, 0, s>>>(xt, pb, sc, ot, R, C, group);
  else
    fake_quant_kernel<T, K_ROWS, ROW_SCALE, GROUP, false>
        <<<grid, block, 0, s>>>(xt, pb, sc, ot, R, C, group);
}

template <typename T, bool K_ROWS, bool ROW_SCALE>
void launch_group(const void* x, const float* pb, const float* sc,
                  void* out, int E, int R, int C, int group, bool aligned,
                  cudaStream_t s) {
  if (group == 16)
    launch<T, K_ROWS, ROW_SCALE, 16>(x, pb, sc, out, E, R, C, group,
                                     aligned, s);
  else
    launch<T, K_ROWS, ROW_SCALE, 0>(x, pb, sc, out, E, R, C, group,
                                    aligned, s);
}

template <typename T>
void dispatch(const void* x, const float* pb, const float* sc, void* out,
              int E, int R, int C, int group, int k_rows, int row_scale,
              bool aligned, cudaStream_t s) {
  if (k_rows) {
    if (row_scale)
      launch_group<T, true, true>(x, pb, sc, out, E, R, C, group, aligned,
                                  s);
    else
      launch_group<T, true, false>(x, pb, sc, out, E, R, C, group, aligned,
                                   s);
  } else {
    if (row_scale)
      launch_group<T, false, true>(x, pb, sc, out, E, R, C, group, aligned,
                                   s);
    else
      launch_group<T, false, false>(x, pb, sc, out, E, R, C, group,
                                    aligned, s);
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
  if (bad_shape(E, R, C, group, k_rows, dtype) || E > 65535 ||
      R > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const int v = dtype == 0 ? 4 : 8;   // elements in 16 bytes
  const bool aligned = (C % v == 0) &&
                       ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out)) % 16 == 0);
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
