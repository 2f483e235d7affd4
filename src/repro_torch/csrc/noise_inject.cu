// Phase-I fused perturbation for Hopper (sm_90a) and its backward, plain
// C ABI.
//
// Forward: replaces the TPU kernel src/repro/kernels/noise_inject.py::_kernel
// (noise_inject, with src/repro/kernels/prng.py's hash):
//   out[k, n] = clip(w[k, n] + sig[k/G] * eps, -(2 - sig), 2 - sig)
// where eps = (hash(k*N + n, seed) >> 8) * 2^-23 - 1 is U[-1, 1) from a
// counter-based avalanche hash of the global element index: the noise is
// made in registers and never stored. sig = sigmoid(s) per group comes in
// from the wrapper (K/G values, computed once by the same torch op as the
// plain version), and the seed is read from a one-element int64 device
// tensor, so the launch needs no host sync.
//
// Backward: replaces the custom VJP src/repro/backend/base.py::
// _noise_inject_bwd (jnp, which XLA fuses into one pass on the TPU):
//   z = w + sig * eps, inside = |z| <= 2 - sig,
//   dw = inside ? g : 0,
//   ds[grp] = (sum over the group's G x N block of
//              g * (inside ? eps : -sign(z))) * sig * (1 - sig).
// eps is rebuilt in registers by the forward's own hash, so nothing but w,
// g and dw crosses device memory.
//
// Expert banks: both take a stacked bank w [E, K, N] in one launch (the
// expert on the grid's last axis), each expert with its own seed (seeds
// [E]) and its own sigmas (sig [E, K/G]); expert e's eps is the hash of the
// index within its own [K, N] and its seed, as the reference's vmap over
// the bank draws it, so the launch equals E single-weight launches bit for
// bit. Offsets into the bank are 64-bit (a mixtral-8x22b bank is 3.2 GB);
// the element index within one expert stays a uint32. A single weight is
// the bank of one.
//
// What bounds both on the H100: bytes. The forward reads and writes each
// element once (8 B), the backward reads w and g and writes dw (12 B),
// with ~20 integer and a few float operations between, far below the
// card's ~20 operations per byte. Each thread takes four neighbouring
// elements of a row (one 16-byte load and store, neighbouring threads on
// neighbouring addresses). The forward gives each block one 1,024-column
// strip of a row. The backward gives each block one whole group (G rows,
// every column): its ds is a sum over that block alone, so the block
// folds it in a fixed order (each thread down its columns strip by strip
// and its rows in order, then a shuffle tree and the warps in order) and
// writes it, with no atomics and no second launch, and the run repeats
// bitwise. Eight rows of loads are in flight per thread (64 KB a block),
// enough to keep device memory busy with one or two groups per SM.
//
// Numerics: dw is bit-equal with the plain version and ds equal up to the
// order of its fp32 sum. All integer arithmetic is uint32 with
// wraparound, as in the reference. The product sig * eps and the sum round
// separately (__fmul_rn / __fadd_rn keep nvcc from contracting them into
// an FMA), which is how the reference's noise_inject_jnp rounds; eps itself
// is exact in fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;

__device__ __forceinline__ uint32_t hash_u32(uint32_t idx, uint32_t seed) {
  uint32_t h = idx * 0x9E3779B1u + seed;
  h ^= h >> 15;
  h *= 0x85EBCA77u;
  h ^= h >> 13;
  h *= 0xC2B2AE3Du;
  h ^= h >> 16;
  return h;
}

// U[-1, 1): the top 24 bits times 2^-23, minus 1 (both steps exact).
__device__ __forceinline__ float hash_eps(uint32_t idx, uint32_t seed) {
  return __fadd_rn(__fmul_rn((float)(hash_u32(idx, seed) >> 8), 0x1p-23f),
                   -1.0f);
}

__device__ __forceinline__ float perturb(float w, float sg, float lim,
                                         uint32_t idx, uint32_t seed) {
  const float z = __fadd_rn(w, __fmul_rn(sg, hash_eps(idx, seed)));
  return fminf(fmaxf(z, -lim), lim);
}

// One element of the backward: writes dw, returns g * d out / d sig.
__device__ __forceinline__ float perturb_bwd(float w, float g, float sg,
                                             float lim, uint32_t idx,
                                             uint32_t seed, float* dw) {
  const float eps = hash_eps(idx, seed);
  const float z = __fadd_rn(w, __fmul_rn(sg, eps));
  const bool inside = fabsf(z) <= lim;
  *dw = inside ? g : 0.0f;
  // torch.sign: +-1, and 0 for 0 and NaN.
  const float sgn = (float)((z > 0.0f) - (z < 0.0f));
  return __fmul_rn(g, inside ? eps : -sgn);
}

// grid.x: strips of THREADS*VEC columns; grid.y (strided): rows; grid.z:
// experts of a bank (one for a single weight). Expert e reads its own
// seed, its own K/group sigmas and its own [K, N] slice at a 64-bit
// offset; the hash index stays the element's index within its expert.
template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
noise_inject_kernel(const float* __restrict__ w,
                    const float* __restrict__ sig,
                    const long long* __restrict__ seeds,
                    float* __restrict__ out, int K, int N, int group) {
  const int e = blockIdx.z;
  const uint32_t seed = (uint32_t)(seeds[e]);
  const int n0 = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (n0 >= N) return;
  const size_t slice = (size_t)e * K * N;
  w += slice;
  out += slice;
  sig += (size_t)e * (K / group);
  for (int k = blockIdx.y; k < K; k += gridDim.y) {
    const float sg = sig[k / group];
    const float lim = __fsub_rn(2.0f, sg);
    const size_t row = (size_t)k * N;
    const uint32_t base = (uint32_t)k * (uint32_t)N + (uint32_t)n0;
    if (ALIGNED) {
      const float4 v = *reinterpret_cast<const float4*>(w + row + n0);
      float4 o;
      o.x = perturb(v.x, sg, lim, base + 0u, seed);
      o.y = perturb(v.y, sg, lim, base + 1u, seed);
      o.z = perturb(v.z, sg, lim, base + 2u, seed);
      o.w = perturb(v.w, sg, lim, base + 3u, seed);
      *reinterpret_cast<float4*>(out + row + n0) = o;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (n0 + j < N)
          out[row + n0 + j] =
              perturb(w[row + n0 + j], sg, lim, base + (uint32_t)j, seed);
      }
    }
  }
}

constexpr int BWD_THREADS = 256;
constexpr int BWD_ROWS = 8;   // rows of a group whose loads are in flight

// grid.x: groups; grid.y: experts of a bank (one for a single weight),
// each at its own 64-bit offset with its own seed and sigmas. Thread t
// takes columns [4t, 4t + 4) of every BWD_THREADS * 4-column strip, strip
// after strip, the group's rows in order within each; its sum, then the
// block's, fold in that fixed order.
template <bool ALIGNED>
__global__ void __launch_bounds__(BWD_THREADS)
noise_inject_bwd_kernel(const float* __restrict__ w,
                        const float* __restrict__ sig,
                        const long long* __restrict__ seeds,
                        const float* __restrict__ g, float* __restrict__ dw,
                        float* __restrict__ ds, int N, int group) {
  const int e = blockIdx.y;
  const uint32_t seed = (uint32_t)(seeds[e]);
  const size_t groups = gridDim.x;
  const size_t slice = (size_t)e * groups * group * N;
  w += slice;
  g += slice;
  dw += slice;
  sig += (size_t)e * groups;
  ds += (size_t)e * groups;
  const int grp = blockIdx.x;
  const float sg = sig[grp];
  const float lim = __fsub_rn(2.0f, sg);
  const int k0 = grp * group;
  float acc = 0.0f;
  for (int n0 = threadIdx.x * VEC; n0 < N; n0 += BWD_THREADS * VEC) {
    for (int r0 = 0; r0 < group; r0 += BWD_ROWS) {
      float wv[BWD_ROWS][VEC], gv[BWD_ROWS][VEC];
#pragma unroll
      for (int j = 0; j < BWD_ROWS; ++j) {
        if (r0 + j >= group) continue;
        const size_t at = (size_t)(k0 + r0 + j) * N + n0;
        if (ALIGNED) {
          const float4 a = *reinterpret_cast<const float4*>(w + at);
          const float4 b = *reinterpret_cast<const float4*>(g + at);
          wv[j][0] = a.x; wv[j][1] = a.y; wv[j][2] = a.z; wv[j][3] = a.w;
          gv[j][0] = b.x; gv[j][1] = b.y; gv[j][2] = b.z; gv[j][3] = b.w;
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            const bool in = n0 + c < N;
            wv[j][c] = in ? w[at + c] : 0.0f;
            gv[j][c] = in ? g[at + c] : 0.0f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < BWD_ROWS; ++j) {
        if (r0 + j >= group) continue;
        const int k = k0 + r0 + j;
        const size_t at = (size_t)k * N + n0;
        const uint32_t base = (uint32_t)k * (uint32_t)N + (uint32_t)n0;
        float t[VEC], d[VEC];
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          t[c] = perturb_bwd(wv[j][c], gv[j][c], sg, lim, base + (uint32_t)c,
                             seed, &d[c]);
        if (ALIGNED) {
          *reinterpret_cast<float4*>(dw + at) =
              make_float4(d[0], d[1], d[2], d[3]);
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            if (n0 + c < N) dw[at + c] = d[c];
            else t[c] = 0.0f;
          }
        }
        acc = __fadd_rn(acc, __fadd_rn(__fadd_rn(t[0], t[1]),
                                       __fadd_rn(t[2], t[3])));
      }
    }
  }
  __shared__ float warp_sum[BWD_THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = warp_sum[0];
#pragma unroll
    for (int i = 1; i < BWD_THREADS / 32; ++i)
      total = __fadd_rn(total, warp_sum[i]);
    ds[grp] = __fmul_rn(__fmul_rn(total, sg), __fsub_rn(1.0f, sg));
  }
}

bool bad_shape(int E, int K, int N, int group) {
  return E <= 0 || E > 65535 || K <= 0 || N <= 0 || group <= 0 ||
         K % group ||
         (unsigned long long)K * (unsigned long long)N >= (1ull << 32);
}

}  // namespace

// out[E, K, N] fp32 = noise_inject of each expert's slice (w[E, K, N] fp32
// contiguous, sig[E, K/group] fp32, seeds: E int64 on the device, whose low
// 32 bits are the uint32 seeds); E = 1 is a single weight. K*N must stay
// below 2^32 (the reference's uint32 element index within an expert).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int soniq_noise_inject(const void* w, const void* sig,
                                  const void* seed, void* out, int E, int K,
                                  int N, int group, void* stream) {
  if (bad_shape(E, K, N, group)) return (int)cudaErrorInvalidValue;
  const int strips = (N + THREADS * VEC - 1) / (THREADS * VEC);
  const int rows = K < 65535 ? K : 65535;
  dim3 grid(strips, rows, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(sig);
  const long long* seedp = static_cast<const long long*>(seed);
  float* of = static_cast<float*>(out);
  const bool aligned = (N % VEC == 0) &&
                       (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned)
    noise_inject_kernel<true><<<grid, THREADS, 0, s>>>(wf, sf, seedp, of, K,
                                                       N, group);
  else
    noise_inject_kernel<false><<<grid, THREADS, 0, s>>>(wf, sf, seedp, of,
                                                        K, N, group);
  return (int)cudaGetLastError();
}

// (dw [E, K, N] fp32, ds [E, K/group] fp32) = the backward of noise_inject
// at (w, sig, seeds) for the cotangent g [E, K, N] fp32 (all contiguous;
// the operands as the forward takes them). One block a group of an expert.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int soniq_noise_inject_bwd(const void* w, const void* sig,
                                      const void* seed, const void* g,
                                      void* dw, void* ds, int E, int K,
                                      int N, int group, void* stream) {
  if (bad_shape(E, K, N, group)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(sig);
  const long long* seedp = static_cast<const long long*>(seed);
  const float* gf = static_cast<const float*>(g);
  float* dwf = static_cast<float*>(dw);
  float* dsf = static_cast<float*>(ds);
  const bool aligned = (N % VEC == 0) &&
                       ((reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dw)) % 16 == 0);
  const dim3 grid(K / group, E);
  if (aligned)
    noise_inject_bwd_kernel<true><<<grid, BWD_THREADS, 0, s>>>(
        wf, sf, seedp, gf, dwf, dsf, N, group);
  else
    noise_inject_bwd_kernel<false><<<grid, BWD_THREADS, 0, s>>>(
        wf, sf, seedp, gf, dwf, dsf, N, group);
  return (int)cudaGetLastError();
}
