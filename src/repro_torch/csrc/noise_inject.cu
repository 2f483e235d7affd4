// Phase-I fused perturbation for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel src/repro/kernels/noise_inject.py::_kernel
// (noise_inject, with src/repro/kernels/prng.py's hash):
//   out[k, n] = clip(w[k, n] + sig[k/G] * eps, -(2 - sig), 2 - sig)
// where eps = (hash(k*N + n, seed) >> 8) * 2^-23 - 1 is U[-1, 1) from a
// counter-based avalanche hash of the global element index: the noise is
// made in registers and never stored. sig = sigmoid(s) per group comes in
// from the wrapper (K/G values, computed once by the same torch op as the
// plain version), and the seed is read from a one-element int64 device
// tensor, so the launch needs no host sync.
//
// What bounds it on the H100: bytes. Each element is read once (4 B) and
// written once (4 B) with ~20 integer and 4 float operations between, far
// below the card's ~20 operations per byte. The design gives each thread
// four neighbouring elements of one row (one 16-byte load and store,
// neighbouring threads on neighbouring addresses) and each block one
// 1,024-column strip of one row, so the row's sig is one scalar per
// thread and every load is coalesced.
//
// Numerics: bit-equal with the plain version. All integer arithmetic is
// uint32 with wraparound, as in the reference. The product sig * eps and
// the sum round separately (__fmul_rn / __fadd_rn keep nvcc from
// contracting them into an FMA), which is how the reference's
// noise_inject_jnp rounds; eps itself is exact in fp32.

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

__device__ __forceinline__ float perturb(float w, float sg, float lim,
                                         uint32_t idx, uint32_t seed) {
  const float eps =
      __fadd_rn(__fmul_rn((float)(hash_u32(idx, seed) >> 8), 0x1p-23f),
                -1.0f);
  const float z = __fadd_rn(w, __fmul_rn(sg, eps));
  return fminf(fmaxf(z, -lim), lim);
}

// grid.x: strips of THREADS*VEC columns; grid.y (strided): rows.
template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
noise_inject_kernel(const float* __restrict__ w,
                    const float* __restrict__ sig,
                    const long long* __restrict__ seed_ptr,
                    float* __restrict__ out, int K, int N, int group) {
  const uint32_t seed = (uint32_t)(*seed_ptr);
  const int n0 = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (n0 >= N) return;
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

}  // namespace

// out[K, N] fp32 = noise_inject(w[K, N] fp32 contiguous, sig[K/group] fp32,
// seed: one int64 on the device (its low 32 bits are the uint32 seed)).
// K*N must stay below 2^32 (the reference's uint32 element index). Returns
// the CUDA error code of the launch (0 on success).
extern "C" int soniq_noise_inject(const void* w, const void* sig,
                                  const void* seed, void* out, int K, int N,
                                  int group, void* stream) {
  if (K <= 0 || N <= 0 || group <= 0 || K % group ||
      (unsigned long long)K * (unsigned long long)N >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  const int strips = (N + THREADS * VEC - 1) / (THREADS * VEC);
  const int rows = K < 65535 ? K : 65535;
  dim3 grid(strips, rows);
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
