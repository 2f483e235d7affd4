// SMOL quantize + bit-pack for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel src/repro/kernels/quant_pack.py::_kernel
// (quantize_pack): w[K, N] fp32, optionally divided by per-group scales,
// rounds to p-bit SMOL codes clip(rint((w/h + 2^p - 1) / 2), 0, 2^p - 1)
// and packs 8/p codes per byte along K, little-endian (code j of a byte at
// bit p*j): out[K*p/8, N] uint8. Bit-exact with the reference.
//
// What bounds it on the H100: bytes — it reads 4 bytes of weight for every
// p/8 byte it writes and does a handful of ALU operations per element, so
// the fp32 read stream sets the floor. The design gives one thread to each
// output byte: it reads its 8/p weights down K (each read coalesced across
// N by the neighbouring threads), ORs the codes and writes the byte, so
// every weight is read once and every byte written once, with no shared
// memory and no synchronisation.
//
// Numerics: the division by the group scale is an IEEE division
// (__fdiv_rn; a reciprocal multiply is one ulp off), rounding is half to
// even (rintf), and w/h is an exact multiply by the power of two 2^(p-1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int P>
__global__ void __launch_bounds__(THREADS)
quant_pack_kernel(const float* __restrict__ w,
                  const float* __restrict__ scales,
                  uint8_t* __restrict__ out, long long rows, int N,
                  int group) {
  constexpr int VPB = 8 / P;
  constexpr float INV_H = (float)(1 << (P - 1));
  constexpr float TOP = (float)((1 << P) - 1);
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= rows * N) return;
  const long long r = idx / N;
  const int n = (int)(idx % N);
  unsigned int byte = 0;
#pragma unroll
  for (int j = 0; j < VPB; ++j) {
    const long long k = r * VPB + j;
    float v = w[k * N + n];
    if (scales != nullptr) v = __fdiv_rn(v, scales[k / group]);
    float u = rintf((v * INV_H + TOP) * 0.5f);
    u = fminf(fmaxf(u, 0.f), TOP);
    byte |= ((unsigned int)u) << (P * j);
  }
  out[idx] = (uint8_t)byte;
}

}  // namespace

// out[K*p/8, N] uint8 = quantize_pack(w[K, N] fp32 contiguous, scales
// [K/group] fp32 or null). K must be a multiple of 8/p. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int soniq_quant_pack(const void* w, const void* scales, void* out,
                                int K, int N, int p, int group,
                                void* stream) {
  if (K <= 0 || N <= 0 || group <= 0 || (p != 1 && p != 2 && p != 4) ||
      K % (8 / p))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)K * p / 8;
  const long long total = rows * N;
  const unsigned int blocks = (unsigned int)((total + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(scales);
  uint8_t* ob = static_cast<uint8_t*>(out);
  switch (p) {
    case 4:
      quant_pack_kernel<4><<<blocks, THREADS, 0, s>>>(wf, sf, ob, rows, N,
                                                      group);
      break;
    case 2:
      quant_pack_kernel<2><<<blocks, THREADS, 0, s>>>(wf, sf, ob, rows, N,
                                                      group);
      break;
    default:
      quant_pack_kernel<1><<<blocks, THREADS, 0, s>>>(wf, sf, ob, rows, N,
                                                      group);
      break;
  }
  return (int)cudaGetLastError();
}
