// Fused activation-quant segment GEMM for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernels of src/repro/kernels/packed_matmul.py:
//   _fused_kernel            (fused_act_segment_matmul, driver scale), and
//   _fused_selfscale_kernel  (fused_act_selfscale_matmul, in-kernel scale).
// One templated kernel covers p in {1, 2, 4}, x in bf16 or fp32, and both
// scale modes:
//   y[M, N] += xq[M, Kp] @ (unpack_dequant(wp[Kp*p/8, N]) * wscale[Kp/16])
//   xq = round_through_x_dtype(snap_p(x / sx) * sx)
// with sx the driver's per-token scale or, in self-scale mode, the fp32
// abs-max of the full row clamped at 1e-6 and divided by 1.875.
//
// What bounds it on the H100: the packed weight bytes at decode (M = 4:
// ~2.9 bits per weight against 8 FMAs of work per byte), fp32 FMA issue at
// prefill widths (M = 32: 2*M FLOPs per weight against 67 TFLOP/s). The
// design streams each weight byte from device memory once per block of
// BM rows: a block owns a BM x BN output tile, walks K in BK-channel stages
// (whole 16-channel groups), stages the prologue'd activations and the
// unpacked, dequantized, group-scaled weights in fp32 shared memory, and
// accumulates with fp32 FMA in registers, K in ascending order; the next
// stage's raw operands are loaded into registers while the current one
// computes, so a stage costs about one memory latency. No tensor
// cores: TF32 or bf16 MMA would break the fp32 contract of the reference;
// wgmma/TMA pipelining is later work. Each output element is summed by
// one thread in one fixed order, so a row's result does not depend on how
// many rows share the launch (continuous batching relies on that).
//
// Numerics follow the reference element for element: IEEE divisions by
// sx (__fdiv_rn), round half to even (rintf), the 1.875 divide kept a
// true division (the counterpart of the optimization_barrier in the
// reference), and the bf16 round trip through __float2bfloat16_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;                      // output rows per block
constexpr int BN = 64;                      // output columns per block
constexpr int BK = 64;                      // channels per K stage
constexpr int THREADS = 256;
constexpr int RPT = BM * BN / THREADS;      // rows per thread (4)
constexpr int XPT = BM * BK / THREADS;      // staged x values per thread
constexpr int WPT = BK * BN / THREADS;      // staged weights per thread

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float round_through(float v, const float*) {
  return v;
}
__device__ __forceinline__ float round_through(float v,
                                               const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Issue the global loads of one K stage into registers: x values (0 past
// M or Kp) and raw carrier bytes (-1 past Kp or N).
template <int P, typename XT>
__device__ __forceinline__ void load_stage(
    const XT* __restrict__ x, long long ldx, const uint8_t* __restrict__ wp,
    int M, int N, int kp, int m0, int n0, int k0, int tid, float (&xr)[XPT],
    int (&wr)[WPT]) {
  constexpr int VPB = 8 / P;
#pragma unroll
  for (int it = 0; it < XPT; ++it) {
    const int i = tid + it * THREADS;
    const int m = m0 + i / BK;
    const int k = k0 + i % BK;
    xr[it] = (m < M && k < kp) ? load_x(x + (long long)m * ldx + k) : 0.f;
  }
#pragma unroll
  for (int it = 0; it < WPT; ++it) {
    const int i = tid + it * THREADS;
    const int k = k0 + i / BN;
    const int n = n0 + i % BN;
    wr[it] = (k < kp && n < N) ? (int)wp[(long long)(k / VPB) * N + n] : -1;
  }
}

template <int P, typename XT, bool SELF>
__global__ void __launch_bounds__(THREADS)
segment_gemm_kernel(const XT* __restrict__ x, long long ldx,
                    const float* __restrict__ sx,
                    const uint8_t* __restrict__ wp,
                    const float* __restrict__ wscale,
                    float* __restrict__ y, int M, int N, int kp,
                    int group) {
  constexpr int VPB = 8 / P;                       // codes per byte
  static_assert(XPT * THREADS == BM * BK && WPT * THREADS == BK * BN,
                "tiles must divide among the threads");
  constexpr int MASK = (1 << P) - 1;
  constexpr float H = 1.0f / (float)(1 << (P - 1));  // 2^(1-p), exact
  constexpr float INV_H = (float)(1 << (P - 1));     // 2^(p-1), exact
  constexpr float TOP = (float)((1 << P) - 1);       // 2^p - 1

  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][BN];
  __shared__ float s_row[BM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  if (SELF) {
    // 16 lanes per row reduce max|x| over the full K row (exact in any
    // order), then one IEEE divide by the 4-bit grid top.
    const int r = tid / 16;
    const int lane = tid % 16;
    float m = 0.f;
    if (m0 + r < M) {
      const XT* row = x + (long long)(m0 + r) * ldx;
      for (int k = lane; k < kp; k += 16)
        m = fmaxf(m, fabsf(load_x(row + k)));
    }
    for (int off = 8; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) s_row[r] = __fdiv_rn(fmaxf(m, 1e-6f), 1.875f);
  } else if (tid < BM) {
    s_row[tid] = (m0 + tid < M) ? sx[m0 + tid] : 1.f;
  }
  __syncthreads();

  const int col = tid % BN;
  const int rg = tid / BN;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  // Raw operands of the next stage, loaded into registers while the
  // current stage computes (every load of a stage is issued at once).
  float xr[XPT];
  int wr[WPT];
  load_stage<P>(x, ldx, wp, M, N, kp, m0, n0, 0, tid, xr, wr);

  for (int k0 = 0; k0 < kp; k0 += BK) {
    // Activation prologue: divide, snap to the p-bit grid, rescale, round
    // through x's dtype. Lanes past M or Kp stage zeros.
#pragma unroll
    for (int it = 0; it < XPT; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / BK;
      const int kk = i % BK;
      float v = 0.f;
      if (m0 + r < M && k0 + kk < kp) {
        const float s = s_row[r];
        const float q = __fdiv_rn(xr[it], s);
        float u = rintf((q * INV_H + TOP) * 0.5f);
        u = fminf(fmaxf(u, 0.f), TOP);
        v = round_through(((2.f * u - TOP) * H) * s, x);
      }
      xs[r][kk] = v;
    }
    // Weight tile: the code of channel k sits in byte k / VPB at bit
    // p * (k % VPB); dequantize and apply the group scale.
#pragma unroll
    for (int it = 0; it < WPT; ++it) {
      const int i = tid + it * THREADS;
      const int kk = i / BN;
      const int c = i % BN;
      const int k = k0 + kk;
      float w = 0.f;
      if (wr[it] >= 0) {
        const int u = (wr[it] >> ((k % VPB) * P)) & MASK;
        w = (2.f * (float)u - TOP) * H;
        if (wscale != nullptr) w = w * wscale[k / group];
      }
      ws[kk][c] = w;
    }
    __syncthreads();
    if (k0 + BK < kp)
      load_stage<P>(x, ldx, wp, M, N, kp, m0, n0, k0 + BK, tid, xr, wr);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float w = ws[kk][col];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = fmaf(xs[rg * RPT + i][kk], w, acc[i]);
    }
    __syncthreads();
  }

  const int n = n0 + col;
  if (n < N) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = m0 + rg * RPT + i;
      if (m < M) y[(long long)m * N + n] += acc[i];
    }
  }
}

template <int P, typename XT>
void launch(const void* x, long long ldx, const float* sx,
            const uint8_t* wp, const float* wscale, float* y, int M,
            int N, int kp, int group, int self_scale, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const XT* xt = static_cast<const XT*>(x);
  if (self_scale)
    segment_gemm_kernel<P, XT, true><<<grid, THREADS, 0, stream>>>(
        xt, ldx, sx, wp, wscale, y, M, N, kp, group);
  else
    segment_gemm_kernel<P, XT, false><<<grid, THREADS, 0, stream>>>(
        xt, ldx, sx, wp, wscale, y, M, N, kp, group);
}

template <typename XT>
int dispatch_p(int p, const void* x, long long ldx, const float* sx,
               const uint8_t* wp, const float* wscale, float* y, int M,
               int N, int kp, int group, int self_scale,
               cudaStream_t stream) {
  switch (p) {
    case 4:
      launch<4, XT>(x, ldx, sx, wp, wscale, y, M, N, kp, group, self_scale,
                    stream);
      return 0;
    case 2:
      launch<2, XT>(x, ldx, sx, wp, wscale, y, M, N, kp, group, self_scale,
                    stream);
      return 0;
    case 1:
      launch<1, XT>(x, ldx, sx, wp, wscale, y, M, N, kp, group, self_scale,
                    stream);
      return 0;
    default:
      return 1;
  }
}

}  // namespace

// y[M, N] (fp32, contiguous) += the fused segment GEMM. x: [M, kp] with
// row stride ldx elements and unit column stride, bf16 if x_bf16 else
// fp32. sx: [M] fp32 (ignored when self_scale). wp: [kp*p/8, N] uint8,
// contiguous. wscale: [ceil(kp/group)] fp32 or null. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int soniq_segment_gemm(const void* x, long long ldx, int x_bf16,
                                  const void* sx, const void* wp,
                                  const void* wscale, void* y, int M, int N,
                                  int kp, int p, int group, int self_scale,
                                  void* stream) {
  if (M <= 0 || N <= 0 || kp <= 0 || group <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sxf = static_cast<const float*>(sx);
  const uint8_t* wpb = static_cast<const uint8_t*>(wp);
  const float* wsf = static_cast<const float*>(wscale);
  float* yf = static_cast<float*>(y);
  const int bad =
      x_bf16 ? dispatch_p<__nv_bfloat16>(p, x, ldx, sxf, wpb, wsf, yf, M, N,
                                         kp, group, self_scale, s)
             : dispatch_p<float>(p, x, ldx, sxf, wpb, wsf, yf, M, N, kp,
                                 group, self_scale, s);
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
