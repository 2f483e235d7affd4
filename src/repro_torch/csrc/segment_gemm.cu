// Segment GEMM for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernels of src/repro/kernels/packed_matmul.py:
//   _fused_kernel            (fused_act_segment_matmul, driver scale),
//   _fused_selfscale_kernel  (fused_act_selfscale_matmul, in-kernel scale),
//   _kernel                  (packed_segment_matmul, plain), and
//   _grouped_kernel          (packed_segment_matmul_grouped, plain over a
//                             stacked expert bank).
// One templated kernel body covers p in {1, 2, 4}, x in bf16 or fp32, and
// four prologue modes:
//   y[M, N] += xq[M, Kp] @ (unpack_dequant(wp[Kp*p/8, N]) * wscale[Kp/16])
//   fused:  xq = round_through_x_dtype(snap_p(x / sx) * sx), sx the
//           driver's per-token scale;
//   self:   the same with sx the fp32 abs-max of the full row clamped at
//           1e-6 and divided by 1.875;
//   plain:  xq = x (the second pass of the two-pass form, and the
//           unquantized-activation path);
//   snap:   xq = snap_p(x), x already in scale units (act_quant).
// The grouped form is the same body with blockIdx.z over experts: x, wp,
// wscale and y each advance by their own expert stride, so expert e's
// result is bitwise the single-expert launch on expert e's operands.
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
// one thread in one fixed order, the same in every mode, so a row's
// result does not depend on how many rows share the launch (continuous
// batching relies on that), and the two-pass form (fake_quant, then the
// plain mode) is bitwise the fused form. The grouped form runs every
// expert over every row of the drop-free dispatch buffer, as the TPU
// kernel does; skipping experts with no routed token is later work.
//
// Numerics follow the reference element for element: IEEE divisions by
// sx (__fdiv_rn), round half to even (rintf), the 1.875 divide kept a
// true division (the counterpart of the optimization_barrier in the
// reference), the bf16 round trip through __float2bfloat16_rn, and the
// grid step 2^(1-p) a power of two, so scaling by it is exact.

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

enum Mode { FUSED = 0, SELF = 1, PLAIN = 2, SNAP = 3 };

template <int P, typename XT, int MODE>
__global__ void __launch_bounds__(THREADS)
segment_gemm_kernel(const XT* __restrict__ x, long long ldx, long long x_es,
                    const float* __restrict__ sx,
                    const uint8_t* __restrict__ wp, long long wp_es,
                    const float* __restrict__ wscale, long long ws_es,
                    float* __restrict__ y, long long y_es, int M, int N,
                    int kp, int group) {
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
  // This block's expert (0 for a single-segment launch).
  const long long e = blockIdx.z;
  x += e * x_es;
  wp += e * wp_es;
  if (wscale != nullptr) wscale += e * ws_es;
  y += e * y_es;

  if (MODE == SELF) {
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
  } else if (MODE == FUSED && tid < BM) {
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
    // Activation prologue. Lanes past M or Kp stage zeros.
#pragma unroll
    for (int it = 0; it < XPT; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / BK;
      const int kk = i % BK;
      float v = 0.f;
      if (m0 + r < M && k0 + kk < kp) {
        if (MODE == PLAIN) {
          v = xr[it];
        } else if (MODE == SNAP) {
          // snap_p of a value already in scale units.
          float u = rintf((xr[it] * INV_H + TOP) * 0.5f);
          u = fminf(fmaxf(u, 0.f), TOP);
          v = (2.f * u - TOP) * H;
        } else {
          // Divide, snap to the p-bit grid, rescale, round through x's
          // dtype.
          const float s = s_row[r];
          const float q = __fdiv_rn(xr[it], s);
          float u = rintf((q * INV_H + TOP) * 0.5f);
          u = fminf(fmaxf(u, 0.f), TOP);
          v = round_through(((2.f * u - TOP) * H) * s, x);
        }
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

// Operands of one launch: E experts (1 for a single segment), each with
// its own x, wp, wscale and y at the given element strides.
struct Args {
  const void* x;
  long long ldx, x_es;
  const float* sx;
  const uint8_t* wp;
  long long wp_es;
  const float* wscale;
  long long ws_es;
  float* y;
  long long y_es;
  int E, M, N, kp, group;
};

template <int P, typename XT, int MODE>
void launch_mode(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, a.E);
  segment_gemm_kernel<P, XT, MODE><<<grid, THREADS, 0, stream>>>(
      static_cast<const XT*>(a.x), a.ldx, a.x_es, a.sx, a.wp, a.wp_es,
      a.wscale, a.ws_es, a.y, a.y_es, a.M, a.N, a.kp, a.group);
}

template <int P, typename XT>
int launch(const Args& a, int mode, cudaStream_t stream) {
  switch (mode) {
    case FUSED: launch_mode<P, XT, FUSED>(a, stream); return 0;
    case SELF: launch_mode<P, XT, SELF>(a, stream); return 0;
    case PLAIN: launch_mode<P, XT, PLAIN>(a, stream); return 0;
    case SNAP: launch_mode<P, XT, SNAP>(a, stream); return 0;
    default: return 1;
  }
}

template <typename XT>
int dispatch_p(int p, const Args& a, int mode, cudaStream_t stream) {
  switch (p) {
    case 4: return launch<4, XT>(a, mode, stream);
    case 2: return launch<2, XT>(a, mode, stream);
    case 1: return launch<1, XT>(a, mode, stream);
    default: return 1;
  }
}

}  // namespace

// y (fp32) += the segment GEMM of each of E experts (E = 1: one segment).
// Expert e reads x + e*x_es: [M, kp] with row stride ldx elements and unit
// column stride, bf16 if x_bf16 else fp32; wp + e*wp_es: [kp*p/8, N]
// uint8, contiguous; wscale + e*ws_es: [ceil(kp/group)] fp32, or null;
// and adds into y + e*y_es: [M, N] fp32, contiguous. mode: 0 fused (sx:
// [M] fp32, one per row, shared by the experts), 1 self-scale, 2 plain,
// 3 plain with the snap to the p-bit grid. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int soniq_segment_gemm(const void* x, long long ldx,
                                  long long x_es, int x_bf16,
                                  const void* sx, const void* wp,
                                  long long wp_es, const void* wscale,
                                  long long ws_es, void* y, long long y_es,
                                  int E, int M, int N, int kp, int p,
                                  int group, int mode, void* stream) {
  if (E <= 0 || E > 65535 || M <= 0 || N <= 0 || kp <= 0 || group <= 0)
    return (int)cudaErrorInvalidValue;
  if (mode == FUSED && sx == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{x, ldx, x_es, static_cast<const float*>(sx),
               static_cast<const uint8_t*>(wp), wp_es,
               static_cast<const float*>(wscale), ws_es,
               static_cast<float*>(y), y_es, E, M, N, kp, group};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = x_bf16 ? dispatch_p<__nv_bfloat16>(p, a, mode, s)
                         : dispatch_p<float>(p, a, mode, s);
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
