// Decode attention over the packed 4-bit KV cache for Hopper (sm_90a),
// plain C ABI.
//
// Replaces the two TPU kernels of src/repro/kernels/attn_decode.py:
//   _kernel       (qkv_attn_decode, B4): GQA attention over the packed
//                 ring [B, T, Hk, D/2], exact softmax over the full row;
//   _paged_kernel (qkv_attn_decode_paged, B5): the same over the page pool
//                 [P, ps, Hk, D/2] through the per-slot page table, online
//                 softmax; unmapped pages (id < 0) read the null page 0
//                 and are masked.
// q [B, S, Hk, G, D] fp32 -> out [B, S, Hk, G, D] fp32. Codes hold channel
// 2j in the low nibble and dequantize as (2u - 15) * 0.125 * scale (fp16
// scale per entry and head). Mask: causal by position, entries with
// pos < 0 dropped, optional sliding window (window < 0 = none), -1e30
// fill; an all-masked row is the uniform average, as in the reference.
//
// What bounds it on the H100: bytes at decode (the code stream, 0.5 byte
// per K or V element; a few fp ops per element) and latency at these
// sizes: one block per (batch row, kv-head) and tile of 32 query rows,
// B * Hk * ceil(S*G / 32) blocks (32 at batch 4) for 132 SMs.
//
// Design. A TPU program holds the whole [S*G, T] fp32 score row in VMEM;
// here the block walks the keys in tiles of up to 128 entries staged in
// shared memory (codes unpacked and scaled once per tile), so any T fits:
// B4 recomputes the tile scores in three passes (row max; sum of exps;
// p = exp(s - m) / l times V), B5 carries (m, l, acc) across the tiles of
// each page as the reference does (m2 = max(m, max s); alpha = exp(m - m2);
// l = l * alpha + sum p; acc = acc * alpha + p @ V; out = acc / max(l,
// 1e-30)). Numerics follow the port's row-reduction rule
// (repro_torch/core/numerics.py): the dequantized K/V are exact in fp32,
// and the dots, exps, sums and the value contraction run in float64 and
// are rounded once to fp32. Each output element is summed by one thread
// in one fixed order, and the row reductions use a fixed warp tree, so a
// row does not depend on the batch, on S or on the other rows of its
// block; and the ring and paged forms of the same content agree to within
// float64 rounding before that one rounding.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;    // query rows (of S * G) per block
constexpr int kTile = 128;   // keys per shared-memory tile
constexpr int kMaxD = 128;
constexpr int kOut = kRows * kMaxD / kThreads;   // accumulators a thread
constexpr double kNegInf = -1e30;

struct Shared {
  double* q;        // [kRows][D]
  double* s;        // [kRows][kTile] scores, then probabilities
  double* m;        // [kRows] row max
  double* l;        // [kRows] row sum of exps
  double* alpha;    // [kRows] this tile's rescale (B5)
  long long* key;   // [kTile] entry index into the [N, Hk, ...] streams
  float* kv;        // [kTile][D + 1] dequantized K or V tile
  int* qpos;        // [kRows]
  int* kpos;        // [kTile]
};

__host__ __device__ inline size_t smem_bytes(int d) {
  return sizeof(double) * ((size_t)kRows * d + kRows * kTile + 3 * kRows) +
         sizeof(long long) * kTile + sizeof(float) * (size_t)kTile * (d + 1) +
         sizeof(int) * (kRows + kTile);
}

__device__ inline Shared carve(unsigned char* base, int d) {
  Shared sh;
  double* dp = reinterpret_cast<double*>(base);
  sh.q = dp;
  sh.s = sh.q + kRows * d;
  sh.m = sh.s + kRows * kTile;
  sh.l = sh.m + kRows;
  sh.alpha = sh.l + kRows;
  sh.key = reinterpret_cast<long long*>(sh.alpha + kRows);
  sh.kv = reinterpret_cast<float*>(sh.key + kTile);
  sh.qpos = reinterpret_cast<int*>(sh.kv + kTile * (d + 1));
  sh.kpos = sh.qpos + kRows;
  return sh;
}

__device__ inline double warp_max(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Geometry {
  int b, h, hk, g, d, s, rows, row0, window;
};

// Block set-up: the block's query rows (row r = row0 + r of the s-major
// S*G list: s = r / G, g = r % G) into shared memory as float64, their
// positions, and the softmax state.
__device__ inline void load_queries(const float* __restrict__ q,
                                    const int* __restrict__ q_pos,
                                    const Geometry& gm, const Shared& sh) {
  for (int idx = threadIdx.x; idx < gm.rows * gm.d; idx += kThreads) {
    const int r = idx / gm.d, dd = idx - r * gm.d;
    const int rr = gm.row0 + r, si = rr / gm.g, gi = rr - si * gm.g;
    const long long at =
        (((long long)gm.b * gm.s + si) * gm.hk + gm.h) * gm.g + gi;
    sh.q[idx] = (double)q[at * gm.d + dd];
  }
  for (int r = threadIdx.x; r < gm.rows; r += kThreads) {
    const int rr = gm.row0 + r;
    sh.qpos[r] = q_pos[(long long)gm.b * gm.s + rr / gm.g];
    sh.m[r] = kNegInf;
    sh.l[r] = 0.0;
  }
}

// Tile keys: entry index key0 + j and its position stamp, j < n.
__device__ inline void load_keys(const int* __restrict__ pos, long long key0,
                                 int n, const Shared& sh) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    sh.key[j] = key0 + j;
    sh.kpos[j] = pos[key0 + j];
  }
}

// Unpack and scale the tile's K or V rows of head h into sh.kv (fp32,
// exact: a 4-bit grid value times an fp16 scale).
__device__ inline void load_values(const uint8_t* __restrict__ codes,
                                   const __half* __restrict__ scales, int n,
                                   const Geometry& gm, const Shared& sh) {
  const int half = gm.d / 2, ld = gm.d + 1;
  for (int idx = threadIdx.x; idx < n * half; idx += kThreads) {
    const int j = idx / half, c = idx - j * half;
    const long long row = sh.key[j] * gm.hk + gm.h;
    const unsigned byte = codes[row * half + c];
    const float sc = __half2float(scales[row]);
    sh.kv[j * ld + 2 * c] = (float)(2 * (int)(byte & 15u) - 15) * 0.125f * sc;
    sh.kv[j * ld + 2 * c + 1] = (float)(2 * (int)(byte >> 4) - 15) * 0.125f * sc;
  }
}

// Masked scores of the tile (sh.kv holds K): s = (q . k) / sqrt(D), or
// -1e30 where the mask drops the entry.
__device__ inline void tile_scores(int n, bool mapped, const Geometry& gm,
                                   const Shared& sh) {
  const double inv = 1.0 / sqrt((double)gm.d);
  const int ld = gm.d + 1;
  for (int idx = threadIdx.x; idx < gm.rows * n; idx += kThreads) {
    const int r = idx / n, j = idx - r * n;
    const double* qr = sh.q + r * gm.d;
    const float* kj = sh.kv + j * ld;
    double dot = 0.0;
    for (int dd = 0; dd < gm.d; ++dd) dot = fma(qr[dd], (double)kj[dd], dot);
    const int qp = sh.qpos[r], kp = sh.kpos[j];
    const bool ok = mapped && kp >= 0 && qp >= kp &&
                    (gm.window < 0 || qp - kp < gm.window);
    sh.s[r * kTile + j] = ok ? dot * inv : kNegInf;
  }
}

// acc[k] (output element o = threadIdx.x + k * kThreads of the block's
// rows x D) = acc[k] * rescale(row) + sum_j p[row][j] * v[j][d], the sum
// in order of j.
__device__ inline void tile_pv(double (&acc)[kOut], int n, bool rescale,
                               const Geometry& gm, const Shared& sh) {
  const int ld = gm.d + 1;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int o = threadIdx.x + k * kThreads;
    if (o < gm.rows * gm.d) {
      const int r = o / gm.d, dd = o - r * gm.d;
      const double* pr = sh.s + r * kTile;
      double a = rescale ? 0.0 : acc[k];
      for (int j = 0; j < n; ++j) a = fma(pr[j], (double)sh.kv[j * ld + dd], a);
      acc[k] = rescale ? acc[k] * sh.alpha[r] + a : a;
    }
  }
}

__device__ inline void store_out(float* __restrict__ out,
                                 const double (&acc)[kOut], bool divide,
                                 const Geometry& gm, const Shared& sh) {
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int o = threadIdx.x + k * kThreads;
    if (o < gm.rows * gm.d) {
      const int r = o / gm.d, dd = o - r * gm.d;
      const int rr = gm.row0 + r, si = rr / gm.g, gi = rr - si * gm.g;
      const long long at =
          (((long long)gm.b * gm.s + si) * gm.hk + gm.h) * gm.g + gi;
      const double v = divide ? acc[k] / fmax(sh.l[r], 1e-30) : acc[k];
      out[at * gm.d + dd] = (float)v;
    }
  }
}

__device__ inline Geometry block_geometry(int S, int Hk, int G, int D,
                                          int window) {
  Geometry gm;
  gm.b = blockIdx.x / Hk;
  gm.h = blockIdx.x - gm.b * Hk;
  gm.hk = Hk;
  gm.g = G;
  gm.d = D;
  gm.s = S;
  gm.row0 = blockIdx.y * kRows;
  gm.rows = min(kRows, S * G - gm.row0);
  gm.window = window;
  return gm;
}

// B4: exact softmax over the ring row of T entries, in three passes over
// the key tiles (row max; sum of exps; p = exp(s - m) / l times V).
__global__ void __launch_bounds__(kThreads)
ring_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kc,
            const uint8_t* __restrict__ vc, const __half* __restrict__ ks,
            const __half* __restrict__ vs, const int* __restrict__ kv_pos,
            const int* __restrict__ q_pos, float* __restrict__ out, int S,
            int Hk, int G, int D, int T, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = carve(smem, D);
  const Geometry gm = block_geometry(S, Hk, G, D, window);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_queries(q, q_pos, gm, sh);
  __syncthreads();
  double acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0;
  for (int pass = 0; pass < 3; ++pass) {
    for (int t0 = 0; t0 < T; t0 += kTile) {
      const int n = min(kTile, T - t0);
      load_keys(kv_pos, (long long)gm.b * T + t0, n, sh);
      __syncthreads();
      load_values(kc, ks, n, gm, sh);
      __syncthreads();
      tile_scores(n, true, gm, sh);
      __syncthreads();
      for (int r = warp; r < gm.rows; r += kWarps) {
        double* sr = sh.s + r * kTile;
        if (pass == 0) {
          double mt = kNegInf;
          for (int j = lane; j < n; j += 32) mt = fmax(mt, sr[j]);
          mt = warp_max(mt);
          if (lane == 0) sh.m[r] = fmax(sh.m[r], mt);
        } else if (pass == 1) {
          double sum = 0.0;
          for (int j = lane; j < n; j += 32) sum += exp(sr[j] - sh.m[r]);
          sum = warp_sum(sum);
          if (lane == 0) sh.l[r] += sum;
        } else {
          for (int j = lane; j < n; j += 32)
            sr[j] = exp(sr[j] - sh.m[r]) / sh.l[r];
        }
      }
      __syncthreads();
      if (pass == 2) {
        load_values(vc, vs, n, gm, sh);
        __syncthreads();
        tile_pv(acc, n, false, gm, sh);
        __syncthreads();
      }
    }
  }
  store_out(out, acc, false, gm, sh);
}

// B5: online softmax over the slot's pages, tile by tile within a page.
__global__ void __launch_bounds__(kThreads)
paged_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kc,
             const uint8_t* __restrict__ vc, const __half* __restrict__ ks,
             const __half* __restrict__ vs, const int* __restrict__ pool_pos,
             const int* __restrict__ table, const int* __restrict__ q_pos,
             float* __restrict__ out, int S, int Hk, int G, int D, int ps,
             int NP, int tile, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = carve(smem, D);
  const Geometry gm = block_geometry(S, Hk, G, D, window);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_queries(q, q_pos, gm, sh);
  double acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0;
  __syncthreads();
  for (int i = 0; i < NP; ++i) {
    const int pid = table[(long long)gm.b * NP + i];
    const bool mapped = pid >= 0;
    const long long page0 = (long long)(mapped ? pid : 0) * ps;
    for (int off = 0; off < ps; off += tile) {
      load_keys(pool_pos, page0 + off, tile, sh);
      __syncthreads();
      load_values(kc, ks, tile, gm, sh);
      __syncthreads();
      tile_scores(tile, mapped, gm, sh);
      __syncthreads();
      for (int r = warp; r < gm.rows; r += kWarps) {
        double* sr = sh.s + r * kTile;
        double mt = kNegInf;
        for (int j = lane; j < tile; j += 32) mt = fmax(mt, sr[j]);
        mt = warp_max(mt);
        const double m_old = sh.m[r];
        const double m_new = fmax(m_old, mt);
        double sum = 0.0;
        for (int j = lane; j < tile; j += 32) {
          const double p = exp(sr[j] - m_new);
          sr[j] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        __syncwarp();
        if (lane == 0) {
          const double alpha = exp(m_old - m_new);
          sh.alpha[r] = alpha;
          sh.l[r] = sh.l[r] * alpha + sum;
          sh.m[r] = m_new;
        }
      }
      __syncthreads();
      load_values(vc, vs, tile, gm, sh);
      __syncthreads();
      tile_pv(acc, tile, true, gm, sh);
      __syncthreads();
    }
  }
  store_out(out, acc, true, gm, sh);
}

// Allow the largest tile set (head_dim kMaxD) above the 48 KB default,
// once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxD));
  done = err == cudaSuccess;
  return err;
}

bool ring_ready = false, paged_ready = false;

bool bad_geometry(int B, int S, int Hk, int G, int D) {
  return B <= 0 || S <= 0 || Hk <= 0 || G <= 0 || D <= 0 || D % 2 ||
         D > kMaxD;
}

}  // namespace

// B4. q [B,S,Hk,G,D] fp32; k/v codes [B,T,Hk,D/2] uint8; k/v scales
// [B,T,Hk,1] fp16; kv_pos [B,T], q_pos [B,S] int32; out [B,S,Hk,G,D] fp32;
// all contiguous. window < 0: no sliding window. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int soniq_qkv_attn_decode(const void* q, const void* kc,
                                     const void* vc, const void* ks,
                                     const void* vs, const void* kv_pos,
                                     const void* q_pos, void* out, int B,
                                     int S, int Hk, int G, int D, int T,
                                     int window, void* stream) {
  if (bad_geometry(B, S, Hk, G, D) || T <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(ring_kernel, ring_ready);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hk, (S * G + kRows - 1) / kRows);
  ring_kernel<<<grid, kThreads, smem_bytes(D), (cudaStream_t)stream>>>(
      (const float*)q, (const uint8_t*)kc, (const uint8_t*)vc,
      (const __half*)ks, (const __half*)vs, (const int*)kv_pos,
      (const int*)q_pos, (float*)out, S, Hk, G, D, T, window);
  return (int)cudaGetLastError();
}

// B5. k/v codes [P,ps,Hk,D/2] uint8; k/v scales [P,ps,Hk,1] fp16; pool_pos
// [P,ps], page_table [B,NP] (< 0 = unmapped), q_pos [B,S] int32; tile
// divides ps and is at most 128. Otherwise as B4.
extern "C" int soniq_qkv_attn_decode_paged(
    const void* q, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* pool_pos, const void* table,
    const void* q_pos, void* out, int B, int S, int Hk, int G, int D, int P,
    int ps, int NP, int tile, int window, void* stream) {
  if (bad_geometry(B, S, Hk, G, D) || P <= 0 || ps <= 0 || NP <= 0 ||
      tile <= 0 || tile > kTile || ps % tile)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(paged_kernel, paged_ready);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hk, (S * G + kRows - 1) / kRows);
  paged_kernel<<<grid, kThreads, smem_bytes(D), (cudaStream_t)stream>>>(
      (const float*)q, (const uint8_t*)kc, (const uint8_t*)vc,
      (const __half*)ks, (const __half*)vs, (const int*)pool_pos,
      (const int*)table, (const int*)q_pos, (float*)out, S, Hk, G, D, ps, NP,
      tile, window);
  return (int)cudaGetLastError();
}
