// Segment GEMM for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernels of src/repro/kernels/packed_matmul.py:
//   _fused_kernel            (fused_act_segment_matmul, driver scale),
//   _fused_selfscale_kernel  (fused_act_selfscale_matmul, in-kernel scale),
//   _kernel                  (packed_segment_matmul, plain), and
//   _grouped_kernel          (packed_segment_matmul_grouped, plain over a
//                             stacked expert bank).
// One kernel body covers p in {1, 2, 4}, x in bf16 or fp32, four prologue
// modes, up to three segments of one leaf in one launch, and E experts:
//   y[M, N] += sum over segments s, in [K4|K2|K1] order, of
//              xq[M, Kp_s] @ (unpack_dequant(wp_s[Kp_s*p_s/8, N]) * ws_s)
//   fused:  xq = round_through_x_dtype(snap_p(x / sx) * sx), sx the
//           driver's per-token scale;
//   self:   the same with sx the fp32 abs-max of the full row clamped at
//           1e-6 and divided by 1.875 (one segment spanning K);
//   plain:  xq = x (the second pass of the two-pass form, and the
//           unquantized-activation path);
//   snap:   xq = snap_p(x), x already in scale units (act_quant).
// The grouped form (B6) runs the same body with blockIdx.z over experts:
// x, the carriers, the scales and y advance by their own expert strides,
// and an optional rows[E] gives each expert's live rows (rows 0..rows[e]-1,
// the layout of the MoE dispatch buffer); an expert with no live row
// returns before loading anything, and rows past the count are neither
// read nor written.
//
// The order of accumulation (fixed by Kp, p and the group size alone):
// each segment's K is cut into slices of SLICE = 16 channels. A slice's
// partial sum is an ascending chain of fp32 fmaf(xq, w, acc) from 0; the
// segment's sum T is the left fold of its slice partials in ascending
// slice order from 0 (one __fadd_rn each); y = y + T, segment after
// segment. Nothing in that order depends on M, E, N, the grid, the
// cluster, the SM count or the mode, so a row's result does not depend on
// how many rows share the launch, expert e of the grouped form is bitwise
// the single-expert launch, the two-pass form (fake_quant, then plain) is
// bitwise the fused form, one launch over three segments is bitwise three
// launches, and every run gives the same bits. No atomics.
//
// What bounds it on the H100: at decode (M <= 16) the carrier bytes
// (~2.9 bits a weight at the default mix, 8 FMAs of work per byte at p = 4
// and M = 4) set the floor, but a call is held by instruction issue (about
// 8 a weight at M = 4: the unpack, then one FMA a live row) and by the
// latency of each round; at prefill widths fp32 FMA issue. Tensor cores
// stay out: TF32 or bf16 MMA would break the fp32 contract of the
// reference, and at M <= 16 the work is far below the card's line of
// operations per byte anyway. The design:
// - Split-K over the card. A block owns BN = 32 output columns and RT
//   (4, 8 or 16) rows. Its 256 threads are 8 column groups (4 columns, one
//   carrier word) x 32 slice lanes; each lane takes one slice a round, and
//   one thread per output folds the round's partials from shared memory.
//   Where the column tiles alone would leave three quarters of the SMs
//   idle (k_proj and v_proj at N = 640: 20 tiles), CL blocks (up to 8)
//   form a thread-block cluster over one tile and take consecutive runs of
//   slices: each rank gathers its outputs' partials from every rank's
//   shared memory (distributed shared memory, all threads reading at
//   once), then folds them locally in slice order. No workspace, no second
//   launch. Wider grids keep the split inside the block: there the
//   cluster's barriers and remote reads cost more than the rounds they
//   save.
// - Carriers at full width. Each round's carriers are copied with 16-byte
//   cp.async (cache-global) into a ring of NSTAGE = 3 shared-memory stages,
//   two rounds ahead; every carrier byte is read from device memory once
//   per call at M <= 16. A thread reads one 32-bit word (4 columns),
//   splits its 8/p channels with a shift and a mask, and turns each code
//   into fp32 with one byte permute into the mantissa of 2^22 and one
//   subtraction ((u - (2^p-1)/2) exactly), then one multiply by the group
//   factor 2^(2-p) * scale, which is the reference's ((2u - (2^p-1)) *
//   2^(1-p)) * scale rounded once: the same fp32 weight. The weight is then
//   applied to every live row.
// - Activations. Each round's rows x slices are loaded 8 channels at a
//   time (one 16-byte load in bf16) a round ahead into registers, then
//   run through the prologue once per block into fp32 shared memory.
// - Groups. The scale and its index are read once per group (the slice's
//   first scale a round ahead): with group 16 a slice is one group; any
//   other even group size is walked with a running group boundary (one
//   division per slice, none per weight).
// - Rows. Rows past the live count are staged as zeros and skipped in
//   chunks of 4 (no FMA past the last partial chunk). M > 16 runs row
//   tiles (4 rows by default) that reread the carriers from L2: at M = 32
//   eight 4-row tiles take half the time of two 16-row tiles, whose blocks
//   hold one to an SM.
//
// Numerics follow the reference element for element: IEEE divisions by
// sx (__fdiv_rn), round half to even (rintf), the 1.875 divide kept a
// true division (the counterpart of the optimization_barrier in the
// reference), the bf16 round trip through __float2bfloat16_rn, the grid
// steps powers of two, and no step that nvcc may contract.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int BN = 32;                      // output columns per block
constexpr int CG = BN / 4;                  // column groups (one word each)
constexpr int LANES = THREADS / CG;         // slice lanes per block
constexpr int SLICE = 16;                   // channels per K slice
constexpr int NSTAGE = 3;                   // carrier ring depth
constexpr int MAX_ROWS = SLICE / 2;         // carrier rows of a slice (p=4)
// Words of one lane's carriers in a stage, padded so the 4 lanes of a warp
// fall on disjoint banks.
constexpr int LANE_WORDS = MAX_ROWS * CG + 8;
constexpr int STAGE_WORDS = LANES * LANE_WORDS;
constexpr int MAX_SEG = 3;
// The launch shape; none of these changes a bit of the result.
// tools/kernel_ab.py --set NAME=VALUE times another value on a
// scratch build (PERF.md records the alternatives).
// The largest thread-block cluster of the split-K (1 keeps the split
// inside the block).
constexpr int MAX_CLUSTER = 8;
// Rounds of carriers in flight ahead of the one computing.
constexpr int PREFETCH = 2;
// The row tile of M > 16.
constexpr int WIDE_ROWS = 4;
static_assert(MAX_CLUSTER >= 1 && MAX_CLUSTER <= 8 &&
                  (MAX_CLUSTER & (MAX_CLUSTER - 1)) == 0,
              "a cluster of 1, 2, 4 or 8 blocks");
static_assert(PREFETCH >= 1 && PREFETCH < NSTAGE,
              "the ring holds the rounds in flight and the one computing");
static_assert(WIDE_ROWS == 4 || WIDE_ROWS == 8 || WIDE_ROWS == 16,
              "a row tile of 4, 8 or 16");

enum Mode { FUSED = 0, SELF = 1, PLAIN = 2, SNAP = 3 };

// One segment of the launch (expert 0's pointers; expert e adds e times
// the expert strides).
struct Seg {
  const uint8_t* wp;           // carriers [kp * p / 8, N]
  const float* ws;             // group scales [ceil(kp / group)] or null
  long long wp_es, ws_es;
  int p, lvpb;                 // precision, log2(8 / p)
  int k_off, kp;               // channels [k_off, k_off + kp) of x
  int first;                   // its first slice in the launch
  int pad;
};

struct Params {
  const void* x;
  long long ldx, x_es;
  const float* sx;
  float* y;
  long long y_es;
  const int* rows;
  int E, M, N, group, mode, x_bf16;
  int nseg, nslices, rounds, cluster, vec16, xvec;
  Seg seg[MAX_SEG];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float load_x(const Params& P, long long i) {
  return P.x_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(P.x)[i])
             : static_cast<const float*>(P.x)[i];
}

// Eight consecutive activations from element i (16-byte aligned: one
// 16-byte load in bf16, two in fp32), as fp32.
__device__ __forceinline__ void load_x8(const Params& P, long long i,
                                        float (&v)[8]) {
  if (P.x_bf16) {
    const uint4 u =
        *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(P.x) + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xFFFF0000u);
    }
  } else {
    const float4* f =
        reinterpret_cast<const float4*>(static_cast<const float*>(P.x) + i);
    const float4 a = f[0], b = f[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

// The activation prologue of one element at precision p (row scale s).
__device__ __forceinline__ float prologue(const Params& P, float v, float s,
                                          int p) {
  if (P.mode == PLAIN) return v;
  const float h = p == 4 ? 0.125f : (p == 2 ? 0.5f : 1.f);      // 2^(1-p)
  const float inv_h = p == 4 ? 8.f : (p == 2 ? 2.f : 1.f);      // 2^(p-1)
  const float top = p == 4 ? 15.f : (p == 2 ? 3.f : 1.f);       // 2^p - 1
  const float q = P.mode == SNAP ? v : __fdiv_rn(v, s);
  float u = rintf(__fmul_rn(__fadd_rn(__fmul_rn(q, inv_h), top), 0.5f));
  u = fminf(fmaxf(u, 0.f), top);
  const float g = __fmul_rn(__fsub_rn(__fmul_rn(2.f, u), top), h);
  if (P.mode == SNAP) return g;
  const float r = __fmul_rn(g, s);
  return P.x_bf16 ? __bfloat162float(__float2bfloat16_rn(r)) : r;
}

// One slice's partial sums for 4 columns x RT rows: the carrier words of
// the slice (one per carrier row, CG words apart), the slice's staged
// activations xl[SLICE][RT], nch <= SLICE channels starting at channel
// kbase of the segment, the segment's group scales ws (or null) and the
// scale of the slice's first group s0 (prefetched), and the number of
// live 4-row chunks.
template <int P, int RT, bool G16>
__device__ __forceinline__ void slice_fma(const uint32_t* cw, const float* xl,
                                          int nch, int kbase,
                                          const float* ws, float s0,
                                          int group, int mr4,
                                          float (&acc)[RT][4]) {
  constexpr int VPB = 8 / P;                          // codes per byte
  constexpr int ROWS = SLICE / VPB;
  constexpr uint32_t MASK2 = 0x01010101u * (((1u << P) - 1u) << 1);
  constexpr float H2 = P == 4 ? 0.25f : (P == 2 ? 1.f : 2.f);  // 2^(2-p)
  // 2^22 + (2^p - 1) / 2: the byte permute below makes 2^22 + u.
  constexpr float K0 = 4194304.f + 0.5f * (float)((1 << P) - 1);
  int gi = 0, nb = 0;
  if (!G16) {
    gi = kbase / group;
    nb = (gi + 1) * group;
  }
  float c2 = ws != nullptr ? __fmul_rn(s0, H2) : H2;
#pragma unroll
  for (int rw = 0; rw < ROWS; ++rw) {
    if (rw * VPB >= nch) break;
    const uint32_t word = cw[rw * CG];
#pragma unroll
    for (int ch = 0; ch < VPB; ++ch) {
      const int kk = rw * VPB + ch;
      if (!G16 && kbase + kk == nb) {
        ++gi;
        nb += group;
        c2 = ws != nullptr ? __fmul_rn(ws[gi], H2) : H2;
      }
      // Byte q of v holds column q's code of channel kk, shifted left by 1.
      const uint32_t v =
          (ch == 0 ? (word << 1) : (word >> (P * ch - 1))) & MASK2;
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = __fmul_rn(
            __fsub_rn(__uint_as_float(__byte_perm(v, 0x4A800000u,
                                                  0x7650u + q)),
                      K0),
            c2);
      const float* xk = xl + kk * RT;
#pragma unroll
      for (int g = 0; g < RT / 4; ++g) {
        if (g < mr4) {
          const float4 xv = *reinterpret_cast<const float4*>(xk + 4 * g);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[4 * g + 0][q] = fmaf(xv.x, w[q], acc[4 * g + 0][q]);
            acc[4 * g + 1][q] = fmaf(xv.y, w[q], acc[4 * g + 1][q]);
            acc[4 * g + 2][q] = fmaf(xv.z, w[q], acc[4 * g + 2][q]);
            acc[4 * g + 3][q] = fmaf(xv.w, w[q], acc[4 * g + 3][q]);
          }
        }
      }
    }
  }
}

template <int RT>
struct Layout {
  static constexpr int NB = RT == 4 ? 2 : 1;        // partial buffers
  static constexpr int XLANE = SLICE * RT + 4;      // a lane's activations
  static constexpr int XS = LANES * XLANE;          // (padded: few conflicts)
  static constexpr int PART = LANES * RT * BN;      // partials of a round
  static constexpr int OUTS = RT * BN;              // outputs of a block
  static constexpr int XT = RT / 4;                 // 8-channel x loads
  static constexpr size_t BYTES =
      (size_t)NSTAGE * STAGE_WORDS * 4 + (size_t)XS * 4 +
      (size_t)NB * PART * 4;
  // The gather buffer of a cluster: this rank's outputs x every slice of a
  // round, rows padded by one.
  static constexpr size_t GATHER = (size_t)(PART + OUTS) * 4;
};

template <int RT, bool G16>
__global__ void __launch_bounds__(THREADS)
segment_gemm_kernel(const Params P) {
  using L = Layout<RT>;
  constexpr int OUTS = L::OUTS;
  constexpr int OPT = (OUTS + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  float* xs = reinterpret_cast<float*>(ring + NSTAGE * STAGE_WORDS);
  float* part = xs + L::XS;
  float* gath = part + L::NB * L::PART;             // clusters only
  __shared__ Seg s_seg[MAX_SEG];
  __shared__ float s_row[RT];
  __shared__ int s_max[RT];

  const int tid = threadIdx.x;
  const int CL = P.cluster;
  const int rank = blockIdx.x % CL;
  const int n0 = (blockIdx.x / CL) * BN;
  const int m0 = blockIdx.y * RT;
  const long long e = blockIdx.z;
  int live = P.M;
  if (P.rows != nullptr) live = min(live, P.rows[e]);
  const int mr = min(RT, live - m0);
  // Every block of a cluster shares (e, m0), so all of them leave here.
  if (mr <= 0) return;
  const int mr4 = (mr + 3) >> 2;
  cg::cluster_group cluster = cg::this_cluster();
  const long long xrow = e * P.x_es + (long long)m0 * P.ldx;

  if (tid < MAX_SEG) s_seg[tid] = P.seg[tid];
  if (P.mode == SELF) {
    // Lanes of each row reduce max|x| over the full row (exact in any
    // order), then one IEEE divide by the 4-bit grid top.
    constexpr int LPR = THREADS / RT;
    constexpr int WL = LPR < 32 ? LPR : 32;
    if (tid < RT) s_max[tid] = 0;
    __syncthreads();
    const int r = tid / LPR;
    const int lane = tid % LPR;
    float m = 0.f;
    if (r < mr) {
      const long long row = xrow + (long long)r * P.ldx + P.seg[0].k_off;
      for (int k = lane; k < P.seg[0].kp; k += LPR)
        m = fmaxf(m, fabsf(load_x(P, row + k)));
    }
    for (int off = WL / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((lane & (WL - 1)) == 0) atomicMax(&s_max[r], __float_as_int(m));
    __syncthreads();
    if (tid < RT)
      s_row[tid] = __fdiv_rn(fmaxf(__int_as_float(s_max[tid]), 1e-6f),
                             1.875f);
  } else if (P.mode == FUSED && tid < RT) {
    s_row[tid] = tid < mr ? P.sx[m0 + tid] : 1.f;
  }
  __syncthreads();
  const int first1 = s_seg[1].first, first2 = s_seg[2].first;
  auto seg_of = [&](int j) { return (j >= first1) + (j >= first2); };

  // The outputs this thread folds: with no cluster, o = tid + i * THREADS;
  // in a cluster, each rank folds a run of OUTS / CL outputs.
  auto out_of = [&](int i) {
    if (CL == 1) return tid + i * THREADS;
    return (i == 0 && tid < OUTS / CL) ? rank * (OUTS / CL) + tid : OUTS;
  };
  float* y = P.y + e * P.y_es;
  float Y[OPT], T[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) {
    const int o = out_of(i);
    const int r = o / BN, n = n0 + o % BN;
    T[i] = 0.f;
    Y[i] = (o < OUTS && r < mr && n < P.N)
               ? y[(long long)(m0 + r) * P.N + n]
               : 0.f;
  }

  // Carriers of round rr (its lanes' slices, BN columns) into its stage.
  auto issue = [&](int rr) {
    if (rr >= P.rounds) return;
    uint32_t* st = ring + (rr % NSTAGE) * STAGE_WORDS;
    for (int id = tid; id < LANES * MAX_ROWS * 2; id += THREADS) {
      const int l = id / (MAX_ROWS * 2);
      const int row = (id / 2) % MAX_ROWS;
      const int q = id % 2;
      const int j = (rr * CL + rank) * LANES + l;
      if (j >= P.nslices) continue;
      const Seg& s = s_seg[seg_of(j)];
      const int k0 = (j - s.first) * SLICE;
      const int nrows = min(SLICE, s.kp - k0) >> s.lvpb;
      if (row >= nrows) continue;
      const int col = n0 + q * 16;
      const uint8_t* src =
          s.wp + e * s.wp_es +
          (long long)((k0 >> s.lvpb) + row) * P.N + col;
      uint32_t* dst = st + l * LANE_WORDS + row * CG + q * 4;
      if (P.vec16) {
        const int bytes = max(0, min(16, P.N - col));
        cp_async16(dst, bytes > 0 ? src : s.wp, bytes);
      } else {
        uint8_t* d = reinterpret_cast<uint8_t*>(dst);
        for (int b = 0; b < 16; ++b) d[b] = col + b < P.N ? src[b] : 0;
      }
    }
  };
  // Raw activations of round rr into registers, then their prologue into
  // the staging buffer. Task it of this thread: row r, 8 channels (half h)
  // of lane l's slice; neighbouring threads take neighbouring rows.
  float xr[L::XT][8];
  auto xtask = [&](int it, int rr, int& r, int& l, int& h, int& j) {
    const int t = tid + it * THREADS;
    r = t % RT;
    h = (t / RT) & 1;
    l = t / (2 * RT);
    j = (rr * CL + rank) * LANES + l;
  };
  auto xload = [&](int rr) {
#pragma unroll
    for (int it = 0; it < L::XT; ++it) {
      int r, l, h, j;
      xtask(it, rr, r, l, h, j);
#pragma unroll
      for (int q = 0; q < 8; ++q) xr[it][q] = 0.f;
      if (r >= mr || j >= P.nslices) continue;
      const Seg& s = s_seg[seg_of(j)];
      const int k = (j - s.first) * SLICE + h * 8;
      if (k >= s.kp) continue;
      const long long i = xrow + (long long)r * P.ldx + s.k_off + k;
      if (P.xvec) {
        load_x8(P, i, xr[it]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (k + q < s.kp) xr[it][q] = load_x(P, i + q);
      }
    }
  };
  auto xstore = [&](int rr) {
#pragma unroll
    for (int it = 0; it < L::XT; ++it) {
      int r, l, h, j;
      xtask(it, rr, r, l, h, j);
      float* dst = xs + l * L::XLANE + h * 8 * RT + r;
      const bool on = r < mr && j < P.nslices;
      const int p = on ? s_seg[seg_of(j)].p : 4;
      const float sr = s_row[r];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        dst[q * RT] = on ? prologue(P, xr[it][q], sr, p) : 0.f;
    }
  };

  const int c = tid % CG;
  const int lane = tid / CG;
  // The scale of the first group of this thread's slice in round rr,
  // loaded a round ahead.
  auto scale_of = [&](int rr) {
    const int j = (rr * CL + rank) * LANES + lane;
    if (rr >= P.rounds || j >= P.nslices) return 0.f;
    const Seg& s = s_seg[seg_of(j)];
    if (s.ws == nullptr) return 0.f;
    const int kbase = (j - s.first) * SLICE;
    return s.ws[e * s.ws_es + (G16 ? kbase >> 4 : kbase / P.group)];
  };
  auto compute = [&](int rr, float s0) {
    const int j = (rr * CL + rank) * LANES + lane;
    if (j >= P.nslices) return;
    const Seg& s = s_seg[seg_of(j)];
    const int kbase = (j - s.first) * SLICE;
    const int nch = min(SLICE, s.kp - kbase);
    const uint32_t* cw =
        ring + (rr % NSTAGE) * STAGE_WORDS + lane * LANE_WORDS + c;
    const float* xl = xs + lane * L::XLANE;
    const float* ws = s.ws != nullptr ? s.ws + e * s.ws_es : nullptr;
    float acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    switch (s.p) {
      case 4:
        slice_fma<4, RT, G16>(cw, xl, nch, kbase, ws, s0, P.group, mr4,
                              acc);
        break;
      case 2:
        slice_fma<2, RT, G16>(cw, xl, nch, kbase, ws, s0, P.group, mr4,
                              acc);
        break;
      default:
        slice_fma<1, RT, G16>(cw, xl, nch, kbase, ws, s0, P.group, mr4,
                              acc);
        break;
    }
    float* dst = part + (rr % L::NB) * L::PART + lane * RT * BN + 4 * c;
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if ((r >> 2) < mr4)
        *reinterpret_cast<float4*>(dst + r * BN) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  };
  // Fold the partials of slices j0, j0 + 1, ... (stride apart from src)
  // into output i's running sum in ascending slice order; a segment's first
  // slice first adds the previous segment's sum into y.
  auto fold = [&](int i, const float* src, int stride, int j0, int nj) {
#pragma unroll 8
    for (int t = 0; t < nj; ++t) {
      const int j = j0 + t;
      if (j == first1 || j == first2) {
        Y[i] = __fadd_rn(Y[i], T[i]);
        T[i] = 0.f;
      }
      T[i] = __fadd_rn(T[i], src[t * stride]);
    }
  };
  auto combine = [&](int rr) {
    const float* mine = part + (rr % L::NB) * L::PART;
    const int j0 = rr * CL * LANES;
    if (CL == 1) {
      const int nj = min(LANES, P.nslices - j0);
#pragma unroll
      for (int i = 0; i < OPT; ++i) {
        const int o = out_of(i);
        const int r = o / BN, n = o % BN;
        if (o < OUTS && r < mr && n0 + n < P.N)
          fold(i, mine + r * BN + n, RT * BN, j0, nj);
      }
      return;
    }
    // A cluster: gather this rank's outputs' partials from every rank with
    // all threads (the remote reads overlap), then fold them locally.
    const int nj = min(CL * LANES, P.nslices - j0);
    const int gs = CL * LANES + 1;
    const int per = OUTS / CL;
    for (int id = tid; id < per * CL * LANES; id += THREADS) {
      const int qo = id % per;
      const int t = id / per;
      const int o = rank * per + qo;
      const int r = o / BN, n = o % BN;
      if (t < nj && r < mr) {
        const float* src = cluster.map_shared_rank(
            const_cast<float*>(mine) + ((t % LANES) * RT + r) * BN + n,
            t / LANES);
        gath[qo * gs + t] = *src;
      }
    }
    __syncthreads();
    const int o = out_of(0);
    const int r = o / BN, n = o % BN;
    if (o < OUTS && r < mr && n0 + n < P.N)
      fold(0, gath + tid * gs, 1, j0, nj);
  };
  auto csync = [&]() {
    if (CL > 1)
      cluster.sync();
    else
      __syncthreads();
  };

#pragma unroll
  for (int rr = 0; rr < PREFETCH; ++rr) {
    issue(rr);
    cp_async_commit();
  }
  xload(0);
  float s_cur = scale_of(0);
  for (int rr = 0; rr < P.rounds; ++rr) {
    issue(rr + PREFETCH);
    cp_async_commit();
    xstore(rr);
    if (rr + 1 < P.rounds) xload(rr + 1);
    const float s_next = scale_of(rr + 1);
    // Round rr's copies are done once at most PREFETCH groups are pending.
    cp_async_wait<PREFETCH>();
    __syncthreads();
    compute(rr, s_cur);
    s_cur = s_next;
    csync();
    combine(rr);
    if (L::NB == 1 && rr + 1 < P.rounds) csync();
  }
  // No block of the cluster leaves while another may still read its
  // partials.
  if (CL > 1) cluster.sync();
#pragma unroll
  for (int i = 0; i < OPT; ++i) {
    const int o = out_of(i);
    const int r = o / BN, n = n0 + o % BN;
    if (o < OUTS && r < mr && n < P.N)
      y[(long long)(m0 + r) * P.N + n] = __fadd_rn(Y[i], T[i]);
  }
}

template <int RT, bool G16>
int launch_rt(const Params& p, int tiles, cudaStream_t stream) {
  static bool sized = false;
  const size_t most = Layout<RT>::BYTES + Layout<RT>::GATHER;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_gemm_kernel<RT, G16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.cluster, (p.M + RT - 1) / RT, p.E);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = p.cluster > 1 ? most : Layout<RT>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, segment_gemm_kernel<RT, G16>, p);
}

template <int RT>
int launch_g(const Params& p, int tiles, cudaStream_t stream) {
  return p.group == 16 ? launch_rt<RT, true>(p, tiles, stream)
                       : launch_rt<RT, false>(p, tiles, stream);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

}  // namespace

// One segment of a launch as the caller passes it, and the launch's
// segments, passed by value.
struct SegmentArg {
  const void* wp;        // carriers of expert 0
  long long wp_es;       // their expert stride
  const void* ws;        // group scales of expert 0, or null
  long long ws_es;       // their expert stride
  int p, k_off, kp, pad;
};
struct SegmentArgs {
  SegmentArg s[MAX_SEG];
};

// y (fp32) += the segment GEMMs of nseg (1..3) segments of one leaf, in
// order, for each of E experts (E = 1: a dense leaf). Expert e reads
// x + e*x_es: [M, K] with row stride ldx elements and unit column stride,
// bf16 if x_bf16 else fp32. seg.s[0..nseg) are the segments in [K4|K2|K1]
// order: expert e multiplies channels [k_off, k_off + kp) of x by wp +
// e * wp_es: [kp*p/8, N] uint8, contiguous, with the group scales ws +
// e * ws_es: [ceil(kp/group)] fp32 (or none). It adds into y + e*y_es: [M, N] fp32,
// contiguous. rows: null, or int32 [E] device counts of each expert's live
// rows (rows 0..rows[e]-1; the others are not touched). mode: 0 fused (sx:
// [M] fp32, one per row, shared by the experts), 1 self-scale (one
// segment spanning K), 2 plain, 3 plain with the snap to the p-bit grid.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int soniq_segment_gemm(const void* x, long long ldx,
                                  long long x_es, int x_bf16, const void* sx,
                                  int nseg, SegmentArgs seg, void* y,
                                  long long y_es, const void* rows, int E,
                                  int M, int N, int group, int mode,
                                  void* stream) {
  if (E <= 0 || E > 65535 || M <= 0 || N <= 0 || group <= 0 || nseg <= 0 ||
      nseg > MAX_SEG || mode < FUSED || mode > SNAP)
    return (int)cudaErrorInvalidValue;
  if (mode == FUSED && sx == nullptr) return (int)cudaErrorInvalidValue;
  if (mode == SELF && nseg != 1) return (int)cudaErrorInvalidValue;
  Params P = {};
  P.x = x;
  P.ldx = ldx;
  P.x_es = x_es;
  P.sx = static_cast<const float*>(sx);
  P.y = static_cast<float*>(y);
  P.y_es = y_es;
  P.rows = static_cast<const int*>(rows);
  P.E = E;
  P.M = M;
  P.N = N;
  P.group = group;
  P.mode = mode;
  P.x_bf16 = x_bf16;
  P.nseg = nseg;
  bool aligned = N % 16 == 0;
  // Activations load as 16-byte vectors of 8 when every 8-channel chunk of
  // every segment starts 16-byte aligned.
  const int xb = x_bf16 ? 2 : 4;
  bool xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
              (ldx * xb) % 16 == 0 && (x_es * xb) % 16 == 0;
  int slices = 0;
  for (int s = 0; s < MAX_SEG; ++s) {
    Seg& g = P.seg[s];
    if (s >= nseg) {
      g.first = INT_MAX;
      continue;
    }
    const SegmentArg& v = seg.s[s];
    const int p = v.p, k_off = v.k_off, kp = v.kp;
    if ((p != 1 && p != 2 && p != 4) || kp <= 0 || kp % (8 / p) ||
        k_off < 0)
      return (int)cudaErrorInvalidValue;
    g.wp = static_cast<const uint8_t*>(v.wp);
    g.wp_es = v.wp_es;
    g.ws = static_cast<const float*>(v.ws);
    g.ws_es = v.ws_es;
    g.p = p;
    g.lvpb = p == 4 ? 1 : (p == 2 ? 2 : 3);
    g.k_off = k_off;
    g.kp = kp;
    g.first = slices;
    slices += (kp + SLICE - 1) / SLICE;
    aligned = aligned && reinterpret_cast<uintptr_t>(v.wp) % 16 == 0 &&
              v.wp_es % 16 == 0;
    xvec = xvec && k_off % 8 == 0 && kp % 8 == 0;
  }
  P.nslices = slices;
  P.vec16 = aligned;
  P.xvec = xvec;
  const int rt = M <= 4 ? 4 : (M <= 8 ? 8 : (M <= 16 ? 16 : WIDE_ROWS));
  const int tiles = (N + BN - 1) / BN;
  // The split-K cluster, only where the tiles alone would leave three
  // quarters of the SMs idle (k_proj and v_proj at decode): there a cluster
  // takes the rounds of slices down to one or two. Elsewhere the
  // cluster's barriers and remote reads cost more than the rounds they
  // save (tools/kernel_ab.py, PERF.md).
  const long long base =
      (long long)tiles * ((M + rt - 1) / rt) * (long long)E;
  const int need = (slices + LANES - 1) / LANES;
  int cl = 1;
  if (base * 4 <= sm_count())
    while (cl < MAX_CLUSTER && cl < need) cl *= 2;
  P.cluster = cl;
  P.rounds = (slices + cl * LANES - 1) / (cl * LANES);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int code;
  if (rt == 4)
    code = launch_g<4>(P, tiles, st);
  else if (rt == 8)
    code = launch_g<8>(P, tiles, st);
  else
    code = launch_g<16>(P, tiles, st);
  if (code) return code;
  return (int)cudaGetLastError();
}
