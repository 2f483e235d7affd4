// SMOL quantize + bit-pack for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel src/repro/kernels/quant_pack.py::_kernel
// (quantize_pack): w[K, N] of any float type, cast to fp32 in the kernel
// (here fp32 or bf16: the two parameter types of the models), optionally
// divided by per-group scales,
// rounds to p-bit SMOL codes clip(rint((w/h + 2^p - 1) / 2), 0, 2^p - 1)
// and packs 8/p codes per byte along K, little-endian (code j of a byte at
// bit p*j): out[K*p/8, N] uint8. Bit-exact with the reference.
//
// One launch packs a whole linear, or an [S, K, N] stack of S slices (an
// expert bank), into its three segments at once, composed with the gather
// the packing driver needs first: segment p's byte (s, r, n) packs the
// VPB = 8/p source rows perm[s, off_p + r*VPB + j] of slice s, each divided
// by the scale of its sorted group, (off_p + r*VPB + j) / G. With no perm
// and one segment it is the TPU kernel exactly.
//
// What bounds it on the H100: the fp32 read stream (4 bytes of weight
// for every p/8 byte written) nearly — the launch runs at ~70% of that
// byte bound at full width — and the per-element work, the IEEE division
// by the group scale above all. A bf16 weight is read as it is stored and
// widened in registers (exact: its bits are the high half of the fp32
// word), so its launch reads half the bytes and gives carriers bitwise
// those of the fp32 launch on the widened weight. Measured at
// jamba-1.5-large-398b's widths on an H100, a bf16 launch takes the fp32
// launch's time, so there the per-element work, not the read stream,
// bounds it (8 columns a thread with 16-byte bf16 loads was slower). The
// design keeps the read stream wide and every index cheap:
//  - a block covers 32 source rows x 128 columns of one segment of one
//    slice (grid x: column tiles; y: the row tiles of the three segments
//    end to end, so p is uniform in a block; z: slices). Each thread takes
//    8 source rows x 4 adjacent columns: 8 independent 16-byte (fp32) or
//    8-byte (bf16) loads in flight, whatever p, then one 4-byte store per
//    byte row (p of them);
//  - the row index perm[.] and the group scale are loaded once per source
//    row and are warp-uniform (a warp spans columns), so each is one
//    broadcast; the rows are read in place, with no sorted copy;
//  - index math is 32-bit inside a slice, with one 64-bit slice offset a
//    block and no per-element division or modulo.
// A scalar body covers N % 4 != 0, weights whose rows of 4 columns are not
// aligned to their load (a slice stride is a multiple of it only when
// N % 4 == 0) and carriers that are not 4-byte aligned.
//
// Numerics: the division by the group scale is an IEEE division
// (__fdiv_rn; a reciprocal multiply is one ulp off), rounding is half to
// even (rintf), and w/h is an exact multiply by the power of two 2^(p-1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;                 // threads along N
constexpr int TY = 4;                  // threads along K
constexpr int THREADS = TX * TY;
constexpr int COLS = 4;                // adjacent columns a thread
constexpr int ROWS = 8;                // source rows a thread
constexpr int TILE_COLS = TX * COLS;   // 128 columns a block
constexpr int TILE_ROWS = TY * ROWS;   // 32 source rows a block

// A bf16 value is its 16 bits; widened to fp32 by a shift.
using bf16_bits = uint16_t;

struct Args {
  const void* w;         // float or bf16_bits
  long long w_slice;     // elements between slices
  int w_row;             // elements between rows
  const int* perm;       // [S, K] or null (identity)
  const float* scales;   // [S, NG] in sorted order, or null
  uint8_t* out[3];       // [S, rows_p * p / 8, N] each
  int rows[3];           // source rows of each segment (K4, K2, K1)
  int tiles[3];          // row tiles of each segment
  int K, N, NG, G;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_bits v) {
  return __uint_as_float((unsigned int)v << 16);
}

// Four adjacent columns: one 16-byte (fp32) or 8-byte (bf16) load.
__device__ __forceinline__ float4 load4_vec(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4_vec(const bf16_bits* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

template <bool VEC, typename T>
__device__ __forceinline__ float4 load4(const T* p, int left) {
  if (VEC) return load4_vec(p);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (left > 0) v.x = widen(__ldg(p));
  if (left > 1) v.y = widen(__ldg(p + 1));
  if (left > 2) v.z = widen(__ldg(p + 2));
  if (left > 3) v.w = widen(__ldg(p + 3));
  return v;
}

template <int P>
__device__ __forceinline__ unsigned int code(float v, bool scaled,
                                             float sc) {
  constexpr float INV_H = (float)(1 << (P - 1));
  constexpr float TOP = (float)((1 << P) - 1);
  if (scaled) v = __fdiv_rn(v, sc);
  float u = rintf((v * INV_H + TOP) * 0.5f);
  return (unsigned int)fminf(fmaxf(u, 0.f), TOP);
}

// Segment `seg` (precision P, first sorted row `off`), row tile `tile`, of
// slice `s`.
template <int P, bool VEC, typename T>
__device__ __forceinline__ void pack_tile(const Args& a, int seg, int off,
                                          int tile, int s) {
  constexpr int VPB = 8 / P;
  constexpr int BYTES = ROWS / VPB;    // byte rows a thread
  const int r0 = tile * TILE_ROWS + threadIdx.y * ROWS;
  const int kp = a.rows[seg];
  const int n0 = (blockIdx.x * TX + threadIdx.x) * COLS;
  if (r0 >= kp || n0 >= a.N) return;
  // Segments are whole groups, so a thread's rows are all inside one
  // unless the layer is narrower than a group (then whole bytes are).
  const int nrows = min(ROWS, kp - r0);
  const T* w = static_cast<const T*>(a.w) + (long long)s * a.w_slice;
  const int* perm = a.perm == nullptr ? nullptr
                                      : a.perm + (long long)s * a.K;
  const float* scales = a.scales == nullptr ? nullptr
                                            : a.scales + (long long)s * a.NG;
  const int left = a.N - n0;
  const bool scaled = scales != nullptr;
  float4 v[ROWS];
  float sc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (i < nrows) {
      const int k = off + r0 + i;
      const int src = perm == nullptr ? k : __ldg(perm + k);
      sc[i] = scaled ? __ldg(scales + k / a.G) : 1.f;
      v[i] = load4<VEC>(w + src * a.w_row + n0, left);
    }
  }
  uint8_t* out = a.out[seg] + (long long)s * (kp / VPB) * a.N;
#pragma unroll
  for (int b = 0; b < BYTES; ++b) {
    if (b * VPB >= nrows) break;
    unsigned int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
    for (int j = 0; j < VPB; ++j) {
      const int i = b * VPB + j;
      c0 |= code<P>(v[i].x, scaled, sc[i]) << (P * j);
      c1 |= code<P>(v[i].y, scaled, sc[i]) << (P * j);
      c2 |= code<P>(v[i].z, scaled, sc[i]) << (P * j);
      c3 |= code<P>(v[i].w, scaled, sc[i]) << (P * j);
    }
    uint8_t* o = out + (r0 / VPB + b) * a.N + n0;
    if (VEC) {
      *reinterpret_cast<unsigned int*>(o) =
          c0 | (c1 << 8) | (c2 << 16) | (c3 << 24);
    } else {
      o[0] = (uint8_t)c0;
      if (left > 1) o[1] = (uint8_t)c1;
      if (left > 2) o[2] = (uint8_t)c2;
      if (left > 3) o[3] = (uint8_t)c3;
    }
  }
}

template <bool VEC, typename T>
__global__ void __launch_bounds__(THREADS)
quant_pack_segments_kernel(const Args a) {
  int t = blockIdx.y;
  const int s = blockIdx.z;
  if (t < a.tiles[0]) {
    pack_tile<4, VEC, T>(a, 0, 0, t, s);
    return;
  }
  t -= a.tiles[0];
  if (t < a.tiles[1]) {
    pack_tile<2, VEC, T>(a, 1, a.rows[0], t, s);
    return;
  }
  pack_tile<1, VEC, T>(a, 2, a.rows[0] + a.rows[1], t - a.tiles[1], s);
}

template <typename T>
int launch(const void* w, long long w_slice, int w_row, const void* perm,
           const void* scales, void* out4, void* out2, void* out1, int k4,
           int k2, int k1, int N, int S, int G, void* stream) {
  const int K = k4 + k2 + k1;
  if (K <= 0 || N <= 0 || S <= 0 || G <= 0 || k4 < 0 || k2 < 0 || k1 < 0 ||
      k4 % 2 || k2 % 4 || k1 % 8 || w_row < N || S > 65535 ||
      (long long)K * w_row >= (1LL << 31) ||
      (long long)K * N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.w = w;
  a.w_slice = w_slice;
  a.w_row = w_row;
  a.perm = static_cast<const int*>(perm);
  a.scales = static_cast<const float*>(scales);
  a.out[0] = static_cast<uint8_t*>(out4);
  a.out[1] = static_cast<uint8_t*>(out2);
  a.out[2] = static_cast<uint8_t*>(out1);
  a.rows[0] = k4;
  a.rows[1] = k2;
  a.rows[2] = k1;
  long long tiles = 0;
  for (int i = 0; i < 3; ++i) {
    a.tiles[i] = (a.rows[i] + TILE_ROWS - 1) / TILE_ROWS;
    tiles += a.tiles[i];
  }
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  a.K = K;
  a.N = N;
  a.G = G;
  a.NG = (K + G - 1) / G;
  // Vector loads of 4 columns need w aligned to 4 * sizeof(T); 4-byte
  // stores, each carrier 4-byte aligned.
  const bool vec = N % 4 == 0 && w_row % 4 == 0 && w_slice % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % (4 * sizeof(T)) == 0 &&
                   (reinterpret_cast<uintptr_t>(out4) |
                    reinterpret_cast<uintptr_t>(out2) |
                    reinterpret_cast<uintptr_t>(out1)) % 4 == 0;
  const dim3 grid((N + TILE_COLS - 1) / TILE_COLS, (unsigned int)tiles, S);
  const dim3 block(TX, TY);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    quant_pack_segments_kernel<true, T><<<grid, block, 0, st>>>(a);
  else
    quant_pack_segments_kernel<false, T><<<grid, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Packs S slices of w (slice s at w + s * w_slice, row k at + k * w_row,
// N contiguous columns) into out4 [S, K4/2, N], out2 [S, K2/4, N] and out1
// [S, K1/8, N] (contiguous uint8; a null pointer for an empty segment),
// reading sorted row k of slice s from perm[s * K + k] (perm null: row k)
// and dividing by scales[s * (K / G) + k / G] (scales null: no division).
// K = K4 + K2 + K1; each segment a multiple of its 8/p. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int soniq_quant_pack_segments(
    const void* w, long long w_slice, int w_row, const void* perm,
    const void* scales, void* out4, void* out2, void* out1, int k4, int k2,
    int k1, int N, int S, int G, void* stream) {
  return launch<float>(w, w_slice, w_row, perm, scales, out4, out2, out1, k4,
                       k2, k1, N, S, G, stream);
}

// The same on a bf16 weight (strides in elements), widened to fp32 in the
// kernel: carriers bitwise those of the fp32 entry on the widened weight.
extern "C" int soniq_quant_pack_segments_bf16(
    const void* w, long long w_slice, int w_row, const void* perm,
    const void* scales, void* out4, void* out2, void* out1, int k4, int k2,
    int k1, int N, int S, int G, void* stream) {
  return launch<bf16_bits>(w, w_slice, w_row, perm, scales, out4, out2, out1,
                           k4, k2, k1, N, S, G, stream);
}
