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
// scale per entry and head), exact in fp32. Mask: causal by position,
// entries with pos < 0 dropped, optional sliding window (window < 0 =
// none), -1e30 fill; an all-masked row is the uniform average of V, as in
// the reference.
//
// One body, two address modes. A row walks n logical entries (n = T for
// the ring, NP * ps for the pool); entry e reads stream row b * T + e of
// the ring, or table[b, e / ps] * ps + e % ps of the pool (the null page
// 0, masked, where the id is < 0). Everything past that address is the
// same code, so the paged form of some content equals the ring form of it
// bitwise by construction.
//
// The order, fixed by n alone (so a row's result does not depend on B, S,
// the other rows of its block, the grid, the cluster, the SM count or the
// run):
// 1. Chunks. The n entries are cut into nc chunks of L entries (the last
//    one shorter): L = 32 * ceil(n / 2048), nc = ceil(n / L) <= 64
//    (split_entries in kernels/attn_decode.py, which passes L down).
// 2. A chunk is walked by one warp in tiles of 32 entries (lane j takes
//    entry j) with the online softmax in float64, from m = -1e30, l = 0,
//    acc = 0: s = (q . k) / sqrt(D) (four fma chains over the channels,
//    chain j taking channels 8w + 2j and 8w + 2j + 1 for w ascending, then
//    (c0 + c1) + (c2 + c3)), or -1e30 where masked; m2 = max(m, max_j s);
//    alpha = exp(m - m2); p = exp(s - m2); l = fma(l, alpha, the warp's
//    butterfly sum of p); acc = acc * alpha, then acc = fma(p_j, v_j, acc)
//    for j ascending.
// 3. The fold. The chunk states (m_c, l_c, acc_c) are folded left in chunk
//    order: M = max(M, m_c); a = exp(M_old - M); a' = exp(m_c - M); l =
//    fma(l, a, l_c * a'); acc = fma(acc, a, acc_c * a'); out = acc /
//    max(l, 1e-30), rounded once to fp32.
// Which warp of which block walks a chunk, and which rank folds an output,
// changes none of these bits: warps and ranks only share out the work.
//
// What bounds it on the H100: at decode the work is a few hundred
// thousand float64 FMAs and a few MB of codes (0.5 byte per K or V
// element), far below the card's line of operations per byte; a call is
// held by latency: the dependent loads of a page id, a position and the
// codes, and the chains of float64 FMAs. Tensor cores stay out: the port
// takes the attention sums in float64 (core/numerics.py), which keeps
// ring == paged and lockstep == continuous. The design:
// - Split over the cache. A (batch row, kv-head, 4-row tile) is one
//   thread-block cluster of up to 8 blocks of 4 warps; its chunks are
//   shared out over the warps (slot w, w + 4, ... of each rank's run of
//   consecutive chunks). When its chunk ends, a warp pushes the state into
//   the shared memory of the ranks that fold it (distributed shared
//   memory: m and l to every rank, acc to the rank that owns each output),
//   so no rank reads remotely; after one cluster barrier each rank folds
//   its outputs in chunk order. No atomics, no second kernel. (The start
//   barrier, which makes every rank resident before a remote write, is
//   split: arrive on entry, wait before a warp's first push.)
// - Work on entries. Lane j computes entry j's scores against every row of
//   the block (q as float64 in shared memory, read as broadcasts; the K
//   codes of the entry in registers; four partial chains a row, so the
//   chain is a quarter as long); lanes then take channels for p.V, reading
//   the tile's V codes from shared memory, 8 entries unrolled and every
//   channel slot computed without a branch, so their loads and FMAs
//   overlap (a branch a channel serialized them). The rows' max and sum
//   butterflies run side by side. Shared memory is sized for 4 rows (the
//   decode row count at G = 4; G = 1 runs a 1-row body); more rows (a
//   prefill chunk) tile over grid.y.
// - Bytes in flight. A warp fetches the next tile while it computes this
//   one: page ids two tiles ahead, positions, K codes (8- or 16-byte
//   loads) and scales one tile ahead, the V codes by cp.async into a
//   2-stage ring. Codes are unpacked from whole words by shifts; the
//   dequantized value is fma(u, s / 4, -7.5 * s / 4) with u made exact by
//   the 2^52 trick (no conversion, no division).
// - Work follows the mask, exactly. No dot is computed for an entry masked
//   in every row (its score is -1e30 in any case); p.V skips groups of 8
//   entries whose p is 0 in every row, and inside a group such an entry
//   adds exactly nothing (fma(0, v, acc) == acc, and acc is never -0: a
//   rescale by alpha = 0 stores +0). While a row's running max in a chunk
//   is still -1e30, its p.V is deferred: the first live entry rescales by
//   exp(-1e30 - m) = 0, and a chunk that stays masked folds in with a' = 0
//   unless the row is masked everywhere. A masked lane (q_pos < 0) is
//   masked everywhere, so it adds p = 1 from the start; any other row
//   masked everywhere (an empty cache, a window past every entry) takes a
//   second walk over V for those rows alone, with p = 1 and alpha = 1,
//   which computes exactly the deferred sums.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 32;              // entries of a warp's step, one a lane
constexpr int MAX_CHUNKS = 64;        // split_entries' bound
constexpr int MAX_D = 128;
constexpr int MAX_CLUSTER = 8;
// The launch shape; it changes no bit of the result.
constexpr int WARPS = 4;              // warps a block
constexpr int THREADS = WARPS * 32;
constexpr double NEG = -1e30;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* q;
  const uint8_t* kc;
  const uint8_t* vc;
  const __half* ks;
  const __half* vs;
  const int* pos;     // position stamps of the stream rows
  const int* table;   // [B, NP] page table (pool), or null (ring)
  const int* q_pos;   // [B, S]
  float* out;
  int S, Hk, G, D;
  int n;              // entries a row walks
  int T;              // ring length (ring)
  int ps, NP;         // page size, logical pages a slot (pool)
  int window;         // < 0: none
  int chunk, nchunks; // the split
  int ranks, slots;   // cluster size; chunk slots of a rank
  int per_out;        // outputs a rank folds
  int vec;            // bytes a code load moves: 16, 8 or 4
};

// Shared memory of a block; the same offsets in every rank.
struct Smem {
  double2* vq;     // [WARPS][TILE] (s / 4, -7.5 * s / 4) of each V entry
  uint8_t* vbuf;   // [WARPS][2][TILE][D/2] V codes, two stages
  double* p;       // [WARPS][TILE][NR] p of each entry and row
  double* qd;      // [NR][D] the block's query rows in float64
  double* mall;    // [NR][MAX_CHUNKS] chunk maxima (pushed by their warps)
  double* lall;    // [NR][MAX_CHUNKS] chunk sums of exps
  double* fa;      // [NR][MAX_CHUNKS] fold factors a (chunk 0: unused)
  double* fb;      // [NR][MAX_CHUNKS] fold factors a'
  double* g;       // [nchunks][per_out] chunk accumulators of my outputs
  int* qpos;       // [NR]
  int* flag;       // rows masked everywhere (bit r)
};

__host__ __device__ inline size_t smem_bytes(int nr, int d, int nchunks,
                                             int per_out) {
  return sizeof(double2) * WARPS * TILE + (size_t)WARPS * 2 * TILE * (d / 2) +
         sizeof(double) * ((size_t)WARPS * TILE * nr + (size_t)nr * d +
                           4 * (size_t)nr * MAX_CHUNKS +
                           (size_t)nchunks * per_out) +
         sizeof(int) * (nr + 1);
}

template <int NR>
__device__ inline Smem carve(unsigned char* base, const Params& P) {
  Smem s;
  s.vq = reinterpret_cast<double2*>(base);
  s.vbuf = reinterpret_cast<uint8_t*>(s.vq + WARPS * TILE);
  double* dp = reinterpret_cast<double*>(s.vbuf + WARPS * 2 * TILE * (P.D / 2));
  s.p = dp;
  dp += WARPS * TILE * NR;
  s.qd = dp;
  dp += NR * P.D;
  s.mall = dp;
  dp += NR * MAX_CHUNKS;
  s.lall = dp;
  dp += NR * MAX_CHUNKS;
  s.fa = dp;
  dp += NR * MAX_CHUNKS;
  s.fb = dp;
  dp += NR * MAX_CHUNKS;
  s.g = dp;
  dp += (size_t)P.nchunks * P.per_out;
  s.qpos = reinterpret_cast<int*>(dp);
  s.flag = s.qpos + NR;
  return s;
}

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The two halves of a cluster barrier (all threads of a warp together).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A 4-bit code as a double, exactly: the bits of 2^52 + u, minus 2^52.
__device__ __forceinline__ double code_value(unsigned u) {
  return __hiloint2double(0x43300000, static_cast<int>(u)) -
         4503599627370496.0;
}

// What a lane holds of one entry of a tile (W code words).
template <int W>
struct EntryT {
  int pos;                 // position stamp (-1 when not present)
  bool present, mapped;    // e < n; its page is mapped
  float kscale, vscale;
  uint32_t kw[W];          // the entry's K codes of head h
};

// NR rows a block; NCH = ceil(D / 32) channels a lane takes in p.V.
template <int NR, int NCH>
struct Walker {
  using Entry = EntryT<4 * NCH>;
  const Params& P;
  const Smem& sm;
  cg::cluster_group& cluster;
  int b, h, rank, warp, lane;
  int half, words, tpc, K;
  unsigned uniform;        // 0: the softmax walk; else the rows of the
                           // second walk (masked everywhere)
  uint8_t* vb;
  double* ps;
  double2* vq;
  int qp[NR];
  double m[NR], l[NR], acc[NR][NCH];

  __device__ Walker(const Params& P_, const Smem& sm_,
                    cg::cluster_group& cl, int b_, int h_, int rank_,
                    unsigned uniform_)
      : P(P_), sm(sm_), cluster(cl), b(b_), h(h_), rank(rank_),
        uniform(uniform_) {
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    half = P.D >> 1;
    words = half >> 2;
    tpc = P.chunk / TILE;
    vb = sm.vbuf + warp * 2 * TILE * half;
    ps = sm.p + warp * TILE * NR;
    vq = sm.vq + warp * TILE;
#pragma unroll
    for (int r = 0; r < NR; ++r) qp[r] = sm.qpos[r];
    // My chunks: slots warp, warp + WARPS, ... of this rank's run.
    int mine = 0;
    for (int s = warp; s < P.slots && rank * P.slots + s < P.nchunks;
         s += WARPS)
      ++mine;
    K = 0;
    if (mine) {
      const int last = chunk_of((mine - 1) * tpc);
      const int rem = min(P.chunk, P.n - last * P.chunk);
      K = (mine - 1) * tpc + (rem + TILE - 1) / TILE;
    }
    reset();
  }

  __device__ int chunk_of(int k) const {
    return rank * P.slots + warp + (k / tpc) * WARPS;
  }
  __device__ int entry0(int k) const {
    return chunk_of(k) * P.chunk + (k % tpc) * TILE;
  }

  __device__ void reset() {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      m[r] = NEG;
      l[r] = 0.0;
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[r][c] = 0.0;
    }
  }

  // The page id of this lane's entry of tile k (0 for the ring).
  __device__ int page_of(int k) const {
    if (P.table == nullptr || k >= K) return 0;
    const int e = entry0(k) + lane;
    if (e >= P.n) return 0;
    return __ldg(P.table + (long long)b * P.NP + e / P.ps);
  }

  // Start the loads of tile k into st and its V stage; commits one
  // cp.async group (empty past the last tile).
  __device__ void fetch(int k, int pid, Entry& st) {
    st.present = false;
    st.mapped = false;
    st.pos = -1;
    st.kscale = 0.f;
    st.vscale = 0.f;
    const int e = k < K ? entry0(k) + lane : P.n;
    if (e < P.n) {
      st.present = true;
      long long row;
      if (P.table != nullptr) {
        const int lp = e / P.ps;
        st.mapped = pid >= 0;
        row = (long long)(st.mapped ? pid : 0) * P.ps + (e - lp * P.ps);
      } else {
        st.mapped = true;
        row = (long long)b * P.T + e;
      }
      const long long hr = row * P.Hk + h;
      st.vscale = __half2float(P.vs[hr]);
      uint8_t* dst = vb + (k & 1) * TILE * half + lane * half;
      const uint8_t* src = P.vc + hr * half;
      if (P.vec == 16) {
        for (int o = 0; o < half; o += 16) cp_async<16>(dst + o, src + o);
      } else if (P.vec == 8) {
        for (int o = 0; o < half; o += 8) cp_async<8>(dst + o, src + o);
      } else {
        for (int o = 0; o < half; o += 4) cp_async<4>(dst + o, src + o);
      }
      if (!uniform) {
        st.pos = __ldg(P.pos + row);
        st.kscale = __half2float(P.ks[hr]);
        const uint8_t* kp = P.kc + hr * half;
        if (P.vec == 16) {
          const uint4* k4 = reinterpret_cast<const uint4*>(kp);
#pragma unroll
          for (int i = 0; i < NCH; ++i)
            if (4 * i < words) {
              const uint4 v = __ldg(k4 + i);
              st.kw[4 * i] = v.x;
              st.kw[4 * i + 1] = v.y;
              st.kw[4 * i + 2] = v.z;
              st.kw[4 * i + 3] = v.w;
            }
        } else if (P.vec == 8) {
          const uint2* k2 = reinterpret_cast<const uint2*>(kp);
#pragma unroll
          for (int i = 0; i < 2 * NCH; ++i)
            if (2 * i < words) {
              const uint2 v = __ldg(k2 + i);
              st.kw[2 * i] = v.x;
              st.kw[2 * i + 1] = v.y;
            }
        } else {
          const uint32_t* k1 = reinterpret_cast<const uint32_t*>(kp);
#pragma unroll
          for (int i = 0; i < 4 * NCH; ++i)
            if (i < words) st.kw[i] = __ldg(k1 + i);
        }
      }
    }
    cp_async_commit();
  }

  // The softmax step of tile k: p of each row for p.V and the rescale.
  __device__ void softmax(const Entry& st, double (&pv)[NR],
                          double (&alpha)[NR]) {
    bool live[NR];
    bool any = false;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      live[r] = st.mapped && st.pos >= 0 && qp[r] >= st.pos &&
                (P.window < 0 || (long long)qp[r] - st.pos < P.window);
      any = any || live[r];
    }
    // q . k as four fma chains (chain j takes channels 8w + 2j and
    // 8w + 2j + 1, w ascending), then (c0 + c1) + (c2 + c3).
    double dot[NR], part[NR][4];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[r][j] = 0.0;
    if (any) {
      const double ksc = 0.25 * (double)st.kscale, k0 = -7.5 * ksc;
#pragma unroll
      for (int w = 0; w < 4 * NCH; ++w) {
        if (w < words) {
          const uint32_t word = st.kw[w];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const double ka =
                fma(code_value((word >> (8 * j)) & 15u), ksc, k0);
            const double kb =
                fma(code_value((word >> (8 * j + 4)) & 15u), ksc, k0);
#pragma unroll
            for (int r = 0; r < NR; ++r) {
              const double2 qq = *reinterpret_cast<const double2*>(
                  sm.qd + r * P.D + w * 8 + 2 * j);
              part[r][j] = fma(qq.x, ka, part[r][j]);
              part[r][j] = fma(qq.y, kb, part[r][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r)
      dot[r] = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
    // The rows' reductions side by side, each a fixed xor butterfly: every
    // lane ends with the same bits (each step adds two equal partial sums,
    // in either order).
    const double inv = 1.0 / sqrt((double)P.D);
    double s[NR], top[NR], sum[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      s[r] = !st.present ? -INFINITY : (live[r] ? dot[r] * inv : NEG);
      top[r] = s[r];
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
#pragma unroll
      for (int r = 0; r < NR; ++r)
        top[r] = fmax(top[r], __shfl_xor_sync(FULL, top[r], o));
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const double m2 = fmax(m[r], top[r]);
      alpha[r] = m2 == m[r] ? 1.0 : exp(m[r] - m2);   // exp(0) = 1
      sum[r] = exp(s[r] - m2);
      // Deferred while the chunk is masked so far for this row, unless the
      // lane is masked (q_pos < 0: masked everywhere, so p = 1 on every
      // entry, exactly what the deferred walk would add).
      pv[r] = m2 == NEG && qp[r] >= 0 ? 0.0 : sum[r];
      m[r] = m2;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
#pragma unroll
      for (int r = 0; r < NR; ++r)
        sum[r] += __shfl_xor_sync(FULL, sum[r], o);
#pragma unroll
    for (int r = 0; r < NR; ++r) l[r] = fma(l[r], alpha[r], sum[r]);
  }

  __device__ void tile(int k, const Entry& st) {
    double pv[NR], alpha[NR];
    if (!uniform) {
      softmax(st, pv, alpha);
    } else {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        pv[r] = st.present && ((uniform >> r) & 1u) ? 1.0 : 0.0;
        alpha[r] = 1.0;
      }
    }
    bool anyp = false;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      ps[lane * NR + r] = pv[r];
      anyp = anyp || pv[r] != 0.0;
    }
    const double vsc = 0.25 * (double)st.vscale;
    vq[lane] = make_double2(vsc, -7.5 * vsc);
    const unsigned use = __ballot_sync(FULL, anyp);
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        acc[r][c] = alpha[r] == 0.0 ? 0.0 : acc[r][c] * alpha[r];
    // This tile's V codes (all groups but the next tile's are done).
    cp_async_wait<1>();
    __syncwarp();
    // Groups of 8 entries with a p != 0, unrolled so that their loads go
    // out together; an entry with p = 0 in a group adds exactly nothing.
    const uint8_t* vt = vb + (k & 1) * TILE * half;
#pragma unroll 1
    for (int j0 = 0; j0 < TILE; j0 += 8) {
      if (((use >> j0) & 0xffu) == 0u) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = j0 + jj;
        const double2 v2 = vq[j];
        double pj[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) pj[r] = ps[j * NR + r];
        const uint8_t* vr = vt + j * half;
        // Channels past D (lanes of the last slot) read channel D - 1 and
        // accumulate into slots that are never pushed: no branch.
        unsigned u[NCH];
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int ch = min(lane + 32 * c, P.D - 1);
          u[c] = (vr[ch >> 1] >> ((ch & 1) << 2)) & 15u;
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const double v = fma(code_value(u[c]), v2.x, v2.y);
#pragma unroll
          for (int r = 0; r < NR; ++r) acc[r][c] = fma(pj[r], v, acc[r][c]);
        }
      }
    }
    __syncwarp();
  }

  bool started = false;   // the cluster's start barrier passed

  __device__ void wait_started() {
    if (!uniform && !started && P.ranks > 1) cluster_wait();
    started = true;
  }

  __device__ double* at(double* p, int rk) const {
    return P.ranks > 1 ? cluster.map_shared_rank(p, rk) : p;
  }

  // The state of chunk c into the ranks that fold it.
  __device__ void push(int c) {
    wait_started();
    if (!uniform && lane < NR * P.ranks) {
      const int r = lane % NR, rk = lane / NR;
      double mv = m[0], lv = l[0];
#pragma unroll
      for (int i = 1; i < NR; ++i)
        if (r == i) {
          mv = m[i];
          lv = l[i];
        }
      *at(sm.mall + r * MAX_CHUNKS + c, rk) = mv;
      *at(sm.lall + r * MAX_CHUNKS + c, rk) = lv;
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (uniform && !((uniform >> r) & 1u)) continue;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int ch = lane + 32 * i;
        if (ch < P.D) {
          const int o = r * P.D + ch;
          const int rk = o / P.per_out;
          *at(sm.g + (long long)c * P.per_out + (o - rk * P.per_out), rk) =
              acc[r][i];
        }
      }
    }
  }

  __device__ void run() {
    if (K == 0) {
      wait_started();
      return;
    }
    Entry cur, nxt;
    int pid = page_of(0);
    fetch(0, pid, cur);
    pid = page_of(1);
    for (int k = 0; k < K; ++k) {
      const int pid2 = page_of(k + 2);
      fetch(k + 1, pid, nxt);
      pid = pid2;
      tile(k, cur);
      const int e0 = entry0(k);
      if (k % tpc == tpc - 1 || e0 + TILE >= P.n) {
        push(chunk_of(k));
        reset();
      }
      cur = nxt;
    }
    cp_async_wait<0>();
    wait_started();
  }
};

template <int NR, int NCH>
__global__ void __launch_bounds__(THREADS)
    attn_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = carve<NR>(smem, P);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % P.ranks;
  const int unit = blockIdx.x / P.ranks;
  const int b = unit / P.Hk, h = unit - b * P.Hk;
  const int row0 = blockIdx.y * NR;
  const int nrows = min(NR, P.S * P.G - row0);
  auto csync = [&]() {
    if (P.ranks > 1)
      cluster.sync();
    else
      __syncthreads();
  };

  // The block's query rows (row r = row0 + r of the s-major S*G list),
  // their positions; rows past S*G are masked lanes, neither folded nor
  // written.
  constexpr int QPT = (NR * MAX_D + THREADS - 1) / THREADS;
  double qv[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / P.D, d = idx - r * P.D;
    qv[i] = 0.0;
    if (idx < NR * P.D && r < nrows) {
      const int rr = row0 + r, si = rr / P.G, gi = rr - si * P.G;
      qv[i] = (double)P.q[((((long long)b * P.S + si) * P.Hk + h) * P.G +
                           gi) * P.D + d];
    }
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i)
    if (tid + i * THREADS < NR * P.D) sm.qd[tid + i * THREADS] = qv[i];
  if (tid < NR)
    sm.qpos[tid] = tid < nrows
                       ? P.q_pos[(long long)b * P.S + (row0 + tid) / P.G]
                       : -1;
  if (tid == 0) *sm.flag = 0;
  __syncthreads();
  // Every block of the cluster runs before any remote write: arrive now,
  // wait before a warp's first push (the loads of its first tiles go out
  // meanwhile).
  if (P.ranks > 1) cluster_arrive_relaxed();

  Walker<NR, NCH>(P, sm, cluster, b, h, rank, 0u).run();
  csync();

  // Fold factors of every (row, chunk) from the running maximum of the
  // chunk maxima (a max-scan over the chunks, exact in any order): a warp
  // a row, lane j holding chunks j and j + 32.
  const int nc = P.nchunks;
  for (int r = tid >> 5; r < NR; r += WARPS) {
    const int lane = tid & 31;
    const double* mr = sm.mall + r * MAX_CHUNKS;
    const double x0 = lane < nc ? mr[lane] : NEG;
    const double x1 = lane + 32 < nc ? mr[lane + 32] : NEG;
    double in0 = x0, in1 = x1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y0 = __shfl_up_sync(FULL, in0, o);
      const double y1 = __shfl_up_sync(FULL, in1, o);
      if (lane >= o) {
        in0 = fmax(in0, y0);
        in1 = fmax(in1, y1);
      }
    }
    const double half0 = __shfl_sync(FULL, in0, 31);
    in1 = fmax(in1, half0);
    double ex0 = __shfl_up_sync(FULL, in0, 1);
    double ex1 = __shfl_up_sync(FULL, in1, 1);
    if (lane == 0) ex1 = half0;
    if (lane > 0 && lane < nc) {
      sm.fa[r * MAX_CHUNKS + lane] = exp(ex0 - in0);
      sm.fb[r * MAX_CHUNKS + lane] = exp(x0 - in0);
    }
    if (lane + 32 < nc) {
      sm.fa[r * MAX_CHUNKS + lane + 32] = exp(ex1 - in1);
      sm.fb[r * MAX_CHUNKS + lane + 32] = exp(x1 - in1);
    }
    const double all = __shfl_sync(FULL, nc > 32 ? in1 : in0,
                                   nc > 32 ? nc - 33 : nc - 1);
    if (lane == 0 && r < nrows && all == NEG && sm.qpos[r] >= 0)
      atomicOr(sm.flag, 1 << r);
  }
  __syncthreads();
  const unsigned masked = (unsigned)*sm.flag;
  if (masked) {
    // Rows masked everywhere with q_pos >= 0: the deferred sums of V
    // (every rank sees the same maxima, so all take this branch).
    Walker<NR, NCH>(P, sm, cluster, b, h, rank, masked).run();
    csync();
  }

  // Fold this rank's outputs in chunk order.
  const int o0 = rank * P.per_out;
  for (int lo = tid; lo < P.per_out; lo += THREADS) {
    const int o = o0 + lo;
    if (o >= NR * P.D) break;
    const int r = o / P.D, d = o - r * P.D;
    if (r >= nrows) continue;
    const double* lr = sm.lall + r * MAX_CHUNKS;
    const double* ar = sm.fa + r * MAX_CHUNKS;
    const double* br = sm.fb + r * MAX_CHUNKS;
    double l = lr[0], acc = sm.g[lo];
#pragma unroll 8
    for (int c = 1; c < nc; ++c) {
      const double a = ar[c], a2 = br[c];
      l = fma(l, a, lr[c] * a2);
      acc = fma(acc, a, sm.g[(long long)c * P.per_out + lo] * a2);
    }
    const int rr = row0 + r, si = rr / P.G, gi = rr - si * P.G;
    P.out[((((long long)b * P.S + si) * P.Hk + h) * P.G + gi) * P.D + d] =
        (float)(acc / fmax(l, 1e-30));
  }
}

template <int NR, int NCH>
int launch_shape(Params& P, int B, cudaStream_t stream) {
  P.per_out = (NR * P.D + P.ranks - 1) / P.ranks;
  const size_t bytes = smem_bytes(NR, P.D, P.nchunks, P.per_out);
  static size_t sized = 48 * 1024;
  if (bytes > sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_kernel<NR, NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    sized = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * P.Hk * P.ranks, (P.S * P.G + NR - 1) / NR, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, attn_kernel<NR, NCH>, P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int NR>
int launch_nr(Params& P, int B, cudaStream_t stream) {
  switch ((P.D + 31) / 32) {
    case 1: return launch_shape<NR, 1>(P, B, stream);
    case 2: return launch_shape<NR, 2>(P, B, stream);
    case 3: return launch_shape<NR, 3>(P, B, stream);
    default: return launch_shape<NR, 4>(P, B, stream);
  }
}

// The launch shape from the split: a cluster of ranks (a power of two, at
// most 8) that gives each warp at most two chunks; G = 1 decode (one row a
// block) runs the 1-row body.
int launch(Params& P, int B, cudaStream_t stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(P.kc) |
                          reinterpret_cast<uintptr_t>(P.vc);
  const int half = P.D / 2;
  P.vec = half % 16 == 0 && align % 16 == 0   ? 16
          : half % 8 == 0 && align % 8 == 0 ? 8
          : align % 4 == 0                  ? 4
                                            : 0;
  if (P.vec == 0 || P.chunk <= 0 || P.chunk % TILE)
    return (int)cudaErrorInvalidValue;
  P.nchunks = (P.n + P.chunk - 1) / P.chunk;
  if (P.nchunks > MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  const int need = (P.nchunks + WARPS - 1) / WARPS;
  int r = 1;
  while (r < MAX_CLUSTER && r < need) r *= 2;
  P.ranks = r;
  P.slots = (P.nchunks + r - 1) / r;
  return P.S * P.G == 1 ? launch_nr<1>(P, B, stream)
                        : launch_nr<4>(P, B, stream);
}

bool bad_geometry(int B, int S, int Hk, int G, int D, int n) {
  return B <= 0 || S <= 0 || Hk <= 0 || G <= 0 || D < 8 || D % 8 ||
         D > MAX_D || n <= 0 || (long long)B * Hk * MAX_CLUSTER > INT32_MAX ||
         (long long)S * G / 4 >= 65535;
}

}  // namespace

// B4. q [B,S,Hk,G,D] fp32 (D a multiple of 8, at most 128); k/v codes
// [B,T,Hk,D/2] uint8; k/v scales [B,T,Hk,1] fp16; kv_pos [B,T], q_pos [B,S]
// int32; out [B,S,Hk,G,D] fp32; all contiguous. chunk: the split's chunk
// length (a multiple of 32, at most 64 chunks over T). window < 0: no
// sliding window. Returns the CUDA error code of the launch (0 on success).
extern "C" int soniq_qkv_attn_decode(const void* q, const void* kc,
                                     const void* vc, const void* ks,
                                     const void* vs, const void* kv_pos,
                                     const void* q_pos, void* out, int B,
                                     int S, int Hk, int G, int D, int T,
                                     int chunk, int window, void* stream) {
  if (bad_geometry(B, S, Hk, G, D, T)) return (int)cudaErrorInvalidValue;
  Params P = {};
  P.q = static_cast<const float*>(q);
  P.kc = static_cast<const uint8_t*>(kc);
  P.vc = static_cast<const uint8_t*>(vc);
  P.ks = static_cast<const __half*>(ks);
  P.vs = static_cast<const __half*>(vs);
  P.pos = static_cast<const int*>(kv_pos);
  P.table = nullptr;
  P.q_pos = static_cast<const int*>(q_pos);
  P.out = static_cast<float*>(out);
  P.S = S;
  P.Hk = Hk;
  P.G = G;
  P.D = D;
  P.n = T;
  P.T = T;
  P.window = window;
  P.chunk = chunk;
  return launch(P, B, static_cast<cudaStream_t>(stream));
}

// B5. k/v codes [P,ps,Hk,D/2] uint8; k/v scales [P,ps,Hk,1] fp16; pool_pos
// [P,ps], page_table [B,NP] (< 0 = unmapped), q_pos [B,S] int32; chunk
// the split of NP * ps entries. Otherwise as B4.
extern "C" int soniq_qkv_attn_decode_paged(
    const void* q, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* pool_pos, const void* table,
    const void* q_pos, void* out, int B, int S, int Hk, int G, int D,
    int npages, int ps, int NP, int chunk, int window, void* stream) {
  if (npages <= 0 || ps <= 0 || NP <= 0 || (long long)NP * ps > INT32_MAX ||
      bad_geometry(B, S, Hk, G, D, NP * ps))
    return (int)cudaErrorInvalidValue;
  Params P = {};
  P.q = static_cast<const float*>(q);
  P.kc = static_cast<const uint8_t*>(kc);
  P.vc = static_cast<const uint8_t*>(vc);
  P.ks = static_cast<const __half*>(ks);
  P.vs = static_cast<const __half*>(vs);
  P.pos = static_cast<const int*>(pool_pos);
  P.table = static_cast<const int*>(table);
  P.q_pos = static_cast<const int*>(q_pos);
  P.out = static_cast<float*>(out);
  P.S = S;
  P.Hk = Hk;
  P.G = G;
  P.D = D;
  P.n = NP * ps;
  P.ps = ps;
  P.NP = NP;
  P.window = window;
  P.chunk = chunk;
  return launch(P, B, static_cast<cudaStream_t>(stream));
}
