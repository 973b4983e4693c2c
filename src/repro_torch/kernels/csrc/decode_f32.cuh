// Decode / SD-verify attention in full fp32 on the CUDA cores of an H100:
// the fp32 body of kernel 4 (decode_attention.cu, a contiguous cache read
// through strides) and of kernel 3 (paged_decode_attention.cu, K/V pages
// through a block table) at head dims 32, 64, 128 and 256.  It computes what
// the Pallas TPU kernels _decode_kernel and _paged_decode_kernel of
// src/repro/kernels/decode_attention/decode_attention.py compute:
//
//   out[b, t, h*g + i] = softmax_k( cap(q . K[b, k, h] * scale)
//                                   | k <= lengths[b] + t, k < limit ) . V[b, :, h]
//
// with K[b, k] the cache row k (dense) or k_pages[table[b, k / ps], k % ps]
// (paged); the partial entry of kernel 4 (keys at k_off.., lse) too.
//
// What bounds it: at long context the bytes of K and V (fp32: a gemma3-12b
// SD verify, 16 / 8 heads of 256 at 1100-1640 keys, reads 180 MB, 0.054 ms
// at 3.35 TB/s) and, as the rows grow, the products in fp32 FMAs (no TF32:
// the parity checks hold it to 3e-5 and 2e-5), 4 D FLOPs per visible
// (query row, key) at 67 TFLOP/s: the target's SD verify at 8k keys, 35
// rows of 128 a KV head, reads 265 MB (0.079 ms) and does 4.6 GFLOP (0.069
// ms).  So the keys have to be spread over every SM with loads in flight,
// and the FMA units kept busy on rows that sit in registers.
//
// What the design does about it:
//   * Split-KV and row tiles as the TMA + wgmma bodies (splitkv_sm90.cuh):
//     the grid is (splits * n_tiles, Hkv, B), the split plan the paged
//     body's (paged90::plan, its scratch too) or, dense, splitkv::plan over
//     the B * Hkv * n_tiles tiles with splits of at least MIN_CHUNKS_DENSE
//     chunks (a row's FMAs weigh more than on the tensor cores, so a short
//     one splits too) for MIN_BLOCKS blocks an SM, so the 8k cases fill the
//     SMs; each live split writes fp32 partials (O, m, l in log2 units) to
//     scratch and combine_kernel<D, float> merges them (and writes the
//     partial entry's lse), unless split 0 held every live key of a tile.
//     Row tiles hold at most TILE_ROWS = 32 rows (a tile's rows are what
//     its warps keep busy: below).
//   * K and V arrive in chunks of Cfg::BN = 32 keys by cp.async into a ring
//     (3 stages up to D 128, 2 at D 256: 128 KB), STAGES - 1 chunks in
//     flight; the paged producer looks each key's page up in the table
//     (int32, on the device).  Keys past the tile's last visible one are
//     never read: their rows are zero-filled, so no stale value, however
//     large or NaN, enters.
//   * q and the running O stay in registers, as in flash_f32.cuh's
//     flash_f32_qreg_kernel: a half-warp holds 4 query rows, lane ds the
//     d-slice 64 c + 4 ds + {0..3} of each (at D 32, where 16 lanes of 4
//     would cover 64 columns, 2 ds + {0, 1}: Cfg::VW floats a vector); for
//     every 4 keys the 16 slices' partial dot products (4 rows x 4 keys)
//     are summed and scattered by 4 shuffle rounds, P goes through shared
//     memory inside the half-warp.
//   * Few rows (an AR step, a gemma verify of 10 rows) do not leave warps
//     idle: a tile's rows take RW = 8 / KG warps (8 rows a warp), and the 8
//     warps form KG key groups (8, 4, 2 or 1, a template argument) that
//     walk disjoint runs of 4-key batches of every chunk with their own
//     online softmax, in straight-line code; the groups' (O, m, l) merge in
//     shared memory at the end.  A tile of up to 32 rows keeps at least 6
//     of the 8 warps busy (a verify of 35 rows a KV head: tiles of 21 and
//     14 rows, 2 and 4 key groups, where one tile of 35 would keep 5).
//
// Internal linkage throughout (see sm90.cuh).

#pragma once

#include "splitkv_sm90.cuh"

namespace decode32 {
namespace {

using splitkv::BK;
using splitkv::last_key;
using splitkv::LOG2E;
using splitkv::Params;
using splitkv::row_tile;
using splitkv::RowTile;

constexpr int NT = 256;                      // 8 warps
constexpr int KB = 4;                        // keys of a reduce-scatter
constexpr int WARPS = NT / 32;
constexpr int RPW = 8;                       // query rows of a warp (4 a half-warp)
constexpr int MAX_ROWS = 64;                 // query heads a KV head at most
constexpr int TILE_ROWS = 32;                // rows of a row tile (g <= 32)
constexpr int MIN_CHUNKS_DENSE = 2;          // dense: 64-key chunks a split at least
constexpr float NEG_INF = -1e30f;            // running max before any key

// -inf, a masked score: 2^(-inf - m) = 0 for the finite running max m
__device__ __forceinline__ float masked() { return __int_as_float(0xff800000); }

// VW floats of a row at p, as one 16- or 8-byte load or store.
template <int VW>
__device__ __forceinline__ void ld_vec(float (&d)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x;
    d[1] = v.y;
  }
}
template <int VW>
__device__ __forceinline__ void st_vec(float* p, const float* s) {
  if constexpr (VW == 4) *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
  else *reinterpret_cast<float2*>(p) = make_float2(s[0], s[1]);
}

template <int D>
struct Cfg {
  static constexpr int BN = 32;              // keys of a ring stage
  static constexpr int NBT = BN / KB;        // key batches of a stage
  static constexpr int VW = D >= 64 ? 4 : 2; // floats of a lane's vector
  static constexpr int NC = D / (16 * VW);   // vectors of a lane's d-slice of a row
  static constexpr int STAGES = D == 256 ? 2 : 3;
  static constexpr int RV = D / 4;           // float4s of a row
  static constexpr int STAGE = 2 * BN * D;   // floats: K, then V
  static constexpr int PP = BN + 4;          // P pitch: conflict-free float4 reads
  static constexpr int P_OFF = STAGES * STAGE;
  static constexpr int ML_OFF = P_OFF + MAX_ROWS * PP;   // the merge's m and l
  static constexpr int BYTES = (ML_OFF + 2 * MAX_ROWS) * 4;
  // two blocks an SM where their shared memory fits (up to D 128)
  static constexpr int MIN_BLOCKS = 2 * (BYTES + 1024) <= 228 * 1024 ? 2 : 1;
  static_assert(BN * RV % NT == 0, "even staging");
  static_assert(MAX_ROWS * D <= STAGES * STAGE, "the merge reuses the ring");
};

// Where q, K and V are read: q through 3 element strides (batch, position,
// head); K and V dense through theirs, or paged (k, v the pools, p.table).
struct Src {
  const float* q;
  const float* k;
  const float* v;
  long long sqb, sqt, sqh;
  long long skb, sks, skh;
  long long svb, svs, svh;
};

// KG key groups of WARPS / KG warps each: group kg walks batches
// [kg NBW, (kg + 1) NBW) of every stage, NBW = BN / 4 / KG (straight-line code:
// no branch between a group's batches, so their loads, products and
// reductions overlap).
template <int D, int PAGED, int KG>
__global__ void __launch_bounds__(NT, Cfg<D>::MIN_BLOCKS)
decode_f32_kernel(const Params p, const Src src) {
  using L = Cfg<D>;
  constexpr int NC = L::NC, VW = L::VW, BN = L::BN;
  constexpr int CW = 16 * VW;                // columns of one vector of the 16 lanes
  constexpr int RW = WARPS / KG;             // row warps: 8 RW rows a tile at most
  constexpr int NBW = L::NBT / KG;           // a group's batches of a stage
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) float smem[];
  float* Ps = smem + L::P_OFF;
  const int tid = threadIdx.x, ds = tid % 16, warp = tid / 32;
  const int half = (tid % 32) & 16;          // lane 0 of the half-warp
  const int sp = blockIdx.x / p.n_tiles, h = blockIdx.y, b = blockIdx.z;
  const RowTile rt = row_tile(p, blockIdx.x % p.n_tiles);
  const int rows = p.g * rt.npos;
  // the partial entry's keys start at position k_off (see decode_sm90.cuh)
  const int base = p.lengths[b] - p.k_off + rt.t0;   // the tile's first query
  const int last = last_key(base, rt.npos, p.limit);
  const int k0 = sp * p.cps * BK;
  if (k0 > last) return;                     // nothing of this split is visible
  const int kend = min(k0 + p.cps * BK, last + 1);
  const int n_stages = (kend - k0 + BN - 1) / BN;
  // split 0 holds every live key of the tile; the partial entry always merges
  const bool direct = p.lse == nullptr && last < p.cps * BK;

  // warp roles: row warp rw (rows 8 rw ..), key group kg; a warp whose
  // rows all lie past the tile's (a short last tile) only stages keys
  const int rw = warp % RW, kg = warp / RW;
  const bool active = RPW * rw < rows;
  const int rg = 2 * rw + ((tid / 16) & 1);  // this half-warp's rows 4 rg + i
  const int nb0 = kg * NBW;                  // the group's first batch

  const int* trow = PAGED ? p.table + static_cast<long long>(b) * p.MP : nullptr;
  auto load_stage = [&](int c) {
    float* Ks = smem + (c % L::STAGES) * L::STAGE;
    float* Vs = Ks + BN * D;
    const int kb = k0 + c * BN;
#pragma unroll
    for (int n = 0; n < BN * L::RV / NT; ++n) {
      const int i = tid + n * NT, r = i / L::RV, col = (i % L::RV) * 4;
      const int key = kb + r;
      const bool ok = key < kend;
      long long ko = 0, vo = 0;
      if (ok) {
        if constexpr (PAGED) {
          const long long pos = static_cast<long long>(trow[key / p.ps]) * p.ps + key % p.ps;
          ko = vo = (pos * p.Hkv + h) * D;
        } else {
          ko = b * src.skb + key * src.sks + h * src.skh;
          vo = b * src.svb + key * src.svs + h * src.svh;
        }
      }
      sm90::cp_async16(Ks + r * D + col, src.k + ko + col, ok);
      sm90::cp_async16(Vs + r * D + col, src.v + vo + col, ok);
    }
  };
#pragma unroll
  for (int c = 0; c < L::STAGES - 1; ++c) {
    if (c < n_stages) load_stage(c);
    sm90::cp_async_commit();
  }

  // q's slice (zeros on pad rows), straight from global memory.  As in
  // flash_f32_qreg_kernel, this lane keeps row 4 rg + (i ^ rp) as q[i] and
  // takes key n ^ kp of every 4 as its n-th, so each reduce-scatter round
  // keeps the lower half of its values and sends the upper.
  const int rp = ds / 4, kp = ds % 4;
  float q[4][NC][VW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * rg + (i ^ rp);
    const int t = rt.t0 + r / p.g, hq = h * p.g + r % p.g;
    const float* qg = src.q + b * src.sqb + t * src.sqt + hq * src.sqh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (active && r < rows) {
        ld_vec<VW>(q[i][c], qg + CW * c + VW * ds);
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) q[i][c][e] = 0.f;
      }
    }
  }

  // row 4 rg + rp: its last visible key (a pad row sees every loaded key),
  // running max, and this lane's part of its sum (log2 units)
  const int r_own = 4 * rg + rp;
  const int qlim = r_own < rows ? min(base + r_own / p.g, last) : last;
  const bool capped = p.cap > 0.f;
  float m = NEG_INF, l = 0.f;
  float o[4][VW * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < VW * NC; ++c) o[i][c] = 0.f;

  for (int c = 0; c < n_stages; ++c) {
    // chunk c has landed, and every thread is done with the stage the next
    // copies overwrite
    sm90::cp_async_wait<L::STAGES - 2>();
    __syncthreads();
    if (c + L::STAGES - 1 < n_stages) load_stage(c + L::STAGES - 1);
    sm90::cp_async_commit();
    if (!active) continue;
    const float* Ks = smem + (c % L::STAGES) * L::STAGE;
    const float* Vs = Ks + BN * D;
    const int kb = k0 + c * BN;

    // ---- S: this lane's score of row rp and key KB nb + kp, for the
    // group's batches nb = nb0 + j
    float s[NBW];
#pragma unroll
    for (int j = 0; j < NBW; ++j) {
      const int nb = nb0 + j;
      float part[4 * KB];                    // [row i][key n] at KB i + n
#pragma unroll
      for (int n = 0; n < KB; ++n) {
        float kv[NC][VW];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          ld_vec<VW>(kv[cc], Ks + (KB * nb + (n ^ kp)) * D + CW * cc + VW * ds);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = 0.f;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
#pragma unroll
            for (int e = 0; e < VW; ++e) a = fmaf(q[i][cc][e], kv[cc][e], a);
          }
          part[KB * i + n] = a;
        }
      }
      // sum over the 16 slices and scatter (flash_f32_qreg_kernel's rounds)
      float r8[8], r4[4], r2[2];
#pragma unroll
      for (int j = 0; j < 8; ++j) r8[j] = part[j] + __shfl_xor_sync(FULL, part[j + 8], 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) r4[j] = r8[j] + __shfl_xor_sync(FULL, r8[j + 4], 4);
#pragma unroll
      for (int j = 0; j < 2; ++j) r2[j] = r4[j] + __shfl_xor_sync(FULL, r4[j + 2], 2);
      float x = (r2[0] + __shfl_xor_sync(FULL, r2[1], 1)) * p.scale;
      if (capped) x = tanhf(x / p.cap) * p.cap;
      s[j] = kb + KB * nb + kp <= qlim ? x * LOG2E : masked();
    }

    // ---- online softmax of row rp over its 4 lanes; P into shared memory;
    // O's rows rescaled by their rows' corrections
    float cmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < NBW; ++j) cmax = fmaxf(cmax, s[j]);
    cmax = fmaxf(cmax, __shfl_xor_sync(FULL, cmax, 1));
    cmax = fmaxf(cmax, __shfl_xor_sync(FULL, cmax, 2));
    const float m_new = fmaxf(m, cmax);
    const float corr = exp2f(m - m_new);
    m = m_new;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NBW; ++j) {
      const float pr = exp2f(s[j] - m_new);
      Ps[r_own * L::PP + KB * (nb0 + j) + kp] = pr;
      psum += pr;
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ci = __shfl_sync(FULL, corr, half + 4 * i);
#pragma unroll
      for (int cc = 0; cc < VW * NC; ++cc) o[i][cc] *= ci;
    }
    __syncwarp();                            // P rows are the half-warp's own

    // ---- O += P V over the group's batches
#pragma unroll
    for (int j = 0; j < NBW; ++j) {
      const int nb = nb0 + j;
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (4 * rg + i) * L::PP + KB * nb);
#pragma unroll
      for (int e = 0; e < KB; ++e) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          float vv[VW];
          ld_vec<VW>(vv, Vs + (KB * nb + e) * D + CW * cc + VW * ds);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pr = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int f = 0; f < VW; ++f) o[i][VW * cc + f] = fmaf(pr, vv[f], o[i][VW * cc + f]);
          }
        }
      }
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();                           // the ring is free for the merge

  // ---- each group's (O, m, l) into the ring's space: group kg's row r at
  // slot kg * rows8 + r
  constexpr int rows8 = RPW * RW;
  float* Om = smem;
  float* Mm = smem + L::ML_OFF;
  float* Lm = Mm + MAX_ROWS;
  if (active) {
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    if (kp == 0) {
      Mm[kg * rows8 + r_own] = m;
      Lm[kg * rows8 + r_own] = l;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        st_vec<VW>(Om + (kg * rows8 + 4 * rg + i) * D + CW * cc + VW * ds, &o[i][VW * cc]);
  }
  __syncthreads();

  // ---- merge the groups: the output itself, or this split's partial
  float* out = static_cast<float*>(p.out);
  const long long at =
      ((static_cast<long long>(b) * p.Hkv + h) * p.splits + sp) * p.rows + rt.t0 * p.g;
  for (int u = tid; u < rows * (D / 4); u += NT) {
    const int r = u / (D / 4), col = (u % (D / 4)) * 4;
    float mx = NEG_INF;
    for (int g = 0; g < KG; ++g) mx = fmaxf(mx, Mm[g * rows8 + r]);
    float lsum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < KG; ++g) {
      const float w = exp2f(Mm[g * rows8 + r] - mx);
      const float4 v = *reinterpret_cast<const float4*>(Om + (g * rows8 + r) * D + col);
      lsum += w * Lm[g * rows8 + r];
      acc.x += w * v.x;
      acc.y += w * v.y;
      acc.z += w * v.z;
      acc.w += w * v.w;
    }
    if (direct) {
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      const int t = rt.t0 + r / p.g, gi = r % p.g;
      *reinterpret_cast<float4*>(
          out + ((static_cast<long long>(b) * p.T + t) * p.Hq + h * p.g + gi) * D + col) =
          make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    } else {
      *reinterpret_cast<float4*>(p.part_o + (at + r) * D + col) = acc;
      if (col == 0)
        *reinterpret_cast<float2*>(p.part_ml + (at + r) * 2) = make_float2(mx, lsum);
    }
  }
}

// Opt the kernel in to its shared memory (and the carveout for two blocks
// an SM), launch it over (splits * n_tiles, Hkv, B) and the combine.
template <int D, int PAGED, int KG>
int launch_kg(Params& p, const Src& src, int B, cudaStream_t stream) {
  using L = Cfg<D>;
  static bool opted_in = false;              // per instantiation, per library
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(decode_f32_kernel<D, PAGED, KG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(decode_f32_kernel<D, PAGED, KG>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  decode_f32_kernel<D, PAGED, KG>
      <<<dim3(p.splits * p.n_tiles, p.Hkv, B), NT, L::BYTES, stream>>>(p, src);
  return splitkv::launch_combine<D, float>(p, B, stream);
}

// The key groups a tile of `rows` rows runs: as many as leave every warp a
// row warp's share (8 rows a warp).
inline int key_groups(int rows) {
  const int rw = (rows + RPW - 1) / RPW;
  return rw <= 1 ? 8 : rw <= 2 ? 4 : rw <= 4 ? 2 : 1;
}

template <int D, int PAGED>
int launch_body(Params& p, const Src& src, void* scratch, int B, cudaStream_t stream) {
  if (splitkv::set_partials(p, scratch, B, D) != 0) return -1;
  switch (key_groups(p.g * p.tp)) {
    case 8: return launch_kg<D, PAGED, 8>(p, src, B, stream);
    case 4: return launch_kg<D, PAGED, 4>(p, src, B, stream);
    case 2: return launch_kg<D, PAGED, 2>(p, src, B, stream);
    default: return launch_kg<D, PAGED, 1>(p, src, B, stream);
  }
}

// Row tiles of the fp32 body: at most TILE_ROWS rows, so a verify of 35
// rows a KV head runs two tiles on 6 and 8 busy warps, not one on 5.
inline void tiles(int g, int T, int* tp, int* n_tiles) {
  splitkv::row_tiles(g, T, tp, n_tiles, TILE_ROWS);
}

// Chunks per split and splits of the dense body for a cache of S positions:
// splits for MIN_BLOCKS blocks an SM over the B * Hkv * n_tiles tiles.
inline void plan_dense(int B, int Hkv, int S, int head_dim, int n_tiles, int* cps,
                       int* splits) {
  const int waves = head_dim == 256 ? Cfg<256>::MIN_BLOCKS : Cfg<128>::MIN_BLOCKS;
  splitkv::plan(B * n_tiles, Hkv, S, MIN_CHUNKS_DENSE, waves, cps, splits);
}

inline void set_shape(Params& p, const void* lengths, void* out, int T, int Hq, int Hkv,
                      float scale, float cap) {
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.g = Hq / Hkv;
  p.rows = p.g * T;
  tiles(p.g, T, &p.tp, &p.n_tiles);
  p.scale = scale;
  p.cap = cap;
}

// Whether the body takes the call: fp32 at head dim 32, 64, 128 or 256, at
// most 64 query heads per KV head, any page size.
inline bool takes(int dtype, int head_dim, int g, int T) {
  return dtype == 1 &&
         (head_dim == 32 || head_dim == 64 || head_dim == 128 || head_dim == 256) &&
         g >= 1 && g <= MAX_ROWS && T >= 1;
}

// Dense (kernel 4): st as decode_sm90.cuh's launch, out contiguous (B, T,
// Hq, D); the partial entry with lse non-null (keys at k_off ..).
template <int D>
int launch_dense(const void* q, const void* k, const void* v, const void* lengths, void* out,
                 void* scratch, const long long* st, int B, int T, int S, int Hq, int Hkv,
                 float scale, float cap, cudaStream_t stream, float* lse, int k_off) {
  if (st[11] != D || st[10] != static_cast<long long>(Hq) * D ||
      st[9] != static_cast<long long>(T) * Hq * D)
    return -1;
  Params p{};
  set_shape(p, lengths, out, T, Hq, Hkv, scale, cap);
  p.limit = S;
  p.lse = lse;
  p.k_off = k_off;
  plan_dense(B, Hkv, S, D, p.n_tiles, &p.cps, &p.splits);
  const Src src{static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), st[0], st[1], st[2], st[3], st[4],
                st[5], st[6], st[7], st[8]};
  return launch_body<D, 0>(p, src, scratch, B, stream);
}

// Paged (kernel 3): q and out contiguous (B, T, Hq, D), the pools (NP, ps,
// Hkv, D), the table (B, MP); cps and splits from the paged body's plan
// (paged90::plan).
template <int D>
int launch_paged(const void* q, const void* kp, const void* vp, const void* lengths,
                 const void* table, void* out, void* scratch, int B, int T, int Hq, int Hkv,
                 int ps, int MP, int cps, int splits, float scale, float cap,
                 cudaStream_t stream) {
  Params p{};
  set_shape(p, lengths, out, T, Hq, Hkv, scale, cap);
  p.table = static_cast<const int*>(table);
  p.ps = ps;
  p.MP = MP;
  p.limit = MP * ps;
  p.cps = cps;
  p.splits = splits;
  const long long sh = D, st = static_cast<long long>(Hq) * D;
  const Src src{static_cast<const float*>(q), static_cast<const float*>(kp),
                static_cast<const float*>(vp), st * T, st, sh, 0, 0, 0, 0, 0, 0};
  return launch_body<D, 1>(p, src, scratch, B, stream);
}

// Bytes of scratch a dense call needs (every split's partial for the
// partial entry, else 0 with one split).
inline long long scratch_bytes_dense(int head_dim, int B, int T, int Hq, int Hkv, int S,
                                     bool partial) {
  int tp = 0, n_tiles = 0, cps = 0, splits = 0;
  tiles(Hq / Hkv, T, &tp, &n_tiles);
  plan_dense(B, Hkv, S, head_dim, n_tiles, &cps, &splits);
  if (partial)
    return static_cast<long long>(B) * Hkv * splits * (Hq / Hkv) * T * (head_dim + 2) * 4;
  return splitkv::scratch_bytes(head_dim, B, Hkv, (Hq / Hkv) * T, splits);
}

// Dynamic shared memory of a block at this head dim (for reports), or -2.
inline int smem_bytes(int head_dim) {
  if (head_dim == 32) return Cfg<32>::BYTES;
  if (head_dim == 64) return Cfg<64>::BYTES;
  if (head_dim == 128) return Cfg<128>::BYTES;
  if (head_dim == 256) return Cfg<256>::BYTES;
  return -2;
}

}  // namespace
}  // namespace decode32
