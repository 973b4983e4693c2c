// Flash prefill attention in full fp32 on the CUDA cores of an H100: the
// fp32 body of the flash kernel (flash_attention.cu; bf16 runs
// flash_sm90.cuh).  It computes what the Pallas TPU kernel _flash_kernel of
// src/repro/kernels/flash_attention/flash_attention.py computes, for G = 1
// (64 query positions of one head a block):
//
//   out[b, t, h] = softmax_s( cap(q[b, t, h] . k[b, s, h/g] * scale)
//                             | s <= t, s > t - window ) . v[b, s, h/g]
//
// causal by index (or not), with the optional window and tanh cap, q, k, v
// and out read and written in place through 12 element strides.
//
// What bounds it: the products, in fp32 FMAs (no TF32: the parity checks
// hold it to 2e-5), 4 D FLOPs per visible (query, key) at 67 TFLOP/s; a
// gemma-7b prefill of 2 x 256 tokens is 1.08 GFLOP (0.016 ms) against
// 2.5 us of bytes.  So the loop has to keep the FMA units busy: every
// shared-memory read should feed many FMAs, and the running state should
// never leave the registers.
//
// What the design does about it (64 query positions of one head a block,
// 256 threads, the grid heaviest first):
//   * Registers hold each thread's tile of O (4 rows x D/16 columns) for
//     the whole key walk, its rows' running max and its part of their sums;
//     only P passes through shared memory, once a chunk, inside the
//     half-warp that wrote it.
//   * Head dim 256 (flash_f32_qreg_kernel): q stays in registers too.
//     Thread (rg, ds) keeps rows 4 rg + i on the d-slice 64 c + 4 ds +
//     {0..3}, so S = Q K^T reads one float4 of K per 16 FMAs; the 16 slices'
//     partial sums of 4 rows x 4 keys are added and scattered over the
//     half-warp by 4 shuffle rounds.  K and V arrive in 32-key chunks, 140
//     KB a block, one block an SM (255 registers).
//   * Head dims 32 to 128 (flash_f32_kernel), where a d-slice would feed
//     too few FMAs per shuffle: Q in shared memory; thread (ty, tx) computes
//     rows ty + 16 i and keys tx + 16 j of S over float4s of Q and K, and
//     the max is reduced over the half-warp; Q and K rows have a pitch of
//     D + 4 floats, so the 8 keys of a quarter-warp fall in 8 bank groups.
//     64-key chunks: two blocks an SM at 32 and 64, one (183 KB) at 128,
//     which measured faster than two blocks of 32-key chunks.
//   * K and V chunks arrive by cp.async into a ring of 2 stages: the next
//     chunk's copies are issued right after the barrier that opens a chunk
//     and land during its FMAs.
//   * Keys a block cannot see are never read: it walks [kstart, kend) only
//     (a causal block stops at its last query, a windowed one starts at its
//     first visible key).
//
// kernel_variants.py's TUNING holds the shapes measured against these
// (PERF.md, section 6).

#pragma once

#include <cuda_runtime.h>

#include "../../csrc/sm90.cuh"

// Internal linkage, as in the other headers: several kernel libraries are
// loaded into one process.
namespace flash32 {
namespace {

constexpr int NT = 256;                      // Q in shared memory: 16 x 16 threads
constexpr int BM = 64;                       // and 64 query rows a block
constexpr float NEG_INF = -1e30f;            // running max before any key

// -inf, a masked score: exp(-inf - m) = 0 for the finite running max m
__device__ __forceinline__ float masked() { return __int_as_float(0xff800000); }

template <int D>
struct Cfg {
  static constexpr int BN = D >= 256 ? 32 : 64;     // keys per chunk
  static constexpr int KN = BN / 16;                // keys per thread
  static constexpr int STAGES = 2;
  static constexpr int QP = D + 4;                  // Q, K pitch (floats)
  static constexpr int VP = D;
  static constexpr int PP = BN + 16;                // P pitch: half-warps 16 banks apart
  static constexpr int VW = D >= 64 ? 4 : 2;        // O columns per vector
  static constexpr int NG = D / (16 * VW);          // vectors per row per thread
  static constexpr int CPT = D / 16;                // O columns per thread
  static constexpr int RV = D / 4;                  // 16-byte pieces per row
  static constexpr int K_FLOATS = BN * QP;
  static constexpr int STAGE = K_FLOATS + BN * VP;
  static constexpr int KV_OFF = BM * QP;            // float offsets
  static constexpr int P_OFF = KV_OFF + STAGES * STAGE;
  static constexpr int BYTES = (P_OFF + BM * PP) * 4;
  // two blocks an SM where their shared memory fits (228 KB, 1 KB a block
  // reserved), else one, with all of a thread's 255 registers
  static constexpr int MIN_BLOCKS = 2 * (BYTES + 1024) <= 228 * 1024 ? 2 : 1;
  static_assert(BN * RV % NT == 0 && BM * RV % NT == 0, "even staging");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  long long sqb, sqt, sqh;                   // strides in elements: batch, position, head
  long long skb, sks, skh;
  long long svb, svs, svh;
  long long sob, sot, soh;
  int B, T, S, Hq, Hkv;
  int n_tiles;                               // query tiles of the body's rows
  int causal, window;
  float scale, cap;
};

// VW consecutive floats as one 16- or 8-byte vector, taken apart by
// constant index (registers, no local memory)
template <int W>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ __forceinline__ static float get(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ __forceinline__ static float get(const T& v, int i) { return i == 0 ? v.x : v.y; }
};

// The block's query tile of bm positions and the keys it may see, [kstart,
// kend), in chunks of bn: block i runs query tile n_tiles - 1 - i / (B Hq),
// so the tiles with the most keys start first.
struct Tile {
  int b, h, kvh, t0, n_pos, kstart, kend, n_chunks;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int bm, int bn) {
  Tile t;
  const int bh_n = p.B * p.Hq;
  const int tile = p.n_tiles - 1 - static_cast<int>(blockIdx.x / bh_n);
  const int bh = static_cast<int>(blockIdx.x % bh_n);
  t.h = bh % p.Hq;
  t.b = bh / p.Hq;
  t.kvh = t.h / (p.Hq / p.Hkv);
  t.t0 = tile * bm;
  t.n_pos = min(bm, p.T - t.t0);
  t.kstart = 0;
  t.kend = p.S;
  if (p.causal) {
    t.kend = min(p.S, t.t0 + t.n_pos);
    if (p.window > 0) t.kstart = max(0, t.t0 - p.window + 1);
  }
  t.n_chunks = t.kend > t.kstart ? (t.kend - t.kstart + bn - 1) / bn : 0;
  return t;
}

// Whether key `key` is visible from query position t.
__device__ __forceinline__ bool visible(const Params& p, int key, int kend, int t) {
  bool vis = key < kend;
  if (p.causal) {
    vis = vis && key <= t;
    if (p.window > 0) vis = vis && key > t - p.window;
  }
  return vis;
}

// ------------------------------------------- Q in shared memory (D <= 128)
// (the template also takes 256: QREG_MIN_D below chooses)
template <int D>
__global__ void __launch_bounds__(NT, Cfg<D>::MIN_BLOCKS)
flash_f32_kernel(const Params p) {
  using L = Cfg<D>;
  constexpr int BN = L::BN, KN = L::KN, CPT = L::CPT, VW = L::VW;
  using V = Vec<VW>;
  using VT = typename V::T;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ps = smem + L::P_OFF;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  const Tile tl = tile_of(p, BM, BN);
  const int b = tl.b, h = tl.h, t0 = tl.t0, n_pos = tl.n_pos;
  const int kstart = tl.kstart, kend = tl.kend, n_chunks = tl.n_chunks;
  const float* qg = p.q + b * p.sqb + h * p.sqh;
  const float* kg = p.k + b * p.skb + tl.kvh * p.skh;
  const float* vg = p.v + b * p.svb + tl.kvh * p.svh;

  // Q rows (zeros past T) and K/V chunk c into stage c % STAGES
#pragma unroll
  for (int n = 0; n < BM * L::RV / NT; ++n) {
    const int i = tid + n * NT, r = i / L::RV, col = (i % L::RV) * 4;
    const bool ok = r < n_pos;
    sm90::cp_async16(Qs + r * L::QP + col, ok ? qg + (t0 + r) * p.sqt + col : p.q, ok);
  }
  auto load_chunk = [&](int c) {
    float* Ks = smem + L::KV_OFF + (c % L::STAGES) * L::STAGE;
    float* Vs = Ks + L::K_FLOATS;
    const int kb = kstart + c * BN;
#pragma unroll
    for (int n = 0; n < BN * L::RV / NT; ++n) {
      const int i = tid + n * NT, r = i / L::RV, col = (i % L::RV) * 4;
      const int key = kb + r;
      const bool ok = key < kend;
      sm90::cp_async16(Ks + r * L::QP + col, ok ? kg + key * p.sks + col : p.k, ok);
      sm90::cp_async16(Vs + r * L::VP + col, ok ? vg + key * p.svs + col : p.v, ok);
    }
  };
  if (n_chunks > 0) load_chunk(0);
  sm90::cp_async_commit();

  float o[4][CPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    // chunk c (and Q) has landed, and every thread is done with the stage
    // the next copies overwrite and with its P rows of chunk c - 1
    sm90::cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < n_chunks) load_chunk(c + 1);
    sm90::cp_async_commit();
    const float* Ks = smem + L::KV_OFF + (c % L::STAGES) * L::STAGE;
    const float* Vs = Ks + L::K_FLOATS;
    const int kb = kstart + c * BN;

    // ---- S = Q K^T: rows ty + 16 i, keys tx + 16 j
    float s[4][KN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[KN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * L::QP + d);
#pragma unroll
      for (int j = 0; j < KN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L::QP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // ---- online softmax on the thread's rows; rescale its O by the
    // correction; P into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      float cmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int key = kb + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.cap > 0.f) x = tanhf(x / p.cap) * p.cap;
        s[i][j] = visible(p, key, kend, t) ? x : masked();
        cmax = fmaxf(cmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
      const float m_new = fmaxf(m[i], cmax);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const float pr = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * L::PP + tx + 16 * j] = pr;
        psum += pr;
      }
      l[i] = l[i] * corr + psum;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) o[i][cc] *= corr;
    }
    __syncwarp();                            // P rows are the warp's own

    // ---- O += P V: rows ty + 16 i, columns 16 VW g + VW tx + {0..VW-1}
#pragma unroll
    for (int kk = 0; kk < BN; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * L::PP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < L::NG; ++g) {
          const VT vv = *reinterpret_cast<const VT*>(Vs + (kk + e) * L::VP + 16 * VW * g +
                                                     VW * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pr = Vec<4>::get(pv[i], e);
#pragma unroll
            for (int w = 0; w < VW; ++w)
              o[i][VW * g + w] = fmaf(pr, V::get(vv, w), o[i][VW * g + w]);
          }
        }
      }
    }
  }
  sm90::cp_async_wait<0>();

  // ---- emit O / l: the row's sum is the sum of its 16 threads' parts
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int r = ty + 16 * i;
    if (r >= n_pos) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    float* og = p.out + b * p.sob + (t0 + r) * p.sot + h * p.soh;
#pragma unroll
    for (int g = 0; g < L::NG; ++g) {
      float* dst = og + 16 * VW * g + VW * tx;
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(o[i][4 * g] * inv, o[i][4 * g + 1] * inv, o[i][4 * g + 2] * inv,
                        o[i][4 * g + 3] * inv);
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(o[i][2 * g] * inv, o[i][2 * g + 1] * inv);
      }
    }
  }
}

// ------------------------------------------- Q in registers (D 256)
template <int D>
struct QCfg {
  static constexpr int BM = 64;                     // query rows per block
  static constexpr int NT = BM / 4 * 16;            // 16 row groups x 16 slices
  static constexpr int BN = 32;                     // keys per chunk
  static constexpr int KB = 4;                      // keys per reduce-scatter
  static constexpr int STAGES = 2;
  static constexpr int MIN_BLOCKS = 1;              // 255 registers a thread
  static constexpr int NC = D / 64;                 // float4 pieces of a d-slice
  static constexpr int PP = BN + 4;                 // P pitch: conflict-free
  static constexpr int RV = D / 4;
  static constexpr int STAGE = 2 * BN * D;          // K then V, pitch D
  static constexpr int P_OFF = STAGES * STAGE;
  static constexpr int BYTES = (P_OFF + BM * PP) * 4;
  static_assert(BN * RV % NT == 0 && BN % KB == 0, "even staging");
};

// Thread (rg, ds), rg = tid / 16, ds = tid % 16, keeps q's rows 4 rg + i
// (i < 4) on its d-slice d = 64 c + 4 ds + {0..3} (c < D / 64) in registers
// for the whole walk, so S reads only K from shared memory: one float4 per
// 16 FMAs.  The 16 lanes of a half-warp hold the 16 slices of one row
// group; for every 4 keys their partial dot products (4 rows x 4 keys) are
// summed and scattered by 4 shuffle rounds, after which lane ds holds the
// score of row 4 rg + ds / 4 and key ds % 4.  A row's 32 scores of a chunk
// thus lie in 4 lanes, its max is reduced over them, and P goes to shared
// memory for the half-warp's P V, where the thread owns O's rows 4 rg + i
// and columns 64 c + 4 ds + {0..3} (the same slice) and takes each row's
// correction from a lane that holds it.
template <int D>
__global__ void __launch_bounds__(QCfg<D>::NT, QCfg<D>::MIN_BLOCKS)
flash_f32_qreg_kernel(const Params p) {
  using L = QCfg<D>;
  constexpr int BN = L::BN, KB = L::KB, NC = L::NC, NB = BN / KB, NT = L::NT;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) float smem[];
  float* Ps = smem + L::P_OFF;
  const int tid = threadIdx.x, ds = tid % 16, rg = tid / 16;
  const int half = (tid % 32) & 16;                // lane 0 of the half-warp
  const Tile tl = tile_of(p, L::BM, BN);
  const int t0 = tl.t0, kstart = tl.kstart, kend = tl.kend;
  const float* kg = p.k + tl.b * p.skb + tl.kvh * p.skh;
  const float* vg = p.v + tl.b * p.svb + tl.kvh * p.svh;

  auto load_chunk = [&](int c) {
    float* Ks = smem + (c % L::STAGES) * L::STAGE;
    float* Vs = Ks + BN * D;
    const int kb = kstart + c * BN;
#pragma unroll
    for (int n = 0; n < BN * L::RV / NT; ++n) {
      const int i = tid + n * NT, r = i / L::RV, col = (i % L::RV) * 4;
      const int key = kb + r;
      const bool ok = key < kend;
      sm90::cp_async16(Ks + r * D + col, ok ? kg + key * p.sks + col : p.k, ok);
      sm90::cp_async16(Vs + r * D + col, ok ? vg + key * p.svs + col : p.v, ok);
    }
  };
  if (tl.n_chunks > 0) load_chunk(0);
  sm90::cp_async_commit();

  // q's slice (zeros past T), straight from global memory.  This lane keeps
  // row 4 rg + (i ^ rp) as q[i] and takes key n ^ kp of every 4 as its n-th,
  // so each reduce-scatter round below keeps the lower half of its values
  // and sends the upper (no per-lane choice of halves).
  const int rp = ds / 4, kp = ds % 4;
  float4 q[4][NC];
  const float* qg = p.q + tl.b * p.sqb + tl.h * p.sqh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * rg + (i ^ rp);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      q[i][c] = r < tl.n_pos
                    ? *reinterpret_cast<const float4*>(qg + (t0 + r) * p.sqt + 64 * c + 4 * ds)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // row 4 rg + ds / 4: its running max, and this lane's part of its sum
  const int t = t0 + 4 * rg + ds / 4;
  float m = NEG_INF, l = 0.f;
  float o[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) o[i][c] = 0.f;

  for (int c = 0; c < tl.n_chunks; ++c) {
    // chunk c has landed, and every thread is done with the stage the next
    // copies overwrite
    sm90::cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < tl.n_chunks) load_chunk(c + 1);
    sm90::cp_async_commit();
    const float* Ks = smem + (c % L::STAGES) * L::STAGE;
    const float* Vs = Ks + BN * D;
    const int kb = kstart + c * BN;

    // ---- S: this lane's score of row ds / 4 = rp and key KB nb + ds % 4 = kp
    float s[NB];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float part[4 * KB];                          // [row i][key n] at KB i + n
#pragma unroll
      for (int n = 0; n < KB; ++n) {
        float4 kv[NC];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          kv[cc] = *reinterpret_cast<const float4*>(Ks + (KB * nb + (n ^ kp)) * D + 64 * cc +
                                                    4 * ds);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = 0.f;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            a = fmaf(q[i][cc].x, kv[cc].x, a);
            a = fmaf(q[i][cc].y, kv[cc].y, a);
            a = fmaf(q[i][cc].z, kv[cc].z, a);
            a = fmaf(q[i][cc].w, kv[cc].w, a);
          }
          part[KB * i + n] = a;
        }
      }
      // sum over the 16 slices and scatter: the partner across bit 3 of ds
      // holds this lane's lower rows as its upper ones (rp differs by 2),
      // across bit 2 the next row (by 1), across bits 1 and 0 the keys
      float r8[8], r4[4], r2[2];
#pragma unroll
      for (int j = 0; j < 8; ++j) r8[j] = part[j] + __shfl_xor_sync(FULL, part[j + 8], 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) r4[j] = r8[j] + __shfl_xor_sync(FULL, r8[j + 4], 4);
#pragma unroll
      for (int j = 0; j < 2; ++j) r2[j] = r4[j] + __shfl_xor_sync(FULL, r4[j + 2], 2);
      s[nb] = r2[0] + __shfl_xor_sync(FULL, r2[1], 1);
    }

    // ---- online softmax of row ds / 4 over its 4 lanes; P into shared
    // memory; O's rows rescaled by their rows' corrections
    float cmax = NEG_INF;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float x = s[nb] * p.scale;
      if (p.cap > 0.f) x = tanhf(x / p.cap) * p.cap;
      s[nb] = visible(p, kb + KB * nb + ds % 4, kend, t) ? x : masked();
      cmax = fmaxf(cmax, s[nb]);
    }
    cmax = fmaxf(cmax, __shfl_xor_sync(FULL, cmax, 1));
    cmax = fmaxf(cmax, __shfl_xor_sync(FULL, cmax, 2));
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);
    m = m_new;
    float psum = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float pr = expf(s[nb] - m_new);
      Ps[(4 * rg + ds / 4) * L::PP + KB * nb + ds % 4] = pr;
      psum += pr;
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ci = __shfl_sync(FULL, corr, half + 4 * i);
#pragma unroll
      for (int cc = 0; cc < 4 * NC; ++cc) o[i][cc] *= ci;
    }
    __syncwarp();                            // P rows are the half-warp's own

    // ---- O += P V
#pragma unroll
    for (int kk = 0; kk < BN; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (4 * rg + i) * L::PP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float4 vv =
              *reinterpret_cast<const float4*>(Vs + (kk + e) * D + 64 * cc + 4 * ds);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pr = Vec<4>::get(pv[i], e);
            o[i][4 * cc] = fmaf(pr, vv.x, o[i][4 * cc]);
            o[i][4 * cc + 1] = fmaf(pr, vv.y, o[i][4 * cc + 1]);
            o[i][4 * cc + 2] = fmaf(pr, vv.z, o[i][4 * cc + 2]);
            o[i][4 * cc + 3] = fmaf(pr, vv.w, o[i][4 * cc + 3]);
          }
        }
      }
    }
  }
  sm90::cp_async_wait<0>();

  // ---- emit O / l: a row's sum is the sum of its 4 lanes' parts
  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = __shfl_sync(FULL, l, half + 4 * i);
    const int r = 4 * rg + i;
    if (r >= tl.n_pos) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    float* og = p.out + tl.b * p.sob + (t0 + r) * p.sot + tl.h * p.soh;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
      *reinterpret_cast<float4*>(og + 64 * cc + 4 * ds) =
          make_float4(o[i][4 * cc] * inv, o[i][4 * cc + 1] * inv, o[i][4 * cc + 2] * inv,
                      o[i][4 * cc + 3] * inv);
  }
}

// The body a head dim runs: Q in registers from QREG_MIN_D on, below it Q in
// shared memory (at 128 the register body measured slower, with spills at
// two blocks an SM).
constexpr int QREG_MIN_D = 256;

template <int D, typename Kernel>
int launch_body(Kernel kernel, int bm, int nt, int bytes, Params p, cudaStream_t stream) {
  static bool opted_in = false;              // per instantiation, per library
  if (!opted_in) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)                    // room for two blocks an SM where they fit
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  p.n_tiles = (p.T + bm - 1) / bm;
  const long long blocks = static_cast<long long>(p.n_tiles) * p.B * p.Hq;
  if (blocks > 0x7fffffffLL) return -1;
  kernel<<<static_cast<unsigned>(blocks), nt, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Params& p, cudaStream_t stream) {
  if constexpr (D >= QREG_MIN_D)
    return launch_body<D>(flash_f32_qreg_kernel<D>, QCfg<D>::BM, QCfg<D>::NT, QCfg<D>::BYTES,
                          p, stream);
  else
    return launch_body<D>(flash_f32_kernel<D>, BM, NT, Cfg<D>::BYTES, p, stream);
}

template <int D>
constexpr int body_bytes() {
  if constexpr (D >= QREG_MIN_D) return QCfg<D>::BYTES;
  else return Cfg<D>::BYTES;
}

// The 12 strides in the order q (b, t, h), k (b, s, h), v (b, s, h),
// out (b, t, h); -2 for a head dim the body is not built for.
inline int launch_any(int head_dim, const void* q, const void* k, const void* v, void* out,
                      const long long* st, int B, int T, int S, int Hq, int Hkv, int causal,
                      int window, float scale, float cap, cudaStream_t stream) {
  Params p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.sqb = st[0]; p.sqt = st[1]; p.sqh = st[2];
  p.skb = st[3]; p.sks = st[4]; p.skh = st[5];
  p.svb = st[6]; p.svs = st[7]; p.svh = st[8];
  p.sob = st[9]; p.sot = st[10]; p.soh = st[11];
  p.B = B; p.T = T; p.S = S; p.Hq = Hq; p.Hkv = Hkv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.cap = cap;
  switch (head_dim) {
    case 32: return launch<32>(p, stream);
    case 64: return launch<64>(p, stream);
    case 128: return launch<128>(p, stream);
    case 256: return launch<256>(p, stream);
  }
  return -2;
}

// Dynamic shared memory of a block at this head dim (for reports), or -2.
inline int smem_bytes(int head_dim) {
  switch (head_dim) {
    case 32: return body_bytes<32>();
    case 64: return body_bytes<64>();
    case 128: return body_bytes<128>();
    case 256: return body_bytes<256>();
  }
  return -2;
}

}  // namespace
}  // namespace flash32
