// Split-KV decode / SD-verify attention in bf16 on Hopper (sm_90a): the parts
// that do not depend on where the keys come from, shared by the paged body
// (kernels/decode_attention/csrc/paged_sm90.cuh, keys through a block table)
// and the dense body (kernels/decode_attention/csrc/decode_sm90.cuh, keys
// from a contiguous cache).  Each of those defines its kernel: the grid
// decode, its producer (which keys land in which ring stage), and calls
// consume<D>() for the consumer warpgroup and combine_kernel<D> for the
// merge.
//
//   out[b, t, h*g + i] = softmax_k( cap(q . K[b, k] * scale) | k <= len + t ) . V
//
// Split-KV.  The grid is (splits, Hkv, B): split s of (KV head h, sequence
// b) owns the logical keys [s * cps * BK, (s + 1) * cps * BK), cps whole
// chunks of BK = 64 keys.  plan() picks cps on the host from the number of
// keys a row may hold (nothing waits on the device) so that at long context
// B * Hkv * splits fills the SMs once, and a short row keeps one split.  A
// split that starts past length + T - 1 returns at once.
//
// Combine.  When split 0 holds every live key of (b, h), its block writes
// the output directly.  Otherwise each live split writes its unnormalised
// accumulator O and its row max m and sum l in fp32 into the wrapper's
// scratch, and combine_kernel merges them:
//   out = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s,   M = max_s m_s.
//
// Block: one consumer warpgroup and one producer warp (in a warpgroup of
// its own, whose other warps exit).
//   * Q: the g * T <= 64 query rows of one KV head (row r = t * g + i) are
//     one wgmma m64 tile; the producer loads them with one 4-D TMA box (64
//     columns, g heads, T steps, 1) over q (B, T, Hq, D), which delivers
//     them in that row order.  The consumers zero the pad rows [g * T, 64).
//   * K and V: STAGES chunks in flight in a ring with full barriers for K
//     and V and one empty barrier; 128-byte swizzle, a chunk of BK rows per
//     64-column box.  The producer never loads a chunk that starts past
//     length + T - 1; the last chunk it loads may reach past it.  Those K
//     rows are masked out of the scores, and those V rows are zeroed in
//     shared memory before the P V product, so no stale value, however
//     large or NaN, enters the result.
//   * S = Q K^T: wgmma m64n64k16, Q and K (K-major) from shared memory.
//     O += P V: wgmma m64nDk16 with P from registers (the score
//     accumulator rounded to bf16 is wgmma's register-A fragment) and V
//     read MN-major through the transpose bit.  The online softmax runs in
//     registers (quad shuffles), exp2 with scale * log2(e) folded in, the
//     tanh cap before the mask; row t is masked at keys > length + t.
//
// Internal linkage throughout (see sm90.cuh).

#pragma once

#include "sm90.cuh"

namespace splitkv {
namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;                       // keys per chunk (= ROWS: zero_rows)
constexpr int ROWS = 64;                     // query rows of one wgmma tile
constexpr int SW = 128;                      // swizzle bytes = one 64-column box row
constexpr int NT = 256;                      // consumer warpgroup + producer warpgroup
constexpr int STAGES = 4;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int NB = D / 64;          // 64-column boxes of a row
  static constexpr int Q_BYTES = ROWS * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one chunk of K (or V)
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + (1 + 3 * STAGES) * 8 + 1024;   // + alignment
};

struct Params {
  const int* lengths;
  const int* table;                          // paged body only
  bf16* out;                                 // (B, T, Hq, D), contiguous
  float* part_o;                             // (B, Hkv, splits, rows, D) partial O
  float* part_ml;                            // (B, Hkv, splits, rows, 2) m, l
  float* lse;                                // partial entry: (B, T, Hq) log-sum-exp
  int T, Hq, Hkv, g, rows, ps, MP, cps, splits;
  int limit;                                 // keys a row can hold: keys >= limit never exist
  int k_off;                                 // partial entry: key 0's position (dense body)
  float scale, cap;
};

// Chunks per split and number of splits for rows of at most n_keys keys:
// as many splits as fill `waves` blocks per SM over the B * Hkv (sequence,
// KV head) pairs, none shorter than min_chunks chunks.
inline void plan(int B, int Hkv, long long n_keys, int min_chunks, int waves, int* cps,
                 int* splits) {
  const long long n_chunks = (n_keys + BK - 1) / BK;
  long long n = static_cast<long long>(waves) * sm90::sm_count() / (static_cast<long long>(B) * Hkv);
  if (n > n_chunks / min_chunks) n = n_chunks / min_chunks;
  if (n < 1) n = 1;
  const long long c = (n_chunks + n - 1) / n;
  *cps = static_cast<int>(c);
  *splits = static_cast<int>((n_chunks + c - 1) / c);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (D == 128) sm90::wgmma_rs_n128<1>(o, a, db, 1);
  else sm90::wgmma_rs_n64<1>(o, a, db, 1);
}

// Zero rows [first, 64) of each of NB 64-row boxes of a swizzled tile (a
// row keeps its 128 bytes under the swizzle), by the consumer warpgroup,
// then order the stores before the wgmma reads and the next TMA writes.
template <int NB>
__device__ __forceinline__ void zero_rows(unsigned char* tile, int first, int tid) {
  constexpr int UNITS = NB * SW / 16;        // 16-byte units of a row
  for (int u = tid; u < (64 - first) * UNITS; u += 128) {
    const int r = first + u / UNITS, c = u / (SW / 16) % NB, v = u % (SW / 16);
    *reinterpret_cast<uint4*>(tile + (c * 64 + r) * SW + v * 16) = make_uint4(0, 0, 0, 0);
  }
  sm90::fence_proxy_async();
  sm90::named_barrier(1, 128);
}

// The last logical key (b, .) attends to: length + T - 1, within the row.
__device__ __forceinline__ int last_key(int length, int T, int limit) {
  return min(length + T - 1, limit - 1);
}

// The block's barriers, after the Q tile and the K and V rings.
struct Bars {
  uint64_t* q_full;
  uint64_t* k_full;
  uint64_t* v_full;
  uint64_t* empty;
};

// Lay the barriers out, initialise them (thread 0) and sync the block.
template <int D>
__device__ __forceinline__ Bars init_bars(unsigned char* smem) {
  Bars bars;
  bars.q_full = reinterpret_cast<uint64_t*>(smem + Cfg<D>::BAR_OFF);
  bars.k_full = bars.q_full + 1;
  bars.v_full = bars.k_full + STAGES;
  bars.empty = bars.v_full + STAGES;
  if (threadIdx.x == 0) {
    sm90::mbar_init(bars.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&bars.k_full[s], 1);
      sm90::mbar_init(&bars.v_full[s], 1);
      sm90::mbar_init(&bars.empty[s], 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  return bars;
}

// The consumer warpgroup (threads 0..127) of split sp of (KV head h,
// sequence b): n_chunks chunks from key k0 as the producer fills the ring,
// then the output itself (direct) or this split's partial (O, m, l).
template <int D>
__device__ __forceinline__ void consume(unsigned char* smem, const Bars& bars, const Params& p,
                                        int b, int h, int sp, int length, int last, int k0,
                                        int n_chunks, bool direct) {
  using L = Cfg<D>;
  // rows r0 = 16 warp + lane / 4 and r0 + 8
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kc = 2 * (lane % 4);             // key (and output) columns kc, kc + 1 of 8
  int row[2], qlim[2];                       // rows held; last visible key (-1: pad row)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = warp * 16 + lane / 4 + 8 * hh;
    qlim[hh] = row[hh] < p.rows ? min(length + row[hh] / p.g, last) : -1;
  }
  zero_rows<L::NB>(smem, p.rows, tid);       // Q's pad rows: the box fills g * T

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const bool capped = p.cap > 0.f;
  const float mul = capped ? LOG2E : p.scale * LOG2E;
  const float pre = capped ? p.scale / p.cap : 0.f;
  const uint32_t qbase = sm90::smem_u32(smem);

  sm90::mbar_wait(bars.q_full, 0);
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int kb = k0 + i * BK;
    unsigned char* vs = smem + L::V_OFF + s * L::KV_BYTES;
    const uint32_t kbase = sm90::smem_u32(smem + L::K_OFF + s * L::KV_BYTES);
    const uint32_t vbase = sm90::smem_u32(vs);

    // ---- S = Q K^T (64 rows x 64 keys, fp32 in registers)
    float sc[32];
    sm90::mbar_wait(&bars.k_full[s], ph);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / 64, off = (kk * 16 % 64) * 2;
      const uint64_t da = sm90::make_desc(qbase + c * ROWS * SW + off, 16, 8 * SW, SW);
      const uint64_t db = sm90::make_desc(kbase + c * BK * SW + off, 16, 8 * SW, SW);
      sm90::wgmma_ss_n64<0>(sc, da, db, kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    // ---- scores in log2 units: cap, then mask in chunks past the first
    // row's last visible key
    if (capped) {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = p.cap * tanhf(sc[e] * pre);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] *= mul;
    if (kb + BK - 1 > min(length, last)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = kb + 8 * (e / 4) + kc + (e & 1);
        if (key > qlim[(e >> 1) & 1]) sc[e] = -INFINITY;
      }
    }

    // ---- online softmax over the quad that holds each row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    float base[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];   // a row with nothing visible yet
      corr[r] = ex2(m[r] - base[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[e] = ex2(sc[e] - base[(e >> 1) & 1]);
      rs[(e >> 1) & 1] += sc[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = sm90::pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
    }

    // ---- O += P V; V rows past `last` (stale or never loaded) zeroed first
    sm90::mbar_wait(&bars.v_full[s], ph);
    if (kb + BK - 1 > last) zero_rows<L::NB>(vs, last - kb + 1, tid);
    sm90::fence_regs(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = sm90::make_desc(vbase + kk * 16 * SW, BK * SW, 8 * SW, SW);
      pv_product<D>(o, pa[kk], db);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    if (tid == 0) sm90::mbar_arrive(&bars.empty[s]);
  }

  // ---- epilogue: the output itself, or this split's partial (O, m, l)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (direct) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (row[hh] >= p.rows) continue;
      const float inv = 1.f / fmaxf(l[hh], 1e-30f);
      const int t = row[hh] / p.g, gi = row[hh] % p.g;
      bf16* dst = p.out + ((static_cast<long long>(b) * p.T + t) * p.Hq + h * p.g + gi) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j + kc) =
            sm90::pack_bf16(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    }
  } else {
    const long long base =
        ((static_cast<long long>(b) * p.Hkv + h) * p.splits + sp) * p.rows;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (row[hh] >= p.rows) continue;
      float* dst = p.part_o + (base + row[hh]) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j + kc) =
            make_float2(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
      if (lane % 4 == 0)
        *reinterpret_cast<float2*>(p.part_ml + (base + row[hh]) * 2) = make_float2(m[hh], l[hh]);
    }
  }
}

// Merge the live splits of (KV head blockIdx.x, sequence blockIdx.y) into
// the output, unless split 0 held every live key (its block wrote it).
// The partial entry (lse non-null) always merges, even one live split (the
// kernel sends every split to scratch then), and writes each row's natural
// log-sum-exp, (M + log2 L) ln 2 from the log2 units the splits keep; a row
// with no visible key of the block (no live split, or every score masked)
// gets 0 and -inf.
template <int D>
__global__ void __launch_bounds__(256)
combine_kernel(const Params p) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int last = last_key(p.lengths[b] - p.k_off, p.T, p.limit);
  const int live = last < 0 ? 0 : last / (p.cps * BK) + 1;
  if (live <= 1 && p.lse == nullptr) return;
  const long long base = (static_cast<long long>(b) * p.Hkv + h) * p.splits * p.rows;
  for (int u = threadIdx.x; u < p.rows * (D / 4); u += blockDim.x) {
    const int r = u / (D / 4), col = (u % (D / 4)) * 4;
    float mmax = -INFINITY;
    for (int s = 0; s < live; ++s) mmax = fmaxf(mmax, p.part_ml[(base + s * p.rows + r) * 2]);
    float lsum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < live; ++s) {
      const long long at = base + s * p.rows + r;
      const float2 ml = *reinterpret_cast<const float2*>(p.part_ml + at * 2);
      const float w = ml.x == -INFINITY ? 0.f : ex2(ml.x - mmax);
      const float4 v = *reinterpret_cast<const float4*>(p.part_o + at * D + col);
      lsum += w * ml.y;
      acc.x += w * v.x;
      acc.y += w * v.y;
      acc.z += w * v.z;
      acc.w += w * v.w;
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    const int t = r / p.g, gi = r % p.g;
    const long long row = (static_cast<long long>(b) * p.T + t) * p.Hq + h * p.g + gi;
    uint2 packed;
    packed.x = sm90::pack_bf16(acc.x * inv, acc.y * inv);
    packed.y = sm90::pack_bf16(acc.z * inv, acc.w * inv);
    *reinterpret_cast<uint2*>(p.out + row * D + col) = packed;
    if (p.lse != nullptr && col == 0)
      p.lse[row] = lsum > 0.f ? (mmax + __log2f(lsum)) * 0.6931471805599453f : -INFINITY;
  }
}

// Bytes of scratch for the split partials of B * Hkv pairs of `rows` query
// rows each; 0 with one split.
inline long long scratch_bytes(int head_dim, int B, int Hkv, int rows, int splits) {
  if (splits <= 1) return 0;
  return static_cast<long long>(B) * Hkv * splits * rows * (head_dim + 2) * 4;
}

// Point the partials into `scratch` (the layout scratch_bytes sized), or
// return -1 when more than one split (or the partial entry) needs scratch
// that is missing.
inline int set_partials(Params& p, void* scratch, int B, int D) {
  if (p.splits <= 1 && p.lse == nullptr) return 0;
  if (scratch == nullptr) return -1;
  p.part_o = static_cast<float*>(scratch);
  p.part_ml = p.part_o + static_cast<long long>(B) * p.Hkv * p.splits * p.rows * D;
  return 0;
}

// The combine after the split kernel: when there is more than one split,
// and always for the partial entry.
template <int D>
inline int launch_combine(const Params& p, int B, cudaStream_t stream) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || (p.splits <= 1 && p.lse == nullptr)) return static_cast<int>(e);
  combine_kernel<D><<<dim3(p.Hkv, B), 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace splitkv
