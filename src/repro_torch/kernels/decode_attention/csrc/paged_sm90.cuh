// Paged decode / SD-verify attention in bf16 on Hopper (sm_90a): the body of
// the bf16 path of paged_decode_attention.cu at head dims 64 and 128.
//
//   out[b, t, h*g + i] = softmax_k( cap(q . K[b, k] * scale) | k <= len + t ) . V
//
// Split-KV.  The grid is (splits, Hkv, B): split s of (KV head h, sequence
// b) owns the logical keys [s * cps * BK, (s + 1) * cps * BK), cps whole
// chunks of BK = 64 keys.  The launcher picks cps from the table width MP
// and the page size (known on the host, so nothing waits on the device) so
// that at long context B * Hkv * splits fills the SMs once (one block an SM;
// splits for two or four were slower, PERF.md), and at the serve shape one
// split holds every key.  A split that starts past length + T - 1 returns at
// once.
//
// Combine.  When split 0 holds every live key of (b, h), its block writes
// the output directly.  Otherwise each live split writes its unnormalised
// accumulator O and its row max m and sum l in fp32 into the wrapper's
// scratch, and paged_combine_kernel merges them:
//   out = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s,   M = max_s m_s.
//
// Block: one consumer warpgroup and one producer warp (in a warpgroup of
// its own, whose other warps exit).
//   * Q: the g * T <= 64 query rows of one KV head (row r = t * g + i) are
//     one wgmma m64 tile; one 4-D TMA box (64 columns, g heads, T steps, 1)
//     over q (B, T, Hq, D) delivers them in that row order.  The consumers
//     zero the pad rows [g * T, 64) themselves.
//   * K and V: the producer looks each page up in the block table and keeps
//     STAGES chunks in flight in a ring with full barriers for K and V and
//     one empty barrier.  TMA reads a 3-D tensor map over the pool viewed as
//     (D, Hkv, NP * ps), 128-byte swizzle, boxes of 64 columns x 1 head x
//     min(ps, BK) positions at coordinate page * ps + offset: one box per
//     64 columns when a chunk lies in one page (ps a multiple of 64), else
//     one per page of the chunk (ps 8, 16, 32).  Pages past the one holding
//     length + T - 1 are never loaded (the trash page and stale pages
//     beyond are never read).  Within that last page the box reaches past
//     length + T - 1, as the TPU kernel's page block does: those K rows are
//     masked out of the scores, and those V rows (and the rows of pages not
//     loaded) are zeroed in shared memory before the P V product, so no
//     stale value, however large or NaN, enters the result.
//   * S = Q K^T: wgmma m64n64k16, Q and K (K-major) from shared memory.
//     O += P V: wgmma m64nDk16 with P from registers (the score
//     accumulator rounded to bf16 is wgmma's register-A fragment) and V
//     read MN-major through the transpose bit.  The online softmax runs in
//     registers (quad shuffles), exp2 with scale * log2(e) folded in, the
//     tanh cap before the mask; row t is masked at keys > length + t.
//
// Internal linkage throughout (see sm90.cuh).

#pragma once

#include "../../csrc/sm90.cuh"

namespace paged90 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;                       // keys per chunk (= ROWS: zero_rows)
constexpr int ROWS = 64;                     // query rows of one wgmma tile
constexpr int SW = 128;                      // swizzle bytes = one 64-column box row
constexpr int NT = 256;                      // consumer warpgroup + producer warpgroup
constexpr int STAGES = 4;
constexpr int MIN_CHUNKS = 4;                // chunks a split holds at least
constexpr int WAVES = 1;                     // blocks per SM the split count aims at
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
  const int* table;
  bf16* out;
  float* part_o;                             // (B, Hkv, splits, rows, D) partial O
  float* part_ml;                            // (B, Hkv, splits, rows, 2) m, l
  int T, Hq, Hkv, g, rows, ps, MP, cps, splits;
  float scale, cap;
};

// Chunks per split and number of splits for a table of MP pages of ps: as
// many splits as fill WAVES blocks per SM over the B * Hkv (sequence, KV
// head) pairs, none shorter than MIN_CHUNKS chunks.
inline void plan(int B, int Hkv, int ps, int MP, int* cps, int* splits) {
  const long long n_chunks = (static_cast<long long>(MP) * ps + BK - 1) / BK;
  long long n = static_cast<long long>(WAVES) * sm90::sm_count() / (static_cast<long long>(B) * Hkv);
  if (n > n_chunks / MIN_CHUNKS) n = n_chunks / MIN_CHUNKS;
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

// The last logical key (b, .) attends to: length + T - 1, within the table.
__device__ __forceinline__ int last_key(int length, int T, int limit) {
  return min(length + T - 1, limit - 1);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
paged_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const Params p) {
  using L = Cfg<D>;
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int length = p.lengths[b];
  const int last = last_key(length, p.T, p.MP * p.ps);
  const int k0 = sp * p.cps * BK;
  if (k0 > last) return;                     // nothing of this split is visible
  const int n_chunks = min(p.cps, (last - k0) / BK + 1);
  const bool direct = last < p.cps * BK;     // split 0 holds every live key

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: one thread looks pages up and keeps the ring full
    if (threadIdx.x != 128) return;
    sm90::prefetch_map(&qmap);
    sm90::prefetch_map(&kmap);
    sm90::prefetch_map(&vmap);
    sm90::mbar_expect_tx(q_full, L::NB * p.rows * SW);
    for (int c = 0; c < L::NB; ++c)
      sm90::tma_load_4d(smem + c * ROWS * SW, &qmap, q_full, 64 * c, h * p.g, 0, b);
    const int* trow = p.table + static_cast<long long>(b) * p.MP;
    const int per = p.ps < BK ? p.ps : BK;   // positions of one box
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % STAGES;
      const int kb = k0 + i * BK;
      // the boxes of this chunk that hold keys <= last: page ids first
      const int nbox = p.ps >= BK ? 1 : min(BK / p.ps, (last - kb) / p.ps + 1);
      int pos[BK / 8];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        if (j < nbox) {
          const int lk = kb + j * per;
          pos[j] = trow[lk / p.ps] * p.ps + lk % p.ps;
        }
      }
      sm90::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      for (int kv = 0; kv < 2; ++kv) {          // K, then V
        unsigned char* dst = smem + (kv ? L::V_OFF : L::K_OFF) + s * L::KV_BYTES;
        uint64_t* bar = kv ? &v_full[s] : &k_full[s];
        const CUtensorMap* map = kv ? &vmap : &kmap;
        sm90::mbar_expect_tx(bar, static_cast<uint32_t>(nbox * per * D * 2));
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          if (j < nbox) {
            for (int c = 0; c < L::NB; ++c)
              sm90::tma_load_3d(dst + c * BK * SW + j * per * SW, map, bar, 64 * c, h, pos[j]);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup, rows r0 = 16 warp + lane / 4 and r0 + 8
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

  sm90::mbar_wait(q_full, 0);
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int kb = k0 + i * BK;
    unsigned char* vs = smem + L::V_OFF + s * L::KV_BYTES;
    const uint32_t kbase = sm90::smem_u32(smem + L::K_OFF + s * L::KV_BYTES);
    const uint32_t vbase = sm90::smem_u32(vs);

    // ---- S = Q K^T (64 rows x 64 keys, fp32 in registers)
    float sc[32];
    sm90::mbar_wait(&k_full[s], ph);
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
    sm90::mbar_wait(&v_full[s], ph);
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
    if (tid == 0) sm90::mbar_arrive(&empty[s]);
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
template <int D>
__global__ void __launch_bounds__(256)
paged_combine_kernel(const Params p) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int last = last_key(p.lengths[b], p.T, p.MP * p.ps);
  const int live = last / (p.cps * BK) + 1;
  if (live <= 1) return;
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
    bf16* dst = p.out + ((static_cast<long long>(b) * p.T + t) * p.Hq + h * p.g + gi) * D + col;
    uint2 packed;
    packed.x = sm90::pack_bf16(acc.x * inv, acc.y * inv);
    packed.y = sm90::pack_bf16(acc.z * inv, acc.w * inv);
    *reinterpret_cast<uint2*>(dst) = packed;
  }
}

// Whether this body takes the call: bf16 at head dim 64 or 128, pages whose
// boxes tile a 64-key chunk (ps a multiple of 64, or 8, 16, 32), at most 64
// query rows.  (Alignment is the wrapper's check.)
inline bool takes(int dtype, int head_dim, int ps, int g, int T) {
  return dtype == 0 && (head_dim == 64 || head_dim == 128) && ps % 8 == 0 &&
         (ps % BK == 0 || BK % ps == 0) && g * T <= ROWS && g >= 1 && T >= 1;
}

// Bytes of scratch a call needs: the split partials, 0 with one split.
inline long long scratch_bytes(int head_dim, int B, int T, int Hq, int Hkv, int ps, int MP) {
  int cps = 0, splits = 0;
  plan(B, Hkv, ps, MP, &cps, &splits);
  if (splits <= 1) return 0;
  const long long rows = static_cast<long long>(Hq / Hkv) * T;
  return static_cast<long long>(B) * Hkv * splits * rows * (head_dim + 2) * 4;
}

template <int D>
int launch(const void* q, const void* kp, const void* vp, const void* lengths,
           const void* table, void* out, void* scratch, int B, int T, int Hq, int Hkv,
           int NP, int ps, int MP, float scale, float cap, cudaStream_t stream) {
  using L = Cfg<D>;
  static bool opted_in = false;              // per instantiation, per library
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  Params p{};
  p.lengths = static_cast<const int*>(lengths);
  p.table = static_cast<const int*>(table);
  p.out = static_cast<bf16*>(out);
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.g = Hq / Hkv;
  p.rows = p.g * T;
  p.ps = ps;
  p.MP = MP;
  p.scale = scale;
  p.cap = cap;
  plan(B, Hkv, ps, MP, &p.cps, &p.splits);
  if (p.splits > 1) {
    if (scratch == nullptr) return -1;
    p.part_o = static_cast<float*>(scratch);
    p.part_ml = p.part_o + static_cast<long long>(B) * Hkv * p.splits * p.rows * D;
  }
  // q: (D, Hq, T, B), box (64, g, T, 1); pools: (D, Hkv, NP * ps), box
  // (64, 1, min(ps, BK))
  CUtensorMap qm, km, vm;
  const long long qd[4] = {D, Hq, T, B};
  const long long qs[3] = {D, static_cast<long long>(Hq) * D, static_cast<long long>(T) * Hq * D};
  const long long kd[3] = {D, Hkv, static_cast<long long>(NP) * ps};
  const long long ks[2] = {D, static_cast<long long>(Hkv) * D};
  const int qb[4] = {64, p.g, T, 1};
  const int kbx[3] = {64, 1, ps < BK ? ps : BK};
  int rc = sm90::make_map_bf16<4>(&qm, q, qd, qs, qb, SW);
  if (rc == 0) rc = sm90::make_map_bf16<3>(&km, kp, kd, ks, kbx, SW);
  if (rc == 0) rc = sm90::make_map_bf16<3>(&vm, vp, kd, ks, kbx, SW);
  if (rc != 0) return rc;
  paged_sm90_kernel<D><<<dim3(p.splits, Hkv, B), NT, L::BYTES, stream>>>(qm, km, vm, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits <= 1) return static_cast<int>(e);
  paged_combine_kernel<D><<<dim3(Hkv, B), 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace paged90
