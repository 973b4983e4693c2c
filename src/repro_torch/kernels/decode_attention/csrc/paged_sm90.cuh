// Paged decode / SD-verify attention in bf16 on Hopper (sm_90a): the body of
// the bf16 path of paged_decode_attention.cu at head dims 64 and 128.
//
//   out[b, t, h*g + i] = softmax_k( cap(q . K[b, k] * scale) | k <= len + t ) . V
//
// with K[b, k] = k_pages[table[b, k / ps], k % ps, h].  The split-KV grid,
// the consumer warpgroup (both products as wgmma, the online softmax in
// registers), the split partials and their combine are
// kernels/csrc/splitkv_sm90.cuh's, shared with the dense body
// (decode_sm90.cuh).  What is paged is the producer and the split plan:
//   * Splits: plan() over the table width MP * ps, so that at long context
//     B * Hkv * splits fills the SMs once (one block an SM; splits for two
//     or four were slower, PERF.md), and at the serve shape one split holds
//     every key.
//   * K and V: the producer looks each page up in the block table and keeps
//     STAGES chunks in flight.  TMA reads a 3-D tensor map over the pool
//     viewed as (D, Hkv, NP * ps), 128-byte swizzle, boxes of 64 columns x
//     1 head x min(ps, BK) positions at coordinate page * ps + offset: one
//     box per 64 columns when a chunk lies in one page (ps a multiple of
//     64), else one per page of the chunk (ps 8, 16, 32).  Pages past the
//     one holding length + T - 1 are never loaded (the trash page and stale
//     pages beyond are never read).  Within that last page the box reaches
//     past length + T - 1, as the TPU kernel's page block does; the
//     consumers mask those K rows and zero those V rows (and the rows of
//     boxes not loaded) in shared memory.
//
// Internal linkage throughout (see sm90.cuh).

#pragma once

#include "../../csrc/splitkv_sm90.cuh"

namespace paged90 {
namespace {

using namespace splitkv;

constexpr int MIN_CHUNKS = 4;                // chunks a split holds at least
constexpr int WAVES = 1;                     // blocks per SM the split count aims at

// Chunks per split and number of splits for a table of MP pages of ps.
inline void plan(int B, int Hkv, int ps, int MP, int* cps, int* splits) {
  splitkv::plan(B, Hkv, static_cast<long long>(MP) * ps, MIN_CHUNKS, WAVES, cps, splits);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
paged_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const Params p) {
  using L = Cfg<D>;
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int length = p.lengths[b];
  const int last = last_key(length, p.T, p.limit);
  const int k0 = sp * p.cps * BK;
  if (k0 > last) return;                     // nothing of this split is visible
  const int n_chunks = min(p.cps, (last - k0) / BK + 1);
  const bool direct = last < p.cps * BK;     // split 0 holds every live key

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  const Bars bars = init_bars<D>(smem);

  if (threadIdx.x >= 128) {
    // ---- producer: one thread looks pages up and keeps the ring full
    if (threadIdx.x != 128) return;
    sm90::prefetch_map(&qmap);
    sm90::prefetch_map(&kmap);
    sm90::prefetch_map(&vmap);
    sm90::mbar_expect_tx(bars.q_full, L::NB * p.rows * SW);
    for (int c = 0; c < L::NB; ++c)
      sm90::tma_load_4d(smem + c * ROWS * SW, &qmap, bars.q_full, 64 * c, h * p.g, 0, b);
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
      sm90::mbar_wait(&bars.empty[s], ((i / STAGES) & 1) ^ 1);
      for (int kv = 0; kv < 2; ++kv) {          // K, then V
        unsigned char* dst = smem + (kv ? L::V_OFF : L::K_OFF) + s * L::KV_BYTES;
        uint64_t* bar = kv ? &bars.v_full[s] : &bars.k_full[s];
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
  consume<D>(smem, bars, p, b, h, sp, length, last, k0, n_chunks, direct);
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
  return splitkv::scratch_bytes(head_dim, B, Hkv, (Hq / Hkv) * T, splits);
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
  p.limit = MP * ps;
  p.scale = scale;
  p.cap = cap;
  plan(B, Hkv, ps, MP, &p.cps, &p.splits);
  if (set_partials(p, scratch, B, D) != 0) return -1;
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
  return launch_combine<D>(p, B, stream);
}

}  // namespace
}  // namespace paged90
