// Paged decode / SD-verify attention in bf16 on Hopper (sm_90a): the body of
// the bf16 path of paged_decode_attention.cu at head dims 32, 64, 128 and
// 256, on pages of any size.
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
//     or four were slower, PERF.md, at D 128 and at D 256), and at the
//     serve shape one split holds every key.  At gemma3's B 8 x Hkv 8 at
//     D 256 that is two splits a pair, 128 blocks.  Splits are whole 64-key
//     chunks whatever the page size.
//   * K and V: the producer looks each page up in the block table and keeps
//     Cfg<D>::RING chunks in flight.  A 64-key chunk is cut into boxes of
//     gcd(ps, 64) rows (box_rows), each lying in one page: one box on pages
//     of a multiple of 64, 8 on pages of 8 or 24, 4 on pages of 16 or 48.
//     TMA reads them through a 3-D tensor map over the pool viewed as (D,
//     Hkv, NP * ps), boxes of 64 columns (32 at D 32, in the 64-byte
//     swizzle) x 1 head x gcd(ps, 64) positions at coordinate page * ps +
//     offset, so every box fills whole 8-row swizzle atoms; eight lanes of
//     the producer warp look up a chunk's pages and issue its boxes, a lane
//     a box (one lane issuing all eight took 1.8x as long at 8k keys on
//     pages of 24: PERF.md, kernel_variants.py paged_one_issuer).  On pages that
//     are not a multiple of 8 (12, 20, any odd size) a box would cut an
//     atom, so the producer warpgroup stages the chunk with cp.async into
//     the swizzled layout instead (stage_chunks), each key's page looked up
//     in the table.  Boxes and keys past length + T - 1 are never loaded
//     (the trash page and stale pages beyond are never read), and the full
//     barrier waits for the bytes of the boxes loaded.  The last box loaded
//     may reach past length + T - 1, as the TPU kernel's page block does;
//     the consumers mask those K rows and zero those V rows (and the rows
//     not loaded) in shared memory.
//
// Internal linkage throughout (see sm90.cuh).

#pragma once

#include <numeric>

#include "../../csrc/splitkv_sm90.cuh"

namespace paged90 {
namespace {

using namespace splitkv;

constexpr int MIN_CHUNKS = 4;                // chunks a split holds at least
constexpr int WAVES = 1;                     // blocks per SM the split count aims at
// fewest rows of a TMA box of K or V: an 8-row swizzle atom; pages whose
// boxes would be shorter (ps not a multiple of 8) are staged by cp.async
constexpr int MIN_BOX = 8;
// lanes of the producer warp that issue a chunk's boxes (at most 8 boxes a
// chunk: a lane each)
constexpr int BOX_LANES = 8;

// Chunks per split and number of splits for a table of MP pages of ps.
inline void plan(int B, int Hkv, int ps, int MP, int* cps, int* splits) {
  splitkv::plan(B, Hkv, static_cast<long long>(MP) * ps, MIN_CHUNKS, WAVES, cps, splits);
}

// The producer warpgroup's copies on pages of fewer than MIN_BOX rows a box
// (ps not a multiple of 8): its 128 threads stage each chunk's keys <= last
// with cp.async, 16 bytes a piece, each key's page looked up in the table,
// into the swizzled layout TMA would have written.  Each thread waits for
// its pieces of a chunk one chunk later, fences them for the wgmma reads
// (async proxy), and the warpgroup's barrier lets one thread arrive on the
// chunk's full barriers.
template <int D>
__device__ __forceinline__ void stage_chunks(unsigned char* smem, const Bars& bars,
                                             const Params& p, const bf16* kp, const bf16* vp,
                                             int b, int h, int last, int k0, int n_chunks) {
  using L = Cfg<D>;
  constexpr int UPR = D / 8;                 // 16-byte pieces of a row
  constexpr int UPB = L::SW / 16;            // of a box row
  const int pt = threadIdx.x - 128;
  const int* trow = p.table + static_cast<long long>(b) * p.MP;
  for (int i = 0; i <= n_chunks; ++i) {
    if (i < n_chunks) {
      const int s = i % L::RING;
      const int kb = k0 + i * BK;
      const int n_rows = min(BK, last - kb + 1);
      sm90::mbar_wait(&bars.empty[s], ((i / L::RING) & 1) ^ 1);
      unsigned char* ks = smem + L::K_OFF + s * L::KV_BYTES;
      unsigned char* vs = smem + L::V_OFF + s * L::KV_BYTES;
      for (int u = pt; u < n_rows * UPR; u += 128) {
        const int r = u / UPR, w = u % UPR;
        const int key = kb + r;
        const long long row = static_cast<long long>(trow[key / p.ps]) * p.ps + key % p.ps;
        const long long src = (row * p.Hkv + h) * D + w * 8;
        const uint32_t dst =
            sm90::swizzled(static_cast<uint32_t>((w / UPB * BK + r) * L::SW + w % UPB * 16), L::SW);
        sm90::cp_async16(ks + dst, kp + src, true);
        sm90::cp_async16(vs + dst, vp + src, true);
      }
    }
    sm90::cp_async_commit();
    if (i == 0) continue;
    // chunk i - 1 has landed: make it visible to the consumers' wgmma
    sm90::cp_async_wait<1>();
    sm90::fence_proxy_async();
    sm90::named_barrier(2, 128);
    if (pt == 0) {
      const int s = (i - 1) % L::RING;
      sm90::mbar_arrive(&bars.k_full[s]);
      sm90::mbar_arrive(&bars.v_full[s]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
paged_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const Params p,
                  const bf16* kp, const bf16* vp) {
  using L = Cfg<D>;
  constexpr int SW = L::SW;
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int length = p.lengths[b];
  const int last = last_key(length, p.T, p.limit);
  const int k0 = sp * p.cps * BK;
  if (k0 > last) return;                     // nothing of this split is visible
  const int n_chunks = min(p.cps, (last - k0) / BK + 1);
  const bool direct = last < p.cps * BK;     // split 0 holds every live key
  const RowTile rt{0, p.T};                  // one row tile: g * T <= 64

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  const Bars bars = init_bars<D>(smem);

  if (threadIdx.x >= 128) {
    // ---- producer: q by TMA; K and V by TMA boxes of `per` rows, or staged
    const int per = p.box;                   // rows of a box: gcd(ps, BK)
    if (threadIdx.x == 128) {
      sm90::prefetch_map(&qmap);
      sm90::mbar_expect_tx(bars.q_full, L::NB * p.rows * SW);
      for (int c = 0; c < L::NB; ++c)
        sm90::tma_load_4d(smem + c * ROWS * SW, &qmap, bars.q_full, L::DC * c, h * p.g, 0, b);
    }
    if (per < MIN_BOX) {
      stage_chunks<D>(smem, bars, p, kp, vp, b, h, last, k0, n_chunks);
      return;
    }
    // BOX_LANES lanes of the producer warp: lane j looks up the pages of
    // boxes j, j + BOX_LANES, ... of each chunk and issues their loads;
    // lane 0 arms the full barriers first
    const int lane = threadIdx.x - 128;
    if (lane >= BOX_LANES) return;
    constexpr unsigned LANES = BOX_LANES == 32 ? 0xffffffffu : (1u << BOX_LANES) - 1;
    constexpr int NPOS = BK / MIN_BOX / BOX_LANES;   // boxes of a lane at most
    if (lane == 0) {
      sm90::prefetch_map(&kmap);
      sm90::prefetch_map(&vmap);
    }
    const int* trow = p.table + static_cast<long long>(b) * p.MP;
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % L::RING;
      const int kb = k0 + i * BK;
      // the boxes of this chunk that hold keys <= last, each in one page:
      // this lane's page positions first
      const int nbox = min(BK / per, (last - kb) / per + 1);
      int pos[NPOS];
#pragma unroll
      for (int n = 0; n < NPOS; ++n) {
        const int j = lane + n * BOX_LANES;
        if (j < nbox) {
          const int lk = kb + j * per;
          pos[n] = trow[lk / p.ps] * p.ps + lk % p.ps;
        }
      }
      sm90::mbar_wait(&bars.empty[s], ((i / L::RING) & 1) ^ 1);
      for (int kv = 0; kv < 2; ++kv) {          // K, then V
        unsigned char* dst = smem + (kv ? L::V_OFF : L::K_OFF) + s * L::KV_BYTES;
        uint64_t* bar = kv ? &bars.v_full[s] : &bars.k_full[s];
        const CUtensorMap* map = kv ? &vmap : &kmap;
        if (lane == 0) sm90::mbar_expect_tx(bar, static_cast<uint32_t>(nbox * per * D * 2));
        __syncwarp(LANES);
#pragma unroll
        for (int n = 0; n < NPOS; ++n) {
          const int j = lane + n * BOX_LANES;
          if (j < nbox) {
            for (int c = 0; c < L::NB; ++c)
              sm90::tma_load_3d(dst + c * BK * SW + j * per * SW, map, bar, L::DC * c, h, pos[n]);
          }
        }
      }
    }
    return;
  }
  consume<D>(smem, bars, p, b, h, sp, rt, length, last, k0, n_chunks, direct);
}

// Rows of a box of K or V: the most that tile a 64-key chunk and lie in one
// page, gcd(ps, 64) (64 on pages of a multiple of 64, 8 on pages of 24, 16
// on pages of 48, 4 on pages of 12).
inline int box_rows(int ps) { return std::gcd(ps, BK); }

// Whether this body takes the call: bf16 at head dim 32, 64, 128 or 256, any
// page size, at most 64 query rows.  (Alignment is the wrapper's check.)
inline bool takes(int dtype, int head_dim, int ps, int g, int T) {
  return dtype == 0 &&
         (head_dim == 32 || head_dim == 64 || head_dim == 128 || head_dim == 256) &&
         ps >= 1 && g * T <= ROWS && g >= 1 && T >= 1;
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
  p.out = out;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.g = Hq / Hkv;
  p.rows = p.g * T;
  p.tp = T;
  p.n_tiles = 1;
  p.ps = ps;
  p.box = box_rows(ps);
  p.MP = MP;
  p.limit = MP * ps;
  p.scale = scale;
  p.cap = cap;
  plan(B, Hkv, ps, MP, &p.cps, &p.splits);
  if (set_partials(p, scratch, B, D) != 0) return -1;
  // q: (D, Hq, T, B), box (DC, g, T, 1); pools: (D, Hkv, NP * ps), box
  // (DC, 1, gcd(ps, BK)) (not read when the producer stages the chunks)
  CUtensorMap qm, km, vm;
  const long long qd[4] = {D, Hq, T, B};
  const long long qs[3] = {D, static_cast<long long>(Hq) * D, static_cast<long long>(T) * Hq * D};
  const long long kd[3] = {D, Hkv, static_cast<long long>(NP) * ps};
  const long long ks[2] = {D, static_cast<long long>(Hkv) * D};
  const int qb[4] = {L::DC, p.g, T, 1};
  const int kbx[3] = {L::DC, 1, p.box};
  int rc = sm90::make_map_bf16<4>(&qm, q, qd, qs, qb, L::SW);
  if (rc == 0) rc = sm90::make_map_bf16<3>(&km, kp, kd, ks, kbx, L::SW);
  if (rc == 0) rc = sm90::make_map_bf16<3>(&vm, vp, kd, ks, kbx, L::SW);
  if (rc != 0) return rc;
  paged_sm90_kernel<D><<<dim3(p.splits, Hkv, B), NT, L::BYTES, stream>>>(
      qm, km, vm, p, static_cast<const bf16*>(kp), static_cast<const bf16*>(vp));
  return launch_combine<D>(p, B, stream);
}

}  // namespace
}  // namespace paged90
