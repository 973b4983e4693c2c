// Dense decode / SD-verify attention in bf16 on Hopper (sm_90a): the body of
// the bf16 path of decode_attention.cu at head dims 32, 64, 128 and 256, at
// any T and up to 64 query heads per KV head.
//
//   out[b, t, h*g + i] = softmax_s( cap(q . k[b, s, h] * scale)
//                                   | s <= lengths[b] + t, s < S ) . v[b, :, h]
//
// The split-KV grid, the row tiles, the consumer warpgroup (both products
// as wgmma, the online softmax in registers), the split partials and their
// combine are kernels/csrc/splitkv_sm90.cuh's, shared with the paged body
// (paged_sm90.cuh).  What is dense is the producer and the split plan:
//   * Splits: plan() over S, so that at long context (S 8192) B * Hkv *
//     splits fills the SMs once, and at the serve shape (S 512, lengths
//     129-290) one split holds every key and one kernel runs (MIN_CHUNKS
//     chunks a split at least; MIN_CHUNKS_256 at head dim 256).  At D 256
//     (one block an SM: Cfg<256> takes 230,480 B) a split holds 32 chunks
//     at least, so gemma3-12b's B 8 x Hkv 8 at S 2048 runs one split, 64
//     blocks and no combine: 6-15 % faster than two splits of 16 chunks
//     (128 blocks and the combine) and 11-20 % faster than four at gemma3's
//     lengths (PERF.md section 6).  gemma-7b's 8 x 16 pairs run one split
//     either way.
//   * K and V: a 4-D tensor map over the cache as (D, Hkv, S, B) with the
//     strides the wrapper hands over, so the model's (B, S+1, Hkv, D) cache
//     sliced to S is read in place: batch stride (S+1) * Hkv * D, and the
//     trash slot S lies outside the map, so TMA never reads it (a box
//     reaching past S is zero fill).  One box of 64 columns x 1 head x 64
//     positions x 1 sequence per 64 columns of a chunk; chunks that start
//     past length + T - 1 are never loaded (at D 32 one box of 32 columns, a
//     64-byte row, in the 64-byte swizzle).  Rows of the last chunk past
//     length + T - 1 are masked in the scores and zeroed in shared memory
//     (splitkv::consume).
//   * q is read in place through its strides too: one 4-D box (64, g, tp, 1)
//     at step t0 over (D, Hq, T, B) per 64 columns (four at D 256) lands a
//     row tile's g * npos rows in one m64 tile.  With more than 64 rows a
//     KV head (a verify at gamma >= 9 on qwen2-57b-a14b's g 7, >= 16 on
//     mixtral's g 4, >= 32 on gemma3's g 2) the grid holds splits x
//     n_tiles blocks a (KV head, sequence), a split's tiles side by side.
//
// Internal linkage throughout (see sm90.cuh).

#pragma once

#include "../../csrc/splitkv_sm90.cuh"

namespace decode90 {
namespace {

using namespace splitkv;

constexpr int MIN_CHUNKS = 8;                // chunks a split holds at least
constexpr int MIN_CHUNKS_256 = 32;           // the same at head dim 256
constexpr int WAVES = 1;                     // blocks per SM the split count aims at

// Chunks per split and number of splits for a cache of S positions, over
// the B * Hkv * n_tiles row tiles (a split's tiles share its K/V reads in
// L2, so at 8k keys two tiles of a verify run half as many splits each).
inline void plan(int B, int Hkv, int S, int head_dim, int n_tiles, int* cps, int* splits) {
  splitkv::plan(B * n_tiles, Hkv, S, head_dim == 256 ? MIN_CHUNKS_256 : MIN_CHUNKS, WAVES,
                cps, splits);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
decode_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const Params p) {
  using L = Cfg<D>;
  const int sp = blockIdx.x / p.n_tiles, h = blockIdx.y, b = blockIdx.z;
  const RowTile rt = row_tile(p, blockIdx.x % p.n_tiles);
  // the partial entry's keys start at position k_off: local key i is
  // position k_off + i, so a row's length shifts by -k_off (and may fall
  // below 0: that row sees no key of the block)
  const int base = p.lengths[b] - p.k_off + rt.t0;   // the tile's first query
  const int last = last_key(base, rt.npos, p.limit);
  const int k0 = sp * p.cps * BK;
  if (k0 > last) return;                     // nothing of this split is visible
  const int n_chunks = min(p.cps, (last - k0) / BK + 1);
  // split 0 holds every live key of the tile; the partial entry always merges
  const bool direct = p.lse == nullptr && last < p.cps * BK;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  const Bars bars = init_bars<D>(smem);

  if (threadIdx.x >= 128) {
    // ---- producer: one thread keeps the ring full
    if (threadIdx.x != 128) return;
    sm90::prefetch_map(&qmap);
    sm90::prefetch_map(&kmap);
    sm90::prefetch_map(&vmap);
    constexpr int SW = L::SW;
    sm90::mbar_expect_tx(bars.q_full, L::NB * p.g * p.tp * SW);   // steps past T: zero fill
    for (int c = 0; c < L::NB; ++c)
      sm90::tma_load_4d(smem + c * ROWS * SW, &qmap, bars.q_full, L::DC * c, h * p.g, rt.t0, b);
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % L::RING;
      const int kb = k0 + i * BK;            // the chunk's first key
      sm90::mbar_wait(&bars.empty[s], ((i / L::RING) & 1) ^ 1);
      for (int kv = 0; kv < 2; ++kv) {          // K, then V
        unsigned char* dst = smem + (kv ? L::V_OFF : L::K_OFF) + s * L::KV_BYTES;
        uint64_t* bar = kv ? &bars.v_full[s] : &bars.k_full[s];
        const CUtensorMap* map = kv ? &vmap : &kmap;
        sm90::mbar_expect_tx(bar, L::KV_BYTES);   // zero fill past S counts too
        for (int c = 0; c < L::NB; ++c)
          sm90::tma_load_4d(dst + c * BK * SW, map, bar, L::DC * c, h, kb, b);
      }
    }
    return;
  }
  consume<D>(smem, bars, p, b, h, sp, rt, base, last, k0, n_chunks, direct);
}

// Whether this body takes the call: bf16 at head dim 32, 64, 128 or 256, any
// T and at most 64 query heads per KV head (one query position's rows fit a
// tile).  (Strides and alignment are the wrapper's check.)
inline bool takes(int dtype, int head_dim, int g, int T) {
  return dtype == 0 &&
         (head_dim == 32 || head_dim == 64 || head_dim == 128 || head_dim == 256) &&
         g >= 1 && g <= ROWS && T >= 1;
}

// Bytes of scratch a call needs: the split partials, 0 with one split
// (the partial entry's, with any number of splits).
inline long long scratch_bytes(int head_dim, int B, int T, int Hq, int Hkv, int S,
                               bool partial = false) {
  int tp = 0, n_tiles = 0, cps = 0, splits = 0;
  row_tiles(Hq / Hkv, T, &tp, &n_tiles);
  plan(B, Hkv, S, head_dim, n_tiles, &cps, &splits);
  if (partial)
    return static_cast<long long>(B) * Hkv * splits * (Hq / Hkv) * T * (head_dim + 2) * 4;
  return splitkv::scratch_bytes(head_dim, B, Hkv, (Hq / Hkv) * T, splits);
}

// st: 12 element strides, q (b, t, h), k (b, s, h), v (b, s, h), out (b, t,
// h); out must be contiguous (B, T, Hq, D).
// The partial entry (lse non-null): keys are positions k_off .. k_off + S -
// 1, every live split goes to scratch and combine_kernel writes the
// output and the log-sum-exp.
template <int D>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           void* scratch, const long long* st, int B, int T, int S, int Hq, int Hkv,
           float scale, float cap, cudaStream_t stream, float* lse = nullptr,
           int k_off = 0) {
  using L = Cfg<D>;
  static bool opted_in = false;              // per instantiation, per library
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  if (st[11] != D || st[10] != static_cast<long long>(Hq) * D ||
      st[9] != static_cast<long long>(T) * Hq * D)
    return -1;
  Params p{};
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.g = Hq / Hkv;
  p.rows = p.g * T;
  row_tiles(p.g, T, &p.tp, &p.n_tiles);
  p.limit = S;
  p.scale = scale;
  p.cap = cap;
  p.lse = lse;
  p.k_off = k_off;
  plan(B, Hkv, S, D, p.n_tiles, &p.cps, &p.splits);
  if (set_partials(p, scratch, B, D) != 0) return -1;
  // dims (D, heads, positions, batch); strides of heads, positions, batch
  CUtensorMap qm, km, vm;
  const long long qd[4] = {D, Hq, T, B}, kd[4] = {D, Hkv, S, B};
  const long long qs[3] = {st[2], st[1], st[0]}, ks[3] = {st[5], st[4], st[3]},
                  vs[3] = {st[8], st[7], st[6]};
  const int qb[4] = {L::DC, p.g, p.tp, 1}, kb[4] = {L::DC, 1, BK, 1};
  int rc = sm90::make_map_bf16<4>(&qm, q, qd, qs, qb, L::SW);
  if (rc == 0) rc = sm90::make_map_bf16<4>(&km, k, kd, ks, kb, L::SW);
  if (rc == 0) rc = sm90::make_map_bf16<4>(&vm, v, kd, vs, kb, L::SW);
  if (rc != 0) return rc;
  decode_sm90_kernel<D>
      <<<dim3(p.splits * p.n_tiles, Hkv, B), NT, L::BYTES, stream>>>(qm, km, vm, p);
  return launch_combine<D>(p, B, stream);
}

}  // namespace
}  // namespace decode90
