// Ragged grouped matmul (the MoE down projection) in bf16 on Hopper
// (sm_90a): the body of ragged_gmm_sm90_launch in ragged_gmm.cu.
//
//   out[n] = x[n] @ w[e(n)]    x (N, K) sorted by expert, w (E, K, F)
//
// Work is expert-aligned.  One item is (expert e, row chunk c, column tile
// n): rows [off[e] + c * BM, min(off[e] + (c + 1) * BM, off[e + 1])),
// columns [n * BN, (n + 1) * BN), BM = 64 and BN = 128.  Its rows start
// wherever the expert's do, not at a multiple of BM, so each expert's weight
// tile is read once per chunk of that expert (once for an expert with <= BM
// rows) and an empty expert costs nothing.  The row-tile-aligned visit list of the WMMA kernel
// (ragged.py:make_group_metadata) visits an expert once per BM-row tile its
// rows touch and reads its weights again on each visit.  Rows of a chunk
// past off[e + 1] are loaded (the next expert's rows, or TMA zero fill past
// N) and multiplied, never stored.
//
// The list comes from group_sizes alone, inside the kernel: one warp of
// each block reads the E sizes and writes to shared memory the prefix sums
// of the row offsets and of the items (ceil(size / BM) * tiles_n per
// expert), so the wrapper adds no device op and the number of items stays
// on the device.  Items are numbered expert-major, then column tile, then
// chunk, so the chunks of one expert's column tile are adjacent and run at
// once on neighbouring blocks: their re-reads of the weight tile hit L2.
//
// Mainloop: gmm_capacity.cu's cap90 kernel with one consumer warpgroup.  A
// persistent grid (one block per SM) walks the items; one producer warp
// keeps a ring of STAGES (x 64 x 64, w 64 x BN) tiles full with TMA (x a 2-D
// map over (K, N), w a 3-D map over (F, K, E), 128-byte swizzle); the
// consumer warpgroup runs wgmma m64nBNk16 with x K-major and w MN-major
// through the transpose bit, fp32 accumulators in registers.  The epilogue
// stores rows below off[e + 1] and columns below F straight from the
// accumulators.
//
// Tiles by measurement (PERF.md): 128-row chunks (two consumer warpgroups)
// were no faster at prefill and 8 % slower at verify; 256 columns were
// within 2 % either way.
//
// Internal linkage throughout (see sm90.cuh).

#pragma once

#include "../../csrc/sm90.cuh"

namespace ragged90 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;                       // K per stage: one 128-byte row
constexpr int SW = 128;                      // swizzle bytes (= BK * 2)
constexpr int BM = 64;                       // rows per item: one wgmma m64 tile
constexpr int BN = 128;                      // output columns per item
constexpr int NT = 256;                      // consumer warpgroup + producer warpgroup
constexpr int MAX_E = 512;                   // experts the shared tables hold
constexpr int STAGES = 5;
constexpr int X_BYTES = BM * BK * 2;
constexpr int W_BOX = BK * 64 * 2;           // one 64-column box of w
constexpr int STAGE = X_BYTES + (BN / 64) * W_BOX;
constexpr int BAR_OFF = STAGES * STAGE;
constexpr int META_OFF = BAR_OFF + 2 * STAGES * 8;
// + row offsets (E + 1) and item ends (E), int32, + alignment
constexpr int BYTES = META_OFF + (2 * MAX_E + 1) * 4 + 1024;

struct Item {
  int e, n, row0, row_end;
};

// Item t of the list: binary search of the item ends for its expert.
__device__ __forceinline__ Item item_of(int t, const int* off, const int* item_end, int E,
                                        int tiles_n) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (item_end[mid] > t) hi = mid;
    else lo = mid + 1;
  }
  const int e = lo;
  const int start = e > 0 ? item_end[e - 1] : 0;
  const int chunks = (off[e + 1] - off[e] + BM - 1) / BM;
  const int local = t - start;
  Item it;
  it.e = e;
  it.n = local / chunks;
  it.row0 = off[e] + (local % chunks) * BM;
  it.row_end = off[e + 1];
  return it;
}

__global__ void __launch_bounds__(NT, 1)
ragged_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, bf16* __restrict__ out,
                   const int* __restrict__ sizes, int E, int K, int F, int tiles_n) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  int* off = reinterpret_cast<int*>(smem + META_OFF);
  int* item_end = off + E + 1;
  const int wg = threadIdx.x / 128;

  // ---- the expert-chunk list: prefix sums in warp 0, lane l over a
  // contiguous run of experts
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (E + 31) / 32, e0 = min(lane * per, E), e1 = min(e0 + per, E);
    int rows = 0, items = 0;
    for (int e = e0; e < e1; ++e) {
      const int s = sizes[e];
      rows += s;
      items += (s + BM - 1) / BM * tiles_n;
    }
    int rows_incl = rows, items_incl = items;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int r = __shfl_up_sync(0xffffffffu, rows_incl, o);
      const int i = __shfl_up_sync(0xffffffffu, items_incl, o);
      if (lane >= o) {
        rows_incl += r;
        items_incl += i;
      }
    }
    rows = rows_incl - rows;                 // exclusive: before expert e0
    items = items_incl - items;
    if (lane == 0) off[0] = 0;
    for (int e = e0; e < e1; ++e) {
      const int s = sizes[e];
      rows += s;
      items += (s + BM - 1) / BM * tiles_n;
      off[e + 1] = rows;
      item_end[e] = items;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int n_items = item_end[E - 1];
  const int nk = (K + BK - 1) / BK;

  if (wg == 1) {
    // ---- producer: one thread keeps the ring full, item after item
    if (threadIdx.x == 128) {
      sm90::prefetch_map(&xmap);
      sm90::prefetch_map(&wmap);
      int it = 0;
      for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
        const Item w = item_of(t, off, item_end, E, tiles_n);
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % STAGES;
          sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* st = smem + s * STAGE;
          sm90::mbar_expect_tx(&full[s], STAGE);
          sm90::tma_load_2d(st, &xmap, &full[s], ks * BK, w.row0);
#pragma unroll
          for (int bx = 0; bx < BN / 64; ++bx)
            sm90::tma_load_3d(st + X_BYTES + bx * W_BOX, &wmap, &full[s],
                              w.n * BN + 64 * bx, ks * BK, w.e);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: the item's 64 rows
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float acc[BN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
      const Item w = item_of(t, off, item_end, E, tiles_n);
      int prev = -1;
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t xa = sm90::smem_u32(smem + s * STAGE);
        const uint32_t wa = sm90::smem_u32(smem + s * STAGE + X_BYTES);
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // x: K-major, 16 columns = 32 bytes along the 128-byte row;
          // w: MN-major, 16 rows of 128 bytes, 64-column boxes W_BOX apart
          const uint64_t da = sm90::make_desc(xa + kk * 32, 16, 8 * SW, SW);
          const uint64_t db = sm90::make_desc(wa + kk * 16 * SW, W_BOX, 8 * SW, SW);
          sm90::wgmma_ss_n128<1>(acc, da, db, ks > 0 || kk > 0);
        }
        sm90::wgmma_commit();
        sm90::fence_regs(acc);
        // the previous stage's products are done: hand its tiles back
        sm90::wgmma_wait<1>();
        sm90::fence_regs(acc);
        if (prev >= 0 && tid == 0) sm90::mbar_arrive(&empty[prev]);
        prev = s;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (tid == 0) sm90::mbar_arrive(&empty[prev]);

      // ---- epilogue: this expert's rows, columns < F, from the accumulators
      const int row = w.row0 + warp * 16 + lane / 4;
      const int col = w.n * BN + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = col + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h;
          if (r < w.row_end && c < F)
            *reinterpret_cast<uint32_t*>(out + static_cast<long long>(r) * F + c) =
                sm90::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

int launch(const void* x, const void* w, void* out, const void* sizes, int N, int K, int F,
           int E, cudaStream_t stream) {
  static bool opted_in = false;              // per library
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  CUtensorMap xmap, wmap;
  const long long xd[2] = {K, N}, xs[1] = {K};
  const long long wd[3] = {F, K, E}, ws[2] = {F, static_cast<long long>(K) * F};
  const int xb[2] = {BK, BM}, wb[3] = {64, BK, 1};
  int rc = sm90::make_map_bf16<2>(&xmap, x, xd, xs, xb, SW);
  if (rc == 0) rc = sm90::make_map_bf16<3>(&wmap, w, wd, ws, wb, SW);
  if (rc != 0) return rc;
  const int tiles_n = (F + BN - 1) / BN;
  // items <= (N / BM + E) * tiles_n: no more blocks than that, nor than SMs
  const long long bound = (static_cast<long long>(N) / BM + E) * tiles_n;
  const int grid = static_cast<int>(bound < sm90::sm_count() ? bound : sm90::sm_count());
  ragged_sm90_kernel<<<grid, NT, BYTES, stream>>>(
      xmap, wmap, static_cast<bf16*>(out), static_cast<const int*>(sizes), E, K, F, tiles_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ragged90
