// Ragged grouped matmuls of the MoE expert FFN in bf16 on Hopper (sm_90a):
// the body of ragged_gmm_sm90_launch and fused_gate_up_sm90_launch in
// ragged_gmm.cu.  One kernel, templated on the number of weight matrices:
//
//   NMAT 1 (down):         out[n] = x[n] @ w[e(n)]
//   NMAT 2 (fused gate/up): out[n] = act(x[n] @ wg[e(n)]) * (x[n] @ wu[e(n)])
//
// for x (N, K) sorted by expert and each weight (E, K, F).  act is silu or
// gelu with the tanh approximation (ACT 0 / 1), applied to the fp32
// accumulators; act(g) * u is rounded once to bf16.
//
// Work is expert-aligned.  One item is (expert e, row chunk c, column tile
// n): rows [off[e] + c * BM, min(off[e] + (c + 1) * BM, off[e + 1])),
// columns [n * BN, (n + 1) * BN), BM = 64.  Its rows start wherever the
// expert's do, not at a multiple of BM, so each expert's weight tiles are
// read once per chunk of that expert (once for an expert with <= BM rows)
// and an empty expert costs nothing.  The row-tile-aligned visit list of the
// WMMA kernel (ragged.py:make_group_metadata) visits an expert once per
// BM-row tile its rows touch and reads its weights again on each visit.
// Rows of a chunk past off[e + 1] are loaded (the next expert's rows, or TMA
// zero fill past N) and multiplied, never stored.
//
// The list comes from group_sizes alone, inside the kernel: one warp of
// each block reads the E sizes and writes to shared memory the prefix sums
// of the row offsets and of the items (ceil(size / BM) * tiles_n per
// expert), so the wrapper adds no device op and the number of items stays
// on the device (a CUDA graph replay reads the routing of its run).  Items
// are numbered expert-major, then column tile, then chunk, so the chunks of
// one expert's column tile are adjacent and run at once on neighbouring
// blocks: their re-reads of the weight tiles hit L2.
//
// Mainloop: gmm_capacity.cu's cap90 kernel with one consumer warpgroup.  A
// persistent grid (one block per SM) walks the items; one producer thread
// keeps a ring of STAGES stages full with TMA, each stage the x tile
// (64 x 64, a 2-D map over (K, N)) and the item's 64 x BN tile of every
// weight (3-D maps over (F, K, E)), 128-byte swizzle, one transaction count
// for the stage.  The consumer warpgroup runs, per 16 of K, one wgmma
// m64nBNk16 per weight on the same x descriptor (x K-major, w MN-major
// through the transpose bit), committed as one group, into fp32 accumulators
// in registers: 2 x 64 a thread for the fused product at BN 128, within
// __launch_bounds__(256, 1) without setmaxnreg.  The epilogue stores rows
// below off[e + 1] and columns below F straight from the accumulators; gate
// and up fragments share one layout, so act(g) * u is formed in registers.
//
// What bounds it on an H100: reading the touched experts' weights (~2.35 GB
// of Wg + Wu, ~1.17 GB of w a layer at SD verify against ~60x less time in
// the tensor cores), so the design streams each weight tile once per chunk
// with several stages of loads in flight on every SM.
//
// Tiles by measurement (PERF.md): for the down product, 128-row chunks (two
// consumer warpgroups) were no faster at prefill and 8 % slower at verify;
// 256 columns were within 2 % either way.
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
constexpr int NT = 256;                      // consumer warpgroup + producer warpgroup
constexpr int MAX_E = 512;                   // experts the shared tables hold
constexpr int X_BYTES = BM * BK * 2;
constexpr int W_BOX = BK * 64 * 2;           // one 64-column box of a weight

// Columns per item and stages of the ring, by product (NMAT weights); the
// two products take the same today (kernel_variants.py times others).
template <int NMAT>
struct Tiles {
  static constexpr int BN = NMAT == 1 ? 128 : 128;
  static constexpr int STAGES = NMAT == 1 ? 5 : 5;
  static constexpr int W_BYTES = (BN / 64) * W_BOX;       // one weight's tile
  static constexpr int STAGE = X_BYTES + NMAT * W_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int META_OFF = BAR_OFF + 2 * STAGES * 8;
  // + row offsets (E + 1) and item ends (E), int32, + alignment
  static constexpr int BYTES = META_OFF + (2 * MAX_E + 1) * 4 + 1024;
};

template <int ACT> __device__ __forceinline__ float activate(float g);
template <> __device__ __forceinline__ float activate<0>(float g) {   // silu
  return g / (1.0f + expf(-g));
}
template <> __device__ __forceinline__ float activate<1>(float g) {   // gelu (tanh)
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g)));
}

// D (64 x BN) += A (64 x 16) * B (16 x BN), B MN-major.
template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BN == 64) sm90::wgmma_ss_n64<1>(d, da, db, scale_d);
  else if constexpr (BN == 128) sm90::wgmma_ss_n128<1>(d, da, db, scale_d);
  else sm90::wgmma_ss_n256<1>(d, da, db, scale_d);
}

struct Item {
  int e, n, row0, row_end;
};

// The item list's tables, by warp 0 into shared memory: off[e] the first
// row of expert e (off[E] = N), item_end[e] the items of experts 0..e.
// Lane l sums a contiguous run of experts, then a shuffle scan.
__device__ __forceinline__ void build_items(const int* __restrict__ sizes, int E, int tiles_n,
                                            int* off, int* item_end) {
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
  rows = rows_incl - rows;                   // exclusive: before expert e0
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

// wmap: w (down) or wg (fused); umap: wu (fused; unused by the down product).
template <int NMAT, int ACT>
__global__ void __launch_bounds__(NT, 1)
ragged_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap umap, bf16* __restrict__ out,
                   const int* __restrict__ sizes, int E, int K, int F, int tiles_n) {
  using L = Tiles<NMAT>;
  constexpr int BN = L::BN, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  int* off = reinterpret_cast<int*>(smem + L::META_OFF);
  int* item_end = off + E + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x < 32) build_items(sizes, E, tiles_n, off, item_end);
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
      if (NMAT == 2) sm90::prefetch_map(&umap);
      int it = 0;
      for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
        const Item w = item_of(t, off, item_end, E, tiles_n);
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % STAGES;
          sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* st = smem + s * L::STAGE;
          sm90::mbar_expect_tx(&full[s], L::STAGE);
          sm90::tma_load_2d(st, &xmap, &full[s], ks * BK, w.row0);
#pragma unroll
          for (int m = 0; m < NMAT; ++m)
#pragma unroll
            for (int bx = 0; bx < BN / 64; ++bx)
              sm90::tma_load_3d(st + X_BYTES + m * L::W_BYTES + bx * W_BOX,
                                m == 0 ? &wmap : &umap, &full[s], w.n * BN + 64 * bx,
                                ks * BK, w.e);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: the item's 64 rows
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float acc[NMAT][BN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
      const Item w = item_of(t, off, item_end, E, tiles_n);
      int prev = -1;
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t xa = sm90::smem_u32(smem + s * L::STAGE);
        const uint32_t wa = sm90::smem_u32(smem + s * L::STAGE + X_BYTES);
#pragma unroll
        for (int m = 0; m < NMAT; ++m) sm90::fence_regs(acc[m]);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // x: K-major, 16 columns = 32 bytes along the 128-byte row;
          // w: MN-major, 16 rows of 128 bytes, 64-column boxes W_BOX apart
          const uint64_t da = sm90::make_desc(xa + kk * 32, 16, 8 * SW, SW);
#pragma unroll
          for (int m = 0; m < NMAT; ++m) {
            const uint64_t db =
                sm90::make_desc(wa + m * L::W_BYTES + kk * 16 * SW, W_BOX, 8 * SW, SW);
            wgmma_bn<BN>(acc[m], da, db, ks > 0 || kk > 0);
          }
        }
        sm90::wgmma_commit();
#pragma unroll
        for (int m = 0; m < NMAT; ++m) sm90::fence_regs(acc[m]);
        // the previous stage's products are done: hand its tiles back
        sm90::wgmma_wait<1>();
#pragma unroll
        for (int m = 0; m < NMAT; ++m) sm90::fence_regs(acc[m]);
        if (prev >= 0 && tid == 0) sm90::mbar_arrive(&empty[prev]);
        prev = s;
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < NMAT; ++m) sm90::fence_regs(acc[m]);
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
          if (r < w.row_end && c < F) {
            const int i = 4 * j + 2 * h;
            float v0 = acc[0][i], v1 = acc[0][i + 1];
            if constexpr (NMAT == 2) {
              v0 = activate<ACT>(v0) * acc[1][i];
              v1 = activate<ACT>(v1) * acc[1][i + 1];
            }
            *reinterpret_cast<uint32_t*>(out + static_cast<long long>(r) * F + c) =
                sm90::pack_bf16(v0, v1);
          }
        }
      }
    }
  }
}

// x (N, K); w and u (E, K, F), u read only when NMAT is 2; out (N, F).
template <int NMAT, int ACT>
int launch(const void* x, const void* w, const void* u, void* out, const void* sizes, int N,
           int K, int F, int E, cudaStream_t stream) {
  using L = Tiles<NMAT>;
  static bool opted_in = false;              // per instantiation and library
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_sm90_kernel<NMAT, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  CUtensorMap xmap, wmap, umap;
  const long long xd[2] = {K, N}, xs[1] = {K};
  const long long wd[3] = {F, K, E}, ws[2] = {F, static_cast<long long>(K) * F};
  const int xb[2] = {BK, BM}, wb[3] = {64, BK, 1};
  int rc = sm90::make_map_bf16<2>(&xmap, x, xd, xs, xb, SW);
  if (rc == 0) rc = sm90::make_map_bf16<3>(&wmap, w, wd, ws, wb, SW);
  if (NMAT == 2 && rc == 0) rc = sm90::make_map_bf16<3>(&umap, u, wd, ws, wb, SW);
  if (NMAT == 1) umap = wmap;
  if (rc != 0) return rc;
  const int tiles_n = (F + L::BN - 1) / L::BN;
  // items <= (N / BM + E) * tiles_n: no more blocks than that, nor than SMs
  const long long bound = (static_cast<long long>(N) / BM + E) * tiles_n;
  const int grid = static_cast<int>(bound < sm90::sm_count() ? bound : sm90::sm_count());
  ragged_sm90_kernel<NMAT, ACT><<<grid, NT, L::BYTES, stream>>>(
      xmap, wmap, umap, static_cast<bf16*>(out), static_cast<const int*>(sizes), E, K, F,
      tiles_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ragged90
