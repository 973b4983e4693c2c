// Ragged grouped matmuls of the MoE expert FFN in bf16 on Hopper (sm_90a):
// the bf16 body of ragged_launch in ragged_gmm.cu.  One kernel, templated
// on the number of weight matrices:
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
// and an empty expert costs nothing.  A row-tile-aligned visit list
// (ragged.py:make_group_metadata, the reference's grid) visits an expert
// once per BM-row tile its rows touch and reads its weights again on each
// visit.  Rows of a chunk past off[e + 1] are loaded (the next expert's
// rows, or zeros past N) and multiplied, never stored.
//
// The list comes from group_sizes alone, inside the kernel: one warp of
// each block reads the sizes and writes to shared memory the prefix sums
// of the row offsets and of the items (ceil(size / BM) * tiles_n per
// expert), so the wrapper adds no device op and the number of items stays
// on the device (a CUDA graph replay reads the routing of its run).  Items
// are numbered expert-major, then column tile, then chunk, so the chunks of
// one expert's column tile are adjacent and run at once on neighbouring
// blocks: their re-reads of the weight tiles hit L2.  The tables hold
// MAX_E experts: a call over more experts is launched once per window of
// MAX_E experts (launch()), each launch's warp first summing the rows of
// the experts before its window; at E <= MAX_E that is one launch.
//
// Mainloop: gmm_capacity.cu's cap90 kernel with one consumer warpgroup.  A
// persistent grid (one block per SM) walks the items; the producer
// warpgroup keeps a ring of STAGES stages full, each stage the x tile
// (64 x 64) and the item's 64 x BN tile of every weight, in the 128-byte
// swizzle.  The consumer warpgroup runs, per 16 of K, one wgmma m64nBNk16
// per weight on the same x descriptor (x K-major, w MN-major through the
// transpose bit), committed as one group, into fp32 accumulators in
// registers: 2 x 64 a thread for the fused product at BN 128, within
// __launch_bounds__(256, 1) without setmaxnreg.  The epilogue stores rows
// below off[e + 1] and columns below F straight from the accumulators; gate
// and up fragments share one layout, so act(g) * u is formed in registers.
//
// The producer has two modes (STAGED), chosen by launch() from the
// operands, both writing the same layout for the same consumer:
//   * STAGED 0, whenever TMA can address x and every weight (K and F
//     multiples of 8, 16-byte aligned bases, out 4-byte aligned): one
//     thread issues each stage as TMA loads, the x tile through a 2-D map
//     over (K, N) and each weight's tile through 3-D maps over (F, K, E),
//     with one transaction count for the stage; TMA fills zeros past N, K
//     and F.
//   * STAGED 1, any other shape or base (K or F not a multiple of 8, an
//     operand off 16 bytes): one thread still loads by TMA the operands TMA
//     can address (x, or both weights), and the warpgroup's 128 threads
//     stage the others by hand (../../csrc/stage_sm90.cuh, shared with
//     gmm_capacity.cu's staged producer), each 16-byte
//     unit of a tile with the widest copy its source's alignment allows:
//     cp.async of 16, 8 or 4 bytes, or, for a unit 2 bytes off 4 (or cut
//     by K or F), two aligned 16-byte loads shifted into place in
//     registers; written into the swizzle TMA writes (sm90::swizzled) with
//     zeros past N, K and F.  No producer thread waits for its copies: the
//     stage's full barrier expects an arrival from each of the 4 warps,
//     after its stores (fenced for the async proxy, the wgmma reads), and
//     the completion of each thread's copies (cp.async.mbarrier.arrive, as
//     CUTLASS's cp.async + GMMA mainloop, no fence for those).  A unit's
//     register loads are issued before the wait for its ring slot.  The
//     epilogue stores element by element where F or out's base leaves a
//     bf16 pair unaligned, and masks F per element.  (TMA boxes from a map
//     over a base rounded down to 16 bytes, started at the offset's column,
//     never completed: the operands off 16 bytes are staged by hand.)
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
#include "../../csrc/stage_sm90.cuh"

namespace ragged90 {
namespace {

using bf16 = __nv_bfloat16;
using stage90::BoxRegs;
using stage90::stage_box_issue;
using stage90::stage_box_store;

constexpr int BK = 64;                       // K per stage: one 128-byte row
constexpr int SW = 128;                      // swizzle bytes (= BK * 2)
constexpr int BM = 64;                       // rows per item: one wgmma m64 tile
constexpr int NT = 256;                      // consumer warpgroup + producer warpgroup
constexpr int MAX_E = 512;                   // experts the shared tables hold (a window)
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

// The staged producer's operands (STAGED 1; unused by the TMA producer).
struct Staged {
  const bf16* x;                             // (N, K)
  const bf16* w;                             // (E, K, F): w, or wg
  const bf16* u;                             // (E, K, F): wu (fused), else w
  int N;
  int x_tma, w_tma;                          // TMA can address x; both weights
  int out_pairs;                             // bf16 pairs of out 4-byte aligned
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
  int e, n, row0, row_end;                   // e within the launch's window
};

// The item list's tables, by warp 0 into shared memory, for the window of
// E experts from e0: off[e] the first row of expert e0 + e (off[E] its
// end), item_end[e] the items of the window's experts 0..e.  The lanes
// first sum the rows of the experts before the window; then lane l sums a
// contiguous run of the window's experts, and a shuffle scan.
__device__ __forceinline__ void build_items(const int* __restrict__ sizes, int e0, int E,
                                            int tiles_n, int* off, int* item_end) {
  const int lane = threadIdx.x;
  int base = 0;
  for (int e = lane; e < e0; e += 32) base += sizes[e];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) base += __shfl_xor_sync(0xffffffffu, base, o);
  sizes += e0;
  const int per = (E + 31) / 32, e_lo = min(lane * per, E), e_hi = min(e_lo + per, E);
  int rows = 0, items = 0;
  for (int e = e_lo; e < e_hi; ++e) {
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
  rows = base + rows_incl - rows;            // exclusive: before expert e_lo
  items = items_incl - items;
  if (lane == 0) off[0] = base;
  for (int e = e_lo; e < e_hi; ++e) {
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

// wmap: w (down) or wg (fused); umap: wu (fused; unused by the down
// product).  The maps are read by the TMA producer (STAGED 0), st by the
// staged one.  sizes: the group sizes of every expert; the launch covers
// the E experts from e0.
template <int NMAT, int ACT, int STAGED>
__global__ void __launch_bounds__(NT, 1)
ragged_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap umap, const Staged st,
                   bf16* __restrict__ out, const int* __restrict__ sizes, int e0, int E,
                   int K, int F, int tiles_n) {
  using L = Tiles<NMAT>;
  constexpr int BN = L::BN, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  int* off = reinterpret_cast<int*>(smem + L::META_OFF);
  int* item_end = off + E + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x < 32) build_items(sizes, e0, E, tiles_n, off, item_end);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], STAGED ? 4 : 1);   // staged: each producer warp
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int n_items = item_end[E - 1];
  const int nk = (K + BK - 1) / BK;

  if (wg == 1) {
    if constexpr (STAGED != 0) {
      // ---- staged producer: the warpgroup copies each stage, item after
      // item; the stage's full barrier (count 4) takes an arrival from each
      // warp after its threads' stores, and waits for each thread's cp.async
      // copies (cp.async.mbarrier.arrive), so no thread waits for its copies
      const int pt = threadIdx.x - 128, lane = pt % 32;
      const long long wstride = static_cast<long long>(K) * F;
      if (pt == 0) {
        if (st.x_tma) sm90::prefetch_map(&xmap);
        if (st.w_tma) {
          sm90::prefetch_map(&wmap);
          if (NMAT == 2) sm90::prefetch_map(&umap);
        }
      }
      int it = 0;
      for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
        const Item w = item_of(t, off, item_end, E, tiles_n);
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % STAGES;
          unsigned char* stg = smem + s * L::STAGE;
          const int k0 = ks * BK;
          // the boxes staged by hand this stage: x (bit 0), weight box bx of
          // matrix m (bit 1 + m * (BN / 64) + bx)
          const uint32_t by_hand =
              (st.x_tma ? 0u : 1u) | (st.w_tma ? 0u : ((1u << (NMAT * (BN / 64))) - 1) << 1);
          // x's register loads go before the wait for the slot, and stay in
          // flight while the other copies go
          BoxRegs xr, wr;
          if (by_hand & 1)
            stage_box_issue<true>(stg, st.x, K, w.row0, st.N - w.row0, k0, K - k0, pt, xr);
          sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          if (pt == 0) {
            // the rest by TMA, its bytes expected before the loads (this
            // thread's arrival comes after its copies below)
            const int tma_boxes = NMAT * (BN / 64) - __popc(by_hand >> 1);
            const uint32_t bytes = (by_hand & 1 ? 0 : X_BYTES) + tma_boxes * W_BOX;
            if (bytes) sm90::mbar_expect(&full[s], bytes);
            if (!(by_hand & 1)) sm90::tma_load_2d(stg, &xmap, &full[s], k0, w.row0);
#pragma unroll
            for (int m = 0; m < NMAT; ++m)
#pragma unroll
              for (int bx = 0; bx < BN / 64; ++bx)
                if (!(by_hand >> (1 + m * (BN / 64) + bx) & 1))
                  sm90::tma_load_3d(stg + X_BYTES + m * L::W_BYTES + bx * W_BOX,
                                    m == 0 ? &wmap : &umap, &full[s], w.n * BN + 64 * bx, k0,
                                    e0 + w.e);
          }
          bool stored = false, copied = false;
          if (by_hand & 1)
            copied = stage_box_issue<false>(stg, st.x, K, w.row0, st.N - w.row0, k0, K - k0,
                                            pt, xr);
#pragma unroll
          for (int m = 0; m < NMAT; ++m)
#pragma unroll
            for (int bx = 0; bx < BN / 64; ++bx) {
              if (!(by_hand >> (1 + m * (BN / 64) + bx) & 1)) continue;
              const int col0 = w.n * BN + 64 * bx;
              const int n_cols = F - col0;
              unsigned char* box = stg + X_BYTES + m * L::W_BYTES + bx * W_BOX;
              const bf16* src = (m == 0 ? st.w : st.u) + (e0 + w.e) * wstride;
              stage_box_issue<true>(box, src, F, k0, K - k0, col0, n_cols, pt, wr);
              copied |= stage_box_issue<false>(box, src, F, k0, K - k0, col0, n_cols, pt, wr);
              stored |= stage_box_store(box, src, F, k0, K - k0, col0, n_cols, pt, wr);
            }
          if (by_hand & 1)
            stored |= stage_box_store(stg, st.x, K, w.row0, st.N - w.row0, k0, K - k0, pt, xr);
          // this thread's stores (generic proxy) before the wgmma reads of
          // them (async proxy); its cp.async copies take no fence.  The
          // barrier waits for each thread's copies, and takes one arrival
          // from each warp after its stores
          if (stored) sm90::fence_proxy_async();
          if (copied) sm90::cp_async_arrive(&full[s]);
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&full[s]);
        }
      }
      sm90::cp_async_wait<0>();              // no thread leaves with copies in flight
    } else if (threadIdx.x == 128) {
      // ---- TMA producer: one thread keeps the ring full, item after item
      sm90::prefetch_map(&xmap);
      sm90::prefetch_map(&wmap);
      if (NMAT == 2) sm90::prefetch_map(&umap);
      int it = 0;
      for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
        const Item w = item_of(t, off, item_end, E, tiles_n);
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % STAGES;
          sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* stg = smem + s * L::STAGE;
          sm90::mbar_expect_tx(&full[s], L::STAGE);
          sm90::tma_load_2d(stg, &xmap, &full[s], ks * BK, w.row0);
#pragma unroll
          for (int m = 0; m < NMAT; ++m)
#pragma unroll
            for (int bx = 0; bx < BN / 64; ++bx)
              sm90::tma_load_3d(stg + X_BYTES + m * L::W_BYTES + bx * W_BOX,
                                m == 0 ? &wmap : &umap, &full[s], w.n * BN + 64 * bx,
                                ks * BK, e0 + w.e);
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
            bf16* o = out + static_cast<long long>(r) * F + c;
            if (!STAGED || (st.out_pairs && c + 1 < F)) {
              *reinterpret_cast<uint32_t*>(o) = sm90::pack_bf16(v0, v1);
            } else {
              o[0] = __float2bfloat16_rn(v0);
              if (c + 1 < F) o[1] = __float2bfloat16_rn(v1);
            }
          }
        }
      }
    }
  }
}

// One instantiation's launches: a window of at most MAX_E experts each.
template <int NMAT, int ACT, int STAGED>
int launch_mode(const CUtensorMap& xmap, const CUtensorMap& wmap, const CUtensorMap& umap,
                const Staged& st, void* out, const void* sizes, int N, int K, int F, int E,
                cudaStream_t stream) {
  using L = Tiles<NMAT>;
  static bool opted_in = false;              // per instantiation and library
  if (!opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(ragged_sm90_kernel<NMAT, ACT, STAGED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int tiles_n = (F + L::BN - 1) / L::BN;
  for (int e0 = 0; e0 < E; e0 += MAX_E) {
    const int ew = E - e0 < MAX_E ? E - e0 : MAX_E;
    // items <= (N / BM + ew) * tiles_n: no more blocks than that, nor than SMs
    const long long bound = (static_cast<long long>(N) / BM + ew) * tiles_n;
    const int grid = static_cast<int>(bound < sm90::sm_count() ? bound : sm90::sm_count());
    ragged_sm90_kernel<NMAT, ACT, STAGED><<<grid, NT, L::BYTES, stream>>>(
        xmap, wmap, umap, st, static_cast<bf16*>(out), static_cast<const int*>(sizes), e0, ew,
        K, F, tiles_n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Launches of a call over E experts (one per window of MAX_E).
inline int launches(int E) { return (E + MAX_E - 1) / MAX_E; }

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// x (N, K); w and u (E, K, F), u read only when NMAT is 2; out (N, F).
// *staged is set to 1 when the launch takes the staged producer.
template <int NMAT, int ACT>
int launch(const void* x, const void* w, const void* u, void* out, const void* sizes, int N,
           int K, int F, int E, cudaStream_t stream, int* staged) {
  const bf16* ub = static_cast<const bf16*>(NMAT == 2 ? u : w);
  const Staged st{static_cast<const bf16*>(x), static_cast<const bf16*>(w), ub, N,
                  K % 8 == 0 && aligned16(x), F % 8 == 0 && aligned16(w) && aligned16(ub),
                  F % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0};
  // the TMA producer when TMA can address every operand (and out's bf16
  // pairs are aligned), else the staged one
  const bool staged_mode = !(st.x_tma && st.w_tma && reinterpret_cast<uintptr_t>(out) % 4 == 0);
  // tensor maps for the operands TMA can address (every one in TMA mode)
  CUtensorMap xmap{}, wmap{}, umap{};
  const long long xd[2] = {K, N}, xs[1] = {K};
  const long long wd[3] = {F, K, E}, ws[2] = {F, static_cast<long long>(K) * F};
  const int xbox[2] = {BK, BM}, wbox[3] = {64, BK, 1};
  int rc = st.x_tma ? sm90::make_map_bf16<2>(&xmap, x, xd, xs, xbox, SW) : 0;
  if (rc == 0 && st.w_tma) rc = sm90::make_map_bf16<3>(&wmap, w, wd, ws, wbox, SW);
  if (rc == 0 && st.w_tma && NMAT == 2) rc = sm90::make_map_bf16<3>(&umap, u, wd, ws, wbox, SW);
  if (NMAT == 1) umap = wmap;
  if (rc != 0) return rc;
  *staged = staged_mode;
  return staged_mode
             ? launch_mode<NMAT, ACT, 1>(xmap, wmap, umap, st, out, sizes, N, K, F, E, stream)
             : launch_mode<NMAT, ACT, 0>(xmap, wmap, umap, st, out, sizes, N, K, F, E, stream);
}

}  // namespace
}  // namespace ragged90
