// Capacity-binned grouped matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _gmm_kernel of src/repro/kernels/gmm/gmm.py
// (called through gmm_capacity): tokens dispatched to fixed-capacity expert
// bins run through one batched product,
//
//   out[e] = x[e] @ w[e]        x (E, C, K), w (E, K, F) -> (E, C, F)
//
// accumulated in fp32 and cast to x's dtype at emit.
//
// What bounds it on an H100: at the SD-verify capacity of the full-width
// expert FFN (E 64, C 128, K 3584, F 2560, bf16) a call reads ~1.17 GB of
// weights and ~59 MB of bins against ~150 GFLOP: the bytes take ~0.38 ms at
// 3.35 TB/s and the operations ~0.15 ms at the bf16 tensor-core peak, so it is
// memory bound; at a prefill capacity of 512 the operations (~600 GFLOP,
// ~0.61 ms) pass the bytes and it is compute bound.  Either way the products
// have to run on the tensor cores and each weight tile should be read from
// device memory as few times as the bins allow.
//
// Two bodies, one per element type (the wrapper, gmm.py, _route), each
// taking any K, F and base:
//
//   * gmm_capacity_sm90_kernel<NC, BN, STAGED>, every bf16 call: TMA +
//     wgmma.
//       - A block tile is 64 * NC rows x BN columns: NC = 2 consumer
//         warpgroups (one for bins of at most 64 rows), each running
//         wgmma m64nBNk16 with its fp32 accumulators in registers.  At
//         C <= 128 one row tile covers a whole bin, so each weight tile is
//         read from device memory once, and BN = 128 (the call is bound by
//         the weight bytes; more, smaller tiles fill the 132 SMs).  Above,
//         the call is bound by the products and BN = 256 halves the
//         shared-memory reads of x per operation (PERF.md has both times).
//       - The producer warpgroup fills a ring of STAGES (5 at BN 128, 4 at
//         256) of (x 64*NC x 64, w 64 x BN) tiles over K, completion on
//         full/empty mbarriers, and gives registers to the consumers
//         (setmaxnreg).  x is K-major; w is MN-major (F contiguous), read
//         with wgmma's transpose bit, so nothing is transposed in memory.
//       - STAGED 0, whenever TMA can address both operands (K and F
//         multiples of 8 elements, 16-byte aligned bases, out's bf16 pairs
//         aligned): one producer thread issues each stage as TMA loads
//         through 3-D maps over (K, C, E) and (F, K, E); rows past C in a
//         bin and columns past K or F are TMA zero fill, never another
//         expert's.
//       - STAGED 1, any other shape or base: one thread still loads by TMA
//         the operand TMA can address, and the warpgroup's 128 threads
//         stage the other by hand (../../csrc/stage_sm90.cuh, shared with
//         kernels 1-2's staged producer): each 16-byte unit with the widest
//         cp.async its source allows, or through registers shifted into
//         place, into the swizzle TMA writes, zeros past C, K and F, so the
//         consumers and their descriptors are the same.  x's tile is NC
//         boxes of 64 rows, w's BN / 64 boxes of 64 columns.  A register
//         unit takes one load, the next chunk coming from the neighbouring
//         lane by shuffles, and a box inside the operand's edges whose
//         units all sit 2 bytes off 4 (one element off a 16-byte base) is
//         staged without per-unit tests (stage_box_load / _store1): the
//         staging is instruction-bound on one warpgroup, and these with
//         the wider tile below took x 2 bytes off at C 128 from 2.10 to
//         0.53 ms (PERF.md).  A stage's
//         register loads go out before its wait for the slot.  No producer
//         thread waits for its copies: the stage's full barrier takes an
//         arrival from each of the 4 producer warps after its stores and
//         the completion of each thread's copies (cp.async.mbarrier.arrive).
//         With x staged, bins of 65 to 128 rows take BN = 256: each x tile
//         is staged once per column tile, so wider tiles halve that work.
//         The epilogue stores element by element where F or out's base
//         leaves a bf16 pair unaligned.  (No map over a base rounded down
//         to 16 bytes is built: a TMA box from one never completes.)
//       - The epilogue stores rows < C and columns < F straight from the
//         accumulators.  A persistent grid (one block per SM) walks the
//         (expert, column tile, row tile) list with the row tiles of one
//         (expert, column tile) adjacent, so at C = 512 four neighbouring
//         blocks read the same weight tile at once and three of the four
//         reads hit L2.
//   * gmm_capacity_simt90_kernel<BM, XV, WV>, every fp32 call (the parity
//     checks and the ops path).  Full fp32 on the CUDA cores (fmaf, no
//     TF32), so the bound is operations at 67 TFLOP/s: 2.2 ms at the
//     SD-verify capacity, against 0.7 ms of bytes.
//       - A block tile is 128 x 128 outputs (64 x 128 for bins of at most 64
//         rows), 256 threads of 8 x 8 (4 x 8) outputs each: thread (ty, tx)
//         owns rows 4 ty + 64 g + {0..3} and columns 4 tx + 64 h + {0..3}.
//       - x is staged K-major, w row-major, so each k step is two float4
//         reads of x and two of w for 64 FMAs.  An SM issues 4 warp
//         instructions a cycle, as many as its FMA units take, so every
//         other instruction costs an FMA: x goes through registers (4 rows
//         a thread, loaded two tiles ahead, stored as 4 float4s of the
//         transposed tile after this tile's FMAs), which measured 12-14 %
//         faster than per-element cp.async copies of it (PERF.md, section
//         6).
//       - A ring of 3 stages of BK = 32 (100 KB, two blocks an SM); w's
//         tile arrives by cp.async, in flight two stages ahead, with one
//         barrier a stage.
//       - Each operand at its own width: w in 16-byte cp.async pieces (WV
//         4) where F and its base keep them aligned, else as four 4-byte
//         pieces masked per element at K and F (WV 1); x as a float4 along
//         K (XV 4) where K and its base allow it, else as scalars into the
//         same transposed tile (XV 1); the store a float4 where F and out
//         allow it and element by element otherwise.  Every width sums in
//         the same fixed order.  (One width for both operands cost x 4
//         bytes off 1.41x the aligned call, PERF.md.)
//       - Rows past C and columns or K past the operands are zero fill (a bin
//         never reads another expert's rows); the store masks rows >= C and
//         columns >= F.  Adjacent blocks take the row tiles of one weight
//         tile, so at C 512 the four reads of it meet in L2.
//
// Plain C interface for ctypes; the launchers return cudaGetLastError(), or
// a negative code for arguments they refuse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"
#include "../../csrc/stage_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// -------------------------------------------------- fp32, CUDA cores, cp.async
namespace simt90 {

constexpr int BN = 128;                      // output columns per block
constexpr int BK = 32;                       // K per stage
constexpr int STAGES = 3;                    // ring depth
constexpr int NT = 256;                      // 16 x 16 threads

template <int BM>                            // 128, or 64 for bins of <= 64 rows
struct Cfg {
  static constexpr int MG = BM / 64;         // 64-row groups: 4 rows a thread each
  static constexpr int XP = BM + 4;          // x tile pitch (K-major), 16B rows
  static constexpr int X_FLOATS = BK * XP;
  static constexpr int STAGE = X_FLOATS + BK * BN;
  static constexpr int BYTES = STAGES * STAGE * 4;
  static constexpr int KT = BM * BK / NT / 4;   // x: 4 rows x KT k a thread
  static constexpr int KQ = BK / KT;            // threads along K of a row quad
  static constexpr int W_PER_THREAD = BK * BN / 4 / NT;    // 16-byte copies
  static_assert(KT * 4 * NT == BM * BK && BK * BN / 4 % NT == 0, "even staging");
};

// One block: expert blockIdx.z, rows [blockIdx.x * BM, + BM) of its bin,
// columns [blockIdx.y * BN, + BN).  XV 4: K a multiple of 4 and x 16-byte
// aligned, x loaded as float4 (else XV 1, scalars); WV 4: F a multiple of 4
// and w 16-byte aligned, w copied in 16-byte pieces (else WV 1, 4-byte
// ones); out_vec: F a multiple of 4 and out 16-byte aligned (the launcher
// checks each).
template <int BM, int XV, int WV>
__global__ void __launch_bounds__(NT, 2)
gmm_capacity_simt90_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           float* __restrict__ out, int C, int K, int F, int out_vec) {
  using L = Cfg<BM>;
  constexpr int MG = L::MG;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int e = blockIdx.z, row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const float* xe = x + static_cast<long long>(e) * C * K;
  const float* we = w + static_cast<long long>(e) * K * F;

  // w: K tile kt into stage s by cp.async, as it is
  auto stage_w = [&](int kt, int s) {
    float* ws = smem + s * L::STAGE + L::X_FLOATS;
    const int k0 = kt * BK;
#pragma unroll
    for (int n = 0; n < L::W_PER_THREAD; ++n) {
      const int idx = tid + n * NT;
      const int kk = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      if constexpr (WV == 4) {
        const bool ok = k0 + kk < K && col0 + c < F;
        sm90::cp_async16(ws + kk * BN + c,
                         ok ? we + static_cast<long long>(k0 + kk) * F + col0 + c : w, ok);
      } else {
        // the same 16 bytes of the tile as four 4-byte pieces, each masked
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = k0 + kk < K && col0 + c + j < F;
          sm90::cp_async4(ws + kk * BN + c + j,
                          ok ? we + static_cast<long long>(k0 + kk) * F + col0 + c + j : w,
                          ok ? 4 : 0);
        }
      }
    }
  };
  // x: K tile kt through registers, transposed on the way: this thread
  // loads rows 4 m4 + {0..3} at k KT kq + {0..KT-1} (zeros past C and K)
  // and stores each k's 4 rows as one float4 of xs[k][m]
  const int m4 = tid / L::KQ, kq = tid % L::KQ;
  float xr[4][L::KT];
  auto load_x = [&](int kt) {
    const int k = kt * BK + L::KT * kq;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = row0 + 4 * m4 + q;
      const float* src = xe + static_cast<long long>(r) * K + k;
      const bool ok = r < C && k < K;                 // XV 4: all KT or none
      if constexpr (XV == 1) {
        xr[q][0] = ok ? src[0] : 0.f;
#pragma unroll
        for (int j = 1; j < L::KT; ++j) xr[q][j] = ok && k + j < K ? src[j] : 0.f;
      } else if constexpr (L::KT == 4) {
        const float4 v = ok ? *reinterpret_cast<const float4*>(src)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        xr[q][0] = v.x;
        xr[q][1] = v.y;
        xr[q][2] = v.z;
        xr[q][3] = v.w;
      } else if constexpr (L::KT == 2) {
        const float2 v = ok ? *reinterpret_cast<const float2*>(src) : make_float2(0.f, 0.f);
        xr[q][0] = v.x;
        xr[q][1] = v.y;
      } else {
        xr[q][0] = ok ? *src : 0.f;
      }
    }
  };
  auto store_x = [&](int s) {
    float* xs = smem + s * L::STAGE;
#pragma unroll
    for (int j = 0; j < L::KT; ++j)
      *reinterpret_cast<float4*>(xs + (L::KT * kq + j) * L::XP + 4 * m4) =
          make_float4(xr[0][j], xr[1][j], xr[2][j], xr[3][j]);
  };

  float acc[4 * MG][8];
#pragma unroll
  for (int i = 0; i < 4 * MG; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      stage_w(s, s);
      load_x(s);
      store_x(s);
    }
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // tile kt has landed (this thread's copies and stores; the barrier:
    // everyone's), and every thread is done with the stage that tile
    // kt + STAGES - 1 overwrites; its x loads land during this tile's FMAs
    sm90::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < nk) {
      stage_w(next, next % STAGES);
      load_x(next);
    }
    sm90::cp_async_commit();
    const float* xs = smem + (kt % STAGES) * L::STAGE;
    const float* ws = xs + L::X_FLOATS;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4 * MG], b[8];
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        const float4 av = *reinterpret_cast<const float4*>(xs + k * L::XP + 64 * g + 4 * ty);
        a[4 * g] = av.x; a[4 * g + 1] = av.y; a[4 * g + 2] = av.z; a[4 * g + 3] = av.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 bv = *reinterpret_cast<const float4*>(ws + k * BN + 64 * h + 4 * tx);
        b[4 * h] = bv.x; b[4 * h + 1] = bv.y; b[4 * h + 2] = bv.z; b[4 * h + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * MG; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (next < nk) store_x(next % STAGES);
  }
  sm90::cp_async_wait<0>();

  float* oe = out + static_cast<long long>(e) * C * F;
#pragma unroll
  for (int i = 0; i < 4 * MG; ++i) {
    const int r = row0 + 64 * (i / 4) + 4 * ty + i % 4;
    if (r >= C) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + 64 * h + 4 * tx;
      if (out_vec) {                           // F % 4 == 0: all 4 columns or none
        if (c < F)
          *reinterpret_cast<float4*>(oe + static_cast<long long>(r) * F + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < F) oe[static_cast<long long>(r) * F + c + j] = acc[i][4 * h + j];
      }
    }
  }
}

// The tile rows the launcher takes for bins of C rows.
inline int rows_for(int C) { return C <= 64 ? 64 : 128; }

template <int BM, int XV, int WV>
int launch(const float* x, const float* w, float* out, int E, int C, int K, int F, int out_vec,
           cudaStream_t stream) {
  using L = Cfg<BM>;
  static bool opted_in = false;              // per instantiation, per library
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(gmm_capacity_simt90_kernel<BM, XV, WV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L::BYTES);
    if (err == cudaSuccess)                  // room for two blocks an SM
      err = cudaFuncSetAttribute(gmm_capacity_simt90_kernel<BM, XV, WV>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const long long tiles_m = (C + BM - 1) / BM;
  const int tiles_n = (F + BN - 1) / BN;
  if (tiles_m > 0x7fffffffLL || tiles_n > 65535) return -1;
  const dim3 grid(static_cast<unsigned>(tiles_m), tiles_n, E);
  gmm_capacity_simt90_kernel<BM, XV, WV><<<grid, NT, L::BYTES, stream>>>(x, w, out, C, K, F,
                                                                      out_vec);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for the operands' widths (4: 16-byte pieces, 1: 4-byte).
template <int BM>
int launch_widths(int xv, int wv, const float* x, const float* w, float* out, int E, int C,
                  int K, int F, int out_vec, cudaStream_t stream) {
  if (xv == 4 && wv == 4) return launch<BM, 4, 4>(x, w, out, E, C, K, F, out_vec, stream);
  if (xv == 4) return launch<BM, 4, 1>(x, w, out, E, C, K, F, out_vec, stream);
  if (wv == 4) return launch<BM, 1, 4>(x, w, out, E, C, K, F, out_vec, stream);
  return launch<BM, 1, 1>(x, w, out, E, C, K, F, out_vec, stream);
}

}  // namespace simt90

// ------------------------------------------------------------ bf16, TMA + wgmma
namespace cap90 {

constexpr int BK = 64;                       // K per stage: one 128-byte row
constexpr int SW = 128;                      // swizzle bytes (= BK * 2)
static_assert(SW == stage90::SW, "staged boxes are 128-byte swizzled rows");

template <int NC, int BN>                    // consumer warpgroups, columns
struct Cfg {
  static constexpr int BM = 64 * NC;         // rows per tile
  static constexpr int NT = 128 * (NC + 1);  // + one producer warpgroup
  static constexpr int STAGES = BN == 256 ? 4 : 5;
  static constexpr int X_BYTES = BM * BK * 2;
  static constexpr int W_BOX = BK * 64 * 2;  // one 64-column box of w
  static constexpr int STAGE = X_BYTES + (BN / 64) * W_BOX;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;   // + alignment
};

// The setmaxnreg split, from the 168 registers a thread at entry (384
// threads): the TMA producer's one thread needs few, the staged producer's
// 128 threads hold two boxes' register units (~66) and their addresses.
template <int STAGED>
struct Regs {
  static constexpr int PRODUCER = STAGED ? 152 : 40;
  static constexpr int CONSUMER = STAGED ? 176 : 232;
  static_assert(128 * PRODUCER + 256 * CONSUMER <= 384 * 168, "within the block's registers");
};

// The staged producer's operands (STAGED 1; unused by the TMA producer).
struct Staged {
  const bf16* x;                             // (E, C, K)
  const bf16* w;                             // (E, K, F)
  int x_tma, w_tma;                          // TMA can address x; w
  int out_pairs;                             // bf16 pairs of out 4-byte aligned
};

// One 64 x 64 box staged by hand (stage_sm90.cuh's arguments).
struct Box {
  unsigned char* dst;
  const bf16* src;
  long long ld;
  int row0, n_rows, col0, n_cols;
};

// A box's register loads (one chunk a unit), its cp.async copies, and its
// register units' stores (stage_sm90.cuh).
__device__ __forceinline__ void box_load(const Box& b, int pt, stage90::BoxRegs1& r) {
  stage90::stage_box_load(b.dst, b.src, b.ld, b.row0, b.n_rows, b.col0, b.n_cols, pt, r);
}

__device__ __forceinline__ bool box_copy(const Box& b, int pt) {
  stage90::BoxRegs none;                     // written only by the register phase
  return stage90::stage_box_issue<false>(b.dst, b.src, b.ld, b.row0, b.n_rows, b.col0, b.n_cols,
                                         pt, none);
}

__device__ __forceinline__ bool box_store(const Box& b, int pt, const stage90::BoxRegs1& r) {
  return stage90::stage_box_store1(b.dst, b.src, b.ld, b.row0, b.n_rows, b.col0, b.n_cols, pt,
                                   r);
}

template <int BN>
__device__ __forceinline__ void mma(float (&acc)[BN / 2], uint64_t da, uint64_t db,
                                    int scale_d) {
  if constexpr (BN == 256) sm90::wgmma_ss_n256<1>(acc, da, db, scale_d);
  else sm90::wgmma_ss_n128<1>(acc, da, db, scale_d);
}

// The staged producer (all 128 threads of the producer warpgroup): each
// stage's boxes that TMA cannot address by hand, the rest by one thread's
// TMA loads.  Box b of a stage is x's rows 64 b .. 64 b + 63 of the tile
// (b < NC) or w's columns 64 (b - NC) .. of the column tile.  The register
// loads of the first two boxes by hand go out before the wait for the ring
// slot, those of further boxes (w staged at BN 256) after it.  (Loads a
// stage ahead, held across the wait, ran 1.12x slower; PERF.md.)
template <int NC, int BN>
__device__ __forceinline__ void staged_producer(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                                const Staged& st, unsigned char* smem,
                                                uint64_t* full, uint64_t* empty, int C, int K,
                                                int F, int tiles_m, int tiles_n, int n_tiles) {
  using L = Cfg<NC, BN>;
  constexpr int STAGES = L::STAGES, NW = BN / 64;
  const int pt = threadIdx.x - NC * 128, lane = pt % 32;
  if (pt == 0) {
    if (st.x_tma) sm90::prefetch_map(xmap);
    if (st.w_tma) sm90::prefetch_map(wmap);
  }
  // the boxes staged by hand (bits 0..NC-1 x's, NC.. w's): the first two,
  // b0 and b1 (-1: none), and the rest
  const uint32_t by_hand =
      (st.x_tma ? 0u : (1u << NC) - 1) | (st.w_tma ? 0u : ((1u << NW) - 1) << NC);
  const uint32_t after_b0 = by_hand & (by_hand - 1);
  const uint32_t rest = after_b0 & (after_b0 - 1);
  const int b0 = __ffs(by_hand) - 1, b1 = __ffs(after_b0) - 1;
  const uint32_t tma_bytes =
      (st.x_tma ? L::X_BYTES : 0) + (st.w_tma ? NW * L::W_BOX : 0);
  const int nk = (K + BK - 1) / BK;
  stage90::BoxRegs1 r0, r1;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int m = t % tiles_m, n = (t / tiles_m) % tiles_n, e = t / (tiles_m * tiles_n);
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int s = it % STAGES, k0 = ks * BK;
      unsigned char* stg = smem + s * L::STAGE;
      auto box = [&](int b) {
        if (b < NC) {
          const int row0 = m * L::BM + 64 * b;
          return Box{stg + b * 64 * SW, st.x + static_cast<long long>(e) * C * K, K, row0,
                     C - row0, k0, K - k0};
        }
        const int col0 = n * BN + 64 * (b - NC);
        return Box{stg + L::X_BYTES + (b - NC) * L::W_BOX,
                   st.w + static_cast<long long>(e) * K * F, F, k0, K - k0, col0, F - col0};
      };
      // the register loads need no free slot: in flight during the wait
      if (b0 >= 0) box_load(box(b0), pt, r0);
      if (b1 >= 0) box_load(box(b1), pt, r1);
      sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      if (pt == 0 && tma_bytes) {
        // the rest by TMA, its bytes expected before the loads (this
        // thread's arrival comes after its copies below)
        sm90::mbar_expect(&full[s], tma_bytes);
        if (st.x_tma) sm90::tma_load_3d(stg, xmap, &full[s], k0, m * L::BM, e);
        if (st.w_tma) {
#pragma unroll
          for (int bx = 0; bx < NW; ++bx)
            sm90::tma_load_3d(stg + L::X_BYTES + bx * L::W_BOX, wmap, &full[s], n * BN + 64 * bx,
                              k0, e);
        }
      }
      bool stored = false, copied = false;
      if (b0 >= 0) {
        const Box bx = box(b0);
        copied |= box_copy(bx, pt);
        stored |= box_store(bx, pt, r0);
      }
      if (b1 >= 0) {
        const Box bx = box(b1);
        copied |= box_copy(bx, pt);
        stored |= box_store(bx, pt, r1);
      }
#pragma unroll
      for (int b = 0; b < NC + NW; ++b) {
        if (!(rest >> b & 1)) continue;
        const Box bx = box(b);
        box_load(bx, pt, r1);
        copied |= box_copy(bx, pt);
        stored |= box_store(bx, pt, r1);
      }
      // this thread's stores (generic proxy) before the wgmma reads of them
      // (async proxy); its cp.async copies take no fence.  The barrier
      // waits for each thread's copies, and takes one arrival from each
      // warp after its stores
      if (stored) sm90::fence_proxy_async();
      if (copied) sm90::cp_async_arrive(&full[s]);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&full[s]);
    }
  }
  sm90::cp_async_wait<0>();                  // no thread leaves with copies in flight
}

// The maps are read where TMA can address their operand (every one in TMA
// mode, STAGED 0), st by the staged producer.
template <int NC, int BN, int STAGED>
__global__ void __launch_bounds__(384, 1)   // 168 registers at entry, for setmaxnreg
gmm_capacity_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap, const Staged st,
                         bf16* __restrict__ out, int C, int K, int F, int tiles_m, int tiles_n,
                         int n_tiles) {
  using L = Cfg<NC, BN>;
  using R = Regs<STAGED>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], STAGED ? 4 : 1);   // staged: each producer warp
      sm90::mbar_init(&empty[s], NC);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int nk = (K + BK - 1) / BK;

  if (wg == NC) {
    sm90::reg_dealloc<R::PRODUCER>();
    if constexpr (STAGED != 0) {
      staged_producer<NC, BN>(&xmap, &wmap, st, smem, full, empty, C, K, F, tiles_m, tiles_n,
                              n_tiles);
    } else if (threadIdx.x == NC * 128) {
      // ---- TMA producer: one thread keeps the ring full, tile after tile
      sm90::prefetch_map(&xmap);
      sm90::prefetch_map(&wmap);
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int m = t % tiles_m, n = (t / tiles_m) % tiles_n, e = t / (tiles_m * tiles_n);
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % STAGES;
          sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* stg = smem + s * L::STAGE;
          sm90::mbar_expect_tx(&full[s], L::STAGE);
          sm90::tma_load_3d(stg, &xmap, &full[s], ks * BK, m * L::BM, e);
#pragma unroll
          for (int bx = 0; bx < BN / 64; ++bx)
            sm90::tma_load_3d(stg + L::X_BYTES + bx * L::W_BOX, &wmap, &full[s],
                              n * BN + 64 * bx, ks * BK, e);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
    sm90::reg_alloc<R::CONSUMER>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float acc[BN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int m = t % tiles_m, n = (t / tiles_m) % tiles_n, e = t / (tiles_m * tiles_n);
      int prev = -1;
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t xa = sm90::smem_u32(smem + s * L::STAGE) + wg * 64 * SW;
        const uint32_t wa = sm90::smem_u32(smem + s * L::STAGE + L::X_BYTES);
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // x: K-major, 16 columns = 32 bytes along the 128-byte row;
          // w: MN-major, 16 rows of 128 bytes, 64-column boxes L::W_BOX apart
          const uint64_t da = sm90::make_desc(xa + kk * 32, 16, 8 * SW, SW);
          const uint64_t db = sm90::make_desc(wa + kk * 16 * SW, L::W_BOX, 8 * SW, SW);
          mma<BN>(acc, da, db, ks > 0 || kk > 0);
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

      // ---- epilogue: rows < C, columns < F, straight from the accumulators
      const int row = m * L::BM + wg * 64 + warp * 16 + lane / 4;
      const int col = n * BN + 2 * (lane % 4);
      bf16* oe = out + static_cast<long long>(e) * C * F;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = col + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h;
          if (r < C && c < F) {
            const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
            bf16* o = oe + static_cast<long long>(r) * F + c;
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

template <int NC, int BN, int STAGED>
int launch_mode(const CUtensorMap& xmap, const CUtensorMap& wmap, const Staged& st, void* out,
                int E, int C, int K, int F, cudaStream_t stream) {
  using L = Cfg<NC, BN>;
  static bool opted_in = false;              // per instantiation, per library
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(gmm_capacity_sm90_kernel<NC, BN, STAGED>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int tiles_m = (C + L::BM - 1) / L::BM, tiles_n = (F + BN - 1) / BN;
  const long long n_tiles = static_cast<long long>(E) * tiles_m * tiles_n;
  if (n_tiles > 0x7fffffffLL) return -1;
  const int grid = static_cast<int>(n_tiles < sm90::sm_count() ? n_tiles : sm90::sm_count());
  gmm_capacity_sm90_kernel<NC, BN, STAGED><<<grid, L::NT, L::BYTES, stream>>>(
      xmap, wmap, st, static_cast<bf16*>(out), C, K, F, tiles_m, tiles_n,
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// *staged is set to 1 when the launch takes the staged producer.
template <int NC, int BN>
int launch(const void* x, const void* w, void* out, int E, int C, int K, int F,
           cudaStream_t stream, int* staged) {
  using L = Cfg<NC, BN>;
  const Staged st{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                  K % 8 == 0 && aligned16(x), F % 8 == 0 && aligned16(w),
                  F % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0};
  // the TMA producer when TMA can address both operands (and out's bf16
  // pairs are aligned), else the staged one; maps only for the operands
  // TMA can address
  const bool staged_mode = !(st.x_tma && st.w_tma && st.out_pairs);
  CUtensorMap xmap{}, wmap{};
  const long long xd[3] = {K, C, E}, xs[2] = {K, static_cast<long long>(C) * K};
  const long long wd[3] = {F, K, E}, ws[2] = {F, static_cast<long long>(K) * F};
  const int xb[3] = {BK, L::BM, 1}, wb[3] = {64, BK, 1};
  int rc = st.x_tma ? sm90::make_map_bf16<3>(&xmap, x, xd, xs, xb, SW) : 0;
  if (rc == 0 && st.w_tma) rc = sm90::make_map_bf16<3>(&wmap, w, wd, ws, wb, SW);
  if (rc != 0) return rc;
  *staged = staged_mode;
  return staged_mode ? launch_mode<NC, BN, 1>(xmap, wmap, st, out, E, C, K, F, stream)
                     : launch_mode<NC, BN, 0>(xmap, wmap, st, out, E, C, K, F, stream);
}

// x staged by hand (its base or pitch off TMA's) takes 256 columns from 65
// rows on: its staging by the producer, not the weight bytes, bounds the
// call, and a wider column tile stages each row of x half as often.
constexpr bool WIDE_STAGED_X = true;

// The tile the launcher takes for bins of C rows: one consumer warpgroup
// for at most 64 rows, else two; 256 columns past 128 rows (or past 64
// with x staged), else 128.
inline void tile_for(int C, bool x_staged, int* consumers, int* columns) {
  *consumers = C <= 64 ? 1 : 2;
  *columns = C > 128 || (WIDE_STAGED_X && x_staged && C > 64) ? 256 : 128;
}

}  // namespace cap90

}  // namespace

// fp32 on the CUDA cores through the cp.async ring.  x (E, C, K), w (E, K, F),
// out (E, C, F), all contiguous on the device, any K, F and 4-byte aligned
// bases: each operand in 16-byte pieces where its pitch and base keep them
// aligned, 4-byte ones otherwise.  -1 for arguments it refuses.
extern "C" int gmm_capacity_simt90_launch(const void* x, const void* w, void* out, int E,
                                          int C, int K, int F, void* stream) {
  const auto a4 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; };
  if (E < 1 || C < 1 || K < 1 || F < 1 || E > 65535 || !a4(x) || !a4(w) || !a4(out)) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  const int xv = K % 4 == 0 && aligned16(x) ? 4 : 1;
  const int wv = F % 4 == 0 && aligned16(w) ? 4 : 1;
  const int out_vec = F % 4 == 0 && aligned16(out);
  return simt90::rows_for(C) == 64
             ? simt90::launch_widths<64>(xv, wv, xf, wf, of, E, C, K, F, out_vec, s)
             : simt90::launch_widths<128>(xv, wv, xf, wf, of, E, C, K, F, out_vec, s);
}

// Dynamic shared memory of a block of the fp32 simt90 kernel with 64- or
// 128-row tiles, x and w in 16- (4) or 4-byte pieces (1; the same), for
// reports, or -1.
extern "C" int gmm_capacity_simt90_smem_bytes(int rows, int xv, int wv) {
  if ((xv != 4 && xv != 1) || (wv != 4 && wv != 1)) return -1;
  if (rows == 64) return simt90::Cfg<64>::BYTES;
  if (rows == 128) return simt90::Cfg<128>::BYTES;
  return -1;
}

// bf16 through TMA and wgmma.  x (E, C, K), w (E, K, F), out (E, C, F), all
// contiguous on the device, any K, F and (2-byte aligned) base: *staged is
// set to 1 when the producer stages an operand TMA cannot address (or out's
// bf16 pairs are unaligned), 0 when TMA loads every tile.  -1 for arguments
// it refuses, -3/-4 when the CUDA driver cannot encode the tensor maps.
extern "C" int gmm_capacity_sm90_launch(const void* x, const void* w, void* out, int E, int C,
                                        int K, int F, void* stream, int* staged) {
  if (E < 1 || C < 1 || K < 1 || F < 1) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int consumers, columns;
  cap90::tile_for(C, K % 8 != 0 || !aligned16(x), &consumers, &columns);
  if (consumers == 1) return cap90::launch<1, 128>(x, w, out, E, C, K, F, s, staged);
  if (columns == 128) return cap90::launch<2, 128>(x, w, out, E, C, K, F, s, staged);
  return cap90::launch<2, 256>(x, w, out, E, C, K, F, s, staged);
}

// Dynamic shared memory of a block of the bf16 kernel with 1 or 2 consumer
// warpgroups and a column tile of 128 or 256, with either producer (the
// same), for reports, or -1.
extern "C" int gmm_capacity_sm90_smem_bytes(int consumers, int columns, int staged) {
  if (staged != 0 && staged != 1) return -1;
  if (consumers == 1 && columns == 128) return cap90::Cfg<1, 128>::BYTES;
  if (consumers == 2 && columns == 128) return cap90::Cfg<2, 128>::BYTES;
  if (consumers == 2 && columns == 256) return cap90::Cfg<2, 256>::BYTES;
  return -1;
}

// Dynamic shared memory of a block that the launcher of route 0 (bf16,
// sm90) or 1 (fp32, simt90) takes for bins of C rows, x staged by hand
// (x_staged 1: bf16 x whose pitch or base TMA cannot address) or not, by
// the launcher's own tile choice, for reports, or -1.
extern "C" int gmm_capacity_smem_bytes(int route, int C, int x_staged) {
  if (C < 1) return -1;
  if (route == 1) return gmm_capacity_simt90_smem_bytes(simt90::rows_for(C), 4, 4);
  if (route != 0) return -1;
  int consumers, columns;
  cap90::tile_for(C, x_staged != 0, &consumers, &columns);
  return gmm_capacity_sm90_smem_bytes(consumers, columns, 0);
}
