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
// Four kernels; the wrapper (gmm.py, _route) picks one per call, before the
// launch, from the operands' dtype, pitches and bases:
//
//   * gmm_capacity_sm90_kernel, bf16 whenever TMA can address the operands
//     (K and F multiples of 8 elements, 16-byte aligned bases): the shapes of
//     the model and of every serving-width call.
//       - A block tile is 64 * NC rows x BN columns: NC = 2 consumer
//         warpgroups (one for bins of at most 64 rows), each running
//         wgmma m64nBNk16 with its fp32 accumulators in registers.  At
//         C <= 128 one row tile covers a whole bin, so each weight tile is
//         read from device memory once, and BN = 128 (the call is bound by
//         the weight bytes; more, smaller tiles fill the 132 SMs).  Above,
//         the call is bound by the products and BN = 256 halves the
//         shared-memory reads of x per operation (PERF.md has both times).
//       - One producer warp fills a ring of STAGES (5 at BN 128, 4 at 256) of
//         (x 64*NC x 64, w 64 x BN) tiles over K with TMA, completion on
//         full/empty mbarriers, and gives most of its registers to the
//         consumers (setmaxnreg).
//       - Tensor maps are 3-D over (K, C, E) and (F, K, E): rows past C in a
//         bin and columns past K or F are TMA zero fill, never another
//         expert's; the epilogue stores rows < C and columns < F straight
//         from the accumulators.  x is K-major; w is MN-major (F contiguous),
//         read with wgmma's transpose bit, so nothing is transposed in memory.
//       - A persistent grid (one block per SM) walks the (expert, column
//         tile, row tile) list with the row tiles of one (expert, column
//         tile) adjacent, so at C = 512 four neighbouring blocks read the same
//         weight tile at once and three of the four reads hit L2.
//   * gmm_capacity_tc_kernel, bf16 shapes TMA cannot address (a row pitch
//     that is not a multiple of 16 bytes, an unaligned base): WMMA 16x16x16
//     tiles of 64 (or 16) rows x 64 columns staged through registers.
//   * gmm_capacity_simt90_kernel, fp32 (the parity checks and the ops path)
//     whenever every 16-byte piece it copies is aligned (K and F multiples of
//     4, 16-byte aligned bases).  Full fp32 on the CUDA cores (fmaf, no TF32),
//     so the bound is operations at 67 TFLOP/s: 2.2 ms at the SD-verify
//     capacity, against 0.7 ms of bytes.
//       - A block tile is 128 x 128 outputs (64 x 128 for bins of at most 64
//         rows), 256 threads of 8 x 8 (4 x 8) outputs each: thread (ty, tx)
//         owns rows 4 ty + 64 g + {0..3} and columns 4 tx + 64 h + {0..3}.
//       - x is staged K-major, w row-major, so each k step is two float4
//         reads of x and two of w for 64 FMAs.  An SM issues 4 warp
//         instructions a cycle, as many as its FMA units take, so every
//         other instruction costs an FMA: x goes through registers (a float4
//         along K of each of 4 rows a thread, loaded two tiles ahead, stored
//         as 4 float4s of the transposed tile after this tile's FMAs), which
//         measured 12-14 % faster than per-element cp.async copies of it
//         (PERF.md, section 6).
//       - A ring of 3 stages of BK = 32 (100 KB, two blocks an SM); w's
//         tile arrives by cp.async, in flight two stages ahead, with one
//         barrier a stage.
//       - Rows past C and columns or K past the operands are zero fill (a bin
//         never reads another expert's rows); the store masks rows >= C and
//         columns >= F.  Adjacent blocks take the row tiles of one weight
//         tile, so at C 512 the four reads of it meet in L2.
//   * gmm_capacity_simt_kernel, fp32 operands simt90 cannot copy (a pitch
//     not a multiple of 16 bytes, an unaligned base): 64 x 64 tiles staged
//     element by element through registers.
//
// Plain C interface for ctypes; the launchers return cudaGetLastError(), or
// a negative code for arguments they refuse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 64;                       // output columns per block

// Stage a ROWS x COLS tile of a row-major matrix (leading dimension ld) into
// shared memory (pitch PITCH elements), element by element (the operands
// that come here are not 16-byte aligned).  Tile row i is global row
// row0 + i, read only if it is below row_end, and column c only if it is
// below col_end; everything else is 0.
template <typename T, int ROWS, int COLS, int PITCH, int NT>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src,
                                           long long ld, int row0, int row_end,
                                           int col0, int col_end) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS_PER_ROW = COLS / VEC;
  constexpr int CHUNKS = ROWS * CHUNKS_PER_ROW;
  for (int c = threadIdx.x; c < CHUNKS; c += NT) {
    const int i = c / CHUNKS_PER_ROW;
    const int j = (c % CHUNKS_PER_ROW) * VEC;
    const long long grow = row0 + i;
    const int gcol = col0 + j;
    T* d = dst + i * PITCH + j;
    const bool row_ok = grow < row_end;
    alignas(16) T vals[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      vals[v] = (row_ok && gcol + v < col_end) ? src[grow * ld + gcol + v] : T(0.0f);
    if constexpr (PITCH * sizeof(T) % 16 == 0) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(vals);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[v] = vals[v];
    }
  }
}

// ------------------------------------------------- bf16, WMMA (unaligned)
// One block: expert blockIdx.z, rows [blockIdx.y*BM, +BM) of its bin, output
// columns [blockIdx.x*BN, +BN).  Each warp owns TPW 16x16 output tiles.  Only
// shapes whose rows or bases are not 16-byte aligned come here (the aligned
// ones take the TMA kernel), so tiles are staged element by element.
template <int BM>
__global__ void __launch_bounds__(BM == 16 ? 128 : 256)
gmm_capacity_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       bf16* __restrict__ out, int C, int K, int F) {
  using namespace nvcuda;
  constexpr int NWARPS = BM == 16 ? 4 : 8;
  constexpr int NT = NWARPS * 32;
  constexpr int TILES_N = BN / 16;
  constexpr int TPW = (BM / 16) * TILES_N / NWARPS;
  constexpr int BK = 64;
  constexpr int XP = BK + 8;                 // bf16 pitches: 16B-aligned rows,
  constexpr int WP = BN + 8;                 // rows offset across banks
  constexpr int OP = BN + 4;                 // fp32 pitch of the epilogue tile
  constexpr int X_BYTES = BM * XP * 2;
  constexpr int W_BYTES = BK * WP * 2;
  constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  constexpr int OUT_BYTES = BM * OP * 4;
  constexpr int SMEM = STAGE_BYTES > OUT_BYTES ? STAGE_BYTES : OUT_BYTES;
  static_assert(X_BYTES % 32 == 0 && W_BYTES % 32 == 0, "wmma needs 32B alignment");
  // staging tiles, reused for the fp32 output tile after the K loop
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + X_BYTES);
  float* os = reinterpret_cast<float*>(smem);

  const int e = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const bf16* xe = x + static_cast<long long>(e) * C * K;
  const bf16* we = w + static_cast<long long>(e) * K * F;
  bf16* oe = out + static_cast<long long>(e) * C * F;
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TPW];
#pragma unroll
  for (int t = 0; t < TPW; ++t) wmma::fill_fragment(acc[t], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_tile<bf16, BM, BK, XP, NT>(xs, xe, K, row0, C, k0, K);
    stage_tile<bf16, BK, BN, WP, NT>(ws, we, F, k0, K, col0, F);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int t = 0; t < TPW; ++t) {
        const int tile = warp + t * NWARPS;
        const int tr = tile / TILES_N, tc = tile % TILES_N;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, xs + tr * 16 * XP + kk * 16, XP);
        wmma::load_matrix_sync(b, ws + kk * 16 * WP + tc * 16, WP);
        wmma::mma_sync(acc[t], a, b, acc[t]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < TPW; ++t) {
    const int tile = warp + t * NWARPS;
    const int tr = tile / TILES_N, tc = tile % TILES_N;
    wmma::store_matrix_sync(os + tr * 16 * OP + tc * 16, acc[t], OP, wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
    const int r = idx / BN, c = idx % BN;
    const int grow = row0 + r, gcol = col0 + c;
    if (grow < C && gcol < F)
      oe[static_cast<long long>(grow) * F + gcol] = __float2bfloat16_rn(os[r * OP + c]);
  }
}

// ------------------------------------------------------ fp32, unaligned
template <int BM>
__global__ void __launch_bounds__(256)
gmm_capacity_simt_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         float* __restrict__ out, int C, int K, int F) {
  constexpr int NT = 256;
  constexpr int BK = 32;
  constexpr int COL_GROUPS = BN / 4;         // 16 threads span 64 columns
  constexpr int ROW_GROUPS = NT / COL_GROUPS;
  constexpr int RM = BM / ROW_GROUPS;        // rows per thread
  constexpr int WP = BN + 4;                 // keeps float4 rows 16B aligned
  constexpr int XP = BK + 1;                 // odd pitch: no bank conflicts
  static_assert(RM * ROW_GROUPS == BM, "BM must be a multiple of 16");
  __shared__ float xs[BM * XP];
  __shared__ __align__(16) float ws[BK * WP];

  const int e = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const float* xe = x + static_cast<long long>(e) * C * K;
  const float* we = w + static_cast<long long>(e) * K * F;
  float* oe = out + static_cast<long long>(e) * C * F;
  const int cg = threadIdx.x % COL_GROUPS;
  const int rg = threadIdx.x / COL_GROUPS;
  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_tile<float, BM, BK, XP, NT>(xs, xe, K, row0, C, k0, K);
    stage_tile<float, BK, BN, WP, NT>(ws, we, F, k0, K, col0, F);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[k * WP + cg * 4]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float xv = xs[(rg + i * ROW_GROUPS) * XP + k];
        acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
        acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
        acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
        acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + rg + i * ROW_GROUPS;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + cg * 4 + j;
      if (c < F) oe[static_cast<long long>(r) * F + c] = acc[i][j];
    }
  }
}

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
// columns [blockIdx.y * BN, + BN).  K and F multiples of 4, x, w and out
// 16-byte aligned (the launcher checks).
template <int BM>
__global__ void __launch_bounds__(NT, 2)
gmm_capacity_simt90_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           float* __restrict__ out, int C, int K, int F) {
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
      const bool ok = k0 + kk < K && col0 + c < F;
      sm90::cp_async16(ws + kk * BN + c,
                       ok ? we + static_cast<long long>(k0 + kk) * F + col0 + c : w, ok);
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
      const bool ok = r < C && k < K;                 // K % 4 == 0: all KT or none
      if constexpr (L::KT == 4) {
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
      if (c < F)
        *reinterpret_cast<float4*>(oe + static_cast<long long>(r) * F + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

// The tile rows the launcher takes for bins of C rows.
inline int rows_for(int C) { return C <= 64 ? 64 : 128; }

template <int BM>
int launch(const float* x, const float* w, float* out, int E, int C, int K, int F,
           cudaStream_t stream) {
  using L = Cfg<BM>;
  static bool opted_in = false;              // per instantiation, per library
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(gmm_capacity_simt90_kernel<BM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L::BYTES);
    if (err == cudaSuccess)                  // room for two blocks an SM
      err = cudaFuncSetAttribute(gmm_capacity_simt90_kernel<BM>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const long long tiles_m = (C + BM - 1) / BM;
  const int tiles_n = (F + BN - 1) / BN;
  if (tiles_m > 0x7fffffffLL || tiles_n > 65535) return -1;
  const dim3 grid(static_cast<unsigned>(tiles_m), tiles_n, E);
  gmm_capacity_simt90_kernel<BM><<<grid, NT, L::BYTES, stream>>>(x, w, out, C, K, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt90

// ------------------------------------------------------------ bf16, TMA + wgmma
namespace cap90 {

constexpr int BK = 64;                       // K per stage: one 128-byte row
constexpr int SW = 128;                      // swizzle bytes (= BK * 2)

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

template <int BN>
__device__ __forceinline__ void mma(float (&acc)[BN / 2], uint64_t da, uint64_t db,
                                    int scale_d) {
  if constexpr (BN == 256) sm90::wgmma_ss_n256<1>(acc, da, db, scale_d);
  else sm90::wgmma_ss_n128<1>(acc, da, db, scale_d);
}

template <int NC, int BN>
__global__ void __launch_bounds__(384, 1)   // 168 registers at entry, for setmaxnreg
gmm_capacity_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap, bf16* __restrict__ out,
                         int C, int K, int F, int tiles_m, int tiles_n, int n_tiles) {
  using L = Cfg<NC, BN>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], NC);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int nk = (K + BK - 1) / BK;

  if (wg == NC) {
    // ---- producer: one thread keeps the ring full, tile after tile
    sm90::reg_dealloc<40>();
    if (threadIdx.x == NC * 128) {
      sm90::prefetch_map(&xmap);
      sm90::prefetch_map(&wmap);
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int m = t % tiles_m, n = (t / tiles_m) % tiles_n, e = t / (tiles_m * tiles_n);
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % STAGES;
          sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* st = smem + s * L::STAGE;
          sm90::mbar_expect_tx(&full[s], L::STAGE);
          sm90::tma_load_3d(st, &xmap, &full[s], ks * BK, m * L::BM, e);
#pragma unroll
          for (int bx = 0; bx < BN / 64; ++bx)
            sm90::tma_load_3d(st + L::X_BYTES + bx * L::W_BOX, &wmap, &full[s],
                              n * BN + 64 * bx, ks * BK, e);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
    sm90::reg_alloc<232>();
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
          if (r < C && c < F)
            *reinterpret_cast<uint32_t*>(oe + static_cast<long long>(r) * F + c) =
                sm90::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

template <int NC, int BN>
int launch(const void* x, const void* w, void* out, int E, int C, int K, int F,
           cudaStream_t stream) {
  using L = Cfg<NC, BN>;
  static bool opted_in = false;              // per instantiation, per library
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(gmm_capacity_sm90_kernel<NC, BN>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  CUtensorMap xmap, wmap;
  const long long xd[3] = {K, C, E}, xs[2] = {K, static_cast<long long>(C) * K};
  const long long wd[3] = {F, K, E}, ws[2] = {F, static_cast<long long>(K) * F};
  const int xb[3] = {BK, L::BM, 1}, wb[3] = {64, BK, 1};
  int rc = sm90::make_map_bf16<3>(&xmap, x, xd, xs, xb, SW);
  if (rc == 0) rc = sm90::make_map_bf16<3>(&wmap, w, wd, ws, wb, SW);
  if (rc != 0) return rc;
  const int tiles_m = (C + L::BM - 1) / L::BM, tiles_n = (F + BN - 1) / BN;
  const long long n_tiles = static_cast<long long>(E) * tiles_m * tiles_n;
  if (n_tiles > 0x7fffffffLL) return -1;
  const int grid = static_cast<int>(n_tiles < sm90::sm_count() ? n_tiles : sm90::sm_count());
  gmm_capacity_sm90_kernel<NC, BN><<<grid, L::NT, L::BYTES, stream>>>(
      xmap, wmap, static_cast<bf16*>(out), C, K, F, tiles_m, tiles_n,
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// The tile the launcher takes for bins of C rows: one consumer warpgroup
// for at most 64 rows, else two; 256 columns past 128 rows, else 128.
inline void tile_for(int C, int* consumers, int* columns) {
  *consumers = C <= 64 ? 1 : 2;
  *columns = C > 128 ? 256 : 128;
}

}  // namespace cap90

template <int BM>
int launch(int dtype, const void* x, const void* w, void* out, int E, int C,
           int K, int F, void* stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gmm_capacity_tc_kernel<BM><<<grid, BM == 16 ? 128 : 256, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), C, K, F);
  } else if (dtype == 1) {
    gmm_capacity_simt_kernel<BM><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), C, K, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  bm: 16 or 64.  x (E, C, K), w (E, K, F),
// out (E, C, F), all contiguous on the device; the kernels read them element
// by element (bf16: WMMA, fp32: the CUDA-core simt kernel), so any pitch or
// base is taken.
extern "C" int gmm_capacity_launch(int dtype, int bm, const void* x, const void* w,
                                   void* out, int E, int C, int K, int F, void* stream) {
  if (E < 1 || C < 1 || K < 1 || F < 1 || E > 65535 || (C + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 16) return launch<16>(dtype, x, w, out, E, C, K, F, stream);
  if (bm == 64) return launch<64>(dtype, x, w, out, E, C, K, F, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// fp32 on the CUDA cores through the cp.async ring.  x (E, C, K), w (E, K, F),
// out (E, C, F), all contiguous on the device, K and F multiples of 4, every
// base 16-byte aligned (the wrapper's _route).  -1 for arguments it refuses.
extern "C" int gmm_capacity_simt90_launch(const void* x, const void* w, void* out, int E,
                                          int C, int K, int F, void* stream) {
  if (E < 1 || C < 1 || K < 1 || F < 1 || E > 65535 || K % 4 != 0 || F % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  if (simt90::rows_for(C) == 64) return simt90::launch<64>(xf, wf, of, E, C, K, F, s);
  return simt90::launch<128>(xf, wf, of, E, C, K, F, s);
}

// Dynamic shared memory of a block of the fp32 simt90 kernel with 64- or
// 128-row tiles (for reports), or -1.
extern "C" int gmm_capacity_simt90_smem_bytes(int rows) {
  if (rows == 64) return simt90::Cfg<64>::BYTES;
  if (rows == 128) return simt90::Cfg<128>::BYTES;
  return -1;
}

// bf16 through TMA and wgmma.  x (E, C, K), w (E, K, F), out (E, C, F), all
// contiguous on the device, K and F multiples of 8 elements, x and w 16-byte
// aligned (the wrapper's _route).  -1 for arguments it refuses, -3/-4 when
// the CUDA driver cannot encode the tensor maps.
extern "C" int gmm_capacity_sm90_launch(const void* x, const void* w, void* out, int E, int C,
                                        int K, int F, void* stream) {
  if (E < 1 || C < 1 || K < 1 || F < 1 || K % 8 != 0 || F % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int consumers, columns;
  cap90::tile_for(C, &consumers, &columns);
  if (consumers == 1) return cap90::launch<1, 128>(x, w, out, E, C, K, F, s);
  if (columns == 128) return cap90::launch<2, 128>(x, w, out, E, C, K, F, s);
  return cap90::launch<2, 256>(x, w, out, E, C, K, F, s);
}

// Dynamic shared memory of a block of the bf16 TMA kernel with 1 or 2
// consumer warpgroups and a column tile of 128 or 256 (for reports), or -1.
extern "C" int gmm_capacity_sm90_smem_bytes(int consumers, int columns) {
  if (consumers == 1 && columns == 128) return cap90::Cfg<1, 128>::BYTES;
  if (consumers == 2 && columns == 128) return cap90::Cfg<2, 128>::BYTES;
  if (consumers == 2 && columns == 256) return cap90::Cfg<2, 256>::BYTES;
  return -1;
}

// Dynamic shared memory of a block that the launcher of route 0 (bf16,
// sm90) or 1 (fp32, simt90) takes for bins of C rows, by the launcher's
// own tile choice (for reports), or -1.
extern "C" int gmm_capacity_smem_bytes(int route, int C) {
  if (C < 1) return -1;
  if (route == 1) return gmm_capacity_simt90_smem_bytes(simt90::rows_for(C));
  if (route != 0) return -1;
  int consumers, columns;
  cap90::tile_for(C, &consumers, &columns);
  return gmm_capacity_sm90_smem_bytes(consumers, columns);
}
