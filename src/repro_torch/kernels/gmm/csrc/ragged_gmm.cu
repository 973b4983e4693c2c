// Ragged grouped matmul for the MoE expert FFN, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/gmm/ragged.py:
//   * _fused_kernel  -> fused_gate_up_launch: act(x @ Wg[e]) * (x @ Wu[e])
//   * _ragged_kernel -> ragged_gmm_launch:    x @ W[e]
// for rows x sorted by expert id, with per-expert row counts (group sizes).
// Accumulation is fp32; the result is cast to the element type (bf16 or
// fp32) at emit.  act is silu or gelu with the tanh approximation.
//
// What bounds it on an H100: reading expert weights.  In an SD verify pass
// at batch 8 and gamma 4 there are 40 tokens, 320 routed rows, and nearly all
// 64 experts are hit, each by ~5 rows: the fused kernel must read ~2.35 GB of
// Wg+Wu per layer and the down kernel ~1.17 GB, against ~11.7 and ~5.9
// GFLOP.  At 3.35 TB/s and 989 TFLOP/s the bytes take ~60x longer than the
// operations, so the kernels are memory bound and the goal is to stream
// every touched weight tile once, with enough loads in flight, spending as
// few instructions per weight byte as possible.
//
// What the design does about it:
//   * Work list.  The wrapper builds (on the device, no host sync) the
//     visit list of ragged.py:make_group_metadata: one visit per (expert,
//     m-tile) pair that holds rows of that expert; an empty expert costs no
//     visit.  The grid is (n-tiles, static upper bound on visits); blocks
//     past num_visits exit at once.
//   * No carry between blocks.  The TPU kernel runs its grid in order and
//     carries one accumulator across the visits of an m-tile that straddles
//     two experts.  Here each block owns one (visit, n-tile) and writes only
//     rows [max(mt*BM, off[g]), min((mt+1)*BM, off[g+1])) of its tile, so
//     the visits sharing a straddled tile write disjoint rows and nothing
//     accumulates across blocks.
//   * Row tiles of 16 (verify: ~5 rows per expert) or 64 (prefill), so each
//     weight tile is read by as few visits as possible.
//   * bf16 runs on the tensor cores (WMMA 16x16x16, fp32 accumulators): the
//     weight and x tiles are copied into shared memory with 16-byte loads
//     and fed to the tensor cores as they are, so a block spends a handful
//     of instructions per tile and the 16-row tile costs no more than the
//     ~5 rows it holds.  The fused kernel reads each x tile once for both
//     products and applies the activation on the accumulator fragments.
//   * fp32 (used by the parity checks) runs on the CUDA cores in full fp32,
//     with the accumulators in registers.
//   * Simple and right first: no TMA, no wgmma, no multi-stage pipeline;
//     those are later work.
//
// Plain C interface for ctypes; each launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 64;                       // output columns per block

template <int ACT> __device__ __forceinline__ float activate(float g);
template <> __device__ __forceinline__ float activate<0>(float g) {   // silu
  return g / (1.0f + expf(-g));
}
template <> __device__ __forceinline__ float activate<1>(float g) {   // gelu (tanh)
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g)));
}

// Stage a ROWS x COLS tile of a row-major matrix (leading dimension ld) into
// shared memory (pitch PITCH elements).  Tile row i is global row row0 + i;
// it is read only if it lies in [row_lo, row_hi), and column c only if
// c < col_end.  Everything else is 0.  With vec, aligned 16-byte chunks are
// loaded whole; they are stored whole where the pitch keeps shared-memory
// rows 16-byte aligned.
template <typename T, int ROWS, int COLS, int PITCH, int NT>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src,
                                           long long ld, int row0, int row_lo,
                                           int row_hi, int col0, int col_end,
                                           bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS_PER_ROW = COLS / VEC;
  constexpr int CHUNKS = ROWS * CHUNKS_PER_ROW;
  for (int c = threadIdx.x; c < CHUNKS; c += NT) {
    const int i = c / CHUNKS_PER_ROW;
    const int j = (c % CHUNKS_PER_ROW) * VEC;
    const int grow = row0 + i;
    const int gcol = col0 + j;
    T* d = dst + i * PITCH + j;
    const bool row_ok = grow >= row_lo && grow < row_hi;
    alignas(16) T vals[VEC];
    if (row_ok && vec && gcol + VEC <= col_end) {
      *reinterpret_cast<uint4*>(vals) =
          __ldg(reinterpret_cast<const uint4*>(src + grow * ld + gcol));
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        vals[v] = (row_ok && gcol + v < col_end) ? src[grow * ld + gcol + v] : T(0.0f);
    }
    if constexpr (PITCH * sizeof(T) % 16 == 0) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(vals);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[v] = vals[v];
    }
  }
}

struct Visit {
  int g, tile0, row_lo, row_hi;
};

// The visit of blockIdx.y, or row_lo >= row_hi when the block has no work.
template <int BM>
__device__ __forceinline__ Visit visit_of(const int* offs, const int* gids,
                                          const int* mtids, const int* nvis) {
  Visit v{0, 0, 0, 0};
  const int i = blockIdx.y;
  if (i >= nvis[0]) return v;                // padding visit: no work
  v.g = gids[i];
  v.tile0 = mtids[i] * BM;
  v.row_lo = max(v.tile0, offs[v.g]);
  v.row_hi = min(v.tile0 + BM, offs[v.g + 1]);
  return v;
}

// ---------------------------------------------------------------- bf16 path
// One block: visit blockIdx.y x output columns [blockIdx.x*BN, +BN).  NMAT = 2
// is the fused gate+up kernel, 1 the plain ragged product.  x is (N, K),
// each w (E, K, F), out (N, F).  Each warp owns TPW 16x16 output tiles.
template <int BM, int NMAT, int ACT>
__global__ void __launch_bounds__(BM == 16 ? 128 : 256)
ragged_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                 const bf16* __restrict__ w1, bf16* __restrict__ out,
                 const int* __restrict__ offs, const int* __restrict__ gids,
                 const int* __restrict__ mtids, const int* __restrict__ nvis,
                 int K, int F, bool vec) {
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
  constexpr int STAGE_BYTES = X_BYTES + NMAT * W_BYTES;
  constexpr int OUT_BYTES = BM * OP * 4;
  constexpr int SMEM = STAGE_BYTES > OUT_BYTES ? STAGE_BYTES : OUT_BYTES;
  static_assert(X_BYTES % 32 == 0 && W_BYTES % 32 == 0, "wmma needs 32B alignment");
  // staging tiles, reused for the fp32 output tile after the K loop
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + X_BYTES);
  float* os = reinterpret_cast<float*>(smem);

  const Visit v = visit_of<BM>(offs, gids, mtids, nvis);
  if (v.row_lo >= v.row_hi) return;
  const int col0 = blockIdx.x * BN;
  const long long wstride = static_cast<long long>(K) * F;
  const bf16* wmat[2] = {w0 + v.g * wstride, NMAT == 2 ? w1 + v.g * wstride : nullptr};
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NMAT][TPW];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int t = 0; t < TPW; ++t) wmma::fill_fragment(acc[m][t], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_tile<bf16, BM, BK, XP, NT>(xs, x, K, v.tile0, v.row_lo, v.row_hi, k0, K, vec);
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
      stage_tile<bf16, BK, BN, WP, NT>(ws + m * BK * WP, wmat[m], F, k0, 0, K,
                                             col0, F, vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int t = 0; t < TPW; ++t) {
        const int tile = warp + t * NWARPS;
        const int tr = tile / TILES_N, tc = tile % TILES_N;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + tr * 16 * XP + kk * 16, XP);
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, ws + m * BK * WP + kk * 16 * WP + tc * 16, WP);
          wmma::mma_sync(acc[m][t], a, b, acc[m][t]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: act(gate) * up on the fragments (same type, same layout),
  // through shared memory, then only this visit's rows to device memory
#pragma unroll
  for (int t = 0; t < TPW; ++t) {
    const int tile = warp + t * NWARPS;
    const int tr = tile / TILES_N, tc = tile % TILES_N;
    if (NMAT == 2) {
#pragma unroll
      for (int i = 0; i < acc[0][t].num_elements; ++i)
        acc[0][t].x[i] = activate<ACT>(acc[0][t].x[i]) * acc[NMAT - 1][t].x[i];
    }
    wmma::store_matrix_sync(os + tr * 16 * OP + tc * 16, acc[0][t], OP, wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
    const int r = idx / BN, c = idx % BN;
    const int grow = v.tile0 + r, gcol = col0 + c;
    if (grow >= v.row_lo && grow < v.row_hi && gcol < F)
      out[static_cast<long long>(grow) * F + gcol] = __float2bfloat16_rn(os[r * OP + c]);
  }
}

// ---------------------------------------------------------------- fp32 path
template <int BM, int NMAT, int ACT>
__global__ void __launch_bounds__(256)
ragged_simt_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                   const float* __restrict__ w1, float* __restrict__ out,
                   const int* __restrict__ offs, const int* __restrict__ gids,
                   const int* __restrict__ mtids, const int* __restrict__ nvis,
                   int K, int F, bool vec) {
  constexpr int NT = 256;
  constexpr int BK = 32;
  constexpr int COL_GROUPS = BN / 4;         // 16 threads span 64 columns
  constexpr int ROW_GROUPS = NT / COL_GROUPS;
  constexpr int RM = BM / ROW_GROUPS;        // rows per thread
  constexpr int WP = BN + 4;                 // keeps float4 rows 16B aligned
  constexpr int XP = BK + 1;                 // odd pitch: no bank conflicts
  static_assert(RM * ROW_GROUPS == BM, "BM must be a multiple of 16");
  __shared__ float xs[BM * XP];
  __shared__ __align__(16) float ws[NMAT][BK * WP];

  const Visit v = visit_of<BM>(offs, gids, mtids, nvis);
  if (v.row_lo >= v.row_hi) return;
  const int col0 = blockIdx.x * BN;
  const long long wstride = static_cast<long long>(K) * F;
  const float* wmat[2] = {w0 + v.g * wstride, NMAT == 2 ? w1 + v.g * wstride : nullptr};
  const int cg = threadIdx.x % COL_GROUPS;
  const int rg = threadIdx.x / COL_GROUPS;
  float acc[NMAT][RM][4];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_tile<float, BM, BK, XP, NT>(xs, x, K, v.tile0, v.row_lo, v.row_hi, k0, K, vec);
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
      stage_tile<float, BK, BN, WP, NT>(ws[m], wmat[m], F, k0, 0, K, col0, F, vec);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float4 wv[NMAT];
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
        wv[m] = *reinterpret_cast<const float4*>(&ws[m][k * WP + cg * 4]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float xv = xs[(rg + i * ROW_GROUPS) * XP + k];
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          acc[m][i][0] = fmaf(xv, wv[m].x, acc[m][i][0]);
          acc[m][i][1] = fmaf(xv, wv[m].y, acc[m][i][1]);
          acc[m][i][2] = fmaf(xv, wv[m].z, acc[m][i][2]);
          acc[m][i][3] = fmaf(xv, wv[m].w, acc[m][i][3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = v.tile0 + rg + i * ROW_GROUPS;
    if (r < v.row_lo || r >= v.row_hi) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + cg * 4 + j;
      if (c >= F) continue;
      out[static_cast<long long>(r) * F + c] =
          NMAT == 2 ? activate<ACT>(acc[0][i][j]) * acc[NMAT - 1][i][j] : acc[0][i][j];
    }
  }
}

template <typename T, int BM, int NMAT, int ACT>
int launch(const void* x, const void* w0, const void* w1, void* out,
           const void* offs, const void* gids, const void* mtids,
           const void* nvis, int K, int F, int t_max, int vec, void* stream) {
  const dim3 grid((F + BN - 1) / BN, t_max);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(offs);
  const int* g = static_cast<const int*>(gids);
  const int* mt = static_cast<const int*>(mtids);
  const int* nv = static_cast<const int*>(nvis);
  if constexpr (std::is_same<T, bf16>::value) {
    ragged_tc_kernel<BM, NMAT, ACT><<<grid, BM == 16 ? 128 : 256, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w0), static_cast<const T*>(w1),
        static_cast<T*>(out), o, g, mt, nv, K, F, vec != 0);
  } else {
    ragged_simt_kernel<BM, NMAT, ACT><<<grid, 256, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w0), static_cast<const T*>(w1),
        static_cast<T*>(out), o, g, mt, nv, K, F, vec != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NMAT, int ACT>
int launch_bm(int bm, const void* x, const void* w0, const void* w1, void* out,
              const void* offs, const void* gids, const void* mtids,
              const void* nvis, int K, int F, int t_max, int vec, void* stream) {
  if (bm == 16)
    return launch<T, 16, NMAT, ACT>(x, w0, w1, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream);
  if (bm == 64)
    return launch<T, 64, NMAT, ACT>(x, w0, w1, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  bm: 16 or 64.  act: 0 = silu, 1 = gelu (tanh).
// Metadata pointers are device int32 arrays from make_group_metadata.
extern "C" int fused_gate_up_launch(int dtype, int bm, int act, const void* x,
                                    const void* wg, const void* wu, void* out,
                                    const void* offs, const void* gids,
                                    const void* mtids, const void* nvis, int K,
                                    int F, int t_max, int vec, void* stream) {
  if (dtype == 0 && act == 0)
    return launch_bm<bf16, 2, 0>(bm, x, wg, wu, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream);
  if (dtype == 0 && act == 1)
    return launch_bm<bf16, 2, 1>(bm, x, wg, wu, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream);
  if (dtype == 1 && act == 0)
    return launch_bm<float, 2, 0>(bm, x, wg, wu, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream);
  if (dtype == 1 && act == 1)
    return launch_bm<float, 2, 1>(bm, x, wg, wu, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ragged_gmm_launch(int dtype, int bm, const void* x, const void* w,
                                 void* out, const void* offs, const void* gids,
                                 const void* mtids, const void* nvis, int K, int F,
                                 int t_max, int vec, void* stream) {
  if (dtype == 0)
    return launch_bm<bf16, 1, 0>(bm, x, w, nullptr, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream);
  if (dtype == 1)
    return launch_bm<float, 1, 0>(bm, x, w, nullptr, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
