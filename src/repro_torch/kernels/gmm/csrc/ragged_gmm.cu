// Ragged grouped matmul for the MoE expert FFN, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/gmm/ragged.py:
//   * _fused_kernel  -> fused_gate_up_sm90_launch / fused_gate_up_launch:
//                       act(x @ Wg[e]) * (x @ Wu[e])
//   * _ragged_kernel -> ragged_gmm_sm90_launch / ragged_gmm_launch: x @ W[e]
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
// every touched weight tile once, with enough loads in flight.
//
// Two designs:
//   * bf16, whenever TMA can address x and every weight (ragged.py's
//     _route): ragged_sm90.cuh, one kernel for both products.  Its items
//     are expert-aligned (an expert's weight tiles read once per 64-row
//     chunk of its rows), built inside the kernel from group_sizes, on a
//     persistent TMA + wgmma mainloop.
//   * bf16 with 16-row tiles or shapes TMA cannot address (WMMA 16x16x16),
//     and fp32 (CUDA cores, full fp32): the kernels below, on the visit list
//     of ragged.py:make_group_metadata, one visit per (expert, m-tile) pair
//     that holds rows of that expert; an empty expert costs no visit.  The
//     grid is (n-tiles, static upper bound on visits); blocks past
//     num_visits exit at once.  The TPU kernel runs its grid in order and
//     carries one accumulator across the visits of an m-tile that straddles
//     two experts; here each block owns one (visit, n-tile) and writes only
//     rows [max(mt*BM, off[g]), min((mt+1)*BM, off[g+1])) of its tile, so
//     nothing accumulates across blocks.  Weight and x tiles are copied into
//     shared memory with 16-byte loads; the fused kernel reads each x tile
//     once for both products and applies the activation on the accumulator
//     fragments.
// Each launcher reports the kernel it ran.
//
// Plain C interface for ctypes; each launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "ragged_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 64;                       // output columns per block

using ragged90::activate;

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
// *kernel is set to the kernel the call launches: 1 = WMMA (bf16), 2 = the
// CUDA-core kernel (fp32).
extern "C" int fused_gate_up_launch(int dtype, int bm, int act, const void* x,
                                    const void* wg, const void* wu, void* out,
                                    const void* offs, const void* gids,
                                    const void* mtids, const void* nvis, int K,
                                    int F, int t_max, int vec, void* stream,
                                    int* kernel) {
  if (dtype == 0) {
    *kernel = 1;
    return act == 0 ? launch_bm<bf16, 2, 0>(bm, x, wg, wu, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream)
                    : launch_bm<bf16, 2, 1>(bm, x, wg, wu, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream);
  }
  if (dtype == 1) {
    *kernel = 2;
    return act == 0 ? launch_bm<float, 2, 0>(bm, x, wg, wu, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream)
                    : launch_bm<float, 2, 1>(bm, x, wg, wu, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// *kernel is set to the kernel the call launches: 1 = WMMA (bf16), 2 = the
// CUDA-core kernel (fp32).
extern "C" int ragged_gmm_launch(int dtype, int bm, const void* x, const void* w,
                                 void* out, const void* offs, const void* gids,
                                 const void* mtids, const void* nvis, int K, int F,
                                 int t_max, int vec, void* stream, int* kernel) {
  if (dtype == 0) {
    *kernel = 1;
    return launch_bm<bf16, 1, 0>(bm, x, w, nullptr, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream);
  }
  if (dtype == 1) {
    *kernel = 2;
    return launch_bm<float, 1, 0>(bm, x, w, nullptr, out, offs, gids, mtids, nvis, K, F, t_max, vec, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The sm90 launchers' common checks: sizes, x and the weights 16-byte
// aligned, K and F multiples of 8 (TMA's row pitch), out 4-byte aligned.
static bool sm90_args_ok(const void* x, const void* w, const void* u, const void* out, int N,
                         int K, int F, int E) {
  return N >= 1 && K >= 1 && F >= 1 && E >= 1 && E <= ragged90::MAX_E && K % 8 == 0 &&
         F % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 4 == 0;
}

// The down projection in bf16 through TMA and wgmma, on expert-aligned items
// of ragged_sm90_chunk_rows() rows built in the kernel from group_sizes.
// x (N, K), w (E, K, F), out (N, F), all contiguous on the device; sizes (E,)
// int32 summing to N (sm90_args_ok; the wrapper's _route).  *kernel is set
// to 0.  -1 for arguments it refuses, -3/-4 when the CUDA driver cannot
// encode the tensor maps.
extern "C" int ragged_gmm_sm90_launch(const void* x, const void* w, void* out,
                                      const void* sizes, int N, int K, int F, int E,
                                      void* stream, int* kernel) {
  if (!sm90_args_ok(x, w, w, out, N, K, F, E)) return -1;
  *kernel = 0;
  return ragged90::launch<1, 0>(x, w, nullptr, out, sizes, N, K, F, E,
                                static_cast<cudaStream_t>(stream));
}

// The fused gate/up product in bf16 on the same kernel: out = act(x @ wg[e])
// * (x @ wu[e]), wg and wu (E, K, F); act 0 = silu, 1 = gelu (tanh).  The
// rest as ragged_gmm_sm90_launch.
extern "C" int fused_gate_up_sm90_launch(int act, const void* x, const void* wg,
                                         const void* wu, void* out, const void* sizes, int N,
                                         int K, int F, int E, void* stream, int* kernel) {
  if (!sm90_args_ok(x, wg, wu, out, N, K, F, E) || (act != 0 && act != 1)) return -1;
  *kernel = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return act == 0 ? ragged90::launch<2, 0>(x, wg, wu, out, sizes, N, K, F, E, s)
                  : ragged90::launch<2, 1>(x, wg, wu, out, sizes, N, K, F, E, s);
}

// Rows of one expert chunk of the TMA kernel.
extern "C" int ragged_sm90_chunk_rows() { return ragged90::BM; }

// Output columns of one item of the TMA kernel, for nmat weights (1 down,
// 2 fused gate/up).
extern "C" int ragged_sm90_tile_cols(int nmat) {
  return nmat == 2 ? ragged90::Tiles<2>::BN : ragged90::Tiles<1>::BN;
}

// Dynamic shared memory of a block of ragged_sm90_kernel<nmat, act> (for
// reports).
extern "C" int ragged_sm90_smem_bytes(int nmat, int act) {
  (void)act;
  return nmat == 2 ? ragged90::Tiles<2>::BYTES : ragged90::Tiles<1>::BYTES;
}
