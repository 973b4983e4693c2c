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
// What the design does about it:
//   * One block per (64-column tile, row tile, expert); blocks run in no order,
//     so the TPU grid's sequential K axis is a loop inside the block and the
//     accumulators stay in registers (the TPU kernel's VMEM scratch).
//   * Row tiles of 64, or 16 when C < 64 (the reference's tests use C = 4):
//     a weight tile is read once per row tile, twice at C = 128.
//   * bf16 runs on the tensor cores (WMMA 16x16x16, fp32 accumulators), the
//     tiles copied into shared memory with 16-byte loads; fp32 (used by the
//     parity checks) runs on the CUDA cores in full fp32.
//   * Rows at or past C and columns at or past F are masked, so C and F need
//     not be multiples of the tiles.
//   * The tiles are those of ragged_gmm.cu with the visit list replaced by
//     the fixed bins.  Simple and right first: no TMA, no wgmma, no pipeline.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 64;                       // output columns per block

// Stage a ROWS x COLS tile of a row-major matrix (leading dimension ld) into
// shared memory (pitch PITCH elements).  Tile row i is global row row0 + i,
// read only if it is below row_end, and column c only if it is below col_end;
// everything else is 0.  With vec, aligned 16-byte chunks are loaded whole.
template <typename T, int ROWS, int COLS, int PITCH, int NT>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src,
                                           long long ld, int row0, int row_end,
                                           int col0, int col_end, bool vec) {
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

// ---------------------------------------------------------------- bf16 path
// One block: expert blockIdx.z, rows [blockIdx.y*BM, +BM) of its bin, output
// columns [blockIdx.x*BN, +BN).  Each warp owns TPW 16x16 output tiles.
template <int BM>
__global__ void __launch_bounds__(BM == 16 ? 128 : 256)
gmm_capacity_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       bf16* __restrict__ out, int C, int K, int F, bool vec) {
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
    stage_tile<bf16, BM, BK, XP, NT>(xs, xe, K, row0, C, k0, K, vec);
    stage_tile<bf16, BK, BN, WP, NT>(ws, we, F, k0, K, col0, F, vec);
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

// ---------------------------------------------------------------- fp32 path
template <int BM>
__global__ void __launch_bounds__(256)
gmm_capacity_simt_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         float* __restrict__ out, int C, int K, int F, bool vec) {
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
    stage_tile<float, BM, BK, XP, NT>(xs, xe, K, row0, C, k0, K, vec);
    stage_tile<float, BK, BN, WP, NT>(ws, we, F, k0, K, col0, F, vec);
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

template <int BM>
int launch(int dtype, const void* x, const void* w, void* out, int E, int C,
           int K, int F, int vec, void* stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gmm_capacity_tc_kernel<BM><<<grid, BM == 16 ? 128 : 256, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), C, K, F, vec != 0);
  } else if (dtype == 1) {
    gmm_capacity_simt_kernel<BM><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), C, K, F, vec != 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  bm: 16 or 64.  x (E, C, K), w (E, K, F),
// out (E, C, F), all contiguous on the device.  vec: every 16-byte chunk the
// kernel loads is aligned (K and F multiples of 16 bytes, aligned pointers).
extern "C" int gmm_capacity_launch(int dtype, int bm, const void* x, const void* w,
                                   void* out, int E, int C, int K, int F, int vec,
                                   void* stream) {
  if (E < 1 || C < 1 || K < 1 || F < 1 || E > 65535 || (C + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 16) return launch<16>(dtype, x, w, out, E, C, K, F, vec, stream);
  if (bm == 64) return launch<64>(dtype, x, w, out, E, C, K, F, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
