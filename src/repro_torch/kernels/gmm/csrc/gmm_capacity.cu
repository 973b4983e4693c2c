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
// Three kernels; the wrapper (gmm.py, _route) picks one per call:
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
//   * gmm_capacity_simt_kernel, fp32 (used by the parity checks), on the CUDA
//     cores in full fp32.
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
    stage_tile<bf16, BM, BK, XP, NT>(xs, xe, K, row0, C, k0, K, false);
    stage_tile<bf16, BK, BN, WP, NT>(ws, we, F, k0, K, col0, F, false);
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

}  // namespace cap90

template <int BM>
int launch(int dtype, const void* x, const void* w, void* out, int E, int C,
           int K, int F, int vec, void* stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gmm_capacity_tc_kernel<BM><<<grid, BM == 16 ? 128 : 256, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), C, K, F);
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
// out (E, C, F), all contiguous on the device.  vec (fp32 only): every 16-byte
// chunk the kernel loads is aligned (K and F multiples of 16 bytes, aligned
// pointers); the bf16 WMMA kernel ignores it.
extern "C" int gmm_capacity_launch(int dtype, int bm, const void* x, const void* w,
                                   void* out, int E, int C, int K, int F, int vec,
                                   void* stream) {
  if (E < 1 || C < 1 || K < 1 || F < 1 || E > 65535 || (C + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 16) return launch<16>(dtype, x, w, out, E, C, K, F, vec, stream);
  if (bm == 64) return launch<64>(dtype, x, w, out, E, C, K, F, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (C <= 64) return cap90::launch<1, 128>(x, w, out, E, C, K, F, s);
  if (C <= 128) return cap90::launch<2, 128>(x, w, out, E, C, K, F, s);
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
