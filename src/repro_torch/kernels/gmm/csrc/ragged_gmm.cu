// Ragged grouped matmul for the MoE expert FFN, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/gmm/ragged.py:
//   * _fused_kernel  -> ragged_launch(nmat 2): act(x @ Wg[e]) * (x @ Wu[e])
//   * _ragged_kernel -> ragged_launch(nmat 1): x @ W[e]
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
// Two bodies, one per element type, both on expert-aligned items built
// inside the kernel from group_sizes (no visit list, no host sync), so an
// expert's weight tiles are read once per chunk of its rows:
//   * bf16: ragged_sm90.cuh, one kernel for both products on a persistent
//     TMA + wgmma mainloop, chunks of 64 rows; its producer issues TMA loads
//     where TMA can address the operands and stages them by cp.async into
//     the same swizzled tiles otherwise (any K, F and base).
//   * fp32 (the parity checks; every reduced config): the CUDA-core body
//     below (simt90), full fp32 (fmaf, no TF32).  At SD verify it is bound
//     by the weight bytes (1.38 ms fused, 0.69 ms down, at 3.35 TB/s); at a
//     prefill of 64 rows an expert by its operations at 67 TFLOP/s (2.24 ms
//     fused).
//
// Plain C interface for ctypes; each launcher returns cudaGetLastError(), or
// a negative code for arguments it refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ragged_sm90.cuh"

namespace {

using ragged90::activate;

// -------------------------------------------------- fp32, CUDA cores, cp.async
//
// Following gmm_capacity.cu's simt90 kernel: a ring of STAGES stages of BK of
// K, the weight tile filled by cp.async three stages ahead, x through
// registers (loaded three stages ahead, stored transposed, K-major, after
// this stage's FMAs), one barrier a stage.
//   * An item is (expert, chunk of BM = 64 of its rows, column tile), the
//     items of ragged_sm90.cuh, numbered alike; a block takes one (the grid
//     covers the most the routing could give, blocks past the list exit).
//     Its warp 0 finds the item by scanning group_sizes 32 experts at a
//     time, so there is no table and no limit on E.
//   * The stage's weight tile is BK x 128 floats: 128 output columns of w
//     (down), or 64 columns of wg beside the same 64 of wu (fused).  Each
//     thread owns 8 rows x 8 of those columns, (4 + 4, 64 apart): for the
//     fused product its gate and up sums of the same 4 output columns, so
//     act(g) * u is formed in registers.  Per k it reads 2 float4 of x (the
//     warp's two 8-row halves: broadcasts) and 2 float4 of w for 64 FMAs.
//   * The chunk's rows are cut into bands of 16, a warp's; the bands that
//     hold rows (RB: 1, 2 or 4, a power of two) split the 8 warps, and each
//     band's 8 / RB warps split every stage's K between them.  A chunk of
//     at most 8 rows (an AR or SD verify's) splits K 16 ways, a group for
//     each 8-row half of a warp.  So every chunk keeps all 8 warps on its
//     FMAs, and no warp multiplies rows past the expert's band.  At the
//     end the K groups' partial sums meet in shared memory, summed in a
//     fixed order.
//   * Rows past the expert's end and K or columns past the operands are
//     zeros; x rows past the expert's end are never read.  Copies are 16
//     bytes where the operand's pitch and base keep every piece aligned,
//     else 4 bytes (x through registers likewise), so one body takes every
//     shape and base; the store is float4 or element by element alike.
namespace simt90 {

constexpr int BM = 64;                       // rows per item (an expert chunk)
constexpr int BW = 128;                      // weight columns of a stage
constexpr int BK = 32;                       // K per stage
constexpr int STAGES = 4;                    // ring depth
constexpr int NT = 256;                      // 8 warps
constexpr int XP = BM + 4;                   // x tile pitch (K-major), 16-byte rows
constexpr int X_FLOATS = BK * XP;
constexpr int STAGE = X_FLOATS + BK * BW;
constexpr int BYTES = STAGES * STAGE * 4;
constexpr int KQ = BK / 4;                   // x: a thread loads 2 rows x 4 k
constexpr int RED_FLOATS = 8 * 16 * BW;      // the warps' partial sums at the end
static_assert(NT * 8 == BM * BK && NT / KQ * 2 == BM && RED_FLOATS <= STAGES * STAGE,
              "x staging covers the tile; the partials fit the ring");

// Output columns of an item: 128 of w, or 64 of act(g) * u.
template <int NMAT>
__host__ __device__ constexpr int out_cols() {
  return NMAT == 2 ? BW / 2 : BW;
}

struct Args {
  const float* x;                            // (N, K)
  const float* w;                            // (E, K, F): w, or wg
  const float* u;                            // (E, K, F): wu (fused), else w
  float* out;                                // (N, F)
  const int* sizes;                          // (E,)
  int N, K, F, E, tiles_n;
  int x_vec, w_vec, out_vec;                 // 16-byte pieces aligned
};

// A warp's share of a stage: KSPAN k of its 8 rows (x tile from xs, pitch
// XP) by its 8 columns (w tile from ws: 4, and 4 more BW / 2 on), into acc.
template <int KSPAN>
__device__ __forceinline__ void fma_span(float (&acc)[8][8], const float* xs, const float* ws) {
#pragma unroll
  for (int k = 0; k < KSPAN; ++k) {
    float av[8], bv[8];
    const float4 a0 = *reinterpret_cast<const float4*>(xs + k * XP);
    const float4 a1 = *reinterpret_cast<const float4*>(xs + k * XP + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(ws + k * BW);
    const float4 b1 = *reinterpret_cast<const float4*>(ws + k * BW + BW / 2);
    av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
    av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
    bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int NMAT, int ACT>
__global__ void __launch_bounds__(NT, 1)
ragged_simt90_kernel(const Args a) {
  constexpr int OC = out_cols<NMAT>();
  extern __shared__ __align__(16) float smem[];
  __shared__ int item[4];                    // expert, column tile, first row, end row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // ---- the item of this block: warp 0 scans the sizes, 32 experts at a time
  if (warp == 0) {
    const int t = blockIdx.x;
    int rows_before = 0, items_before = 0, found = 0;
    for (int e0 = 0; e0 < a.E && !found; e0 += 32) {
      const int e = e0 + lane;
      const int s = e < a.E ? a.sizes[e] : 0;
      const int n = (s + BM - 1) / BM * a.tiles_n;
      int s_incl = s, n_incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int ps = __shfl_up_sync(0xffffffffu, s_incl, o);
        const int pn = __shfl_up_sync(0xffffffffu, n_incl, o);
        if (lane >= o) {
          s_incl += ps;
          n_incl += pn;
        }
      }
      const int first = items_before + n_incl - n;       // this expert's first item
      if (n > 0 && t >= first && t < first + n) {
        const int chunks = (s + BM - 1) / BM, local = t - first;
        const int row_start = rows_before + s_incl - s;
        item[0] = e;
        item[1] = local / chunks;
        item[2] = row_start + (local % chunks) * BM;
        item[3] = row_start + s;
      }
      found = __any_sync(0xffffffffu, n > 0 && t >= first && t < first + n);
      rows_before += __shfl_sync(0xffffffffu, s_incl, 31);
      items_before += __shfl_sync(0xffffffffu, n_incl, 31);
    }
    if (lane == 0 && !found) item[0] = -1;
  }
  __syncthreads();
  if (item[0] < 0) return;                   // past the routing's items
  const int e = item[0], col0 = item[1] * OC, row0 = item[2], row_end = item[3];
  const int rows = min(BM, row_end - row0);
  // bands of 16 rows that hold rows (a power of two), and K groups a band
  const int rb = rows > 32 ? 4 : rows > 16 ? 2 : 1;
  const int band = warp % rb;
  // a chunk of at most 8 rows: a warp's two 8-row halves take two K groups
  // of the band's first 8 rows instead (the second half would only hold
  // padding), so the partial sums are 16 groups of 8 rows
  const bool half = rows <= 8;
  const int groups = half ? 16 : 8 / rb;                   // K groups
  const int g_rows = half ? 8 : rb * 16;                   // rows a group sums
  const int kg = half ? 2 * warp + lane / 16 : warp / rb;  // this lane's group
  const int kb = kg * (BK / groups);
  const long long wstride = static_cast<long long>(a.K) * a.F;

  // w: K tile kt into stage s by cp.async.  Column c of the tile is column
  // col0 + c of w (down), or col0 + c of wg (c < 64) / col0 + c - 64 of wu;
  // a thread's pieces share one column (16-byte pieces: 4 columns, K rows
  // tid / 32 + 8 p; 4-byte pieces: one column, K rows tid / 128 + 2 p)
  const int wc = a.w_vec ? 4 * (tid % 32) : tid % BW;
  const int wcol = col0 + (NMAT == 2 ? wc % (BW / 2) : wc);
  const float* wsrc = (NMAT == 2 && wc >= BW / 2 ? a.u : a.w) + e * wstride + wcol;
  const bool wcol_ok = wcol < a.F;
  const int wk0 = a.w_vec ? tid / 32 : tid / BW;
  auto stage_w = [&](int kt, int s) {
    float* ws = smem + s * STAGE + X_FLOATS + wc;
    const int k0 = kt * BK + wk0;
    if (a.w_vec) {
#pragma unroll
      for (int p = 0; p < BK * BW / 4 / NT; ++p) {
        const int k = k0 + (NT / 32) * p;
        const bool ok = wcol_ok && k < a.K;
        sm90::cp_async16(ws + (k - kt * BK) * BW, ok ? wsrc + static_cast<long long>(k) * a.F
                                                     : a.w, ok);
      }
    } else {
#pragma unroll
      for (int p = 0; p < BK * BW / NT; ++p) {
        const int k = k0 + (NT / BW) * p;
        const bool ok = wcol_ok && k < a.K;
        sm90::cp_async4(ws + (k - kt * BK) * BW, ok ? wsrc + static_cast<long long>(k) * a.F
                                                    : a.w, ok ? 4 : 0);
      }
    }
  };
  // x: K tile kt through registers: rows 2 m2 + {0, 1} at k 4 kq + {0..3}
  // (zeros past the expert's rows and past K), stored as float2 of the two
  // rows at each k of the transposed tile
  const int m2 = tid / KQ, kq = tid % KQ;
  const bool xrow_ok[2] = {row0 + 2 * m2 < row_end, row0 + 2 * m2 + 1 < row_end};
  const float* xsrc = a.x + static_cast<long long>(row0 + 2 * m2) * a.K + 4 * kq;
  float xr[2][4];
  auto load_x = [&](int kt) {
    const int k = kt * BK + 4 * kq;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float* src = xsrc + static_cast<long long>(q) * a.K + kt * BK;
      if (a.x_vec) {
        const float4 v = xrow_ok[q] && k < a.K ? *reinterpret_cast<const float4*>(src)
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
        xr[q][0] = v.x;
        xr[q][1] = v.y;
        xr[q][2] = v.z;
        xr[q][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) xr[q][j] = xrow_ok[q] && k + j < a.K ? src[j] : 0.f;
      }
    }
  };
  auto store_x = [&](int s) {
    float* xs = smem + s * STAGE;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(xs + (4 * kq + j) * XP + 2 * m2) =
          make_float2(xr[0][j], xr[1][j]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const bool active = band * 16 < rows;      // the warp's band holds rows
  const int r0 = band * 16 + (half ? 0 : 8 * (lane / 16)), c0 = 4 * (lane % 16);
  const int nk = (a.K + BK - 1) / BK;
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
    if (active) {
      const float* xs = smem + (kt % STAGES) * STAGE + kb * XP + r0;
      const float* ws = smem + (kt % STAGES) * STAGE + X_FLOATS + kb * BW + c0;
      if (half) fma_span<BK / 16>(acc, xs, ws);
      else if (rb == 1) fma_span<BK / 8>(acc, xs, ws);
      else if (rb == 2) fma_span<BK / 4>(acc, xs, ws);
      else fma_span<BK / 2>(acc, xs, ws);
    }
    if (next < nk) store_x(next % STAGES);
  }
  sm90::cp_async_wait<0>();
  __syncthreads();                           // the ring is free: partial sums

  // ---- the K groups' partial sums, [kg][band row (rb * 16)][BW], then one
  // pass over the item's outputs sums them in K order
  float* red = smem;
  if (active) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* d = red + (kg * g_rows + r0 + i) * BW;
      *reinterpret_cast<float4*>(d + c0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(d + BW / 2 + c0) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  __syncthreads();
  const int out_rows = min(rows, g_rows);
  for (int idx = tid; idx < out_rows * (OC / 4); idx += NT) {
    const int r = idx / (OC / 4), c = (idx % (OC / 4)) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f}, up[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < groups; ++q) {
      const float* sp = red + (q * g_rows + r) * BW + c;
      const float4 p = *reinterpret_cast<const float4*>(sp);
      v[0] += p.x; v[1] += p.y; v[2] += p.z; v[3] += p.w;
      if (NMAT == 2) {
        const float4 pu = *reinterpret_cast<const float4*>(sp + BW / 2);
        up[0] += pu.x; up[1] += pu.y; up[2] += pu.z; up[3] += pu.w;
      }
    }
    if (NMAT == 2) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = activate<ACT>(v[j]) * up[j];
    }
    const int col = col0 + c;
    float* o = a.out + static_cast<long long>(row0 + r) * a.F + col;
    if (a.out_vec && col + 3 < a.F) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < a.F) o[j] = v[j];
    }
  }
}

template <int NMAT, int ACT>
int launch(const Args& a, cudaStream_t stream) {
  static bool opted_in = false;              // per instantiation, per library
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_simt90_kernel<NMAT, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  // items <= (N / BM + E) * tiles_n: one block each, the rest exit
  const long long grid = (static_cast<long long>(a.N) / BM + a.E) * a.tiles_n;
  if (grid > 0x7fffffffLL) return -1;
  ragged_simt90_kernel<NMAT, ACT><<<static_cast<unsigned>(grid), NT, BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt90

}  // namespace

// Both products, both element types.  dtype 0 = bf16 (ragged_sm90.cuh),
// 1 = fp32 (simt90); nmat 1 = the down product x @ w[e] (u unused), 2 = the
// fused act(x @ w[e]) * (x @ u[e]); act 0 = silu, 1 = gelu (tanh).  x (N, K),
// w and u (E, K, F), out (N, F), contiguous on the device, any alignment of
// the element type; sizes (E,) int32 summing to at most N (rows past the
// groups are never stored).  *kernel is set to the body the call ran: 0 =
// bf16 with the TMA producer, 1 = bf16 with the staged producer, 2 = fp32;
// *launches to the kernel launches it made (the bf16 body launches once per
// window of ragged90::MAX_E = 512 experts).  -1 for arguments it
// refuses, -3/-4 when the CUDA driver cannot encode the tensor maps.
extern "C" int ragged_launch(int dtype, int nmat, int act, const void* x, const void* w,
                             const void* u, void* out, const void* sizes, int N, int K, int F,
                             int E, void* stream, int* kernel, int* launches) {
  if (N < 1 || K < 1 || F < 1 || E < 1 || (nmat != 1 && nmat != 2) || (act != 0 && act != 1))
    return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    int staged = 0;
    const int rc = nmat == 1 ? ragged90::launch<1, 0>(x, w, w, out, sizes, N, K, F, E, s, &staged)
                   : act == 0 ? ragged90::launch<2, 0>(x, w, u, out, sizes, N, K, F, E, s, &staged)
                              : ragged90::launch<2, 1>(x, w, u, out, sizes, N, K, F, E, s, &staged);
    *kernel = staged;
    *launches = ragged90::launches(E);
    return rc;
  }
  if (dtype != 1) return -1;
  const auto a16 = ragged90::aligned16;
  simt90::Args a{static_cast<const float*>(x), static_cast<const float*>(w),
                 static_cast<const float*>(nmat == 2 ? u : w), static_cast<float*>(out),
                 static_cast<const int*>(sizes), N, K, F, E, 0,
                 K % 4 == 0 && a16(x),
                 F % 4 == 0 && a16(w) && a16(nmat == 2 ? u : w),
                 F % 4 == 0 && a16(out)};
  const int cols = nmat == 2 ? simt90::out_cols<2>() : simt90::out_cols<1>();
  a.tiles_n = (F + cols - 1) / cols;
  *kernel = 2;
  *launches = 1;
  return nmat == 1 ? simt90::launch<1, 0>(a, s)
         : act == 0 ? simt90::launch<2, 0>(a, s)
                    : simt90::launch<2, 1>(a, s);
}

// Rows of one expert chunk of the bf16 body.
extern "C" int ragged_sm90_chunk_rows() { return ragged90::BM; }

// Output columns of one item of the bf16 body, for nmat weights (1 down,
// 2 fused gate/up).
extern "C" int ragged_sm90_tile_cols(int nmat) {
  return nmat == 2 ? ragged90::Tiles<2>::BN : ragged90::Tiles<1>::BN;
}

// Dynamic shared memory of a block of ragged_sm90_kernel<nmat, act, staged>
// (for reports; the same in both producer modes).
extern "C" int ragged_sm90_smem_bytes(int nmat, int act, int staged) {
  (void)act;
  (void)staged;
  return nmat == 2 ? ragged90::Tiles<2>::BYTES : ragged90::Tiles<1>::BYTES;
}

// Rows of one expert chunk, output columns of one item (nmat 1 down, 2
// fused gate/up) and dynamic shared memory of a block of the fp32 body
// ragged_simt90_kernel<nmat, act> (for reports).
extern "C" int ragged_simt90_chunk_rows() { return simt90::BM; }
extern "C" int ragged_simt90_tile_cols(int nmat) {
  return nmat == 2 ? simt90::out_cols<2>() : simt90::out_cols<1>();
}
extern "C" int ragged_simt90_smem_bytes(int nmat, int act) {
  (void)nmat;
  (void)act;
  return simt90::BYTES;
}
