// One block of online-softmax attention for Hopper (sm_90a): the body of the
// dense decode/verify kernel (kernels/decode_attention/csrc/decode_attention.cu)
// at head dim 32, in bf16 and fp32, which only reduced configs have; head
// dims 64, 128 and 256 run the split-KV bodies (decode_sm90.cuh in bf16,
// decode_f32.cuh in fp32) at any number of query rows.  The flash prefill
// kernel has bodies of its own (flash_sm90.cuh in bf16, flash_f32.cuh in
// fp32).  The layout below is built for head dim 32 only.
//
// A block owns up to BM = 64 query rows that share one KV head and walks
// that head's keys in chunks of BK = 64:
//
//   out[row] = softmax_k( cap(q[row] . K[k] * scale) | visible(row, k) ) . V
//
// Row r of a block is query position t = t0 + r / G of query head
// hg * G + r % G: the decode kernel folds the g = Hq / Hkv heads of a KV head
// into the rows (G = g, as the TPU kernel folds them), so each staged K/V
// chunk serves every query head that reads it.  A row sits at query position
// base + t, where base is lengths[b] (or 0 without lengths, masking by
// index).  Key k is visible
// if k < kend and, when causal, k <= base + t and (window > 0) k > base + t -
// window; otherwise every key below S is.  Keys at or past kend = min(S, last
// query position + 1) are never read, so a dense cache's trash slot S is not
// either.
//
// Per chunk: S = Q K^T, an online-softmax step (running max, sum and
// correction per row, in fp32), O = O * corr + P V.  bf16 multiplies on the
// tensor cores (WMMA 16x16x16, fp32 accumulators, P rounded to bf16 as flash
// kernels on GPUs do); fp32 multiplies on the CUDA cores in full fp32, for the
// parity checks.  O lives in shared memory in fp32, so the per-row rescale
// does not depend on the WMMA fragment layout.  The next chunk's K and V are
// loaded into registers while the current one is computed.
//
// Inputs are read in place through element strides (batch, position, head;
// the head dim is contiguous), so neither the model's (B, T, H, D) tensors nor
// its (B, S+1, Hkv, D) cache is transposed or copied first.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

// Internal linkage: several kernel libraries are loaded into one process,
// and a template's static local (the opt-in flag of launch<>) with external
// linkage would be one object shared by every library built from this
// header, so a second one would skip its own shared-memory opt-in.
namespace attn {
namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;           // keys per chunk
constexpr int NT = 256;          // threads per block (8 warps)
constexpr int NWARPS = NT / 32;
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* lengths;            // (B,) query base positions, or nullptr: 0
  float* lse;                    // partial entry: (B, T, Hq) log-sum-exp, or nullptr
  int k_off;                     // partial entry: key 0's position
  long long sqb, sqt, sqh;       // strides in elements: batch, position, head
  long long skb, sks, skh;
  long long svb, svs, svh;
  long long sob, sot, soh;
  int T, S, Hq, Hkv;
  int G;                         // query heads folded into a block's rows
  int causal, window;
  float scale, cap;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

// Shared-memory layout (byte offsets, each section 128-byte aligned).  bf16:
// Q, K, V in bf16 with 8-element pads (16-byte aligned rows, rows spread over
// banks, WMMA's 32-byte tile alignment), S in fp32, P in bf16.  fp32: Q, K, V
// and S/P in fp32; K's pitch is odd so 16 threads reading 16 keys at one
// column hit 16 banks.
template <typename T, int D>
struct Layout {
  static_assert(D == 32, "built for head dim 32 only");
  static constexpr bool TC = std::is_same<T, bf16>::value;
  static constexpr int BM = 64;                    // query rows per block
  static constexpr int MI = BM / 16;               // 16-row tiles per block
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int QP = TC ? D + 8 : D;
  static constexpr int KP = TC ? D + 8 : D + 1;
  static constexpr int VP = TC ? D + 8 : D;
  static constexpr int SP = TC ? BK + 4 : BK;
  static constexpr int PP = BK + 8;              // bf16 only
  static constexpr int OP = TC ? D + 4 : D;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + round128(BM * QP * (int)sizeof(T));
  static constexpr int V_OFF = K_OFF + round128(BK * KP * (int)sizeof(T));
  static constexpr int S_OFF = V_OFF + round128(BK * VP * (int)sizeof(T));
  static constexpr int P_OFF = S_OFF + round128(BM * SP * 4);
  static constexpr int O_OFF = P_OFF + (TC ? round128(BM * PP * 2) : 0);
  static constexpr int M_OFF = O_OFF + round128(BM * OP * 4);
  static constexpr int BYTES = M_OFF + 2 * BM * 4;   // running max and sum
  static constexpr int VEC = 16 / (int)sizeof(T);    // elements per 16-byte load
  static constexpr int ROW_VECS = D / VEC;
  static constexpr int NV = BK * ROW_VECS / NT;      // K (and V) loads per thread
  static_assert(BK * ROW_VECS % NT == 0, "a chunk must split evenly over the block");
};

// Copy 16-byte chunks of element type T into shared memory: whole when the
// destination pitch keeps rows 16-byte aligned, else element by element.
template <typename T, int PITCH>
__device__ __forceinline__ void put16(T* dst, const uint4& raw) {
  if constexpr (PITCH * sizeof(T) % 16 == 0) {
    *reinterpret_cast<uint4*>(dst) = raw;
  } else {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 16 / (int)sizeof(T); ++i) dst[i] = e[i];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, Layout<T, D>::MIN_BLOCKS)
attention_tile_kernel(const Params p) {
  using L = Layout<T, D>;
  constexpr int BM = L::BM, MI = L::MI;
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q_OFF);
  T* Ks = reinterpret_cast<T*>(smem + L::K_OFF);
  T* Vs = reinterpret_cast<T*>(smem + L::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  float* Ms = reinterpret_cast<float*>(smem + L::M_OFF);
  float* Ls = Ms + BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, hg = blockIdx.y;
  const int G = p.G, g = p.Hq / p.Hkv;
  const int tp = BM / G;                         // query positions per block
  const int t0 = blockIdx.x * tp;
  const int n_pos = min(tp, p.T - t0);
  const int rows = n_pos * G;
  const int kvh = hg * G / g;
  // key k sits at position k_off + k: a row's base shifts by -k_off
  const int base = (p.lengths != nullptr ? p.lengths[b] : 0) - p.k_off;
  const T* kg = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* vg = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;

  // keys this block may see: [kstart, kend)
  const int q_first = base + t0, q_last = base + t0 + n_pos - 1;
  int kstart = 0, kend = p.S;
  if (p.causal) {
    kend = min(p.S, q_last + 1);
    if (p.window > 0) kstart = max(0, q_first - p.window + 1);
  }

  // ---- the block's query rows (zeros past `rows`), running state, O = 0
  for (int v = tid; v < BM * L::ROW_VECS; v += NT) {
    const int r = v / L::ROW_VECS, col = (v % L::ROW_VECS) * L::VEC;
    uint4 raw = make_uint4(0, 0, 0, 0);          // zero bits are 0.0 in both types
    if (r < rows) {
      const int t = t0 + r / G, h = hg * G + r % G;
      raw = *reinterpret_cast<const uint4*>(
          static_cast<const T*>(p.q) + b * p.sqb + t * p.sqt + h * p.sqh + col);
    }
    put16<T, L::QP>(Qs + r * L::QP + col, raw);
  }
  for (int i = tid; i < BM * L::OP; i += NT) Os[i] = 0.f;
  if constexpr (L::TC) {
    for (int i = tid; i < BM * L::PP; i += NT) Ps[i] = from_f<bf16>(0.f);
  }
  if (tid < BM) {
    Ms[tid] = NEG_INF;
    Ls[tid] = 0.f;
  }

  // K/V chunk in flight: NV 16-byte loads of each, issued before any is used
  uint4 rk[L::NV], rv[L::NV];
  auto load_chunk = [&](int kbase) {
#pragma unroll
    for (int j = 0; j < L::NV; ++j) {
      const int v = tid + j * NT;
      const int key = kbase + v / L::ROW_VECS, col = (v % L::ROW_VECS) * L::VEC;
      if (key < kend) {
        rk[j] = *reinterpret_cast<const uint4*>(kg + key * p.sks + col);
        rv[j] = *reinterpret_cast<const uint4*>(vg + key * p.svs + col);
      } else {
        rk[j] = make_uint4(0, 0, 0, 0);
        rv[j] = make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto store_chunk = [&]() {
#pragma unroll
    for (int j = 0; j < L::NV; ++j) {
      const int v = tid + j * NT;
      const int key = v / L::ROW_VECS, col = (v % L::ROW_VECS) * L::VEC;
      put16<T, L::KP>(Ks + key * L::KP + col, rk[j]);
      put16<T, L::VP>(Vs + key * L::VP + col, rv[j]);
    }
  };

  const int mt = (rows + 15) / 16;               // 16-row tiles holding rows
  if (kstart < kend) load_chunk(kstart);
  for (int kbase = kstart; kbase < kend; kbase += BK) {
    store_chunk();
    __syncthreads();
    if (kbase + BK < kend) load_chunk(kbase + BK);   // lands during compute

    // ---- S = Q K^T over this chunk (rows < mt * 16)
    if constexpr (L::TC) {
      for (int tile = warp; tile < mt * (BK / 16); tile += NWARPS) {
        const int tr = tile / (BK / 16), tc = tile % (BK / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(a, Qs + tr * 16 * L::QP + kk * 16, L::QP);
          wmma::load_matrix_sync(bt, Ks + tc * 16 * L::KP + kk * 16, L::KP);
          wmma::mma_sync(acc, a, bt, acc);
        }
        wmma::store_matrix_sync(Ss + tr * 16 * L::SP + tc * 16, acc, L::SP,
                                wmma::mem_row_major);
      }
    } else {
      // thread (ty, tx): rows ty + 16 i, keys tx + 16 j
      const int ty = tid / 16, tx = tid % 16;
      float s[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = to_f(Ks[(tx + 16 * j) * L::KP + d]);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (i < mt) {
            const float qv = to_f(Qs[(ty + 16 * i) * L::QP + d]);
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ss[(ty + 16 * i) * L::SP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // ---- online softmax: one warp per row, two keys per lane; the same warp
    // rescales the row of O by the correction
    for (int r = warp; r < rows; r += NWARPS) {
      const int qpos = base + t0 + r / G;
      float sv[2];
      bool ok[2];
      float cmax = NEG_INF;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = lane + 32 * e;
        const int key = kbase + kk;
        float x = Ss[r * L::SP + kk] * p.scale;
        if (p.cap > 0.f) x = tanhf(x / p.cap) * p.cap;
        bool vis = key < kend;
        if (p.causal) {
          vis = vis && key <= qpos;
          if (p.window > 0) vis = vis && key > qpos - p.window;
        }
        ok[e] = vis;
        sv[e] = x;
        if (vis) cmax = fmaxf(cmax, x);
      }
      cmax = warp_max(cmax);
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, cmax);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pr = ok[e] ? expf(sv[e] - m_new) : 0.f;
        if constexpr (L::TC) {
          Ps[r * L::PP + lane + 32 * e] = __float2bfloat16_rn(pr);
        } else {
          Ss[r * L::SP + lane + 32 * e] = pr;
        }
        psum += pr;
      }
      psum = warp_sum(psum);
      const float corr = expf(m_old - m_new);
      for (int d = lane; d < D; d += 32) Os[r * L::OP + d] *= corr;
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * corr + psum;
      }
    }
    __syncthreads();

    // ---- O += P V
    if constexpr (L::TC) {
      for (int tile = warp; tile < mt * (D / 16); tile += NWARPS) {
        const int tr = tile / (D / 16), tc = tile % (D / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, Os + tr * 16 * L::OP + tc * 16, L::OP,
                               wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(a, Ps + tr * 16 * L::PP + kk * 16, L::PP);
          wmma::load_matrix_sync(bv, Vs + kk * 16 * L::VP + tc * 16, L::VP);
          wmma::mma_sync(acc, a, bv, acc);
        }
        wmma::store_matrix_sync(Os + tr * 16 * L::OP + tc * 16, acc, L::OP,
                                wmma::mem_row_major);
      }
    } else {
      // thread (ty, tx): rows ty + 16 i, columns tx + 16 j
      constexpr int CJ = D / 16;
      const int ty = tid / 16, tx = tid % 16;
      float o[MI][CJ];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          o[i][j] = i < mt ? Os[(ty + 16 * i) * L::OP + tx + 16 * j] : 0.f;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float vv[CJ];
#pragma unroll
        for (int j = 0; j < CJ; ++j) vv[j] = to_f(Vs[kk * L::VP + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (i < mt) {
            const float pr = Ss[(ty + 16 * i) * L::SP + kk];
#pragma unroll
            for (int j = 0; j < CJ; ++j) o[i][j] = fmaf(pr, vv[j], o[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
        if (i < mt)
#pragma unroll
          for (int j = 0; j < CJ; ++j) Os[(ty + 16 * i) * L::OP + tx + 16 * j] = o[i][j];
    }
    __syncthreads();
  }

  // a block that sees no key (the partial entry's rows all before its
  // block) ran no chunk, whose barriers order the initialisation above
  // before the reads below
  if (kstart >= kend) __syncthreads();

  // ---- emit O / l in the element type
  T* out = static_cast<T*>(p.out);
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = t0 + r / G, h = hg * G + r % G;
    const float inv = 1.f / fmaxf(Ls[r], 1e-30f);
    out[b * p.sob + t * p.sot + h * p.soh + d] = from_f<T>(Os[r * L::OP + d] * inv);
  }
  if (p.lse != nullptr) {
    // natural log-sum-exp of the row's scores; -inf where it saw no key
    for (int r = tid; r < rows; r += NT) {
      const int t = t0 + r / G, h = hg * G + r % G;
      p.lse[(static_cast<long long>(b) * p.T + t) * p.Hq + h] =
          Ls[r] > 0.f ? Ms[r] + logf(Ls[r]) : __int_as_float(0xff800000);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int B, void* stream) {
  using L = Layout<T, D>;
  if (p.G > L::BM) return -1;
  static bool opted_in = false;                  // per instantiation
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(attention_tile_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const int tp = L::BM / p.G;
  dim3 grid((p.T + tp - 1) / tp, p.Hq / p.G, B);
  attention_tile_kernel<T, D><<<grid, NT, L::BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The 12 strides in the order q (b, t, h), k (b, s, h), v (b, s, h),
// out (b, t, h).
inline void set_strides(Params& p, const long long* st) {
  p.sqb = st[0]; p.sqt = st[1]; p.sqh = st[2];
  p.skb = st[3]; p.sks = st[4]; p.skh = st[5];
  p.svb = st[6]; p.svs = st[7]; p.svh = st[8];
  p.sob = st[9]; p.sot = st[10]; p.soh = st[11];
}

}  // namespace
}  // namespace attn
