// Paged decode / SD-verify attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _paged_decode_kernel of
// src/repro/kernels/decode_attention/decode_attention.py (called through
// paged_decode_attention_bhtd).  T = gamma+1 <= 8 fresh queries per sequence
// sit at positions length[b] + t and attend, causally, to the K/V pages the
// block table maps for that sequence:
//
//   out[b, t, h*g + i] = softmax_k( cap(q . K[b, k] * scale) | k <= len + t ) . V
//
// with K[b, k] = k_pages[table[b, k / ps], k % ps, h], g = Hq / Hkv query
// heads per KV head, and cap(s) = tanh(s / c) * c when logit_cap c > 0.
// Pages past length + T - 1 are never read; the softmax is online (running
// max, sum and accumulator in fp32), the result is cast to q's dtype.
//
// What bounds it on an H100: reading the K/V pages.  At the serve shape
// (8 sequences, ~130 cached positions, 4 KV heads of 128, bf16) one call
// must read ~1 MB, ~0.3 us at 3.35 TB/s, and its FLOPs are negligible, so
// at short context launch latency sets the time; at 8k positions a call
// reads ~134 MB, a floor of ~40 us, and the kernel is memory bound: the
// keys have to be spread over every SM with loads in flight on each.
//
// Three bodies; the launcher picks one per call and reports which:
//   * bf16 at head dims 64, 128 and 256, pages of 8, 16, 32 or a multiple
//     of 64 (every call of the served models): paged_sm90.cuh.  Split-KV
//     over a (splits, Hkv, B) grid with a combine kernel, a producer warp
//     keeping TMA page loads in flight in a ring of 64-key chunks, both
//     products as wgmma with the softmax in registers.  At D 256 the O
//     accumulator is 128 registers a thread and a K+V chunk 64 KB, so the
//     ring holds 3 chunks.
//   * fp32 (the parity checks) at the same head dims and any page size:
//     kernels/csrc/decode_f32.cuh, the same split plan and combine on the
//     CUDA cores in full fp32 (K/V chunks by cp.async, each key's page
//     looked up in the table; q and O in registers).
//   * bf16 on pages that do not tile a 64-key chunk, at head dims 64 and
//     128 (no served path has them): the CUDA-core body below, one block
//     per (KV head, sequence), unchanged since it was written.
//
// The CUDA-core body:
//   * One block per (KV head h, sequence b).  The TPU kernel's grid
//     (B, Hkv, MP) carried the softmax state from page to page in VMEM; on
//     the GPU blocks run in no order, so the page walk is a loop inside the
//     block and the state stays in shared memory and registers.
//   * GQA folds into rows, as on the TPU: the g*T query rows of one KV head
//     (row r = t*g + i) are loaded once, and each staged K/V chunk is read
//     from device memory once for all of them.
//   * The block walks logical positions in chunks of 64 keys, looks each
//     key's physical page up in the table (int32, on the device: no host
//     sync), and copies the chunk's K and V with 16-byte loads that are all
//     issued before any is used, converting to fp32 in shared memory.
//     Positions past length + T - 1 are not loaded.
//   * Scores: each thread owns one key of the chunk and a quarter of the
//     head dim, for all rows; the quarters are summed with warp shuffles.
//     PV: each thread owns 4 columns of the head dim for a slice of rows.
//     All arithmetic is fp32 on the CUDA cores.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/decode_f32.cuh"
#include "paged_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;          // threads per block
constexpr int KT = 64;           // keys staged per chunk
constexpr int MAX_ROWS = 64;     // g * T query rows per block
constexpr int KPAD = 16;         // K row pad in floats: conflict-free float4 reads
constexpr float NEG_INF = -1e30f;

// 16-byte loads of the element type, converted to fp32
template <typename T> struct Vec;

template <> struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& raw, float* dst) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(h[e]);
      dst[2 * e] = f.x;
      dst[2 * e + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store4(bf16* dst, const float* v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
  }
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

template <int D>
constexpr size_t smem_floats(int rows) {
  return static_cast<size_t>(rows) * D          // Qs: query rows
         + static_cast<size_t>(KT) * (D + KPAD)  // Ks: staged keys
         + static_cast<size_t>(KT) * D           // Vs: staged values
         + static_cast<size_t>(rows) * KT        // Ss: scores, then probabilities
         + 3 * MAX_ROWS;                         // running max, sum, correction
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ lengths,
                    const int* __restrict__ table, T* __restrict__ out, int T_q,
                    int Hq, int Hkv, int ps, int MP, float scale, float cap) {
  constexpr int VN = Vec<T>::N;                // elements per 16-byte load
  constexpr int ROW_VECS = D / VN;             // 16-byte loads per key row
  constexpr int NV = KT * ROW_VECS / NT;       // loads per thread per matrix
  static_assert(KT * ROW_VECS % NT == 0, "chunk must split evenly");
  constexpr int DG = D / 4;                    // float4 column groups
  constexpr int RG = NT / DG;                  // row groups in the PV phase
  constexpr int RPT = MAX_ROWS / RG;           // rows per thread in the PV phase

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = Hq / Hkv;
  const int rows = g * T_q;

  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + rows * D;
  float* Vs = Ks + KT * (D + KPAD);
  float* Ss = Vs + KT * D;
  float* Ms = Ss + rows * KT;
  float* Ls = Ms + MAX_ROWS;
  float* Cs = Ls + MAX_ROWS;

  // ---- the block's query rows, once: row r = t * g + i -> head h * g + i
  for (int v = tid; v < rows * ROW_VECS; v += NT) {
    const int r = v / ROW_VECS, col = (v % ROW_VECS) * VN;
    const int t = r / g, i = r % g;
    const T* src = q + ((static_cast<int64_t>(b) * T_q + t) * Hq + h * g + i) * D + col;
    float f[VN];
    Vec<T>::unpack(*reinterpret_cast<const uint4*>(src), f);
#pragma unroll
    for (int e = 0; e < VN; ++e) Qs[r * D + col + e] = f[e];
  }
  if (tid < MAX_ROWS) {
    Ms[tid] = NEG_INF;
    Ls[tid] = 0.f;
  }

  const int length = lengths[b];
  const int limit = MP * ps;                   // logical positions the table maps
  const int last = min(length + T_q - 1, limit - 1);
  const int* trow = table + static_cast<int64_t>(b) * MP;
  const int64_t page_stride = static_cast<int64_t>(ps) * Hkv * D;

  // PV-phase ownership: 4 columns of the head dim for rows rg, rg+RG, ...
  const int dg = tid % DG, rg = tid / DG;
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  // score-phase ownership: key kk of the chunk, quarter qp of the head dim
  const int kk = warp * 8 + (lane >> 2), qp = lane & 3;

  for (int kbase = 0; kbase <= last; kbase += KT) {
    // ---- stage K and V of keys kbase .. kbase+KT-1: every load in flight first
    uint4 rk[NV], rv[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = tid + j * NT;
      const int key = v / ROW_VECS, col = (v % ROW_VECS) * VN;
      const int pos = kbase + key;
      if (pos <= last) {
        const int page = trow[pos / ps];
        const int64_t off = page * page_stride +
                            (static_cast<int64_t>(pos % ps) * Hkv + h) * D + col;
        rk[j] = *reinterpret_cast<const uint4*>(kp + off);
        rv[j] = *reinterpret_cast<const uint4*>(vp + off);
      } else {
        rk[j] = make_uint4(0, 0, 0, 0);        // zero bits are 0.0 in both types
        rv[j] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = tid + j * NT;
      const int key = v / ROW_VECS, col = (v % ROW_VECS) * VN;
      float f[VN];
      Vec<T>::unpack(rk[j], f);
#pragma unroll
      for (int e = 0; e < VN; ++e) Ks[key * (D + KPAD) + col + e] = f[e];
      Vec<T>::unpack(rv[j], f);
#pragma unroll
      for (int e = 0; e < VN; ++e) Vs[key * D + col + e] = f[e];
    }
    __syncthreads();

    // ---- scores: S[r][kk] = q[r] . K[kk] over this thread's quarter of D
    float s[MAX_ROWS];
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int j = 0; j < D / 16; ++j) {
      const int d = 4 * (qp + 4 * j);
      const float4 kv = *reinterpret_cast<const float4*>(&Ks[kk * (D + KPAD) + d]);
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r) {
        if (r < rows) {
          const float4 qv = *reinterpret_cast<const float4*>(&Qs[r * D + d]);
          s[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r < rows) {
        float v = s[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((r & 3) == qp) Ss[r * KT + kk] = v;
      }
    }
    __syncthreads();

    // ---- online softmax, one warp per row, two keys per lane
    for (int r = warp; r < rows; r += NT / 32) {
      const int qpos = length + r / g;
      float sv[2];
      bool ok[2];
      float cmax = NEG_INF;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = lane + 32 * e;
        const int pos = kbase + k;
        float x = Ss[r * KT + k] * scale;
        if (cap > 0.f) x = tanhf(x / cap) * cap;
        ok[e] = pos <= qpos && pos < limit;
        sv[e] = x;
        if (ok[e]) cmax = fmaxf(cmax, x);
      }
      cmax = warp_max(cmax);
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, cmax);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ok[e] ? expf(sv[e] - m_new) : 0.f;
        Ss[r * KT + lane + 32 * e] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Cs[r] = corr;
        Ms[r] = m_new;
        Ls[r] = Ls[r] * corr + psum;
      }
    }
    __syncthreads();

    // ---- acc[r][d] = acc[r][d] * corr[r] + sum_k P[r][k] V[k][d]
    const int nk = min(KT, last - kbase + 1);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + i * RG;
      if (r < rows) {
        const float corr = Cs[r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] *= corr;
      }
    }
    for (int k = 0; k < nk; ++k) {
      const float4 vv = *reinterpret_cast<const float4*>(&Vs[k * D + 4 * dg]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + i * RG;
        if (r < rows) {
          const float p = Ss[r * KT + k];
          acc[i][0] += p * vv.x;
          acc[i][1] += p * vv.y;
          acc[i][2] += p * vv.z;
          acc[i][3] += p * vv.w;
        }
      }
    }
    __syncthreads();
  }

  // ---- emit (B, T, Hq, D) in q's dtype
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + i * RG;
    if (r < rows) {
      const float inv = 1.f / fmaxf(Ls[r], 1e-30f);
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] = acc[i][c] * inv;
      const int t = r / g, gi = r % g;
      T* dst = out + ((static_cast<int64_t>(b) * T_q + t) * Hq + h * g + gi) * D + 4 * dg;
      Vec<T>::store4(dst, o);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* lengths,
           const void* table, void* out, int B, int T_q, int Hq, int Hkv, int ps,
           int MP, float scale, float cap, void* stream) {
  const int rows = (Hq / Hkv) * T_q;
  if (rows < 1 || rows > MAX_ROWS || Hq % Hkv != 0 || ps < 1 || MP < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_floats<D>(rows) * sizeof(float);
  static size_t opted_in = 48 * 1024;          // per instantiation
  if (bytes > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = bytes;
  }
  dim3 grid(Hkv, B);
  paged_decode_kernel<T, D><<<grid, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(lengths), static_cast<const int*>(table),
      static_cast<T*>(out), T_q, Hq, Hkv, ps, MP, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int head_dim, const void* q, const void* kp, const void* vp,
             const void* lengths, const void* table, void* out, int B, int T_q,
             int Hq, int Hkv, int ps, int MP, float scale, float cap, void* stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, kp, vp, lengths, table, out, B, T_q, Hq, Hkv, ps, MP, scale, cap, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, lengths, table, out, B, T_q, Hq, Hkv, ps, MP, scale, cap, stream);
    default:                                   // bf16 at 256 runs paged_sm90.cuh only
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  head_dim: 64, 128 or 256.  q, out: (B, T, Hq, D);
// k_pages, v_pages: (NP, ps, Hkv, D); lengths: (B,) int32; table: (B, MP)
// int32; scratch: paged_decode_attention_scratch_bytes() bytes (null when 0).
// All contiguous, on the device, 16-byte aligned.  *kernel is set to the body
// the call launches: 0 = paged_sm90_kernel (split-KV, TMA + wgmma), 1 = the
// CUDA-core body (bf16 on pages that do not tile a 64-key chunk; at 256
// refused), 2 = decode_f32_kernel (split-KV, CUDA cores, fp32, any page
// size).  Returns cudaGetLastError() after the launch, -1 for a missing
// scratch, -3/-4 when the CUDA driver cannot encode the tensor maps.
extern "C" int paged_decode_attention_launch(int dtype, int head_dim, const void* q,
                                             const void* k_pages, const void* v_pages,
                                             const void* lengths, const void* table,
                                             void* out, void* scratch, int B, int T_q,
                                             int Hq, int Hkv, int NP, int ps, int MP,
                                             float scale, float logit_cap, void* stream,
                                             int* kernel) {
  if (Hkv < 1 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (paged90::takes(dtype, head_dim, ps, Hq / Hkv, T_q)) {
    *kernel = 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (head_dim == 64)
      return paged90::launch<64>(q, k_pages, v_pages, lengths, table, out, scratch, B, T_q,
                                 Hq, Hkv, NP, ps, MP, scale, logit_cap, s);
    if (head_dim == 128)
      return paged90::launch<128>(q, k_pages, v_pages, lengths, table, out, scratch, B, T_q,
                                  Hq, Hkv, NP, ps, MP, scale, logit_cap, s);
    return paged90::launch<256>(q, k_pages, v_pages, lengths, table, out, scratch, B, T_q,
                                Hq, Hkv, NP, ps, MP, scale, logit_cap, s);
  }
  if (decode32::takes(dtype, head_dim, Hq / Hkv, T_q)) {
    *kernel = 2;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    int cps = 0, splits = 0;
    paged90::plan(B, Hkv, ps, MP, &cps, &splits);
    if (head_dim == 64)
      return decode32::launch_paged<64>(q, k_pages, v_pages, lengths, table, out, scratch, B,
                                        T_q, Hq, Hkv, ps, MP, cps, splits, scale, logit_cap, s);
    if (head_dim == 128)
      return decode32::launch_paged<128>(q, k_pages, v_pages, lengths, table, out, scratch, B,
                                         T_q, Hq, Hkv, ps, MP, cps, splits, scale, logit_cap, s);
    return decode32::launch_paged<256>(q, k_pages, v_pages, lengths, table, out, scratch, B,
                                       T_q, Hq, Hkv, ps, MP, cps, splits, scale, logit_cap, s);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  *kernel = 1;
  return launch_d<bf16>(head_dim, q, k_pages, v_pages, lengths, table, out, B, T_q, Hq, Hkv,
                        ps, MP, scale, logit_cap, stream);
}

// Bytes of scratch the call with these arguments needs (the split-KV
// partials of the sm90 and f32 bodies, which share the paged plan; 0 when
// they run one split or for the old CUDA-core body).
extern "C" long long paged_decode_attention_scratch_bytes(int dtype, int head_dim, int B,
                                                          int T_q, int Hq, int Hkv, int ps,
                                                          int MP) {
  if (Hkv < 1 || Hq % Hkv != 0) return 0;
  const int g = Hq / Hkv;
  if (paged90::takes(dtype, head_dim, ps, g, T_q) || decode32::takes(dtype, head_dim, g, T_q))
    return paged90::scratch_bytes(head_dim, B, T_q, Hq, Hkv, ps, MP);
  return 0;
}

// Dynamic shared memory of a block of the f32 body at this head dim (for
// reports), or -2 for a head dim it is not built for.
extern "C" int paged_f32_smem_bytes(int head_dim) { return decode32::smem_bytes(head_dim); }

// Dynamic shared memory of a block of the sm90 body at this head dim (for
// reports), or -2 for a head dim it is not built for.
extern "C" int paged_sm90_smem_bytes(int head_dim) {
  if (head_dim == 64) return paged90::Cfg<64>::BYTES;
  if (head_dim == 128) return paged90::Cfg<128>::BYTES;
  if (head_dim == 256) return paged90::Cfg<256>::BYTES;
  return -2;
}
