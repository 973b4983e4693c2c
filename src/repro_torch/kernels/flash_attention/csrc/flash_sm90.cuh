// Flash attention for prefill in bf16 on Hopper (sm_90a): the body of the
// bf16 path of flash_attention.cu.  TMA fills a ring of K/V chunks in shared
// memory, two consumer warpgroups run both products with wgmma and keep the
// online softmax in registers, one producer warp keeps the loads in flight.
//
//   out[b, t, h] = softmax_s( cap(q[b, t, h] . k[b, s, h/g] * scale)
//                             | s <= t, s > t - window ) . v[b, s, h/g]
//
// Block: 128 query positions of one query head of one sequence.
//   * Warpgroups 0 and 1 own rows [0, 64) and [64, 128); warpgroup 2 is the
//     producer: one thread issues every TMA load, and the warpgroup gives its
//     registers to the consumers (setmaxnreg 24 / 240).
//   * Q is loaded once; K and V chunks of BK = 128 keys go into a ring of
//     STAGES (2 at D 128, 3 below) with a full barrier each for K and V, so
//     the score product starts before V has landed, and one empty barrier
//     the two consumers release after their PV product.
//   * Tensor maps are 4-D over (D, heads, positions, batch) with the element
//     strides the wrapper hands over, so the model's (B, T, H, D) tensors and
//     the (B, H, T, D) views of flash_attention_bhtd are read in place.  Rows
//     past T or S are TMA zero fill.  128-byte swizzle (64-byte at D 32): a
//     row of D is one (D <= 64) or two 64-element boxes.
//   * S = Q K^T: wgmma m64n128k16, A = Q and B = K (K-major) from shared
//     memory.  O += P V: wgmma m64nDk16 with A = P from registers (the score
//     accumulator rounded to bf16 is already in wgmma's register-A order)
//     and B = V from shared memory through the transpose bit, so V is never
//     transposed in memory.
//   * The softmax stays in registers: a row's max and sum are reduced over
//     the four threads of a quad with shuffles, exp2 with scale * log2(e)
//     folded in, the tanh cap before the mask, O rescaled in registers.
//   * Masks are built only in chunks that cross the diagonal, the window
//     edge or S.  Causal blocks stop at their last query and windowed blocks
//     start at their first visible key, as the TPU kernel skips fully masked
//     blocks; non-causal blocks run every key.
//   * Blocks are numbered so that the causal tiles with the most keys start
//     first (the last query tile of every head before the one before it).
//   * The epilogue stages O / l in bf16 in the warpgroup's own rows of the Q
//     buffer and writes 16-byte vectors through the output strides, rows
//     past T masked.
//
// Internal linkage throughout (see sm90.cuh).

#pragma once

#include "../../csrc/sm90.cuh"

namespace flash90 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;                      // query positions per block
constexpr int BK = 128;                      // keys per chunk
constexpr int NT = 384;                      // two consumer warpgroups + producer
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int SW = D >= 64 ? 128 : 64;   // swizzle = bytes of a box row
  static constexpr int DC = SW / 2;               // elements of a box row
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // one chunk of K (or V)
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + (1 + 3 * STAGES) * 8 + 1024;   // + alignment
  static_assert(D % DC == 0, "a row of D is whole boxes");
};

struct Params {
  bf16* out;
  long long sob, sot, soh;                   // output strides in elements
  int B, T, S, Hq, Hkv, n_qt;
  int causal, window;
  float scale, cap;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (D == 128) sm90::wgmma_rs_n128<1>(o, a, db, 1);
  else if constexpr (D == 64) sm90::wgmma_rs_n64<1>(o, a, db, 1);
  else sm90::wgmma_rs_n32<1>(o, a, db, 1);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const Params p) {
  using L = Cfg<D>;
  constexpr int SW = L::SW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + L::STAGES;
  uint64_t* empty = v_full + L::STAGES;

  // the last query tiles (most keys under a causal mask) first
  const int bh = p.B * p.Hq;
  const int qt = p.n_qt - 1 - static_cast<int>(blockIdx.x) / bh;
  const int h = static_cast<int>(blockIdx.x) % bh % p.Hq;
  const int b = static_cast<int>(blockIdx.x) % bh / p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);
  const int t0 = qt * BM;
  const int q_last = min(t0 + BM, p.T) - 1;
  int kstart = 0, kend = p.S;
  if (p.causal) {
    kend = min(p.S, q_last + 1);
    if (p.window > 0) kstart = max(0, t0 - p.window + 1);
  }
  const int n_chunks = (kend - kstart + BK - 1) / BK;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 256) {
      sm90::prefetch_map(&qmap);
      sm90::prefetch_map(&kmap);
      sm90::prefetch_map(&vmap);
      sm90::mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < D / L::DC; ++c)
        sm90::tma_load_4d(smem + c * BM * SW, &qmap, q_full, c * L::DC, h, t0, b);
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % L::STAGES;
        const int kb = kstart + i * BK;
        sm90::mbar_wait(&empty[s], ((i / L::STAGES) & 1) ^ 1);
        unsigned char* ks = smem + L::K_OFF + s * L::KV_BYTES;
        unsigned char* vs = smem + L::V_OFF + s * L::KV_BYTES;
        sm90::mbar_expect_tx(&k_full[s], L::KV_BYTES);
        for (int c = 0; c < D / L::DC; ++c)
          sm90::tma_load_4d(ks + c * BK * SW, &kmap, &k_full[s], c * L::DC, kvh, kb, b);
        sm90::mbar_expect_tx(&v_full[s], L::KV_BYTES);
        for (int c = 0; c < D / L::DC; ++c)
          sm90::tma_load_4d(vs + c * BK * SW, &vmap, &v_full[s], c * L::DC, kvh, kb, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query positions [qa, qa + 64)
    sm90::reg_alloc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int qa = t0 + 64 * wg;
    const int qr = qa + warp * 16 + lane / 4;    // this thread's rows: qr, qr + 8
    const int kc = 2 * (lane % 4);               // and key columns kc, kc + 1 of 8
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const bool capped = p.cap > 0.f;
    const float mul = capped ? LOG2E : p.scale * LOG2E;
    const float pre = capped ? p.scale / p.cap : 0.f;
    const uint32_t qbase = sm90::smem_u32(smem) + wg * 64 * SW;

    sm90::mbar_wait(q_full, 0);
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % L::STAGES;
      const uint32_t ph = (i / L::STAGES) & 1;
      const int kb = kstart + i * BK;
      const uint32_t kbase = sm90::smem_u32(smem + L::K_OFF + s * L::KV_BYTES);
      const uint32_t vbase = sm90::smem_u32(smem + L::V_OFF + s * L::KV_BYTES);

      // ---- S = Q K^T (64 x 128 per warpgroup, fp32 in registers)
      float sc[64];
      sm90::mbar_wait(&k_full[s], ph);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / L::DC, off = (kk * 16 % L::DC) * 2;
        const uint64_t da = sm90::make_desc(qbase + c * BM * SW + off, 16, 8 * SW, SW);
        const uint64_t db = sm90::make_desc(kbase + c * BK * SW + off, 16, 8 * SW, SW);
        sm90::wgmma_ss_n128<0>(sc, da, db, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // ---- scores in log2 units: cap, then mask where the chunk needs one
      if (capped) {
#pragma unroll
        for (int e = 0; e < 64; ++e) sc[e] = p.cap * tanhf(sc[e] * pre);
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) sc[e] *= mul;
      const bool edge = kb + BK > p.S ||
                        (p.causal && (kb + BK - 1 > qa ||
                                      (p.window > 0 && kb <= qa + 63 - p.window)));
      if (edge) {
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const int key = kb + 8 * (e / 4) + kc + (e & 1);
          const int q = qr + 8 * ((e >> 1) & 1);
          const bool vis = key < p.S && (!p.causal || (key <= q && (p.window <= 0 ||
                                                                    key > q - p.window)));
          if (!vis) sc[e] = -INFINITY;
        }
      }

      // ---- online softmax over the quad that holds each row
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < 64; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      float base[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];   // a row with nothing visible yet
        corr[r] = ex2(m[r] - base[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        sc[e] = ex2(sc[e] - base[(e >> 1) & 1]);
        rs[(e >> 1) & 1] += sc[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[kk][j] = sm90::pack_bf16(sc[8 * kk + 2 * j],
                                                                sc[8 * kk + 2 * j + 1]);
      }

      // ---- O += P V
      sm90::mbar_wait(&v_full[s], ph);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = sm90::make_desc(vbase + kk * 16 * SW, BK * SW, 8 * SW, SW);
        pv_product<D>(o, pa[kk], db);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      if (tid == 0) sm90::mbar_arrive(&empty[s]);
    }

    // ---- epilogue: O / l in bf16, staged in this warpgroup's rows of Q
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    constexpr int NG = SW / 16;                  // 16-byte groups of a box row
    unsigned char* qs = smem + wg * 64 * SW;
    const int rr = warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + kc, c = col / L::DC, cc = col % L::DC;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rr + 8 * hh;
        unsigned char* at = qs + c * BM * SW + r * SW + (((cc / 8) ^ (r % NG)) * 16) +
                            (cc % 8) * 2;
        *reinterpret_cast<uint32_t*>(at) =
            sm90::pack_bf16(o[4 * j + 2 * hh] * inv[hh], o[4 * j + 2 * hh + 1] * inv[hh]);
      }
    }
    sm90::named_barrier(1 + wg, 128);
    constexpr int VPR = D / 8;                   // 16-byte vectors of a row
    bf16* ob = p.out + b * p.sob + h * p.soh;
    for (int vi = tid; vi < 64 * VPR; vi += 128) {
      const int r = vi / VPR, col = (vi % VPR) * 8;
      const int c = col / L::DC, g = (col % L::DC) / 8;
      const int t = qa + r;
      if (t < p.T)
        *reinterpret_cast<uint4*>(ob + t * p.sot + col) = *reinterpret_cast<const uint4*>(
            qs + c * BM * SW + r * SW + ((g ^ (r % NG)) * 16));
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, const long long* st, int B,
           int T, int S, int Hq, int Hkv, int causal, int window, float scale, float cap,
           cudaStream_t stream) {
  using L = Cfg<D>;
  static bool opted_in = false;              // per instantiation, per library
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  // dims (D, heads, positions, batch); strides of heads, positions, batch
  CUtensorMap qm, km, vm;
  const long long qd[4] = {D, Hq, T, B}, kd[4] = {D, Hkv, S, B};
  const long long qs[3] = {st[2], st[1], st[0]}, ks[3] = {st[5], st[4], st[3]},
                  vs[3] = {st[8], st[7], st[6]};
  const int qb[4] = {L::DC, 1, BM, 1}, kb[4] = {L::DC, 1, BK, 1};
  int rc = sm90::make_map_bf16<4>(&qm, q, qd, qs, qb, L::SW);
  if (rc == 0) rc = sm90::make_map_bf16<4>(&km, k, kd, ks, kb, L::SW);
  if (rc == 0) rc = sm90::make_map_bf16<4>(&vm, v, kd, vs, kb, L::SW);
  if (rc != 0) return rc;
  Params p{};
  p.out = static_cast<bf16*>(out);
  p.sob = st[9];
  p.sot = st[10];
  p.soh = st[11];
  p.B = B;
  p.T = T;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.n_qt = (T + BM - 1) / BM;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.cap = cap;
  const long long blocks = static_cast<long long>(p.n_qt) * Hq * B;
  if (blocks > 0x7fffffffLL) return -1;
  flash_sm90_kernel<D><<<static_cast<unsigned>(blocks), NT, L::BYTES, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

// head_dim 32, 64 or 128; -2 for another.
inline int launch_any(int head_dim, const void* q, const void* k, const void* v, void* out,
                      const long long* st, int B, int T, int S, int Hq, int Hkv, int causal,
                      int window, float scale, float cap, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<32>(q, k, v, out, st, B, T, S, Hq, Hkv, causal, window, scale, cap,
                               stream);
    case 64: return launch<64>(q, k, v, out, st, B, T, S, Hq, Hkv, causal, window, scale, cap,
                               stream);
    case 128: return launch<128>(q, k, v, out, st, B, T, S, Hq, Hkv, causal, window, scale, cap,
                                 stream);
  }
  return -2;
}

}  // namespace
}  // namespace flash90
