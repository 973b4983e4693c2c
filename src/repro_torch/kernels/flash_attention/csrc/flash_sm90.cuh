// Flash attention for prefill in bf16 on Hopper (sm_90a): the body of the
// bf16 path of flash_attention.cu.  TMA fills a ring of K/V chunks in shared
// memory, one or two consumer warpgroups run both products with wgmma and
// keep the online softmax in registers, one producer warp keeps the loads
// in flight.
//
//   out[b, t, h] = softmax_s( cap(q[b, t, h] . k[b, s, h/g] * scale)
//                             | s <= t, s > t - window ) . v[b, s, h/g]
//
// Work item: BM = 64 * NC query positions of one query head of one
// sequence, NC consumer warpgroups of 64 rows each.  Two shapes, chosen on
// the host per call (consumers()):
//   * wide, NC = 2 (BM 128, BK = 128 keys a chunk, one block per SM): long
//     prefills, where a block's many chunks keep the tensor cores busy.
//   * narrow, NC = 1 (BM 64, BK 64, two blocks per SM): short prefills
//     (8 prompts of 256 tokens), where items have one to four chunks and
//     the time goes to each item's start and end, not to its products.
//     Two blocks share an SM, so one's softmax, epilogue and waits run
//     under the other's wgmma, and 64-row items even out the SMs' loads.
// Either way:
//   * Persistent grid: as many blocks as fit the SMs walk the
//     heaviest-first item list with a static stride, in snake order (round
//     r takes item r * G + j for block j when r is even, r * G + G - 1 - j
//     when it is odd), so the rounds' heavy and light causal tiles even out
//     without an atomic counter, and nothing needs resetting between
//     launches.  The block start (barrier init, setmaxnreg, the first Q and
//     K/V round trip) is paid once per block, not once per item.
//   * The last warpgroup is the producer: one thread issues every TMA load,
//     and the warpgroup gives its registers to the consumers (setmaxnreg).
//   * Q is double-buffered: the producer loads item n + 1's Q (and its
//     first K/V chunks, the ring running on across items) while the
//     consumers finish item n; a Q buffer is released (q_empty) after the
//     epilogue that staged its output in it.  K and V chunks go into a ring
//     of STAGES with a full barrier each for K and V, so the score product
//     starts before V has landed, and one empty barrier the consumers
//     release after their PV product.
//   * Tensor maps are 4-D over (D, heads, positions, batch) with the element
//     strides the wrapper hands over, so the model's (B, T, H, D) tensors and
//     the (B, H, T, D) views of flash_attention_bhtd are read in place.  Rows
//     past T or S are TMA zero fill.  128-byte swizzle (64-byte at D 32): a
//     row of D is one (D <= 64) or two 64-element boxes.
//   * S = Q K^T: wgmma m64nBKk16, A = Q and B = K (K-major) from shared
//     memory.  O += P V: wgmma m64nDk16 with A = P from registers (the score
//     accumulator rounded to bf16 is already in wgmma's register-A order)
//     and B = V from shared memory through the transpose bit, so V is never
//     transposed in memory.
//   * The softmax stays in registers: a row's max and sum are reduced over
//     the four threads of a quad with shuffles, exp2 with scale * log2(e)
//     folded in, the tanh cap before the mask, O rescaled in registers.
//   * Masks are built only in chunks that cross the diagonal, the window
//     edge or S.  Causal items stop at their last query and windowed items
//     start at their first visible key, as the TPU kernel skips fully masked
//     blocks; non-causal items run every key.
//   * Items are numbered so that the causal tiles with the most keys come
//     first (the last query tile of every head before the one before it).
//   * The epilogue stages O / l in bf16 in the warpgroup's own rows of the
//     item's Q buffer and writes 16-byte vectors through the output strides,
//     rows past T masked.  (Stores straight from the accumulator's
//     fragments, 4 bytes a thread, were slower: PERF.md.)
//
// Internal linkage throughout (see sm90.cuh).

#pragma once

#include "../../csrc/sm90.cuh"

namespace flash90 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int NARROW_MAX_T = 512;            // prefills up to this many queries run narrow
constexpr float LOG2E = 1.4426950408889634f;

template <int D, int NC>
struct Cfg {
  static constexpr int BM = 64 * NC;              // query positions of an item
  static constexpr int BK = NC == 2 ? 128 : 64;   // keys of a chunk
  static constexpr int NT = 128 * (NC + 1);       // consumers + producer warpgroup
  static constexpr int MIN_BLOCKS = NC == 2 ? 1 : 2;   // blocks an SM holds
  static constexpr int CONSUMER_REGS = NC == 2 ? 240 : 232;
  static constexpr int SW = D >= 64 ? 128 : 64;   // swizzle = bytes of a box row
  static constexpr int DC = SW / 2;               // elements of a box row
  static constexpr int STAGES = D == 128 ? 2 : (NC == 2 ? 3 : 4);
  static constexpr int Q_BYTES = BM * D * 2;      // one of two Q buffers
  static constexpr int KV_BYTES = BK * D * 2;     // one chunk of K (or V)
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + (4 + 3 * STAGES) * 8 + 1024;   // + alignment
  static_assert(D % DC == 0, "a row of D is whole boxes");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Consumer warpgroups per block for a prefill of T queries.
inline int consumers(int T) { return T <= NARROW_MAX_T ? 1 : 2; }

struct Params {
  bf16* out;
  long long sob, sot, soh;                   // output strides in elements
  int B, T, S, Hq, Hkv, n_qt, n_items;
  int causal, window;
  float scale, cap;
};

// Item idx of the heaviest-first list: query tile qt of BM positions (the
// last tiles first) of head h of sequence b, and the chunks of BK keys it
// reads from kstart.
struct Item {
  int qt, h, b, kstart, n_chunks;
};

template <int BM, int BK>
__device__ __forceinline__ Item item_at(const Params& p, int idx) {
  const int bh = p.B * p.Hq;
  Item it;
  it.qt = p.n_qt - 1 - idx / bh;
  it.h = idx % bh % p.Hq;
  it.b = idx % bh / p.Hq;
  const int t0 = it.qt * BM;
  const int q_last = min(t0 + BM, p.T) - 1;
  int kend = p.S;
  it.kstart = 0;
  if (p.causal) {
    kend = min(p.S, q_last + 1);
    if (p.window > 0) it.kstart = max(0, t0 - p.window + 1);
  }
  it.n_chunks = (kend - it.kstart + BK - 1) / BK;
  return it;
}

// The list index of this block's n-th item: a static stride in snake order.
__device__ __forceinline__ int item_index(int n) {
  const int G = static_cast<int>(gridDim.x), j = static_cast<int>(blockIdx.x);
  return n * G + ((n & 1) ? G - 1 - j : j);
}

template <int BK>
__device__ __forceinline__ void qk_product(float (&sc)[BK / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (BK == 128) sm90::wgmma_ss_n128<0>(sc, da, db, scale_d);
  else sm90::wgmma_ss_n64<0>(sc, da, db, scale_d);
}

template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (D == 128) sm90::wgmma_rs_n128<1>(o, a, db, 1);
  else if constexpr (D == 64) sm90::wgmma_rs_n64<1>(o, a, db, 1);
  else sm90::wgmma_rs_n32<1>(o, a, db, 1);
}

template <int D, int NC>
__global__ void __launch_bounds__(Cfg<D, NC>::NT, Cfg<D, NC>::MIN_BLOCKS)
flash_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const Params p) {
  using L = Cfg<D, NC>;
  constexpr int SW = L::SW, BM = L::BM, BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);   // [2]
  uint64_t* q_empty = q_full + 2;                                      // [2]
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + L::STAGES;
  uint64_t* empty = v_full + L::STAGES;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      sm90::mbar_init(&q_full[qb], 1);
      sm90::mbar_init(&q_empty[qb], NC);
    }
    for (int s = 0; s < L::STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], NC);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {
    // ---- producer: Q of each item into buffer n % 2, K/V into the ring
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 128 * NC) {
      sm90::prefetch_map(&qmap);
      sm90::prefetch_map(&kmap);
      sm90::prefetch_map(&vmap);
      int i = 0;                                 // chunks issued, across items
      for (int n = 0;; ++n) {
        const int idx = item_index(n);
        if (idx >= p.n_items) break;
        const Item it = item_at<BM, BK>(p, idx);
        const int qb = n & 1;
        const int kvh = it.h / (p.Hq / p.Hkv);
        sm90::mbar_wait(&q_empty[qb], ((n >> 1) & 1) ^ 1);
        unsigned char* qs = smem + qb * L::Q_BYTES;
        sm90::mbar_expect_tx(&q_full[qb], L::Q_BYTES);
        for (int c = 0; c < D / L::DC; ++c)
          sm90::tma_load_4d(qs + c * BM * SW, &qmap, &q_full[qb], c * L::DC, it.h, it.qt * BM,
                            it.b);
        for (int j = 0; j < it.n_chunks; ++j, ++i) {
          const int s = i % L::STAGES;
          const int kb = it.kstart + j * BK;
          sm90::mbar_wait(&empty[s], ((i / L::STAGES) & 1) ^ 1);
          unsigned char* ks = smem + L::K_OFF + s * L::KV_BYTES;
          unsigned char* vs = smem + L::V_OFF + s * L::KV_BYTES;
          sm90::mbar_expect_tx(&k_full[s], L::KV_BYTES);
          for (int c = 0; c < D / L::DC; ++c)
            sm90::tma_load_4d(ks + c * BK * SW, &kmap, &k_full[s], c * L::DC, kvh, kb, it.b);
          sm90::mbar_expect_tx(&v_full[s], L::KV_BYTES);
          for (int c = 0; c < D / L::DC; ++c)
            sm90::tma_load_4d(vs + c * BK * SW, &vmap, &v_full[s], c * L::DC, kvh, kb, it.b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query positions [qa, qa + 64) of
    // each item
    sm90::reg_alloc<L::CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int kc = 2 * (lane % 4);               // key columns kc, kc + 1 of 8
    const bool capped = p.cap > 0.f;
    const float mul = capped ? LOG2E : p.scale * LOG2E;
    const float pre = capped ? p.scale / p.cap : 0.f;
    int i = 0;                                   // chunks consumed, across items
    for (int n = 0;; ++n) {
      const int idx = item_index(n);
      if (idx >= p.n_items) break;
      const Item it = item_at<BM, BK>(p, idx);
      const int qb = n & 1;
      const int qa = it.qt * BM + 64 * wg;
      const int qr = qa + warp * 16 + lane / 4;  // this thread's rows: qr, qr + 8
      float o[D / 2];
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      unsigned char* qs = smem + qb * L::Q_BYTES + wg * 64 * SW;
      const uint32_t qbase = sm90::smem_u32(qs);

      sm90::mbar_wait(&q_full[qb], (n >> 1) & 1);
      for (int j = 0; j < it.n_chunks; ++j, ++i) {
        const int s = i % L::STAGES;
        const uint32_t ph = (i / L::STAGES) & 1;
        const int kb = it.kstart + j * BK;
        const uint32_t kbase = sm90::smem_u32(smem + L::K_OFF + s * L::KV_BYTES);
        const uint32_t vbase = sm90::smem_u32(smem + L::V_OFF + s * L::KV_BYTES);

        // ---- S = Q K^T (64 x BK per warpgroup, fp32 in registers)
        float sc[BK / 2];
        sm90::mbar_wait(&k_full[s], ph);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk * 16 / L::DC, off = (kk * 16 % L::DC) * 2;
          const uint64_t da = sm90::make_desc(qbase + c * BM * SW + off, 16, 8 * SW, SW);
          const uint64_t db = sm90::make_desc(kbase + c * BK * SW + off, 16, 8 * SW, SW);
          qk_product<BK>(sc, da, db, kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);

        // ---- scores in log2 units: cap, then mask where the chunk needs one
        if (capped) {
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) sc[e] = p.cap * tanhf(sc[e] * pre);
        }
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] *= mul;
        const bool edge = kb + BK > p.S ||
                          (p.causal && (kb + BK - 1 > qa ||
                                        (p.window > 0 && kb <= qa + 63 - p.window)));
        if (edge) {
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) {
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
        for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
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
        for (int e = 0; e < BK / 2; ++e) {
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
          for (int q = 0; q < 4; ++q) pa[kk][q] = sm90::pack_bf16(sc[8 * kk + 2 * q],
                                                                  sc[8 * kk + 2 * q + 1]);
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

      // ---- epilogue: O / l in bf16, staged in this warpgroup's rows of the
      // item's Q buffer, then the buffer goes back to the producer
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
      }
      constexpr int NG = SW / 16;                // 16-byte groups of a box row
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
      constexpr int VPR = D / 8;                 // 16-byte vectors of a row
      bf16* ob = p.out + it.b * p.sob + it.h * p.soh;
      for (int vi = tid; vi < 64 * VPR; vi += 128) {
        const int r = vi / VPR, col = (vi % VPR) * 8;
        const int c = col / L::DC, g = (col % L::DC) / 8;
        const int t = qa + r;
        if (t < p.T)
          *reinterpret_cast<uint4*>(ob + t * p.sot + col) = *reinterpret_cast<const uint4*>(
              qs + c * BM * SW + r * SW + ((g ^ (r % NG)) * 16));
      }
      // every read of the staged rows done, ordered before the next TMA write
      sm90::fence_proxy_async();
      sm90::named_barrier(1 + wg, 128);
      if (tid == 0) sm90::mbar_arrive(&q_empty[qb]);
    }
  }
}

template <int D, int NC>
int launch(const void* q, const void* k, const void* v, void* out, const long long* st, int B,
           int T, int S, int Hq, int Hkv, int causal, int window, float scale, float cap,
           cudaStream_t stream) {
  using L = Cfg<D, NC>;
  static bool opted_in = false;              // per instantiation, per library
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_sm90_kernel<D, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  // dims (D, heads, positions, batch); strides of heads, positions, batch
  CUtensorMap qm, km, vm;
  const long long qd[4] = {D, Hq, T, B}, kd[4] = {D, Hkv, S, B};
  const long long qs[3] = {st[2], st[1], st[0]}, ks[3] = {st[5], st[4], st[3]},
                  vs[3] = {st[8], st[7], st[6]};
  const int qb[4] = {L::DC, 1, L::BM, 1}, kb[4] = {L::DC, 1, L::BK, 1};
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
  p.n_qt = (T + L::BM - 1) / L::BM;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.cap = cap;
  const long long items = static_cast<long long>(p.n_qt) * Hq * B;
  if (items > 0x7fffffffLL) return -1;
  p.n_items = static_cast<int>(items);
  const int slots = L::MIN_BLOCKS * sm90::sm_count();
  const int grid = p.n_items < slots ? p.n_items : slots;
  flash_sm90_kernel<D, NC><<<grid, L::NT, L::BYTES, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, const long long* st, int B,
             int T, int S, int Hq, int Hkv, int causal, int window, float scale, float cap,
             cudaStream_t stream) {
  if (consumers(T) == 1)
    return launch<D, 1>(q, k, v, out, st, B, T, S, Hq, Hkv, causal, window, scale, cap, stream);
  return launch<D, 2>(q, k, v, out, st, B, T, S, Hq, Hkv, causal, window, scale, cap, stream);
}

// head_dim 32, 64 or 128; -2 for another.
inline int launch_any(int head_dim, const void* q, const void* k, const void* v, void* out,
                      const long long* st, int B, int T, int S, int Hq, int Hkv, int causal,
                      int window, float scale, float cap, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch_d<32>(q, k, v, out, st, B, T, S, Hq, Hkv, causal, window, scale,
                                 cap, stream);
    case 64: return launch_d<64>(q, k, v, out, st, B, T, S, Hq, Hkv, causal, window, scale,
                                 cap, stream);
    case 128: return launch_d<128>(q, k, v, out, st, B, T, S, Hq, Hkv, causal, window, scale,
                                   cap, stream);
  }
  return -2;
}

// Dynamic shared memory of a block at this head dim and consumer count, or
// -2 for a shape the kernel is not built for.
inline int smem_bytes(int head_dim, int nc) {
  if (nc != 1 && nc != 2) return -2;
  switch (head_dim) {
    case 32: return nc == 1 ? Cfg<32, 1>::BYTES : Cfg<32, 2>::BYTES;
    case 64: return nc == 1 ? Cfg<64, 1>::BYTES : Cfg<64, 2>::BYTES;
    case 128: return nc == 1 ? Cfg<128, 1>::BYTES : Cfg<128, 2>::BYTES;
  }
  return -2;
}

}  // namespace
}  // namespace flash90
