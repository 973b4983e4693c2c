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
// Two bodies, both split-KV over a (splits, Hkv, B) grid with the same plan
// and combine kernel; the launcher picks one per call and reports which:
//   * bf16 at head dims 32, 64, 128 and 256, on pages of any size (every
//     call of the served models): paged_sm90.cuh.  A producer warp keeps
//     TMA page loads in flight in a ring of 64-key chunks (boxes of
//     gcd(ps, 64) rows; on pages not a multiple of 8 its warpgroup stages
//     the chunks with cp.async), both products as wgmma with the softmax in
//     registers.  At D 256 the O accumulator is 128 registers a thread and
//     a K+V chunk 64 KB, so the ring holds 3 chunks.
//   * fp32 (the parity checks) at the same head dims and any page size:
//     kernels/csrc/decode_f32.cuh, the same split plan and combine on the
//     CUDA cores in full fp32 (K/V chunks by cp.async, each key's page
//     looked up in the table; q and O in registers).
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "../../csrc/decode_f32.cuh"
#include "paged_sm90.cuh"

// dtype: 0 = bf16, 1 = fp32.  head_dim: 32, 64, 128 or 256.  q, out: (B, T,
// Hq, D); k_pages, v_pages: (NP, ps, Hkv, D); lengths: (B,) int32; table:
// (B, MP) int32; scratch: paged_decode_attention_scratch_bytes() bytes (null
// when 0).  All contiguous, on the device, 16-byte aligned.  *kernel is set
// to the body the call launches: 0 = paged_sm90_kernel (split-KV, TMA +
// wgmma, bf16), 1 = decode_f32_kernel (split-KV, CUDA cores, fp32).  Returns
// cudaGetLastError() after the launch, -1 for a missing scratch, -2 for a
// dtype, head dim or shape neither body takes, -3/-4 when the CUDA driver
// cannot encode the tensor maps.
extern "C" int paged_decode_attention_launch(int dtype, int head_dim, const void* q,
                                             const void* k_pages, const void* v_pages,
                                             const void* lengths, const void* table,
                                             void* out, void* scratch, int B, int T_q,
                                             int Hq, int Hkv, int NP, int ps, int MP,
                                             float scale, float logit_cap, void* stream,
                                             int* kernel) {
  if (Hkv < 1 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (paged90::takes(dtype, head_dim, ps, Hq / Hkv, T_q)) {
    *kernel = 0;
    switch (head_dim) {
      case 32:
        return paged90::launch<32>(q, k_pages, v_pages, lengths, table, out, scratch, B, T_q,
                                   Hq, Hkv, NP, ps, MP, scale, logit_cap, s);
      case 64:
        return paged90::launch<64>(q, k_pages, v_pages, lengths, table, out, scratch, B, T_q,
                                   Hq, Hkv, NP, ps, MP, scale, logit_cap, s);
      case 128:
        return paged90::launch<128>(q, k_pages, v_pages, lengths, table, out, scratch, B, T_q,
                                    Hq, Hkv, NP, ps, MP, scale, logit_cap, s);
      default:
        return paged90::launch<256>(q, k_pages, v_pages, lengths, table, out, scratch, B, T_q,
                                    Hq, Hkv, NP, ps, MP, scale, logit_cap, s);
    }
  }
  if (!decode32::takes(dtype, head_dim, Hq / Hkv, T_q)) return -2;
  *kernel = 1;
  int cps = 0, splits = 0;
  paged90::plan(B, Hkv, ps, MP, &cps, &splits);
  switch (head_dim) {
    case 32:
      return decode32::launch_paged<32>(q, k_pages, v_pages, lengths, table, out, scratch, B,
                                        T_q, Hq, Hkv, ps, MP, cps, splits, scale, logit_cap, s);
    case 64:
      return decode32::launch_paged<64>(q, k_pages, v_pages, lengths, table, out, scratch, B,
                                        T_q, Hq, Hkv, ps, MP, cps, splits, scale, logit_cap, s);
    case 128:
      return decode32::launch_paged<128>(q, k_pages, v_pages, lengths, table, out, scratch, B,
                                         T_q, Hq, Hkv, ps, MP, cps, splits, scale, logit_cap, s);
    default:
      return decode32::launch_paged<256>(q, k_pages, v_pages, lengths, table, out, scratch, B,
                                         T_q, Hq, Hkv, ps, MP, cps, splits, scale, logit_cap, s);
  }
}

// Bytes of scratch the call with these arguments needs (the split-KV
// partials of the sm90 and f32 bodies, which share the paged plan; 0 when
// they run one split).
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
  if (head_dim == 32) return paged90::Cfg<32>::BYTES;
  if (head_dim == 64) return paged90::Cfg<64>::BYTES;
  if (head_dim == 128) return paged90::Cfg<128>::BYTES;
  if (head_dim == 256) return paged90::Cfg<256>::BYTES;
  return -2;
}
