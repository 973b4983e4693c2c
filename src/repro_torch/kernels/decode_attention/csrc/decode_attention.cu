// Dense decode / SD-verify attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _decode_kernel of
// src/repro/kernels/decode_attention/decode_attention.py (called through
// decode_attention_bhtd): T fresh queries per sequence sit at positions
// lengths[b] + t and attend, causally, to a contiguous KV cache:
//
//   out[b, t, h*g + i] = softmax_s( cap(q . k[b, s, h] * scale)
//                                   | s <= lengths[b] + t, s < S ) . v[b, :, h]
//
// with g = Hq / Hkv query heads per KV head.  Keys past lengths[b] + T - 1 are
// never read; a row that ran past the cache (lengths[b] + t >= S) sees all S
// keys and never the cache's trash slot S.
//
// What bounds it on an H100: reading the cache.  At SD verify of the serve
// shape (8 sequences, ~130-290 cached positions, 4 KV heads of 128, bf16) a
// call must read ~2 MB, under a microsecond at 3.35 TB/s, so launch latency
// and one block's serial chunk loop set its time; at 8k positions it reads
// ~134 MB, ~40 us, and the kernel is memory bound.
//
// What the design does about it (the body is attention_tile.cuh):
//   * One block per (KV head, sequence), as the TPU grid's (B, Hkv) axes; the
//     KV axis, sequential on the TPU, is a loop inside the block.
//   * GQA folds into rows, as on the TPU: the g*T query rows of one KV head
//     (g = 7 and T = 5 give 35 rows at SD verify, 7 at AR) share every staged
//     K/V chunk, so each cached key is read from device memory once.
//   * lengths stay on the device: each block reads its own, the grid is
//     static, nothing waits on the host.
//   * The cache is read in place through strides, the model's (B, S+1, Hkv, D)
//     layout included: no per-layer transpose or copy.
//   * bf16 products on the tensor cores (16-row WMMA tiles: 35 rows cost 48);
//     fp32 on the CUDA cores in full fp32.  The next chunk's loads are in
//     flight while the current one is computed.
//   * Simple and right first: at 8k positions the grid is B*Hkv = 32 blocks on
//     132 SMs; split-KV across blocks with a combine pass is later work.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "../../csrc/attention_tile.cuh"

// dtype: 0 = bf16, 1 = fp32.  head_dim: 32, 64 or 128.  lengths: (B,) int32
// on the device.  strides: 12 element strides, q (b, t, h), k (b, s, h),
// v (b, s, h), out (b, t, h); the head dim is contiguous and every row
// 16-byte aligned.  S is the number of cache positions that may be read.
extern "C" int decode_attention_launch(int dtype, int head_dim, const void* q,
                                       const void* k, const void* v,
                                       const void* lengths, void* out,
                                       const long long* strides, int B, int T, int S,
                                       int Hq, int Hkv, float scale, float logit_cap,
                                       void* stream) {
  attn::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lengths = static_cast<const int*>(lengths);
  attn::set_strides(p, strides);
  p.T = T;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hkv > 0 ? Hq / Hkv : 0;              // the g heads of a KV head share rows
  p.causal = 1;
  p.window = 0;
  p.scale = scale;
  p.cap = logit_cap;
  return attn::launch_any(dtype, head_dim, p, B, stream);
}
