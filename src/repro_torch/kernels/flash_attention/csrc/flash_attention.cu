// Flash attention for prefill, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel of
// src/repro/kernels/flash_attention/flash_attention.py (called through
// flash_attention_bhtd): causal (or non-causal) attention of T queries over S
// keys of the same sequence, with an optional sliding window and tanh logit
// cap, GQA through h // g, masking by index:
//
//   out[b, h, t] = softmax_s( cap(q[b, h, t] . k[b, h/g, s] * scale)
//                             | s <= t, s > t - window ) . v[b, h/g]
//
// What bounds it on an H100: the two products.  At the serve prefill (8
// prompts of 256 tokens, 28 query heads of 128) a call does ~3 GFLOP against
// ~29 MB of q/k/v/out; at 4096 tokens ~120 GFLOP against ~37 MB, ~0.12 ms at
// the bf16 tensor-core peak, so the kernel is compute bound and the products
// have to run on the tensor cores.
//
// What the design does about it (the body is attention_tile.cuh):
//   * One block per (64-query tile, query head, sequence); blocks run in no
//     order, so the TPU grid's sequential KV axis is a loop inside the block
//     and the running max, sum and output stay in shared memory.
//   * bf16 products on the tensor cores (WMMA 16x16x16, fp32 accumulation);
//     fp32 inputs, used by the parity checks, stay in full fp32 on the CUDA
//     cores.
//   * Causal blocks stop at their last query position and windowed blocks
//     start at their first visible key, as the TPU kernel skips fully masked
//     blocks.
//   * q, k, v and out are read and written in place through strides, in the
//     (B, H, T, D) layout of flash_attention_bhtd or the (B, T, H, D) layout
//     of the model alike.
//   * Simple and right first: no TMA, no wgmma, one K/V chunk in flight.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "../../csrc/attention_tile.cuh"

// dtype: 0 = bf16, 1 = fp32.  head_dim: 32, 64 or 128.  strides: 12 element
// strides, q (b, t, h), k (b, s, h), v (b, s, h), out (b, t, h); the head dim
// is contiguous and every row 16-byte aligned.
extern "C" int flash_attention_launch(int dtype, int head_dim, const void* q,
                                      const void* k, const void* v, void* out,
                                      const long long* strides, int B, int T, int S,
                                      int Hq, int Hkv, int causal, int window,
                                      float scale, float logit_cap, void* stream) {
  attn::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lengths = nullptr;                       // positions are indices
  attn::set_strides(p, strides);
  p.T = T;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = 1;                                   // 64 positions of one head per block
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.cap = logit_cap;
  return attn::launch_any(dtype, head_dim, p, B, stream);
}
