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
// have to run on the tensor cores at a rate near wgmma's.
//
// What the design does about it:
//   * bf16 (every call of the model, head dims 32 to 256): flash_sm90.cuh.
//     A work item is 128 query positions of one head (64 up to T 512); a
//     persistent grid of one block per SM
//     walks the heaviest-first items with a static stride, so a short
//     prefill pays the block start once per SM.  TMA fills a ring of
//     128-key K/V chunks that runs on across items, a producer warp keeps
//     the loads in flight, two consumer warpgroups run S = Q K^T and
//     O += P V as wgmma with the softmax and O in registers, and masks are
//     built only where a chunk crosses the diagonal, the window edge or S.
//     Causal items stop at their last query and windowed items start at
//     their first visible key, as the TPU kernel skips fully masked blocks.
//     At head dim 256 (gemma-7b, gemma3-12b) the chunks are 64 keys, the
//     ring 2 stages and the wide shape's Q one buffer, so a 64 x 256 O
//     accumulator per consumer warpgroup and the tiles fit (flash_sm90.cuh).
//   * fp32 (the parity checks): attention_tile.cuh's CUDA-core path in full
//     fp32, 64 positions (32 at head dim 256) of one head per block (G = 1),
//     the body and fp32 numerics of the dense decode kernel.
//   * q, k, v and out are read and written in place through strides, in the
//     (B, H, T, D) layout of flash_attention_bhtd or the (B, T, H, D) layout
//     of the model alike.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "../../csrc/attention_tile.cuh"
#include "flash_sm90.cuh"

namespace {

// fp32 on attention_tile.cuh's CUDA-core body
template <int D>
int launch_tile(const long long* strides, const void* q, const void* k, const void* v,
                void* out, int B, int T, int S, int Hq, int Hkv, int causal, int window,
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
  p.G = 1;                                   // positions of one head per block
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.cap = logit_cap;
  return attn::launch<float, D>(p, B, stream);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  head_dim: 32, 64, 128 or 256.  strides: 12
// element strides, q (b, t, h), k (b, s, h), v (b, s, h), out (b, t, h); the
// head dim is contiguous and every row 16-byte aligned.  *kernel is set to the
// kernel the call launches: 0 = flash_sm90_kernel (TMA + wgmma), 1 =
// attention_tile's CUDA-core body.  Returns cudaGetLastError() after the launch, -1 for shapes
// the kernels do not take, -2 for a dtype or head dim they are not built for,
// -3/-4 when the CUDA driver cannot encode the tensor maps.
extern "C" int flash_attention_launch(int dtype, int head_dim, const void* q,
                                      const void* k, const void* v, void* out,
                                      const long long* strides, int B, int T, int S,
                                      int Hq, int Hkv, int causal, int window,
                                      float scale, float logit_cap, void* stream,
                                      int* kernel) {
  if (Hkv < 1 || Hq % Hkv != 0 || T < 1 || S < 1 || B < 1) return -1;
  if (dtype == 0) {
    *kernel = 0;
    return flash90::launch_any(head_dim, q, k, v, out, strides, B, T, S, Hq, Hkv, causal,
                               window, scale, logit_cap, static_cast<cudaStream_t>(stream));
  }
  if (dtype == 1) {
    *kernel = 1;
    switch (head_dim) {
      case 32: return launch_tile<32>(strides, q, k, v, out, B, T, S, Hq, Hkv, causal,
                                      window, scale, logit_cap, stream);
      case 64: return launch_tile<64>(strides, q, k, v, out, B, T, S, Hq, Hkv, causal,
                                      window, scale, logit_cap, stream);
      case 128: return launch_tile<128>(strides, q, k, v, out, B, T, S, Hq, Hkv, causal,
                                        window, scale, logit_cap, stream);
      case 256: return launch_tile<256>(strides, q, k, v, out, B, T, S, Hq, Hkv, causal,
                                        window, scale, logit_cap, stream);
    }
  }
  return -2;
}

// Dynamic shared memory of a block of the bf16 kernel at this head dim with
// nc consumer warpgroups (for reports), or -2 for a shape it is not built for.
extern "C" int flash_sm90_smem_bytes(int head_dim, int nc) {
  return flash90::smem_bytes(head_dim, nc);
}

// Dynamic shared memory of a block of attention_tile.cuh's body (the fp32
// flash and decode kernels, and the bf16 dense decode kernel at head dim
// 256) for this dtype
// (0 = bf16, 1 = fp32) and head dim (for reports), or -2 for one it is not
// built for.
extern "C" int attention_tile_smem_bytes(int dtype, int head_dim) {
  switch (head_dim) {
    case 32: return dtype == 0 ? attn::Layout<attn::bf16, 32>::BYTES
                               : attn::Layout<float, 32>::BYTES;
    case 64: return dtype == 0 ? attn::Layout<attn::bf16, 64>::BYTES
                               : attn::Layout<float, 64>::BYTES;
    case 128: return dtype == 0 ? attn::Layout<attn::bf16, 128>::BYTES
                                : attn::Layout<float, 128>::BYTES;
    case 256: return dtype == 0 ? attn::Layout<attn::bf16, 256>::BYTES
                                : attn::Layout<float, 256>::BYTES;
  }
  return -2;
}
