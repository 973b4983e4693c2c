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
// What the design does about it.  Three bodies; the launcher picks one per
// call and reports which:
//   * bf16 at head dims 64 and 128 with g * T <= 64 query rows per KV head
//     (every extend of the served models: the target's verify and AR steps,
//     the draft's steps): decode_sm90.cuh.  Split-KV over a (splits, Hkv, B)
//     grid planned on the host from S, so the 8k case fills the SMs once and
//     the serve shape runs one split and one kernel; a producer warp keeps
//     TMA loads of 64-key chunks in flight in a ring; both products as wgmma
//     with the online softmax in registers; a combine kernel merges the
//     fp32 partials of rows with more than one live split.
//   * bf16 otherwise (head dim 32, or g * T > 64, which the model's dense
//     branch allows): attention_tile.cuh's WMMA body.  One block per
//     (query tile, KV head, sequence), GQA folded into its 64 rows, the KV
//     axis a loop inside the block, 16-row WMMA tiles.
//   * fp32 (the parity checks): the same body on the CUDA cores in full
//     fp32.
//   * lengths stay on the device: each block reads its own, the grid is
//     static, nothing waits on the host.
//   * The cache is read in place through strides, the model's (B, S+1, Hkv, D)
//     layout included: no per-layer transpose or copy.

// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "../../csrc/attention_tile.cuh"
#include "decode_sm90.cuh"

// dtype: 0 = bf16, 1 = fp32.  head_dim: 32, 64 or 128.  lengths: (B,) int32
// on the device.  strides: 12 element strides, q (b, t, h), k (b, s, h),
// v (b, s, h), out (b, t, h); the head dim is contiguous and every row
// 16-byte aligned; out is contiguous.  S is the number of cache positions
// that may be read.  scratch: decode_attention_scratch_bytes() bytes (null
// when 0).  *kernel is set to the body the call launches: 0 =
// decode_sm90_kernel (split-KV, TMA + wgmma), 1 = attention_tile's WMMA
// body, 2 = its CUDA-core body.  Returns cudaGetLastError() after the
// launch, -1 for shapes the kernels do not take or a missing scratch, -2
// for a dtype or head dim they are not built for, -3/-4 when the CUDA
// driver cannot encode the tensor maps.
extern "C" int decode_attention_launch(int dtype, int head_dim, const void* q,
                                       const void* k, const void* v,
                                       const void* lengths, void* out, void* scratch,
                                       const long long* strides, int B, int T, int S,
                                       int Hq, int Hkv, float scale, float logit_cap,
                                       void* stream, int* kernel) {
  if (Hkv < 1 || Hq % Hkv != 0 || T < 1 || S < 1 || B < 1) return -1;
  if (decode90::takes(dtype, head_dim, Hq / Hkv, T)) {
    *kernel = 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (head_dim == 64)
      return decode90::launch<64>(q, k, v, lengths, out, scratch, strides, B, T, S, Hq, Hkv,
                                  scale, logit_cap, s);
    return decode90::launch<128>(q, k, v, lengths, out, scratch, strides, B, T, S, Hq, Hkv,
                                 scale, logit_cap, s);
  }
  *kernel = dtype == 0 ? 1 : 2;
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
  p.G = Hq / Hkv;                            // the g heads of a KV head share rows
  p.causal = 1;
  p.window = 0;
  p.scale = scale;
  p.cap = logit_cap;
  return attn::launch_any(dtype, head_dim, p, B, stream);
}

// Bytes of scratch the call with these arguments needs (the split-KV
// partials of the sm90 body; 0 when it runs one split or another body).
extern "C" long long decode_attention_scratch_bytes(int dtype, int head_dim, int B, int T,
                                                    int S, int Hq, int Hkv) {
  if (Hkv < 1 || Hq % Hkv != 0 || S < 1 || B < 1 ||
      !decode90::takes(dtype, head_dim, Hq / Hkv, T))
    return 0;
  return decode90::scratch_bytes(head_dim, B, T, Hq, Hkv, S);
}

// Dynamic shared memory of a block of the sm90 body at this head dim (for
// reports), or -2 for a head dim it is not built for.
extern "C" int decode_sm90_smem_bytes(int head_dim) {
  if (head_dim == 64) return splitkv::Cfg<64>::BYTES;
  if (head_dim == 128) return splitkv::Cfg<128>::BYTES;
  return -2;
}
