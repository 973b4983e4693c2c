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
// What the design does about it.  Two bodies, both split-KV with the same
// row tiles, partials and combine kernel; the launcher picks one per call
// and reports which:
//   * bf16 at head dims 32, 64, 128 and 256 (every extend of the served
//     models: the target's verify and AR steps, the draft's steps, gemma's
//     global layers at 256, the reduced drafts at 32, and a verify of any
//     gamma, which the model's dense branch allows): decode_sm90.cuh.  Split-KV over a (splits * n_tiles,
//     Hkv, B) grid planned on the host from S, so the 8k case fills the SMs
//     once and the serve shape runs one split and one kernel; a KV head's
//     g * T query rows in row tiles of at most 64 (one, up to 64 rows); a
//     producer warp keeps TMA loads of 64-key chunks in flight in a ring (3
//     chunks of K and V at D 256, 230,480 B a block); both products as
//     wgmma with the online softmax in registers (at D 256 one m64n256k16
//     accumulator; at D 32 one 32-column box a row in the 64-byte swizzle
//     and an m64n32k16 P V); a combine kernel merges the fp32 partials of
//     rows with more than one live split.
//   * fp32 at the same head dims (the parity checks):
//     kernels/csrc/decode_f32.cuh.  The same split plan (splits of at
//     least 2 chunks), row tiles and combine, on the CUDA cores in full
//     fp32: K/V chunks by cp.async into a ring, q and O in registers.
//   * lengths stay on the device: each block reads its own, the grid is
//     static, nothing waits on the host.
//   * The cache is read in place through strides, the model's (B, S+1, Hkv, D)
//     layout included: no per-layer transpose or copy.

// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "../../csrc/decode_f32.cuh"
#include "decode_sm90.cuh"

// dtype: 0 = bf16, 1 = fp32.  head_dim: 32, 64, 128 or 256.  lengths: (B,) int32
// on the device.  strides: 12 element strides, q (b, t, h), k (b, s, h),
// v (b, s, h), out (b, t, h); the head dim is contiguous and every row
// 16-byte aligned; out is contiguous.  S is the number of cache positions
// that may be read.  scratch: decode_attention_scratch_bytes() bytes (null
// when 0).  *kernel is set to the body the call launches: 0 =
// decode_sm90_kernel (split-KV, TMA + wgmma, bf16), 1 = decode_f32_kernel
// (split-KV, CUDA cores, fp32).  Returns cudaGetLastError() after the
// launch, -1 for shapes the kernels do not take or a missing scratch, -2
// for a dtype or head dim they are not built for, -3/-4 when the CUDA
// driver cannot encode the tensor maps.
//
// lse null: the whole call (k_off must be 0).  lse non-null: the partial
// entry, the same attention over ONE block of a cache split along its
// sequence, whose keys sit at positions k_off .. k_off + S - 1 (queries
// still at lengths[b] + t), for the combine across blocks by log-sum-exp.
// out then gets the block's output normalized over its visible keys, lse
// (B, T, Hq) fp32 each row's natural log-sum-exp of those keys' scores; a
// row that sees none gets 0 and -inf.  Both bodies send every live split to
// scratch and combine_kernel (splitkv_sm90.cuh) merges them and writes
// lse.
extern "C" int decode_attention_launch(int dtype, int head_dim, const void* q,
                                       const void* k, const void* v,
                                       const void* lengths, void* out, void* lse,
                                       void* scratch, const long long* strides, int B,
                                       int T, int S, int Hq, int Hkv, int k_off,
                                       float scale, float logit_cap, void* stream,
                                       int* kernel) {
  if (Hkv < 1 || Hq % Hkv != 0 || T < 1 || S < 1 || B < 1) return -1;
  float* lse_f = static_cast<float*>(lse);
  if (decode90::takes(dtype, head_dim, Hq / Hkv, T)) {
    *kernel = 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (head_dim) {
      case 32:
        return decode90::launch<32>(q, k, v, lengths, out, scratch, strides, B, T, S, Hq, Hkv,
                                    scale, logit_cap, s, lse_f, k_off);
      case 64:
        return decode90::launch<64>(q, k, v, lengths, out, scratch, strides, B, T, S, Hq, Hkv,
                                    scale, logit_cap, s, lse_f, k_off);
      case 128:
        return decode90::launch<128>(q, k, v, lengths, out, scratch, strides, B, T, S, Hq,
                                     Hkv, scale, logit_cap, s, lse_f, k_off);
      default:
        return decode90::launch<256>(q, k, v, lengths, out, scratch, strides, B, T, S, Hq,
                                     Hkv, scale, logit_cap, s, lse_f, k_off);
    }
  }
  if (decode32::takes(dtype, head_dim, Hq / Hkv, T)) {
    *kernel = 1;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (head_dim) {
      case 32:
        return decode32::launch_dense<32>(q, k, v, lengths, out, scratch, strides, B, T, S, Hq,
                                          Hkv, scale, logit_cap, s, lse_f, k_off);
      case 64:
        return decode32::launch_dense<64>(q, k, v, lengths, out, scratch, strides, B, T, S, Hq,
                                          Hkv, scale, logit_cap, s, lse_f, k_off);
      case 128:
        return decode32::launch_dense<128>(q, k, v, lengths, out, scratch, strides, B, T, S,
                                           Hq, Hkv, scale, logit_cap, s, lse_f, k_off);
      default:
        return decode32::launch_dense<256>(q, k, v, lengths, out, scratch, strides, B, T, S,
                                           Hq, Hkv, scale, logit_cap, s, lse_f, k_off);
    }
  }
  return -2;
}

// Bytes of scratch the call with these arguments needs (the split-KV
// partials of the sm90 and f32 bodies; 0 when they run one split, and every
// split's partial for the partial entry).
extern "C" long long decode_attention_scratch_bytes(int dtype, int head_dim, int B, int T,
                                                    int S, int Hq, int Hkv, int partial) {
  if (Hkv < 1 || Hq % Hkv != 0 || S < 1 || B < 1) return 0;
  if (decode90::takes(dtype, head_dim, Hq / Hkv, T))
    return decode90::scratch_bytes(head_dim, B, T, Hq, Hkv, S, partial != 0);
  if (decode32::takes(dtype, head_dim, Hq / Hkv, T))
    return decode32::scratch_bytes_dense(head_dim, B, T, Hq, Hkv, S, partial != 0);
  return 0;
}

// Dynamic shared memory of a block of the sm90 body at this head dim (for
// reports), or -2 for a head dim it is not built for.
extern "C" int decode_sm90_smem_bytes(int head_dim) {
  if (head_dim == 32) return splitkv::Cfg<32>::BYTES;
  if (head_dim == 64) return splitkv::Cfg<64>::BYTES;
  if (head_dim == 128) return splitkv::Cfg<128>::BYTES;
  if (head_dim == 256) return splitkv::Cfg<256>::BYTES;
  return -2;
}

// Dynamic shared memory of a block of the f32 body at this head dim (for
// reports), or -2 for a head dim it is not built for.
extern "C" int decode_f32_smem_bytes(int head_dim) { return decode32::smem_bytes(head_dim); }
