// Staging by hand into the 128-byte swizzle that TMA writes: the copies a
// producer warpgroup of 128 threads makes of a bf16 operand TMA cannot
// address (a row pitch that is not a multiple of 16 bytes, a base off 16
// bytes), so the consumers read the tile through the same wgmma
// descriptors as a TMA-loaded one.
//
// Used by the staged producers of kernels/gmm/csrc/ragged_sm90.cuh
// (kernels 1-2: stage_box_issue, stage_box_store) and gmm_capacity.cu
// (kernel 6: stage_box_issue's copies, stage_box_load, stage_box_store1,
// which load each register unit once).  (A TMA box from a map over the base
// rounded down to 16 bytes, started at the offset's column, never completed
// on the card, so such operands are staged by these copies.)
//
// One call covers one 64 x 64 box (64 rows of 128 bytes) at `box`
// (1024-byte aligned): box row r is row row0 + r of a row-major bf16
// matrix src with leading dimension ld, columns col0 .. col0 + 63.  Only
// rows r < n_rows and columns col0 + c, c < n_cols, are read; the rest is
// written as zeros.  The box is 512 16-byte units, (row r, 8 columns from
// 8u); thread pt of the producer warpgroup takes units pt + 128 i, i < 4.
// Each unit takes the widest copy its source address allows: cp.async of
// 16, 8 or 4 bytes (a source 4-byte aligned, all 8 elements to read), zeros
// by cp.async where it reads nothing; a unit that starts 2 bytes off 4 or
// ends past n_cols is loaded into registers as the aligned 16-byte chunks
// that hold its elements (stage_box_issue<true>), then shifted into place,
// masked past its last element and stored (stage_box_store), so the loads
// of a box are in flight together and other copies go between the two.
//
// Completion is the caller's: its cp.async copies land on a barrier through
// sm90::cp_async_arrive, and its stores (generic proxy) need
// sm90::fence_proxy_async before the wgmma reads of them.
//
// Internal linkage throughout (see sm90.cuh).

#pragma once

#include "sm90.cuh"

namespace stage90 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int SW = 128;                      // swizzle bytes: one box row

struct BoxRegs {
  uint4 lo[4], hi[4];                        // the register units' chunks
  uint32_t mask;                             // which of the 4 units they are
};

// Unit i of this thread: its destination, source address and the number
// of its elements to read (0..8).
__device__ __forceinline__ int box_unit(unsigned char* box, const bf16* src, long long ld,
                                        int row0, int n_rows, int col0, int n_cols, int pt,
                                        int i, unsigned char** dst, const bf16** a) {
  const int q = pt + 128 * i, r = q >> 3, u = q & 7;
  *dst = box + sm90::swizzled(static_cast<uint32_t>(r * SW + u * 16), SW);
  *a = src + (row0 + r) * ld + col0 + u * 8;          // read only when the count is > 0
  return r < n_rows ? max(0, min(8, n_cols - u * 8)) : 0;
}

// Whether a unit of nv elements at address a goes through registers: it
// starts 2 bytes off 4, or its elements end before the unit does.
__device__ __forceinline__ bool reg_unit(int nv, const bf16* a) {
  return nv > 0 &&
         (nv < 8 || (reinterpret_cast<uintptr_t>(a) & 3) != 0);
}

// Phase 1 of a box (REGS true: its register loads only, which need no free
// ring slot; false: its cp.async copies only, returning whether it issued
// any).
template <bool REGS>
__device__ __forceinline__ bool stage_box_issue(unsigned char* box, const bf16* __restrict__ src,
                                                long long ld, int row0, int n_rows, int col0,
                                                int n_cols, int pt, BoxRegs& regs) {
  if (REGS) regs.mask = 0;
  bool copied = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned char* dst;
    const bf16* a;
    const int nv = box_unit(box, src, ld, row0, n_rows, col0, n_cols, pt, i, &dst, &a);
    const uintptr_t ad = reinterpret_cast<uintptr_t>(a);
    if (reg_unit(nv, a)) {
      if (REGS) {
        // the aligned 16-byte chunks that hold the unit's elements
        const uint4* c = reinterpret_cast<const uint4*>(ad & ~uintptr_t{15});
        regs.lo[i] = __ldg(c);
        regs.hi[i] = ((ad + 2 * nv - 1) & ~uintptr_t{15}) != (ad & ~uintptr_t{15})
                         ? __ldg(c + 1)
                         : make_uint4(0u, 0u, 0u, 0u);
        regs.mask |= 1u << i;
      }
    } else if (!REGS) {
      copied = true;
      if (nv == 0 || (ad & 15) == 0) {
        sm90::cp_async16(dst, nv ? a : src, nv != 0);
      } else if ((ad & 7) == 0) {
        sm90::cp_async8(dst, a, 8);
        sm90::cp_async8(dst + 8, a + 4, 8);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) sm90::cp_async4(dst + 4 * j, a + 2 * j, 4);
      }
    }
  }
  return copied;
}

// Phase 2: the register units shifted into place (the unit's address mod
// 16 bytes), masked past the unit's last element and stored.  Returns
// whether it stored any.
__device__ __forceinline__ bool stage_box_store(unsigned char* box, const bf16* __restrict__ src,
                                                long long ld, int row0, int n_rows, int col0,
                                                int n_cols, int pt, const BoxRegs& regs) {
  if (!regs.mask) return false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!(regs.mask >> i & 1)) continue;
    unsigned char* dst;
    const bf16* a;
    const int nv = box_unit(box, src, ld, row0, n_rows, col0, n_cols, pt, i, &dst, &a);
    const int s = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
    const int j = s >> 2, bits = (s & 3) * 8;
    const uint32_t w[8] = {regs.lo[i].x, regs.lo[i].y, regs.lo[i].z, regs.lo[i].w,
                           regs.hi[i].x, regs.hi[i].y, regs.hi[i].z, regs.hi[i].w};
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // words j + k and j + k + 1 of the 32 bytes, by selects (no indexing
      // by a run-time value)
      const uint32_t x0 = j == 0 ? w[k] : j == 1 ? w[k + 1] : j == 2 ? w[k + 2] : w[k + 3];
      const uint32_t x1 = j == 0 ? w[k + 1] : j == 1 ? w[k + 2] : j == 2 ? w[k + 3] : w[k + 4];
      o[k] = __funnelshift_r(x0, x1, bits);
      // elements 2k, 2k + 1 of the unit: zero past its count
      if (2 * k >= nv) o[k] = 0u;
      else if (2 * k + 1 >= nv) o[k] &= 0xffffu;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  }
  return true;
}

// ---- the same register units with one load each (kernel 6's producer)
//
// A warp's lanes 8 g .. 8 g + 7 hold units 0..7 of one box row (box_unit's
// mapping), and the second aligned chunk of unit u is the first of unit
// u + 1.  So each lane loads only the chunk at its unit's start (when its
// unit or its left neighbour's needs it), the store phase takes the next
// chunk from lane + 1 by shuffles, and a unit 7 that reaches past its first
// chunk loads that second chunk itself (tail).  Both phases must be called
// by all 32 lanes of the warp together.  (With two loads a unit,
// stage_box_issue's, kernel 6 with x staged took 1.56x the time; PERF.md.)
struct BoxRegs1 {
  uint4 lo[4];                               // the chunk at each unit's start
  uint4 tail[4];                             // unit 7's second chunk
  uint32_t mask;                             // which units go through registers
};

__device__ __forceinline__ uint32_t shfl_next(uint32_t v) {
  return __shfl_down_sync(0xffffffffu, v, 1);
}

// A box whose 512 units are all whole and start at one offset 2 bytes off
// 4 (every row below n_rows, all 64 columns below n_cols, a row pitch of a
// multiple of 16 bytes): an operand one element off its base, inside its
// edges.  Its units need no per-unit count, test or mask: thread pt's unit
// i is its unit 0 moved 16 i rows down, in the source and in the box.
__device__ __forceinline__ bool uniform_box(const bf16* src, long long ld, int row0, int n_rows,
                                            int col0, int n_cols) {
  return n_rows >= 64 && n_cols >= 64 && (ld & 7) == 0 &&
         (reinterpret_cast<uintptr_t>(src + row0 * ld + col0) & 3) == 2;
}

// Phase 1: the register loads (no ring slot needed).  The cp.async units
// of the box are stage_box_issue<false>'s.
__device__ __forceinline__ void stage_box_load(unsigned char* box, const bf16* __restrict__ src,
                                               long long ld, int row0, int n_rows, int col0,
                                               int n_cols, int pt, BoxRegs1& regs) {
  const int u = pt & 7;
  if (uniform_box(src, ld, row0, n_rows, col0, n_cols)) {
    const bf16* a = src + (row0 + (pt >> 3)) * ld + col0 + u * 8;
    const uint4* c = reinterpret_cast<const uint4*>(reinterpret_cast<uintptr_t>(a) & ~uintptr_t{15});
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4* ci = c + i * 2 * ld;        // 16 rows on
      regs.lo[i] = __ldg(ci);
      regs.tail[i] = u == 7 ? __ldg(ci + 1) : make_uint4(0u, 0u, 0u, 0u);
    }
    regs.mask = 0xfu;
    return;
  }
  regs.mask = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned char* dst;
    const bf16* a;
    const int nv = box_unit(box, src, ld, row0, n_rows, col0, n_cols, pt, i, &dst, &a);
    const uintptr_t ad = reinterpret_cast<uintptr_t>(a);
    const bool reg = reg_unit(nv, a);
    // the unit's elements reach the chunk after its first
    const bool spans =
        reg && ((ad + 2 * nv - 1) & ~uintptr_t{15}) != (ad & ~uintptr_t{15});
    const bool left_spans = __shfl_up_sync(0xffffffffu, spans ? 1 : 0, 1) && u > 0;
    const uint4* c = reinterpret_cast<const uint4*>(ad & ~uintptr_t{15});
    regs.lo[i] = reg || left_spans ? __ldg(c) : make_uint4(0u, 0u, 0u, 0u);
    regs.tail[i] = u == 7 && spans ? __ldg(c + 1) : make_uint4(0u, 0u, 0u, 0u);
    if (reg) regs.mask |= 1u << i;
  }
}

// Words J .. J + 4 of the 32 bytes w, shifted right by `bits`.
template <int J>
__device__ __forceinline__ void shift_words(const uint32_t (&w)[8], int bits, uint32_t (&o)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = __funnelshift_r(w[J + k], w[J + k + 1], bits);
}

// A uniform box's stores: every unit shifted right by 2 + 4 J bytes.
template <int J>
__device__ __forceinline__ void store_uniform(unsigned char* dst, const BoxRegs1& regs,
                                              bool last) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 l = regs.lo[i];
    uint4 h = make_uint4(shfl_next(l.x), shfl_next(l.y), shfl_next(l.z), shfl_next(l.w));
    if (last) h = regs.tail[i];
    const uint32_t w[8] = {l.x, l.y, l.z, l.w, h.x, h.y, h.z, h.w};
    uint32_t o[4];
    shift_words<J>(w, 16, o);
    *reinterpret_cast<uint4*>(dst + 16 * SW * i) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Phase 2: each register unit shifted into place from its chunk and the
// next, masked past its last element and stored.  Returns whether this
// lane stored any.
__device__ __forceinline__ bool stage_box_store1(unsigned char* box, const bf16* __restrict__ src,
                                                 long long ld, int row0, int n_rows, int col0,
                                                 int n_cols, int pt, const BoxRegs1& regs) {
  if (!__any_sync(0xffffffffu, regs.mask != 0)) return false;
  const bool last = (pt & 7) == 7;
  if (uniform_box(src, ld, row0, n_rows, col0, n_cols)) {
    unsigned char* dst =
        box + sm90::swizzled(static_cast<uint32_t>((pt >> 3) * SW + (pt & 7) * 16), SW);
    switch ((reinterpret_cast<uintptr_t>(src + row0 * ld + col0) & 15) >> 2) {
      case 0: store_uniform<0>(dst, regs, last); break;
      case 1: store_uniform<1>(dst, regs, last); break;
      case 2: store_uniform<2>(dst, regs, last); break;
      default: store_uniform<3>(dst, regs, last); break;
    }
    return true;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 l = regs.lo[i];
    uint4 h = make_uint4(shfl_next(l.x), shfl_next(l.y), shfl_next(l.z), shfl_next(l.w));
    if (last) h = regs.tail[i];
    if (!(regs.mask >> i & 1)) continue;
    unsigned char* dst;
    const bf16* a;
    const int nv = box_unit(box, src, ld, row0, n_rows, col0, n_cols, pt, i, &dst, &a);
    const int s = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
    const int bits = (s & 3) * 8;
    const uint32_t w[8] = {l.x, l.y, l.z, l.w, h.x, h.y, h.z, h.w};
    uint32_t o[4];
    switch (s >> 2) {
      case 0: shift_words<0>(w, bits, o); break;
      case 1: shift_words<1>(w, bits, o); break;
      case 2: shift_words<2>(w, bits, o); break;
      default: shift_words<3>(w, bits, o); break;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // elements 2k, 2k + 1 of the unit: zero past its count
      if (2 * k >= nv) o[k] = 0u;
      else if (2 * k + 1 >= nv) o[k] &= 0xffffu;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  }
  return regs.mask != 0;
}

}  // namespace
}  // namespace stage90
