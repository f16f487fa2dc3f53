// What the wgmma window-attention kernels share (csrc/window_attn_wg.cu,
// K15's "wgmma" route, and csrc/batched_attn_wg.cu, K16's "square"
// route): a bf16 pair packed into a register, a consumer warpgroup's
// named barrier, and the producer warpgroup's repack of a contiguous
// [rows][hd] bf16 run into the swizzled [rows][HDP] layout wgmma reads
// (cp.async of 16 bytes where hd % 8 == 0 and the run is 16-byte aligned,
// of 4 where hd is even, else 2-byte loads and shared stores).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace wg_attn {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void consumer_barrier(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(cw + 1) : "memory");  // one warpgroup
}

// Rows [0, rows) of a contiguous [rows][hd] bf16 run into the swizzled
// [rows][HDP] part at shared address `dst`, by the producer warpgroup's
// thread t.
template <int RB, int CPR>
__device__ __forceinline__ void copy16(uint32_t dst, const bf16* src, int rows, int t) {
  const int total = rows * CPR;  // 16-byte pieces, CPR a row
  for (int i = t; i < total; i += 128) {
    const int r = i / CPR, c = i - r * CPR;
    hopper::cp_async<16>(dst + hopper::swizzled_offset<RB>(r * RB + c * 16), src + i * 8, 16);
  }
}

template <int HDP>
__device__ __forceinline__ void load_part(uint32_t dst, const bf16* src, int rows, int hd,
                                          int vec, int t) {
  constexpr int RB = HDP * 2;
  if (vec == 8) {
    switch (hd >> 3) {
      case 1: copy16<RB, 1>(dst, src, rows, t); break;
      case 2: copy16<RB, 2>(dst, src, rows, t); break;
      case 3: copy16<RB, 3>(dst, src, rows, t); break;
      case 4: copy16<RB, 4>(dst, src, rows, t); break;
      case 5: copy16<RB, 5>(dst, src, rows, t); break;
      case 6: copy16<RB, 6>(dst, src, rows, t); break;
      case 7: copy16<RB, 7>(dst, src, rows, t); break;
      default: copy16<RB, 8>(dst, src, rows, t); break;
    }
  } else if (vec == 2) {
    // 4-byte pieces in the run's order (neighbouring threads, neighbouring
    // addresses), the row and piece stepped without a division
    const int cpr = hd >> 1, dr = 128 / cpr, dc = 128 - dr * cpr;
    int r = t / cpr, c = t - r * cpr;
    for (int i = t; i < rows * cpr; i += 128) {
      hopper::cp_async<4>(dst + hopper::swizzled_offset<RB>(r * RB + c * 4), src + 2 * i, 4);
      r += dr;
      c += dc;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  } else {
    for (int r = t; r < rows; r += 128) {
      const unsigned short* s =
          reinterpret_cast<const unsigned short*>(src) + static_cast<long long>(r) * hd;
      for (int c = 0; c < hd; ++c) {
        const unsigned short e = __ldg(s + c);
        asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(
                         dst + hopper::swizzled_offset<RB>(r * RB + c * 2)),
                     "h"(e)
                     : "memory");
      }
    }
  }
}

}  // namespace wg_attn
