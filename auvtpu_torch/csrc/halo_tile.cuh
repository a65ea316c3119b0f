// The NaN-encoded halo tile of a block, loaded into shared memory from the
// elevation and validity planes as they are, for Hopper (sm_90a).  Included
// by window_fill.cu: B3 (fill_tile_kernel), B1 (kriging_fill_kernel) and B2
// (topk_tile_kernel).
//
// A block of BW x BH threads (BW = 32: threadIdx.x is the lane) fills the
// th x tw tile whose cell (0, 0) is the plane's (r0 - R, c0 - R).  A tile
// cell is the plane's elevation where the cell lies inside the plane and
// its validity is > 0.5, NaN otherwise (a select: no arithmetic touches a
// NaN).  The planes are read with their own row pitches pe and pv (in
// elements; columns adjacent), so a window view of a larger mosaic is taken
// as it is and no padded copy is made.  Warp w loads tile rows w, w + BH,
// ..., BATCH rows a batch, its lanes on adjacent columns (coalesced), every
// load of a batch issued before any store: the loads are L2 round trips,
// and one pair at a time left the block waiting on each.  The caller
// synchronises the block before reading the tile.

#pragma once

#include <math.h>
#include <stddef.h>

template <int BW, int BH, int BATCH>
__device__ __forceinline__ void load_halo_tile(float* __restrict__ tile, int th, int tw, int r0, int c0, int R,
                                               const float* __restrict__ elev, int pe,
                                               const float* __restrict__ valid, int pv, int H, int W) {
  const int lane = threadIdx.x;
  for (int tc0 = 0; tc0 < tw; tc0 += 2 * BW) {
    for (int tr0 = threadIdx.y; tr0 < th; tr0 += BH * BATCH) {
      float e[BATCH][2], va[BATCH][2];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int tr = tr0 + b * BH;
        const int gr = r0 - R + tr;
        const bool row_in = tr < th && gr >= 0 && gr < H;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tc = tc0 + lane + h * BW;
          const int gc = c0 - R + tc;
          const bool in = row_in && tc < tw && gc >= 0 && gc < W;
          e[b][h] = in ? __ldg(elev + (size_t)gr * pe + gc) : 0.f;
          va[b][h] = in ? __ldg(valid + (size_t)gr * pv + gc) : 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int tr = tr0 + b * BH;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tc = tc0 + lane + h * BW;
          if (tr < th && tc < tw) tile[tr * tw + tc] = va[b][h] > 0.5f ? e[b][h] : NAN;
        }
      }
    }
  }
}
