// The query prologue of the scattered select kernels, in registers, for
// Hopper (sm_90a): a query's (lon, lat) to its grid coordinates, its
// out-of-bounds flag, its centre cell and its offsets from that cell.
// Included by scattered_select.cu (B6, idw_select_kernel; B11,
// select_krige_kernel; B12, window_krige_kernel; B15, window_idw_kernel);
// B5 and B7 still take the torch prologue's planes
// (kernels/scattered_select.py prologue) and can adopt this one.
//
// It computes what the torch prologue computes, op for op (the build keeps
// -fmad=false, so the subtract and the multiply are two roundings, as in
// torch), which is what the compiled JAX ops compute
// (auvtpu/pallas/valid_select.py:146 _prologue, auvtpu/ops/scattered.py:34
// _normalize under jit):
//   - oob: lon < min_lon || lon > max_lon || lat < min_lat || lat > max_lat,
//     every bound rounded to f32 (a NaN coordinate is not out of bounds);
//   - x = (lon - min_lon) * inv_lon, y likewise, 0 where oob.  inv_lon is
//     f32(1) / f32(lon_step): the JAX ops are jitted with the extent as
//     static metadata, and XLA folds the division by the constant step into
//     that multiply (ops/scattered.py _normalize, grid.py inv_steps);
//   - ci = clamp(int(floor(x + 0.5)), 0, W - 1), a NaN floor cast to 0 as
//     XLA casts it (ops/scattered.py as_index, centre_cells), cj likewise;
//   - fx = x - ci, fy = y - cj.

#pragma once

#include <math.h>

// The grid's scalars the prologue reads, by value.
struct QueryGeom {
  float min_lon, max_lon, min_lat, max_lat, inv_lon, inv_lat;
  int W, H;
};

struct QueryCell {
  bool oob;
  int ci, cj;
  float fx, fy;
};

// A float -> int cast as XLA's: NaN to 0.  (cvt.rzi gives 0 for NaN too;
// this says so rather than leaning on it.)
__device__ __forceinline__ int xla_index(float v) { return isnan(v) ? 0 : __float2int_rz(v); }

__device__ __forceinline__ int clamp_index(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__device__ __forceinline__ QueryCell query_cell(float lon, float lat, const QueryGeom& g) {
  QueryCell c;
  c.oob = lon < g.min_lon || lon > g.max_lon || lat < g.min_lat || lat > g.max_lat;
  const float x = c.oob ? 0.f : __fmul_rn(__fsub_rn(lon, g.min_lon), g.inv_lon);
  const float y = c.oob ? 0.f : __fmul_rn(__fsub_rn(lat, g.min_lat), g.inv_lat);
  c.ci = clamp_index(xla_index(floorf(__fadd_rn(x, 0.5f))), g.W - 1);
  c.cj = clamp_index(xla_index(floorf(__fadd_rn(y, 0.5f))), g.H - 1);
  c.fx = __fsub_rn(x, (float)c.ci);
  c.fy = __fsub_rn(y, (float)c.cj);
  return c;
}
