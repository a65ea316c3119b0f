// The floor that random pack-row reads reach on this card: one random
// P-float row a query, its floats summed, one float written.  Built and
// timed by scripts/row_gather_probe.py; the access pattern of B11
// (auvtpu_torch/csrc/scattered_select.cu, select_krige_kernel) without its
// selection and solve.
//   mode 0: the row's cell index is read (4 bytes a query);
//   mode 1: the query's (lon, lat) are read (8 bytes) and the cell computed
//           by query_prologue.cuh, as B11 computes it;
//   mode 2: as mode 1, each load asking L2 for the whole 128-byte line
//           (ld.global.nc.L2::128B).
// The rows are read as P/4 16-byte loads through the read-only cache, one
// thread a query, kThreads a block, as B11 reads them.

#include <cuda_runtime.h>

#include "../auvtpu_torch/csrc/query_prologue.cuh"

namespace {

constexpr int kThreads = 128;

template <int P, int MODE>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ pack, const int* __restrict__ cell, const float* __restrict__ lons,
                  const float* __restrict__ lats, const QueryGeom geo, int n, float* __restrict__ out) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= n) return;
  int c;
  if (MODE == 0) {
    c = __ldg(cell + q);
  } else {
    const QueryCell qc = query_cell(__ldg(lons + q), __ldg(lats + q), geo);
    c = qc.cj * geo.W + qc.ci;
  }
  const float4* row = reinterpret_cast<const float4*>(pack + (size_t)c * P);
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < P / 4; ++t) {
    float4 v;
    if (MODE == 2)
      asm volatile("ld.global.nc.L2::128B.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                   : "l"(row + t));
    else
      v = __ldg(row + t);
    s += (v.x + v.y) + (v.z + v.w);
  }
  out[q] = s;
}

template <int P>
int launch(int mode, const float* pack, const int* cell, const float* lons, const float* lats, const QueryGeom& geo,
           int n, float* out, cudaStream_t st) {
  const dim3 g((unsigned)((n + kThreads - 1) / kThreads));
  if (mode == 0)
    row_gather_kernel<P, 0><<<g, kThreads, 0, st>>>(pack, cell, lons, lats, geo, n, out);
  else if (mode == 1)
    row_gather_kernel<P, 1><<<g, kThreads, 0, st>>>(pack, cell, lons, lats, geo, n, out);
  else
    row_gather_kernel<P, 2><<<g, kThreads, 0, st>>>(pack, cell, lons, lats, geo, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pack: (cells, P) f32, 16-byte aligned, P 16 or 32; cell: (n,) int32
// (mode 0); lons, lats: (n,) f32 (modes 1 and 2); geo: min_lon, max_lon, min_lat,
// max_lat, inv_lon, inv_lat; W, H the grid's columns and rows; out: (n,) f32.
int row_gather(const void* pack, int P, int mode, const void* cell, const void* lons, const void* lats,
               const float* geo, int W, int H, int n, void* out, void* stream) {
  if ((P != 16 && P != 32) || mode < 0 || mode > 2 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const QueryGeom g{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], W, H};
  const float* p = (const float*)pack;
  const int* c = (const int*)cell;
  const float *lo = (const float*)lons, *la = (const float*)lats;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  return P == 16 ? launch<16>(mode, p, c, lo, la, g, n, o, st) : launch<32>(mode, p, c, lo, la, g, n, o, st);
}

}  // extern "C"
