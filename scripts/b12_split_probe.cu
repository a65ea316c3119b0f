// B12 (window_krige_kernel of auvtpu_torch/csrc/scattered_select.cu) cut
// short after its selection: the query prologue, the pack row read straight
// into registers, the d2 of its M taps and the four tournaments with their
// knock-outs, as krige_query runs them, and one float written a query (the
// four values, the count and the tags summed, so nothing is dropped as
// dead).  No centres, no gamma, no solve.  Built and timed by
// scripts/b12_variant_probe.py: against the row-gather floor
// (scripts/row_gather_probe.cu) and the whole kernel it splits B12's time
// into gather, selection and solve.

#include "../auvtpu_torch/csrc/scattered_select.cu"

namespace {

template <int M, int P>
__global__ void __launch_bounds__(kSelThreads)
b12_select_only_kernel(const float* __restrict__ pack, const float* __restrict__ lons,
                       const float* __restrict__ lats, const __grid_constant__ KrigeTaps<M> taps,
                       const QueryGeom geo, int n, float* __restrict__ out) {
  const int q = blockIdx.x * kSelThreads + threadIdx.x;
  if (q >= n) return;
  const QueryCell qc = query_cell(__ldg(lons + q), __ldg(lats + q), geo);
  float val[M];
  load_row<M, true>(pack + (size_t)(qc.cj * geo.W + qc.ci) * P, val);
  float d2[M];
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const float di = taps.x[t] - qc.fx;
    const float dj = taps.y[t] - qc.fy;
    d2[t] = val[t] < kHalfSentinel ? di * di + dj * dj : kInf;
  }
  float vz[4] = {0.f, 0.f, 0.f, 0.f};
  int tag[4] = {0, 0, 0, 0};
  int cnt = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    float m, v;
    int id;
    tree_min<0, M, M>(d2, val, [&](int t) { return taps.tag[t]; }, m, id, v);
    if (!(m < kHalfInf)) break;
    vz[s] = v;
    tag[s] = id;
    cnt = s + 1;
    if (s == 3) break;
#pragma unroll
    for (int t = 0; t < M; ++t) d2[t] = id == taps.tag[t] ? kInf : d2[t];
  }
  out[q] = (((vz[0] + vz[1]) + vz[2]) + vz[3]) + (float)(cnt + tag[0] + tag[1] + tag[2] + tag[3]);
}

}  // namespace

extern "C" {

// As auvtpu_window_krige for M = 25 (P = 32), the pack 16-byte aligned,
// without the variogram: out (n,) f32.
int b12_select_only(const void* pack, const void* lons, const void* lats, const float* offs, int n, int W, int H,
                    const float* geo, void* out, void* stream) {
  if (n <= 0 || ((uintptr_t)pack & 15)) return (int)cudaErrorInvalidValue;
  KrigeTaps<25> tv;
  if (!krige_taps(offs, geo[8], tv)) return (int)cudaErrorInvalidValue;
  const QueryGeom g{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], W, H};
  const dim3 grid((unsigned)((n + kSelThreads - 1) / kSelThreads));
  b12_select_only_kernel<25, 32><<<grid, kSelThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pack, (const float*)lons, (const float*)lats, tv, g, n, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
