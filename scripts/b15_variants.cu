// B15 (window_idw_kernel of auvtpu_torch/csrc/scattered_select.cu) on
// B12's staged row loop, the first staged design, which
// scripts/b15_path_probe.py times beside the shipped one: in the radius-2
// builds on an aligned pack, a persistent grid whose warps copy their 32
// rows into shared memory by cp.async, the next chunk's while this one is
// served (window_rows<M, P, true>); each row unstaged into val[M] registers
// beside d2, the tournament carrying the value (idw_query), the prologue
// computed when the chunk is issued and again when it is served.  The
// shipped radius-2 build keeps the row in shared memory, carries no value
// and runs the prologue once.
//
// It exports the shipped file's C interface but for auvtpu_window_idw and
// auvtpu_window_idw_attributes, which launch and describe the variant, so
// the probe points the wrappers of auvtpu_torch/kernels/scattered_select.py
// at it.  A pack that is not 16-byte aligned, and the radius-1 and -3
// builds, take the rows straight into registers, as B12's do.

#define auvtpu_window_idw auvtpu_window_idw_shipped
#define auvtpu_window_idw_attributes auvtpu_window_idw_attributes_shipped
#include "../auvtpu_torch/csrc/scattered_select.cu"
#undef auvtpu_window_idw
#undef auvtpu_window_idw_attributes

namespace {

template <int M, int P, int K>
__global__ void __launch_bounds__(kSelThreads, M <= 16 ? 8 : (M <= 32 ? 4 : 1))
b15_staged_kernel(const float* __restrict__ pack, const float* __restrict__ lons, const float* __restrict__ lats,
                  const __grid_constant__ Taps<M> taps, const IdwParams par, int n, int vec,
                  float* __restrict__ out) {
  window_rows<M, P, kStagedBuild<M>>(pack, lons, lats, par.geo, n, vec,
                                     [&](const float(&val)[M], const QueryCell& qc, float, float, int q) {
                                       idw_query<M, K>(val, qc, taps, par, q, out);
                                     });
}

template <int M>
constexpr int staged_smem() {
  return kStagedBuild<M> ? 2 * kSelThreads * RowCopy<M>::kStride * 16 : 0;
}

template <int M, int P, int K>
int staged_resident(int* per_sm, int* sms) {
  static Residency cache[kMaxDevices];
  return residency((const void*)b15_staged_kernel<M, P, K>, staged_smem<M>(), cache, per_sm, sms);
}

template <int M, int P, int K>
int launch_staged_k(cudaStream_t st, const float* pack, const float* lons, const float* lats, const Taps<M>& tv,
                    const IdwParams& par, int n, float* out) {
  int vec = ((uintptr_t)pack & 15) == 0;
  const bool staged = kStagedBuild<M> && vec;
  long long blocks = ((long long)n + kSelThreads - 1) / kSelThreads;
  if (staged) {  // persistent: as many blocks as fit, at most one a block of queries
    int per_sm = 0, sms = 0;
    const int err = staged_resident<M, P, K>(&per_sm, &sms);
    if (err) return err;
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    blocks = blocks < resident ? blocks : resident;
  }
  void* args[] = {(void*)&pack, (void*)&lons, (void*)&lats, (void*)&tv, (void*)&par, &n, &vec, &out};
  return (int)cudaLaunchKernel((const void*)b15_staged_kernel<M, P, K>, dim3((unsigned)blocks), dim3(kSelThreads),
                               args, staged ? (size_t)staged_smem<M>() : 0, st);
}

template <int M, int P>
int launch_staged(cudaStream_t st, const float* pack, const float* lons, const float* lats, const float* offs,
                  const IdwParams& par, float half, int n, float* out) {
  Taps<M> tv;
  for (int t = 0; t < M; ++t) {
    tv.x[t] = offs[t] + half;
    tv.y[t] = offs[M + t] + half;
  }
  switch (par.k) {
    case 4: return launch_staged_k<M, P, 4>(st, pack, lons, lats, tv, par, n, out);
    case 8: return launch_staged_k<M, P, 8>(st, pack, lons, lats, tv, par, n, out);
    default: return launch_staged_k<M, P, 0>(st, pack, lons, lats, tv, par, n, out);
  }
}

template <int M, int P, int K>
int staged_attributes(int* out) {
  int per_sm = 0, sms = 0;
  const int err = staged_resident<M, P, K>(&per_sm, &sms);
  if (err) return err;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, (const void*)b15_staged_kernel<M, P, K>);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = per_sm;
  out[3] = staged_smem<M>();
  return 0;
}

}  // namespace

extern "C" {

// auvtpu_window_idw's interface, launching the variant.
int auvtpu_window_idw(const void* pack, int P, int M, const void* lons, const void* lats, const float* offs, int n,
                      int W, int H, const float* geo, int k, int pow_mode, float pow_e, float eps, void* out,
                      void* stream) {
  if (P != pitch_for(M) || k < 1 || k > P || pow_mode < kPowOne || pow_mode > kPowGeneral || n < 0 || W < 1 ||
      H < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  IdwParams par;
  par.geo = QueryGeom{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], W, H};
  par.k = k;
  par.pow_mode = pow_mode;
  par.pow_e = pow_e;
  par.eps = eps;
  const float half = geo[8];
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pack;
  const float *lo = (const float*)lons, *la = (const float*)lats;
  float* o = (float*)out;
  switch (M) {
    case 9: return launch_staged<9, 16>(st, p, lo, la, offs, par, half, n, o);
    case 25: return launch_staged<25, 32>(st, p, lo, la, offs, par, half, n, o);
    case 49: return launch_staged<49, 64>(st, p, lo, la, offs, par, half, n, o);
    default: return (int)cudaErrorInvalidValue;
  }
}

// auvtpu_window_idw_attributes's interface, for the variant's builds.
int auvtpu_window_idw_attributes(int M, int k, int* out) {
  switch (M * 100 + (k == 4 || k == 8 ? k : 0)) {
    case 904: return staged_attributes<9, 16, 4>(out);
    case 908: return staged_attributes<9, 16, 8>(out);
    case 900: return staged_attributes<9, 16, 0>(out);
    case 2504: return staged_attributes<25, 32, 4>(out);
    case 2508: return staged_attributes<25, 32, 8>(out);
    case 2500: return staged_attributes<25, 32, 0>(out);
    case 4904: return staged_attributes<49, 64, 4>(out);
    case 4908: return staged_attributes<49, 64, 8>(out);
    case 4900: return staged_attributes<49, 64, 0>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
