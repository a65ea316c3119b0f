// B12 (window_krige_kernel of auvtpu_torch/csrc/scattered_select.cu) in the
// designs that scripts/b12_variant_probe.py times beside the shipped one,
// for the exponential model.  Built with nvcc's -D, one build a variant:
//
//   B12_STAGES         0: the rows loaded straight into registers (the
//                      design before the staging, one query a thread);
//                      1: a warp's 32 rows copied into shared memory, then
//                      selected and solved, a chunk at a time; 2 (default):
//                      the shipped pipeline, a persistent grid, the next
//                      chunk's rows copied while this one is solved
//   B12_COPY           0 (default): 16-byte cp.async pieces; 1: one
//                      cp.async.bulk a row, completing on the stage's
//                      mbarrier
//   B12_L2_HINT        1: the cp.async pieces ask L2 for the whole 128-byte
//                      line (.L2::128B)
//   B12_MIN_BLOCKS_R2  the launch bounds' minimum of resident blocks of 128
//   B12_MIN_BLOCKS_R3  threads an SM for the radius-2 (default 4) and
//                      radius-3 (default 1) builds; radius 1 keeps 8
//
// It exports the shipped file's C interface but for auvtpu_window_krige and
// auvtpu_window_krige_attributes, which launch and describe the variant, so
// the probe points the wrappers of auvtpu_torch/kernels/scattered_select.py
// at it.  A pack that is not 16-byte aligned takes scalar loads straight
// into registers, whatever the variant.

#define auvtpu_window_krige auvtpu_window_krige_shipped
#define auvtpu_window_krige_attributes auvtpu_window_krige_attributes_shipped
#include "../auvtpu_torch/csrc/scattered_select.cu"
#undef auvtpu_window_krige
#undef auvtpu_window_krige_attributes

#ifndef B12_STAGES
#define B12_STAGES 2
#endif
#ifndef B12_COPY
#define B12_COPY 0
#endif
#ifndef B12_L2_HINT
#define B12_L2_HINT 0
#endif
#ifndef B12_MIN_BLOCKS_R2
#define B12_MIN_BLOCKS_R2 4
#endif
#ifndef B12_MIN_BLOCKS_R3
#define B12_MIN_BLOCKS_R3 1
#endif

namespace {

constexpr int kStages = B12_STAGES > 0 ? B12_STAGES : 1;

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
#if B12_L2_HINT
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem) : "memory");
#else
  cp_async16(smem, gmem);
#endif
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// stage_rows's aligned branch, by copy16
template <int M, int P>
__device__ __forceinline__ void variant_stage_rows(const float* __restrict__ pack, int cell, float4* stage, int lane) {
  constexpr int C = RowCopy<M>::kPieces, S = RowCopy<M>::kStride;
#pragma unroll
  for (int it = 0; it < C; ++it) {
    const int i = it * 32 + lane;
    const int r = i / C, c = i % C;
    const int rc = __shfl_sync(0xffffffffu, cell, r);
    if (rc >= 0) copy16(stage + r * S + c, pack + (size_t)rc * P + 4 * c);
  }
}

template <int M, int P>
__global__ void __launch_bounds__(kSelThreads, M <= 16 ? 8 : (M <= 32 ? B12_MIN_BLOCKS_R2 : B12_MIN_BLOCKS_R3))
b12_variant_kernel(const float* __restrict__ pack, const float* __restrict__ lons, const float* __restrict__ lats,
                   const __grid_constant__ KrigeTaps<M> taps, const KrigeParams par, int n, int vec,
                   float* __restrict__ out) {
  constexpr int S = RowCopy<M>::kStride;
  constexpr unsigned kRowBytes = 16 * RowCopy<M>::kPieces;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long chunks = ((long long)n + 31) / 32;
  const long long step = (long long)gridDim.x * kWarpsPerBlock;
  long long w = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (B12_STAGES == 0 || !vec) {  // rows straight into registers
    for (; w < chunks; w += step) {
      const int q = (int)(w * 32) + lane;
      if (q >= n) continue;
      const float lon = __ldg(lons + q);
      const float lat = __ldg(lats + q);
      const QueryCell qc = query_cell(lon, lat, par.geo);
      const float* row = pack + (size_t)row_of(qc, par.geo.W) * P;
      float val[M];
      if (vec)
        load_row<M, true>(row, val);
      else
        load_row<M, false>(row, val);
      krige_query<M, kExponential, kMeanOrNaN>(val, qc, lon, lat, taps, par, n, q, out);
    }
    return;
  }
  extern __shared__ float4 b12v_stages[];
  __shared__ uint64_t b12v_bars[kWarpsPerBlock][kStages];
  float4* stages = b12v_stages + warp * (kStages * 32 * S);
  uint64_t* bars = b12v_bars[warp];
  unsigned phases = 0;  // bit s: the parity stage s's barrier completes next
  if (B12_COPY == 1) {
    if (lane == 0)
      for (int st = 0; st < kStages; ++st) bar_init(bars + st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncwarp();
  }
  const auto issue = [&](long long c, int st, float& lon, float& lat) {
    const int q = (int)(c * 32) + lane;
    lon = q < n ? __ldg(lons + q) : 0.f;
    lat = q < n ? __ldg(lats + q) : 0.f;
    const int cell = q < n ? row_of(query_cell(lon, lat, par.geo), par.geo.W) : -1;
    float4* stage = stages + st * 32 * S;
    if constexpr (B12_COPY == 1) {
      const unsigned live = __ballot_sync(0xffffffffu, cell >= 0);
      if (lane == 0) bar_expect(bars + st, (unsigned)__popc(live) * kRowBytes);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after this stage's last reads
      __syncwarp();
      if (cell >= 0) bulk_copy(stage + lane * S, pack + (size_t)cell * P, kRowBytes, bars + st);
    } else {
      variant_stage_rows<M, P>(pack, cell, stage, lane);
      cp_async_commit();
    }
  };
  const auto solve = [&](long long c, int st, float lon, float lat, bool pending) {
    if constexpr (B12_COPY == 1) {
      bar_wait(bars + st, (phases >> st) & 1u);
      phases ^= 1u << st;
    } else {
      if (pending)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
    }
    __syncwarp();
    float val[M];
    unstage_row<M>(stages + st * 32 * S + lane * S, val);
    __syncwarp();
    const int q = (int)(c * 32) + lane;
    if (q < n) {
      const QueryCell qc = query_cell(lon, lat, par.geo);
      krige_query<M, kExponential, kMeanOrNaN>(val, qc, lon, lat, taps, par, n, q, out);
    }
  };
  if constexpr (kStages == 1) {
    for (; w < chunks; w += step) {
      float lon, lat;
      issue(w, 0, lon, lat);
      solve(w, 0, lon, lat, false);
    }
  } else {
    float lon = 0.f, lat = 0.f;
    if (w < chunks) issue(w, 0, lon, lat);
    for (int st = 0; w < chunks; w += step, st ^= 1) {
      float lon_n = 0.f, lat_n = 0.f;
      const bool more = w + step < chunks;
      if (more) issue(w + step, st ^ 1, lon_n, lat_n);
      solve(w, st, lon, lat, more);
      lon = lon_n;
      lat = lat_n;
    }
  }
}

template <int M>
constexpr int variant_smem() {
  return B12_STAGES > 0 ? kStages * kSelThreads * RowCopy<M>::kStride * 16 : 0;
}

// The shared memory above the 48 KB default (the two stages at radius 3) is
// granted first: a grant is each device's, and is asked on every call.
template <int M, int P>
int variant_resident(int* per_sm, int* sms) {
  static Residency cache[kMaxDevices];
  const void* fn = (const void*)b12_variant_kernel<M, P>;
  const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, variant_smem<M>());
  if (err != cudaSuccess) return (int)err;
  return residency(fn, variant_smem<M>(), cache, per_sm, sms);
}

template <int M, int P>
int launch_variant(cudaStream_t st, const float* pack, const float* lons, const float* lats, const float* offs,
                   KrigeParams par, int n, float* out) {
  KrigeTaps<M> tv;
  if (!krige_taps(offs, par.half, tv)) return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const int err = variant_resident<M, P>(&per_sm, &sms);
  if (err) return err;
  long long blocks = ((long long)n + kSelThreads - 1) / kSelThreads;
  if (B12_STAGES == 2) {
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    blocks = blocks < resident ? blocks : resident;
  }
  int vec = ((uintptr_t)pack & 15) == 0;
  void* args[] = {&pack, &lons, &lats, &tv, &par, &n, &vec, &out};
  return (int)cudaLaunchKernel((const void*)b12_variant_kernel<M, P>, dim3((unsigned)blocks), dim3(kSelThreads), args,
                               (size_t)variant_smem<M>(), st);
}

}  // namespace

extern "C" {

// auvtpu_window_krige's interface; the exponential model only.
int auvtpu_window_krige(const void* pack, int P, int M, const void* lons, const void* lats, const float* offs, int n,
                        int W, int H, const float* geo, const float* vario, const void* p_nugget, const void* p_sill,
                        const void* p_range, int model, void* out, void* stream) {
  if (P != pitch_for(M) || model != kExponential || n < 0 || W < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const KrigeParams par = krige_params(W, H, geo, vario, p_nugget, p_sill, p_range, 0, 0.f);
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pack;
  const float *lo = (const float*)lons, *la = (const float*)lats;
  float* o = (float*)out;
  switch (M) {
    case 9: return launch_variant<9, 16>(st, p, lo, la, offs, par, n, o);
    case 25: return launch_variant<25, 32>(st, p, lo, la, offs, par, n, o);
    case 49: return launch_variant<49, 64>(st, p, lo, la, offs, par, n, o);
    default: return (int)cudaErrorInvalidValue;
  }
}

// auvtpu_window_krige_attributes's interface, for the variant's builds.
int auvtpu_window_krige_attributes(int M, int model, int* out) {
  if (model != kExponential) return (int)cudaErrorInvalidValue;
  const void* fn;
  int per_sm = 0, sms = 0, err, smem;
  switch (M) {
    case 9: fn = (const void*)b12_variant_kernel<9, 16>; err = variant_resident<9, 16>(&per_sm, &sms);
      smem = variant_smem<9>(); break;
    case 25: fn = (const void*)b12_variant_kernel<25, 32>; err = variant_resident<25, 32>(&per_sm, &sms);
      smem = variant_smem<25>(); break;
    case 49: fn = (const void*)b12_variant_kernel<49, 64>; err = variant_resident<49, 64>(&per_sm, &sms);
      smem = variant_smem<49>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = per_sm;
  out[3] = smem;
  return 0;
}

}  // extern "C"
