// Exact mode's query preparation for Hopper (sm_90a): B16.  Plain C
// interface, loaded with ctypes by auvtpu_torch/kernels/exact_prologue.py.
//
// Replaces no Pallas kernel: the JAX package prepares exact mode's queries
// in host numpy, float64, and the port ran the same numpy on the host:
//   prologue_kernel<In, ROUND>  <- auvtpu/ops/exact.py:139
//                                  prepare_exact_queries (In int32 or int64:
//                                  cell-aligned queries, the reference
//                                  harness's index -> geo -> grid round-trip
//                                  and the split into anchor and scaled
//                                  residue) and :449 _prepare_scattered (In
//                                  double: raw coordinates); ROUND the
//                                  kriging anchor, else the floor anchor;
//                                  with auvtpu/ops/exact_fast.py's aligned
//                                  mask of the two-tier path (the plain
//                                  version: kernels/exact_prologue.py
//                                  prologue_ref, torch float64 ops)
//
// What it computes, one thread a query, op for op as numpy does in float64
// (each operation an intrinsic rounded to nearest, so nothing contracts
// into a fused multiply-add whatever the build's flags):
//   - cell form, from the query's column and row: qlon = min_lon +
//     (double)col * lon_step, qlat likewise (numpy converts the int64 index
//     first); scattered form: qlon, qlat are the query's coordinates;
//   - oob = qlon < min_lon || qlon > max_lon || qlat < min_lat || qlat >
//     max_lat (a NaN coordinate is not out of bounds);
//   - x = oob ? 0 : (qlon - min_lon) / lon_step (IEEE division), y likewise;
//   - the anchors: ROUND clamp(floor(x + 0.5), 0, W - 1), else floor(x); a
//     NaN floor (a NaN coordinate of the scattered form) becomes 0, which is
//     what the JAX package's int32 anchors hold (numpy's int64 of NaN,
//     -2**63, wraps to 0 there); the anchors are written as int64;
//   - cell form only: exi = rint(x - ci) (round half to even, as np.rint),
//     through int64 and back as numpy's astype does; ex_key = ((x - ci) -
//     exi) * eps_scale; the key is exact in float32 where (double)(float)
//     ex_key == ex_key (a NaN or an overflow is not), ey_key likewise;
//     variant = 2 exi + eyi; aligned = ci == col && cj == row && variant ==
//     0 && !oob; flat = clamp(row * W + col, 0, H * W - 1) in int64.
// Every query's inexact keys, and with the aligned mask every query not
// aligned, are counted into two device ints (a ballot a warp, one atomic
// add a warp), which the host reads once to raise or to pick B13's path.
// `fields` chooses which outputs are written (the anchors and oob always).
//
// What bounds it on the H100: bytes.  A query reads 8 or 16 bytes and
// writes 17 (anchors, oob) to 62 (keys, variant, both coordinate pairs,
// aligned, flat); ~30 float64 operations a query are far below the card's
// float64 rate.  The accesses are coalesced, one element a thread; the
// counts cost one atomic a warp.  One thread a query in blocks of 256.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// the outputs `fields` asks for (kernels/exact_prologue.py KEYS, GEO, GRID,
// ALIGNED, FLAT)
constexpr int kKeys = 1;     // ex_key, ey_key (2, n) f32 and variant (n,) int32
constexpr int kGeo = 2;      // qlon, qlat (2, n) f64 (cell form)
constexpr int kGrid = 4;     // x, y (2, n) f64
constexpr int kAligned = 8;  // aligned (n,) bool and the count of queries not aligned
constexpr int kFlat = 16;    // the query cell row * W + col, clamped to the plane, (n,) int64
constexpr int kCellFields = kKeys | kGeo | kGrid | kAligned | kFlat;

template <typename In>
struct PrologueArgs {
  const In* a;  // (n,) columns (cell form) or longitudes
  const In* b;  // (n,) rows or latitudes
  int n;
  int H, W;
  double min_lon, max_lon, min_lat, max_lat, lon_step, lat_step;
  double eps_scale;
  int fields;
  int64_t* anchors;  // (2, n) ci then cj
  uint8_t* oob;      // (n,)
  int32_t* counts;   // (2,) inexact keys, queries not aligned; zero before the launch
  float* keys;       // kKeys: (2, n) ex_key then ey_key
  int32_t* variant;  // kKeys: (n,)
  double* geo;       // kGeo: (2, n) qlon then qlat
  double* xy;        // kGrid: (2, n) x then y
  uint8_t* aligned;  // kAligned: (n,)
  int64_t* flat;     // kFlat: (n,)
};

// an anchor from its floor: NaN to 0
__device__ __forceinline__ long long anchor_of(double f) { return isnan(f) ? 0LL : (long long)f; }

__device__ __forceinline__ long long clamp_ll(long long v, long long hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// the scaled residue of a coordinate at its anchor: (x - c) - rint(x - c),
// times eps_scale; the rint's integer in `whole`
__device__ __forceinline__ double scaled_residue(double x, long long c, double eps_scale, long long& whole) {
  const double d = __dsub_rn(x, (double)c);
  whole = (long long)rint(d);
  return __dmul_rn(__dsub_rn(d, (double)whole), eps_scale);
}

__device__ __forceinline__ bool f32_exact(double k) { return (double)__double2float_rn(k) == k; }

template <typename In, bool ROUND>
__global__ void __launch_bounds__(kThreads) prologue_kernel(const PrologueArgs<In> p) {
  constexpr bool kCell = !std::is_same<In, double>::value;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool inexact = false, misaligned = false;
  if (i < p.n) {
    double qlon, qlat;
    long long col = 0, row = 0;
    if constexpr (kCell) {
      col = (long long)p.a[i];
      row = (long long)p.b[i];
      qlon = __dadd_rn(p.min_lon, __dmul_rn((double)col, p.lon_step));
      qlat = __dadd_rn(p.min_lat, __dmul_rn((double)row, p.lat_step));
    } else {
      qlon = p.a[i];
      qlat = p.b[i];
    }
    const bool oob = qlon < p.min_lon || qlon > p.max_lon || qlat < p.min_lat || qlat > p.max_lat;
    const double x = oob ? 0.0 : __ddiv_rn(__dsub_rn(qlon, p.min_lon), p.lon_step);
    const double y = oob ? 0.0 : __ddiv_rn(__dsub_rn(qlat, p.min_lat), p.lat_step);
    long long ci, cj;
    if constexpr (ROUND) {
      ci = clamp_ll(anchor_of(floor(__dadd_rn(x, 0.5))), p.W - 1);
      cj = clamp_ll(anchor_of(floor(__dadd_rn(y, 0.5))), p.H - 1);
    } else {
      ci = anchor_of(floor(x));
      cj = anchor_of(floor(y));
    }
    p.anchors[i] = ci;
    p.anchors[p.n + i] = cj;
    p.oob[i] = oob;
    if (p.fields & kGrid) {
      p.xy[i] = x;
      p.xy[p.n + i] = y;
    }
    if constexpr (kCell) {
      long long exi, eyi;
      const double kx = scaled_residue(x, ci, p.eps_scale, exi);
      const double ky = scaled_residue(y, cj, p.eps_scale, eyi);
      inexact = !f32_exact(kx) || !f32_exact(ky);
      const long long v = 2 * exi + eyi;
      if (p.fields & kKeys) {
        p.keys[i] = __double2float_rn(kx);
        p.keys[p.n + i] = __double2float_rn(ky);
        p.variant[i] = (int32_t)v;
      }
      if (p.fields & kGeo) {
        p.geo[i] = qlon;
        p.geo[p.n + i] = qlat;
      }
      if (p.fields & kAligned) {
        const bool al = ci == col && cj == row && v == 0 && !oob;
        p.aligned[i] = al;
        misaligned = !al;
      }
      if (p.fields & kFlat) p.flat[i] = clamp_ll(row * p.W + col, (long long)p.H * p.W - 1);
    }
  }
  // whole warps reach the ballots: threads past n vote false
  const unsigned in_w = __ballot_sync(0xffffffffu, inexact);
  const unsigned mis_w = __ballot_sync(0xffffffffu, misaligned);
  if ((threadIdx.x & 31) == 0) {
    if (in_w) atomicAdd(p.counts, __popc(in_w));
    if (mis_w) atomicAdd(p.counts + 1, __popc(mis_w));
  }
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <typename In>
int launch(bool round_anchor, const PrologueArgs<In>& p, cudaStream_t st) {
  if (round_anchor)
    prologue_kernel<In, true><<<blocks_for(p.n), kThreads, 0, st>>>(p);
  else
    prologue_kernel<In, false><<<blocks_for(p.n), kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename In>
int launch_in(bool round_anchor, const void* a, const void* b, int n, int H, int W, const double* geo, double eps_scale,
              int fields, void* anchors, void* oob, void* counts, void* keys, void* variant, void* geo_out, void* xy,
              void* aligned, void* flat, cudaStream_t st) {
  PrologueArgs<In> p;
  p.a = (const In*)a;
  p.b = (const In*)b;
  p.n = n;
  p.H = H;
  p.W = W;
  p.min_lon = geo[0];
  p.max_lon = geo[1];
  p.min_lat = geo[2];
  p.max_lat = geo[3];
  p.lon_step = geo[4];
  p.lat_step = geo[5];
  p.eps_scale = eps_scale;
  p.fields = fields;
  p.anchors = (int64_t*)anchors;
  p.oob = (uint8_t*)oob;
  p.counts = (int32_t*)counts;
  p.keys = (float*)keys;
  p.variant = (int32_t*)variant;
  p.geo = (double*)geo_out;
  p.xy = (double*)xy;
  p.aligned = (uint8_t*)aligned;
  p.flat = (int64_t*)flat;
  return launch<In>(round_anchor, p, st);
}

// every build the wrapper launches, in auvtpu_exact_prologue_attributes' order
const void* const kBuilds[] = {
    (const void*)prologue_kernel<int32_t, true>, (const void*)prologue_kernel<int32_t, false>,
    (const void*)prologue_kernel<int64_t, true>, (const void*)prologue_kernel<int64_t, false>,
    (const void*)prologue_kernel<double, true>,  (const void*)prologue_kernel<double, false>,
};

}  // namespace

extern "C" {

// B16.  in_type 0: a, b the (n,) int32 columns and rows of cell-aligned
// queries; 1: int64; 2: the (n,) f64 longitudes and latitudes of scattered
// queries.  round_anchor 1: the kriging anchor, 0: the floor anchor.  The grid:
// H, W and, by value, min_lon, max_lon, min_lat, max_lat, lon_step,
// lat_step (the host's f64 (max - min) / (W - 1) and (H - 1)); eps_scale
// the residue's scale.  Outputs: anchors (2, n) int64, oob (n,) uint8 and
// counts (2,) int32 (zero before the call) always; keys (2, n) f32 and
// variant (n,) int32 with KEYS, geo (2, n) f64 with GEO, xy (2, n) f64
// with GRID, aligned (n,) uint8 with ALIGNED, flat (n,) int64 with FLAT,
// null otherwise; the scattered form takes GRID alone.  Returns the
// launch's cudaError_t.
int auvtpu_exact_prologue(int in_type, int round_anchor, const void* a, const void* b, int n, int H, int W,
                          double min_lon, double max_lon, double min_lat, double max_lat, double lon_step,
                          double lat_step, double eps_scale, int fields, void* anchors, void* oob, void* counts,
                          void* keys, void* variant, void* geo, void* xy, void* aligned, void* flat, void* stream) {
  if (H < 1 || W < 1 || n < 0 || in_type < 0 || in_type > 2 || (fields & ~kCellFields) != 0 ||
      (in_type == 2 && (fields & ~kGrid) != 0) || anchors == nullptr || oob == nullptr || counts == nullptr ||
      ((fields & kKeys) && (keys == nullptr || variant == nullptr)) || ((fields & kGeo) && geo == nullptr) ||
      ((fields & kGrid) && xy == nullptr) || ((fields & kAligned) && aligned == nullptr) ||
      ((fields & kFlat) && flat == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const double g[6] = {min_lon, max_lon, min_lat, max_lat, lon_step, lat_step};
  const bool r = round_anchor != 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_type == 0)
    return launch_in<int32_t>(r, a, b, n, H, W, g, eps_scale, fields, anchors, oob, counts, keys, variant, geo, xy,
                              aligned, flat, st);
  if (in_type == 1)
    return launch_in<int64_t>(r, a, b, n, H, W, g, eps_scale, fields, anchors, oob, counts, keys, variant, geo, xy,
                              aligned, flat, st);
  return launch_in<double>(r, a, b, n, H, W, g, eps_scale, fields, anchors, oob, counts, keys, variant, geo, xy,
                           aligned, flat, st);
}

// The resources of build `which` (kBuilds' order) on the current card:
// registers a thread, local bytes a thread, resident blocks an SM at
// kThreads a block.  For the resource report of chip_smoke.py.
int auvtpu_exact_prologue_attributes(int which, int* out) {
  if (which < 0 || which >= (int)(sizeof(kBuilds) / sizeof(kBuilds[0]))) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kBuilds[which]);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kBuilds[which], kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return 0;
}

const char* auvtpu_exact_prologue_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
