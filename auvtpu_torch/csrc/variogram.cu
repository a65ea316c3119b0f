// The variogram layer's two kernels for Hopper (sm_90a): the binned pair sums
// (B9) and the Gauss-Newton variogram fit (B10).  Plain C interface, loaded
// with ctypes by auvtpu_torch/kernels/variogram.py.
//
// Neither has a Pallas counterpart: the JAX package computes both as XLA
// scans inside the program it compiles for the fit-then-fill:
//   pair_sums_tile_kernel<T> + pair_sums_finish_kernel
//       <- auvtpu/variogram.py:60 _pair_sums_binned (a scan over the
//          half-plane lag offsets)                                      (B9)
//   fit_model_kernel
//       <- auvtpu/variogram.py:337 fit_model (a scan of iters damped
//          Gauss-Newton steps)                                          (B10)
//
// B9 computes, for every base cell (i, j) of an n_rows x n_cols block whose
// cell (0, 0) is the source plane's (0, col0), and every (dy, dx, bin) of an
// offset table,
//     both = v(i, j) * v(i+dy, col0+j+dx);  d = (e(i, j) - e(i+dy, col0+j+dx)) * both
//     s[bin] += (double)(d * d);  c[bin] += (double)both
// where a partner outside the source plane reads as elevation 0, validity 0
// (what the plain version's zero padding gives).  The f32 (or f64) ops are
// the plain version's, op for op, in the planes' dtype (-fmad=false keeps
// them single roundings); the sums are float64, so counts are exact and the
// sums, rounded once to f32 by the caller, do not depend on the order.  One
// layout serves the whole grid (col0 = 0, every column), a row band with the
// next band's rows below it, and a 2-D block inside its halo-extended block
// (col0 = max_lag); the planes are read in place with their row pitches.
//
// B9's shape.  A block of 32 x 8 threads takes a 32 x 32 tile of base cells
// (four rows a thread, its lanes on adjacent columns) and stages the tile's
// partner halo, (32 + R) x (32 + 2R) cells, in shared memory; the offset
// table, grouped by bin (a stable sort: within a bin the table's own order),
// sits beside it.  A thread keeps one f64 sum and one count, runs over one
// bin's offsets, and at the bin's end the block sums them in a fixed order
// (warp shuffles, then the warps in order) into its (bin) partial, written to
// an (n_blocks, n_out, 2) buffer.  A second kernel sums each bin's partials
// over the blocks, again in a fixed order.  No atomics: a call gives the same
// bits every time, which the fit's one landing needs (ROADMAP section C1).
//
// Two paths, chosen per block from the data.  While staging its halo each
// thread notes whether a cell has a validity outside {0, 1} or an elevation
// of magnitude above 2**126 (2**1022 in f64; inf and NaN among them), so that
// no difference of two elevations overflows; cells outside the plane read
// (0, 0) and qualify.  A block-wide vote picks the path.
//   general  (a cell outside the identity): the halo staged as (elevation,
//            validity) pairs and the formula above, pair for pair.
//   fast     (every cell qualifies): the halo staged as one word a cell, the
//            elevation where the validity is 1 and NaN elsewhere (and outside
//            the plane), at a fixed row pitch, and a 64-bit validity mask a
//            halo row.  A pair adds (double)fmax(d * d, 0) with d = e0 - p:
//            d * d where d is a number, +0 where either end is NaN.  The
//            counts are popcounts of the masks, a tile row and an offset at a
//            time, summed in a 32-bit integer a thread and converted once at
//            the bin's end.
// Why the fast path gives the general path's bits.  With v in {0, 1} and e
// bounded so, both is 1 or a zero; where it is 1, (e0 - p) * 1 is e0 - p
// exactly and d * d the same f32 (f64) value, added to s in the same order.
// Where it is a zero, (e0 - p) * both is +-0 (e0 - p is finite: no inf * 0),
// d * d is +0, and the general path adds +0.0 to s, as the fast path does.
// So each thread's s is the general path's, bit for bit.  The general path's
// c is a sum of 1.0s and zeros; every partial sum of the block's counts, in
// block_sum2's order, is an integer far below 2**53 (at most 1,024 x 158 at
// max_lag 10), so the block's total is the exact count of its pairs with
// both ends valid however the counting is split among its threads, and the
// fast path's popcounts give that count.  block_sum2 and the finish kernel
// then add the same values in the same order: the output is bit-equal
// whichever path each block took.  A validity of 0.5, an inf under an
// invalid cell (inf * 0 is NaN), or two huge elevations whose difference
// overflows, breaks the identity, and such a block takes the general path.
//
// What bounds B9 on the H100.  At the Kerguelen stand-in's 5.01 M cells x 158
// offsets (792 M pairs) the f32 and f64 pipes' operations take ~0.05 ms and
// the two 20 MB planes' read 0.012 ms.  The general path does per pair two
// f32 -> f64 conversions (16 a clock an SM: ~0.4 ms), two f64 adds and an
// 8-byte shared load.  The fast path does six instructions a pair (a 4-byte
// shared load at an immediate offset, a subtract, a square, the fmax, one
// conversion, one f64 add); a predicated add would not do: the compiler
// makes it an add and two 32-bit selects, and the count an add and a move.
// Its floor is the conversions, 792 M / (16 x 132 SMs), ~0.19 ms at 1.98
// GHz, with the instruction rate close behind.
//
// B10 is fit_model's loop (auvtpu_torch/variogram.py) in one launch of one
// warp, all in float64: the data-driven start (or the given one), log
// parameters, count weights, residuals times sqrt(w), the Jacobian taken
// analytically per model (the clamp p2 >= 1e-6 of variogram_model gives a
// zero derivative where it binds, as autograd's clamp does), A = J^T J,
// damp = 1e-4 max(trace(A) / 3, 1e-12), a 3x3 LU solve with partial
// pivoting, the +-2 clip, the keep test on the two weighted SSEs and the
// freeze after the first kept step that moves gamma by less than ``stop``
// at the bins with pairs.  A lane takes bins lane, lane + 32, ...; the sums
// are warp butterflies (every lane holds the same bits), so every lane takes
// the same decisions.  It is latency-bound serial work (~100 f64 operations
// a bin a step, a chain of divisions, exps and shuffles): its bound is far
// under a microsecond; the gain is the host loop it replaces.
//
// What B10 spares of that latency, with the plain loop's bits kept.
//   It stops at the first step that is not kept or that freezes.  A step
//   not kept leaves theta as it was, and the damping is fixed, so the next
//   step computes the same candidate, bit for bit, and rejects it again; a
//   frozen walk keeps nothing.  From there on (theta, frozen) cannot change,
//   and a tail writes the remaining steps' flags as (0, frozen).
//   It evaluates the curve once a bin a step.  A bin's shape terms at the
//   current parameters (u = h / p2 and the exp term) are kept in shared
//   memory: the Jacobian pass reads them (no division, no exp) and keeps
//   the curve's value, ``now``, for the candidate pass; the candidate pass
//   computes the candidate's shape terms, which become the current ones
//   when the step is kept (p = q: exp of the same log parameters).  Every
//   value is the same operation on the same inputs as before, and no float64
//   sum changes order.
//
// B10 takes its gamma and counts in one of two forms (the template's kIn).
//   kArrays  (n,) arrays, f32 or f64 by their flags, as a caller hands them.
//   kBinned  B9's float64 (sums, counts), from which the kernel forms them as
//            empirical_variogram's torch ops do, in T (float or double, the
//            lags' dtype): s and c rounded to T, gamma = s / (2 max(c, 1))
//            where c > 0 and 0 elsewhere, an IEEE division (nvcc's default
//            -prec-div=true; 2 max(c, 1) is exact), then both widened to
//            double.  A bin's count passes 2**24 on a large grid, so the
//            rounding of c to float is kept, not skipped.  The fit-then-fill
//            launches B9 and then this form, with nothing between them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// ---------------------------------------------------------------------------
// B9: binned pair sums
// ---------------------------------------------------------------------------

constexpr int kTW = 32;          // tile columns: a warp's lanes
constexpr int kTY = 8;           // warps a block
constexpr int kCPT = 4;          // base rows a thread
constexpr int kTH = kTY * kCPT;  // tile rows
constexpr int kThreads = kTW * kTY;
constexpr int kMaxLag = 16;
constexpr int kMaxOut = 1024;
constexpr int kPitch = kTW + 2 * kMaxLag;  // the fast path's halo row pitch, whatever R
constexpr int kGroup = 32;                  // bins the fast path sums between two barriers
constexpr int kStage = (kTH + kMaxLag) * kPitch / kThreads;  // halo cells a thread stages
static_assert(kThreads % kPitch == 0 && (kTH + kMaxLag) * kPitch % kThreads == 0, "the halo's index space");

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// The fast path's halo words, (kTH + R) rows at pitch kPitch; its row masks
// follow.
__host__ __device__ constexpr size_t fast_tile_bytes(int R, size_t elem_bytes) {
  return align16((size_t)(kTH + R) * kPitch * elem_bytes);
}

// Sums (s, c) over the block's kThreads threads in a fixed order; thread 0
// holds the result.  Every thread of the block calls it.
__device__ __forceinline__ void block_sum2(double& s, double& c, double* red) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, m);
    c += __shfl_down_sync(0xffffffffu, c, m);
  }
  if (lane == 0) {
    red[warp] = s;
    red[kTY + warp] = c;
  }
  __syncthreads();
  if (tid == 0) {
    double S = 0.0, C = 0.0;
#pragma unroll
    for (int w = 0; w < kTY; ++w) {
      S += red[w];
      C += red[kTY + w];
    }
    s = S;
    c = C;
  }
  __syncthreads();
}

// The largest elevation magnitude the fast path takes: no difference of two
// such values overflows.
template <typename T>
__device__ __forceinline__ T fast_limit();
template <>
__device__ __forceinline__ float fast_limit<float>() {
  return 8.50705917e37f;  // 2**126
}
template <>
__device__ __forceinline__ double fast_limit<double>() {
  return 4.49423283715578977e307;  // 2**1022
}

// The general path: the halo as (elevation, validity) pairs, the formula of
// the header pair for pair.
template <typename T>
__device__ __forceinline__ void sums_general(const typename Vec2<T>::type* tile, int tw, int R, bool col_in, int r0,
                                             int H, const int2* offs, const int* starts, int n_out, double* red,
                                             double* partials, size_t cta, int tid) {
  using V = typename Vec2<T>::type;
  T e0[kCPT], v0[kCPT];
  bool in[kCPT];
#pragma unroll
  for (int q = 0; q < kCPT; ++q) {
    const int tr = threadIdx.y + q * kTY;
    in[q] = col_in && r0 + tr < H;
    const V p = tile[tr * tw + threadIdx.x + R];
    e0[q] = p.x;
    v0[q] = p.y;
  }
  const V* base = tile + threadIdx.y * tw + threadIdx.x + R;
  for (int b = 0; b < n_out; ++b) {
    double s = 0.0, c = 0.0;
    const int k1 = starts[b + 1];
    for (int k = starts[b]; k < k1; ++k) {
      const int2 o = offs[k];  // (dy, dx)
      const V* row = base + o.x * tw + o.y;
#pragma unroll
      for (int q = 0; q < kCPT; ++q) {
        if (in[q]) {
          const V p = row[q * kTY * tw];
          const T both = v0[q] * p.y;
          const T d = (e0[q] - p.x) * both;
          const T dd = d * d;
          s += (double)dd;
          c += (double)both;
        }
      }
    }
    block_sum2(s, c, red);
    if (tid == 0) {
      partials[(cta * n_out + b) * 2] = s;
      partials[(cta * n_out + b) * 2 + 1] = c;
    }
  }
}

// The fast path: the halo NaN-coded, one word a cell at row pitch kPitch, so
// a thread's four rows sit at immediate offsets.  A base cell outside the
// block's rows or columns reads NaN too.  A pair adds (double)fmax(d * d, 0):
// d * d where d = e0 - p is a number (d * d >= +0), +0 where it is NaN (fmax
// returns the number), so no select and no branch.  The counts come from
// ``rowmask``, one 64-bit validity mask a halo row (bit c: column c is not
// NaN): for an offset (dy, dx) and a tile row r, the pairs that count are
// popc(base(r) & (rowmask[r + dy] >> (R + dx))) over the 32 base columns;
// thread (x, y) takes row x for the bin's offsets y, y + 8, ...  The block's
// sums are block_sum2's, in its order, for kGroup bins at a time: each warp
// sums a bin down its lanes as block_sum2 does and keeps the result in
// ``gs``; after one barrier, thread t adds bin t's warp sums in warp order,
// as block_sum2's thread 0 does.  The counts are integers, exact in any
// order.
template <typename T>
__device__ __forceinline__ void sums_fast(const T* tile, const unsigned long long* rowmask, int R, bool col_in,
                                          unsigned base_bits, int r0, int H, const int2* offs, const int* flat,
                                          const int* starts, int n_out, double* gs, int* gn, double* partials,
                                          size_t cta, int tid) {
  T e0[kCPT];
#pragma unroll
  for (int q = 0; q < kCPT; ++q) {
    const int tr = threadIdx.y + q * kTY;
    e0[q] = (col_in && r0 + tr < H) ? tile[tr * kPitch + threadIdx.x + R] : static_cast<T>(NAN);
  }
  const T* base = tile + threadIdx.y * kPitch + threadIdx.x + R;
  for (int g0 = 0; g0 < n_out; g0 += kGroup) {
    const int ng = n_out - g0 < kGroup ? n_out - g0 : kGroup;
    for (int b = g0; b < g0 + ng; ++b) {
      double s = 0.0;
      const int k0 = starts[b], k1 = starts[b + 1];
      for (int k = k0; k < k1; ++k) {
        const T* row = base + flat[k];  // dy * kPitch + dx
#pragma unroll
        for (int q = 0; q < kCPT; ++q) {
          const T d = e0[q] - row[q * kTY * kPitch];
          s += (double)fmax(d * d, T(0));
        }
      }
      int n = 0;
      for (int k = k0 + threadIdx.y; k < k1; k += kTY) {
        const int2 o = offs[k];
        n += __popc(base_bits & (unsigned)(rowmask[threadIdx.x + o.x] >> (R + o.y)));
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) s += __shfl_down_sync(0xffffffffu, s, m);
      n = __reduce_add_sync(0xffffffffu, n);
      if (threadIdx.x == 0) {
        gs[(b - g0) * kTY + threadIdx.y] = s;
        gn[(b - g0) * kTY + threadIdx.y] = n;
      }
    }
    __syncthreads();
    if (tid < ng) {
      double S = 0.0;
      int N = 0;
#pragma unroll
      for (int w = 0; w < kTY; ++w) {
        S += gs[tid * kTY + w];
        N += gn[tid * kTY + w];
      }
      partials[(cta * n_out + g0 + tid) * 2] = S;
      partials[(cta * n_out + g0 + tid) * 2 + 1] = (double)N;
    }
    __syncthreads();
  }
}

// tab: n_off (dy, dx) int pairs grouped by bin, then n_out + 1 bin starts.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pair_sums_tile_kernel(const T* __restrict__ elev, int pe, const T* __restrict__ valid, int pv, int Hs, int Ws,
                          int H, int Wb, int c0, int R, const int* __restrict__ tab, int n_off, int n_out,
                          double* __restrict__ partials) {
  using V = typename Vec2<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  int2* offs = reinterpret_cast<int2*>(smem);
  int* starts = reinterpret_cast<int*>(smem + align16(sizeof(int2) * n_off));
  int* flat = reinterpret_cast<int*>(smem + align16(sizeof(int2) * n_off) + align16(sizeof(int) * (n_out + 1)));
  double* red = reinterpret_cast<double*>(reinterpret_cast<unsigned char*>(flat) + align16(sizeof(int) * n_off));
  double* gs = red + 2 * kTY;
  int* gn = reinterpret_cast<int*>(gs + kGroup * kTY);
  unsigned char* halo = reinterpret_cast<unsigned char*>(gn + kGroup * kTY);

  const int tid = threadIdx.y * kTW + threadIdx.x;
  const int2* toffs = reinterpret_cast<const int2*>(tab);
  for (int i = tid; i < n_off; i += kThreads) {
    const int2 o = toffs[i];
    offs[i] = o;
    flat[i] = o.x * kPitch + o.y;
  }
  for (int i = tid; i <= n_out; i += kThreads) starts[i] = tab[2 * n_off + i];

  // the partner halo: source rows r0 .. r0 + kTH + R - 1, columns
  // c0 + bc0 - R .. c0 + bc0 + kTW + R - 1; (0, 0) outside the plane.  A
  // thread takes the cells (tr, tc) = (j / kPitch, j % kPitch) of the
  // (kTH + kMaxLag) x kPitch index space, j = tid + k kThreads, that lie in
  // the (kTH + R) x (kTW + 2R) halo, and holds them in registers until the
  // vote says how to stage them.
  const int r0 = blockIdx.y * kTH;
  const int bc0 = blockIdx.x * kTW;
  const int th = kTH + R, tw = kTW + 2 * R;
  T he[kStage], hv[kStage];
  bool general = false;
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int tr = (tid + k * kThreads) / kPitch, tc = tid % kPitch;  // kThreads is a multiple of kPitch
    const int gr = r0 + tr, gc = c0 + bc0 - R + tc;
    T e = T(0), v = T(0);
    if (tr < th && tc < tw && gr < Hs && gc >= 0 && gc < Ws) {
      e = __ldg(elev + (size_t)gr * pe + gc);
      v = __ldg(valid + (size_t)gr * pv + gc);
    }
    he[k] = e;
    hv[k] = v;
    general |= !((v == T(0) || v == T(1)) && fabs(e) <= fast_limit<T>());
  }
  const bool col_in = bc0 + (int)threadIdx.x < Wb;
  const size_t cta = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  if (__syncthreads_or(general)) {
    V* tile = reinterpret_cast<V*>(halo);
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int tr = (tid + k * kThreads) / kPitch, tc = tid % kPitch;
      if (tr < th && tc < tw) {
        V p;
        p.x = he[k];
        p.y = hv[k];
        tile[tr * tw + tc] = p;
      }
    }
    __syncthreads();
    sums_general<T>(tile, tw, R, col_in, r0, H, offs, starts, n_out, red, partials, cta, tid);
  } else {
    T* tile = reinterpret_cast<T*>(halo);
    unsigned long long* rowmask = reinterpret_cast<unsigned long long*>(halo + fast_tile_bytes(R, sizeof(T)));
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int tr = (tid + k * kThreads) / kPitch, tc = tid % kPitch;
      if (tr < th && tc < tw) tile[tr * kPitch + tc] = hv[k] == T(1) ? he[k] : static_cast<T>(NAN);
    }
    __syncthreads();
    // warp y builds the masks of halo rows y, y + 8, ... (columns >= tw,
    // never read, cleared)
    const unsigned long long cols = tw >= 64 ? ~0ull : (1ull << tw) - 1;
    for (int r = threadIdx.y; r < th; r += kTY) {
      const T lo = tile[r * kPitch + threadIdx.x], hi = tile[r * kPitch + 32 + threadIdx.x];
      const unsigned long long m = __ballot_sync(0xffffffffu, lo == lo) |
                                   ((unsigned long long)__ballot_sync(0xffffffffu, hi == hi) << 32);
      if (threadIdx.x == 0) rowmask[r] = m & cols;
    }
    __syncthreads();
    // the base cells of the row this thread counts: its tile row x's 32
    // columns, those inside the block
    const int nc = Wb - bc0;
    const unsigned in_cols = nc >= 32 ? 0xffffffffu : (1u << nc) - 1;
    const unsigned base_bits =
        r0 + (int)threadIdx.x < H ? (unsigned)(rowmask[threadIdx.x] >> R) & in_cols : 0u;
    sums_fast<T>(tile, rowmask, R, col_in, base_bits, r0, H, offs, flat, starts, n_out, gs, gn, partials, cta, tid);
  }
}

// Block b sums bin b's partials over the n_cta tile blocks in a fixed order:
// out[b] = s, out[n_out + b] = c.
__global__ void __launch_bounds__(kThreads)
    pair_sums_finish_kernel(const double* __restrict__ partials, int n_cta, int n_out, double* __restrict__ out) {
  __shared__ double red[2 * kTY];
  const int b = blockIdx.x;
  double s = 0.0, c = 0.0;
  for (int k = threadIdx.y * kTW + threadIdx.x; k < n_cta; k += kThreads) {
    s += partials[((size_t)k * n_out + b) * 2];
    c += partials[((size_t)k * n_out + b) * 2 + 1];
  }
  block_sum2(s, c, red);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    out[b] = s;
    out[n_out + b] = c;
  }
}

// The shared memory of a tile block: the table (pairs, bin starts, flat
// offsets), the reductions' scratch, and the halo as the general path's
// pairs or the fast path's words and row masks, whichever is larger.
size_t pair_sums_smem(int n_off, int n_out, int R, size_t elem_bytes) {
  const size_t general = (size_t)(kTH + R) * (kTW + 2 * R) * 2 * elem_bytes;
  const size_t fast = fast_tile_bytes(R, elem_bytes) + (kTH + R) * sizeof(unsigned long long);
  return align16(sizeof(int2) * n_off) + align16(sizeof(int) * (n_out + 1)) + align16(sizeof(int) * n_off) +
         2 * kTY * sizeof(double) + kGroup * kTY * (sizeof(double) + sizeof(int)) + (general > fast ? general : fast);
}

template <typename T>
int launch_pair_sums(const T* e, int pe, const T* v, int pv, int Hs, int Ws, int H, int Wb, int c0, int R,
                     const int* tab, int n_off, int n_out, double* partials, double* out, cudaStream_t st) {
  const dim3 grid((unsigned)((Wb + kTW - 1) / kTW), (unsigned)((H + kTH - 1) / kTH));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int n_cta = (H > 0 && Wb > 0) ? (int)(grid.x * grid.y) : 0;
  if (n_cta > 0) {
    const size_t smem = pair_sums_smem(n_off, n_out, R, sizeof(T));
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(pair_sums_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    pair_sums_tile_kernel<T><<<grid, dim3(kTW, kTY), smem, st>>>(e, pe, v, pv, Hs, Ws, H, Wb, c0, R, tab, n_off,
                                                                 n_out, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pair_sums_finish_kernel<<<n_out, dim3(kTW, kTY), 0, st>>>(partials, n_cta, n_out, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B10: the Gauss-Newton variogram fit
// ---------------------------------------------------------------------------

constexpr int kFitMaxBins = 512;
enum Model { kExponential = 0, kLinear = 1, kSpherical = 2, kGaussian = 3 };

__device__ __forceinline__ double load_as_f64(const void* p, int f64, int i) {
  return f64 ? static_cast<const double*>(p)[i] : (double)static_cast<const float*>(p)[i];
}

// torch.max / torch.clamp semantics: a NaN wins (clamp_min passes it on)
__device__ __forceinline__ double nan_max(double a, double b) { return (isnan(a) || isnan(b)) ? NAN : fmax(a, b); }
__device__ __forceinline__ double clamp_min(double x, double lo) { return x < lo ? lo : x; }
__device__ __forceinline__ double clamp_pm(double x, double lim) { return x < -lim ? -lim : (x > lim ? lim : x); }

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ double warp_nan_max(double x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

// A bin's shape terms for the parameter p2r: u = h / p2 (p2 = p2r clamped
// at 1e-6) and the exp term E of the exponential (e^-u) and the gaussian
// (e^-(u^2)); the linear model has none.
__device__ __forceinline__ void shape(int model, double h, double p2r, double& u, double& E) {
  if (model == kLinear) {
    u = 0.0;
    E = 0.0;
    return;
  }
  const double p2 = p2r < 1e-6 ? 1e-6 : p2r;
  u = h / p2;
  E = model == kExponential ? exp(-u) : (model == kGaussian ? exp(-(u * u)) : 0.0);
}

// variogram_model(h, (p0, p1, p2), model) from the bin's shape terms (u, E)
// and, where ``jac``, its derivatives in the log parameters: dc[k] = d curve
// / d log p_k; ``live``: p2 >= 1e-6 (the clamp passes the derivative where
// it does not bind).
template <bool kJac>
__device__ __forceinline__ double curve(int model, double h, double u, double E, double p0, double p1, bool live,
                                        double* dc) {
  if (kJac) dc[0] = p0;
  if (model == kLinear) {
    if (kJac) {
      dc[1] = p1 * h;
      dc[2] = 0.0;
    }
    return p0 + p1 * h;
  }
  if (model == kSpherical) {
    const double m = u > 1.0 ? 1.0 : u;
    const double f = 1.5 * m - 0.5 * (m * m * m);
    if (kJac) {
      dc[1] = p1 * f;
      dc[2] = (live && u <= 1.0) ? -(p1 * ((1.5 - 1.5 * (m * m)) * m)) : 0.0;
    }
    return p0 + p1 * f;
  }
  // exponential, gaussian
  const double f = 1.0 - E;
  if (kJac) {
    dc[1] = p1 * f;
    dc[2] = live ? -(p1 * (model == kGaussian ? E * (2.0 * (u * u)) : E * u)) : 0.0;
  }
  return p0 + p1 * f;
}

// Solves a x = b (3x3) by LU with partial pivoting (the first largest pivot).
__device__ __forceinline__ void solve3(double a[3][3], double b[3], double x[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int p = k;
#pragma unroll
    for (int i = k + 1; i < 3; ++i)
      if (fabs(a[i][k]) > fabs(a[p][k])) p = i;
    if (p != k) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const double t = a[k][j];
        a[k][j] = a[p][j];
        a[p][j] = t;
      }
      const double t = b[k];
      b[k] = b[p];
      b[p] = t;
    }
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      const double l = a[i][k] / a[k][k];
#pragma unroll
      for (int j = k + 1; j < 3; ++j) a[i][j] = a[i][j] - l * a[k][j];
      b[i] = b[i] - l * b[k];
    }
  }
  x[2] = b[2] / a[2][2];
  x[1] = (b[1] - a[1][2] * x[2]) / a[1][1];
  x[0] = (b[0] - a[0][1] * x[1] - a[0][2] * x[2]) / a[0][0];
}

enum Input { kArrays = 0, kBinnedF32 = 1, kBinnedF64 = 2 };

// A bin's gamma and count as empirical_variogram forms them from B9's
// float64 sum and count, in T, widened to double.
template <typename T>
__device__ __forceinline__ void semivariance(double s64, double c64, double& g, double& c) {
  const T s = (T)s64, n = (T)c64;
  const T lo = n < (T)1 ? (T)1 : n;  // torch.clamp(c, min=1): a NaN passes
  g = n > (T)0 ? (double)(s / ((T)2 * lo)) : 0.0;
  c = (double)n;
}

// lags: (n,) f32 or f64 (lags_f64); gamma, counts: (n,) f32 or f64 (their
// flags) for kArrays, B9's (n,) f64 sums and counts for kBinned*; init:
// three f64 on the device, or null for the data-driven start; out: (3,)
// (nugget, p1, p2) in f32 or f64 (out_f64); flags: (iters, 2) int8 (kept,
// frozen after the step), or null; formed: for kBinned*, null or (2, n)
// in T, the gamma and counts the kernel formed.
template <int kIn>
__global__ void __launch_bounds__(32)
    fit_model_kernel(const void* lags, int lags_f64, const void* gamma, int gamma_f64, const void* counts,
                     int counts_f64, int n, const double* init, int model, int iters, double stop, void* out,
                     int out_f64, signed char* flags, void* formed) {
  __shared__ double sh_h[kFitMaxBins], sh_g[kFitMaxBins], sh_c[kFitMaxBins], sh_sw[kFitMaxBins];
  // per bin: the curve's value at the current parameters, and the shape
  // terms (u, E) at the current ([cur]) and the candidate ([cur ^ 1]) ones
  __shared__ double sh_now[kFitMaxBins], sh_u[2][kFitMaxBins], sh_e[2][kFitMaxBins];
  const int lane = threadIdx.x;
  double csum = 0.0, gmax = -INFINITY, hmax = -INFINITY;
  for (int i = lane; i < n; i += 32) {
    const double h = load_as_f64(lags, lags_f64, i);
    double g, c;
    if (kIn == kArrays) {
      g = load_as_f64(gamma, gamma_f64, i);
      c = load_as_f64(counts, counts_f64, i);
    } else {
      const double s64 = static_cast<const double*>(gamma)[i], c64 = static_cast<const double*>(counts)[i];
      if (kIn == kBinnedF32)
        semivariance<float>(s64, c64, g, c);
      else
        semivariance<double>(s64, c64, g, c);
      if (formed != nullptr) {
        if (kIn == kBinnedF32) {
          static_cast<float*>(formed)[i] = (float)g;
          static_cast<float*>(formed)[n + i] = (float)c;
        } else {
          static_cast<double*>(formed)[i] = g;
          static_cast<double*>(formed)[n + i] = c;
        }
      }
    }
    sh_h[i] = h;
    sh_g[i] = g;
    sh_c[i] = c;
    csum += c;
    gmax = nan_max(gmax, g);
    hmax = nan_max(hmax, h);
  }
  csum = warp_sum(csum);
  gmax = warp_nan_max(gmax);
  hmax = warp_nan_max(hmax);
  const double tot = clamp_min(csum, 1.0);
  for (int i = lane; i < n; i += 32) sh_sw[i] = sqrt(sh_c[i] / tot);
  __syncwarp();

  double th[3];
  if (init != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k) th[k] = log(init[k]);
  } else {
    const double sill0 = clamp_min(gmax, 1e-3);
    const double maxlag = clamp_min(hmax, 1e-9);
    th[0] = log(0.01 * sill0);
    th[1] = log(model == kLinear ? sill0 / maxlag : sill0);
    th[2] = log(maxlag / 3.0);
  }
  double p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = exp(th[k]);
  int cur = 0;
  for (int i = lane; i < n; i += 32) shape(model, sh_h[i], p[2], sh_u[cur][i], sh_e[cur][i]);

  // a lane reads and writes only its own bins' entries, so no barrier is
  // needed between the passes
  bool frozen = false;
  int done = 0;
  while (done < iters) {
    // the normal equations: A (6), g (3) and the SSE, lane-strided bins
    const bool live = p[2] >= 1e-6;
    double acc[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = lane; i < n; i += 32) {
      double dc[3];
      const double sw = sh_sw[i];
      const double now = curve<true>(model, sh_h[i], sh_u[cur][i], sh_e[cur][i], p[0], p[1], live, dc);
      sh_now[i] = now;
      const double r = (now - sh_g[i]) * sw;
      const double j0 = dc[0] * sw, j1 = dc[1] * sw, j2 = dc[2] * sw;
      acc[0] += j0 * j0;
      acc[1] += j0 * j1;
      acc[2] += j0 * j2;
      acc[3] += j1 * j1;
      acc[4] += j1 * j2;
      acc[5] += j2 * j2;
      acc[6] += j0 * r;
      acc[7] += j1 * r;
      acc[8] += j2 * r;
      acc[9] += r * r;
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) acc[k] = warp_sum(acc[k]);
    const double tr3 = (acc[0] + acc[3] + acc[5]) / 3.0;
    const double damp = 1e-4 * clamp_min(tr3, 1e-12);
    double a[3][3] = {{acc[0] + damp, acc[1], acc[2]}, {acc[1], acc[3] + damp, acc[4]}, {acc[2], acc[4], acc[5] + damp}};
    double g[3] = {acc[6], acc[7], acc[8]};
    double delta[3];
    solve3(a, g, delta);
    double nw[3], q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      nw[k] = th[k] - clamp_pm(delta[k], 2.0);
      q[k] = exp(nw[k]);
    }
    // the candidate: its weighted SSE and how far it moves gamma where
    // there are pairs
    const bool qlive = q[2] >= 1e-6;
    const int nx = cur ^ 1;
    double ssn = 0.0, moved = 0.0;
    for (int i = lane; i < n; i += 32) {
      shape(model, sh_h[i], q[2], sh_u[nx][i], sh_e[nx][i]);
      const double now = sh_now[i];
      const double nxt = curve<false>(model, sh_h[i], sh_u[nx][i], sh_e[nx][i], q[0], q[1], qlive, nullptr);
      const double rn = (nxt - sh_g[i]) * sh_sw[i];
      ssn += rn * rn;
      if (sh_c[i] > 0.0) moved = nan_max(moved, fabs(nxt - now) / fabs(now));
    }
    ssn = warp_sum(ssn);
    moved = warp_nan_max(moved);
    // frozen is false here: the loop ends at the step that freezes
    const bool keep = ssn <= acc[9];
    frozen = keep && moved < stop;
    if (flags != nullptr && lane == 0) {
      flags[2 * done] = keep ? 1 : 0;
      flags[2 * done + 1] = frozen ? 1 : 0;
    }
    ++done;
    if (keep) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        th[k] = nw[k];
        p[k] = q[k];
      }
      cur = nx;
    }
    if (!keep || frozen) break;
  }
  // the steps after the last one run: (theta, frozen) as they are
  if (flags != nullptr) {
    for (int j = done + lane; j < iters; j += 32) {
      flags[2 * j] = 0;
      flags[2 * j + 1] = frozen ? 1 : 0;
    }
  }
  if (lane < 3) {
    const double v = exp(th[lane]);
    if (out_f64)
      static_cast<double*>(out)[lane] = v;
    else
      static_cast<float*>(out)[lane] = (float)v;
  }
}

}  // namespace

extern "C" {

// B9.  elev, valid: (Hs, Ws) planes of one dtype (f64 != 0: double, else
// float) with unit column stride and row pitches pe, pv (elements); base
// cells (i, j) for i < H, j < Wb at the plane's (i, c0 + j), H <= Hs,
// c0 + Wb <= Ws; 0 <= R <= 16 with every |dy|, |dx| <= R, dy >= 0; tab: as
// pair_sums_tile_kernel's, on the device; 1 <= n_out <= 1024; partials:
// (ceil(H/32) * ceil(Wb/32), n_out, 2) f64 scratch; out: (2, n_out) f64
// (sums, counts).  Two kernel launches, nothing else on the stream.
int auvtpu_pair_sums(const void* elev, int pe, const void* valid, int pv, int f64, int Hs, int Ws, int H, int Wb,
                     int c0, int R, const void* tab, int n_off, int n_out, void* partials, void* out,
                     void* stream) {
  if (R < 0 || R > kMaxLag || n_out < 1 || n_out > kMaxOut || n_off < 0 || H < 0 || Wb < 0 || H > Hs || c0 < 0 ||
      c0 + Wb > Ws)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* t = (const int*)tab;
  double* p = (double*)partials;
  double* o = (double*)out;
  if (f64)
    return launch_pair_sums<double>((const double*)elev, pe, (const double*)valid, pv, Hs, Ws, H, Wb, c0, R, t,
                                    n_off, n_out, p, o, st);
  return launch_pair_sums<float>((const float*)elev, pe, (const float*)valid, pv, Hs, Ws, H, Wb, c0, R, t, n_off,
                                 n_out, p, o, st);
}

// B10.  See fit_model_kernel; 1 <= n <= 512, model 0..3 (exponential,
// linear, spherical, gaussian), iters >= 0.  One kernel launch.
int auvtpu_fit_model(const void* lags, int lags_f64, const void* gamma, int gamma_f64, const void* counts,
                     int counts_f64, int n, const void* init, int model, int iters, double stop, void* out,
                     int out_f64, void* flags, void* stream) {
  if (n < 1 || n > kFitMaxBins || model < 0 || model > 3 || iters < 0) return (int)cudaErrorInvalidValue;
  fit_model_kernel<kArrays><<<1, 32, 0, (cudaStream_t)stream>>>(lags, lags_f64, gamma, gamma_f64, counts,
                                                               counts_f64, n, (const double*)init, model, iters,
                                                               stop, out, out_f64, (signed char*)flags, nullptr);
  return (int)cudaGetLastError();
}

// B10 on B9's output.  sums, counts: (n,) f64; lags, out and formed (null
// or (2, n)) in one dtype, f64 where f64 != 0, else f32; the rest as
// auvtpu_fit_model's.  One kernel launch.
int auvtpu_fit_binned(const void* lags, const void* sums, const void* counts, int f64, int n, const void* init,
                      int model, int iters, double stop, void* out, void* flags, void* formed, void* stream) {
  if (n < 1 || n > kFitMaxBins || model < 0 || model > 3 || iters < 0) return (int)cudaErrorInvalidValue;
  if (f64)
    fit_model_kernel<kBinnedF64><<<1, 32, 0, (cudaStream_t)stream>>>(lags, 1, sums, 1, counts, 1, n,
                                                                    (const double*)init, model, iters, stop, out,
                                                                    1, (signed char*)flags, formed);
  else
    fit_model_kernel<kBinnedF32><<<1, 32, 0, (cudaStream_t)stream>>>(lags, 0, sums, 1, counts, 1, n,
                                                                    (const double*)init, model, iters, stop, out,
                                                                    0, (signed char*)flags, formed);
  return (int)cudaGetLastError();
}

const char* auvtpu_variogram_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
