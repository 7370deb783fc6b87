// NFA rectangle rasterize + count for Hopper (sm_90a): for each
// rectangle of a batch, the two exact counts (all_pix, ali_pix) of the
// level-line field pixels it covers and of those aligned with it.
//
// Replaces the TPU kernel lsdtpu/ops/nfa_pallas.py:87 _kernel (per-pixel
// math rect_counts_math, :53).  Reference semantics:
// RectangleNFACalculator, LSD/myLSD.cpp:926-1016.  With the packed
// scalars [x_start, x_len, vx0..3, vy0..3, k0..3, deg, prec] of one
// rectangle (mapprep/nfa.py pack_rect_scalars), a pixel (row y, col x)
// is inside when
//   x >= x_start and x <= (x_start + x_len) - 1
//   y >= y_low(x)  = c_int(ceil,  x < vx3 ? vy0 + (x - vx0)*k3
//                                          : vy3 + (x - vx3)*k2)
//   y <= y_high(x) = c_int(floor, x < vx1 ? vy0 + (x - vx0)*k0
//                                          : vy1 + (x - vx1)*k1)
// where c_int maps NaN, +-inf and values outside [-2^31, 2^31) to
// INT_MIN (the x86 cvttsd2si the reference inherits), and it is aligned
// when |deg - deg_map|, folded by 2*pi above 1.5*pi, is below prec.
//
// Bound.  Each call reads the covered pixels once and 16 scalars per
// rectangle and writes two counts: at the recorded map preps (293x432
// field, R <= 5, at most ~855 covered pixels) that is a few KB, about a
// nanosecond at 3.35 TB/s, and ~6 operations per covered pixel; any
// launch costs ~2 us, so the launch floor is the target.
//
// What held the first design (one block per rectangle, threads striding
// over all W columns, each walking its column's rows) back, and what
// this design does about it: with R <= 5 blocks, a rectangle's time was
// the walk down its tallest column by one thread (a near-vertical line
// of hundreds of rows), while the threads of empty columns idled.  Now
// the block shares a rectangle's pixels evenly:
//   * column pass: thread c evaluates column c's predicate and its
//     [y_low, y_high] bounds with the same float expressions as before
//     (every multiply and add an explicit round-to-nearest intrinsic, the
//     build is -fmad=false too), so NaN, inf and out-of-range inputs keep
//     their results; the clipped height max(0, hi - lo + 1) goes to
//     shared memory;
//   * a block-wide inclusive scan of the heights (warp shuffles, then
//     the warp totals), looping over tiles of kThreads columns when W is
//     wider than the block; all_pix is the sum of the heights;
//   * pixel pass: threads stride over the flat covered index t in
//     [0, total); a binary search over the scanned ends in shared memory
//     (narrowed to the columns between ceil(x_start) and floor(x_end))
//     finds the column, and the row is the column's first row plus the
//     offset, so every thread has ~total / kThreads independent loads
//     whatever the rectangle's shape, two of them in flight at a time;
//   * ali_pix is reduced exactly (warp shuffles, then shared memory; no
//     atomics), so the counts repeat from run to run.
// A rectangle is not split over several blocks: at <= 855 covered pixels
// a block of 512 threads loads each in at most two rounds, and a second
// block would add a cross-block ticket (a fence and an atomic round trip,
// about a microsecond) to save less.  The launches stay one per improver
// phase (R <= 5): the phases depend on each other through the host's
// `better` chain (mapprep/nfa.py).  1.5*pi and 2*pi are rounded once to
// the working type, as the reference package's weakly typed constants
// are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kScalars = 16;
constexpr double kPi = 3.14159265358979323846;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T c_int(T r, T v) {
  // r is ceil(v) or floor(v); NaN and +-inf fail both compares
  const T lo = T(-2147483648.0), hi = T(2147483648.0);
  return (v >= lo && v < hi) ? r : lo;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Inclusive scan of v over the block (sh_warp: kWarps ints).
__device__ __forceinline__ int block_scan(int v, int* sh_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) sh_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? sh_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += u;
    }
    if (lane < kWarps) sh_warp[lane] = t;
  }
  __syncthreads();
  return warp ? v + sh_warp[warp - 1] : v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rect_counts_kernel(const T* __restrict__ deg_map, int H, int W,
                   const T* __restrict__ scalars,
                   int32_t* __restrict__ all_out,
                   int32_t* __restrict__ ali_out) {
  __shared__ int sh_base[kThreads];  // column's first row minus its offset
  __shared__ int sh_end[kThreads];   // inclusive scan of the heights
  __shared__ int sh_warp[kWarps];
  const T* s = scalars + static_cast<int64_t>(blockIdx.x) * kScalars;
  const T x_start = s[0], x_len = s[1];
  const T vx0 = s[2], vx1 = s[3], vx3 = s[5];
  const T vy0 = s[6], vy1 = s[7], vy3 = s[9];
  const T k0 = s[10], k1 = s[11], k2 = s[12], k3 = s[13];
  const T deg = s[14], prec = s[15];
  const T x_end = sub_rn(add_rn(x_start, x_len), T(1));
  const T fold = T(kPi * 1.5), two_pi = T(2 * kPi);

  int n_all = 0, n_ali = 0;
  for (int c0 = 0; c0 < W; c0 += kThreads) {
    // column pass: the clipped row range of column c
    const int c = c0 + threadIdx.x;
    int lo_i = 0, h = 0;
    if (c < W) {
      const T xx = T(c);
      if (xx >= x_start && xx <= x_end) {
        const T lo_v = xx < vx3 ? add_rn(vy0, mul_rn(sub_rn(xx, vx0), k3))
                                : add_rn(vy3, mul_rn(sub_rn(xx, vx3), k2));
        const T hi_v = xx < vx1 ? add_rn(vy0, mul_rn(sub_rn(xx, vx0), k0))
                                : add_rn(vy1, mul_rn(sub_rn(xx, vx1), k1));
        // y_low/y_high are whole numbers (or INT_MIN), so the float row
        // tests of the plain version are these integer row bounds
        const T lo = fmax(c_int(ceil(lo_v), lo_v), T(0));
        const T hi = fmin(c_int(floor(hi_v), hi_v), T(H - 1));
        if (lo <= hi) {
          lo_i = static_cast<int>(lo);
          h = static_cast<int>(hi) - lo_i + 1;
        }
      }
    }
    const int end = block_scan(h, sh_warp);
    sh_end[threadIdx.x] = end;
    sh_base[threadIdx.x] = lo_i - (end - h);
    __syncthreads();
    const int total = sh_end[kThreads - 1];
    n_all += total;
    // pixel pass: flat covered index t -> (column, row).  Every covered
    // column passes the column test, so the search runs over the tile's
    // columns in [ceil(x_start), floor(x_end)] only (clamped in float,
    // no out-of-range conversion; total is 0 where x_start or x_end is
    // NaN), and each thread issues the loads of two indices before it
    // uses either.
    const int c_a = max(static_cast<int>(fmin(fmax(ceil(x_start), T(c0)),
                                               T(c0 + kThreads - 1))) - c0, 0);
    const int c_b = static_cast<int>(fmax(fmin(floor(x_end),
                                               T(c0 + kThreads - 1)),
                                          T(c0))) - c0;
    for (int t0 = threadIdx.x; t0 < total; t0 += 2 * kThreads) {
      T d[2];
      bool live[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = t0 + u * kThreads;
        live[u] = t < total;
        int a = c_a, b = c_b;            // first column with end > t
        while (a < b) {
          const int m = (a + b) >> 1;
          if (sh_end[m] > t) b = m; else a = m + 1;
        }
        const int64_t at =
            static_cast<int64_t>(sh_base[a] + t) * W + (c0 + a);
        d[u] = live[u] ? __ldg(deg_map + at) : T(0);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        T dd = fabs(sub_rn(deg, d[u]));
        if (dd > fold) dd = fabs(sub_rn(dd, two_pi));
        n_ali += live[u] && dd < prec ? 1 : 0;
      }
    }
    __syncthreads();                   // before the next tile's scan
  }

  n_ali = warp_sum(n_ali);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh_warp[warp] = n_ali;
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sh_warp[w];
    all_out[blockIdx.x] = n_all;
    ali_out[blockIdx.x] = a;
  }
}

template <typename T>
cudaError_t launch(const T* deg_map, int H, int W, const T* scalars, int R,
                   int32_t* all_out, int32_t* ali_out, void* stream) {
  if (R <= 0) return cudaSuccess;
  rect_counts_kernel<T><<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      deg_map, H, W, scalars, all_out, ali_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

cudaError_t lsd_rect_counts_f32(const float* deg_map, int H, int W,
                                const float* scalars, int R,
                                int32_t* all_out, int32_t* ali_out,
                                void* stream) {
  return launch<float>(deg_map, H, W, scalars, R, all_out, ali_out, stream);
}

cudaError_t lsd_rect_counts_f64(const double* deg_map, int H, int W,
                                const double* scalars, int R,
                                int32_t* all_out, int32_t* ali_out,
                                void* stream) {
  return launch<double>(deg_map, H, W, scalars, R, all_out, ali_out, stream);
}

}  // extern "C"
