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
// Design (a simple, correct first kernel):
//   * one thread block per rectangle; threads stride over the image
//     columns and test the column range with the same float
//     expressions as the plain version;
//   * each thread computes its column's y_low/y_high once, every
//     multiply and add an explicit round-to-nearest intrinsic (the build
//     is -fmad=false too), so the ceil/floor boundaries fall where the
//     plain version's separate PyTorch ops put them;
//   * the thread then walks only rows max(y_low, 0) .. min(y_high, H-1),
//     the reference's own column walk (myLSD.cpp:973-1016): it reads
//     only the pixels the rectangle covers, and neighbouring threads
//     read neighbouring addresses of a row;
//   * 1.5*pi and 2*pi are rounded once to the working type, as the
//     reference package's weakly typed constants are;
//   * counts are int32; a warp-shuffle + shared-memory block reduction
//     with no atomics makes them exact and repeatable.
//
// Bound: each call reads the covered pixels once (a 426x3 px line at
// 293x432 is ~1.3k pixels, ~5 KB in f32) and does ~6 operations per
// pixel, so the bytes bound it at a few nanoseconds; at R <= 5
// rectangles per launch the launch itself (microseconds) and the
// thread that walks the tallest column (a near-vertical line walks
// hundreds of rows in one thread) set the time.  Making it fast is
// later work: several rectangles per launch across seeds, splitting
// tall columns over a warp, and a CUDA graph over the improver.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rect_counts_kernel(const T* __restrict__ deg_map, int H, int W,
                   const T* __restrict__ scalars,
                   int32_t* __restrict__ all_out,
                   int32_t* __restrict__ ali_out) {
  const T* s = scalars + static_cast<int64_t>(blockIdx.x) * kScalars;
  const T x_start = s[0], x_len = s[1];
  const T vx0 = s[2], vx1 = s[3], vx3 = s[5];
  const T vy0 = s[6], vy1 = s[7], vy3 = s[9];
  const T k0 = s[10], k1 = s[11], k2 = s[12], k3 = s[13];
  const T deg = s[14], prec = s[15];
  const T x_end = sub_rn(add_rn(x_start, x_len), T(1));
  const T fold = T(kPi * 1.5), two_pi = T(2 * kPi);

  int n_all = 0, n_ali = 0;
  for (int c = threadIdx.x; c < W; c += kThreads) {
    const T xx = T(c);
    if (!(xx >= x_start && xx <= x_end)) continue;
    const T lo_v = xx < vx3 ? add_rn(vy0, mul_rn(sub_rn(xx, vx0), k3))
                            : add_rn(vy3, mul_rn(sub_rn(xx, vx3), k2));
    const T hi_v = xx < vx1 ? add_rn(vy0, mul_rn(sub_rn(xx, vx0), k0))
                            : add_rn(vy1, mul_rn(sub_rn(xx, vx1), k1));
    // y_low/y_high are whole numbers (or INT_MIN), so the float row
    // tests of the plain version are these integer row bounds
    const T lo = fmax(c_int(ceil(lo_v), lo_v), T(0));
    const T hi = fmin(c_int(floor(hi_v), hi_v), T(H - 1));
    if (!(lo <= hi)) continue;
    const int y1 = static_cast<int>(hi);
    const T* col = deg_map + c;
#pragma unroll 4
    for (int y = static_cast<int>(lo); y <= y1; ++y) {
      T d = fabs(sub_rn(deg, __ldg(col + static_cast<int64_t>(y) * W)));
      if (d > fold) d = fabs(sub_rn(d, two_pi));
      n_all += 1;
      n_ali += d < prec ? 1 : 0;
    }
  }

  constexpr int kWarps = kThreads / 32;
  __shared__ int sh_all[kWarps], sh_ali[kWarps];
  n_all = warp_sum(n_all);
  n_ali = warp_sum(n_ali);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh_all[warp] = n_all;
    sh_ali[warp] = n_ali;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0, b = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += sh_all[w];
      b += sh_ali[w];
    }
    all_out[blockIdx.x] = a;
    ali_out[blockIdx.x] = b;
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
