// CalcScore partials for Hopper (sm_90a): the per-candidate
// (sum_d, n_valid, sum_far, n_far) of scoring rigid scan transforms
// against the mapCache distance field.
//
// Replaces the TPU kernel lsdtpu/ops/score_pallas.py:_score_kernel (and
// the XLA transform+gather+reduce it stood for,
// lsdtpu/match/associate.py:_make_part_all).  Reference semantics:
// CalcScore, LSD/myFA.cpp:357-396.  For each candidate c and each live
// scan pixel p:
//   tx = (px - sx)*ca - (py - sy)*sa + mx
//   ty = (px - sx)*sa + (py - sy)*ca + my
//   ix, iy = C-round(tx), C-round(ty)           (half away from zero)
//   inside = 0 <= ix < cols, 0 <= iy < rows, row0 <= iy < row0 + block_h
//   v = cache[iy - row0, ix]; at_cap = v >= z
//   contrib = at_cap ? penalty : v
//   sum_d += contrib, n_valid += 1              (inside pixels)
//   sum_far += contrib, n_far += 1              (inside and (at_cap or v >= omd))
// finalize_scores (match/associate.py) turns the partials into scores.
//
// Design (a simple, correct first kernel):
//   * one thread block per candidate slot; the block reads the live
//     candidate count and live pixel count from device memory, so the
//     host never syncs to size the launch; blocks past the count write
//     zeros and exit (the pruned path passes a survivor index list and
//     its count instead of the candidate prefix);
//   * threads stride over the live pixel prefix; the transform's
//     multiplies and adds are explicit round-to-nearest intrinsics, never
//     contracted into FMAs, so the C-rounding boundaries match the plain
//     PyTorch version operation for operation;
//   * the bounds test runs on the rounded float values before any
//     conversion to int (no out-of-range float->int behaviour), and the
//     cell is loaded (__ldg) only when it is inside the map;
//   * the linear index is int32, or int64 when the block has >= 2^31
//     cells (no 2^24-cell limit);
//   * sums accumulate in the working type (float or double), counts in
//     int32 (exact); a warp-shuffle + shared-memory block reduction with
//     no atomics makes results repeat from run to run.
//
// Bound: at a relock frame (~1000 live candidates x ~2.5k live pixels)
// the work is ~16 float operations per (candidate, pixel) pair and one
// 4-byte gather; the field (a 979x1440 f32 map is 5.6 MB) sits in the
// 50 MB L2, so the pair count and the gather latency bound it, not
// device memory.  Making it fast is later work: tiling several
// candidates per block, keeping the pixel cloud in shared memory, and a
// CUDA graph over the whole frame to remove launch and sync overhead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T c_round(T v) {
  // C round(): floor(v + 0.5) / ceil(v - 0.5); roundf differs at
  // 0.49999997f, where v + 0.5 rounds up to 1.0
  return v >= T(0) ? floor(add_rn(v, T(0.5))) : ceil(sub_rn(v, T(0.5)));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
score_partials_kernel(const T* __restrict__ cand, int K,
                      const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ n_cand,
                      const T* __restrict__ px, const T* __restrict__ py,
                      const int32_t* __restrict__ n_pix,
                      const T* __restrict__ cache, int block_h, int pad_cols,
                      int row0, int rows, int cols, T z, T penalty, T omd,
                      T* __restrict__ sum_d, int32_t* __restrict__ n_valid,
                      T* __restrict__ sum_far, int32_t* __restrict__ n_far) {
  const int b = blockIdx.x;
  const int n_live = min(max(*n_cand, 0), K);
  if (b >= n_live) {
    if (threadIdx.x == 0) {
      sum_d[b] = T(0);
      n_valid[b] = 0;
      sum_far[b] = T(0);
      n_far[b] = 0;
    }
    return;
  }
  const int c = idx ? idx[b] : b;
  const T ca = cand[0 * K + c], sa = cand[1 * K + c];
  const T sx = cand[2 * K + c], sy = cand[3 * K + c];
  const T mx = cand[4 * K + c], my = cand[5 * K + c];
  // the field block covers rows [row0, row0 + block_h) of the map
  const T lo_y = T(max(row0, 0));
  const T hi_y = T(min(rows, row0 + block_h));   // exclusive
  const T hi_x = T(min(cols, pad_cols));         // exclusive
  const int P = *n_pix;

  T s_d = T(0), s_far = T(0);
  int c_valid = 0, c_far = 0;
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const T dx = sub_rn(px[i], sx);
    const T dy = sub_rn(py[i], sy);
    const T tx = add_rn(sub_rn(mul_rn(dx, ca), mul_rn(dy, sa)), mx);
    const T ty = add_rn(add_rn(mul_rn(dx, sa), mul_rn(dy, ca)), my);
    const T fx = c_round(tx);
    const T fy = c_round(ty);
    if (fx >= T(0) && fx < hi_x && fy >= lo_y && fy < hi_y) {
      const I lin = static_cast<I>(static_cast<int>(fy) - row0) * pad_cols +
                    static_cast<I>(static_cast<int>(fx));
      const T v = __ldg(cache + lin);
      const bool at_cap = v >= z;
      const T contrib = at_cap ? penalty : v;
      s_d += contrib;
      c_valid += 1;
      if (at_cap || v >= omd) {
        s_far += contrib;
        c_far += 1;
      }
    }
  }

  // block reduction: warp shuffles, then one value per warp in shared
  constexpr int kWarps = kThreads / 32;
  __shared__ T sh_d[kWarps], sh_far[kWarps];
  __shared__ int sh_valid[kWarps], sh_nfar[kWarps];
  s_d = warp_sum(s_d);
  s_far = warp_sum(s_far);
  c_valid = warp_sum(c_valid);
  c_far = warp_sum(c_far);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh_d[warp] = s_d;
    sh_far[warp] = s_far;
    sh_valid[warp] = c_valid;
    sh_nfar[warp] = c_far;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T a = T(0), f = T(0);
    int nv = 0, nf = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += sh_d[w];
      f += sh_far[w];
      nv += sh_valid[w];
      nf += sh_nfar[w];
    }
    sum_d[b] = a;
    n_valid[b] = nv;
    sum_far[b] = f;
    n_far[b] = nf;
  }
}

template <typename T>
cudaError_t launch(const T* cand, int K, const int32_t* idx,
                   const int32_t* n_cand, const T* px, const T* py,
                   const int32_t* n_pix, const T* cache, int block_h,
                   int pad_cols, int row0, int rows, int cols, T z,
                   T penalty, T omd, T* sum_d, int32_t* n_valid, T* sum_far,
                   int32_t* n_far, void* stream) {
  if (K <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(block_h) * pad_cols;
  if (cells >= (1LL << 31)) {
    score_partials_kernel<T, int64_t><<<K, kThreads, 0, s>>>(
        cand, K, idx, n_cand, px, py, n_pix, cache, block_h, pad_cols, row0,
        rows, cols, z, penalty, omd, sum_d, n_valid, sum_far, n_far);
  } else {
    score_partials_kernel<T, int32_t><<<K, kThreads, 0, s>>>(
        cand, K, idx, n_cand, px, py, n_pix, cache, block_h, pad_cols, row0,
        rows, cols, z, penalty, omd, sum_d, n_valid, sum_far, n_far);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

cudaError_t lsd_score_partials_f32(
    const float* cand, int K, const int32_t* idx, const int32_t* n_cand,
    const float* px, const float* py, const int32_t* n_pix,
    const float* cache, int block_h, int pad_cols, int row0, int rows,
    int cols, float z, float penalty, float omd, float* sum_d,
    int32_t* n_valid, float* sum_far, int32_t* n_far, void* stream) {
  return launch<float>(cand, K, idx, n_cand, px, py, n_pix, cache, block_h,
                       pad_cols, row0, rows, cols, z, penalty, omd, sum_d,
                       n_valid, sum_far, n_far, stream);
}

cudaError_t lsd_score_partials_f64(
    const double* cand, int K, const int32_t* idx, const int32_t* n_cand,
    const double* px, const double* py, const int32_t* n_pix,
    const double* cache, int block_h, int pad_cols, int row0, int rows,
    int cols, double z, double penalty, double omd, double* sum_d,
    int32_t* n_valid, double* sum_far, int32_t* n_far, void* stream) {
  return launch<double>(cand, K, idx, n_cand, px, py, n_pix, cache, block_h,
                        pad_cols, row0, rows, cols, z, penalty, omd, sum_d,
                        n_valid, sum_far, n_far, stream);
}

}  // extern "C"
