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
// Bound.  Bytes: the 6 features of each live candidate, the live pixel
// cloud, each distinct field cell the live pairs touch and the 4 outputs
// of every slot, once each: at the recorded frames (chip_smoke.py) 0.05 us
// (tracking, 21 x 1852 px), 0.5 us (relock as the main path scores it,
// 325 survivors x 1954 px) and 0.9 us (unpruned relock, 1072 x 1954 px),
// all below the ~1.1 us device time of the smallest launch on an H100.
// The work is ~16 float operations and one gather per live (candidate,
// pixel) pair.  At a tracking frame the chain of dependent memory round
// trips sets the time; at a relock frame the gathers' scattered sectors
// and the instructions per pair do.
//
// What held the first design (one block per K-cap slot) back, and what
// this design does about each:
//   * a grid sized by the cap: at a tracking frame 2027 of 2048 blocks
//     only wrote zeros and the 21 live ones used 21 of 132 SMs.  Now the
//     grid is persistent, the SMs x the blocks the launch bounds keep
//     resident (ops/score.py:plan), and block b scores the live slots
//     b, b + grid, ... of the count it reads on the device; the dead
//     slots [n_live, K) are zeroed by a grid-stride loop in the same
//     launch;
//   * serial gather latency: each thread walked ~15 pixels with one
//     gather in flight, behind a chain of dependent loads.  Now the whole
//     block (256 threads) scores one slot, each thread kPix pixels of the
//     live prefix with all kPix gathers issued before any is used, with
//     no branch around them (a pixel outside the map reads cell 0 and is
//     masked out of the sums by a bit of a mask); the pixel cloud's first
//     round (up to the cap P) and the features of the block's first
//     kSlots slots are loaded before the live counts arrive, so the chain
//     is: counts, gathers, one barrier, stores (two loads more with a
//     survivor list);
//   * no reuse of the pixel cloud: every block re-read px/py per
//     candidate.  Now each thread holds its pixels in registers for every
//     slot its block scores (2048 pixels a block; a larger live prefix
//     takes further rounds from global memory).
// The warps run through a batch of kSlots slots on their own, each
// writing its partials to shared memory; one barrier a batch, and two
// threads a slot add the warps in order.  The field stays in the 50 MB
// L2 (5.6 MB f32, 11.3 MB f64 at 979x1440); gathers go through __ldg.
//
// Reductions, exact and repeatable (no atomics, no second launch, no
// cross-block traffic): each thread adds its pixels in order, a warp
// adds its lanes in an xor butterfly (every lane ends with the same
// bits), the block adds its warps in order; counts are int32, a warp's
// packed as n_valid + (n_far << 16) (a warp holds fewer than 2^16
// pixels).  The summation order depends only on n_pix, so two launches
// give the same bits.  Designs measured on the card before this one
// (PERF.md, section 6): tiles of candidates x pixel chunks reduced across
// blocks through global scratch and a per-tile ticket counter
// (__threadfence, atomicAdd, the last block adds the chunks), and
// thread-block clusters reduced through distributed shared memory; the
// fence and atomic round trips, and cluster barriers that wait for the
// slowest of 8 blocks, made both slower than one block per slot.
//
// Numerics: the transform's multiplies and adds are explicit
// round-to-nearest intrinsics, never contracted into FMAs (the build is
// -fmad=false too), so the C-rounding boundaries match the plain PyTorch
// version operation for operation.  C-round(v) is trunc(a) with
// a = v + copysign(0.5, v) (floor(v + 0.5) for v >= 0 and ceil(v - 0.5)
// for v < 0 are both truncations), so the bounds test runs on a against
// exact thresholds (trunc(a) >= 0 iff a > -1; trunc(a) >= lo iff
// a >= lo for lo >= 1; trunc(a) < hi iff a < hi for hi >= 1; NaN fails
// every test) before one round-toward-zero conversion per axis, and the
// cell is loaded only when it is inside the map.  No tensor cores: there
// is no matrix product here, and the 2x2 rotation per pixel must round
// operation by operation at the C-round boundaries, where TF32 or bf16
// would move pixels to other cells.  The linear index is int32, or int64
// when the block has >= 2^31 cells.  Shared memory is static, under 7 KB
// a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 8;                    // pixels a lane holds
constexpr int kHeld = kThreads * kPix;     // pixels a block holds: 2048
constexpr int kSlots = 32;                 // slots a block takes per batch
// resident blocks per SM the launch bounds ask for (registers: 85 a
// thread in f32, 128 in f64): 768 and 512 threads an SM.  Four f32
// blocks (64 registers) measured slower at relock frames (PERF.md)
template <typename T> struct Resident;
template <> struct Resident<float> { static constexpr int kBlocks = 3; };
template <> struct Resident<double> { static constexpr int kBlocks = 2; };

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ int trunc_int(float a) { return __float2int_rz(a); }
__device__ __forceinline__ int trunc_int(double a) { return __double2int_rz(a); }

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads, Resident<T>::kBlocks)
score_partials_kernel(const T* __restrict__ cand, int K,
                      const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ n_cand,
                      const T* __restrict__ px, const T* __restrict__ py,
                      int P, const int32_t* __restrict__ n_pix_live,
                      const T* __restrict__ cache, int block_h, int pad_cols,
                      int row0, int rows, int cols, T z, T penalty, T omd,
                      T* __restrict__ sum_d, int32_t* __restrict__ n_valid,
                      T* __restrict__ sum_far, int32_t* __restrict__ n_far) {
  __shared__ T sh_feat[kSlots][6];           // features of the batch
  __shared__ T sh_sum[kSlots][kWarps][2];    // warp partials of each slot
  __shared__ int sh_cnt[kSlots][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grid = gridDim.x;

  // features of this block's slots blockIdx.x + (k0 + k) grid, k < nk
  // (slots past the live count are read too, and never used)
  auto fetch = [&](int k0, int nk) {
    if (tid < 6 * kSlots) {
      const int k = tid / 6, r = tid % 6;
      const int b = blockIdx.x + (k0 + k) * grid;
      if (k < nk && b < K) {
        const int c = idx ? min(max(idx[b], 0), K - 1) : b;
        sh_feat[k][r] = cand[r * K + c];
      }
    }
  };
  // The first batch's features and the first round of the pixel cloud
  // (pixel tid + kThreads u of the allocation, read up to the cap P) go
  // out together with the live counts: nothing waits for them before
  // the gathers.
  const int cap_mine = blockIdx.x < K ? (K - 1 - blockIdx.x) / grid + 1 : 0;
  fetch(0, min(cap_mine, kSlots));
  T xs[kPix], ys[kPix];
#pragma unroll
  for (int u = 0; u < kPix; ++u) {
    const int i = tid + kThreads * u;
    xs[u] = i < P ? px[i] : T(0);
    ys[u] = i < P ? py[i] : T(0);
  }
  const int n_live = min(max(*n_cand, 0), K);
  const int n_pix = min(max(*n_pix_live, 0), P);

  // dead slots [n_live, K): zeros, grid-stride
  for (int b = n_live + blockIdx.x * kThreads + tid; b < K;
       b += grid * kThreads) {
    sum_d[b] = T(0);
    n_valid[b] = 0;
    sum_far[b] = T(0);
    n_far[b] = 0;
  }
  // exact thresholds on a = v + copysign(0.5, v) for the bounds test
  const int lo_row = max(row0, 0);
  const int hi_col = min(cols, pad_cols), hi_row = min(rows, row0 + block_h);
  const bool none = hi_col <= 0 || hi_row <= lo_row;
  const T x_lo = T(-1), x_hi = none ? T(-2) : T(hi_col);
  const T y_lo = lo_row > 0 ? nextafter(T(lo_row), T(-1)) : T(-1);
  const T y_hi = T(hi_row);
  // no cell is inside: nothing is gathered (cell 0 may not exist)
  const int n_scored = none ? 0 : n_pix;

  // live slots blockIdx.x + k grid: the whole block scores each slot
  // over every live pixel; the warps run through a batch's slots on
  // their own, one barrier a batch
  const int mine = blockIdx.x < n_live ? (n_live - 1 - blockIdx.x) / grid + 1
                                       : 0;
  for (int k0 = 0; k0 < mine; k0 += kSlots) {
    const int nk = min(kSlots, mine - k0);
    if (k0 > 0) fetch(k0, nk);
    __syncthreads();           // the batch's features are in shared memory
    for (int k = 0; k < nk; ++k) {
      T f[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) f[r] = sh_feat[k][r];
      T s_d = T(0), s_far = T(0);
      int cnt = 0;             // n_valid + (n_far << 16)
      for (int q0 = 0; q0 < n_scored; q0 += kHeld) {
        T x[kPix], y[kPix], v[kPix];
        if (q0 == 0) {
#pragma unroll
          for (int u = 0; u < kPix; ++u) {
            x[u] = xs[u];
            y[u] = ys[u];
          }
        } else {
#pragma unroll
          for (int u = 0; u < kPix; ++u) {
            const int i = q0 + tid + kThreads * u;
            x[u] = i < n_pix ? px[i] : T(0);
            y[u] = i < n_pix ? py[i] : T(0);
          }
        }
        // every gather of the round issued before any is used; a pixel
        // outside the map reads cell 0 and is masked out
        unsigned in = 0;
#pragma unroll
        for (int u = 0; u < kPix; ++u) {
          const T dx = sub_rn(x[u], f[2]);
          const T dy = sub_rn(y[u], f[3]);
          const T tx = add_rn(sub_rn(mul_rn(dx, f[0]), mul_rn(dy, f[1])),
                              f[4]);
          const T ty = add_rn(add_rn(mul_rn(dx, f[1]), mul_rn(dy, f[0])),
                              f[5]);
          const T ax = add_rn(tx, copysign(T(0.5), tx));
          const T ay = add_rn(ty, copysign(T(0.5), ty));
          const bool inside = q0 + tid + kThreads * u < n_pix && ax > x_lo &&
                              ax < x_hi && ay > y_lo && ay < y_hi;
          const I lin = inside
              ? static_cast<I>(trunc_int(ay) - row0) * pad_cols +
                    static_cast<I>(trunc_int(ax))
              : I(0);
          v[u] = __ldg(cache + lin);
          in |= inside ? 1u << u : 0u;
        }
#pragma unroll
        for (int u = 0; u < kPix; ++u) {
          if (in & (1u << u)) {
            const bool at_cap = v[u] >= z;
            const T contrib = at_cap ? penalty : v[u];
            const bool far = at_cap || v[u] >= omd;
            s_d += contrib;
            if (far) s_far += contrib;
            cnt += far ? 0x10001 : 1;
          }
        }
      }
      // the warp's sums (every lane ends with the same bits)
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) {
        s_d += __shfl_xor_sync(0xffffffffu, s_d, o);
        s_far += __shfl_xor_sync(0xffffffffu, s_far, o);
        cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
      }
      if (lane == 0) {
        sh_sum[k][warp][0] = s_d;
        sh_sum[k][warp][1] = s_far;
        sh_cnt[k][warp] = cnt;
      }
    }
    __syncthreads();           // every warp's partials of the batch
    // thread 2k + kind adds slot k's warps in order
    if (tid < 2 * nk) {
      const int k = tid >> 1, kind = tid & 1;
      const int b = blockIdx.x + (k0 + k) * grid;
      T a = T(0);
      int n = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        a += sh_sum[k][w][kind];
        n += kind ? sh_cnt[k][w] >> 16 : sh_cnt[k][w] & 0xffff;
      }
      (kind ? sum_far : sum_d)[b] = a;
      (kind ? n_far : n_valid)[b] = n;
    }
    __syncthreads();           // before the next batch's features
  }
}

template <typename T>
cudaError_t launch(const T* cand, int K, const int32_t* idx,
                   const int32_t* n_cand, const T* px, const T* py, int P,
                   const int32_t* n_pix, const T* cache, int block_h,
                   int pad_cols, int row0, int rows, int cols, T z,
                   T penalty, T omd, T* sum_d, int32_t* n_valid, T* sum_far,
                   int32_t* n_far, int grid, void* stream) {
  if (K <= 0) return cudaSuccess;
  if (grid <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(block_h) * pad_cols;
  if (cells >= (1LL << 31)) {
    score_partials_kernel<T, int64_t><<<grid, kThreads, 0, s>>>(
        cand, K, idx, n_cand, px, py, P, n_pix, cache, block_h, pad_cols,
        row0, rows, cols, z, penalty, omd, sum_d, n_valid, sum_far, n_far);
  } else {
    score_partials_kernel<T, int32_t><<<grid, kThreads, 0, s>>>(
        cand, K, idx, n_cand, px, py, P, n_pix, cache, block_h, pad_cols,
        row0, rows, cols, z, penalty, omd, sum_d, n_valid, sum_far, n_far);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The constants the wrapper's launch plan (ops/score.py:plan) must use:
// threads, pixels a lane holds, resident blocks f32, f64.
void lsd_score_plan_constants(int32_t* out) {
  out[0] = kThreads;
  out[1] = kPix;
  out[2] = Resident<float>::kBlocks;
  out[3] = Resident<double>::kBlocks;
}

cudaError_t lsd_score_partials_f32(
    const float* cand, int K, const int32_t* idx, const int32_t* n_cand,
    const float* px, const float* py, int P, const int32_t* n_pix,
    const float* cache, int block_h, int pad_cols, int row0, int rows,
    int cols, float z, float penalty, float omd, float* sum_d,
    int32_t* n_valid, float* sum_far, int32_t* n_far, int grid,
    void* stream) {
  return launch<float>(cand, K, idx, n_cand, px, py, P, n_pix, cache,
                       block_h, pad_cols, row0, rows, cols, z, penalty, omd,
                       sum_d, n_valid, sum_far, n_far, grid, stream);
}

cudaError_t lsd_score_partials_f64(
    const double* cand, int K, const int32_t* idx, const int32_t* n_cand,
    const double* px, const double* py, int P, const int32_t* n_pix,
    const double* cache, int block_h, int pad_cols, int row0, int rows,
    int cols, double z, double penalty, double omd, double* sum_d,
    int32_t* n_valid, double* sum_far, int32_t* n_far, int grid,
    void* stream) {
  return launch<double>(cand, K, idx, n_cand, px, py, P, n_pix, cache,
                        block_h, pad_cols, row0, rows, cols, z, penalty, omd,
                        sum_d, n_valid, sum_far, n_far, grid, stream);
}

}  // extern "C"
