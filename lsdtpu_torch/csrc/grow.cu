// Exact FIFO region growth and the FIFO radius reducer of the LSD map
// prep, for Hopper (sm_90a).
//
// No TPU kernel stands behind these: the reference package runs them as
// XLA while_loops (lsdtpu/mapprep/lsd.py:_grow_fifo,
// lsdtpu/mapprep/rect.py:radius_reducer_fifo).  Reference semantics:
// RegionGrower and RegionRadiusReducer, LSD/myLSD.cpp:491-590 and
// 736-802.
//
// grow_fifo: a queue of accepted pixels.  Each popped pixel scans its
// 3x3 neighbourhood in row-major order (dy outer, dx inner; the centre
// is already in the region and skips itself; out-of-map neighbours are
// skipped); a neighbour neither in the region nor banned is accepted
// when |deg - d| (folded by 2 pi above 1.5 pi) < thre, and after EVERY
// acceptance sin += sin(d), cos += cos(d), deg = atan2(sin, cos).  A
// pass walks the queue from its head while it grows; passes repeat
// until one adds nothing.  The start angle is atan2(sin, cos) of the
// seed pixel's entries of the sin/cos tables the caller built once per
// map, and every sin/cos added comes from those tables too, so the
// kernel and its plain version (ops/grow.py) differ only in atan2.
//
// radius_reducer_fifo: one shrink pass over the queue.  A point farther
// than rad from the seed is removed by swapping the last point into its
// slot (the slot is then examined again; only a kept point advances the
// walk), clearing it from the region mask and the fit mask.  Then the
// reference's one-past-the-end read (the `i <= num` loop reads a (0, 0)
// phantom): when the origin is farther than rad and points are left,
// the real last point leaves the list and the fit mask but stays in the
// region mask, and cell (0, 0) of the region mask is cleared.  The host
// loop around it (mapprep/rect.py) reads the count once a pass.
//
// Bound.  Both are serial by construction: every acceptance decision
// depends on the running angle of all earlier ones.  The least time is
// the dependent chain, not bytes: per popped pixel one dependent on-chip
// load and per accepted pixel one atan2 of the working type; per reducer
// point one dependent load.  latency_probe_kernel measures those two
// latencies in SM cycles, and chip_smoke.py charges them to the run's
// popped and accepted counts.  What the design does about it: one
// thread takes every decision; the 9 neighbours' flags, angles and
// sin/cos entries are loaded together before any is used (they cannot
// change during the pop: each is a distinct cell), so a pop costs one
// memory round trip plus the decisions; the block's other threads only
// clear the region mask first.  No cross-thread traffic, no atomics.
//
// Numerics: every add and subtract is an explicit round-to-nearest
// intrinsic, never contracted (the build is -fmad=false too); the sums
// run in the working type in queue order, as in the plain version.  The
// distance test of the reducer squares integer offsets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // threads of the one block
constexpr double kPi = 3.14159265358979323846;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float atan2_t(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_t(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ float sqrt_t(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_t(double a) { return __dsqrt_rn(a); }

// The region mask is cleared in 4-byte words by thread t at words
// t, t + kThreads, ..., the tail bytes by threads below cells % 4
// (ops/grow.py:clear_split is the same split).
__device__ void clear_mask(uint8_t* cur, int cells) {
  const int words = cells >> 2;
  uint32_t* w = reinterpret_cast<uint32_t*>(cur);
  for (int i = threadIdx.x; i < words; i += kThreads) w[i] = 0u;
  const int tail = cells & 3;
  if (static_cast<int>(threadIdx.x) < tail) cur[(words << 2) + threadIdx.x] = 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
grow_fifo_kernel(int sy, int sx, T thre_v, const T* __restrict__ thre_p,
                 const uint8_t* __restrict__ ban, const T* __restrict__ deg,
                 const T* __restrict__ sn, const T* __restrict__ cs, int H,
                 int W, int32_t* __restrict__ qy, int32_t* __restrict__ qx,
                 uint8_t* __restrict__ cur, T* __restrict__ reg_deg,
                 int32_t* __restrict__ counts) {
  clear_mask(cur, H * W);
  __syncthreads();
  if (threadIdx.x != 0) return;

  const T thre = thre_p ? *thre_p : thre_v;
  const T fold = T(1.5 * kPi), two_pi = T(2.0 * kPi);
  const int s = sy * W + sx;
  T s_sin = __ldg(sn + s), s_cos = __ldg(cs + s);
  T d = atan2_t(s_sin, s_cos);
  cur[s] = 1;
  qy[0] = sy;
  qx[0] = sx;
  int grow = 1, ex = 0, pops = 0, passes = 0;
  while (ex != grow) {
    ex = grow;
    ++passes;
    for (int i = 0; i < grow; ++i) {
      ++pops;
      const int ry = qy[i], rx = qx[i];
      // the 9 neighbours' loads, all issued before any decision
      int idx[9];
      bool ok[9];
      T nd[9], ns[9], nc[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int m = ry + k / 3 - 1, n = rx + k % 3 - 1;
        const bool inb = m >= 0 && m < H && n >= 0 && n < W;
        idx[k] = inb ? m * W + n : s;
        ok[k] = inb && !cur[idx[k]] && !__ldg(ban + idx[k]);
        nd[k] = __ldg(deg + idx[k]);
        ns[k] = __ldg(sn + idx[k]);
        nc[k] = __ldg(cs + idx[k]);
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        if (!ok[k]) continue;
        T dif = abs_t(sub_rn(d, nd[k]));
        if (dif > fold) dif = abs_t(sub_rn(dif, two_pi));
        if (dif < thre) {
          s_sin = add_rn(s_sin, ns[k]);
          s_cos = add_rn(s_cos, nc[k]);
          d = atan2_t(s_sin, s_cos);
          cur[idx[k]] = 1;
          qy[grow] = ry + k / 3 - 1;
          qx[grow] = rx + k % 3 - 1;
          ++grow;
        }
      }
    }
  }
  *reg_deg = d;
  counts[0] = grow;
  counts[1] = pops;
  counts[2] = passes;
}

template <typename T>
__global__ void radius_reducer_fifo_kernel(int sx, int sy, T rad,
                                           int32_t* __restrict__ qy,
                                           int32_t* __restrict__ qx,
                                           int32_t* __restrict__ n_io,
                                           uint8_t* __restrict__ cur,
                                           uint8_t* __restrict__ fit, int W) {
  const T fx = T(sx), fy = T(sy);
  int n = *n_io;
  int i = 0;
  while (i < n) {
    const int yi = qy[i], xi = qx[i];
    const T dx = sub_rn(fx, T(xi)), dy = sub_rn(fy, T(yi));
    if (sqrt_t(add_rn(mul_rn(dx, dx), mul_rn(dy, dy))) > rad) {
      qy[i] = qy[n - 1];
      qx[i] = qx[n - 1];
      --n;
      cur[yi * W + xi] = 0;
      fit[yi * W + xi] = 0;
    } else {
      ++i;
    }
  }
  if (sqrt_t(add_rn(mul_rn(fx, fx), mul_rn(fy, fy))) > rad && n > 0) {
    fit[qy[n - 1] * W + qx[n - 1]] = 0;
    cur[0] = 0;
    --n;
  }
  *n_io = n;
}

// One thread times, with clock64, `steps` dependent loads chasing a ring
// in shared memory, the same chase through the L1 (read-only path, warmed
// by a first lap), and chains of `steps` atan2 in double and in float.
// out[0..3]: the four totals in SM cycles; out[4] keeps the chains live.
constexpr int kProbeRing = 1024;

__global__ void latency_probe_kernel(const int32_t* __restrict__ ring,
                                     int steps, long long* __restrict__ out) {
  __shared__ int32_t sring[kProbeRing];
  for (int i = 0; i < kProbeRing; ++i) sring[i] = ring[i];
  int j = 0;
  for (int i = 0; i < steps; ++i) j = __ldg(ring + j);
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i) j = sring[j];
  const long long t1 = clock64();
  for (int i = 0; i < steps; ++i) j = __ldg(ring + j);
  const long long t2 = clock64();
  double d = 0.5 + j;
  for (int i = 0; i < steps; ++i) d = atan2(d, 0.75);
  const long long t3 = clock64();
  float f = static_cast<float>(d);
  for (int i = 0; i < steps; ++i) f = atan2f(f, 0.75f);
  const long long t4 = clock64();
  out[0] = t1 - t0;
  out[1] = t2 - t1;
  out[2] = t3 - t2;
  out[3] = t4 - t3;
  out[4] = j + static_cast<long long>(f * 1000.0f);
}

template <typename T>
cudaError_t grow(int sy, int sx, T thre_v, const T* thre_p,
                 const uint8_t* ban, const T* deg, const T* sn, const T* cs,
                 int H, int W, int32_t* qy, int32_t* qx, uint8_t* cur,
                 T* reg_deg, int32_t* counts, void* stream) {
  if (H <= 0 || W <= 0 || sy < 0 || sy >= H || sx < 0 || sx >= W)
    return cudaErrorInvalidValue;
  grow_fifo_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sy, sx, thre_v, thre_p, ban, deg, sn, cs, H, W, qy, qx, cur, reg_deg,
      counts);
  return cudaGetLastError();
}

template <typename T>
cudaError_t reduce(int sx, int sy, T rad, int32_t* qy, int32_t* qx,
                   int32_t* n_io, uint8_t* cur, uint8_t* fit, int W,
                   void* stream) {
  radius_reducer_fifo_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      sx, sy, rad, qy, qx, n_io, cur, fit, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The block size the wrapper's clear split (ops/grow.py) must use.
int32_t lsd_grow_threads() { return kThreads; }

// ring: kProbeRing int32 entries, ring[i] = (i + 1) % kProbeRing.
cudaError_t lsd_grow_latency_probe(const int32_t* ring, int steps,
                                   long long* out, void* stream) {
  if (steps <= 0) return cudaErrorInvalidValue;
  latency_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      ring, steps, out);
  return cudaGetLastError();
}

cudaError_t lsd_grow_fifo_f32(int sy, int sx, float thre_v,
                              const float* thre_p, const uint8_t* ban,
                              const float* deg, const float* sn,
                              const float* cs, int H, int W, int32_t* qy,
                              int32_t* qx, uint8_t* cur, float* reg_deg,
                              int32_t* counts, void* stream) {
  return grow<float>(sy, sx, thre_v, thre_p, ban, deg, sn, cs, H, W, qy, qx,
                     cur, reg_deg, counts, stream);
}

cudaError_t lsd_grow_fifo_f64(int sy, int sx, double thre_v,
                              const double* thre_p, const uint8_t* ban,
                              const double* deg, const double* sn,
                              const double* cs, int H, int W, int32_t* qy,
                              int32_t* qx, uint8_t* cur, double* reg_deg,
                              int32_t* counts, void* stream) {
  return grow<double>(sy, sx, thre_v, thre_p, ban, deg, sn, cs, H, W, qy,
                      qx, cur, reg_deg, counts, stream);
}

cudaError_t lsd_radius_reducer_fifo_f32(int sx, int sy, float rad,
                                        int32_t* qy, int32_t* qx,
                                        int32_t* n_io, uint8_t* cur,
                                        uint8_t* fit, int W, void* stream) {
  return reduce<float>(sx, sy, rad, qy, qx, n_io, cur, fit, W, stream);
}

cudaError_t lsd_radius_reducer_fifo_f64(int sx, int sy, double rad,
                                        int32_t* qy, int32_t* qx,
                                        int32_t* n_io, uint8_t* cur,
                                        uint8_t* fit, int W, void* stream) {
  return reduce<double>(sx, sy, rad, qy, qx, n_io, cur, fit, W, stream);
}

}  // extern "C"
