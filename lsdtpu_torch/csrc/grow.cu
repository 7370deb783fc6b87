// Region growth of the LSD map prep - exact FIFO growth, the FIFO radius
// reducer and wave-synchronous growth - for Hopper (sm_90a).
//
// No TPU kernel stands behind these: the reference package runs them as
// XLA while_loops (lsdtpu/mapprep/lsd.py:_grow_fifo, :_grow,
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
// the dependent chain, not bytes, and it counts only the work the walk
// must take one step after another: per accepted pixel one step of its
// add, its atan2 and the angle test of the next candidate against the new
// angle (a pop without an acceptance is parallel work: a window tests
// four entries' neighbours in one step), and the seed's start angle; per
// reducer pass one load and distance test of its points (all at once)
// and one bit scan per 32-slot flag word.  latency_probe_kernel measures
// those steps in SM cycles, and chip_smoke.py charges them to the run's
// accepted pixels and points.
//
// Design of grow_fifo: one 256-thread block; warp 0 takes the decisions
// (its 32 lanes hold the same running values and take the same
// branches), and everything the walk reads back lies on the chip.
//  * Many pops at once.  The walk tests a window of 4 queue entries in
//    one step: lane L tests neighbour L % 8 (row-major, the centre left
//    out) of entry L / 8, so lane order is the order of the decisions.
//    A ballot gathers the neighbours that pass against the running
//    angle; the lowest is the walk's next acceptance.  Its sin/cos are
//    shuffled to every lane, each lane adds them and takes the atan2,
//    and the later lanes drop the accepted cell and test again against
//    the new angle, so every decision is the one the in-order walk takes.
//    A window without acceptances (every pop of a region's last pass)
//    costs one test for four pops; an acceptance costs its atan2 and one
//    more test.  Every lane writes the same values to the same places
//    (region bits, queue entries), so each reads back its own writes and
//    the warp needs no barrier.
//  * The region mask is a bitmap in shared memory (one bit a cell: 16 KB
//    for a 293 x 432 field).  A field whose bitmap does not fit beside a
//    queue of QUEUE_MIN entries (ops/grow.py:grow_plan; above ~1.7 M
//    cells) keeps the mask in the global uint8 output instead, in the
//    same kernel (kSharedMask false).
//  * The queue is a shared array of packed cells (y << 16 | x), of
//    queue_cap entries (at most 16384: 64 KB).  Entries past it spill to
//    the global qy/qx outputs and are read back from there; a full flood
//    of a 293 x 432 field spills.
//  * The read-only tables are off the chain: each lane loads its
//    neighbour's angle, sin, cos and ban (ban unconditionally, not after
//    the mask test), and the next window's entries that exist are loaded
//    before the current window's decisions (the cells are known: the
//    queue holds them), so their latency overlaps the acceptances.  This
//    was chosen over a producer warp staging neighbourhoods into a shared
//    ring: the next cells are known one window ahead in the walking warp
//    itself, and a ring would add a cross-warp handshake (a shared flag
//    and a fence) to every window.
//  * The uint8 mask is the call's own output, cleared whole: with the
//    bitmap in shared memory warps 1-7 clear it (16-byte stores) beside
//    the walk, with the global mask all threads clear it before.  After
//    the walk, a barrier, then all threads write the queue entries to
//    qy/qx (coalesced) and set the region's cells in the mask.
//  * Warp 0's first loads (the threshold, the seed's sin/cos and the
//    seed's neighbourhood) go out before the block clears the bitmap.
//  * Dynamic shared memory (the bitmap and the queue, 81,360 bytes for
//    the 293 x 432 field) above 48 KB is enabled with
//    cudaFuncSetAttribute; a launch the card refuses returns its error.
//
// Design of radius_reducer_fifo: one 256-thread block.  All threads load
// the n live entries (coalesced) and decide in parallel which are farther
// than rad (a pure function of the point: the serial walk examines each
// point exactly once and removes it iff it is far); each warp's ballot
// stores 32 slots' far flags as one word, and the far points' mask cells
// are cleared.  The first cap slots go to shared memory (reduce_plan: at
// most 8192, the flags beside them while they fit; later slots stay in
// the global queue, the flags then in a global buffer).  Thread 0 then
// runs the swap-with-last walk in runs over the flag words: the next far
// slot and the last kept slot are each found with one bit scan, a far
// slot takes the last kept entry (the far ones between leave unexamined,
// as they would one by one), and the phantom-slot rule follows; the
// block writes the entries back.
//
// grow_wave: the counterpart of the JAX package's _grow while_loop
// (lsdtpu/mapprep/lsd.py:73), one launch a growth call where the port's
// plain loop (ops/grow.py:grow_wave_reference) reads the device once a
// wave.  Its waves: the angle d = atan2(sin, cos) of the running sums is
// fixed for a wave; every candidate - a free 8-neighbour of the region not
// in it - passes when |d - deg| (folded by 2 pi above 1.5 pi) < thre; the
// passing ones join the region and their sin/cos sums are added to the
// running sums; the loop ends at the first wave that accepts nothing
// (counted, as the plain loop counts it).  The start angle comes from a
// device scalar (sin and cos taken here), so the refiner's regrowth needs
// no read either.  Outputs: the mask, the angle, and [pixels, waves,
// candidate tests].
//
// Bound of grow_wave: the waves are a dependent chain - a wave's test
// needs the previous wave's angle, its candidates the previous wave's
// acceptances - and a wave's work is small (the region's rim, tens of
// cells on a map), so neither bytes nor operations bound it but the steps
// a wave takes one after another: the candidates' angle loads, the test,
// the sum of the accepted cells, the atan2, the neighbours' free loads,
// and the block barriers between them.
//
// Design of grow_wave: one 256-thread block holds the region and the
// candidates on the chip, so a wave costs a few barriers, not a pass over
// the field.
//  * Two bitmaps in shared memory (16 KB each for a 293 x 432 field): the
//    region and the seen cells (region or listed).  A field whose bitmaps
//    do not fit beside QUEUE_MIN entries of each list (ops/grow.py:
//    wave_plan) keeps a byte a cell in the uint8 output instead (0, 1
//    region, 2 listed), changed by word atomics (kSharedMask false).
//  * The candidate list and the wave's accepted cells are shared arrays
//    of packed cells, spilling past their caps to the per-map queue
//    buffers (list_spill, acc_spill).  A wave tests the list in chunks of
//    256, one entry a thread; a warp's passes move to the accepted array
//    and its fails are packed in place at the front of the list, each with
//    one shared atomic a warp (the chunk is read before any entry moves).
//    The accepted cells' free neighbours are claimed on the seen bitmap
//    (an atomicOr: one thread lists a cell) and appended to the list.
//  * The sums are taken in one order fixed by the accepted cells'
//    row-major index, never by thread timing: the accepted cells are sorted
//    (one warp's shuffles for at most 32, the common case, else a bitonic
//    network over the block) and summed by a fixed tree (wave_sums), so a
//    launch repeats bit for bit.  Only the lists' order depends on timing,
//    and no result depends on it.
//  * The mask is written once at the end, 32 cells from a bitmap word.
//
// Numerics: every add and subtract is an explicit round-to-nearest
// intrinsic, never contracted (the build is -fmad=false too); the FIFO
// sums run in the working type in queue order, as in the plain version,
// the wave sums in the working type in the order above (the plain version
// sums in torch's order: f64 decisions agree, the angles to an ulp or so).
// The distance test of the reducer squares integer offsets.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // threads of a block
constexpr int kWarp = 32;
constexpr int kWindow = kWarp / 8;  // queue entries a walker step tests
constexpr int kSmemMax = 232448;     // shared bytes a block may use (sm_90)
constexpr int kSmemStatic = 49152;   // above this only by the attribute
constexpr int kMaxSide = 65535;      // a packed queue entry's y and x
constexpr int kMaxDevices = 64;
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
__device__ __forceinline__ float sin_t(float a) { return sinf(a); }
__device__ __forceinline__ double sin_t(double a) { return sin(a); }
__device__ __forceinline__ float cos_t(float a) { return cosf(a); }
__device__ __forceinline__ double cos_t(double a) { return cos(a); }

// Clear the whole (H, W) mask: 16-byte word t, t + n_clear, ... and tail
// byte t below cells % 16, by clearing thread t of n_clear (the mask is a
// fresh allocation, 16-byte aligned; tests/test_torch_kernel_plan.py
// mirrors the split).
__device__ void clear_mask(uint8_t* cur, int cells, int t, int n_clear) {
  const int words = cells >> 4;
  uint4* w = reinterpret_cast<uint4*>(cur);
  for (int j = t; j < words; j += n_clear) w[j] = make_uint4(0u, 0u, 0u, 0u);
  if (t < (cells & 15)) cur[(words << 4) + t] = 0;
}

// The walker's state.  Warp 0 walks: its 32 lanes hold the same running
// values and take the same branches.  It tests a window of kWindow queue
// entries at once: lane L owns neighbour L % 8 of entry L / 8 of the
// window, so lane order is the walk's order of the decisions.
template <typename T>
struct Walk {
  const uint8_t* __restrict__ ban;
  const T* __restrict__ deg;
  const T* __restrict__ sn;
  const T* __restrict__ cs;
  int H, W, qcap;
  int32_t* qy;
  int32_t* qx;
  uint8_t* cur;
  uint32_t* bm;      // the shared bitmap (kSharedMask)
  uint32_t* sq;      // the shared queue
  T thre, fold, two_pi, s_sin, s_cos, d;
  int i, grow, ex, pops, passes;
  int lane, slot, dy, dx;   // this lane's window entry and neighbour offset
};

// This lane's neighbour in one window: the cell its test reads and that
// cell's table entries.
template <typename T>
struct Nb {
  int base, count;   // the window: queue entries [base, base + count)
  bool in;           // my entry is in the window, my neighbour in the field
  uint32_t e;        // my neighbour, packed (y << 16 | x)
  int idx;           // its cell
  uint32_t ban;
  T d, s, c;
};

template <typename T>
__device__ __forceinline__ uint32_t entry(const Walk<T>& w, int j) {
  return j < w.qcap ? w.sq[j]
                    : (static_cast<uint32_t>(w.qy[j]) << 16) |
                          static_cast<uint32_t>(w.qx[j]);
}

// This lane's neighbour of the popped cell e, into b (nothing here waits
// on its loads).
template <typename T>
__device__ __forceinline__ void load_lane(const Walk<T>& w, Nb<T>& b,
                                          uint32_t e) {
  const int m = static_cast<int>(e >> 16) + w.dy;
  const int n = static_cast<int>(e & 0xffffu) + w.dx;
  const bool in = static_cast<unsigned>(m) < static_cast<unsigned>(w.H) &&
                  static_cast<unsigned>(n) < static_cast<unsigned>(w.W);
  const int idx = in ? m * w.W + n : 0;
  b.in = in;
  b.e = (static_cast<uint32_t>(m) << 16) | static_cast<uint32_t>(n & 0xffff);
  b.idx = idx;
  b.ban = in ? __ldg(w.ban + idx) : 1u;
  b.d = in ? __ldg(w.deg + idx) : T(0);
  b.s = in ? __ldg(w.sn + idx) : T(0);
  b.c = in ? __ldg(w.cs + idx) : T(0);
}

// A lane whose slot holds no entry: no neighbour.
template <typename T>
__device__ __forceinline__ void no_lane(Nb<T>& b) {
  b.in = false;
  b.e = 0u;
  b.idx = 0;
  b.ban = 1u;
  b.d = b.s = b.c = T(0);
}

// The window of the entries [base, base + count) that exist now (count
// at most kWindow); the lanes of slots below `keep` keep what they hold,
// those of slots past count hold nothing.  Nothing here waits on a load.
template <typename T>
__device__ __forceinline__ void load_window(const Walk<T>& w, Nb<T>& b,
                                            int base, int keep) {
  const int left = w.grow - base;
  b.base = base;
  b.count = left < kWindow ? left : kWindow;
  if (w.slot < keep) return;
  if (w.slot < b.count)
    load_lane(w, b, entry(w, base + w.slot));
  else
    no_lane(b);
}

// The first window, the seed alone, before the queue holds it.
template <typename T>
__device__ __forceinline__ void load_seed(const Walk<T>& w, Nb<T>& b,
                                          uint32_t seed) {
  b.base = 0;
  b.count = 1;
  if (w.slot == 0)
    load_lane(w, b, seed);
  else
    no_lane(b);
}

// The angle test against the running angle.  The fold is computed either
// way and selected, as the plain version's branch would (both are exact
// operations).
template <typename T>
__device__ __forceinline__ bool angle_pass(T d, T nd, T fold, T two_pi,
                                           T thre) {
  const T dif = abs_t(sub_rn(d, nd));
  const T wrapped = abs_t(sub_rn(dif, two_pi));
  return (dif > fold ? wrapped : dif) < thre;
}

template <typename T>
__device__ __forceinline__ bool angle_ok(const Walk<T>& w, T nd) {
  return angle_pass(w.d, nd, w.fold, w.two_pi, w.thre);
}

// Accept lane L's neighbour, the walk's next acceptance: its sin/cos go
// to every lane, each lane updating the same sums, and it joins the region
// and the queue.  Every lane writes the same values to the same places, so
// each lane reads back its own writes without a warp barrier.  Returns the
// lanes after L that still pass against the new angle.
template <bool kSharedMask, typename T>
__device__ __forceinline__ uint32_t accept(Walk<T>& w, const Nb<T>& a, int L,
                                           uint32_t& wv, bool& open) {
  const uint32_t e = __shfl_sync(0xffffffffu, a.e, L);
  const int idx = __shfl_sync(0xffffffffu, a.idx, L);
  w.s_sin = add_rn(w.s_sin, __shfl_sync(0xffffffffu, a.s, L));
  w.s_cos = add_rn(w.s_cos, __shfl_sync(0xffffffffu, a.c, L));
  if (kSharedMask) {
    const uint32_t word = __shfl_sync(0xffffffffu, wv, L) | (1u << (idx & 31));
    w.bm[idx >> 5] = word;
    if ((a.idx >> 5) == (idx >> 5)) wv = word;
  } else {
    w.cur[idx] = 1;
  }
  const int g = w.grow;
  if (g < w.qcap) {
    w.sq[g] = e;
  } else {
    w.qy[g] = static_cast<int>(e >> 16);
    w.qx[g] = static_cast<int>(e & 0xffffu);
  }
  w.grow = g + 1;
  w.d = atan2_t(w.s_sin, w.s_cos);
  open = open && a.idx != idx;
  return __ballot_sync(0xffffffffu, open && w.lane > L && angle_ok(w, a.d));
}

// Pop the window of entries [w.i, w.i + a.count) whose neighbourhoods the
// lanes hold in `a`, and fill `b` with the next one.  Returns true when
// the walk is over.  Every lane tests its neighbour against the running
// angle and a ballot gathers the passes; the lowest passing lane is the
// walk's next acceptance (accept), after which the later lanes drop the
// accepted cell and are tested again against the new angle.  So every
// decision is the one the in-order walk takes, while a window without
// acceptances costs one test.
//
// The next window starts right after this one while the pass goes on.
// Its entries that exist are loaded once `a` is in, before the decisions,
// so their latency overlaps the decisions; the entries this window
// appends to it are loaded after them (loading each beside its atan2 was
// tried and was slower on the card: the loads put waits on the chain).
// The first acceptance stands outside the loop: there the compiler knows
// `a` is in, and the registers it reads wait on none of the next
// window's loads.
template <bool kSharedMask, typename T>
__device__ __forceinline__ bool step(Walk<T>& w, const Nb<T>& a, Nb<T>& b) {
  // the region word of my neighbour, kept current through this window
  uint32_t wv = 0;
  bool open;
  if (kSharedMask) {
    wv = w.bm[a.idx >> 5];
    open = a.in && !a.ban && !((wv >> (a.idx & 31)) & 1u);
  } else {
    open = a.in && !a.ban && !w.cur[a.idx];
  }
  const bool pass = open && angle_ok(w, a.d);
  const int after = w.i + a.count;
  load_window(w, b, after, 0);
  uint32_t acc = __ballot_sync(0xffffffffu, pass);
  if (acc) {
    acc = accept<kSharedMask>(w, a, __ffs(acc) - 1, wv, open);
    while (acc) acc = accept<kSharedMask>(w, a, __ffs(acc) - 1, wv, open);
  }
  w.pops += a.count;
  w.i = after;
  if (after == w.grow) {   // the pass is over
    if (w.grow == w.ex) return true;
    w.ex = w.grow;
    ++w.passes;
    w.i = 0;
    load_window(w, b, 0, 0);
  } else if (b.count < kWindow && after + b.count < w.grow) {
    load_window(w, b, after, b.count);   // the entries appended to it
  }
  return false;
}

template <typename T, bool kSharedMask>
__global__ void __launch_bounds__(kThreads, 1)
grow_fifo_kernel(int sy, int sx, T thre_v, const T* __restrict__ thre_p,
                 const uint8_t* __restrict__ ban, const T* __restrict__ deg,
                 const T* __restrict__ sn, const T* __restrict__ cs, int H,
                 int W, int qcap, int32_t* __restrict__ qy,
                 int32_t* __restrict__ qx, uint8_t* __restrict__ cur,
                 T* __restrict__ reg_deg,
                 int32_t* __restrict__ counts) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_n;
  const int cells = H * W;
  const int words = kSharedMask ? (cells + 31) >> 5 : 0;
  uint32_t* bm = smem;
  uint32_t* sq = smem + words;
  const int t = threadIdx.x;

  // warp 0's first loads (the threshold, the seed's sin/cos, the seed's
  // neighbourhood) go out before the block clears the bitmap
  Walk<T> w;
  Nb<T> a, b;
  const int s = sy * W + sx;
  const uint32_t seed =
      (static_cast<uint32_t>(sy) << 16) | static_cast<uint32_t>(sx);
  if (t < kWarp) {
    w.ban = ban; w.deg = deg; w.sn = sn; w.cs = cs;
    w.H = H; w.W = W; w.qcap = qcap;
    w.qy = qy; w.qx = qx; w.cur = cur; w.bm = bm; w.sq = sq;
    w.lane = t;
    w.slot = t >> 3;
    const int k = (t & 7) + ((t & 7) >= 4);   // row-major 3x3, centre skipped
    w.dy = k / 3 - 1;
    w.dx = k % 3 - 1;
    w.thre = thre_p ? *thre_p : thre_v;
    w.fold = T(1.5 * kPi);
    w.two_pi = T(2.0 * kPi);
    w.s_sin = __ldg(sn + s);
    w.s_cos = __ldg(cs + s);
    w.grow = 1;
    load_seed(w, a, seed);
  }
  if (kSharedMask) {
    for (int j = t; j < words; j += kThreads) bm[j] = 0u;
  } else {
    clear_mask(cur, cells, t, kThreads);
  }
  __syncthreads();

  if (t < kWarp) {
    w.d = atan2_t(w.s_sin, w.s_cos);
    if (kSharedMask)
      bm[s >> 5] |= 1u << (s & 31);
    else
      cur[s] = 1;
    sq[0] = seed;
    w.i = 0; w.ex = 1; w.pops = 0; w.passes = 1;
    for (;;) {
      if (step<kSharedMask>(w, a, b)) break;
      if (step<kSharedMask>(w, b, a)) break;
    }
    if (t == 0) {
      *reg_deg = w.d;
      counts[0] = w.grow;
      counts[1] = w.pops;
      counts[2] = w.passes;
      s_n = w.grow;
    }
  } else if (kSharedMask) {
    clear_mask(cur, cells, t - kWarp, kThreads - kWarp);   // beside the walk
  }
  __syncthreads();

  // the region's cells: the queue written out, the mask set (the walk set
  // a global mask itself)
  const int n = s_n;
  for (int j = t; j < n; j += kThreads) {
    int y, x;
    if (j < qcap) {
      const uint32_t e = sq[j];
      y = static_cast<int>(e >> 16);
      x = static_cast<int>(e & 0xffffu);
      qy[j] = y;
      qx[j] = x;
    } else {
      y = qy[j];
      x = qx[j];
    }
    if (kSharedMask) cur[y * W + x] = 1;
  }
}

template <typename T>
__device__ __forceinline__ bool far_from(int y, int x, T fx, T fy, T rad) {
  const T dx = sub_rn(fx, T(x)), dy = sub_rn(fy, T(y));
  return sqrt_t(add_rn(mul_rn(dx, dx), mul_rn(dy, dy))) > rad;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
radius_reducer_fifo_kernel(int sx, int sy, T rad, int32_t* __restrict__ qy,
                           int32_t* __restrict__ qx,
                           int32_t* __restrict__ n_io,
                           uint8_t* __restrict__ cur,
                           uint8_t* __restrict__ fit, int W, int cap,
                           uint32_t* __restrict__ gflags) {
  extern __shared__ uint32_t smem[];
  int2* se = reinterpret_cast<int2*>(smem);   // the first cap slots {x, y}
  uint32_t* fb = gflags ? gflags : smem + 2 * cap;   // bit j: slot j far
  const T fx = T(sx), fy = T(sy);
  const int m = *n_io;
  const int ms = m < cap ? m : cap;
  const int lane = threadIdx.x & (kWarp - 1);
  // each warp decides whole 32-slot words: the far flags (a pure function
  // of the point), the far points' mask cells, the shared slots
  for (int base = threadIdx.x - lane; base < m; base += kThreads) {
    const int j = base + lane;
    bool far = false;
    if (j < m) {
      const int y = qy[j], x = qx[j];
      far = far_from(y, x, fx, fy, rad);
      if (far) {
        cur[y * W + x] = 0;
        fit[y * W + x] = 0;
      }
      if (j < ms) se[j] = make_int2(x, y);
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, far);
    if (lane == 0) fb[base >> 5] = bits;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    auto get = [&](int j) -> int2 {
      return j < ms ? se[j] : make_int2(qx[j], qy[j]);
    };
    auto put = [&](int j, int2 e) {
      if (j < ms) {
        se[j] = e;
      } else {
        qy[j] = e.y;
        qx[j] = e.x;
      }
    };
    // the first far slot in [i, n), else n
    auto next_far = [&](int i, int n) -> int {
      while (i < n) {
        const uint32_t bits = fb[i >> 5] >> (i & 31);
        if (bits) {
          const int f = i + __ffs(bits) - 1;
          return f < n ? f : n;
        }
        i = (i | 31) + 1;
      }
      return n;
    };
    // the last near slot in (i, n), else i
    auto last_near = [&](int i, int n) -> int {
      int j = n - 1;
      while (j > i) {
        const uint32_t near = ~fb[j >> 5] & (0xffffffffu >> (31 - (j & 31)));
        if (near) {
          const int t = (j & ~31) + 31 - __clz(near);
          return t > i ? t : i;
        }
        j = (j & ~31) - 1;
      }
      return i;
    };
    // The swap-with-last walk with its runs taken whole: the slots from
    // i on are still the entries' own, so their flags hold.  A kept run
    // advances i; a far slot i takes the entries from the end one by one,
    // the far ones leaving again, until a kept one stays (then it is
    // examined and kept) or none is left before i (then slot i holds the
    // last one copied, the entry after it, and the walk ends at i).
    int n = m, i = 0;
    for (;;) {
      i = next_far(i, n);
      if (i >= n) break;
      const int j = last_near(i, n);
      if (j > i) {
        put(i, get(j));
        n = j;
        ++i;
      } else {
        if (i + 1 < n) put(i, get(i + 1));
        n = i;
        break;
      }
    }
    if (sqrt_t(add_rn(mul_rn(fx, fx), mul_rn(fy, fy))) > rad && n > 0) {
      const int2 l = get(n - 1);
      fit[l.y * W + l.x] = 0;
      cur[0] = 0;
      --n;
    }
    *n_io = n;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ms; j += kThreads) {
    const int2 e = se[j];
    qy[j] = e.y;
    qx[j] = e.x;
  }
}

// --- grow_wave ---------------------------------------------------------

constexpr int kWaveStatic = 1024;   // static shared bytes grow_wave keeps
constexpr int kWarps = kThreads / kWarp;

template <typename T>
struct WaveShared {
  T part[2][kWarps];   // the wave's sin and cos sums, one a warp
  // counters that only grow (mod 2^32): a phase's entries are the
  // difference from their value at its start, read after a barrier
  uint32_t acc_ctr, keep_ctr, app_ctr;
};
static_assert(sizeof(WaveShared<double>) <= kWaveStatic,
              "grow_wave's static shared memory outgrew kWaveStatic");

// One of grow_wave's two lists of packed cells (y << 16 | x): slots below
// cap in shared memory, later ones at the same index of a global spill
// buffer (a per-map queue buffer of H * W entries).
struct Slots {
  uint32_t* shared;
  int cap;
  int32_t* spill;

  __device__ __forceinline__ uint32_t get(int j) const {
    return j < cap ? shared[j] : static_cast<uint32_t>(spill[j]);
  }
  __device__ __forceinline__ void put(int j, uint32_t e) const {
    if (j < cap) shared[j] = e;
    else spill[j] = static_cast<int32_t>(e);
  }
};

// The candidate list and the wave's accepted cells.
struct WaveLists {
  Slots list, acc;
};

// Which cells are in the region and which are listed.  With kSharedMask
// two shared bitmaps, the region's and the seen one (region or listed),
// the mask written from the first at the end; else the output mask itself
// is the state, a byte a cell: 0 outside, 1 region, 2 listed (read through
// L2, since its bytes change by atomics), the listed ones cleared at the
// end.
template <bool kSharedMask>
struct WaveMarks {
  uint32_t* reg;
  uint32_t* seen;
  uint8_t* cur;

  __device__ __forceinline__ uint32_t* word(int idx) const {
    return reinterpret_cast<uint32_t*>(cur) + (idx >> 2);
  }
  __device__ __forceinline__ void seed(int idx) const {
    if constexpr (kSharedMask) {
      atomicOr(reg + (idx >> 5), 1u << (idx & 31));
      atomicOr(seen + (idx >> 5), 1u << (idx & 31));
    } else {
      atomicOr(word(idx), 1u << (8 * (idx & 3)));
    }
  }
  // List cell idx unless it is in the region or listed; true when this
  // thread listed it.
  __device__ __forceinline__ bool claim(int idx) const {
    if constexpr (kSharedMask) {
      const uint32_t bit = 1u << (idx & 31);
      if (seen[idx >> 5] & bit) return false;
      return !(atomicOr(seen + (idx >> 5), bit) & bit);
    } else {
      const int sh = 8 * (idx & 3);
      if ((__ldcg(word(idx)) >> sh) & 0xffu) return false;
      return ((atomicOr(word(idx), 2u << sh) >> sh) & 0xffu) == 0u;
    }
  }
  // A listed cell joins the region.
  __device__ __forceinline__ void join(int idx) const {
    if constexpr (kSharedMask)
      atomicOr(reg + (idx >> 5), 1u << (idx & 31));
    else
      atomicXor(word(idx), 3u << (8 * (idx & 3)));   // 2 -> 1
  }
};

template <typename T>
__device__ __forceinline__ T warp_tree(T x) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x = add_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  return x;
}

// 32 packed cells, one a lane, sorted ascending across the warp (the
// bitonic network in its flip form; a lane without a cell holds ~0u).
__device__ __forceinline__ uint32_t warp_sort(uint32_t e, int lane) {
  for (int k = 2; k <= kWarp; k <<= 1) {
    for (int m = k; m >= 2; m >>= 1) {
      const int mask = m == k ? k - 1 : m >> 1;
      const uint32_t o = __shfl_xor_sync(0xffffffffu, e, mask);
      const bool lo = !(lane & (m >> 1));
      e = lo ? min(e, o) : max(e, o);
    }
  }
  return e;
}

// The wave's accepted cells acc[0, n) sorted ascending in place by the
// whole block: the bitonic network in its flip form, where every
// compare-exchange puts the smaller cell at the lower slot, so the slots
// past n act as +infinity and their exchanges are skipped.  Ends on a
// barrier.
__device__ void block_sort(const WaveLists& q, int n) {
  int P = 2;
  while (P < n) P <<= 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int m = k; m >= 2; m >>= 1) {
      const int half = m >> 1;
      for (int p = threadIdx.x; p < (P >> 1); p += kThreads) {
        const int base = (p / half) * m, off = p % half;
        const int lo = base + off;
        const int hi = m == k ? base + m - 1 - off : lo + half;
        if (hi < n) {
          const uint32_t a = q.acc.get(lo), b = q.acc.get(hi);
          if (b < a) {
            q.acc.put(lo, b);
            q.acc.put(hi, a);
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int cell_of(uint32_t e, int W) {
  return static_cast<int>(e >> 16) * W + static_cast<int>(e & 0xffffu);
}

// The sums of sin and cos over the wave's n accepted cells, in one order
// fixed by their row-major index: the cells sorted, cell j added by
// thread j % kThreads in turn, each warp's partial sums added as a tree
// (shuffles), then the warps' as a tree.  With at most 32 cells warp 0
// sorts and sums them alone.  Every thread returns the same sums; the
// accepted cells are left sorted.
template <typename T>
__device__ void wave_sums(const WaveLists& q, WaveShared<T>& sh, int n,
                          const T* __restrict__ sn,
                          const T* __restrict__ cs, int W, T& s, T& c) {
  const int t = threadIdx.x, lane = t & (kWarp - 1), warp = t >> 5;
  if (n <= kWarp) {
    if (warp == 0) {
      const uint32_t e = warp_sort(lane < n ? q.acc.get(lane) : ~0u, lane);
      T ps = T(0), pc = T(0);
      if (lane < n) {
        q.acc.put(lane, e);
        ps = __ldg(sn + cell_of(e, W));
        pc = __ldg(cs + cell_of(e, W));
      }
      ps = warp_tree(ps);
      pc = warp_tree(pc);
      if (lane == 0) {
        sh.part[0][0] = ps;
        sh.part[1][0] = pc;
      }
    }
    __syncthreads();
    s = sh.part[0][0];
    c = sh.part[1][0];
    return;
  }
  block_sort(q, n);
  T ps = T(0), pc = T(0);
  for (int j = t; j < n; j += kThreads) {
    const int idx = cell_of(q.acc.get(j), W);
    ps = add_rn(ps, __ldg(sn + idx));
    pc = add_rn(pc, __ldg(cs + idx));
  }
  ps = warp_tree(ps);
  pc = warp_tree(pc);
  if (lane == 0) {
    sh.part[0][warp] = ps;
    sh.part[1][warp] = pc;
  }
  __syncthreads();
  T v[2][kWarps];
  for (int w = 0; w < kWarps; ++w) {
    v[0][w] = sh.part[0][w];
    v[1][w] = sh.part[1][w];
  }
  for (int len = kWarps / 2; len > 0; len >>= 1)
    for (int w = 0; w < len; ++w) {
      v[0][w] = add_rn(v[0][w], v[0][w + len]);
      v[1][w] = add_rn(v[1][w], v[1][w + len]);
    }
  s = v[0][0];
  c = v[1][0];
}

// List the free 8-neighbours of acc[0, n) that are neither in the region
// nor listed: thread j % kThreads takes neighbour j % 8 of cell j / 8, a
// warp's new entries appended together at nk + (app_ctr - app0).
template <bool kSharedMask, typename T>
__device__ void expand(const WaveLists& q, const WaveMarks<kSharedMask>& mk,
                       WaveShared<T>& sh, int n, int nk, uint32_t app0,
                       const uint8_t* __restrict__ free, int H, int W) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long total = 8LL * n;
  for (long long base = 0; base < total; base += kThreads) {
    const long long j = base + threadIdx.x;
    bool add = false;
    uint32_t c = 0u;
    if (j < total) {
      const uint32_t e = q.acc.get(static_cast<int>(j >> 3));
      const int k = static_cast<int>(j & 7) + ((j & 7) >= 4);   // no centre
      const int y = static_cast<int>(e >> 16) + k / 3 - 1;
      const int x = static_cast<int>(e & 0xffffu) + k % 3 - 1;
      if (static_cast<unsigned>(y) < static_cast<unsigned>(H) &&
          static_cast<unsigned>(x) < static_cast<unsigned>(W)) {
        const int idx = y * W + x;
        add = __ldg(free + idx) && mk.claim(idx);
        c = (static_cast<uint32_t>(y) << 16) | static_cast<uint32_t>(x);
      }
    }
    const uint32_t am = __ballot_sync(0xffffffffu, add);
    uint32_t b = 0u;
    if (lane == 0 && am) b = atomicAdd(&sh.app_ctr, __popc(am));
    b = __shfl_sync(0xffffffffu, b, 0);
    if (add)
      q.list.put(nk + static_cast<int>(b - app0) +
                     __popc(am & ((1u << lane) - 1u)), c);
  }
}

template <typename T, bool kSharedMask>
__global__ void __launch_bounds__(kThreads, 1)
grow_wave_kernel(int sy, int sx, const T* __restrict__ seed_deg, T thre_v,
                 const T* __restrict__ thre_p,
                 const uint8_t* __restrict__ free,
                 const T* __restrict__ deg, const T* __restrict__ sn,
                 const T* __restrict__ cs, int H, int W, int list_cap,
                 int acc_cap, int32_t* __restrict__ list_spill,
                 int32_t* __restrict__ acc_spill, uint8_t* __restrict__ cur,
                 T* __restrict__ reg_deg, int32_t* __restrict__ counts) {
  extern __shared__ uint32_t smem[];
  __shared__ WaveShared<T> sh;
  const int cells = H * W;
  const int words = kSharedMask ? (cells + 31) >> 5 : 0;
  const WaveMarks<kSharedMask> mk{smem, smem + words, cur};
  const WaveLists q{{smem + 2 * words, list_cap, list_spill},
                    {smem + 2 * words + list_cap, acc_cap, acc_spill}};
  const int t = threadIdx.x, lane = t & (kWarp - 1);
  const T thre = thre_p ? *thre_p : thre_v;
  const T fold = T(1.5 * kPi), two_pi = T(2.0 * kPi);
  const T a0 = *seed_deg;
  T s_sin = sin_t(a0), s_cos = cos_t(a0);
  T d = atan2_t(s_sin, s_cos);

  if (kSharedMask) {
    for (int j = t; j < 2 * words; j += kThreads) smem[j] = 0u;
  } else {
    clear_mask(cur, cells, t, kThreads);
    __threadfence();
  }
  if (t == 0) {
    sh.acc_ctr = sh.keep_ctr = sh.app_ctr = 0u;
    q.acc.put(0, (static_cast<uint32_t>(sy) << 16) | static_cast<uint32_t>(sx));
  }
  __syncthreads();
  // the seed joins the region and its neighbours start the list
  if (t == 0) mk.seed(sy * W + sx);
  int nk = 0, n = 1, waves = 0;
  uint32_t app0 = 0u;
  long long tests = 0;
  expand(q, mk, sh, 1, nk, app0, free, H, W);
  __syncthreads();

  for (;;) {
    // one wave: every listed cell tested against the angle d, fixed for
    // the wave; the accepted ones join the region and move to acc, the
    // others are kept, packed in place at the front of the list
    const int nl = nk + static_cast<int>(sh.app_ctr - app0);
    const uint32_t acc0 = sh.acc_ctr, keep0 = sh.keep_ctr;
    ++waves;
    tests += nl;
    for (int base = 0; base < nl; base += kThreads) {
      const int j = base + t;
      const bool in = j < nl;
      uint32_t e = 0u;
      int idx = 0;
      bool pass = false;
      if (in) {
        e = q.list.get(j);
        idx = cell_of(e, W);
        pass = angle_pass(d, __ldg(deg + idx), fold, two_pi, thre);
      }
      __syncthreads();   // the chunk is read before any entry moves
      const uint32_t am = __ballot_sync(0xffffffffu, in && pass);
      const uint32_t km = __ballot_sync(0xffffffffu, in && !pass);
      uint32_t ab = 0u, kb = 0u;
      if (lane == 0) {
        if (am) ab = atomicAdd(&sh.acc_ctr, __popc(am));
        if (km) kb = atomicAdd(&sh.keep_ctr, __popc(km));
      }
      ab = __shfl_sync(0xffffffffu, ab, 0);
      kb = __shfl_sync(0xffffffffu, kb, 0);
      const uint32_t below = (1u << lane) - 1u;
      if (in && pass) {
        q.acc.put(static_cast<int>(ab - acc0) + __popc(am & below), e);
        mk.join(idx);
      } else if (in) {
        q.list.put(static_cast<int>(kb - keep0) + __popc(km & below), e);
      }
    }
    __syncthreads();
    const int na = static_cast<int>(sh.acc_ctr - acc0);
    nk = static_cast<int>(sh.keep_ctr - keep0);
    app0 = sh.app_ctr;
    if (na == 0) break;
    n += na;
    T ws, wc;
    wave_sums(q, sh, na, sn, cs, W, ws, wc);
    s_sin = add_rn(s_sin, ws);
    s_cos = add_rn(s_cos, wc);
    d = atan2_t(s_sin, s_cos);
    expand(q, mk, sh, na, nk, app0, free, H, W);
    __syncthreads();
  }

  if (t == 0) {
    *reg_deg = d;
    counts[0] = n;
    counts[1] = waves;
    counts[2] = tests < INT_MAX ? static_cast<int32_t>(tests) : INT_MAX;
  }
  if (kSharedMask) {
    // the mask from the region bitmap, 32 cells (two 16-byte stores) a word
    const auto spread = [](uint32_t b) {   // bits 0-3 -> bytes 0-3
      return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
    };
    for (int w = t; w < words; w += kThreads) {
      const uint32_t bits = mk.reg[w];
      const int c0 = w << 5;
      if (c0 + 32 <= cells) {
        uint4* out = reinterpret_cast<uint4*>(cur + c0);
        out[0] = make_uint4(spread(bits), spread(bits >> 4), spread(bits >> 8),
                            spread(bits >> 12));
        out[1] = make_uint4(spread(bits >> 16), spread(bits >> 20),
                            spread(bits >> 24), spread(bits >> 28));
      } else {
        for (int b = 0; c0 + b < cells; ++b) cur[c0 + b] = (bits >> b) & 1u;
      }
    }
  } else {
    // the last wave kept every listed cell: they leave the mask
    for (int j = t; j < nk; j += kThreads) cur[cell_of(q.list.get(j), W)] = 0;
  }
}

// One step of grow_fifo's chain per accepted pixel: the sum's add, the
// atan2, and the angle test of the next candidate, whose outcome picks
// the next add.
template <typename T>
__device__ __forceinline__ T accept_chain(T s, int steps) {
  const T fold = T(1.5 * kPi), two_pi = T(2.0 * kPi), thre = T(0.4);
  T a = T(0.01);
  for (int i = 0; i < steps; ++i) {
    s = add_rn(s, a);
    const T d = atan2_t(s, T(0.75));
    const T dif = abs_t(sub_rn(d, T(0.3)));
    const T wrapped = abs_t(sub_rn(dif, two_pi));
    a = (dif > fold ? wrapped : dif) < thre ? T(0.01) : T(-0.01);
  }
  return s;
}

// One distance test of the reducer as a chain: subtract, square, add,
// square root.
template <typename T>
__device__ __forceinline__ T dist_chain(T r, int steps) {
  for (int i = 0; i < steps; ++i) {
    const T dx = sub_rn(r, T(0.5));
    r = sqrt_t(add_rn(mul_rn(dx, dx), T(0.75)));
  }
  return r;
}

// One thread times, with clock64, `steps` dependent loads chasing a ring
// in shared memory, the same chase through the L1 (read-only path, warmed
// by a first lap), chains of `steps` atan2, then of accept_chain's and
// dist_chain's steps, each in double and in float.  out[0..7]: the eight
// totals in SM cycles; out[8] keeps the chains live.
constexpr int kProbeRing = 1024;
constexpr int kProbeChains = 8;

__global__ void latency_probe_kernel(const int32_t* __restrict__ ring,
                                     int steps, long long* __restrict__ out) {
  __shared__ int32_t sring[kProbeRing];
  for (int i = 0; i < kProbeRing; ++i) sring[i] = ring[i];
  int j = 0;
  for (int i = 0; i < steps; ++i) j = __ldg(ring + j);
  long long t[kProbeChains + 1];
  t[0] = clock64();
  for (int i = 0; i < steps; ++i) j = sring[j];
  t[1] = clock64();
  for (int i = 0; i < steps; ++i) j = __ldg(ring + j);
  t[2] = clock64();
  double d = 0.5 + j;
  for (int i = 0; i < steps; ++i) d = atan2(d, 0.75);
  t[3] = clock64();
  float f = static_cast<float>(d);
  for (int i = 0; i < steps; ++i) f = atan2f(f, 0.75f);
  t[4] = clock64();
  d = accept_chain(d + f, steps);
  t[5] = clock64();
  f = accept_chain(static_cast<float>(d), steps);
  t[6] = clock64();
  d = dist_chain(d + f, steps);
  t[7] = clock64();
  f = dist_chain(static_cast<float>(d), steps);
  t[8] = clock64();
  for (int k = 0; k < kProbeChains; ++k) out[k] = t[k + 1] - t[k];
  out[kProbeChains] = j + static_cast<long long>(f * 1000.0f);
}

// Allow `bytes` of dynamic shared memory for `kernel` on the current
// device, once per device and size (above 48 KB the card refuses a launch
// that asks for more than the attribute allows).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* allowed) {
  if (bytes <= kSmemStatic) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

template <typename T>
cudaError_t grow(int sy, int sx, T thre_v, const T* thre_p,
                 const uint8_t* ban, const T* deg, const T* sn, const T* cs,
                 int H, int W, int shared_mask, int qcap, int32_t* qy,
                 int32_t* qx, uint8_t* cur, T* reg_deg, int32_t* counts,
                 void* stream) {
  if (H <= 0 || W <= 0 || H > kMaxSide || W > kMaxSide ||
      static_cast<long long>(H) * W > INT_MAX || sy < 0 || sy >= H ||
      sx < 0 || sx >= W || qcap < 1 ||
      reinterpret_cast<uintptr_t>(cur) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long words = shared_mask ? (static_cast<long long>(H) * W + 31) / 32 : 0;
  const long long bytes = 4 * (words + qcap);
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (shared_mask) {
    static int allowed[kMaxDevices];
    err = allow_smem(grow_fifo_kernel<T, true>, static_cast<int>(bytes), allowed);
    if (err != cudaSuccess) return err;
    grow_fifo_kernel<T, true><<<1, kThreads, bytes, st>>>(
        sy, sx, thre_v, thre_p, ban, deg, sn, cs, H, W, qcap, qy, qx, cur,
        reg_deg, counts);
  } else {
    static int allowed[kMaxDevices];
    err = allow_smem(grow_fifo_kernel<T, false>, static_cast<int>(bytes), allowed);
    if (err != cudaSuccess) return err;
    grow_fifo_kernel<T, false><<<1, kThreads, bytes, st>>>(
        sy, sx, thre_v, thre_p, ban, deg, sn, cs, H, W, qcap, qy, qx, cur,
        reg_deg, counts);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t reduce(int sx, int sy, T rad, int32_t* qy, int32_t* qx,
                   int32_t* n_io, uint8_t* cur, uint8_t* fit, int W, int cap,
                   int flag_words, uint32_t* gflags, void* stream) {
  if (W <= 0 || cap < 1 || flag_words < 1) return cudaErrorInvalidValue;
  const long long bytes = 8LL * cap + (gflags ? 0 : 4LL * flag_words);
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  static int allowed[kMaxDevices];
  cudaError_t err = allow_smem(radius_reducer_fifo_kernel<T>,
                               static_cast<int>(bytes), allowed);
  if (err != cudaSuccess) return err;
  radius_reducer_fifo_kernel<T>
      <<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          sx, sy, rad, qy, qx, n_io, cur, fit, W, cap, gflags);
  return cudaGetLastError();
}

template <typename T>
cudaError_t wave(int sy, int sx, const T* seed_deg, T thre_v, const T* thre_p,
                 const uint8_t* free, const T* deg, const T* sn, const T* cs,
                 int H, int W, int shared_mask, int list_cap, int acc_cap,
                 int32_t* list_spill, int32_t* acc_spill, uint8_t* cur,
                 T* reg_deg, int32_t* counts, void* stream) {
  if (H <= 0 || W <= 0 || H > kMaxSide || W > kMaxSide ||
      static_cast<long long>(H) * W > INT_MAX || sy < 0 || sy >= H ||
      sx < 0 || sx >= W || list_cap < 1 || acc_cap < 1 || !seed_deg ||
      reinterpret_cast<uintptr_t>(cur) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long words =
      shared_mask ? 2 * ((static_cast<long long>(H) * W + 31) / 32) : 0;
  const long long bytes = 4 * (words + list_cap + acc_cap);
  if (bytes > kSmemMax - kWaveStatic) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (shared_mask) {
    static int allowed[kMaxDevices];
    err = allow_smem(grow_wave_kernel<T, true>, static_cast<int>(bytes), allowed);
    if (err != cudaSuccess) return err;
    grow_wave_kernel<T, true><<<1, kThreads, bytes, st>>>(
        sy, sx, seed_deg, thre_v, thre_p, free, deg, sn, cs, H, W, list_cap,
        acc_cap, list_spill, acc_spill, cur, reg_deg, counts);
  } else {
    static int allowed[kMaxDevices];
    err = allow_smem(grow_wave_kernel<T, false>, static_cast<int>(bytes), allowed);
    if (err != cudaSuccess) return err;
    grow_wave_kernel<T, false><<<1, kThreads, bytes, st>>>(
        sy, sx, seed_deg, thre_v, thre_p, free, deg, sn, cs, H, W, list_cap,
        acc_cap, list_spill, acc_spill, cur, reg_deg, counts);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The block size and shared-memory budget ops/grow.py's plans must use.
int32_t lsd_grow_threads() { return kThreads; }
int32_t lsd_grow_smem_max() { return kSmemMax; }
int32_t lsd_grow_wave_static() { return kWaveStatic; }

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
                              const float* cs, int H, int W, int shared_mask,
                              int qcap, int32_t* qy, int32_t* qx,
                              uint8_t* cur, float* reg_deg,
                              int32_t* counts, void* stream) {
  return grow<float>(sy, sx, thre_v, thre_p, ban, deg, sn, cs, H, W,
                     shared_mask, qcap, qy, qx, cur, reg_deg, counts,
                     stream);
}

cudaError_t lsd_grow_fifo_f64(int sy, int sx, double thre_v,
                              const double* thre_p, const uint8_t* ban,
                              const double* deg, const double* sn,
                              const double* cs, int H, int W, int shared_mask,
                              int qcap, int32_t* qy, int32_t* qx,
                              uint8_t* cur, double* reg_deg,
                              int32_t* counts, void* stream) {
  return grow<double>(sy, sx, thre_v, thre_p, ban, deg, sn, cs, H, W,
                      shared_mask, qcap, qy, qx, cur, reg_deg, counts,
                      stream);
}

// flag_words: the queue's slots / 32, rounded up; gflags: a global
// buffer of as many words when they do not fit beside cap shared slots
// (ops/grow.py:reduce_plan), else null.
cudaError_t lsd_radius_reducer_fifo_f32(int sx, int sy, float rad,
                                        int32_t* qy, int32_t* qx,
                                        int32_t* n_io, uint8_t* cur,
                                        uint8_t* fit, int W, int cap,
                                        int flag_words, uint32_t* gflags,
                                        void* stream) {
  return reduce<float>(sx, sy, rad, qy, qx, n_io, cur, fit, W, cap,
                       flag_words, gflags, stream);
}

// flag_words: the queue's slots / 32, rounded up; gflags: a global
// buffer of as many words when they do not fit beside cap shared slots
// (ops/grow.py:reduce_plan), else null.
cudaError_t lsd_radius_reducer_fifo_f64(int sx, int sy, double rad,
                                        int32_t* qy, int32_t* qx,
                                        int32_t* n_io, uint8_t* cur,
                                        uint8_t* fit, int W, int cap,
                                        int flag_words, uint32_t* gflags,
                                        void* stream) {
  return reduce<double>(sx, sy, rad, qy, qx, n_io, cur, fit, W, cap,
                       flag_words, gflags, stream);
}

// cur: the (H, W) uint8 mask, its allocation 16-byte aligned and rounded
// up to 16 bytes; list_spill / acc_spill: H * W entries each (a per-map
// queue buffer); shared_mask, list_cap, acc_cap: ops/grow.py:wave_plan.
cudaError_t lsd_grow_wave_f32(int sy, int sx, const float* seed_deg,
                              float thre_v, const float* thre_p,
                              const uint8_t* free, const float* deg,
                              const float* sn, const float* cs, int H, int W,
                              int shared_mask, int list_cap, int acc_cap,
                              int32_t* list_spill, int32_t* acc_spill,
                              uint8_t* cur, float* reg_deg, int32_t* counts,
                              void* stream) {
  return wave<float>(sy, sx, seed_deg, thre_v, thre_p, free, deg, sn, cs, H,
                     W, shared_mask, list_cap, acc_cap, list_spill, acc_spill,
                     cur, reg_deg, counts, stream);
}

cudaError_t lsd_grow_wave_f64(int sy, int sx, const double* seed_deg,
                              double thre_v, const double* thre_p,
                              const uint8_t* free, const double* deg,
                              const double* sn, const double* cs, int H,
                              int W, int shared_mask, int list_cap,
                              int acc_cap, int32_t* list_spill,
                              int32_t* acc_spill, uint8_t* cur,
                              double* reg_deg, int32_t* counts, void* stream) {
  return wave<double>(sy, sx, seed_deg, thre_v, thre_p, free, deg, sn, cs, H,
                      W, shared_mask, list_cap, acc_cap, list_spill,
                      acc_spill, cur, reg_deg, counts, stream);
}

}  // extern "C"
