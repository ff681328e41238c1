// K1: one fused block of BLOCK_ITERS Lucas-Kanade updates, points-major.
//
// Replaces velocity_tpu/ops/lk_block_pallas.py:lk_block (kernel body
// _make_kernel, sampler _sample_reduce), which runs the block for 128- or
// 1024-lane tiles of points with the slab in VMEM. Per update a point
// samples its destination slab at a fractional offset with a separable tap
// stencil (linear, or Catmull-Rom for the warped stage 3), reduces straight
// into s = sum(J * grad) without storing the sampled window, forms
// b = s - c with c = sum(I * grad) hoisted out of the loop, solves the 2x2
// system and applies the clip, stop, oscillation and bounds logic of
// velocity_tpu/ops/lk_lanes.py:block_iters_ref.
//
// What bounds it on an H100: the bytes first. At win 51, P 64 a point reads
// its 16 KB slab and 31 KB of window and gradients once, 48 MB for 1024
// points (14 us at 3.35 TB/s). The stencil's shared-memory reads come next
// (per strip of 11 rows: 12 x-pass rows of 2 taps when linear, 14 of 4
// when cubic), then the latency of five dependent reductions. The taps
// that weigh are ~27k multiply-adds per point and update at win 51 cubic,
// a few us at the f32 peak. At win 15 the kernel is latency: one round
// trip for the loads, then five short chains of stencil, shuffles, solve.
//
// What the design does about it:
// - Only the taps that weigh. A linear weight is non-zero on 2 taps,
//   floor(o) and floor(o)+1, a Catmull-Rom weight on 4, floor(o)-1 ..
//   floor(o)+2, of the clamped offset o; every other tap weighs exactly 0
//   (tests/test_torch_kernels.py holds this). The tap count is a template
//   constant, so the stencil loops unroll. At the upper clamp end the
//   window's last tap is the stencil's index nt: it gets weight 0, and what
//   it reads is inside the shared buffer (the next row's first floats, or
//   a zero pad past the slab), so a finite slab never yields 0 * NaN.
// - Register strips. A thread owns a strip of up to kR rows of one window
//   column. Its gradients stay in registers across the five updates. Per
//   update it runs the x-pass on the rows its y-taps reach (strip + K - 1
//   rows, read from the slab in shared memory) and keeps them in registers
//   for the y-pass, so there is no x-pass buffer and no barrier between
//   the passes.
// - Two block shapes. Windows up to 16 (the main path's win 15): one warp
//   per point, 4 points a block, strips of up to 8 rows (30 lanes at
//   win 15), reductions by warp shuffles only, no block barrier. Larger
//   windows (win 51): one 256-thread block per point, strips of up to 11
//   rows (255 strips at win 51), one barrier per reduction with
//   double-buffered scratch, at most 64 registers and 48 KB of shared
//   memory so that 4 blocks fit an SM: 528 resident blocks, 1024 points
//   in 1.94 waves.
// - Copies in flight at once. cp.async copies the slab to shared memory
//   while the gradients load and c reduces, and is awaited before the
//   first update. The block shape stages the three windows the same way,
//   ahead of the slab, and fills its registers from shared memory.
// - Masks are bytes (torch.bool) in and out. A point done on entry copies
//   through, and a point stops once done: its later updates change nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockIters = 5;   // velocity_tpu/ops/lk_lanes.py BLOCK_ITERS
constexpr float kReach = 3.0f;   // velocity_tpu/ops/lk_lanes.py REACH
constexpr int kMaxTaps = 32;
constexpr int kWarpRows = 8;     // strip height, one warp per point
constexpr int kWarpMaxWin = 16;  // win * ceil(win / kWarpRows) <= 32 lanes
constexpr int kWarpsPerBlock = 4;
constexpr int kBlockThreads = 256;  // one block per point
constexpr int kBlockRows = 11;      // strip height: 5 strips x 51 columns at win 51
constexpr int kBlocksPerSM = 4;
constexpr size_t kMaxSmem = 226 * 1024;  // 227 KB less the static scratch
// Zeros past each slab: the x-pass reads taps from its window's base
// without a clamp, and a weight-0 tap past the stencil (index nt, at the
// upper clamp end) can run up to 3 floats past the slab's last row.
constexpr int kPad = 4;

struct Args {
  const float* dpatch;  // (N, P, P)
  const float* Ip;      // (N, win, win)
  const float* gx;
  const float* gy;
  const float* a11;  // (N,) each
  const float* a12;
  const float* a22;
  const float* inv_det;
  const float* bx;
  const float* by;
  const unsigned char* trackable;  // (N,) bool
  const float* pts_in;             // (2, N)
  const unsigned char* done_in;    // (N,) bool
  const float* pd_in;              // (2, N)
  float* pts_out;
  unsigned char* done_out;
  float* pd_out;
  int P, win, it0, N, n_taps, nt;
  int slab_stride, win_stride;  // floats of shared memory per slab, per staged window
  float eps2, Wd, Hd;
};

__device__ __forceinline__ float w_linear(float a) {
  return fmaxf(0.0f, 1.0f - fabsf(a));
}

__device__ __forceinline__ float w_cubic(float a) {
  const float d = fabsf(a);
  const float w1 = (1.5f * d - 2.5f) * d * d + 1.0f;
  const float w2 = ((-0.5f * d + 2.5f) * d - 4.0f) * d + 2.0f;
  return d < 1.0f ? w1 : (d < 2.0f ? w2 : 0.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same bits (float add commutes)
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Start copying n floats from src to shared memory, threads i0, i0 +
// stride, ... sharing the work: 16-byte chunks, 4-byte copies for a head
// and tail off the 16-byte grid. `dst` is 16-byte aligned with room for
// n + 3 floats; the data lands at the returned address, which sits on the
// grid as src does.
__device__ __forceinline__ const float* copy_async(float* dst, const float* src, int n, int i0,
                                                   int stride) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* d = dst + mis;
  const int head = min((4 - mis) & 3, n);
  const int body = (n - head) & ~3;
  for (int i = head + 4 * i0; i < head + body; i += 4 * stride) cp_async16(d + i, src + i);
  if (i0 < head) cp_async4(d + i0, src + i0);
  if (i0 < n - head - body) cp_async4(d + head + body + i0, src + head + body + i0);
  return d;
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed copy groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A point's window cut into strips of R rows of one column: strip v covers
// column v % win, rows (v / win) * R .. + R (clipped to the window). R is
// the least height that lets `threads` strips cover the window, and at
// most max_rows; strips past `threads` are walked again by the same threads.
struct Strips {
  int R, count;
};

__host__ __device__ __forceinline__ Strips make_strips(int win, int threads, int max_rows) {
  int per_col = (win + max_rows - 1) / max_rows;
  const int fit = threads / win;
  if (fit > per_col) per_col = fit < win ? fit : win;
  const int R = (win + per_col - 1) / per_col;
  per_col = (win + R - 1) / R;
  return {R, win * per_col};
}

// A point's state, carried through the updates.
struct Point {
  float px, py, pdx, pdy;
  bool done, trk;
};

// What stays fixed for a point: its 2x2 system, its slab origin and c.
struct Consts {
  float v11, v12, v22, idet, bx, by, c1, c2;
};

__device__ __forceinline__ Point load_point(const Args& a, int n) {
  Point p;
  p.done = __ldg(a.done_in + n) != 0;
  p.trk = __ldg(a.trackable + n) != 0;
  p.px = __ldg(a.pts_in + n);
  p.py = __ldg(a.pts_in + a.N + n);
  p.pdx = __ldg(a.pd_in + n);
  p.pdy = __ldg(a.pd_in + a.N + n);
  return p;
}

__device__ __forceinline__ Consts load_consts(const Args& a, int n) {
  return {__ldg(a.a11 + n), __ldg(a.a12 + n), __ldg(a.a22 + n), __ldg(a.inv_det + n),
          __ldg(a.bx + n),  __ldg(a.by + n),  0.0f,              0.0f};
}

__device__ __forceinline__ void store_point(const Args& a, int n, const Point& p) {
  a.pts_out[n] = p.px;
  a.pts_out[a.N + n] = p.py;
  a.done_out[n] = p.done ? 1 : 0;
  a.pd_out[n] = p.pdx;
  a.pd_out[a.N + n] = p.pdy;
}

// The sampling window of one update: the clamp test (from the requested
// taps), the first tap that weighs and the K weights from there.
template <bool kCubic>
struct Window {
  static constexpr int K = kCubic ? 4 : 2;
  bool clamped;
  int bxi, byi;
  float wx[K], wy[K];

  __device__ __forceinline__ Window(const Args& a, const Point& p, float bx, float by) {
    const float half = (a.win - 1) * 0.5f;
    const float ox = p.px - half + bx;
    const float oy = p.py - half + by;
    const float lo = kCubic ? 1.0f : 0.0f;
    const float hi = kCubic ? (float)(a.n_taps - 2) : (float)(a.n_taps - 1);
    clamped = (ox < lo) || (ox > hi) || (oy < lo) || (oy > hi);
    // sampling clamps to the taps the slab can feed; fmaxf drops a NaN
    const float shi = fmaxf(kCubic ? (float)(a.nt - 2) : (float)(a.nt - 1), lo);
    const float oxc = fminf(fmaxf(ox, lo), shi);
    const float oyc = fminf(fmaxf(oy, lo), shi);
    bxi = (int)floorf(oxc) - (kCubic ? 1 : 0);
    byi = (int)floorf(oyc) - (kCubic ? 1 : 0);
#pragma unroll
    for (int t = 0; t < K; ++t) {
      // a tap past the stencil (index nt, at the upper clamp end) weighs 0
      const int ix = bxi + t, iy = byi + t;
      const float fx = oxc - (float)ix, fy = oyc - (float)iy;
      wx[t] = ix < a.nt ? (kCubic ? w_cubic(fx) : w_linear(fx)) : 0.0f;
      wy[t] = iy < a.nt ? (kCubic ? w_cubic(fy) : w_linear(fy)) : 0.0f;
    }
  }
};

// Gradients of one strip into registers (zero past the strip's nr rows),
// and its share of c = sum(I * grad); the windows are in memory or in
// shared memory.
template <int kR>
__device__ __forceinline__ void load_strip(const float* I, const float* gx, const float* gy,
                                           int win, int c, int r0, int nr, float (&g1)[kR],
                                           float (&g2)[kR], float& c1, float& c2) {
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    g1[k] = 0.0f;
    g2[k] = 0.0f;
    if (k < nr) {
      const int e = (r0 + k) * win + c;
      const float v = I[e];
      g1[k] = gx[e];
      g2[k] = gy[e];
      c1 = fmaf(v, g1[k], c1);
      c2 = fmaf(v, g2[k], c2);
    }
  }
}

// s += sum over the strip of J * grad, J sampled from the slab in shared
// memory: the x-pass over the strip's rows plus the K - 1 below (the rows
// its y-taps reach), each kept in a register for the K output rows it
// feeds. kCached: the gradients are g1/g2, else they are read from memory.
template <bool kCubic, int kR, bool kCached, int kG>
__device__ __forceinline__ void strip_dot(const Args& a, const float* slab, size_t base, int c,
                                          int r0, int nr, const Window<kCubic>& w,
                                          const float (&g1)[kG], const float (&g2)[kG],
                                          float& s1, float& s2) {
  constexpr int K = Window<kCubic>::K;
  const int P = a.P;
  const int c0 = c + w.bxi;  // a weight-0 tap may run past the row: see kPad
  float acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < kR + K - 1; ++k) {
    if (k < nr + K - 1) {
      const float* row = slab + min(r0 + w.byi + k, P - 1) * P + c0;
      float h = w.wx[0] * row[0];
#pragma unroll
      for (int t = 1; t < K; ++t) h = fmaf(w.wx[t], row[t], h);
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const int i = k - t;  // output row i takes tap t from x-pass row k
        if (i >= 0 && i < kR) acc[i] = fmaf(w.wy[t], h, acc[i]);
      }
      const int i = k - (K - 1);  // output row i is complete
      if (i >= 0 && i < nr) {
        float e1, e2;
        if constexpr (kCached) {
          e1 = g1[i];
          e2 = g2[i];
        } else {
          const size_t e = base + (size_t)(r0 + i) * a.win + c;
          e1 = __ldg(a.gx + e);
          e2 = __ldg(a.gy + e);
        }
        s1 = fmaf(acc[i], e1, s1);
        s2 = fmaf(acc[i], e2, s2);
      }
    }
  }
}

// The scalar update, run alike by every thread of the point on the same
// sums b = s - c; true once the point is done.
__device__ __forceinline__ bool update(const Args& a, Point& p, const Consts& q, bool clamped,
                                       float s1, float s2, int j) {
  const float half = (a.win - 1) * 0.5f;
  const float b1 = s1 - q.c1;
  const float b2 = s2 - q.c2;
  float dx = -(q.v22 * b1 - q.v12 * b2) * q.idet;
  float dy = -(q.v11 * b2 - q.v12 * b1) * q.idet;
  dx = fminf(fmaxf(dx, -kReach), kReach);
  dy = fminf(fmaxf(dy, -kReach), kReach);

  const float inx = floorf(p.px - half);
  const float iny = floorf(p.py - half);
  const bool in_ok = (inx >= -a.win) && (iny >= -a.win) && (inx < a.Wd) && (iny < a.Hd);
  const bool active = !p.done && p.trk && in_ok;
  if (active) {
    p.px += dx;
    p.py += dy;
  }
  const bool small = dx * dx + dy * dy <= a.eps2;
  const bool osc =
      (a.it0 + j > 0) && (fabsf(dx + p.pdx) < 0.01f) && (fabsf(dy + p.pdy) < 0.01f);
  if (active && osc && !clamped) {
    p.px -= dx * 0.5f;
    p.py -= dy * 0.5f;
  }
  p.done = p.done || ((small || osc) && !clamped) || !in_ok;
  if (active) {
    p.pdx = dx;
    p.pdy = dy;
  }
  return p.done;
}

// Start the copy of point n's slab into `dst` (the slab lands at the
// returned address) and zero the kPad floats past it, so that a weight-0
// tap running past the last row reads 0. One commit group.
__device__ __forceinline__ const float* start_slab(const Args& a, float* dst, int n, int i0,
                                                   int stride) {
  const int PP = a.P * a.P;
  float* slab = const_cast<float*>(copy_async(dst, a.dpatch + (size_t)n * PP, PP, i0, stride));
  if (i0 < kPad) slab[PP + i0] = 0.0f;
  copy_commit();
  return slab;
}

// Windows up to kWarpMaxWin: one warp per point, blockDim.x / 32 points a
// block, each warp with its own slab in shared memory. Every load starts
// before the done flag is known: the warp's time is latency, not bytes.
template <bool kCubic>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lk_block_warp(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= a.N) return;  // the ragged tail; no block barrier follows
  Point p = load_point(a, n);
  Consts q = load_consts(a, n);
  const float* slab = start_slab(a, smem + (size_t)warp * a.slab_stride, n, lane, 32);

  const Strips st = make_strips(a.win, 32, kWarpRows);
  const int c = lane % a.win;
  const int r0 = (lane / a.win) * st.R;
  const int nr = lane < st.count ? min(st.R, a.win - r0) : 0;
  const size_t base = (size_t)n * a.win * a.win;
  float g1[kWarpRows], g2[kWarpRows];
  load_strip<kWarpRows>(a.Ip + base, a.gx + base, a.gy + base, a.win, c, r0, nr, g1, g2, q.c1,
                        q.c2);
  copy_wait<0>();
  if (p.done) {
    if (lane == 0) store_point(a, n, p);
    return;
  }
  q.c1 = warp_sum(q.c1);
  q.c2 = warp_sum(q.c2);
  __syncwarp();  // the slab copies of every lane have landed

  for (int j = 0; j < kBlockIters; ++j) {
    const Window<kCubic> w(a, p, q.bx, q.by);
    float s1 = 0.0f, s2 = 0.0f;
    if (nr > 0) strip_dot<kCubic, kWarpRows, true>(a, slab, base, c, r0, nr, w, g1, g2, s1, s2);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (update(a, p, q, w.clamped, s1, s2, j)) break;
  }
  if (lane == 0) store_point(a, n, p);
}

// Sum of (x, y) over the block, returned to every thread. One barrier: the
// scratch alternates between two halves, and a thread writes a half only
// after the barrier of the other half, which every thread reaches after
// reading this half the time before.
__device__ __forceinline__ void block_sum2(float& x, float& y, float2 (*red)[32], int& buf) {
  x = warp_sum(x);
  y = warp_sum(y);
  if ((threadIdx.x & 31) == 0) red[buf][threadIdx.x >> 5] = make_float2(x, y);
  __syncthreads();
  x = 0.0f;
  y = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const float2 v = red[buf][w];
    x += v.x;
    y += v.y;
  }
  buf ^= 1;
}

// Larger windows: one block of kBlockThreads per point. kCached: every
// strip has a thread, whose gradients stay in registers (windows up to 51
// at kBlockRows 11); the windows are staged through shared memory by
// cp.async, ahead of the slab, so that every byte is in flight at once.
// Otherwise the threads walk the strips and read the gradients from memory
// in each update. The point's constants live in shared memory, read after
// each barrier, which keeps the cached kernel within its 64 registers.
template <bool kCubic, bool kCached>
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSM)
lk_block_point(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float2 red[2][32];
  __shared__ Consts q;
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  Point p = load_point(a, n);
  if (p.done) {  // the block's bytes are not read for a done point
    if (tid == 0) store_point(a, n, p);
    return;
  }
  const int ww = a.win * a.win;
  const size_t base = (size_t)n * ww;
  const float *I = a.Ip + base, *gx = a.gx + base, *gy = a.gy + base;
  if constexpr (kCached) {  // one commit group: the three windows
    float* wbuf = smem + a.slab_stride;
    I = copy_async(wbuf, I, ww, tid, kBlockThreads);
    gx = copy_async(wbuf + a.win_stride, gx, ww, tid, kBlockThreads);
    gy = copy_async(wbuf + 2 * a.win_stride, gy, ww, tid, kBlockThreads);
    copy_commit();
  }
  const float* slab = start_slab(a, smem, n, tid, kBlockThreads);
  if (tid == 0) q = load_consts(a, n);

  const Strips st = make_strips(a.win, kBlockThreads, kBlockRows);
  const int c = tid % a.win;
  const int r0 = (tid / a.win) * st.R;
  const int nr = tid < st.count ? min(st.R, a.win - r0) : 0;
  float g1[kCached ? kBlockRows : 1], g2[kCached ? kBlockRows : 1];
  float c1 = 0.0f, c2 = 0.0f;
  if constexpr (kCached) {
    copy_wait<1>();  // the windows; the slab may still be in flight
    __syncthreads();
    load_strip<kBlockRows>(I, gx, gy, a.win, c, r0, nr, g1, g2, c1, c2);
  } else {
    for (int v = tid; v < st.count; v += kBlockThreads) {
      const int cv = v % a.win, rv = (v / a.win) * st.R, nv = min(st.R, a.win - rv);
      for (int k = 0; k < nv; ++k) {
        const int e = (rv + k) * a.win + cv;
        c1 = fmaf(__ldg(I + e), __ldg(gx + e), c1);
        c2 = fmaf(__ldg(I + e), __ldg(gy + e), c2);
      }
    }
  }
  copy_wait<0>();
  int buf = 0;
  block_sum2(c1, c2, red, buf);  // its barrier also publishes the slab and q
  if (tid == 0) {  // read by all after the next barrier
    q.c1 = c1;
    q.c2 = c2;
  }

  for (int j = 0; j < kBlockIters; ++j) {
    const Window<kCubic> w(a, p, q.bx, q.by);
    float s1 = 0.0f, s2 = 0.0f;
    if constexpr (kCached) {
      if (nr > 0)
        strip_dot<kCubic, kBlockRows, true>(a, slab, base, c, r0, nr, w, g1, g2, s1, s2);
    } else {
      for (int v = tid; v < st.count; v += kBlockThreads) {
        const int cv = v % a.win, rv = (v / a.win) * st.R, nv = min(st.R, a.win - rv);
        strip_dot<kCubic, kBlockRows, false>(a, slab, base, cv, rv, nv, w, g1, g2, s1, s2);
      }
    }
    block_sum2(s1, s2, red, buf);
    if (update(a, p, q, w.clamped, s1, s2, j)) break;
  }
  if (tid == 0) store_point(a, n, p);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem + 1024 <= 48 * 1024) return cudaSuccess;  // static shared memory included
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool kCubic>
int launch(Args& a, cudaStream_t stream) {
  const size_t slab_bytes = sizeof(float) * a.slab_stride;
  cudaError_t err;
  if (a.win <= kWarpMaxWin) {
    int per_block = (int)(kMaxSmem / slab_bytes);
    if (per_block < 1) return (int)cudaErrorInvalidValue;
    if (per_block > kWarpsPerBlock) per_block = kWarpsPerBlock;
    const size_t smem = slab_bytes * per_block;
    if ((err = set_smem(lk_block_warp<kCubic>, smem)) != cudaSuccess) return (int)err;
    lk_block_warp<kCubic><<<(a.N + per_block - 1) / per_block, 32 * per_block, smem, stream>>>(a);
  } else if (make_strips(a.win, kBlockThreads, kBlockRows).count <= kBlockThreads &&
             slab_bytes + 3 * sizeof(float) * a.win_stride <= kMaxSmem) {
    const size_t smem = slab_bytes + 3 * sizeof(float) * a.win_stride;
    if ((err = set_smem(lk_block_point<kCubic, true>, smem)) != cudaSuccess) return (int)err;
    lk_block_point<kCubic, true><<<a.N, kBlockThreads, smem, stream>>>(a);
  } else {  // many strips, or a slab too large to stage the windows beside it
    if ((err = set_smem(lk_block_point<kCubic, false>, slab_bytes)) != cudaSuccess) return (int)err;
    lk_block_point<kCubic, false><<<a.N, kBlockThreads, slab_bytes, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vt_lk_block(const float* dpatch, int P, const float* Ip,
                           const float* gxp, const float* gyp, int win,
                           const float* a11, const float* a12, const float* a22,
                           const float* inv_det, const float* bx, const float* by,
                           const unsigned char* trackable, const float* pts_in,
                           const unsigned char* done_in, const float* pd_in, int it0, int N,
                           int n_taps, int cubic, float eps2, int Wd, int Hd,
                           float* pts_out, unsigned char* done_out, float* pd_out,
                           cudaStream_t stream) {
  if (N <= 0) return 0;
  const int nt = n_taps < P - win + 1 ? n_taps : P - win + 1;  // taps the slab can feed
  if (win < 1 || nt < 1 || nt > kMaxTaps) return (int)cudaErrorInvalidValue;
  Args a{dpatch, Ip, gxp, gyp, a11, a12, a22, inv_det, bx, by, trackable, pts_in, done_in,
         pd_in, pts_out, done_out, pd_out, P, win, it0, N, n_taps, nt,
         (P * P + 3 + kPad + 3) / 4 * 4, (win * win + 3 + 3) / 4 * 4, eps2, (float)Wd,
         (float)Hd};
  return cubic ? launch<true>(a, stream) : launch<false>(a, stream);
}
