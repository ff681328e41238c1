// K4: cv2.cornerSubPix's refinement loop, every iteration of every point on
// the card, in one launch.
//
// Replaces no TPU kernel. The JAX package runs the loop as a
// lax.while_loop (velocity_tpu/ops/harris.py:193) that XLA keeps on the
// device. The port's eager loop (ops/harris.py:subpix_loop_ref, kept as
// K4's plain twin) dispatches about 350 small kernels an iteration, 15 taps
// x 2 passes of them the resample alone, and reads the host once an
// iteration to stop early: some 35,000 launches and 100 reads at frame-0
// init and at each re-seeding, where the card sits idle. K4 was added to
// remove both.
//
// What bounds it on an H100: neither bytes nor operations. A call reads
// N (Q, Q) float32 slabs (1,020 x 27 x 27, 3 MB: 0.9 us at 3.35 TB/s) and
// does about 4,400 operations a point and iteration (0.1 GFLOP for the
// ~22,000 point-iterations of a frame-0 init: 1.5 us at 67 TFLOP/s). The
// time is the latency of each point's chain of up to max_iters dependent
// iterations: a resample, the gradients, five reductions and a 2x2 solve
// each, all in one warp (0.2 ms at max_iters 100, about 2 us an iteration).
//
// What the design does about it:
// - One warp per point, 4 points a block, the slab in shared memory (2.9 KB
//   a point at Q 27) beside the resampled patch and the window's 1-D
//   Gaussian. Every lane runs the same scalar loop on the same sums, so the
//   warp never diverges and needs no block barrier.
// - Each point runs its own loop until it is done (moved^2 < eps^2,
//   |det| <= 16 FLT_MIN, a drift past half_win + 1 from the seed) or
//   reaches max_iters, the plain loop's per-point rules; there is no host
//   read and no test across points. A point that stops early leaves the
//   plain loop's later iterations, which would not move it, undone.
// - The resample keeps the plain version's bits. Of the linear stencil's
//   n_taps taps only floor(o) and floor(o) + 1 weigh (the others weigh
//   exactly 0 and add exactly 0 to a sum of products of finite pixels), and
//   those two are evaluated in the plain version's order, with every
//   product and sum rounded as it rounds them (no contraction into FMAs).
// - The gradients and the element products of the five Gaussian-weighted
//   sums round as the plain version's do too; the sums themselves run in
//   another order (a lane's strided partial sums, then a butterfly), so a
//   point may differ from the plain version in the last bits of its step.
// - The launch is checked with cudaGetLastError and returned to the caller.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr size_t kMaxSmem = 48 * 1024;  // no opt-in: a few KB a point

struct Args {
  const float* slabs;  // (N, Q, Q), row-major
  const int* corners;  // (N, 2) xy: each slab's (clamped) image corner
  const float* seeds;  // (N, 2) xy
  float* out;          // (N, 2) xy
  int* iters;          // (N,) iterations each point ran
  int N, Q, half_win, max_iters;
  int stride;  // floats of shared memory a point
  float eps2;
};

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same bits (float add commutes)
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The linear stencil's weight of tap t at offset o: max(0, 1 - |o - t|)
__device__ __forceinline__ float w_linear(float o, int t) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(o, (float)t))));
}

// One stencil row: w0 * row[0] + w1 * row[1], the second tap only where
// the slab feeds it, each product and the sum rounded.
__device__ __forceinline__ float tap2(const float* row, float w0, float w1, bool two) {
  const float h = __fmul_rn(w0, row[0]);
  return two ? __fadd_rn(h, __fmul_rn(w1, row[1])) : h;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32) corner_subpix_warp(const Args a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= a.N) return;  // the ragged tail; no block barrier follows

  const int hw = a.half_win;
  const int W = 2 * hw + 1;  // the window
  const int G = W + 2;       // the patch: the window and a ring for the differences
  const int Q = a.Q;
  const int nt = Q - G + 1;  // taps the slab feeds
  float* slab = smem + (size_t)warp * a.stride;
  float* patch = slab + Q * Q;
  float* m1d = patch + G * G;

  const float* src = a.slabs + (size_t)n * Q * Q;
  for (int i = lane; i < Q * Q; i += 32) slab[i] = __ldg(src + i);
  // exp(-(off^2) * coef), coef rounded to float32 as the plain version's
  const float coef = (float)(1.0 / ((double)hw * hw));
  for (int i = lane; i < W; i += 32) {
    const float off = (float)(i - hw);
    m1d[i] = expf(__fmul_rn(-__fmul_rn(off, off), coef));
  }
  const float px = __ldg(a.seeds + 2 * n), py = __ldg(a.seeds + 2 * n + 1);
  const float clx = (float)__ldg(a.corners + 2 * n), cly = (float)__ldg(a.corners + 2 * n + 1);
  const float gh = (G - 1) * 0.5f;
  const float hi = (float)(nt - 1);
  const float drift = (float)(hw + 1);
  const float tiny16 = 16.0f * FLT_MIN;
  __syncwarp();

  float qx = px, qy = py;
  int it = 0;
  while (it < a.max_iters) {
    ++it;
    // the patch's fractional corner in the slab, clamped to the stencil
    const float ox = fminf(fmaxf(__fsub_rn(__fsub_rn(qx, gh), clx), 0.0f), hi);
    const float oy = fminf(fmaxf(__fsub_rn(__fsub_rn(qy, gh), cly), 0.0f), hi);
    const int tx = (int)floorf(ox), ty = (int)floorf(oy);
    const bool x2 = tx + 1 < nt, y2 = ty + 1 < nt;
    const float wx0 = w_linear(ox, tx), wx1 = x2 ? w_linear(ox, tx + 1) : 0.0f;
    const float wy0 = w_linear(oy, ty), wy1 = y2 ? w_linear(oy, ty + 1) : 0.0f;

    // resample the (G, G) patch: the x-pass on the two rows an output takes,
    // then the y-pass; element e = (i, c) walked with carries
    for (int e = lane, i = lane / G, c = lane % G; e < G * G; e += 32) {
      const float* row = slab + (ty + i) * Q + tx + c;
      float v = __fmul_rn(wy0, tap2(row, wx0, wx1, x2));
      if (y2) v = __fadd_rn(v, __fmul_rn(wy1, tap2(row + Q, wx0, wx1, x2)));
      patch[e] = v;
      c += 32;
      while (c >= G) {
        c -= G;
        ++i;
      }
    }
    __syncwarp();

    // central differences and the five Gaussian-weighted sums over (W, W)
    float sxx = 0.0f, sxy = 0.0f, syy = 0.0f, sbx = 0.0f, sby = 0.0f;
    for (int e = lane, i = lane / W, j = lane % W; e < W * W; e += 32) {
      const float* p = patch + (i + 1) * G + j + 1;
      const float gx = __fmul_rn(__fsub_rn(p[1], p[-1]), 0.5f);
      const float gy = __fmul_rn(__fsub_rn(p[G], p[-G]), 0.5f);
      const float m = __fmul_rn(m1d[i], m1d[j]);
      const float offx = (float)(j - hw), offy = (float)(i - hw);
      const float xx = __fmul_rn(gx, gx), xy = __fmul_rn(gx, gy), yy = __fmul_rn(gy, gy);
      sxx = __fadd_rn(sxx, __fmul_rn(xx, m));
      sxy = __fadd_rn(sxy, __fmul_rn(xy, m));
      syy = __fadd_rn(syy, __fmul_rn(yy, m));
      sbx = __fadd_rn(sbx, __fmul_rn(__fadd_rn(__fmul_rn(xx, offx), __fmul_rn(xy, offy)), m));
      sby = __fadd_rn(sby, __fmul_rn(__fadd_rn(__fmul_rn(xy, offx), __fmul_rn(yy, offy)), m));
      j += 32;
      while (j >= W) {
        j -= W;
        ++i;
      }
    }
    __syncwarp();  // every lane has read the patch before the next resample
    sxx = warp_sum(sxx);
    sxy = warp_sum(sxy);
    syy = warp_sum(syy);
    sbx = warp_sum(sbx);
    sby = warp_sum(sby);

    // the 2x2 solve, in every lane alike
    const float det = __fsub_rn(__fmul_rn(sxx, syy), __fmul_rn(sxy, sxy));
    const bool safe = fabsf(det) > tiny16;
    const float inv = safe ? 1.0f / det : 0.0f;
    const float dx = __fmul_rn(__fsub_rn(__fmul_rn(syy, sbx), __fmul_rn(sxy, sby)), inv);
    const float dy = __fmul_rn(__fsub_rn(__fmul_rn(sxx, sby), __fmul_rn(sxy, sbx)), inv);
    if (safe) {
      qx = __fadd_rn(qx, dx);
      qy = __fadd_rn(qy, dy);
    }
    const float moved2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    // cv2 bails out once the point drifts out of the window
    const bool out = fabsf(__fsub_rn(qx, px)) > drift || fabsf(__fsub_rn(qy, py)) > drift;
    if (moved2 < a.eps2 || !safe || out) break;
  }
  if (lane == 0) {
    a.out[2 * n] = qx;
    a.out[2 * n + 1] = qy;
    a.iters[n] = it;
  }
}

}  // namespace

extern "C" int vt_corner_subpix(const float* slabs, int Q, const int* corners,
                                const float* seeds, int N, int half_win, int max_iters,
                                float eps2, float* out, int* iters, cudaStream_t stream) {
  if (N <= 0) return 0;
  const int G = 2 * half_win + 3;
  if (half_win < 1 || Q < G || max_iters < 0) return (int)cudaErrorInvalidValue;
  const int stride = Q * Q + G * G + (G - 2);
  int per_block = (int)(kMaxSmem / (sizeof(float) * stride));
  if (per_block < 1) return (int)cudaErrorInvalidValue;
  if (per_block > kWarpsPerBlock) per_block = kWarpsPerBlock;
  const Args a{slabs, corners, seeds, out, iters, N, Q, half_win, max_iters, stride, eps2};
  const size_t smem = sizeof(float) * stride * per_block;
  corner_subpix_warp<<<(N + per_block - 1) / per_block, 32 * per_block, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
