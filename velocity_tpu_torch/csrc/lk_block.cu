// K1: one fused block of BLOCK_ITERS Lucas-Kanade updates, points-major.
//
// Replaces velocity_tpu/ops/lk_block_pallas.py:lk_block (kernel body
// _make_kernel, sampler _sample_reduce), which runs the block for 128- or
// 1024-lane tiles of points with the slab in VMEM. Here one thread block
// owns one point. Per update it samples the destination slab at the point's
// fractional offset with the two-pass tap stencil (linear or Catmull-Rom
// weights), reduces straight into s = sum(J * grad) without storing the
// sampled window, forms b = s - c with c = sum(I * grad) hoisted out of the
// loop, solves the 2x2 system and applies the same clip, stop, oscillation
// and bounds logic as velocity_tpu/ops/lk_lanes.py:block_iters_ref.
//
// What bounds it: not FLOPs (~62k FMA per point-update at win 51 with 10
// taps, ~0.32 GFMA per 1024-point launch) and not bytes (the 16 KB slab at
// P=64 and the 31 KB of window and gradients per point are read once per
// launch, ~48 MB in all) but latency: five
// dependent updates, each a block-wide reduction followed by a scalar solve
// that every thread needs before the next update. The design keeps that
// chain on chip: the slab and the x-pass rows live in shared memory (29 KB
// at win 51, P 64), the gradient windows are re-read through L1, partial
// sums reduce with warp shuffles, and every thread computes the scalar
// update itself from the broadcast sums, so no extra barrier is needed for
// it. 1024 independent points fill the 132 SMs several blocks deep.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockIters = 5;   // velocity_tpu/ops/lk_lanes.py BLOCK_ITERS
constexpr float kReach = 3.0f;   // velocity_tpu/ops/lk_lanes.py REACH
constexpr int kThreads = 256;
constexpr int kMaxTaps = 32;

__device__ __forceinline__ float w_linear(float a) {
  return fmaxf(0.0f, 1.0f - fabsf(a));
}

__device__ __forceinline__ float w_cubic(float a) {
  const float d = fabsf(a);
  const float w1 = (1.5f * d - 2.5f) * d * d + 1.0f;
  const float w2 = ((-0.5f * d + 2.5f) * d - 4.0f) * d + 2.0f;
  return d < 1.0f ? w1 : (d < 2.0f ? w2 : 0.0f);
}

// Sum of (a, b) over the thread block, returned to every thread.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // scratch may still be read from the previous call
  if (lane == 0) {
    scratch[warp] = a;
    scratch[32 + warp] = b;
  }
  __syncthreads();
  a = 0.0f;
  b = 0.0f;
  for (int w = 0; w < nwarps; ++w) {
    a += scratch[w];
    b += scratch[32 + w];
  }
}

template <bool kCubic>
__global__ void __launch_bounds__(kThreads)
lk_block_kernel(const float* __restrict__ dpatch, int P,
                const float* __restrict__ Ip, const float* __restrict__ gxp,
                const float* __restrict__ gyp, int win,
                const float* __restrict__ a11, const float* __restrict__ a12,
                const float* __restrict__ a22, const float* __restrict__ inv_det,
                const float* __restrict__ bx, const float* __restrict__ by,
                const float* __restrict__ trackable,
                const float* __restrict__ pts_in, const float* __restrict__ done_in,
                const float* __restrict__ pd_in, int it0, int N, int n_taps,
                float eps2, float Wd, float Hd, float* __restrict__ pts_out,
                float* __restrict__ done_out, float* __restrict__ pd_out) {
  extern __shared__ float smem[];
  float* patch = smem;           // P * P destination slab
  float* hrow = smem + P * P;    // (win + nt - 1) * win x-pass rows
  __shared__ float wx[kMaxTaps];
  __shared__ float wy[kMaxTaps];
  __shared__ float scratch[64];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = min(n_taps, P - win + 1);  // taps the slab can feed
  const int rows = win + nt - 1;
  const int ww = win * win;
  // clamp range of the sampling offsets (from the taps actually used) and
  // of the `clamped` test (from the requested taps), as in block_iters_ref
  const float slo = kCubic ? 1.0f : 0.0f;
  const float shi = fmaxf(kCubic ? (float)(nt - 2) : (float)(nt - 1), slo);
  const float lo = kCubic ? 1.0f : 0.0f;
  const float hi = kCubic ? (float)(n_taps - 2) : (float)(n_taps - 1);

  const float* dp = dpatch + (size_t)n * P * P;
  for (int e = tid; e < P * P; e += blockDim.x) patch[e] = dp[e];

  const float* I = Ip + (size_t)n * ww;
  const float* gx = gxp + (size_t)n * ww;
  const float* gy = gyp + (size_t)n * ww;
  float c1 = 0.0f, c2 = 0.0f;
  for (int e = tid; e < ww; e += blockDim.x) {
    const float v = I[e];
    c1 += v * gx[e];
    c2 += v * gy[e];
  }
  block_sum2(c1, c2, scratch);

  const float half = (win - 1) * 0.5f;
  float px = pts_in[n], py = pts_in[N + n];
  float pdx = pd_in[n], pdy = pd_in[N + n];
  bool done = done_in[n] > 0.5f;
  const bool trk = trackable[n] > 0.5f;
  const float v11 = a11[n], v12 = a12[n], v22 = a22[n], idet = inv_det[n];
  const float bxv = bx[n], byv = by[n];

  for (int j = 0; j < kBlockIters; ++j) {
    const float ox = px - half + bxv;
    const float oy = py - half + byv;
    const bool clamped = (ox < lo) || (ox > hi) || (oy < lo) || (oy > hi);
    const float oxc = fminf(fmaxf(ox, slo), shi);
    const float oyc = fminf(fmaxf(oy, slo), shi);
    if (tid < nt) {
      wx[tid] = kCubic ? w_cubic(oxc - tid) : w_linear(oxc - tid);
      wy[tid] = kCubic ? w_cubic(oyc - tid) : w_linear(oyc - tid);
    }
    __syncthreads();  // weights (and, on j == 0, the slab) are visible
    for (int e = tid; e < rows * win; e += blockDim.x) {
      const int r = e / win;
      const int c = e - r * win;
      const float* src = patch + r * P + c;
      float acc = 0.0f;
      for (int t = 0; t < nt; ++t) acc += wx[t] * src[t];
      hrow[e] = acc;
    }
    __syncthreads();
    float s1 = 0.0f, s2 = 0.0f;
    for (int e = tid; e < ww; e += blockDim.x) {
      const int i = e / win;
      const int c = e - i * win;
      const float* h = hrow + i * win + c;
      float jv = 0.0f;
      for (int t = 0; t < nt; ++t) jv += wy[t] * h[t * win];
      s1 += jv * gx[e];
      s2 += jv * gy[e];
    }
    block_sum2(s1, s2, scratch);

    // every thread runs the scalar update on the same sums
    const float b1 = s1 - c1;
    const float b2 = s2 - c2;
    float dx = -(v22 * b1 - v12 * b2) * idet;
    float dy = -(v11 * b2 - v12 * b1) * idet;
    dx = fminf(fmaxf(dx, -kReach), kReach);
    dy = fminf(fmaxf(dy, -kReach), kReach);

    const float inx = floorf(px - half);
    const float iny = floorf(py - half);
    const bool in_ok = (inx >= -win) && (iny >= -win) && (inx < Wd) && (iny < Hd);
    const bool active = !done && trk && in_ok;
    if (active) {
      px += dx;
      py += dy;
    }
    const bool small = dx * dx + dy * dy <= eps2;
    const bool osc = (it0 + j > 0) && (fabsf(dx + pdx) < 0.01f) && (fabsf(dy + pdy) < 0.01f);
    if (active && osc && !clamped) {
      px -= dx * 0.5f;
      py -= dy * 0.5f;
    }
    done = done || ((small || osc) && !clamped) || !in_ok;
    if (active) {
      pdx = dx;
      pdy = dy;
    }
  }
  if (tid == 0) {
    pts_out[n] = px;
    pts_out[N + n] = py;
    done_out[n] = done ? 1.0f : 0.0f;
    pd_out[n] = pdx;
    pd_out[N + n] = pdy;
  }
}

template <bool kCubic>
int launch(const float* dpatch, int P, const float* Ip, const float* gxp,
           const float* gyp, int win, const float* a11, const float* a12,
           const float* a22, const float* inv_det, const float* bx,
           const float* by, const float* trackable, const float* pts_in,
           const float* done_in, const float* pd_in, int it0, int N, int n_taps,
           float eps2, int Wd, int Hd, float* pts_out, float* done_out,
           float* pd_out, cudaStream_t stream) {
  const int nt = n_taps < P - win + 1 ? n_taps : P - win + 1;
  if (nt < 1 || nt > kMaxTaps) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)P * P + (size_t)(win + nt - 1) * win);
  cudaError_t err = cudaFuncSetAttribute(
      lk_block_kernel<kCubic>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lk_block_kernel<kCubic><<<N, kThreads, smem, stream>>>(
      dpatch, P, Ip, gxp, gyp, win, a11, a12, a22, inv_det, bx, by, trackable,
      pts_in, done_in, pd_in, it0, N, n_taps, eps2, (float)Wd, (float)Hd,
      pts_out, done_out, pd_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vt_lk_block(const float* dpatch, int P, const float* Ip,
                           const float* gxp, const float* gyp, int win,
                           const float* a11, const float* a12, const float* a22,
                           const float* inv_det, const float* bx, const float* by,
                           const float* trackable, const float* pts_in,
                           const float* done_in, const float* pd_in, int it0, int N,
                           int n_taps, int cubic, float eps2, int Wd, int Hd,
                           float* pts_out, float* done_out, float* pd_out,
                           cudaStream_t stream) {
  if (N <= 0) return 0;
  if (cubic)
    return launch<true>(dpatch, P, Ip, gxp, gyp, win, a11, a12, a22, inv_det, bx,
                        by, trackable, pts_in, done_in, pd_in, it0, N, n_taps, eps2,
                        Wd, Hd, pts_out, done_out, pd_out, stream);
  return launch<false>(dpatch, P, Ip, gxp, gyp, win, a11, a12, a22, inv_det, bx,
                       by, trackable, pts_in, done_in, pd_in, it0, N, n_taps, eps2,
                       Wd, Hd, pts_out, done_out, pd_out, stream);
}
