// K5: stage 3's affine-warped windows (ops/lk_lanes.py:_extract_warped_lanes),
// every point's (P, P) patch in one launch.
//
// Replaces no TPU kernel. The JAX package writes this function in jnp
// (velocity_tpu/ops/lk_lanes.py:_extract_warped_lanes) and leaves it to
// XLA's fusion, which keeps the per-pixel weights out of memory. The port's
// eager form (_extract_warped_lanes_ref, kept as K5's plain twin) runs about
// 110 full-grid kernels a call: 8 taps x 2 passes of subtract, abs, 1 - x,
// clamp, multiply and add over (N, Q, P) and (N, P, P) grids, the grids of
// the positions, ~20 small kernels of the corners and a K2 launch. A frame
// step calls it 7 times (6 forward blocks, the backward leg's source).
//
// What bounds it on an H100: the bytes it must write. A call writes N
// (P, P) float32 patches and the (2, N) corner: 16.8 MB at N 1024, P 64,
// 5 us at 3.35 TB/s. The N (Q, Q) windows it reads overlap and sit in L2
// (the padded level-0 image is ~10 MB); the arithmetic, about 56
// instructions an output word of each pass (8 taps of weight, product and
// sum; 0.5 G a call), is ~15 us of the card's 33 T float32 instructions a
// second, so instructions weigh about as much as the bytes. Measured on an
// H100 (700 W): 0.038 ms a call at N 1024, P 64, Q 72.
//
// What the design does about it:
// - One block per point. It computes its own map terms, integer corner
//   (clamped into the image as K2 clamps it) and slab offsets, stages its
//   (Q, Q) window from the padded image into shared memory with coalesced
//   row loads, runs the x-pass into a (Q, P) tile in shared memory, then the
//   y-pass, and writes its (P, P) patch once, coalesced. Nothing between the
//   image and the patch goes to device memory: 39 KB of shared memory a
//   block at P 64 / Q 72, five blocks an SM.
// - The bits are the plain form's. Each position is formed in the plain
//   form's order of operations, each tap's weight is max(0, 1 - |e - t|)
//   after the same NaN-keeping clamp, and every tap of the 8 is multiplied
//   and added in order, each product and sum rounded alone (__fmul_rn,
//   __fadd_rn: no FMA contraction). Taps that weigh 0 still add their +-0,
//   so even the sign of a zero is the plain form's.
// - A stack of V equal-sized images (V, H, W) takes the same launch: point n
//   reads image n / (N / V), lane-major as the lanes engine lays out a batch.
//   A map stride of 0 serves one shared (2, 3) map; 6 one map per point.
// - The launch is checked with cudaGetLastError and returned to the caller.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTaps = 8;  // WARP_TAPS of ops/lk_lanes.py
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

struct Args {
  const float* img;  // (V, H, W) row-major, edge-padded by `pad`
  int H, W, n_per_image;
  const float* centers;  // (2, N): x at centers[n * cs1], y at centers[cs0 + n * cs1]
  long long cs0, cs1;
  const float* maps;  // (2, 3) row-major, one shared (map_stride 0) or one per point (6)
  int map_stride;
  int N, P, Q, oo, pad;
  float* out;     // (N, P, P)
  float* corner;  // (2, N)
};

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// _w_linear(e - t) = clamp(1 - |e - t|, min=0), NaN kept
__device__ __forceinline__ float w_linear(float e, int t) {
  const float v = __fsub_rn(1.0f, fabsf(__fsub_rn(e, (float)t)));
  return v != v ? v : fmaxf(v, 0.0f);
}

// The 8-tap stencil along a row (step 1) or a column (step P) of `src`:
// w(e - 0) * src[0] + w(e - 1) * src[step] + ..., in order, each rounded.
__device__ __forceinline__ float taps(const float* src, int step, float e) {
  float acc = __fmul_rn(w_linear(e, 0), src[0]);
#pragma unroll
  for (int t = 1; t < kTaps; ++t) acc = __fadd_rn(acc, __fmul_rn(w_linear(e, t), src[t * step]));
  return acc;
}

// floor(v) as int32, as torch's floor then .to(int32) gives it (saturating,
// NaN to 0), then + add in int32 with wrap-around
__device__ __forceinline__ int floor_plus(float v, int add) {
  return (int)((unsigned)(int)floorf(v) + (unsigned)add);
}

__global__ void __launch_bounds__(kThreads) warp_window(const Args a) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int P = a.P, Q = a.Q, W = a.W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* slab = smem;       // (Q, Q)
  float* hx = smem + Q * Q;  // (Q, P): the x-pass

  // the point's map terms, in the plain form's order (every thread alike)
  const float* M = a.maps + (long long)n * a.map_stride;
  const float m00 = __ldg(M), m01 = __ldg(M + 1), m02 = __ldg(M + 2);
  const float m10 = __ldg(M + 3), m11 = __ldg(M + 4), m12 = __ldg(M + 5);
  const float cx = __ldg(a.centers + n * a.cs1), cy = __ldg(a.centers + a.cs0 + n * a.cs1);
  const float base_x = __fadd_rn(__fadd_rn(__fmul_rn(m00, cx), __fmul_rn(m01, cy)), m02);
  const float base_y = __fadd_rn(__fadd_rn(__fmul_rn(m10, cx), __fmul_rn(m11, cy)), m12);
  const int shift = a.pad - a.oo - (kTaps / 2 - 1);
  const int kx = min(max(floor_plus(base_x, shift), 0), W - Q);  // K2's clamp
  const int ky = min(max(floor_plus(base_y, shift), 0), a.H - Q);
  const float bx_s = __fsub_rn(__fadd_rn(base_x, (float)a.pad), (float)kx);
  const float by_s = __fsub_rn(__fadd_rn(base_y, (float)a.pad), (float)ky);
  // near-identity precondition: the x-pass solves the dest row through m11
  const float inv_m11 = fabsf(m11) > 1e-3f ? __fdiv_rn(1.0f, m11) : 1.0f;
  const float k01 = __fmul_rn(m01, inv_m11);

  const float* src = a.img + (long long)(n / a.n_per_image) * a.H * W + (long long)ky * W + kx;
  for (int r = warp; r < Q; r += kWarps)
    for (int c = lane; c < Q; c += 32) slab[r * Q + c] = __ldg(src + (long long)r * W + c);
  __syncthreads();

  // x-pass: slab row y at dest column j, position
  // ((bx_s + m00 joff) + k01 ((y - by_s) - m10 joff)) - j
  for (int y = warp; y < Q; y += kWarps) {
    const float dy = __fsub_rn((float)y, by_s);
    for (int j = lane; j < P; j += 32) {
      const float joff = (float)(j - a.oo);
      const float t1 = __fadd_rn(bx_s, __fmul_rn(m00, joff));
      const float t5 = __fsub_rn(dy, __fmul_rn(m10, joff));
      const float ex = __fsub_rn(__fadd_rn(t1, __fmul_rn(k01, t5)), (float)j);
      hx[y * P + j] = taps(slab + y * Q + j, 1, clamp_keep_nan(ex, 0.0f, kTaps - 1.0f));
    }
  }
  __syncthreads();

  // y-pass: dest (i, j), position ((by_s + m10 joff) + m11 ioff) - i
  float* o = a.out + (long long)n * P * P;
  for (int i = warp; i < P; i += kWarps) {
    const float ioff = (float)(i - a.oo);
    for (int j = lane; j < P; j += 32) {
      const float joff = (float)(j - a.oo);
      const float u = __fadd_rn(__fadd_rn(by_s, __fmul_rn(m10, joff)), __fmul_rn(m11, ioff));
      const float ey = __fsub_rn(u, (float)i);
      o[i * P + j] = taps(hx + i * P + j, P, clamp_keep_nan(ey, 0.0f, kTaps - 1.0f));
    }
  }
  if (threadIdx.x == 0) {
    a.corner[n] = __fsub_rn(cx, (float)a.oo);
    a.corner[a.N + n] = __fsub_rn(cy, (float)a.oo);
  }
}

}  // namespace

// N (P, P) patches of `img` (V, H, W) through the affine maps (see Args),
// and the windows' fractional corners (2, N), on `stream`. Needs
// Q == P + 8 rounded up to 8, Q <= min(H, W), N == V * n_per_image.
// Returns the launch's cudaError_t.
extern "C" int vt_extract_warped(const float* img, int V, int H, int W, int pad,
                                 const float* centers, long long cs0, long long cs1,
                                 const float* maps, int map_stride, int N, int P, int Q, int oo,
                                 float* out, float* corner, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (V < 1 || N % V != 0 || P < 1 || Q < P + kTaps - 1 || Q > H || Q > W ||
      (map_stride != 0 && map_stride != 6))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)Q * Q + (size_t)Q * P);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        warp_window, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const Args a{img, H, W, N / V, centers, cs0, cs1, maps, map_stride, N, P, Q, oo, pad,
               out, corner};
  warp_window<<<N, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
