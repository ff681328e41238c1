// K6: the LK source window of one pyramid level (ops/lk_lanes.py:source_window),
// every point's window in one launch.
//
// Replaces no TPU kernel. The JAX package writes the source window in jnp
// (velocity_tpu/ops/lk_lanes.py:439-475: the slab, _grad_xy, three
// _sample_taps and the structure tensor) and leaves it to XLA's fusion. The
// port's eager form (_source_window_ref, kept as K6's plain twin) runs ~210
// kernels a window at win 15 and ~900 at win 51 with the cubic stencil, each
// over the whole (N, P, P) or (N, win, win) grid. A lanes frame step runs 17
// windows (stage 1's 5 levels, the 5 of each of stage 2's two legs, one for
// each of stage 3's legs): ~4,300 kernels.
//
// What bounds it on an H100: the bytes it must write are Ip, gx and gy
// (3 x N x win^2 float32) and four floats and a flag a point: 2.8 MB at
// N 1024, win 15 (0.8 us at 3.35 TB/s), 32 MB at win 51 (9.5 us). The slabs
// it reads overlap and sit in L2. Next come the stencils' shared-memory
// reads, one a tap: 3 (S win + win^2) taps a point, S = win + taps - 1, so
// 116k a point at win 51 with 7 cubic taps, ~16 us for 1,024 points at the
// card's ~7 T words a second; the arithmetic (a product and a sum a tap,
// never fused) is about as much. Measured on an H100 (700 W) in the
// benchmark's traced clips: a step's 17 launches take ~0.23 ms, 13.6-13.8%
// of the bytes bound (31.5 us); the win-15 launches, 8 warps an SM, wait
// on their loads more than they work.
//
// What the design does about it:
// - Nothing of a window goes to device memory but its outputs. A point's
//   slab (only the E x E corner its window reaches: E = min(S + 1, P)), the
//   two smoothings, gx and gy (S x S) and the three x-passes (S x win) live
//   in shared memory; each stage is one walk of its grid by the point's
//   threads, consecutive threads on consecutive words, between barriers.
// - Two shapes, as K1 has them. Windows up to 16 (stages 1-2's win 15): one
//   warp per point, 4 points a block, 7.3 KB of shared memory a point,
//   warp barriers and shuffles only. Larger windows (stage 3's win 51): one
//   256-thread block per point, 68-74 KB of dynamic shared memory.
// - The bits are the plain form's. Every smoothing, difference, weight, tap
//   product and sum is rounded alone in the plain form's order (__fmul_rn,
//   __fadd_rn: no FMA contraction), each weight as _w_linear or _w_cubic
//   forms it from the offset clamped as _sample_taps clamps it, and every
//   tap is added, weight 0 or not, so Ip, gx and gy are the plain form's
//   bits, the sign of a zero too. The structure tensor's sums run in a fixed
//   order of their own (per thread, then a butterfly, then across warps in
//   order), so a call gives the same bits every time; they differ from
//   torch.sum's order by rounding only.
// - The source is the edge-padded level image, a stack (V, H, W) lane-major
//   as K2 takes it (each point's integer corner computed and clamped into
//   the image as K2 clamps it), or, for stage 3's backward leg, the (P, P)
//   patches and fractional corners that K5 wrote, sampled by the cubic
//   stencil. The launch is checked with cudaGetLastError and returned.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kWarpMaxWin = 16;  // windows up to this: one warp per point
constexpr int kWarpsPerBlock = 4;
constexpr int kBlockThreads = 256;  // larger windows: one block per point
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr float kTiny16 = 16.0f * FLT_MIN;  // torch.finfo(float32).tiny * 16

struct Args {
  const float* src;     // linear: the edge-padded level (V, H, W); cubic: K5's patches (N, P, P)
  const float* corner;  // cubic: K5's fractional window corners (2, N)
  int H, W, n_per_image;
  const float* centers;  // (2, N): x at centers[n * cs1], y at centers[cs0 + n * cs1]
  long long cs0, cs1;
  int N, win, P, E, S, shift;  // shift: floor(centre) + shift is a slab's corner
  float half, Hs, Ws, eig_thresh, inv_area;
  float* windows;  // (3, N, win, win): Ip, gx, gy
  float* sums;     // (4, N): a11, a12, a22, inv_det
  unsigned char* trackable;  // (N,) bool
  int stride;                // floats of shared memory a point
};

template <int kGroup>
__device__ __forceinline__ void group_sync() {
  if constexpr (kGroup == 32) __syncwarp();
  else __syncthreads();
}

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// floor(v) as int32, as torch's floor then .to(int32) gives it (saturating,
// NaN to 0), then + add in int32 with wrap-around
__device__ __forceinline__ int floor_plus(float v, int add) {
  return (int)((unsigned)(int)floorf(v) + (unsigned)add);
}

// _w_linear(o - t) or _w_cubic(o - t), each step rounded as torch rounds it
template <bool kCubic>
__device__ __forceinline__ float weight(float o, int t) {
  const float d = fabsf(__fsub_rn(o, (float)t));
  if constexpr (!kCubic) {
    const float v = __fsub_rn(1.0f, d);
    return v != v ? v : fmaxf(v, 0.0f);
  } else {
    const float w1 =
        __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(1.5f, d), 2.5f), d), d), 1.0f);
    const float w2 = __fadd_rn(
        __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(-0.5f, d), 2.5f), d), 4.0f), d), 2.0f);
    return d < 1.0f ? w1 : (d < 2.0f ? w2 : 0.0f);
  }
}

// The stencil along a row (step 1) or a column (step = row length) of `src`:
// w[0] * src[0] + w[1] * src[step] + ..., in order, each rounded.
template <int K>
__device__ __forceinline__ float taps(const float* src, int step, const float (&w)[K]) {
  float acc = __fmul_rn(w[0], src[0]);
#pragma unroll
  for (int t = 1; t < K; ++t) acc = __fadd_rn(acc, __fmul_rn(w[t], src[t * step]));
  return acc;
}

// _grad_xy's [3, 10, 3] / 16 smoothing of three neighbours
__device__ __forceinline__ float smooth(float m, float c, float p) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(3.0f, m), __fmul_rn(10.0f, c)), __fmul_rn(3.0f, p)),
                   0.0625f);
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same bits
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One point's window, by the kGroup threads of its warp (32) or block; t is
// the thread's index among them, sm the point's shared memory.
template <int kGroup, bool kCubic>
__device__ __forceinline__ void point_window(const Args& a, int n, int t, float* sm) {
  constexpr int K = kCubic ? 7 : 4;  // the taps of _sample_taps
  const int win = a.win, E = a.E, S = a.S, ww = win * win;
  float* slab = sm;           // (E, E): the corner of the slab the window reaches
  float* gxs = slab + E * E;  // (S, S)
  float* gys = gxs + S * S;   // (S, S)
  float* tmp = gys + S * S;   // the smoothings (S, E) and (E, S), then the x-passes (3, S, win)

  const float cx = __ldg(a.centers + n * a.cs1), cy = __ldg(a.centers + a.cs0 + n * a.cs1);
  const float hx = __fsub_rn(cx, a.half), hy = __fsub_rn(cy, a.half);
  const float* src;
  int rs;
  float su, sv;
  if constexpr (kCubic) {  // K5's patch and its corner
    src = a.src + (long long)n * a.P * a.P;
    rs = a.P;
    su = __fsub_rn(hx, __ldg(a.corner + n));
    sv = __fsub_rn(hy, __ldg(a.corner + a.N + n));
  } else {  // the integer corner, clamped as K2 clamps it
    const int kx = min(max(floor_plus(cx, a.shift), 0), a.W - a.P);
    const int ky = min(max(floor_plus(cy, a.shift), 0), a.H - a.P);
    src = a.src + (long long)(n / a.n_per_image) * a.H * a.W + (long long)ky * a.W + kx;
    rs = a.W;
    su = __fsub_rn(hx, (float)(kx - a.P));
    sv = __fsub_rn(hy, (float)(ky - a.P));
  }
  const float lo = kCubic ? 1.0f : 0.0f, hi = kCubic ? K - 2.0f : K - 1.0f;
  const float ox = clamp_keep_nan(su, lo, hi), oy = clamp_keep_nan(sv, lo, hi);
  float wx[K], wy[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    wx[k] = weight<kCubic>(ox, k);
    wy[k] = weight<kCubic>(oy, k);
  }

  for (int e = t; e < E * E; e += kGroup) {
    const int r = e / E, c = e - r * E;
    slab[e] = __ldg(src + (long long)r * rs + c);
  }
  group_sync<kGroup>();

  // _grad_xy, replicate border at the slab's edge. Within the E x E corner
  // the clamps at E - 1 are the slab's: where E < P no index reaches it.
  float* smv = tmp;          // (S, E): smoothed across rows, feeds gx
  float* smh = tmp + S * E;  // (E, S): smoothed across columns, feeds gy
  for (int e = t; e < S * E; e += kGroup) {
    const int r = e / E, c = e - r * E;
    smv[e] = smooth(slab[max(r - 1, 0) * E + c], slab[r * E + c], slab[min(r + 1, E - 1) * E + c]);
    const int r2 = e / S, c2 = e - r2 * S;
    const float* row = slab + r2 * E;
    smh[e] = smooth(row[max(c2 - 1, 0)], row[c2], row[min(c2 + 1, E - 1)]);
  }
  group_sync<kGroup>();
  for (int e = t; e < S * S; e += kGroup) {
    const int r = e / S, c = e - r * S;
    gxs[e] = __fmul_rn(__fsub_rn(smv[r * E + min(c + 1, E - 1)], smv[r * E + max(c - 1, 0)]), 0.5f);
    gys[e] = __fmul_rn(__fsub_rn(smh[min(r + 1, E - 1) * S + c], smh[max(r - 1, 0) * S + c]), 0.5f);
  }
  group_sync<kGroup>();

  // _sample_taps: the x-pass of the slab, gx and gy over the S rows the
  // y-pass reads, then the y-pass
  float* hI = tmp;
  float* hX = tmp + S * win;
  float* hY = hX + S * win;
  for (int e = t; e < S * win; e += kGroup) {
    const int r = e / win, j = e - r * win;
    hI[e] = taps(slab + r * E + j, 1, wx);
    hX[e] = taps(gxs + r * S + j, 1, wx);
    hY[e] = taps(gys + r * S + j, 1, wx);
  }
  group_sync<kGroup>();
  float* Ip = a.windows + (long long)n * ww;
  float* gx = Ip + (long long)a.N * ww;
  float* gy = gx + (long long)a.N * ww;
  float s11 = 0.0f, s12 = 0.0f, s22 = 0.0f;
  for (int e = t; e < ww; e += kGroup) {
    const float vi = taps(hI + e, win, wy);
    const float vx = taps(hX + e, win, wy);
    const float vy = taps(hY + e, win, wy);
    Ip[e] = vi;
    gx[e] = vx;
    gy[e] = vy;
    s11 = fmaf(vx, vx, s11);
    s12 = fmaf(vx, vy, s12);
    s22 = fmaf(vy, vy, s22);
  }
  s11 = warp_sum(s11);
  s12 = warp_sum(s12);
  s22 = warp_sum(s22);
  if constexpr (kGroup > 32) {  // across the block's warps, in order
    __shared__ float red[3][kBlockThreads / 32];
    if ((t & 31) == 0) {
      red[0][t >> 5] = s11;
      red[1][t >> 5] = s12;
      red[2][t >> 5] = s22;
    }
    __syncthreads();
    s11 = red[0][0];
    s12 = red[1][0];
    s22 = red[2][0];
    for (int w = 1; w < kGroup / 32; ++w) {
      s11 += red[0][w];
      s12 += red[1][w];
      s22 += red[2][w];
    }
  }

  if (t == 0) {  // the gates, as the plain form computes them
    const float det = __fsub_rn(__fmul_rn(s11, s22), __fmul_rn(s12, s12));
    const float tr = __fadd_rn(s11, s22);
    const float df = __fsub_rn(s11, s22);
    const float q = __fadd_rn(__fmul_rn(df, df), __fmul_rn(__fmul_rn(4.0f, s12), s12));
    const float min_eig = __fmul_rn(__fmul_rn(__fsub_rn(tr, __fsqrt_rn(q)), 0.5f), a.inv_area);
    const bool eig_ok = (min_eig >= a.eig_thresh) && (det >= kTiny16);
    const float fx = floorf(hx), fy = floorf(hy);
    const bool src_ok = (fx >= (float)-win) && (fy >= (float)-win) && (fx < a.Ws) && (fy < a.Hs);
    a.sums[n] = s11;
    a.sums[a.N + n] = s12;
    a.sums[2 * a.N + n] = s22;
    a.sums[3 * a.N + n] = det != 0.0f ? __frcp_rn(det) : 0.0f;
    a.trackable[n] = (src_ok && eig_ok) ? 1 : 0;
  }
}

// Windows up to kWarpMaxWin: one warp a point, blockDim.x / 32 points a block.
template <bool kCubic>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) source_window_warp(const Args a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= a.N) return;  // the ragged tail; no block barrier follows
  point_window<32, kCubic>(a, n, threadIdx.x & 31, smem + (size_t)warp * a.stride);
}

// Larger windows: one block of kBlockThreads a point.
template <bool kCubic>
__global__ void __launch_bounds__(kBlockThreads) source_window_block(const Args a) {
  extern __shared__ float smem[];
  point_window<kBlockThreads, kCubic>(a, blockIdx.x, threadIdx.x, smem);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool kCubic>
int launch(const Args& a, cudaStream_t stream) {
  const size_t point_bytes = sizeof(float) * (size_t)a.stride;
  cudaError_t err;
  if (a.win <= kWarpMaxWin) {
    const size_t smem = point_bytes * kWarpsPerBlock;
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    if ((err = set_smem(source_window_warp<kCubic>, smem)) != cudaSuccess) return (int)err;
    source_window_warp<kCubic><<<(a.N + kWarpsPerBlock - 1) / kWarpsPerBlock,
                                 32 * kWarpsPerBlock, smem, stream>>>(a);
  } else {
    if (point_bytes > kMaxSmem - 1024) return (int)cudaErrorInvalidValue;  // less the static scratch
    if ((err = set_smem(source_window_block<kCubic>, point_bytes)) != cudaSuccess) return (int)err;
    source_window_block<kCubic><<<a.N, kBlockThreads, point_bytes, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The source windows of N points at one level, on `stream`.
// Linear (cubic 0): `src` is the level edge-padded by P, a stack (V, H, W)
// whose images hold N / V points each, and shift = P - (win - 1) / 2 - 2 the
// offset of each point's slab corner from floor(centre). Cubic (1): `src` is
// K5's (N, P, P) patches and `corner` their fractional corners (2, N); V, H,
// W and shift are not read. `centers` (2, N) are the points at the level's
// scale, (Hs, Ws) the level's size. Writes `windows` (3, N, win, win: Ip,
// gx, gy), `sums` (4, N: a11, a12, a22, inv_det) and `trackable` (N, bool).
// Needs min(n_taps, P - win + 1) taps to be 4 (linear) or 7 (cubic).
// Returns the launch's cudaError_t.
extern "C" int vt_source_window(const float* src, int V, int H, int W, const float* corner,
                                const float* centers, long long cs0, long long cs1, int N,
                                int win, int P, int n_taps, int cubic, int shift,
                                float eig_thresh, int Hs, int Ws, float* windows, float* sums,
                                unsigned char* trackable, cudaStream_t stream) {
  if (N <= 0) return 0;
  const int nt = n_taps < P - win + 1 ? n_taps : P - win + 1;
  if (win < 1 || nt != (cubic ? 7 : 4)) return (int)cudaErrorInvalidValue;
  if (!cubic && (V < 1 || N % V != 0 || P > H || P > W)) return (int)cudaErrorInvalidValue;
  const int S = win + nt - 1;
  const int E = S + 1 < P ? S + 1 : P;
  const int scratch = 2 * S * E > 3 * S * win ? 2 * S * E : 3 * S * win;
  const Args a{src, corner, H, W, cubic ? N : N / V, centers, cs0, cs1, N, win, P, E, S, shift,
               (win - 1) * 0.5f, (float)Hs, (float)Ws, eig_thresh,
               1.0f / (float)(win * win), windows, sums, trackable,
               E * E + 2 * S * S + scratch};
  return cubic ? launch<true>(a, stream) : launch<false>(a, stream);
}
