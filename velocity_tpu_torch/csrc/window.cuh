// The window gather shared by K2 (slab.cu) and K3 (patch.cu). For each of N
// int32 corners (x, y), it clamps the corner into [0, W-S] x [0, H-S],
// writes the clamped corner, and copies the S x S window of a row-major f32
// image (H, W) at it into a points-major (N, S, S) output.
//
// What bounds it: device-memory bytes. A call writes N*S*S words and reads
// about as many (2.4 MB each way at S 24, 21 MB at S 72, for N 1024): a few
// microseconds at 3.35 TB/s, short enough that block launch and memory
// latency weigh as much as bandwidth. The design answers both (its variants
// are timed by scripts/gather_ablate.py):
//
// - Several points per block. A block of T threads takes kWordsPerThread * T
//   output words' worth of consecutive points (at least one, at most T), so
//   a launch has a few hundred blocks, not one per point. T is 128 for
//   windows of up to 32 x 32 and 256 above, chosen at launch by size.
// - A block's output is one contiguous run of its points' windows, and its
//   threads walk it flat: thread t takes words V*t, V*(t + T), ... Each
//   word's (point, row, column) advances by the step's fixed digits with
//   carries, so the loop has no division. Stores coalesce across rows and
//   points; reads coalesce along each window row.
// - Loads in flight before stores: each thread issues kUnroll loads of V
//   words into registers, then stores them with the streaming hint
//   (__stcs, evict first; measured faster at the large sizes). The lines
//   still land in L2, where the next kernel reads them.
// - V = 4 words per thread and step where S is even (and the output is
//   16-byte aligned, as a fresh torch.empty is): every window, and so every
//   thread's 4 words, then starts 16-byte aligned, and stores are float4.
//   Where S % 4 == 2 the 4 words may run into the next row or point, so
//   each word steps its own (point, row, column); that still beats one
//   word per thread (P 70 and Q 82 by about an eighth). Reads stay 4-byte,
//   since rows start at any x. Odd S stores 4-byte words. The launch picks
//   the path by shape; nothing is tried and retried.
// - The corners clamp here: one thread per point reads, clamps and writes
//   its corner and leaves its window's image offset in shared memory.
// - No TMA: the images are fresh tensors per level and frame, so a tensor
//   map would be encoded on the host for every call, on a host-bound path;
//   and TMA's 16-byte rules on the box width and the row pitch exclude S 27,
//   34, 70, 82 and a 34-wide padded top level.
// - A stack of V equal-sized images (V, H, W) takes one launch for all its
//   points (kBatched): point i reads image i / n_per_image, the lane-major
//   layout of the JAX package's vmap over videos. The corner thread adds
//   the image's offset to the window offset it leaves in shared memory; the
//   clamp stays per image. Single images compile without that division.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordsPerThread = 16;  // output words a thread takes, in whole points
constexpr int kUnroll = 4;           // loads a thread keeps in flight before storing

template <int T, int V, bool kSplitRows, bool kBatched>
__global__ void __launch_bounds__(T)
gather_windows(const float* __restrict__ img, int H, int W, const int* __restrict__ corners,
               int N, int S, int ppb, int n_per_image, float* __restrict__ out,
               int* __restrict__ cl) {
  __shared__ long long base[T];  // image offset of each point's window
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * ppb;
  const int cnt = min(ppb, N - n0);
  int x0 = 0, y0 = 0;
  if (t < cnt) {
    x0 = corners[2 * (n0 + t)];
    y0 = corners[2 * (n0 + t) + 1];
  }
  // While the corners load: (point p, row r, column c) of this thread's
  // first word, and the same digits of one block-wide step of kStep words.
  constexpr int kStep = T * V;
  const int SS = S * S;
  const int e = t * V;
  int p = e / SS, r = (e - p * SS) / S;
  int c = e - p * SS - r * S;
  const int dp = kStep / SS, dr = (kStep - dp * SS) / S;
  const int dc = kStep - dp * SS - dr * S;
  long long left = (long long)cnt * SS - e;  // words from this thread's first to the block's end
  if (t < cnt) {
    x0 = min(max(x0, 0), W - S);
    y0 = min(max(y0, 0), H - S);
    cl[2 * (n0 + t)] = x0;
    cl[2 * (n0 + t) + 1] = y0;
    long long off = (long long)y0 * W + x0;
    if constexpr (kBatched) off += (long long)((n0 + t) / n_per_image) * H * W;
    base[t] = off;
  }
  __syncthreads();

  float* o = out + (long long)n0 * SS + e;
  while (left > 0) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if ((long long)u * kStep < left) {
        if constexpr (kSplitRows) {  // the V words may run into the next row or point
          int pk = p, rk = r, ck = c;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            v[u][k] = __ldg(img + base[pk] + (long long)rk * W + ck);
            if (++ck == S) {
              ck = 0;
              if (++rk == S) { rk = 0; ++pk; }
            }
          }
        } else {
          const float* src = img + base[p] + (long long)r * W + c;
#pragma unroll
          for (int k = 0; k < V; ++k) v[u][k] = __ldg(src + k);
        }
      }
      c += dc;
      r += dr;
      p += dp;
      if (c >= S) { c -= S; ++r; }
      if (r >= S) { r -= S; ++p; }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if ((long long)u * kStep < left) {
        if constexpr (V == 4) {
          __stcs(reinterpret_cast<float4*>(o + u * kStep),
                 make_float4(v[u][0], v[u][1], v[u][2], v[u][3]));
        } else {
          __stcs(o + u * kStep, v[u][0]);
        }
      }
    }
    o += kUnroll * kStep;
    left -= kUnroll * kStep;
  }
}

template <int T, bool kBatched>
void launch_gather(const float* img, int H, int W, const int* corners, int N, int S,
                   int n_per_image, float* out, int* cl, cudaStream_t stream) {
  const int ppb = max(1, min(T, kWordsPerThread * T / (S * S)));
  const int blocks = (N + ppb - 1) / ppb;
  const bool vec = S % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec && S % 4 == 0) {
    gather_windows<T, 4, false, kBatched><<<blocks, T, 0, stream>>>(
        img, H, W, corners, N, S, ppb, n_per_image, out, cl);
  } else if (vec) {
    gather_windows<T, 4, true, kBatched><<<blocks, T, 0, stream>>>(
        img, H, W, corners, N, S, ppb, n_per_image, out, cl);
  } else {
    gather_windows<T, 1, false, kBatched><<<blocks, T, 0, stream>>>(
        img, H, W, corners, N, S, ppb, n_per_image, out, cl);
  }
}

template <bool kBatched>
int launch_gather_any(const float* img, int H, int W, const int* corners, int N, int S,
                      int n_per_image, float* out, int* cl, cudaStream_t stream) {
  if (S < 1 || S > H || S > W) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  if (S <= 32) {
    launch_gather<128, kBatched>(img, H, W, corners, N, S, n_per_image, out, cl, stream);
  } else {
    launch_gather<256, kBatched>(img, H, W, corners, N, S, n_per_image, out, cl, stream);
  }
  return (int)cudaGetLastError();
}

// Gathers N windows of size S at `corners` (N, 2) xy into `out` (N, S, S)
// and the clamped corners into `cl` (N, 2), on `stream`. Needs 1 <= S <=
// min(H, W). Returns the launch's cudaError_t.
int launch_gather_windows(const float* img, int H, int W, const int* corners, int N, int S,
                          float* out, int* cl, cudaStream_t stream) {
  return launch_gather_any<false>(img, H, W, corners, N, S, N, out, cl, stream);
}

// The same over a contiguous stack `img` (V, H, W): point i's window comes
// from image i / n_per_image, clamped into that image. Needs N == V *
// n_per_image.
int launch_gather_windows_batched(const float* img, int V, int H, int W, const int* corners,
                                  int N, int n_per_image, int S, float* out, int* cl,
                                  cudaStream_t stream) {
  if (V < 1 || n_per_image < 0 || (long long)V * n_per_image != N)
    return (int)cudaErrorInvalidValue;
  return launch_gather_any<true>(img, H, W, corners, N, S, n_per_image, out, cl, stream);
}

}  // namespace
