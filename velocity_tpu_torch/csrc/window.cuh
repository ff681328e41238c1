// Shared by the gather kernels K2 (slab.cu) and K3 (patch.cu): one thread
// block copies one S x S window of a row-major f32 image into a contiguous
// output, row by row. Neighbouring threads read neighbouring pixels of one
// image row and write neighbouring output words, so both sides coalesce.
// Pixel indices clamp into the image, so no corner can read outside it.
#pragma once
#include <cuda_runtime.h>

static __device__ __forceinline__ void copy_window(const float* __restrict__ img,
                                                   int H, int W, int x0, int y0,
                                                   int S, float* __restrict__ out) {
  for (int e = threadIdx.x; e < S * S; e += blockDim.x) {
    const int r = e / S;
    const int c = e - r * S;
    const int y = min(max(y0 + r, 0), H - 1);
    const int x = min(max(x0 + c, 0), W - 1);
    out[e] = img[(size_t)y * W + x];
  }
}

// Threads per window block: 256 once the window has 256 pixels, else 128.
static inline int window_threads(int S) { return S * S >= 256 ? 256 : 128; }
