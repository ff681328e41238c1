// K2: batched integer-corner slab extraction, points-major.
//
// Replaces velocity_tpu/ops/slab_pallas.py:extract_slabs_dma (body _kernel),
// which DMAs an (8,128)-aligned superslab per point into VMEM and shifts it
// with pltpu.roll. None of that carries over: on Hopper the op is a pure
// memory gather, bound by device-memory bytes (N*S*S*4 written, about as
// much read: ~21 MB per call at S=72, N=1024). One thread block per point
// walks its S x S window row by row (copy_window, window.cuh), so reads and
// writes coalesce. The output is (N, S, S), the layout the LK engine
// consumes, so no transpose follows.
#include "window.cuh"

__global__ void extract_slabs_kernel(const float* __restrict__ img, int H, int W,
                                     const int* __restrict__ cx,
                                     const int* __restrict__ cy, int S,
                                     float* __restrict__ out) {
  const int n = blockIdx.x;
  // corners arrive clamped into [0, W-S] x [0, H-S]
  copy_window(img, H, W, cx[n], cy[n], S, out + (size_t)n * S * S);
}

extern "C" int vt_extract_slabs(const float* img, int H, int W, const int* cx,
                                const int* cy, int N, int S, float* out,
                                cudaStream_t stream) {
  if (N <= 0) return 0;
  extract_slabs_kernel<<<N, window_threads(S), 0, stream>>>(img, H, W, cx, cy, S, out);
  return (int)cudaGetLastError();
}
