// K2: batched integer-corner slab extraction, points-major.
//
// Replaces velocity_tpu/ops/slab_pallas.py:extract_slabs_dma (body _kernel),
// which DMAs an (8,128)-aligned superslab per point into VMEM and shifts it
// with pltpu.roll. None of that carries over: on Hopper the op is a pure
// memory gather, bound by device-memory bytes (N*S*S*4 written, about as
// much read: ~21 MB per call at S=72, N=1024). One thread block per point
// walks its S x S window row by row; neighbouring threads read neighbouring
// pixels of one image row and write neighbouring output words, so both
// sides coalesce. The output is (N, S, S), the layout the LK engine
// consumes, so no transpose follows.
#include <cuda_runtime.h>

__global__ void extract_slabs_kernel(const float* __restrict__ img, int H, int W,
                                     const int* __restrict__ cx,
                                     const int* __restrict__ cy, int S,
                                     float* __restrict__ out) {
  const int n = blockIdx.x;
  // corners arrive clamped into [0, W-S] x [0, H-S]; clamp the pixel index
  // as well so that no corner can read outside the image
  const int x0 = cx[n];
  const int y0 = cy[n];
  float* o = out + (size_t)n * S * S;
  for (int e = threadIdx.x; e < S * S; e += blockDim.x) {
    const int r = e / S;
    const int c = e - r * S;
    const int y = min(max(y0 + r, 0), H - 1);
    const int x = min(max(x0 + c, 0), W - 1);
    o[e] = img[(size_t)y * W + x];
  }
}

extern "C" int vt_extract_slabs(const float* img, int H, int W, const int* cx,
                                const int* cy, int N, int S, float* out,
                                cudaStream_t stream) {
  if (N <= 0) return 0;
  const int threads = S * S >= 256 ? 256 : 128;
  extract_slabs_kernel<<<N, threads, 0, stream>>>(img, H, W, cx, cy, S, out);
  return (int)cudaGetLastError();
}
