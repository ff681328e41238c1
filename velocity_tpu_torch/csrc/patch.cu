// K3: batched patch extraction at clamped integer corners, points-major.
//
// Replaces velocity_tpu/ops/patch_pallas.py:extract_patches_pallas (body
// _extract_kernel). There the wrapper clamps the corners, the grid
// scalar-prefetches them into SMEM and each grid step DMAs one (size, size)
// window HBM->VMEM under a DMA semaphore. On Hopper the op is a pure memory
// gather, bound by device-memory bytes: at the fast LK engine's largest
// shape (Q = 82, N = 1024) it writes 27.5 MB and reads about as much. One
// thread block per point reads its own raw corner and clamps it (in place of
// the scalar prefetch and the wrapper's clip); thread 0 writes the clamped
// corner. The block then walks its window row by row (copy_window,
// window.cuh), so neighbouring threads read neighbouring pixels of one image
// row and write neighbouring output words: both sides coalesce. No DMA
// semaphores and no alignment padding.
#include "window.cuh"

__global__ void extract_patches_kernel(const float* __restrict__ img, int H, int W,
                                       const int* __restrict__ corners, int S,
                                       float* __restrict__ out, int* __restrict__ cl) {
  const int n = blockIdx.x;
  const int x0 = min(max(corners[2 * n], 0), W - S);
  const int y0 = min(max(corners[2 * n + 1], 0), H - S);
  if (threadIdx.x == 0) {
    cl[2 * n] = x0;
    cl[2 * n + 1] = y0;
  }
  copy_window(img, H, W, x0, y0, S, out + (size_t)n * S * S);
}

extern "C" int vt_extract_patches(const float* img, int H, int W, const int* corners,
                                  int N, int S, float* out, int* cl,
                                  cudaStream_t stream) {
  if (N <= 0) return 0;
  extract_patches_kernel<<<N, window_threads(S), 0, stream>>>(img, H, W, corners, S,
                                                              out, cl);
  return (int)cudaGetLastError();
}
