// K3: batched patch extraction at clamped integer corners, points-major.
//
// Replaces velocity_tpu/ops/patch_pallas.py:extract_patches_pallas (body
// _extract_kernel). There the wrapper clamps the corners, the grid
// scalar-prefetches them into SMEM and each grid step DMAs one (size, size)
// window HBM->VMEM under a DMA semaphore. On Hopper the op is a pure memory
// gather, bound by device-memory bytes: at the fast LK engine's largest
// shape (Q = 82, N = 1024) it writes 27.5 MB and reads about as much. The
// kernel is the window gather of window.cuh: each block reads and clamps its
// points' corners (in place of the scalar prefetch and the wrapper's clip)
// and copies their windows with coalesced reads and stores. No DMA
// semaphores and no alignment padding. vt_extract_patches_batched is the
// JAX kernel under vmap over videos (run_batch with the fast backend gives
// its grid a lane axis): one launch gathers from a (V, H, W) stack, point i
// from image i / n_per_image.
#include "window.cuh"

extern "C" int vt_extract_patches(const float* img, int H, int W, const int* corners, int N,
                                  int S, float* out, int* cl, cudaStream_t stream) {
  return launch_gather_windows(img, H, W, corners, N, S, out, cl, stream);
}

extern "C" int vt_extract_patches_batched(const float* img, int V, int H, int W,
                                          const int* corners, int N, int n_per_image, int S,
                                          float* out, int* cl, cudaStream_t stream) {
  return launch_gather_windows_batched(img, V, H, W, corners, N, n_per_image, S, out, cl,
                                       stream);
}
