// K2: batched integer-corner slab extraction, points-major.
//
// Replaces velocity_tpu/ops/slab_pallas.py:extract_slabs_dma (body _kernel),
// which DMAs an (8,128)-aligned superslab per point into VMEM and shifts it
// with pltpu.roll, after its caller (velocity_tpu/ops/lk_lanes.py
// _extract_slabs) has clamped the corners. None of that carries over: on
// Hopper the op is a pure memory gather, bound by device-memory bytes
// (~21 MB per call at S 72, N 1024). The kernel is the window gather of
// window.cuh, which also clamps the corners and writes the clamped ones, so
// the caller's clamp and stack go with the superslab. The output is
// (N, S, S), the layout the LK engine consumes, so no transpose follows.
// vt_extract_slabs_batched is the JAX kernel under vmap over videos (a grid
// axis per lane there): one launch gathers from a (V, H, W) stack, point i
// from image i / n_per_image.
#include "window.cuh"

extern "C" int vt_extract_slabs(const float* img, int H, int W, const int* corners, int N,
                                int S, float* out, int* cl, cudaStream_t stream) {
  return launch_gather_windows(img, H, W, corners, N, S, out, cl, stream);
}

extern "C" int vt_extract_slabs_batched(const float* img, int V, int H, int W,
                                        const int* corners, int N, int n_per_image, int S,
                                        float* out, int* cl, cudaStream_t stream) {
  return launch_gather_windows_batched(img, V, H, W, corners, N, n_per_image, S, out, cl,
                                       stream);
}
