#!/usr/bin/env python3
"""Where the window gather's time goes (K2 and K3), on one NVIDIA GPU.

    python3 scripts/gather_ablate.py [--against DIR]

Builds variants of ``velocity_tpu_torch/csrc/window.cuh`` into
``build/gather_ablate/`` (one nvcc process each, all started together) and
times them beside the committed gather at the shapes of ``chip_smoke.py``
(K2's on a padded 1080p frame, K3's on its frames, N 1024 or 1020, corners
past every side included) and at size 1, the launch floor. Turns: the
committed gather, the variants, the variants reversed, the committed
gather; the least of each one's two times is printed, beside the bound.
The variants, each checked bit-equal to the plain version before it is
timed:

- ``words W``: a block of T threads takes W * T output words' worth of
  points (committed: 16), so W * T / S^2 points per block, at least one.
- ``128 threads`` and ``256 threads``: blocks of that many threads at every
  size (committed: 128 up to S 32, 256 above).
- ``unroll U``: U loads in flight per thread before its stores (committed:
  4).
- ``4-byte stores``: one word per thread and step at every size.
- ``4-byte stores at S % 4 == 2``: one word per thread and step where the
  4 words of a thread could run into the next row.
- ``L2-only loads``: ``__ldcg`` (cached in L2, not L1) for ``__ldg``.
- ``plain stores``: plain stores for the streaming ``__stcs`` (evict
  first).
- ``block per point``: the previous design, one 128- or 256-thread block
  per point, one 4-byte load then one store per trip, with a division per
  word.

The cuts, which compute wrong answers and are not checked:

- ``launch only``: the kernel returns at once.
- ``corners only``: corners read, clamped and written; no window.
- ``no stores``: the window loads without its stores.
- ``no loads``: the window stores (zeros) without its loads.

``--against DIR`` adds one more variant, ``DIR``'s own ``window.cuh`` and
``slab.cu`` as they are (another checkout's ``velocity_tpu_torch/csrc``),
so that two versions of the gather are timed in turns in one run.

Variants and cuts exist only for this measurement; the committed gather is
the one the package builds.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from velocity_tpu_torch import cuda_build  # noqa: E402
from velocity_tpu_torch.ops import slab_pallas as k2  # noqa: E402

OUT = ROOT / "build" / "gather_ablate"
WORDS = "constexpr int kWordsPerThread = 16;"
UNROLL = "constexpr int kUnroll = 4;"
THREADS = "if (S <= 32) {"
ST4 = "__stcs(reinterpret_cast<float4*>(o + u * kStep),\n                 make_float4("
ST4_END = "v[u][3]));"
ST1 = "__stcs(o + u * kStep, v[u][0]);"
BODY = "  __shared__ long long base[T];"
COPY = "  float* o = out + (long long)n0 * SS + e;\n"
STORE = "      if ((long long)u * kStep < left) {\n        if constexpr (V == 4)"
LOAD = "v[u][k] = __ldg(src + k);"
SPLIT_LOAD = "v[u][k] = __ldg(img + base[pk] + (long long)rk * W + ck);"
VEC = "const bool vec = S % 2 == 0 &&"
# name: ((text in window.cuh, its replacement), ...)
VARIANTS = {
    **{f"words {w}": ((WORDS, f"constexpr int kWordsPerThread = {w};"),) for w in (8, 32)},
    "128 threads": ((THREADS, "if (true) {"),),
    "256 threads": ((THREADS, "if (false) {"),),
    **{f"unroll {u}": ((UNROLL, f"constexpr int kUnroll = {u};"),) for u in (2, 8)},
    "4-byte stores": ((VEC, "const bool vec = false &&"),),
    "4-byte stores at S % 4 == 2": (("} else if (vec) {", "} else if (false) {"),),
    "L2-only loads": ((LOAD, LOAD.replace("__ldg", "__ldcg")),
                      (SPLIT_LOAD, SPLIT_LOAD.replace("__ldg", "__ldcg"))),
    "plain stores": ((ST4, "*reinterpret_cast<float4*>(o + u * kStep) = make_float4("),
                     (ST4_END, "v[u][3]);"), (ST1, "o[u * kStep] = v[u][0];")),
}
CUTS = {
    "launch only": ((BODY, "  return;\n" + BODY),),
    "corners only": ((COPY, "  return;\n" + COPY),),
    "no stores": ((STORE, STORE.replace("left)", "left && v[u][0] == -1.5e30f)")),),
    "no loads": ((LOAD, "v[u][k] = 0.f;"), (SPLIT_LOAD, "v[u][k] = 0.f;")),
}
BLOCK_PER_POINT = r"""
#include <cuda_runtime.h>
__global__ void gather_point(const float* __restrict__ img, int H, int W,
                             const int* __restrict__ corners, int S,
                             float* __restrict__ out, int* __restrict__ cl) {
  const int n = blockIdx.x;
  const int x0 = min(max(corners[2 * n], 0), W - S);
  const int y0 = min(max(corners[2 * n + 1], 0), H - S);
  if (threadIdx.x == 0) { cl[2 * n] = x0; cl[2 * n + 1] = y0; }
  float* o = out + (size_t)n * S * S;
  for (int e = threadIdx.x; e < S * S; e += blockDim.x) {
    const int r = e / S;
    const int c = e - r * S;
    o[e] = img[(size_t)(y0 + r) * W + x0 + c];
  }
}
extern "C" int vt_extract_slabs(const float* img, int H, int W, const int* corners, int N,
                                int S, float* out, int* cl, cudaStream_t stream) {
  if (N <= 0) return 0;
  gather_point<<<N, S * S >= 256 ? 256 : 128, 0, stream>>>(img, H, W, corners, S, out, cl);
  return (int)cudaGetLastError();
}
"""


def build_variants(against: Path | None = None) -> dict:
    """{variant: vt_extract_slabs of its library}; ``against``, a csrc
    directory whose gather is built as it is."""
    header = (cuda_build.SRC_DIR / "window.cuh").read_text()
    entry = (cuda_build.SRC_DIR / "slab.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    sources = {}
    for name, pairs in {**VARIANTS, **CUTS}.items():
        text = header
        for old, new in pairs:
            if header.count(old) != 1:
                raise RuntimeError(f"window.cuh no longer has the text {name!r} edits")
            text = text.replace(old, new)
        sources[name] = (text, entry)
    sources["block per point"] = (None, BLOCK_PER_POINT)
    if against is not None:
        sources[f"{against}"] = ((against / "window.cuh").read_text(),
                                 (against / "slab.cu").read_text())
    for i, (name, (hdr, cu_text)) in enumerate(sources.items()):
        d = OUT / f"v{i}"
        d.mkdir(exist_ok=True)
        if hdr is not None:
            (d / "window.cuh").write_text(hdr)
        (d / "slab.cu").write_text(cu_text)
        lib = d / "gather.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(d / "slab.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the variant {name!r}:\n{log}")
        for line in chip_smoke.ptxas_report(log):
            print(f"  ptxas {name}: {line[0]}: {line[1]} registers, spills {line[2]}/{line[3]}")
        fn = ctypes.CDLL(str(lib)).vt_extract_slabs
        fn.restype, fn.argtypes = cuda_build.SIGNATURES["vt_extract_slabs"]
        fns[name] = fn
    return fns


class _Lib:
    def __init__(self, fn):
        self.vt_extract_slabs = fn


def _cases(dev):
    """(label, image, corners, size) at the shapes of chip_smoke's K2 and
    K3 phases, each also at size 1."""
    import torch.nn.functional as F

    from velocity_tpu_torch.ops.lk import _pad_edge

    g = torch.Generator(device=dev).manual_seed(2)
    frame = _pad_edge(torch.rand((1080, 1920), generator=g, device=dev) * 255, 72)
    cases = []
    for S, N in chip_smoke.SLAB_SHAPES:
        corners = chip_smoke._corners_with_outsiders(g, *frame.shape, S, N, lo=0)
        cases.append((f"K2 S {S} N {N}", frame, corners, S))
    for label, H, W, size in chip_smoke.K3_CASES:
        img = torch.rand((H, W), generator=g, device=dev) * 255
        if H < size or W < size:
            img = F.pad(img[None, None], (0, max(0, size - W), 0, max(0, size - H)),
                        mode="replicate")[0, 0].contiguous()
        corners = chip_smoke._corners_with_outsiders(g, *img.shape, size, chip_smoke.N_POINTS,
                                                     lo=-(size // 2))
        cases.append((f"K3 {label}", img, corners, size))
    firsts = (cases[0], cases[len(chip_smoke.SLAB_SHAPES)])
    return cases + [(f"{label} floor", img, corners, 1) for label, img, corners, _ in firsts]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a csrc directory whose gather is timed beside the committed one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gather_ablate: no CUDA device", file=sys.stderr)
        return 1
    smi = chip_smoke.phase_device()
    committed = cuda_build.library()
    fns = {"committed": committed.vt_extract_slabs, **build_variants(args.against)}
    dev = torch.device("cuda")
    try:
        for label, img, corners, size in _cases(dev):
            want, want_cl = k2.extract_slabs_ref(img, corners, size)
            r_idx, c_idx = chip_smoke._window_index(want_cl[:, 0], want_cl[:, 1], size)
            bound_ms, _ = chip_smoke._gather_bound(img, r_idx, c_idx, 16 * corners.shape[0])
            times = {name: [] for name in fns}
            for name in [*fns, *reversed(fns)]:
                cuda_build._lib = _Lib(fns[name])
                got, got_cl = k2.extract_slabs(img, corners, size)
                torch.cuda.synchronize()
                if name not in CUTS and not (torch.equal(got, want)
                                             and torch.equal(got_cl, want_cl)):
                    raise AssertionError(f"{name} differs from the plain version at {label}")
                times[name].append(chip_smoke.cuda_ms(lambda: k2.extract_slabs(img, corners,
                                                                                size)))
            print(f"{label} (bound {bound_ms:.4f} ms): "
                  + ", ".join(f"{name} {min(t):.4f}" for name, t in times.items()))
    finally:
        cuda_build._lib = committed
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
