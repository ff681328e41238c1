#!/usr/bin/env python3
"""Where K1's time goes, on one NVIDIA GPU.

    python3 scripts/k1_ablate.py

Builds cut-down copies of ``velocity_tpu_torch/csrc/lk_block.cu`` into
``build/k1_ablate/`` (each with nvcc, one process per copy) and times them
beside the full kernel on the main-path shapes of ``chip_smoke.py``
(N 1024, it0 0 and 5), in turns: full, cuts, cuts reversed, full; the
least of each kernel's two times is printed. The cuts:

- ``loads``: no update; the loads, the c reduction and the stores.
- ``one update``: the first of the five updates only.
- ``no stencil``: five updates whose sampling is skipped (the reductions,
  the solve and the barriers stay).

The cut copies compute wrong answers and exist only for this measurement;
the full kernel is the one the package builds.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from velocity_tpu_torch import cuda_build  # noqa: E402
from velocity_tpu_torch.ops import lk_block_pallas as k1  # noqa: E402

OUT = ROOT / "build" / "k1_ablate"
ITERS = "constexpr int kBlockIters = 5;"
STENCIL = "  constexpr int K = Window<kCubic>::K;\n  const int P = a.P;\n"
CUTS = {
    "loads": (ITERS, "constexpr int kBlockIters = 0;"),
    "one update": (ITERS, "constexpr int kBlockIters = 1;"),
    "no stencil": (STENCIL, "  return;\n" + STENCIL),
}


def build_cuts() -> dict:
    """{cut: vt_lk_block of its library}."""
    src = (cuda_build.SRC_DIR / "lk_block.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (old, new)) in enumerate(CUTS.items()):
        if src.count(old) != 1:
            raise RuntimeError(f"lk_block.cu no longer has the text the cut {name!r} edits")
        cu = OUT / f"cut{i}.cu"
        cu.write_text(src.replace(old, new))
        lib = OUT / f"cut{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the cut {name!r}:\n{log}")
        fn = ctypes.CDLL(str(lib)).vt_lk_block
        fn.restype, fn.argtypes = cuda_build.SIGNATURES["vt_lk_block"]
        fns[name] = fn
    return fns


class _Lib:
    def __init__(self, fn):
        self.vt_lk_block = fn


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_ablate: no CUDA device", file=sys.stderr)
        return 1
    smi = chip_smoke.phase_device()
    full = cuda_build.library()
    fns = {"full": full.vt_lk_block, **build_cuts()}
    dev = torch.device("cuda")
    try:
        for win, P, n_taps, cubic in chip_smoke.K1_CONFIGS:
            for it0 in (0, 5):
                args, kw = chip_smoke._k1_case(dev, win, P, n_taps, cubic, it0)
                times = {name: [] for name in fns}
                for name in [*fns, *reversed(fns)]:
                    cuda_build._lib = _Lib(fns[name])
                    times[name].append(chip_smoke.cuda_ms(lambda: k1.lk_block(*args, **kw)))
                print(f"K1 win {win} P {P} {'cubic' if cubic else 'linear'} it0 {it0}: "
                      + ", ".join(f"{name} {min(t):.4f} ms" for name, t in times.items()))
    finally:
        cuda_build._lib = full
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
