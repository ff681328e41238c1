"""Multi-process runtime entry (torch twin of ``velocity_tpu/parallel/launch.py``).

Every process runs the same program:

  1. ``initialize()`` calls ``torch.distributed.init_process_group`` with
     the address, world size and rank given (gloo on the CPU, NCCL where
     there are CUDA devices; nothing in the environment names a cluster);
  2. ``global_mesh()`` builds a mesh whose process axis spans the ranks
     (one shard per rank) and whose other axes run in process;
  3. the sharded solvers (``parallel/ba_dist.py``, ``parallel/windows.py``)
     run unchanged over that mesh: every process passes the same full
     arrays and runs its own shard, and the results come back whole on
     every rank.

``selftest_multiprocess()`` and ``selftest_multiprocess_windowed()`` check
the whole path without a cluster: they spawn real OS processes that meet
over gloo on the CPU (a free localhost port and a temporary directory per
call), run the point-sharded Schur BA, or the windowed BA with its tracks
sharded over the processes, and hold rank 0's result against the
single-process solver. NCCL cannot put two ranks on one GPU, so the
multi-process path is exercised over gloo only. CLI:

  python -m velocity_tpu_torch.parallel.launch --selftest
  python -m velocity_tpu_torch.parallel.launch --selftest-windowed
  python -m velocity_tpu_torch.parallel.launch --worker ...   (internal)
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
WORKER_TIMEOUT_S = 300


def initialize(init_method: str, world_size: int, rank: int) -> None:
    """Join the process group at ``init_method`` (e.g.
    ``tcp://localhost:29500``) as ``rank`` of ``world_size``."""
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)


def global_mesh(axis_sizes: dict[str, int] | None = None, process_axis: str = "point"):
    """A mesh over the process group (call after ``initialize``): axis
    ``process_axis`` spans the ranks (its size is the world size; -1 means
    that), the other axes run in process on this rank's device."""
    import torch.distributed as dist

    from velocity_tpu_torch.parallel.mesh import Mesh

    world = dist.get_world_size()
    sizes = dict(axis_sizes or {process_axis: -1})
    if sizes.get(process_axis, -1) == -1:
        sizes[process_axis] = world
    if sizes[process_axis] != world:
        raise ValueError(f"process axis {process_axis!r} of size {sizes[process_axis]} "
                         f"over {world} processes")
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    else:
        dev = torch.device("cpu")
    grid = np.empty(tuple(sizes.values()), dtype=object)
    grid.fill(dev)
    return Mesh(grid, tuple(sizes), process_axis=process_axis)


def run_distributed_ba(problem, mesh=None, axis: str = "point", config=None):
    """Point-sharded Schur BA over the process group: every rank passes the
    same full problem and receives the whole result."""
    from velocity_tpu_torch.config import BAConfig
    from velocity_tpu_torch.parallel.ba_dist import ba_schur_sharded

    if mesh is None:
        mesh = global_mesh({axis: -1}, axis)
    return ba_schur_sharded(problem, mesh, axis, config or BAConfig())


# --------------------------------------------------------------- selftest
def _intrinsics():
    from velocity_tpu_torch.geometry.projection import Intrinsics

    return Intrinsics(*(torch.tensor(v, dtype=torch.float32)
                        for v in (500.0, 500.0, 200.0, 150.0, 0.0)))


def _make_problem(nc=6, nt=64, seed=0):
    from velocity_tpu_torch.solvers.ba import BAProblem

    rng = np.random.default_rng(seed)
    pts = np.concatenate(
        [rng.uniform(-1, 1, (nt, 2)), rng.uniform(4, 6, (nt, 1))], axis=1
    ).astype(np.float32)
    cams = np.zeros((nc, 6), np.float32)
    cams[:, 0] = np.linspace(0, 0.4, nc)
    pc = pts[None] + cams[:, None, 0:3]
    pix = np.stack([500 * pc[..., 0] / pc[..., 2] + 200,
                    500 * pc[..., 1] / pc[..., 2] + 150], axis=-1)
    pix = (pix + rng.normal(0, 0.2, pix.shape)).astype(np.float32)
    pts0 = (pts + rng.normal(0, 0.02, pts.shape)).astype(np.float32)
    return BAProblem(intr=_intrinsics(), pixels=torch.as_tensor(pix),
                     mask=torch.ones((nc, nt), dtype=torch.bool),
                     points0=torch.as_tensor(pts0), cams0=torch.as_tensor(cams))


def _make_windowed_problem(nw=2, nc=6, nt=64, seed=1):
    rng = np.random.default_rng(seed)
    pix = np.zeros((nw, nc, nt, 2), np.float32)
    pts0 = np.zeros((nw, nt, 3), np.float32)
    cams0 = np.zeros((nw, nc, 6), np.float32)
    for w in range(nw):
        pts = np.concatenate(
            [rng.uniform(-1, 1, (nt, 2)), rng.uniform(4, 6, (nt, 1))], axis=1
        ).astype(np.float32)
        cams0[w, :, 0] = np.linspace(0, 0.4, nc)
        pc = pts[None] + cams0[w, :, None, 0:3]
        p = np.stack([500 * pc[..., 0] / pc[..., 2] + 200,
                      500 * pc[..., 1] / pc[..., 2] + 150], axis=-1)
        pix[w] = p + rng.normal(0, 0.2, p.shape)
        pts0[w] = pts + rng.normal(0, 0.02, pts.shape)
    return (torch.as_tensor(pix), torch.ones((nw, nc, nt), dtype=torch.bool),
            torch.as_tensor(pts0), torch.as_tensor(cams0), _intrinsics())


WINDOWED_KW = dict(fix_rotations=True, pin_tracks=2)


def _worker(kind: str, init_method: str, nprocs: int, rank: int, out: str) -> int:
    """One rank of a selftest: the sharded solve, rank 0 saving its result."""
    import torch.distributed as dist

    from velocity_tpu_torch.config import BAConfig

    torch.set_num_threads(1)
    initialize(init_method, nprocs, rank)
    try:
        if kind == "ba":
            mesh = global_mesh({"point": nprocs}, "point")
            got = run_distributed_ba(_make_problem(), mesh, "point",
                                     BAConfig(max_iters=6)).points
        else:
            from velocity_tpu_torch.parallel.windows import windowed_ba

            # windows batched in process, each window's tracks over the ranks
            mesh = global_mesh({"window": 2, "point": nprocs}, "point")
            _p, got, _i = windowed_ba(*_make_windowed_problem(), mesh,
                                      config=BAConfig(max_iters=6), **WINDOWED_KW)
        if rank == 0:
            np.save(out, got.numpy())
            print(f"{kind} worker 0: mesh {mesh.shape}, {dist.get_world_size()} processes "
                  f"over {dist.get_backend()} ok", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(kind: str, nprocs: int):
    """Run the ``kind`` selftest workers over gloo on the CPU; rank 0's
    result, or None where a worker failed."""
    init = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as d:
        out = str(Path(d) / "rank0.npy")
        procs = [subprocess.Popen([sys.executable, "-m", "velocity_tpu_torch.parallel.launch",
                                   "--worker", kind, init, str(nprocs), str(rank), out],
                                  env=env, cwd=ROOT)
                 for rank in range(nprocs)]
        try:
            rc = [p.wait(timeout=WORKER_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rc):
            print(f"selftest {kind}: worker exit codes {rc}")
            return None
        return np.load(out)


def selftest_multiprocess(nprocs: int = 2) -> bool:
    """Spawn ``nprocs`` processes, run the point-sharded BA over them, and
    hold the points against the single-process Schur solver."""
    from velocity_tpu_torch.config import BAConfig
    from velocity_tpu_torch.solvers.schur import ba_schur

    got = _spawn("ba", nprocs)
    if got is None:
        return False
    ref = ba_schur(_make_problem(), BAConfig(max_iters=6)).points.numpy()
    ok = np.allclose(got, ref, atol=1e-5)
    print(f"selftest_multiprocess: {'OK' if ok else 'MISMATCH'} "
          f"(max diff {np.abs(got - ref).max():.2e})")
    return ok


def selftest_multiprocess_windowed(nprocs: int = 2) -> bool:
    """The windowed BA with its tracks sharded over ``nprocs`` processes
    against the same call on a 1 x 1 mesh in this process (same math, no
    collectives)."""
    from velocity_tpu_torch.config import BAConfig
    from velocity_tpu_torch.parallel.mesh import make_mesh
    from velocity_tpu_torch.parallel.windows import windowed_ba

    got = _spawn("windowed", nprocs)
    if got is None:
        return False
    mesh = make_mesh({"window": 1, "point": 1}, devices=["cpu"])
    _p, ref, _i = windowed_ba(*_make_windowed_problem(), mesh, config=BAConfig(max_iters=6),
                              **WINDOWED_KW)
    ref = ref.numpy()
    ok = np.allclose(got, ref, atol=1e-5)
    print(f"selftest_multiprocess_windowed: {'OK' if ok else 'MISMATCH'} "
          f"(max diff {np.abs(got - ref).max():.2e})")
    return ok


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--worker"]:
        return _worker(argv[1], argv[2], int(argv[3]), int(argv[4]), argv[5])
    if argv[:1] == ["--selftest"]:
        return 0 if selftest_multiprocess() else 1
    if argv[:1] == ["--selftest-windowed"]:
        return 0 if selftest_multiprocess_windowed() else 1
    print(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main())
