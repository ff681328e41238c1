"""The multi-process path of the port's ``parallel/``: two real processes
meet over gloo on the CPU (a free localhost port and a temporary directory
per run) and run the sharded solvers, rank 0's result held against the
single-process solver (mirror of ``tests/test_launch.py``). Each run takes
a few seconds here, so neither is marked slow."""

import pytest

from velocity_tpu_torch.parallel import launch


def test_two_process_distributed_ba():
    """ba_schur_sharded with the tracks over two ranks."""
    assert launch.selftest_multiprocess(nprocs=2)


def test_two_process_windowed_ba():
    """windowed_ba with two windows batched in each process and each
    window's tracks over two ranks (fix_rotations, pin_tracks=2)."""
    assert launch.selftest_multiprocess_windowed(nprocs=2)


def test_global_mesh_needs_the_process_group():
    """The process axis must span the group: without one there is no mesh."""
    with pytest.raises(ValueError):
        launch.global_mesh({"point": 2}, "point")
