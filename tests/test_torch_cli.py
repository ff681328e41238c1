"""The port's command line (``velocity_tpu_torch/cli.py``) against the JAX
package's (``velocity_tpu/cli.py``) on the CPU.

The small clip of ``tests/_torch_clip.py`` is written to a lossless FFV1
``.avi`` with its annotation (``write_clip_file``); both packages' commands
read that file. JAX's ``speed`` runs once per module, and the port's
``speed`` draws JAX's RANSAC noise (``_inject``), so the two are held to
the run-level tolerances of the other parity tests: speed within 0.5%,
mean residual within 0.05 px. The port's command is held bit for bit to
its own ``SpeedEstimator.run`` on the same file and draws. The parsers
agree on subcommands, options, defaults and choices, except the port's
``--device`` (``speed``, ``longvideo``, ``stills``, ``bench``) and
``bench``'s ``--clip`` and ``--mode`` (``bench_torch.py``).
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_clip import _inject, _jax_gumbel_driver, make_clip, write_clip_file

from velocity_tpu import cli as jax_cli
from velocity_tpu.camera.annotations import load_annotation as jax_load_annotation
from velocity_tpu_torch import cli
from velocity_tpu_torch.camera.annotations import load_annotation
from velocity_tpu_torch.pipeline.longvideo import LongVideoRunner
from velocity_tpu_torch.pipeline.speedest import SpeedEstimator

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N_FRAMES = 8
SUBCOMMANDS = ["speed", "longvideo", "stills", "annotate", "vid2images", "bench"]
# the port's options absent from JAX's parser, with their defaults
PORT_ONLY = {"speed": {"--device": "cuda"}, "longvideo": {"--device": "cuda"},
             "stills": {"--device": "cuda"},
             "bench": {"--device": "cuda", "--clip": "synthetic", "--mode": "scan"}}
# the run-level parity tolerances (tests/test_torch_speedest.py)
SPEED_RTOL, RESIDUAL_ATOL_PX = 5e-3, 0.05
RANSAC_TRIALS = 1024  # TrackerConfig's default: the command line does not set it


def _run(main, argv):
    """(exit code, the JSON object of the last stdout line or None)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None)


@pytest.fixture(scope="module")
def clip_file(tmp_path_factory):
    return write_clip_file(make_clip(), tmp_path_factory.mktemp("clip"))


def _speed_argv(clip_file, command="speed"):
    video, annotation, scale = clip_file
    return [command, "--video", str(video), "--annotation", str(annotation), "--frames",
            str(N_FRAMES), "--native-scale", repr(scale), "--max-features", "128", "--json",
            "--quiet"]


def _with_jax_draws(fn):
    """``fn()`` with JAX's per-frame-driver noise handed to the port's RANSAC."""
    _, draws = _jax_gumbel_driver(N_FRAMES, trials=RANSAC_TRIALS)
    with pytest.MonkeyPatch.context() as mp:
        _inject(mp, list(draws))
        return fn()


@pytest.fixture(scope="module")
def jax_speed(clip_file):
    rc, out = _run(jax_cli.main, _speed_argv(clip_file))
    assert rc == 0
    return out


@pytest.fixture(scope="module")
def port_speed(clip_file):
    rc, out = _with_jax_draws(lambda: _run(cli.main, _speed_argv(clip_file)
                                           + ["--device", "cpu"]))
    assert rc == 0
    return out


def _jax_parser():
    """The parser JAX's ``main`` builds (captured at ``parse_args``)."""

    class Built(Exception):
        pass

    def capture(self, *args, **kwargs):
        raise Built(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(Built) as built:
            jax_cli.main([])
    return built.value.args[0]


def _surface(parser):
    """{subcommand: {option string: (default, choices, type, nargs, required,
    action class)}} of a parser with one level of subcommands."""
    (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return {name: {opt: (a.default, a.choices, a.type, a.nargs, a.required, type(a).__name__)
                   for a in sp._actions for opt in a.option_strings}
            for name, sp in sub.choices.items()}


def test_parsers_match_jax():
    port, jax = _surface(cli.build_parser()), _surface(_jax_parser())
    assert list(port) == list(jax) == SUBCOMMANDS
    for name in SUBCOMMANDS:
        extra = {opt: port[name].pop(opt) for opt in PORT_ONLY.get(name, {})}
        assert port[name] == jax[name], name
        for opt, spec in extra.items():
            assert opt not in jax[name] and spec[0] == PORT_ONLY[name][opt], (name, opt)


def test_help_lists_the_subcommands(capsys):
    with pytest.raises(SystemExit) as done:
        cli.main(["--help"])
    assert done.value.code == 0
    assert "{" + ",".join(SUBCOMMANDS) + "}" in capsys.readouterr().out


def test_module_entry_point_help():
    """``python -m velocity_tpu_torch --help`` runs ``__main__`` and exits 0."""
    out = subprocess.run([sys.executable, "-m", "velocity_tpu_torch", "--help"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert all(name in out.stdout for name in SUBCOMMANDS)


def test_annotate_roundtrip(tmp_path):
    """(JAX: ``tests/test_aux.py::TestCLI::test_annotate_roundtrip``)"""
    out = tmp_path / "X.MOV.npz"
    rc, _ = _run(cli.main, ["annotate", "--video", "X.MOV", "--corners",
                            "10,20,30,40,50,60,70,80", "--start-frame", "5", "--out", str(out)])
    assert rc == 0
    ann = load_annotation(out)
    assert ann.start_frame == 5
    np.testing.assert_allclose(ann.q[0], [10, 20])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_annotate_loads_equal_across_packages(tmp_path, writer):
    out = tmp_path / "V.MOV.npz"
    main = cli.main if writer == "port" else jax_cli.main
    rc, _ = _run(main, ["annotate", "--video", "V.MOV", "--corners",
                        "3761.4,1503,3755.5,1620.25,3390,1625,3391.5,1507.75", "--out", str(out)])
    assert rc == 0
    a, b = load_annotation(out), jax_load_annotation(out)
    np.testing.assert_array_equal(a.q, b.q)
    assert (a.fname, a.start_frame) == (b.fname, b.start_frame) == ("V.MOV", None)


def test_speed_json_equals_the_library_run(clip_file, port_speed):
    """``speed --json --device cpu`` prints what ``SpeedEstimator.run`` on
    the same file, config and draws returns, bit for bit."""
    video, annotation, _ = clip_file
    args = cli.build_parser().parse_args(_speed_argv(clip_file) + ["--device", "cpu"])
    res = _with_jax_draws(lambda: SpeedEstimator(cli._pipeline_config(args), device="cpu").run(
        str(video), annotation=str(annotation), n_frames=N_FRAMES, verbose=False))
    assert (port_speed["speed_kmh"], port_speed["speed_std"], port_speed["residual_px"]) == (
        res.speed_kmh, res.speed_std, res.residual_px)
    assert np.isfinite(res.S[1:, 8]).all() and res.S.shape == (N_FRAMES, 9)


def test_speed_matches_jax_cli(jax_speed, port_speed):
    """The port's ``speed`` against JAX's on the same file and noise: speed
    within SPEED_RTOL, mean residual within RESIDUAL_ATOL_PX."""
    assert abs(port_speed["speed_kmh"] - jax_speed["speed_kmh"]) <= SPEED_RTOL * abs(
        jax_speed["speed_kmh"]), (port_speed, jax_speed)
    assert abs(port_speed["residual_px"] - jax_speed["residual_px"]) <= RESIDUAL_ATOL_PX
    assert set(port_speed) == set(jax_speed) == {"speed_kmh", "speed_std", "residual_px", "fps"}


def test_longvideo_json_equals_the_library_run(clip_file):
    """``longvideo --json --device cpu`` (window 4, overlap 2, polyfit degree
    2) prints what ``LongVideoRunner.run`` returns on the same file."""
    video, annotation, _ = clip_file
    argv = _speed_argv(clip_file, "longvideo") + ["--device", "cpu", "--window", "4",
                                                  "--overlap", "2", "--smooth", "2"]
    rc, got = _run(cli.main, argv)
    assert rc == 0
    args = cli.build_parser().parse_args(argv)
    res = LongVideoRunner(cli._pipeline_config(args), device="cpu").run(
        str(video), annotation=str(annotation), n_frames=N_FRAMES, window=4, overlap=2,
        verbose=False)
    want = {"speed_kmh": res.speed_kmh, "speed_std": res.speed_std,
            "residual_px": res.residual_px, "windows": res.timings["windows"],
            "ba_refined": res.timings["ba_refined"],
            "speed_kmh_polyfit": float(np.nanmean(res.smoothed(2)[1][1:]))}
    assert {k: got[k] for k in want} == want
    assert np.isfinite(want["speed_kmh"])


@pytest.mark.parametrize("command", ["speed", "longvideo"])
def test_default_device_is_the_card(clip_file, command):
    """Without ``--device`` a command asks for CUDA; without a card the
    runner's error goes through (nothing runs on the CPU unasked)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(_speed_argv(clip_file, command))


@pytest.mark.parametrize("flags", [[], ["--clip", "IMG_4119", "--mode", "frames",
                                        "--device", "cpu"]])
def test_bench_runs_bench_torch_main(monkeypatch, flags):
    """``bench`` hands its flags (defaults filled in) to ``bench_torch.main``
    and returns its exit code; JAX's ``bench.py`` is never imported."""
    import bench_torch

    sys.modules.pop("bench", None)
    seen = []
    monkeypatch.setattr(bench_torch, "main", lambda argv: seen.append(argv) or 3)
    assert cli.main(["bench", *flags]) == 3
    want = dict(zip(flags[::2], flags[1::2]))
    assert seen == [["--clip", want.get("--clip", "synthetic"),
                     "--mode", want.get("--mode", "scan"),
                     "--device", want.get("--device", "cuda")]]
    assert "bench" not in sys.modules


def test_vid2images_matches_jax(clip_file, tmp_path):
    """Both packages dump the same frames to the same JPEG files."""
    video = str(clip_file[0])
    dirs = {name: tmp_path / name for name in ("port", "jax")}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        rc, _ = _run(main, ["vid2images", "--video", video, "--out", str(dirs[name]),
                            "--step", "3"])
        assert rc == 0
    port = sorted(p.name for p in dirs["port"].iterdir())
    assert port == sorted(p.name for p in dirs["jax"].iterdir()) and len(port) == 3
    for name in port:
        assert (dirs["port"] / name).read_bytes() == (dirs["jax"] / name).read_bytes()
