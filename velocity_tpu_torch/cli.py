"""Command-line interface of the PyTorch port.

  python -m velocity_tpu_torch speed --video data/IMG_4134.MOV [--frames 20] ...
  python -m velocity_tpu_torch longvideo --video V.MOV --window 24 --overlap 3 ...
  python -m velocity_tpu_torch stills --images data/IMG_41*.JPG ...
  python -m velocity_tpu_torch annotate --video data/IMG_4238.MOV --corners x1,y1,...
  python -m velocity_tpu_torch vid2images --video V.MOV --out dir --step 10
  python -m velocity_tpu_torch bench [--clip synthetic|IMG_4119] [--mode scan|frames]

The flags, defaults and help of ``velocity_tpu/cli.py``, plus ``--device``
on ``speed``, ``longvideo``, ``stills`` and ``bench`` (default "cuda"; "cpu"
asks for the CPU; without a CUDA device the runners raise and the error
goes through), and ``bench``'s ``--clip`` and ``--mode``
(``bench_torch.py``). ``cmd_*`` hand ``args.video`` / ``args.images`` /
``args.annotation`` to the runners as they are, so a caller may put a reader
object or an ``Annotation`` there in place of a path.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _add_speed_args(sp):
    sp.add_argument("--video", required=True)
    sp.add_argument("--annotation", default=None, help=".mat/.npz plate annotation")
    sp.add_argument("--frames", type=int, default=None, help="number of frames")
    sp.add_argument("--start-frame", type=int, default=None)
    sp.add_argument("--read-speed", type=int, default=1, help="read every Nth frame")
    sp.add_argument("--msv-frame", type=int, default=5)
    sp.add_argument("--plate", default="Chile", help="plate country (Chile/EU)")
    sp.add_argument("--platform", default="iPhone 6s")
    sp.add_argument("--native-scale", type=float, default=0.5,
                    help="annotation native resolution -> video scale")
    sp.add_argument("--solver-dtype", default="float32",
                    choices=["float32", "float64"])
    sp.add_argument("--max-features", type=int, default=1024)
    sp.add_argument("--shard-features", type=int, default=0, metavar="N",
                    help="shard the track axis of the fb-LK over N devices "
                         "(a 'feature' mesh axis; the TP analog)")
    sp.add_argument("--car-affine", action="store_true",
                    help="car-anchored affine prior (two-motion-group "
                         "scenes; the stills driver forces this on)")
    sp.add_argument("--plot", default=None, help="write HTML report here")
    sp.add_argument("--json", action="store_true", help="print summary as JSON")
    sp.add_argument("--quiet", action="store_true")
    _add_device_arg(sp)


def _add_device_arg(sp):
    sp.add_argument("--device", default="cuda",
                    help="torch device to run on ('cuda' or 'cpu')")


def _pipeline_config(args):
    from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig

    return PipelineConfig(
        platform=args.platform,
        plate_country=args.plate,
        n_frames=args.frames if args.frames is not None else 20,
        read_speed=args.read_speed,
        start_frame=args.start_frame,
        native_scale=args.native_scale,
        msv_frame=args.msv_frame,
        tracker=TrackerConfig(
            max_features=args.max_features,
            shard_features=getattr(args, "shard_features", 0),
            car_affine=getattr(args, "car_affine", False),
        ),
        solver=SolverConfig(dtype=args.solver_dtype),
    )


def cmd_speed(args) -> int:
    from velocity_tpu_torch.pipeline.speedest import SpeedEstimator

    est = SpeedEstimator(_pipeline_config(args), device=args.device)
    res = est.run(
        args.video,
        annotation=args.annotation,
        n_frames=args.frames,
        start_frame=args.start_frame,
        verbose=not args.quiet,
    )
    if args.plot:
        from velocity_tpu_torch.viz import save_results_html

        path = save_results_html(res, args.plot)
        if not args.quiet:
            print(f"report written to {path}")
    if args.json:
        print(json.dumps({
            "speed_kmh": res.speed_kmh, "speed_std": res.speed_std,
            "residual_px": res.residual_px, "fps": res.timings["fps"],
        }))
    return 0


def cmd_longvideo(args) -> int:
    from velocity_tpu_torch.pipeline.longvideo import LongVideoRunner

    runner = LongVideoRunner(_pipeline_config(args), device=args.device)
    res = runner.run(
        args.video,
        annotation=args.annotation,
        n_frames=args.frames,
        start_frame=args.start_frame,
        window=args.window,
        overlap=args.overlap,
        checkpoint=args.checkpoint,
        resume=args.resume,
        ba_refine=not args.no_ba,
        verbose=not args.quiet,
    )
    out = {
        "speed_kmh": res.speed_kmh, "speed_std": res.speed_std,
        "residual_px": res.residual_px, "fps": res.timings["fps"],
        "windows": res.timings.get("windows"),
        "ba_refined": res.timings.get("ba_refined"),
    }
    if args.smooth:
        import numpy as np

        _dist, vfit = res.smoothed(args.smooth)
        out["speed_kmh_polyfit"] = float(np.nanmean(vfit[1:]))
        if not args.quiet:
            print(f"polyfit(deg {args.smooth}) speed = "
                  f"{out['speed_kmh_polyfit']:.2f} km/h")
    if args.json:
        print(json.dumps(out))
    return 0


def cmd_stills(args) -> int:
    from velocity_tpu_torch.pipeline.stills import StillsSpeedEstimator

    est = StillsSpeedEstimator(_pipeline_config(args), device=args.device)
    res = est.run(args.images, annotation=args.annotation, verbose=not args.quiet)
    if args.json:
        print(json.dumps({
            "speed_kmh": res.speed_kmh, "speed_std": res.speed_std,
            "residual_px": res.residual_px,
        }))
    return 0


def cmd_annotate(args) -> int:
    import numpy as np

    from velocity_tpu_torch.camera.annotations import Annotation, save_annotation

    vals = [float(v) for v in args.corners.split(",")]
    if len(vals) != 8:
        raise SystemExit("--corners must be 8 comma-separated values "
                         "(x1,y1,...,x4,y4 clockwise from top-right, native px)")
    q = np.asarray(vals, np.float32).reshape(4, 2)
    ann = Annotation(q=q, fname=args.video, start_frame=args.start_frame)
    out = args.out or (args.video + ".npz")
    save_annotation(out, ann)
    print(f"annotation written to {out}")
    return 0


def cmd_vid2images(args) -> int:
    from velocity_tpu_torch.ingest.video import dump_frames

    written = dump_frames(args.video, args.out, step=args.step, limit=args.limit)
    print(f"wrote {len(written)} frames")
    return 0


def add_bench_args(sp):
    """The flags of ``bench`` (and of ``bench_torch.py`` itself)."""
    sp.add_argument("--clip", default="synthetic", choices=["synthetic", "IMG_4119"],
                    help="the clip to time (IMG_4119 raises where its video is absent)")
    sp.add_argument("--mode", default="scan", choices=["scan", "frames"],
                    help="the scan runner or the per-frame driver")
    _add_device_arg(sp)


def cmd_bench(args) -> int:
    """Run ``bench_torch.py`` at the repository root with the flags given, as
    JAX's ``bench`` runs ``bench.py``; imported here, so that importing the
    CLI does not pull in the bench."""
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import bench_torch

    return bench_torch.main(["--clip", args.clip, "--mode", args.mode,
                             "--device", args.device])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="velocity_tpu_torch",
                                description="SfM vehicle speed estimation "
                                            "(PyTorch + CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("speed", help="video speed estimation")
    _add_speed_args(sp)
    sp.set_defaults(fn=cmd_speed)

    sp = sub.add_parser(
        "longvideo",
        help="full-length video: windowed tracking + per-window BA + resume",
    )
    _add_speed_args(sp)
    sp.add_argument("--window", type=int, default=24, help="frames per window")
    sp.add_argument("--overlap", type=int, default=3, help="shared frames")
    sp.add_argument("--smooth", type=int, default=0, metavar="DEG",
                    help="polyfit-smoothed speed of the given degree "
                         "(MATLAB runExample.m:185-190 parity; 0 = off)")
    sp.add_argument("--checkpoint", default=None, help="window-state .npz path")
    sp.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if present")
    sp.add_argument("--no-ba", action="store_true",
                    help="skip the per-window BA refinement")
    sp.set_defaults(fn=cmd_longvideo)

    sp = sub.add_parser("stills", help="stills-burst speed estimation")
    sp.add_argument("--images", nargs="+", required=True)
    sp.add_argument("--annotation", default=None)
    sp.add_argument("--plate", default="Chile")
    sp.add_argument("--platform", default="iPhone 6s")
    sp.add_argument("--solver-dtype", default="float32")
    sp.add_argument("--frames", type=int, default=None)
    sp.add_argument("--start-frame", type=int, default=None)
    sp.add_argument("--read-speed", type=int, default=1)
    sp.add_argument("--msv-frame", type=int, default=5)
    sp.add_argument("--native-scale", type=float, default=1.0)
    sp.add_argument("--max-features", type=int, default=1024)
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--quiet", action="store_true")
    _add_device_arg(sp)
    sp.set_defaults(fn=cmd_stills)

    sp = sub.add_parser("annotate", help="write a plate-corner annotation")
    sp.add_argument("--video", required=True)
    sp.add_argument("--corners", required=True)
    sp.add_argument("--start-frame", type=int, default=None)
    sp.add_argument("--out", default=None)
    sp.set_defaults(fn=cmd_annotate)

    sp = sub.add_parser("vid2images", help="dump every Nth frame to JPGs")
    sp.add_argument("--video", required=True)
    sp.add_argument("--out", default=None)
    sp.add_argument("--step", type=int, default=10)
    sp.add_argument("--limit", type=int, default=2000)
    sp.set_defaults(fn=cmd_vid2images)

    sp = sub.add_parser("bench", help="run the benchmark")
    add_bench_args(sp)
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
