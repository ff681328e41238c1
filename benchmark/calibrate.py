"""Readings that the limits of a cell are set from (run on the card).

    python3 benchmark/calibrate.py --workload <name> --banks <b> [<b> ...]

For each bank (``scene.pool``; runs draw from bank 0), renders the pool a
run would render from it, drives each clip once through the cell's driver
(after the first clip every shape is warm), and judges it against the
reference, then judges the control (the reference's bfloat16 answers, on
the same clips) the same way. Prints one JSON line per bank: the
program's numbers and the control's, each the worst over the pool, as a
run reports them. A cell's lower reading of a number is the largest of the
program's over a dozen banks or more, its upper reading the smallest of
the control's; the limit lies between (``limits/<workload>.json``).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    import argparse

    import torch

    from benchmark import harness, scene
    from benchmark.reference import control, judge

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--banks", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _wl, config, traffic, _spec = harness.cell(args.workload)
    dev = torch.device("cuda")
    drv = harness.driver_class(traffic)(config, traffic, dev)
    n, msv = traffic["frames"], drv.pcfg.msv_frame
    gps = (config["gps_fix"], config["yaw_deg"]) if config.get("gps_fix") else None
    for bank in args.banks:
        prog, ctrl = [], []
        for clip in scene.pool(config["scene"], n, traffic["pool"], dev, bank):
            ans = drv(drv.prepare(clip))
            prog.append(judge.readings(ans, clip.truth, n, msv, gps))
            ctrl.append(judge.readings(control.answers(ans, clip.truth, gps), clip.truth, n, msv,
                                       gps))
        print(json.dumps({"workload": args.workload, "bank": bank, "program": judge.worst(prog),
                          "control": judge.worst(ctrl)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
