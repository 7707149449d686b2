"""The readings the limits of ``correct`` are set from, for one cell:

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 [--control] [--fault]

For each seed, in one process: the port's run with a window of one
segment, judged against the float64 reference as a benchmark run judges
it (the lower readings); with ``--control``, also the reference itself
computed at the next precision below the configuration's (float32 with
TF32 matrix products) in the port's place (the upper readings); with
``--fault``, also the reference with half of the likelihood's samples in
the port's place (a planted fault). Prints one
JSON line a seed and a last line with each number's largest port reading
and smallest control reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import compare, datagen, harness, spec  # noqa: E402


def _in_port_place(cell, states, ref):
    """The numbers of a reference run put in the port's place."""
    port = {"start": states["start"], "end": states["end"],
            "stage_out": states["stage"], "replay": 0.0}
    return harness.judge_run(cell, port, ref)


def control_numbers(cell, seed, device, stage, ref):
    """The control's numbers for ``seed``: the reference at float32 with
    TF32 products in the port's place, its likelihood stage at the port's
    recorded inputs ``stage``, against the float64 reference ``ref``."""
    from portbench.reference.common import CONTROL

    x = datagen.make_data(cell.config).x
    low = harness.reference_states(cell, x, seed, CONTROL, device, stage)
    return _in_port_place(cell, low, ref)


def fault_numbers(cell, seed, device, stage, ref):
    """A planted fault's numbers for ``seed``: the reference with half of
    the likelihood's Monte Carlo samples (the mean taken over the rest) in
    the port's place."""
    from portbench.reference.common import REFERENCE

    x = datagen.make_data(cell.config).x
    cfg = dict(cell.config, n_grad_mc_samples=cell.config[
        "n_grad_mc_samples"] // 2)
    half = harness.reference_states(cell._replace(config=cfg), x, seed,
                                    REFERENCE, device, stage)
    return _in_port_place(cell, half, ref)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", action="store_true",
                        help="also the half-samples fault's numbers")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = spec.load_cell(args.workload)
    port_max, control_min = {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        line, port, run = harness.run_cell(cell, seed, 0.0, False,
                                           args.device)
        stage, ref = run["port"]["stage_in"], run["ref"]
        for k, v in port.items():
            port_max[k] = max(port_max.get(k, v), v)
        out = {"seed": seed, "port": port, "correct": line["correct"]}
        if args.control:
            ctl = control_numbers(cell, seed, args.device, stage, ref)
            for k, v in ctl.items():
                control_min[k] = min(control_min.get(k, v), v)
            out["control"] = ctl
            out["control_correct"] = compare.judge(ctl, cell.config["limits"])
        if args.fault:
            out["half_samples"] = fault_numbers(cell, seed, args.device,
                                                stage, ref)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    print(json.dumps({"port_max": port_max, "control_min": control_min}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
