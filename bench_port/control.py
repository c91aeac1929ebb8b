"""The readings that a cell's correctness limits are set from, on the card:

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 \
        [--faults half_batch] [--seconds 1]

For each seed, in one process: the program's sound run through the
harness's own driver (a short window), the control (the plain reference in
the program's place, in the nearest lower precision the configuration
could tempt a change to: float8 for the bfloat16 train step, 16 rounds of
the law's 24 for a regen), and each fault the cell can have, planted
underneath the timed path.  Prints one JSON line a seed and mode: the
numbers compared and ``correct``, the run's own comparison with the limits
in ``workloads/<cell>.json`` (the control's through the driver's
``checks(fp8=True)``).  The limits lie between the sound runs' largest
reading and the smallest reading of the control and of each fault.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from bench_port import harness  # noqa: E402

#: the law's rounds in the control of a regen cell (SPEC.md §2: at 16
#: rounds most statistics converge, fixed points still leak)
CONTROL_ROUNDS = 16


def regen_readings(cell: dict, seed: int, seconds: float, device: str,
                   mode: str) -> dict:
    """``mode``: "sound", "control" (the reference law at CONTROL_ROUNDS
    in the program's place) or a fault name."""
    driver = harness.make_driver(cell, seed, device,
                                 fault=None if mode in ("sound", "control")
                                 else mode)
    driver.setup()
    if mode == "control":
        def fn(e):
            return driver.reference(e, device, rounds=CONTROL_ROUNDS)

        driver.fn = fn
    driver.window(seconds)
    driver.release()
    checks = driver.checks()
    out = {name: value for name, value, _ in checks}
    out["correct"] = all(v <= lim for _, v, lim in checks)
    return out


def train_readings(cell: dict, seed: int, seconds: float, device: str,
                   mode: str, rows=None) -> dict:
    driver = harness.make_driver(cell, seed, device,
                                 fault=None if mode in ("sound", "control")
                                 else mode)
    if rows is not None:
        driver._rows = lambda: rows
    driver.setup()
    driver.window(seconds)
    driver.release()
    checks = driver.checks(fp8=mode == "control")
    out = dict(driver.last_readings,
               correct=all(v <= lim for _, v, lim in checks))
    out["rows"] = driver.rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds of the sound runs; the "
                    "control and the faults take the first three")
    ap.add_argument("--faults", default="",
                    help="comma-separated faults to plant (traffic/)")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.card(cell["entry"]["chips"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = seeds[:3]  # the control's and the faults' seeds
    runs = [(s, "sound") for s in seeds] + [(s, "control") for s in cseeds]
    runs += [(s, f) for f in args.faults.split(",") if f for s in cseeds]
    train = cell["params"]["kind"] in ("train_loader", "train_dp")
    rows = None
    for seed, mode in runs:
        t0 = time.perf_counter()
        if train:
            r = train_readings(cell, seed, args.seconds, "cuda", mode, rows)
            rows = r.pop("rows")
        else:
            r = regen_readings(cell, seed, args.seconds, "cuda", mode)
        print(json.dumps(dict(workload=args.workload, seed=seed, mode=mode,
                              seconds=round(time.perf_counter() - t0, 2),
                              **r)), flush=True)
        found = harness.forbidden_modules()
        if found:
            print(f"forbidden modules loaded: {found}", file=sys.stderr)
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
