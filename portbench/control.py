"""The readings that a cell's limits are set from.

From the root of a checkout, on the card::

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 1 2 3

For each seed, in one process: the cell's inputs and program as a run
makes them; with the seed in ``--seeds``, one call of the program as the
configuration states it (a sound reading); with the seed in
``--control-seeds``, one call with the program's own lower-precision
route switched on (the configuration's ``lower_precision``: TF32 band
products in the LoG); then, with the program's state freed, the
reference, and each call's compared numbers. One JSON line a seed. The
benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(name: str, seed: int, sound: bool, control: bool,
             fault: str = "", device="cuda:0", parts=None) -> dict:
    """One seed's compared numbers: of the sound call, of the control,
    and of a call with ``fault`` (of ``faults.py``) planted."""
    from portbench import faults
    from portbench import harness
    cell, config, traffic, limits = parts or harness.cell_parts(
        harness.benchmark(), name)
    drv = harness.driver_module(traffic["driver"]).Driver(
        config, traffic, seed, device)
    drv.setup()
    outs, kinds = [], []
    if sound:
        outs.append(drv.once()["out"])
        kinds.append("sound")
    if control:
        with drv.lower_precision():
            outs.append(drv.once()["out"])
        kinds.append("control")
    if fault:
        with faults.planted(traffic["driver"], fault):
            outs.append(drv.once()["out"])
        kinds.append(fault)
    drv.release()
    t0 = time.perf_counter()
    ref = drv.reference()
    got = drv.check(outs, ref)
    return {"seed": seed, "reference_s": time.perf_counter() - t0,
            "limits": limits, **dict(zip(kinds, got))}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault", default="",
                        help="a fault of faults.py, planted on --fault-seeds")
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 2
    seeds = list(dict.fromkeys(
        args.seeds + args.control_seeds + args.fault_seeds))
    for seed in seeds:
        line = readings(args.workload, seed, seed in args.seeds,
                        seed in args.control_seeds,
                        args.fault if seed in args.fault_seeds else "")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
