"""Run one cell of the benchmark of ``magellanmapper_torch``.

From the root of a checkout::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the cell's inputs on the card from the seed and warms the
program; then calls run for ``--seconds`` (whole calls: the last one ends
after the window); with ``--trace 1`` a few more calls run under the
profiler. The last line of standard output is one JSON object: the
end-to-end metrics (``--trace 0``) or the per-layer ones (``--trace 1``),
the device, and ``correct``, decided against the plain reference once
the program's state is freed; the numbers compared, with their limits,
come last there and on standard error. It exits non-zero without a
result when no CUDA card (or fewer than the cell asks for) is visible,
or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# build and kernel caches at fixed paths inside the checkout; the
# program's own kernel library goes to build/kernels
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", "portbench", _sub)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    import torch
    from portbench import harness
    cell = harness.by_name(harness.benchmark()["workloads"], args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell asks for {cell['chips']} cards; "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda:0", t_start=T_START)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
