"""Run one cell of the benchmark once:

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON object as the last line of standard output, and the
numbers compared with their limits as the last lines of standard error.
With `--control 1` the comparison judges the reference computed one
precision step down in the program's place (it must come out not
correct); the benchmark's own runs never pass it.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths (the
# port's kernels and engine build into veneur_tpu_torch/_build/ itself)
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / ".bench_cache" / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CHECKOUT / ".bench_cache" / "nv")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_port.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from bench_port import harness
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_PROCESS,
                              control=bool(args.control))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
