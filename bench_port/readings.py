"""The readings a comparison's limits are set from, on the card at a
cell's own size, many runs in one process:

    python3 -m bench_port.readings --workload <cell> --seconds <s> \
        --seeds <n,n,...> --modes sound,control,unsorted_compaction

`sound` runs the program as the benchmark does; `control` judges the
reference one precision step down in the program's place; any other
mode plants that fault of `faults.py` under the timed path. Prints one
JSON line a run: the mode, the seed, `correct` and each number compared
beside its limit. The benchmark's own runs never come here.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from bench_port import run  # noqa: E402,F401  (the caches' directories)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_port.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="sound")
    args = ap.parse_args(argv)
    from bench_port import faults, harness
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            fault = (faults.planted(mode)
                     if mode not in ("sound", "control")
                     else contextlib.nullcontext())
            t0 = time.perf_counter()
            with fault:
                r = harness.run_cell(args.workload, seed, args.seconds,
                                     False, time.perf_counter(),
                                     control=mode == "control",
                                     log=lambda *a, **k: None)
            print(json.dumps(dict(
                mode=mode, seed=seed, correct=r["correct"],
                wall_s=round(time.perf_counter() - t0, 1),
                checks={n: c["value"] for n, c in r["checks"].items()},
                metrics={n: m["value"] for n, m in r["metrics"].items()})),
                flush=True)
    print(f"readings: {time.perf_counter() - T_PROCESS:.1f} s in all",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
