"""CLI: python -m veneur_tpu_torch.analysis [--all | PASS ...] [--json]
[--list] [--root DIR]."""

from __future__ import annotations

import argparse
import sys

from veneur_tpu_torch.analysis import PASSES, run_cli


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m veneur_tpu_torch.analysis",
        description="vtlint: static analysis for the PyTorch/CUDA port")
    ap.add_argument("passes", nargs="*", metavar="PASS",
                    help="pass names to run (see --list)")
    ap.add_argument("--all", action="store_true",
                    help="run every registered pass")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON object")
    ap.add_argument("--list", action="store_true",
                    help="list registered passes and exit")
    ap.add_argument("--root", default=None,
                    help="project root (default: this repo)")
    args = ap.parse_args(argv)

    if args.list:
        for name, mod in PASSES.items():
            print(f"{name:16s} {mod.DOC}")
        return 0
    if args.all:
        names = list(PASSES)
    else:
        names = args.passes
    if not names:
        ap.error("give pass names, or --all / --list")
    unknown = [n for n in names if n not in PASSES]
    if unknown:
        ap.error(f"unknown pass(es): {', '.join(unknown)} "
                 "(see --list)")
    return run_cli(names, root=args.root, as_json=args.json)


if __name__ == "__main__":
    sys.exit(main())
