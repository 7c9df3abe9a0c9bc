"""Server daemon CLI (reference cmd/veneur/main.go): -f config.yaml,
-validate-config[-strict], and -device (default cuda; `-device cpu` runs
the kernels' plain versions on the CPU).

    python -m veneur_tpu_torch.cli.server -f config.yaml
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading


def main(argv=None):
    ap = argparse.ArgumentParser(prog="veneur-tpu-torch")
    ap.add_argument("-f", dest="config", required=True,
                    help="path to config YAML")
    ap.add_argument("-validate-config", action="store_true",
                    dest="validate")
    ap.add_argument("-validate-config-strict", action="store_true",
                    dest="validate_strict")
    ap.add_argument("-device", default="cuda",
                    help="torch device of the aggregation state "
                         "(default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    from veneur_tpu_torch.config import read_config
    logging.basicConfig(
        level=logging.DEBUG if "-v" in (argv or sys.argv) else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = read_config(args.config)
    if cfg.debug:
        logging.getLogger().setLevel(logging.DEBUG)
    if args.validate or args.validate_strict:
        if args.validate_strict and cfg.unknown_keys:
            print("config contains unknown keys: "
                  + ", ".join(cfg.unknown_keys), file=sys.stderr)
            return 1
        print("config valid")
        return 0

    from veneur_tpu_torch.server.factory import new_from_config
    server = new_from_config(cfg, device=args.device)
    server.exit_on_quit = True  # /quitquitquit ends the daemon process
    server.start()
    logging.getLogger("veneur_tpu_torch").info(
        "veneur-tpu-torch started: listeners=%s interval=%ss device=%s",
        cfg.statsd_listen_addresses, server.interval, server.device)

    stop = threading.Event()

    def _sig(_s, _f):
        stop.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    # einhorn-style graceful handoff (reference server.go:1357-1360: goji
    # graceful treats SIGUSR2/SIGHUP as "drain and exit so the supervisor
    # can hand the socket to a replacement")
    signal.signal(signal.SIGUSR2, _sig)
    # respect nohup/supervisors that ignore hangups
    if signal.getsignal(signal.SIGHUP) is not signal.SIG_IGN:
        signal.signal(signal.SIGHUP, _sig)
    stop.wait()
    server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
