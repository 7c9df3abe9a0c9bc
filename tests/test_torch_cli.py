"""The port's daemon as a real process, on the CPU:

    python -m veneur_tpu_torch.cli.server -f config.yaml -device cpu

- `-validate-config` accepts a config and `-validate-config-strict`
  refuses one with unknown keys, as the JAX package's CLI does
  (tests/test_cli_server.py);
- the daemon ingests UDP lines, its ticker flushes them to the
  `flush_file` TSV (the local-file plugin), and SIGTERM ends it with
  exit code 0;
- without `-device cpu` it asks for the card, and on a box without one
  it exits non-zero saying so, before it binds anything.
"""

import os
import signal
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "veneur_tpu_torch.cli.server"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def _free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_config(tmp_path, port, interval="2s"):
    """A small table (the daemon runs the plain versions on the CPU) and
    the local-file plugin."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        f'interval: "{interval}"\n'
        f'statsd_listen_addresses: ["udp://127.0.0.1:{port}"]\n'
        'percentiles: [0.5]\n'
        'aggregates: ["count"]\n'
        'tpu_counter_capacity: 256\ntpu_gauge_capacity: 64\n'
        'tpu_status_capacity: 16\ntpu_set_capacity: 16\n'
        'tpu_histo_capacity: 64\n'
        'tpu_batch_counter: 512\ntpu_batch_gauge: 128\n'
        'tpu_batch_status: 16\ntpu_batch_set: 64\ntpu_batch_histo: 512\n'
        f'flush_file: "{tmp_path}/out.tsv"\n')
    return str(cfg)


def test_validate_config_modes(tmp_path):
    cfg = _write_config(tmp_path, 8126)
    ok = subprocess.run(CLI + ["-f", cfg, "-validate-config", "-device",
                               "cpu"], capture_output=True, text=True,
                        env=_env(), timeout=120)
    assert ok.returncode == 0 and "config valid" in ok.stdout, ok.stderr
    bad = tmp_path / "bad.yaml"
    bad.write_text('interval: "10s"\nnot_a_real_key: 1\n')
    lax = subprocess.run(CLI + ["-f", str(bad), "-validate-config"],
                         capture_output=True, text=True, env=_env(),
                         timeout=120)
    assert lax.returncode == 0 and "config valid" in lax.stdout
    strict = subprocess.run(CLI + ["-f", str(bad), "-validate-config-strict"],
                            capture_output=True, text=True, env=_env(),
                            timeout=120)
    assert strict.returncode == 1
    assert "not_a_real_key" in strict.stderr


def test_daemon_ticks_a_flush_file_and_exits_0_on_sigterm(tmp_path):
    port = _free_udp_port()
    cfg = _write_config(tmp_path, port)
    # daemon output to a FILE, not a pipe: an undrained pipe would block
    # the daemon's logging
    log_path = tmp_path / "daemon.log"
    tsv = tmp_path / "out.tsv"
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(CLI + ["-f", cfg, "-device", "cpu"],
                                stdout=log_f, stderr=subprocess.STDOUT,
                                env=_env())
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            deadline = time.time() + 60
            while time.time() < deadline:
                assert proc.poll() is None, (
                    f"daemon exited early rc={proc.returncode}:\n"
                    f"{log_path.read_text()[-2000:]}")
                tx.sendto(b"cli.torch:7|c|#src:clitest\ncli.torch.t:3|ms",
                          ("127.0.0.1", port))
                if tsv.exists() and "cli.torch" in tsv.read_text():
                    break
                time.sleep(0.5)
            body = tsv.read_text() if tsv.exists() else ""
            assert "cli.torch" in body, (
                "ticker never flushed the metric:\n"
                + log_path.read_text()[-2000:])
            row = next(ln for ln in body.splitlines()
                       if ln.startswith("cli.torch\t"))
            assert "src:clitest" in row
            assert any(ln.startswith("cli.torch.t.count\t")
                       for ln in body.splitlines())
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0, log_path.read_text()[-2000:]
        finally:
            tx.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def test_daemon_without_a_card_exits_nonzero(tmp_path):
    cfg = _write_config(tmp_path, _free_udp_port())
    res = subprocess.run(CLI + ["-f", cfg], capture_output=True, text=True,
                         env=_env(), timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
