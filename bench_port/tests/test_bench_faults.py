"""A whole run of each cell on the CPU at a test size (the harness's look
for a card skipped, the plain versions of the kernels): sound, it comes
out correct; with the control in the program's place, or with a fault
of `faults.py` planted under the timed path, it comes out not correct.
The exchange between chips is no fault here: every cell runs on one
chip."""

import time

import pytest

from bench_port import faults, harness

SIZES = {
    "local_100k.timers_zipf": {
        # compaction every other step: a test-size interval holds a few
        "server": {"tpu_histo_capacity": 4096, "tpu_compact_every": 2},
        "mix": {"lines": 60000, "warmup_lines": 10000, "backlog": [8, 4],
                "metrics": [{"type": "ms", "share": 1.0,
                             "prefix": "api.latency.", "names": 2000,
                             "zipf": 1.2,
                             "value": {"dist": "lognormal", "mean": 3.0,
                                       "sigma": 0.5, "decimals": 4},
                             "tag": {"key": "route", "value_prefix": "r",
                                     "values": 5, "every": 2}}]}},
}
CELLS = sorted(SIZES)


def _run(cell, control=False, seed=2**31 + 99):
    over = dict(SIZES[cell], interval_s=1.0)
    return harness.run_cell(cell, seed, 2.0, False, time.perf_counter(),
                            device="cpu", control=control, overrides=over,
                            log=lambda *a, **k: None)


def test_every_cell_has_a_test_size():
    assert CELLS == sorted(w["name"] for w in
                           harness.load_benchmark()["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    for m in r["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = _run(cell, control=True)
    assert not r["correct"]
    # it fails the exact numbers and the exact-key quantiles alike
    assert r["checks"]["exact_q_err"]["value"] > 10 * r["checks"][
        "exact_q_err"]["limit"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_caught(cell, fault):
    with faults.planted(fault):
        r = _run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_unsorted_compaction_is_caught_by_the_rank(cell):
    # it keeps every count, min and max: only rank_err sees it
    with faults.planted("unsorted_compaction"):
        c = _run(cell)["checks"]
    assert c["rank_err"]["value"] > c["rank_err"]["limit"]
    assert c["count_gap"]["value"] == 0 and c["minmax_gap"]["value"] == 0
