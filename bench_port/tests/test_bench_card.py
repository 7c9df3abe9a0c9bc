"""On the card, at each cell's own size: the control (the reference one
precision step down, in the program's place) and a compaction that
leaves out its sort each come out not correct. Marked `gpu`: without
a card these skip with a reason. On the card:
`python -m pytest -m gpu bench_port/tests -q`."""

import time

import pytest

from bench_port import faults, harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


def _run(cell, control=False):
    return harness.run_cell(cell, 2**31 + 7, 10.0, False,
                            time.perf_counter(), device="cuda",
                            control=control, log=lambda *a, **k: None)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_on_the_card_is_not_correct(cell, cuda):
    r = _run(cell, control=True)
    assert not r["correct"]
    assert r["checks"]["exact_q_err"]["value"] > 10 * r["checks"][
        "exact_q_err"]["limit"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_an_unsorted_compaction_on_the_card_is_not_correct(cell, cuda):
    with faults.planted("unsorted_compaction"):
        r = _run(cell)
    assert r["checks"]["rank_err"]["value"] > r["checks"]["rank_err"][
        "limit"]
