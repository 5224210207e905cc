"""Each cell's comparison, driven through the rest of a run on the CPU at
a tiny size (``conftest.make_tiny``): a sound run is correct; the
lower-precision control in the program's place, and the timed path
broken underneath (``calibrate.FAULTS``: an answer altered where it is
produced, half of the batch left out, a step that returns its state
unchanged), are not.  The look for a card is skipped (``run_cell``)."""

from __future__ import annotations

import pytest

from portbench import calibrate
from portbench import run as bench

SEED = 2 ** 31 + 12345
SERVE = ["resnet50_mrlal.serve.b128", "deit_mrlal_small.serve.b256"]
TRAIN = ["resnet50_mrlal.train.b128", "deit_mrlal_small.train.b256"]
FAULTS = ([(w, f) for w in SERVE for f in ("answer", "half_batch")]
          + [(w, f) for w in TRAIN for f in ("half_batch", "unchanged")])


def _run(tiny, workload, variant):
    root, pkg = tiny
    return calibrate.readings(workload, SEED, 0.2, variant, "cpu", root,
                              pkg)


@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_a_sound_run_is_correct(tiny, workload):
    res = _run(tiny, workload, "program")
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_the_lower_precision_control_is_not_correct(tiny, workload):
    res = _run(tiny, workload, "control")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload, fault", FAULTS,
                         ids=[f"{w}-{f}" for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny, workload, fault):
    res = _run(tiny, workload, fault)
    assert not res["correct"], res["checks"]
    assert res["checks"]


def test_the_result_line_holds_the_contract_keys(tiny):
    root, pkg = tiny
    res = bench.run_cell(SERVE[0], SEED, 0.2, True, "cpu", root,
                         pkg=pkg)
    assert list(res)[:6] == ["correct", "attempted", "failed", "metrics",
                             "device", "breakdown"]
    assert list(res).index("checks") == len(res) - 3  # then _readings, _notes
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes", "busy_s", "window_s"}
