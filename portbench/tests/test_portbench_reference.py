"""The references against the port computed in float32 on the CPU, at a
tiny size: the same weights, inputs and recipe give the same answers, so
what the benchmark compares at bf16 is precision, not a difference of
mathematics.  (The references themselves import nothing of the port.)"""

from __future__ import annotations

import json

import pytest

from portbench import run as bench

SEED = 2 ** 31 + 99


def _fp32(pkg):
    for path in (pkg / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        if t["kind"] == "serve_closed_loop":
            t["dtype"] = "float32"
        else:
            t["recipe"]["bf16"] = False
        path.write_text(json.dumps(t))


@pytest.mark.parametrize("workload", ["resnet50_mrlal.serve.b128",
                                      "deit_mrlal_small.serve.b256"])
def test_serving_reference_is_the_port_in_fp32(tiny, workload):
    root, pkg = tiny
    _fp32(pkg)
    res = bench.run_cell(workload, SEED, 0.2, False, "cpu", root, pkg=pkg)
    r = res["_readings"]
    assert r["logit_err"] < 1e-5 and r["logit_err_worst"] < 1e-5, r


@pytest.mark.parametrize("workload", ["resnet50_mrlal.train.b128",
                                      "deit_mrlal_small.train.b256"])
def test_training_reference_is_the_port_in_fp32(tiny, workload):
    root, pkg = tiny
    _fp32(pkg)
    res = bench.run_cell(workload, SEED, 0.2, False, "cpu", root, pkg=pkg)
    r, notes = res["_readings"], res["_notes"]
    # the first step from the same weights agrees to rounding; the tiny
    # ResNet's later steps amplify rounding (its loss grows several-fold
    # at lr 0.1), so they are held by the median leaf
    first, ref_first = notes["losses"][0], notes["ref_losses"][0]
    assert abs(first - ref_first) <= 1e-5 * abs(ref_first), notes
    assert r["grad_gap"] < 1e-4, r
    assert r["update_gap_median"] < 1e-2, r
    # the BN running statistics and the EMA follow the same rules
    assert r.get("stat_gap_median", 0.0) < 1e-2, r
    assert r.get("ema_gap", 0.0) < 1e-3, r
    assert ("stat_gap" in r) == workload.startswith("resnet"), r
    assert ("ema_gap" in r) == workload.startswith("deit"), r
