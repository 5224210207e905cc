"""The harness on the CPU: files found by name, the import guard, the span
arithmetic, and the refusal to measure without a card."""

from __future__ import annotations

import collections
import json
import sys

import pytest
import torch

from portbench import run as bench
from portbench.core import guard, spec, trace
from portbench.tests.conftest import PKG, ROOT


def test_every_cell_of_the_benchmark_has_its_files():
    b = spec.load_benchmark(ROOT)
    for w in b["workloads"]:
        cell = spec.Cell(b, w["name"], ROOT)
        assert cell.limits, f"{w['name']} has no limits file"
        cell.system(), cell.loop()
        e2e = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert set(cell.loop().E2E) <= e2e
        layers = cell.per_layer()
        assert layers and all(m["moves"] in e2e for m in layers)
        for m in layers:
            assert callable(cell.reader(m["name"]).read)


def test_new_config_mix_and_metric_are_found_by_their_files(tmp_path):
    """A later change adds a cell by adding files: nothing that exists is
    edited."""
    root, pkg = tmp_path, tmp_path / "pkg"
    (pkg / "traffic").mkdir(parents=True)
    (pkg / "metrics").mkdir()
    (pkg / "limits").mkdir()
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((PKG / "configs" / "resnet50_mrlal.json").read_text())
    cfg["layers"] = [3, 4, 23, 3]
    (root / "r101.json").write_text(json.dumps(cfg))
    b["configs"].append({"name": "resnet101_mrlal", "source": "x",
                         "file": "r101.json", "reduced": [], "why": "x"})
    (pkg / "traffic" / "serve_b64.json").write_text(json.dumps(
        {"kind": "serve_closed_loop", "batch": 64, "in_flight": 3,
         "dtype": "bfloat16", "check_images": 256}))
    (pkg / "metrics" / "answers_per_forward.serve.py").write_text(
        "def read(window):\n    return window.images / window.units\n")
    (pkg / "limits" / "resnet101_mrlal.serve.b64.json").write_text(
        json.dumps({"limits": {"logit_err": 0.5}}))
    b["workloads"].append({"name": "resnet101_mrlal.serve.b64",
                           "config": "resnet101_mrlal",
                           "traffic": "serve_b64", "chips": 1, "why": "x"})
    b["end_to_end"][0]["workloads"].append("resnet101_mrlal.serve.b64")
    b["per_layer"].append({"name": "answers_per_forward.serve",
                           "unit": "img", "better": "higher",
                           "source": "program_counter",
                           "layer": "serving engine", "moves": "img_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.Cell(spec.load_benchmark(root), "resnet101_mrlal.serve.b64",
                     root, pkg)
    assert cell.config["layers"] == [3, 4, 23, 3]
    assert cell.traffic["in_flight"] == 3
    assert cell.limits == {"logit_err": 0.5}
    assert [m["name"] for m in cell.end_to_end()] == ["img_per_s",
                                                      "setup_s"]
    # a metric without a list of cells goes to every cell that reports
    # the metric it moves
    names = [m["name"] for m in cell.per_layer()]
    assert names == ["answers_per_forward.serve"]
    win = trace.Window(False)
    win.units, win.images = 4, 256
    assert cell.reader("answers_per_forward.serve").read(win) == 64
    other = spec.Cell(spec.load_benchmark(root),
                      "resnet50_mrlal.train.b128", ROOT)
    assert "answers_per_forward.serve" not in [
        m["name"] for m in other.per_layer()]


@pytest.mark.parametrize("names, found", [
    (["mrla_tpu_torch", "mrla_tpu_torch.kernels._build"], []),
    (["mrla_tpu", "mrla_tpu.kernels"], ["mrla_tpu", "mrla_tpu.kernels"]),
    (["jax", "jax.numpy", "jaxlib", "flax.linen"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib"]),
    (["jaxtyping", "mrla_tpu_torchx", "flaxen"], []),
], ids=["port", "jax_package", "jax", "prefixes_alone"])
def test_guard_compares_top_level_names_whole(names, found):
    assert guard.banned_modules(names) == found


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        imported = guard.imported_names(path)
        assert not guard.banned_modules(imported), path
        if path.parent.name == "reference":
            assert not guard.banned_modules(
                imported, guard.REFERENCE_BANNED), path


def test_the_references_take_nothing_of_the_program_when_run():
    """Importing every reference loads neither the program nor JAX."""
    code = ("import sys\n"
            "import portbench.reference.resnet_mrlal, "
            "portbench.reference.deit_mrlal, portbench.reference.train\n"
            "from portbench.core import guard\n"
            "print(guard.banned_modules(sys.modules, "
            "guard.REFERENCE_BANNED))\n")
    import subprocess
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("spans, union", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 15)], 15),
    ([(0, 10), (2, 3), (20, 30)], 20),
    ([(20, 30), (0, 10), (10, 20)], 30),
    ([(0, 100), (10, 20), (30, 40), (90, 120)], 120),
], ids=["none", "one", "overlap", "nested_and_apart", "touching",
        "several_inside"])
def test_span_union_counts_overlaps_once(spans, union):
    assert trace.span_union_ns(spans) == union


def test_window_busy_breakdown_and_side_stream():
    win = trace.Window(False)
    win.ns0, win.ns1, win.t0, win.t1 = 0, 1000, 0.0, 1e-6
    win.events = [("gemm_a", 100, 300, 7), ("elementwise_b", 250, 400, 7),
                  ("spin_kernel", 0, 5, 13), ("normal_draw", 500, 600, 13),
                  ("Memcpy DtoH", 700, 750, 7)]
    win.side_ids = {13}
    win.spans = [("forward", 90, 450), ("wait", 450, 990)]
    assert win.busy_seconds() == pytest.approx(
        (5 + 300 + 100 + 50) / 1e9)
    assert [e[0] for e in win.kernels()] == ["gemm_a", "elementwise_b"]
    assert win.kernel_seconds(lambda n: True) == pytest.approx(350 / 1e9)
    assert win.union_seconds(lambda n: True) == pytest.approx(300 / 1e9)
    gaps = win.breakdown()["idle_gaps"]
    assert gaps[0] == ["wait", pytest.approx(250 / 1e9)]
    assert gaps[1] == ["forward", pytest.approx(100 / 1e9)]
    assert gaps[3] == ["before the first span", pytest.approx(95 / 1e9)]


def test_launch_counters_are_read_over_the_window():
    from mrla_tpu_torch.kernels.mrla_epilogue import fused_epilogue
    before = trace.launch_counters()
    fused_epilogue.counter.launch((2, 4, 4, 8))
    after = trace.launch_counters()
    key = "mrla_tpu_torch.kernels.mrla_epilogue.fused_epilogue"
    assert after[key] - before[key] == collections.Counter({(2, 4, 4, 8): 1})


@pytest.mark.parametrize("available, count", [(False, 0), (True, 0)],
                         ids=["no_card", "too_few_cards"])
def test_run_refuses_to_measure_without_a_card(monkeypatch, capsys,
                                               available, count):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(bench, "set_environment", lambda: None)
    called = []
    monkeypatch.setattr(bench, "run_cell", lambda *a, **k: called.append(a))
    rc = bench.main(["--workload", "resnet50_mrlal.serve.b128", "--seed",
                     "3", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and not called
    assert "card" in out.err


def test_run_prints_no_result_with_the_jax_package_loaded(monkeypatch,
                                                          capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bench, "set_environment", lambda: None)
    monkeypatch.setitem(sys.modules, "mrla_tpu", object())
    monkeypatch.setattr(bench, "run_cell", lambda *a, **k: {
        "_notes": {}, "_readings": {}, "checks": {}, "correct": True})
    rc = bench.main(["--workload", "resnet50_mrlal.serve.b128", "--seed",
                     "3", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "mrla_tpu" in out.err
