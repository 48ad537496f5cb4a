"""The run's contract: the last line's keys, the card's look, the forbidden
modules by whole top-level name, and ``BENCHMARK.json`` against the files."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

import perfbench_tiny as tiny
import run
from pb import cells

ROOT = Path(__file__).resolve().parent.parent
REPO = ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_result_line_keys_and_checks_last():
    rec, line = tiny.run_tiny(tiny.siglip("siglip_seq.train_b16"), trace=1)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"logit_gap", "loss_gap", "step_gap"}     # grad_gap read only
    assert "grad_gap" in rec["numbers"]
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    json.loads(json.dumps(line))
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and UNIT.match(m["unit"]), name


def test_untraced_run_reports_its_end_to_end_metrics():
    _, line = tiny.run_tiny(tiny.siglip("siglip_seq.serve_pool8"), seconds=2.0)
    assert {"serve_obs_per_s", "serve_p90_ms", "setup_s"} <= set(line["metrics"])
    assert "train_samples_per_s" not in line["metrics"]
    assert "breakdown" not in line


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "siglip_seq.train_b16", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.fake_extension", object())
    monkeypatch.setitem(sys.modules, "bifold_tpu_torch_fake", object())
    assert run.forbidden_modules() == ["jaxlib"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r, %r]\n"
            "import perfbench_tiny as t, run\n"
            "t.run_tiny(t.siglip('siglip_seq.train_b16'))\n"
            "print(run.forbidden_modules())" % (str(REPO), str(ROOT), str(ROOT / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_benchmark_json_names_its_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    metric_files = {m.NAME: m for t in (0, 1) for m in cells.metrics(t)}
    for name, m in {**e2e, **per_layer}.items():
        assert NAME.match(name) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert name in metric_files and metric_files[name].UNIT == m["unit"], name
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in per_layer.values():
        assert m["moves"] in e2e and len(m["layer"]) <= 200
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
        assert (ROOT / "reference" / f"{c['name']}.py").is_file()
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"] == 1 and len(w["why"]) <= 200
        reported = {n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in per_layer.values())
