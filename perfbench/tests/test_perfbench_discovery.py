"""A cell, a traffic mix, a configuration with its reference and a per-layer
metric, each added as a new file to a copy of ``perfbench/``, are found by
name and run, with no existing file edited."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

NEW_METRIC = '''"""Steps the traced window took."""

NAME, UNIT, TRACE = "steps_seen", "steps", 1


def read(record):
    return record.get("steps") or None
'''

DRIVE = '''
import json, sys, time
sys.path[:0] = [{repo!r}, {bench!r}]
import torch
import run
from pb import cells
cell = cells.load_cell("tiny_seq.train_b2")
rec = run.run_cell(cell, 2 ** 33 + 5, 0.2, 1, torch.device("cpu"), time.perf_counter())
rec["card"] = "cpu"
line = run.assemble(cell, rec, 1, {{"platform": "cpu", "kind": "cpu", "count": 1}})
print(json.dumps(line))
'''


def test_new_files_only(tmp_path):
    bench = tmp_path / "perfbench"
    shutil.copytree(ROOT, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    cfg = json.loads((bench / "configs" / "siglip_sequential.json").read_text())
    cfg["name"] = "siglip_tiny"
    cfg["model"].update(image_size=64, automodel_name="tiny", dim=64, r=2, depth=2, heads=4)
    cfg["towers"].update(layers=2, heads=4, mlp=256)
    cfg["processor"]["model_image_size"] = 64
    cfg["key_mask"] = {"head_dim": 16, "base": 82, "per_context_frame": 17}
    (bench / "configs" / "siglip_tiny.json").write_text(json.dumps(cfg))
    (bench / "reference" / "siglip_tiny.py").write_text(
        '"""The flagship\'s reference, at the tiny sizes of its file."""\n'
        "from siglip_sequential import *  # noqa: F401,F403\n"
        "from siglip_sequential import HEADS, LoraDropout  # noqa: F401\n")
    mix = json.loads((bench / "traffic" / "train_b16_bimanual_ctx.json").read_text())
    mix.update(batch=2, frame_px=64, label_px=[5, 58], cloth_px=32)
    (bench / "traffic" / "train_b2_tiny.json").write_text(json.dumps(mix))
    cell = json.loads((bench / "workloads" / "siglip_seq.train_b16.json").read_text())
    cell.update(config="siglip_tiny", traffic="train_b2_tiny", trace_steps=2)
    (bench / "workloads" / "tiny_seq.train_b2.json").write_text(json.dumps(cell))
    (bench / "metrics" / "steps_seen.py").write_text(NEW_METRIC)

    for rel, data in before.items():            # nothing that was there changed
        assert (bench / rel).read_bytes() == data
    out = subprocess.run([sys.executable, "-c", DRIVE.format(repo=str(ROOT.parent),
                                                             bench=str(bench))],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"]["steps_seen"] == {"value": 2, "unit": "steps"}
    assert "mfu.train" not in line["metrics"]      # the flagship's own metrics read its cells only
    assert line["correct"] is True, line["checks"]
