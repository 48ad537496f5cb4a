"""The plain references against the port at a tiny size on the CPU, and the
check catching the control and the faults it has to catch.

In float32 the port and the reference compute the same steps and the same
heatmaps, so every number reads at rounding; the cells' own limits (set
from the card, ``PERF.md``) then hold for the bf16 port and fail for each
fault planted in the timed path: a step that leaves the state unchanged,
half of the batch left out, an answer altered where it is produced (one
chip: no exchange to leave out). The control, the reference in float8
products in the program's place, fails the served limit here and reads
far above the bf16 port in training.
"""

import pytest
import torch

import calibrate
import perfbench_tiny as tiny
from pb import check


def test_train_reference_follows_the_float32_port():
    rec, _ = tiny.run_tiny(tiny.siglip("siglip_seq.train_b16", "float32"))
    n = rec["numbers"]
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-5 and n["step_gap"] < 1e-3, n
    assert n["logit_gap"] < 1e-4, n


def test_rgb_clip_reference_follows_the_float32_port():
    with tiny.tiny_clip():
        rec, _ = tiny.run_tiny(tiny.rgb_clip("float32"))
    n = rec["numbers"]
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-5 and n["step_gap"] < 1e-3, n
    assert n["logit_gap"] < 1e-4, n


def test_serve_reference_decides_as_the_float32_port():
    rec, line = tiny.run_tiny(tiny.siglip("siglip_seq.serve_pool8", "float32"), seconds=0.5)
    assert rec["numbers"] == {"action_gap": 0.0}
    assert line["correct"] is True


def test_bf16_port_is_correct_under_the_cells_limits():
    _, line = tiny.run_tiny(tiny.siglip("siglip_seq.train_b16"))
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_train_faults_come_out_incorrect(fault):
    rec, line = tiny.run_tiny(tiny.siglip("siglip_seq.train_b16"), fault=fault)
    assert line["correct"] is False, line["checks"]
    if fault == "half_batch":           # rows of the first forward left without logits
        assert rec["numbers"]["logit_gap"] == float("inf")


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_rgb_clip_faults_come_out_incorrect(fault):
    with tiny.tiny_clip():
        rec, line = tiny.run_tiny(tiny.rgb_clip(), fault=fault)
    assert line["correct"] is False, line["checks"]
    if fault == "half_batch":
        assert rec["numbers"]["logit_gap"] == float("inf")


def test_serve_altered_answer_comes_out_incorrect():
    _, line = tiny.run_tiny(tiny.siglip("siglip_seq.serve_pool8"), seconds=0.5,
                            fault="altered")
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ["siglip_seq.train_b16", "rgb_clip.train_b256"])
def test_train_control_reads_far_above_the_program(cell):
    """The control (the reference in float8 products in the program's
    place) reads ``logit_gap`` at least 3x the bf16 port at the same seed:
    the separation the cell's limit rests on (on the card, ``PERF.md``)."""
    if cell.startswith("rgb_clip"):
        with tiny.tiny_clip():
            prog = tiny.run_tiny(tiny.rgb_clip())[0]["numbers"]
            ctl = calibrate.train_control(tiny.rgb_clip(), tiny.SEED, torch.device("cpu"))
    else:
        prog = tiny.run_tiny(tiny.siglip(cell))[0]["numbers"]
        ctl = calibrate.train_control(tiny.siglip(cell), tiny.SEED, torch.device("cpu"))
    assert ctl["logit_gap"] >= 3 * prog["logit_gap"], (ctl, prog)


def test_serve_control_fails_the_limits():
    c = tiny.siglip("siglip_seq.serve_pool8")
    correct, checks = check.verdict(calibrate.serve_control(c, tiny.SEED, torch.device("cpu")),
                                    c["limits"])
    assert correct is False, checks
