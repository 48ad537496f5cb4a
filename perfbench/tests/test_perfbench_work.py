"""The yardstick's arithmetic against hand counts: model FLOPs, flash
launch bytes and FLOPs, the bound, the roofline share, merged intervals."""

import math

import pytest

from pb import roofline, trace, work

H100 = work.PEAKS["H100"]


def test_stack_and_dense_flops_by_hand():
    stack = {"tokens": 10, "width": 4, "depth": 2, "mlp": 8, "passes": 3}
    # per layer: 2*10*(4*16 + 2*4*8) projections + 4*10*10*4 attention
    per_layer = 2 * 10 * (64 + 64) + 4 * 10 * 10 * 4
    assert work.stack_flops(stack, 0) == 2 * per_layer
    w = {"stacks": [stack], "dense": [{"m": 3, "k": 5, "n": 7, "passes": 2}]}
    assert work.sample_flops(w, 0, train=True) == 3 * 2 * per_layer + 2 * 2 * 3 * 5 * 7
    assert work.sample_flops(w, 0, train=False) == 2 * per_layer + 2 * 3 * 5 * 7


def test_kept_keys_and_frames_follow_the_context():
    stack = {"tokens": 10, "width": 2, "depth": 1, "mlp": 2, "passes": 1,
             "keys": {"base": 4, "per_context_frame": 2}, "per_sample": "frames",
             "context_slots": 3}
    for frames in range(4):
        kept = 4 + 2 * frames
        want = 4 * (2 * 10 * (4 * 4 + 2 * 2 * 2) + 4 * 10 * kept * 2)
        assert work.sample_flops({"stacks": [stack]}, frames, train=False) == want


def test_lora_adds_its_adapters_three_times_in_training():
    stack = {"tokens": 5, "width": 6, "depth": 2, "mlp": 6, "passes": 2,
             "lora": {"rank": 1, "targets": 2}}
    lora = 2 * 5 * (6 + 6) * 2 * 2
    assert work.lora_flops(stack) == lora
    assert (work.sample_flops({"stacks": [stack]}, 0, True)
            == 2 * work.stack_flops(stack, 0) + 3 * lora)


@pytest.mark.parametrize("kind,flop_factor,acts", [("fwd_infer", 4, 4), ("fwd_lse", 4, 4),
                                                   ("bwd", 10, 8)])
def test_flash_launch_counts(kind, flop_factor, acts):
    b, n, h, d = 2, 100, 3, 32
    kept = 150                     # summed over the batch
    flops, nbytes = work.flash_launch(kind, (b, n, h, d), kept, True)
    assert flops == flop_factor * h * n * kept * d
    lse = 0 if kind == "fwd_infer" else 4 * b * h * n
    assert nbytes == acts * b * n * h * d * 2 + 4 * b * n + lse


def test_bound_takes_the_slower_of_operations_and_bytes():
    t, by = work.bound(989e12, 1.0, H100)
    assert (t, by) == (pytest.approx(1.0), "operations")
    t, by = work.bound(1.0, 3.35e12, H100)
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = work.bound(67e12, 0.0, H100, "float32")     # 3xTF32 is faster than FMA
    assert t == pytest.approx(min(1.0, 3 * 67e12 / 495e12))
    assert work.card_peaks("NVIDIA H100 PCIe")[0] == 756e12


def test_roofline_share_by_hand():
    shape = (2, 100, 3, 32)
    record = {"flash_shapes": [["fwd_lse_d32", list(shape), 4], ["bwd_d32", list(shape), 4],
                               ["fwd_infer_d32", list(shape), 9]],
              "kernel_s": {"void flash_fwd_mma<32, true>(...)": 1e-3, "void dq_mma<32>": 1e-3,
                           "elementwise": 5.0},
              "flash_kept_per_step": [], "key_mask_dim": None}
    least = 0.0
    for kind in ("fwd_lse", "bwd"):
        least += 4 * work.bound(*work.flash_launch(kind, shape, 200, False), H100)[0]
    got = roofline.share(record, ("fwd_lse", "bwd"), ("flash_fwd_mma", "dkdv_mma", "dq_mma"))
    assert got == pytest.approx(100 * least / 2e-3)
    assert roofline.share(dict(record, kernel_s={}), ("bwd",), ("dq_mma",)) is None


def test_masked_launches_use_each_steps_kept_keys():
    shape = (2, 100, 3, 48)
    record = {"flash_shapes": [["fwd_lse_d48", list(shape), 6]], "kernel_s": {"flash_fwd_mma": 1.0},
              "flash_kept_per_step": [120, 160, 200], "key_mask_dim": 48}
    least = sum(2 * work.bound(*work.flash_launch("fwd_lse", shape, k, True), H100)[0]
                for k in (120, 160, 200))
    assert roofline.share(record, ("fwd_lse",), ("flash_fwd_mma",)) == pytest.approx(100 * least)


def test_merged_intervals_count_overlap_once():
    merged = trace.merge([(0, 2), (1, 3), (5, 6), (6, 7)])
    assert merged == [[0, 3], [5, 7]]
    assert sum(e - s for s, e in merged) == 5
    assert not math.isnan(sum(e - s for s, e in merged))
