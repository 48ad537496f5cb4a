"""The port's data path against the JAX package's, on the CPU.

Raw records of the synthetic, bimanual (the tiny zarr groups and renders of
``tests/test_bimanual_data.py``) and real datasets (the captures of
``tests/test_real_dataset.py``) must equal the JAX package's byte for byte;
the loader's shuffled batch indices must equal JAX's over two epochs and
from a ``start_batch``; test-partition batches processed by the port must
equal JAX's ``process_batch`` within 1e-6 (f32, absolute; the port's resize
sums in another order); the metrics must summarise seeded actions as JAX's
do (1e-9 relative). The loader's prefetch thread must end when its iterator
is abandoned, and its per-batch generators must make a batch's augmentation
independent of the batches built before it.
"""

import json
import threading

import numpy as np
import pytest
import torch
from test_bimanual_data import (CATEGORY, IMAGE, PREFIX, _ds_cfg,  # noqa: F401
                                mini_dataset, write_zarr_array)
from test_real_dataset import IMAGE as REAL_IMAGE
from test_real_dataset import real_root  # noqa: F401

from bifold_tpu.data import DataLoader as JaxDataLoader
from bifold_tpu.data import build_dataset as jax_build_dataset
from bifold_tpu.data import collate as jax_collate
from bifold_tpu.env.action import Action as JaxAction
from bifold_tpu.metrics import Metrics as JaxMetrics
from bifold_tpu_torch.config import compose
from bifold_tpu_torch.data import DataLoader, build_dataset, collate
from bifold_tpu_torch.data.zarr_lite import Array, open_group
from bifold_tpu_torch.env.action import Action
from bifold_tpu_torch.metrics import Metrics


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads per test: the suite runs several workers at
    once, and torch's default (every core per process) oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


PROCESSED_ATOL = 1e-6


def _assert_records_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k
        else:
            assert type(g) is type(w) and g == w, k


def _synthetic_cfg(bimanual):
    extra = (["train_dataset.is_bimanual=true", "train_dataset.max_context_length=3",
              "model=siglip_sequential"] if bimanual else ["model=siglip"])
    return compose(["train_dataset=synthetic", "train_dataset.n_samples=12",
                    "train_dataset.image_size=64", "model.image_size=64",
                    "model.automodel_name=tiny", *extra])


def _both(ds_cfg, proc_cfg, partition, autoprocessor="tiny"):
    kw = dict(partition=partition, autoprocessor_name=autoprocessor, seed=3)
    return (build_dataset(ds_cfg, proc_cfg, **kw),
            jax_build_dataset(ds_cfg, proc_cfg, **kw))


@pytest.mark.parametrize("bimanual", [False, True], ids=["unimanual", "bimanual_context"])
def test_synthetic_records_match_jax(bimanual):
    cfg = _synthetic_cfg(bimanual)
    ours, theirs = _both(cfg.train_dataset, cfg.processor, "train")
    assert len(ours) == len(theirs) == 12
    for i in range(len(ours)):
        _assert_records_equal(ours[i], theirs[i])
    if bimanual:
        assert {int(ours[i]["ctx_count"]) for i in range(12)} > {0}


def test_loader_batch_indices_match_jax():
    cfg = _synthetic_cfg(False)
    ours, theirs = _both(cfg.train_dataset, cfg.processor, "train")
    a = DataLoader(ours, batch_size=5, shuffle=True, seed=11)
    b = JaxDataLoader(theirs, batch_size=5, shuffle=True, seed=11)
    assert len(a) == len(b) == 2
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        for start in (0, 1):
            got = [(i, list(g)) for i, g in a.index_batches(start)]
            want = [(i, list(g)) for i, g in b._index_batches(start)]
            assert got == want
        assert [a.batch_seed(i) for i in range(2)] == [
            int(np.random.default_rng([11, epoch, i]).integers(0, 2 ** 31 - 1))
            for i in range(2)]
    tail = DataLoader(ours, batch_size=5, shuffle=False, drop_last=False)
    assert len(tail) == 3
    assert [list(g) for _, g in tail.index_batches()] == [
        list(g) for _, g in JaxDataLoader(theirs, batch_size=5, shuffle=False,
                                          drop_last=False)._index_batches()]


@pytest.mark.parametrize("bimanual", [False, True], ids=["unimanual", "bimanual_context"])
def test_processed_test_batches_match_jax(bimanual):
    cfg = _synthetic_cfg(bimanual)
    ours, theirs = _both(cfg.train_dataset, cfg.processor, "test")
    records = [ours[i] for i in range(4)]
    got = ours.processor.process_batch(collate(records), "cpu")
    want = theirs.processor.process_batch(jax_collate([theirs[i] for i in range(4)]))
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, list):
            assert got[k] == w
            continue
        g = got[k].numpy()
        assert g.shape == np.shape(w) and g.dtype == np.asarray(w).dtype, k
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=PROCESSED_ATOL, err_msg=k)


@pytest.mark.parametrize("sequential", [False, True], ids=["bimanual", "bimanual_sequential"])
def test_bimanual_records_match_jax(mini_dataset, sequential):
    proc = compose(["model.image_size=64", "processor.spatial_augment=false"]).processor
    for partition in ("train", "test"):
        ours, theirs = _both(_ds_cfg(mini_dataset, sequential), proc, partition)
        assert len(ours) == len(theirs) == 3
        for i in range(3):
            _assert_records_equal(ours[i], theirs[i])
    got = ours.processor.process_batch(collate([ours[0], ours[1]]), "cpu")
    want = theirs.processor.process_batch(jax_collate([theirs[0], theirs[1]]))
    for k in ("rgb", "depth", "mask", "left_pick", "right_place"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=PROCESSED_ATOL, err_msg=k)


def test_real_records_and_instructions_match_jax(real_root):
    from bifold_tpu.data.real_dataset import get_instructions as jax_instructions
    from bifold_tpu_torch.data.real_dataset import get_instructions

    for category, steps in (("long_shirt", 3), ("short_shirt", 2), ("dress", 2),
                            ("pants", 2), ("towel", 2)):
        for step in range(steps):
            assert get_instructions(category, step) == jax_instructions(category, step)
    for category, step in (("long_shirt", 3), ("hat", 0), ("towel", 2)):
        with pytest.raises(ValueError):
            get_instructions(category, step)
    cfg = {"name": "real", "dataset_path": str(real_root), "depth_scale": 1000,
           "is_bimanual": True, "voxel_size": 0.0125, "neighbor_radius": 0.045,
           "num_nodes": 20, "max_context_length": 3, "image_size": REAL_IMAGE}
    proc = compose([f"model.image_size={REAL_IMAGE}"]).processor
    ours, theirs = _both(cfg, proc, "test")
    assert len(ours) == len(theirs) == 140
    for i in (0, 1, 77, 139):
        _assert_records_equal(ours[i], theirs[i])
    with pytest.raises(AssertionError):
        build_dataset(cfg, proc, partition="train", autoprocessor_name="tiny")


def test_zarr_lite_roundtrip(mini_dataset, tmp_path):
    import zlib

    g = open_group(mini_dataset / "vr_folding_dataset.zarr" / CATEGORY)
    verts = g["samples"][f"{PREFIX}_000004"]["mesh"]["cloth_verts"]
    arr = np.asarray(verts)
    assert arr.shape == (4, 3) and abs(arr[0, 0] - (-0.5 + 0.12 * 2)) < 1e-6
    np.testing.assert_array_equal(verts[[1, 3]], arr[[1, 3]])
    assert g["samples"][f"{PREFIX}_000004"].attrs["sample_id"] == 4
    # an array written by the JAX tests' writer, raw and zlib-compressed
    data = np.arange(30, dtype=np.int64).reshape(5, 6)
    write_zarr_array(tmp_path / "raw", data)
    np.testing.assert_array_equal(Array(tmp_path / "raw")[:], data)
    meta = json.loads((tmp_path / "raw" / ".zarray").read_text())
    (tmp_path / "z").mkdir()
    (tmp_path / "z" / ".zarray").write_text(json.dumps(
        dict(meta, compressor={"id": "zlib", "level": 1})))
    (tmp_path / "z" / "0.0").write_bytes(zlib.compress(data.tobytes()))
    np.testing.assert_array_equal(np.asarray(Array(tmp_path / "z")), data)


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "bifold-loader"]


def test_abandoned_prefetch_iterator_leaves_no_thread():
    cfg = _synthetic_cfg(False)
    ds = build_dataset(cfg.train_dataset, cfg.processor, partition="train",
                       autoprocessor_name="tiny")
    dl = DataLoader(ds, batch_size=2, shuffle=True, prefetch=2)
    it = iter(dl)
    first = next(it)
    assert first["rgb"].shape == (2, 3, 64, 64)
    assert _prefetch_threads()
    it.close()                        # abandoned after one batch
    assert not _prefetch_threads()
    for batch in dl:                  # a break mid-epoch
        break
    del batch
    assert not _prefetch_threads()
    assert len(list(dl)) == len(dl) == 6 and not _prefetch_threads()


def test_batch_augmentation_from_its_index_alone():
    """A batch's augmentation comes from (seed, epoch, batch index): an epoch
    restarted at batch 3 rebuilds batches 3.. as the full epoch built them,
    with spatial augmentation on."""
    cfg = _synthetic_cfg(True)
    ds = build_dataset(cfg.train_dataset, cfg.processor, partition="train",
                       autoprocessor_name="tiny", seed=5)
    dl = DataLoader(ds, batch_size=2, shuffle=True, seed=5)
    dl.set_epoch(1)
    full = list(dl)
    dl.start_batch = 3
    resumed = list(dl)
    assert len(resumed) == len(full) - 3
    for a, b in zip(full[3:], resumed):
        for k, v in a.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, b[k]), k
    dl.set_epoch(2)
    other = list(dl)
    assert not torch.equal(other[0]["rgb"], full[0]["rgb"])


def _actions_and_samples(seed, bimanual):
    rng = np.random.default_rng(seed)
    fields = (("left_pick", "right_pick", "left_place", "right_place") if bimanual
              else ("pick", "place"))
    b, s = 6, 32
    action = {f: rng.integers(-1, s, (b, 2)).astype(np.float32) for f in fields}
    sample = {f: np.where(rng.random((b, 8, 1)) < 0.3, -1.0,
                          rng.uniform(0, s, (b, 8, 2))).astype(np.float32)
              for f in fields}
    sample["mask"] = (rng.random((b, 1, s, s)) > 0.5).astype(np.float32)
    raw = {f"{f}_heatmap": rng.random((b, s, s)).astype(np.float32) for f in fields}
    raw["mask_heatmap"] = rng.random((b, s, s)).astype(np.float32)
    return action, sample, raw


@pytest.mark.parametrize("bimanual", [False, True], ids=["unimanual", "bimanual"])
def test_metrics_summary_matches_jax(bimanual):
    cfg = {"computed_metrics": ["kp_mse", "ap_5", "ap_10", "ap_20", "ap_50", "iou",
                                "quantile_prob"], "tracked_metric": "kp_mse"}
    ours, theirs = Metrics(cfg), JaxMetrics(cfg)
    for seed in range(3):
        action, sample, raw = _actions_and_samples(seed, bimanual)
        ours(action=Action(**action), sample=sample, raw_output=raw)
        theirs(action=JaxAction(**action), sample=sample, raw_output=raw)
    got, want = ours.summary(), theirs.summary()
    assert got[0] == want[0] and sorted(got[1]) == sorted(want[1])
    for k, v in want[1].items():
        np.testing.assert_allclose(got[1][k], v, rtol=1e-9, err_msg=k)
    assert ours.best_eval == theirs.best_eval
