"""The port's vr-folding action mining and partition builder against the JAX
package's, on a mini vr-folding zarr made here from a numpy seed.

The store has two categories (Tshirt and Towel) of two instances each, on a
7 x 7 grid mesh whose NOCS coordinates name its sides. Its grasps cover
each branch of the mining: a sleeve pick, a one-arm action with either
arm, a grasp too short to keep, a pick that equals its place (a refine), a
place whose two arms disagree on both sides (the heuristics), a pick that
no side names (the instance is ignored from there on), and two action ends
whose mesh has an exploded corner vertex (``bad_sequence``).

Held:
- ``create_groups_df`` equal column by column (JAX after ``random.seed(s)``,
  the port given ``random.Random(s)``);
- the partition builder's CLI (run in-process through ``runpy``) writing
  ``<category>_actions.csv``, ``train.csv`` and ``test.csv`` byte-equal to
  JAX's, on the fresh path (mined from the zarr) and again on the cached
  path (the category CSVs re-read by ``pd.read_csv``);
- ``filter_bad_meshes`` equal on its three methods, clean and exploded.
"""

import random
import runpy
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from bifold_tpu.data import vr_folding as jax_vr
from bifold_tpu_torch.data import vr_folding as port_vr
from bifold_tpu_torch.data.zarr_lite import open_group

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_bimanual_data import write_zarr_array, write_zarr_group  # noqa: E402

N = 7                                   # grid vertices a side
FRAMES = 28
STEP = 1.0 / (N - 1)


def vid(i, j):
    """Vertex id of column i (NOCS x = i / 6: >= 0.5 is "left") and row j
    (NOCS z = j / 6: >= 0.5 is "top")."""
    return j * N + i


def grid():
    i, j = np.meshgrid(np.arange(N), np.arange(N))
    i, j = i.reshape(-1), j.reshape(-1)
    nocs = np.stack([i * STEP, np.zeros(N * N), j * STEP], 1).astype(np.float32)
    faces = []
    for r in range(N - 1):
        for c in range(N - 1):
            a = vid(c, r)
            faces += [[a, a + 1, a + N], [a + 1, a + N + 1, a + N]]
    return nocs, np.asarray(faces, np.int64), i, j


# Each action: (start, end, {arm: grip vertex ids}, [(moved vertices, d)]).
# Between start and end the moved vertices travel a growing share of d (all
# of it at end); after the end they spring back. Moving whole column ranges
# stretches only the edges along their boundary, so only the exploded
# corner trips the z-score test.
def columns(lo, hi):
    _, _, i, _ = grid()
    return np.nonzero((i >= lo) & (i <= hi))[0]


INSTANCES = {
    "Tshirt": {
        "00001_Tshirt_000000": {
            "actions": [
                # sleeve: both arms top-left
                (2, 9, {"l": [vid(6, 6), vid(6, 5)], "r": [vid(5, 6)]},
                 [(columns(4, 6), (-3 * STEP, 0.0, 0.0))]),
                # left arm only, bottom right -> bottom left
                (12, 19, {"l": [vid(1, 1)]}, [(columns(0, 2), (4 * STEP, 0.0, 0.0))]),
                # right arm, too fast to keep (4 frames)
                (22, 25, {"r": [vid(3, 3)]}, [(columns(3, 3), (0.0, 0.3, 0.0))]),
            ],
            "exploded": [19],
        },
        "00002_Tshirt_000001": {
            "actions": [
                # pick "bottom"; the arms' places disagree on both sides:
                # the heuristics place it "top"
                (2, 10, {"l": [vid(4, 1)], "r": [vid(2, 1)]},
                 [(columns(4, 6), (-2 * STEP, 0.0, 3 * STEP)),
                  (columns(0, 2), (2 * STEP, 0.0, 0.0))]),
                # lifted and set down where it was: a refine
                (13, 20, {"l": [vid(0, 0)], "r": [vid(1, 0)]},
                 [(columns(0, 1), (0.0, 0.12, 0.0))]),
            ],
            "exploded": [],
        },
    },
    "Towel": {
        "00003_Towel_000000": {
            "actions": [
                # left -> right
                (1, 8, {"l": [vid(6, 6)], "r": [vid(6, 0)]},
                 [(columns(4, 6), (-4 * STEP, 0.0, 0.0))]),
                # right arm only, top left -> bottom left
                (11, 18, {"r": [vid(3, 3)]}, [(columns(3, 3), (0.0, 0.0, -3 * STEP))]),
            ],
            "exploded": [8],
        },
        "00004_Towel_000001": {
            "actions": [
                # left arm only, top left -> bottom right
                (2, 9, {"l": [vid(5, 5)]}, [(columns(5, 6), (-4 * STEP, 0.0, -4 * STEP))]),
                # no side names the pick: the instance is ignored from here
                (12, 19, {"l": [vid(4, 1)], "r": [vid(2, 5)]},
                 [(columns(0, 6), (0.0, 0.2, 0.0))]),
                (21, 27, {"l": [vid(6, 6)]}, [(columns(6, 6), (0.0, 0.3, 0.0))]),
            ],
            "exploded": [],
        },
    },
}


def build_store(root: Path, seed: int = 0) -> Path:
    """The mini vr-folding dataset under root: ``vr_folding_dataset.zarr``
    with one group per category; returns root."""
    rng = np.random.default_rng(seed)
    nocs, faces, _, _ = grid()
    zroot = root / "vr_folding_dataset.zarr"
    write_zarr_group(zroot)
    for category, instances in INSTANCES.items():
        write_zarr_group(zroot / category)
        samples = zroot / category / "samples"
        write_zarr_group(samples)
        for instance, spec in instances.items():
            base = np.stack([nocs[:, 0] - 0.5, nocs[:, 1], nocs[:, 2] - 0.5], 1)
            base = base + rng.normal(0.0, 1e-3, base.shape)
            for t in range(FRAMES):
                verts = base.copy()
                grips = {"l": [-1], "r": [-1]}
                for start, end, arms, moves in spec["actions"]:
                    if start <= t <= end:
                        for moved, d in moves:
                            verts[moved] += (t - start) / (end - start) * np.asarray(d)
                        grips.update(arms)
                if t in spec["exploded"]:
                    verts[vid(0, N - 1)] += 50.0
                g = samples / f"{instance}_{t:06d}"
                write_zarr_group(g, attrs={"instance_id": instance, "garment_name": category,
                                           "sample_id": t})
                write_zarr_group(g / "mesh")
                write_zarr_array(g / "mesh" / "cloth_verts", verts.astype(np.float32))
                write_zarr_array(g / "mesh" / "cloth_nocs_verts", nocs)
                write_zarr_array(g / "mesh" / "cloth_faces_tri", faces)
                write_zarr_group(g / "grip_vertex_id")
                for arm, name in (("l", "left"), ("r", "right")):
                    write_zarr_array(g / "grip_vertex_id" / f"{name}_grip_vertex_id",
                                     np.asarray(grips[arm], np.int64))
    return root


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return build_store(tmp_path_factory.mktemp("vr_folding"))


@pytest.fixture(autouse=True)
def _global_random():
    """The JAX package draws from the global ``random``: put it back."""
    state = random.getstate()
    yield
    random.setstate(state)


@pytest.mark.parametrize("category", list(INSTANCES))
@pytest.mark.parametrize("seed", [0, 7])
def test_create_groups_df_matches_jax(store, category, seed, capsys):
    samples = open_group(store / "vr_folding_dataset.zarr" / category)["samples"]
    random.seed(seed)
    want = jax_vr.create_groups_df(samples)
    jax_out = capsys.readouterr().out
    got = port_vr.create_groups_df(samples, random.Random(seed))
    assert capsys.readouterr().out == jax_out
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for column in want.columns:
        pd.testing.assert_series_equal(got[column], want[column], check_exact=True)
    # the store reaches the branches it was built for
    text = " ".join(got["text"])
    if category == "Tshirt":
        assert len(got) == 4 and got["bad_sequence"].tolist() == [False, True, False, False]
        assert isinstance(got["left_start_idx"][1], str) and pd.isna(got["right_start_idx"][1])
        assert "only using the left arm" in got["text"][1]
        assert "Using heuristics." in got["info"][2]
        assert "Same pick and place location." in got["info"][3]
        assert "00001_Tshirt_000000_000022" not in got["right_start_idx"].tolist()
    else:
        assert len(got) == 3 and got["bad_sequence"].tolist() == [True, False, False]
        assert "only using the right arm" in got["text"][1]
        assert "Ignoring 00004_Towel_000001" in jax_out
    assert "towel" in text or "tshirt" in text


def _run_cli(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module, *argv])
    runpy.run_module(module, run_name="__main__", alter_sys=False)


def _outputs(path: Path):
    return {p.name: p.read_bytes() for p in sorted(path.glob("*.csv"))}


@pytest.mark.parametrize("argv", [["--seed", "3"], ["--seed", "42", "--train_portion", "0.5",
                                                    "--no-remove_bad_sequences"]],
                         ids=["seed3", "seed42-keep-bad"])
def test_partition_builder_matches_jax_bytes(store, argv, tmp_path, monkeypatch, capsys):
    """Both CLIs on one store (the actions dirs are siblings of the zarr
    root): the fresh path mines and writes every CSV, the second run reads
    the category CSVs back; each file byte-equal to JAX's."""
    import shutil

    root = tmp_path / "dataset"
    shutil.copytree(store / "vr_folding_dataset.zarr", root / "vr_folding_dataset.zarr")
    dirs = {}
    for name, module in (("jax", "bifold_tpu.data.create_dataset_partitions"),
                         ("port", "bifold_tpu_torch.data.create_dataset_partitions")):
        dirs[name] = root / f"actions_{name}"
        _run_cli(module, ["--actions_path", str(dirs[name]), *argv], monkeypatch)
    fresh = {name: _outputs(d) for name, d in dirs.items()}
    assert sorted(fresh["port"]) == ["Towel_actions.csv", "Tshirt_actions.csv",
                                     "test.csv", "train.csv"]
    assert fresh["port"] == fresh["jax"]
    for name, module in (("jax", "bifold_tpu.data.create_dataset_partitions"),
                         ("port", "bifold_tpu_torch.data.create_dataset_partitions")):
        _run_cli(module, ["--actions_path", str(dirs[name]), *argv], monkeypatch)
    cached = {name: _outputs(d) for name, d in dirs.items()}
    assert cached["port"] == cached["jax"]
    out = capsys.readouterr().out
    assert out.count("Filtered out") == 4
    # the cached path re-reads the category CSVs: their index column comes
    # back as "Unnamed: 0" in train.csv
    assert b"Unnamed: 0" in cached["port"]["train.csv"]
    assert b"Unnamed: 0" not in fresh["port"]["train.csv"]
    train = pd.read_csv(dirs["port"] / "train.csv")
    test = pd.read_csv(dirs["port"] / "test.csv")
    keep_bad = "--no-remove_bad_sequences" in argv
    assert len(train) + len(test) == (7 if keep_bad else 5)


@pytest.mark.parametrize("method", ["zscore", "length", "ratio"])
def test_filter_bad_meshes_matches_jax(method):
    rng = np.random.default_rng(1)
    nocs, faces, _, _ = grid()
    clean = (nocs + rng.normal(0.0, 1e-3, nocs.shape)) * 0.25
    exploded = clean.copy()
    exploded[vid(0, N - 1)] += 50.0
    stretched = clean * np.array([1.0, 1.0, 3.0])
    for verts in (clean, exploded, stretched):
        kwargs = dict(vertices=verts, nocs_vertices=nocs, faces=faces, method=method)
        assert port_vr.filter_bad_meshes(**kwargs) == jax_vr.filter_bad_meshes(**kwargs)
    assert not port_vr.filter_bad_meshes(clean, nocs, faces, method=method)
    assert port_vr.filter_bad_meshes(exploded, nocs, faces, method=method)
    with pytest.raises(NotImplementedError):
        port_vr.filter_bad_meshes(clean, nocs, faces, method="area")
