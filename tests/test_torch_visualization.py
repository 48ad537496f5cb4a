"""The port's visualization helpers (no cv2, Pillow or matplotlib) against
the JAX package's (which use them).

- ``save_predictions`` writes the same file tree and names;
- the RGB and ``viz`` PNGs decode (with Pillow, here) to the arrays
  written, and every PNG decodes;
- the port's viridis table equals matplotlib's, and the colormapped depth
  equals JAX's image exactly;
- heatmap overlays within 1 LSB of ``PIL.Image.blend`` (they have been
  exact);
- the marks of ``visualize_action`` (unimanual and bimanual, ground truth
  and prediction): pixels more than 3 px from any mark equal cv2's image,
  and the port's mark pixels have IoU >= 0.8 with cv2's (the numpy marks
  approximate cv2's rasteriser).
"""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from bifold_tpu.env.action import Action as JaxAction
from bifold_tpu.utils import visualization as jax_viz
from bifold_tpu_torch.env.action import Action
from bifold_tpu_torch.utils import visualization as viz

RES = 96


def _tree(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _png(path: Path) -> np.ndarray:
    return np.asarray(Image.open(path))


def _artifacts(seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (RES, RES, 3), dtype=np.uint8)
    heat = rng.random((1, RES, RES)).astype(np.float32)
    heat[0, 0, :4] = [0.0, 1.0, 0.5, 0.99999]   # the colormap's edges
    depth = rng.uniform(0.8, 1.6, (RES, RES)).astype(np.float32)
    pos = rng.normal(size=(50, 3)).astype(np.float32)
    return dict(rgb=rgb, viz=rgb[::-1].copy(), pick_heatmap=heat, place_heatmap=heat[:, ::-1],
                depth=depth, particle_pos=pos)


def test_viridis_table_is_matplotlibs():
    import matplotlib

    cm = matplotlib.colormaps["viridis"]
    np.testing.assert_array_equal(viz.VIRIDIS, (cm(np.arange(256))[:, :3] * 255).astype(np.uint8))
    v = np.concatenate([np.linspace(0, 1, 1001, dtype=np.float32), [np.nan]]).reshape(6, 167)
    np.testing.assert_array_equal(viz.apply_colormap(v), jax_viz._colormap(v, "viridis"))


def test_save_predictions_matches_jax(tmp_path):
    arts = _artifacts()
    viz.save_predictions(str(tmp_path / "port"), "0001.png", **arts)
    jax_viz.save_predictions(str(tmp_path / "jax"), "0001.png", **arts)
    tree = _tree(tmp_path / "port")
    assert tree == _tree(tmp_path / "jax")
    assert set(tree) == {f"{k}/0001.{'npy' if k == 'particle_pos' else 'png'}"
                         for k in arts}
    port, jax = tmp_path / "port", tmp_path / "jax"
    np.testing.assert_array_equal(_png(port / "rgb/0001.png"), arts["rgb"])
    np.testing.assert_array_equal(_png(port / "viz/0001.png"), arts["viz"])
    np.testing.assert_array_equal(_png(port / "depth/0001.png"), _png(jax / "depth/0001.png"))
    np.testing.assert_array_equal(np.load(port / "particle_pos/0001.npy"), arts["particle_pos"])
    for key in ("pick_heatmap", "place_heatmap"):
        a = _png(port / f"{key}/0001.png").astype(np.int16)
        b = _png(jax / f"{key}/0001.png").astype(np.int16)
        assert a.shape == b.shape == (RES, RES, 3)
        assert np.abs(a - b).max() <= 1, key
        print(f"{key}: {float((a != b).mean()):.6f} of the overlay's values differ")


def test_png_writer_modes(tmp_path):
    rng = np.random.default_rng(1)
    for shape in ((5, 7), (5, 7, 3), (5, 7, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        viz.write_png(str(tmp_path / "x.png"), img)
        np.testing.assert_array_equal(_png(tmp_path / "x.png"), img)


def _marks(img, base):
    return np.any(img != base, axis=-1)


def _dilate(mask, r):
    out = mask.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out |= np.roll(np.roll(mask, dy, axis=0), dx, axis=1)
    return out


@pytest.mark.parametrize("bimanual", [False, True])
def test_marks_against_cv2(bimanual):
    rng = np.random.default_rng(3)
    n = 4
    base = np.full((n, RES, RES, 3), 128, np.uint8)
    sample = {"raw_rgb": base}
    if bimanual:
        arms = {k: rng.uniform(8, RES - 8, (n, 2)) for k in
                ("left_pick", "left_place", "right_pick", "right_place")}
        arms["right_pick"][0] = -1.0          # a DUMMY arm draws nothing
        arms["right_place"][0] = -1.0
        sample.update({k: v + 3 for k, v in arms.items()})
        acts = [cls(**arms) for cls in (Action, JaxAction)]
    else:
        pick, place = rng.uniform(8, RES - 8, (n, 2)), rng.uniform(8, RES - 8, (n, 2))
        sample.update(pick=pick - 5, place=place + 4)
        acts = [cls(pick=pick, place=place) for cls in (Action, JaxAction)]
    ours = viz.visualize_action(sample, acts[0])
    theirs = jax_viz.visualize_action(sample, acts[1])
    assert len(ours) == len(theirs) == n
    for a, b, background in zip(ours, theirs, base):
        ma, mb = _marks(a, background), _marks(b, background)
        far = ~_dilate(ma | mb, 3)
        np.testing.assert_array_equal(a[far], b[far])
        iou = (ma & mb).sum() / (ma | mb).sum()
        print(f"marks IoU with cv2: {iou:.3f}")
        assert iou >= 0.8
        # every mark is drawn in one of the colours cv2 was given
        colours = {tuple(c) for c in b[mb]}
        assert {tuple(c) for c in a[ma]} <= colours
