"""The train partition's pieces against the JAX package's, on the CPU:
gaussmap targets, the affine warp, joint spatial augmentation, the depth
transforms and the whole train-partition Processor.

The port takes its random draws as arguments; these tests make them with
``jax.random`` exactly as the JAX package splits its keys, and hand the same
numbers to the port. Tolerances: maps and nearest-warped images 1e-5 (f32,
same formulas; XLA and torch round cos/sin/exp in the last bit), bilinear
warps 1e-4 (source coordinates near 40 px carry a 4e-6 ulp, and the weights
multiply differences of neighbours ~3 apart), the fitted Gaussian 1e-5
relative, processor outputs 1e-4 (the bicubic resize sums in
another order, as in ``test_torch_serving.py``), raw_rgb within one uint8
step of rounding.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu.data.processor import Processor as JaxProcessor
from bifold_tpu.data.spm import fixture_model_bytes
from bifold_tpu.ops import augment as jax_augment
from bifold_tpu.ops import depth as jax_depth
from bifold_tpu.ops.gaussmap import batched_gaussmap as jax_gaussmap
from bifold_tpu.serving import _stack_raws
from bifold_tpu_torch.data.processor import Processor
from bifold_tpu_torch.ops import augment, depth
from bifold_tpu_torch.ops.gaussmap import batched_gaussmap, gaussmap

TOL = 1e-5
BILINEAR_TOL = 1e-4
PROC_TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _points(seed, b=4, n=8, size=48):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, size + 2, (b, n, 2)).astype(np.float32)
    pts[:, 1::2] = np.floor(pts[:, 1::2]) + 0.5   # centres rounded half to even
    valid = rng.random((b, n)) > 0.4
    valid[1] = False                      # no target: a zero map
    valid[2] = False
    valid[2, 5] = True                    # one point
    return pts, valid


@pytest.mark.parametrize("strategy", ["first", "gmm", "fit"])
def test_gaussmap_matches_jax(strategy):
    pts, valid = _points(0)
    ref = np.asarray(jax_gaussmap(jnp.asarray(pts), jnp.asarray(valid), size=48,
                                  sigma=5.0, strategy=strategy))
    out = batched_gaussmap(_t(pts), _t(valid), 48, 5.0, strategy).numpy()
    if strategy == "fit":
        np.testing.assert_allclose(out, ref, rtol=TOL, atol=1e-12)
    else:
        np.testing.assert_allclose(out, ref, atol=TOL)
    assert not out[1].any()
    one = gaussmap(_t(pts[0]), _t(valid[0]), 48, 5.0, strategy).numpy()
    np.testing.assert_array_equal(one, out[0])


def _warp_args(seed, b=3):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, 2, 40, 48)).astype(np.float32)
    angle = rng.uniform(-5, 6, b).astype(np.float32)
    dx, dy = (rng.uniform(-5, 6, b).astype(np.float32) for _ in range(2))
    angle[0] = dx[0] = dy[0] = 0.0        # the identity
    return img, angle, dx, dy


@pytest.mark.parametrize("order", ["nearest", "bilinear"])
def test_affine_warp_matches_jax(order):
    img, angle, dx, dy = _warp_args(1)
    ref = np.stack([np.asarray(jax_augment.affine_warp(
        jnp.asarray(img[i]), angle[i], dx[i], dy[i], order=order))
        for i in range(len(img))])
    out = augment.affine_warp(_t(img), _t(angle), _t(dx), _t(dy), order).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL if order == "nearest" else BILINEAR_TOL)
    np.testing.assert_array_equal(out[0], img[0])


def _trial_draws(key, trials, rot, trans):
    """spatial_augment's draws from its per-sample key (augment.py:119-123)."""
    ka, kx, ky = jax.random.split(key, 3)
    return (jax.random.uniform(ka, (trials,), minval=rot[0], maxval=rot[1]),
            jax.random.uniform(kx, (trials,), minval=trans[0], maxval=trans[1]),
            jax.random.uniform(ky, (trials,), minval=trans[0], maxval=trans[1]))


def test_spatial_augment_matches_jax():
    rng = np.random.default_rng(2)
    b, size = 5, 48
    images = {"rgb": rng.normal(size=(b, 3, size, size)).astype(np.float32),
              "ctx": rng.normal(size=(b, 2, 1, size, size)).astype(np.float32)}
    pix = rng.uniform(3, size - 4, (b, 16, 2)).astype(np.float32)
    valid = rng.random((b, 16)) > 0.3
    valid[3] = False                       # nothing constrains the trials
    # the four corners: no trial keeps them all in frame -> the identity
    pix[4, :4] = [[0.1, 0.1], [46.8, 0.1], [0.1, 46.8], [46.8, 46.8]]
    valid[4, :4] = True
    keys = jax.random.split(jax.random.key(3), b)
    jout = [jax_augment.spatial_augment(
        keys[i], {k: jnp.asarray(v[i]) for k, v in images.items()},
        jnp.asarray(pix[i]), jnp.asarray(valid[i]), image_size=size,
        rotate_range=(-5.0, 6.0), translate_range=(-5.0, 6.0)) for i in range(b)]
    draws = [np.stack([np.asarray(x) for x in _trial_draws(
        keys[i], 5, (-5.0, 6.0), (-5.0, 6.0))]) for i in range(b)]
    angles, dxs, dys = (_t(np.stack([d[j] for d in draws])) for j in range(3))
    out_images, out_pix, accepted = augment.spatial_augment(
        {k: _t(v) for k, v in images.items()}, _t(pix), _t(valid), angles, dxs,
        dys, image_size=size)
    np.testing.assert_array_equal(accepted.numpy(), [bool(o[2]) for o in jout])
    assert not accepted[4] and accepted[3]
    np.testing.assert_array_equal(out_pix[4].numpy(), pix[4])
    np.testing.assert_allclose(out_pix.numpy(), np.stack([o[1] for o in jout]),
                               atol=TOL)
    for k in images:
        np.testing.assert_allclose(out_images[k].numpy(),
                                   np.stack([o[0][k] for o in jout]), atol=TOL)


def test_depth_transforms_match_jax():
    rng = np.random.default_rng(4)
    d = rng.uniform(0.5, 1.5, (3, 32, 40)).astype(np.float32)
    d[:, :4] = 0.0                          # invalid depth stays 0
    keys = jax.random.split(jax.random.key(5), 3)
    ref, normals = [], []
    for i in range(3):
        ref.append(np.asarray(jax_depth.depth_noise(keys[i], jnp.asarray(d[i]))))
        kd, ky, kx = jax.random.split(keys[i], 3)
        normals.append([np.asarray(jax.random.normal(k, d.shape[1:]))
                        for k in (ky, kx, kd)])
    ny, nx, nd = (_t(np.stack([n[j] for n in normals])) for j in range(3))
    out = depth.depth_noise(_t(d), ny, nx, nd).numpy()
    np.testing.assert_allclose(out, np.stack(ref), rtol=TOL)
    ref = np.asarray(jax.vmap(jax_depth.truncated_standardization)(jnp.asarray(d)))
    np.testing.assert_allclose(depth.truncated_standardization(_t(d)).numpy(),
                               ref, atol=TOL)
    shift = np.float32([0.1, -0.2, 0.05])[:, None, None]
    np.testing.assert_array_equal(depth.depth_shift(_t(d), _t(shift)).numpy(),
                                  d + shift)


PROC_CFG = {"model_image_size": 48, "text_encoder": None, "sigma": 5,
            "requires_graph": False, "spatial_augment": True, "strategy": "gmm",
            "mask_depth": True, "standardize_depth": False,
            "spatial_augmentations": {"max_augmentation_trials": 5,
                                      "rotate_augmentation": [-5, 6],
                                      "translate_augmentation": [-5, 6]}}


def _jax_core_draws(key, b, t, hw, cfg):
    """The draws JAX's train ``_core`` makes from ``key``
    (processor.py:116-135, 155, 206)."""
    depth_key, ctx_key, spatial_key = jax.random.split(key, 3)
    da = cfg.get("depth_augmentations", {})
    draws = {}
    for prefix, k, n in (("", depth_key, b), ("ctx_", ctx_key, b * t)):
        if da.get("random_depth_shift"):
            k, sub = jax.random.split(k)
            draws[prefix + "depth_shift"] = jax.random.uniform(
                sub, (n, 1, 1), minval=da["min_shift"], maxval=da["max_shift"])
        if da.get("add_depth_noise"):
            k, sub = jax.random.split(k)
            per = []
            for nk in jax.random.split(sub, n):
                kd, ky, kx = jax.random.split(nk, 3)
                per.append([jax.random.normal(x, hw) for x in (ky, kx, kd)])
            draws[prefix + "depth_noise"] = np.stack(
                [np.stack([np.asarray(p[j]) for p in per]) for j in range(3)])
    trials = [_trial_draws(k, 5, (-5.0, 6.0), (-5.0, 6.0))
              for k in jax.random.split(spatial_key, b)]
    for j, name in enumerate(("angles", "dxs", "dys")):
        draws[name] = np.stack([np.asarray(tr[j]) for tr in trials])
    return {k: _t(v) for k, v in draws.items()}


@pytest.mark.parametrize("depth_aug", [False, True])
def test_train_processor_matches_jax(depth_aug):
    """The shipped train config (spatial augmentation on, depth augmentation
    off), and again with depth shift and noise on."""
    cfg = dict(PROC_CFG)
    if depth_aug:
        cfg["depth_augmentations"] = {"random_depth_shift": True,
                                      "add_depth_noise": True,
                                      "min_shift": -0.2, "max_shift": 0.2}
    spm = fixture_model_bytes()
    jproc = JaxProcessor(cfg, partition="train", max_context_length=3,
                         autoprocessor_name="tiny", spm_asset=spm)
    tproc = Processor(cfg, partition="train", max_context_length=3,
                      autoprocessor_name="tiny", spm_asset=spm)
    rng = np.random.default_rng(6)
    size = 56

    def frame():
        return dict(rgb=rng.integers(0, 255, (size, size, 3), dtype=np.uint8),
                    depth=rng.uniform(0.5, 1.5, (size, size)).astype(np.float32),
                    mask=(rng.random((size, size)) > 0.3).astype(np.float32))

    raws = []
    for n_ctx, lp in ((1, [[10.0, 20.0], [30.0, 31.0]]), (3, [5.0, 50.0])):
        obs = frame()
        obs["context"] = [frame() for _ in range(n_ctx)]
        raws.append(jproc.make_raw(**obs, instruction="fold it", left_pick=np.array(lp),
                                   left_place=np.array([40.0, 12.0]), right_pick=None,
                                   right_place=np.array([22.0, 33.0])))
    batched = _stack_raws(raws)
    batched["label_keys"] = raws[0]["label_keys"]
    key = jax.random.key(8)
    ref = jproc.process_batch(batched, key)
    draws = _jax_core_draws(key, 2, 3, (size, size), cfg)
    out = tproc.process_batch(batched, "cpu", draws=draws)
    assert sorted(out) == sorted(k for k in ref if k != "raw_instruction")
    assert any(k.endswith("_heatmap") for k in out)
    for k in out:
        tol = 1 if k == "raw_rgb" else PROC_TOL
        np.testing.assert_allclose(out[k].numpy().astype(np.float32),
                                   np.asarray(ref[k]).astype(np.float32),
                                   atol=tol, err_msg=k)
    # the processor's own draws: seeded, the same from the same seed
    a = Processor(cfg, partition="train", max_context_length=3,
                  autoprocessor_name="tiny", spm_asset=spm, seed=3)
    b = Processor(cfg, partition="train", max_context_length=3,
                  autoprocessor_name="tiny", spm_asset=spm, seed=3)
    first, second = (p.process_batch(batched, "cpu") for p in (a, b))
    for k in first:
        torch.testing.assert_close(first[k], second[k], rtol=0, atol=0)
    assert set(first) == set(out)
