"""The port's cloth env, render resize and cache builder against the JAX
package's.

Both packages on the native simulator core (the JAX package's csrc build,
the port's own build of the same source; tests/test_torch_sim.py holds the
two bitwise), the cheap env of tests/test_parallel_eval.py (64 px,
substeps 2, iterations 6):

- the pick-and-place (single and dual) and fling primitives leave bitwise
  equal particle states;
- ``render_image``: the port's numpy resize against ``cv2.resize``
  (INTER_LINEAR) through the JAX env: RGB within 1 LSB (the share of
  pixels off by one is printed; it has been 0), depth within 1e-6 (it
  has been bitwise: the share of unequal depth pixels is printed too);
- pixel -> world unprojection equal;
- ``build_cache`` pickles byte-equal to JAX's for every cloth type at
  ``n_configs=1, settle_steps=10``, and each package's evaluator loads the
  other's.
"""

import pickle

import numpy as np
import pytest

from bifold_tpu.env import cloth_env as jax_env
from bifold_tpu.env.cache_builder import build_cache as jax_build_cache
from bifold_tpu_torch.env import cloth_env as port_env
from bifold_tpu_torch.env.cache_builder import CLOTH_TYPES, build_cache

RES = 64


def cheap_env(mod, res=RES):
    return mod.ClothEnv(render_dim=res, substeps=2, iterations=6)


def _both(config, res=RES):
    envs = [cheap_env(jax_env, res), cheap_env(port_env, res)]
    for env in envs:
        env.reset(config, settle_steps=10)
    return envs


def _same_state(a, b):
    np.testing.assert_array_equal(a.sim.get_positions(), b.sim.get_positions())
    np.testing.assert_array_equal(a.sim.get_velocities(), b.sim.get_velocities())
    np.testing.assert_array_equal(a.sim.get_shape_states(), b.sim.get_shape_states())


@pytest.mark.parametrize("primitive", ["single", "dual", "fling"])
def test_primitives_bitwise(primitive):
    envs = _both(port_env.square_cloth_config(14, 14))
    for env in envs:
        assert env.sim._native is not None
        kp = env.get_keypoints(env.get_square_keypoints_idx())
        if primitive == "single":
            env.pick_and_place_single(kp[0].copy(), kp[4].copy())
        elif primitive == "dual":
            env.pick_and_place_dual(kp[0].copy(), kp[8].copy(), kp[2].copy(), kp[6].copy())
        else:
            env.fling_speed = 0.1
            env.pick_and_fling(kp[3].copy(), kp[5].copy())
    _same_state(*envs)
    assert not np.array_equal(envs[1].sim.get_positions(), envs[1].sim.rest_positions)


@pytest.mark.parametrize("res", [64, 224, 384])
def test_render_image_against_cv2(res):
    a, b = _both(port_env.square_cloth_config(20, 20), res)
    port_env.rotate_particles(a, [0, 30, 0])
    port_env.rotate_particles(b, [0, 30, 0])
    rgb_a, depth_a = a.render_image()
    rgb_b, depth_b = b.render_image()
    assert rgb_b.shape == (res, res, 3) and rgb_b.dtype == np.uint8
    assert depth_b.shape == (res, res) and depth_b.dtype == np.float32
    diff = np.abs(rgb_a.astype(np.int16) - rgb_b.astype(np.int16))
    print(f"{res} px: RGB pixels off by 1 LSB: {float((diff == 1).mean()):.6f}, "
          f"depth pixels unequal: {float((depth_a != depth_b).mean()):.6f}")
    assert diff.max() <= 1
    assert np.abs(depth_a - depth_b).max() <= 1e-6


def test_resize_of_random_images():
    """The resize alone, on noise at every evaluator size (uint8 RGB and
    float32 depth, as cv2 resizes them)."""
    import cv2

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (720, 720, 3), dtype=np.uint8)
    depth = rng.uniform(0.5, 2.0, (720, 720)).astype(np.float32)
    for size in (64, 224, 384):
        ref = cv2.resize(rgb, (size, size), interpolation=cv2.INTER_LINEAR)
        diff = np.abs(port_env.resize_linear(rgb, size).astype(np.int16) - ref)
        print(f"{size} px noise: RGB off by 1 LSB: {float((diff == 1).mean()):.6f}")
        assert diff.max() <= 1
        ref = cv2.resize(depth, (size, size), interpolation=cv2.INTER_LINEAR)
        assert np.abs(port_env.resize_linear(depth, size) - ref).max() <= 1e-6


def test_pixel_world_equal():
    a, b = _both(port_env.square_cloth_config(20, 20))
    _, depth = b.render_image()
    _, depth_a = a.render_image()
    np.testing.assert_allclose(depth, depth_a, atol=1e-6, rtol=0)
    for px in ([32.0, 32.0], [20.4, 40.6], [0.0, 63.0], [50.5, 10.5]):
        np.testing.assert_array_equal(a.get_world_coord_from_pixel(px, depth),
                                      b.get_world_coord_from_pixel(px, depth))
    np.testing.assert_array_equal(a.camera_matrix, b.camera_matrix)
    np.testing.assert_array_equal(a.intrinsic_from_fov(RES, RES, 45),
                                  b.intrinsic_from_fov(RES, RES, 45))


@pytest.mark.parametrize("cloth_type", CLOTH_TYPES)
def test_build_cache_equal(cloth_type, tmp_path):
    jax_path = jax_build_cache(cloth_type, tmp_path / "jax", n_configs=1, settle_steps=10)
    port_path = build_cache(cloth_type, tmp_path / "port", n_configs=1, settle_steps=10)
    assert port_path.name == jax_path.name == f"{cloth_type}.pkl"
    assert port_path.read_bytes() == jax_path.read_bytes()

    from bifold_tpu.env.softgym_evaluator import SoftgymEvaluator as JaxEvaluator
    from bifold_tpu_torch.env.softgym_evaluator import SoftgymEvaluator

    with open(jax_path, "rb") as f:
        payload = pickle.load(f)
    for cls, other in ((JaxEvaluator, tmp_path / "port"), (SoftgymEvaluator, tmp_path / "jax")):
        ev = cls(cache_dir=str(other), policy=None, processor=None, image_size=RES)
        ev.load_cache(cloth_type)
        assert len(ev.cached_configs) == len(ev.cached_states) == 1
        np.testing.assert_array_equal(ev.cached_states[0]["particle_pos"],
                                      payload["states"][0]["particle_pos"])
        assert (ev.cached_keypoints is None) == ("keypoints" not in payload)
