"""The port's closed-loop evaluators against the JAX package's.

A deterministic centroid policy (tests/test_parallel_eval.py) drives each
evaluator of both packages on the same caches (the port's ``build_cache``
garments, and squares of 16 x 16 and 14 x 20 particles, ``settle_steps=10``)
and the same seed, both on the native
simulator core, in the cheap env of tests/test_parallel_eval.py (64 px,
substeps 2, iterations 6). JAX draws its instructions from the global
``random``, so it is seeded with the port's seed before each of its
``evaluate`` calls. Each pair must make the same policy calls (batch
sizes, and every row's observation mask and action equal) and give
summaries equal to rtol 1e-9:

- every task x the 3 regimes, sequential (as tests/test_full_protocol.py);
- the parallel pool of 2 over 3 trials (a ragged group) against JAX's and
  against the port's sequential evaluator;
- the bimanual replay (dual arm, and a DUMMY right arm demoted to the
  single-arm primitive), its parallel pool, and the two rollout
  evaluators.
"""

import pickle
import random

import numpy as np
import pytest

from bifold_tpu.data.processor import Processor as JaxProcessor
from bifold_tpu.env import bimanual_evaluator as jax_bim
from bifold_tpu.env import cloth_env as jax_env
from bifold_tpu.env import softgym_evaluator as jax_eval
from bifold_tpu.env.action import Action as JaxAction
from bifold_tpu_torch.data.processor import Processor
from bifold_tpu_torch.env import bimanual_evaluator as port_bim
from bifold_tpu_torch.env import cloth_env as port_env
from bifold_tpu_torch.env import softgym_evaluator as port_eval
from bifold_tpu_torch.env.action import Action
from bifold_tpu_torch.env.cache_builder import CLOTH_TYPES, build_cache

RES = 64
PROC = {"model_image_size": RES, "text_encoder": None, "sigma": 5,
        "requires_graph": False, "spatial_augment": False, "strategy": "gmm",
        "mask_depth": True, "standardize_depth": False}
PACKAGES = {"jax": (jax_env, jax_eval, jax_bim, JaxProcessor, JaxAction),
            "port": (port_env, port_eval, port_bim, Processor, Action)}


SMALL = {"Square": (16, 16), "Rectangular": (14, 20)}


def small_caches(out):
    """The garment caches from ``build_cache``; the square and rectangular
    ones laid out as ``build_cache`` lays them out, at cloth sizes below
    its 28-52 particles a side, to keep the loops short."""
    out.mkdir(parents=True, exist_ok=True)
    for cloth_type in CLOTH_TYPES:
        if cloth_type not in SMALL:
            build_cache(cloth_type, out, n_configs=1, settle_steps=10)
            continue
        config = port_env.square_cloth_config(*SMALL[cloth_type])
        env = port_env.ClothEnv(render_dim=224)
        env.reset(config, settle_steps=10)
        pos = env.sim.get_positions()[:, :3]
        extent = pos.max(axis=0) - pos.min(axis=0)
        state = env.get_state()
        state["max_area"] = float(extent[0] * extent[2])
        with open(out / f"{cloth_type}.pkl", "wb") as f:
            pickle.dump({"configs": [config], "states": [state]}, f)
    return out


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return small_caches(tmp_path_factory.mktemp("softgym_cache"))


def install_cheap_envs(ev, env_mod, pool=None):
    for env in getattr(ev, "envs", [ev.env]):
        env.close()
    cheap = [env_mod.ClothEnv(render_dim=RES, substeps=2, iterations=6)
             for _ in range(pool or 1)]
    ev.env = cheap[0]
    if pool is not None:
        ev.envs = cheap
    ev.K = ev.env.intrinsic_from_fov(RES, RES)
    ev.error_threshold = ev.env.particle_radius * 2


def centroid_policy(action_cls, calls, bimanual=False, dummy_right=False):
    """pick = the mask's centroid, place = 2 px on; records (mask, action)
    per call."""

    def policy(batch):
        masks = np.asarray(batch["mask"])[:, 0]
        picks = []
        for m in masks:
            ys, xs = np.nonzero(m > 0)
            if len(xs) == 0:
                ys = xs = np.array([32])
            picks.append([xs.mean(), ys.mean()])
        p = np.array(picks)
        if bimanual:
            lp, rp = p - [3, 0], p + [3, 0]
            rpl = np.full_like(rp, -1.0) if dummy_right else rp + 2
            if dummy_right:
                rp = rpl
            action = action_cls(left_pick=lp, left_place=lp + 2,
                                right_pick=rp, right_place=rpl)
        else:
            action = action_cls(pick=p, place=p + 2)
        calls.append((masks.copy(), {k: np.asarray(v) for k, v in vars(action).items()
                                     if v is not None}))
        return action, None

    return policy


def same_calls(a, b):
    assert len(a) == len(b) > 0
    for (mask_a, act_a), (mask_b, act_b) in zip(a, b):
        np.testing.assert_array_equal(mask_a, mask_b)
        assert act_a.keys() == act_b.keys()
        for k in act_a:
            np.testing.assert_array_equal(act_a[k], act_b[k], err_msg=k)


def same_summary(a, b):
    assert set(a) == set(b)
    for k, v in a.items():
        np.testing.assert_allclose(b[k], v, rtol=1e-9, atol=0, err_msg=k)


def run_unimanual(package, cache_dir, tasks, num_evals, seed=0, pool=None, run_dir=None):
    env_mod, eval_mod, _, proc_cls, action_cls = PACKAGES[package]
    calls = []
    kwargs = {"pool": pool} if pool else {}
    cls = eval_mod.SoftgymParallelEvaluator if pool else eval_mod.SoftgymSingleEvaluator
    ev = cls(cache_dir=str(cache_dir), policy=centroid_policy(action_cls, calls),
             processor=proc_cls(PROC, partition="test", max_context_length=3),
             image_size=RES, visualize_predictions=run_dir is not None,
             run_dir=None if run_dir is None else str(run_dir), **kwargs)
    install_cheap_envs(ev, env_mod, pool)
    for task in tasks:
        if package == "jax":
            random.seed(seed)
        ev.evaluate(num_evals=num_evals, task=task, seed=seed)
    summary = ev.summary()
    ev.close()
    return summary, calls


@pytest.mark.parametrize("task", port_eval.TASKS)
def test_every_task_and_regime(task, cache_dir):
    port, port_calls = run_unimanual("port", cache_dir, [task], 1)
    jax, jax_calls = run_unimanual("jax", cache_dir, [task], 1)
    same_calls(jax_calls, port_calls)
    same_summary(jax, port)
    for regime in ("si", "usi", "ut"):
        assert f"{task} {regime}" in port
        assert np.isfinite(port[f"error {task} {regime}"])
    assert "average_success" in port


def test_seeded_instructions_match_jax():
    """The port's seeded draws are JAX's after random.seed(seed), for every
    task (StraightFold in each angle mode)."""
    from bifold_tpu.env.demonstrators import Demonstrator as JaxDemonstrator
    from bifold_tpu_torch.env.demonstrators import Demonstrator

    for task in port_eval.TASKS:
        for seed in (0, 7):
            args = [(mode,) for mode in range(3)] if task == "StraightFold" else [()]
            for a in args:
                random.seed(seed)
                want = JaxDemonstrator[task]().get_eval_instruction(*a)
                got = Demonstrator[task](random.Random(seed)).get_eval_instruction(*a)
                assert got == want


def test_parallel_pool(cache_dir, tmp_path):
    """3 trials over a pool of 2 (a ragged group): equal to JAX's pool and
    to the port's sequential evaluator; every call a padded batch of 2."""
    port, port_calls = run_unimanual("port", cache_dir, ["TriangleFold"], 3, pool=2,
                                     run_dir=tmp_path / "run")
    jax, jax_calls = run_unimanual("jax", cache_dir, ["TriangleFold"], 3, pool=2)
    same_calls(jax_calls, port_calls)
    same_summary(jax, port)
    assert all(len(mask) == 2 for mask, _ in port_calls)
    seq, _ = run_unimanual("port", cache_dir, ["TriangleFold"], 3)
    same_summary(seq, port)
    viz = tmp_path / "run" / "eval" / "softgym" / "TriangleFold"
    assert sorted((viz / "viz").glob("si_*.png"))
    assert sorted((viz / "particle_pos").glob("*.npy"))


def bimanual_cache(root, n_samples):
    """bimanual.pkl keyed by frame names, from the Tshirt cache (left/right
    pick = sleeves, place = hems), as tests/test_parallel_eval.py builds it."""
    root.mkdir(parents=True, exist_ok=True)
    path = build_cache("Tshirt", root, n_configs=2, settle_steps=10)
    with open(path, "rb") as f:
        data = pickle.load(f)
    names = [f"{i:04d}_Tshirt_f{i}" for i in range(1, n_samples + 1)]
    configs, states, kps = {}, {}, {}
    for i, name in enumerate(names):
        j = i % 2
        kp = data["keypoints"][j]
        configs[name] = data["configs"][j]
        states[name] = data["states"][j]
        kps[name] = {"left_pick_idx": kp[2], "left_place_idx": kp[6],
                     "right_pick_idx": kp[5], "right_place_idx": kp[7]}
    with open(root / "bimanual.pkl", "wb") as f:
        pickle.dump({"configs": configs, "states": states, "keypoints": kps}, f)
    ctx = [names[0]] + [f"{names[0]}+{names[1]}"] * (n_samples - 1)
    return {"frame_start": names,
            "raw_instruction": [f"fold the tshirt {i}" for i in range(n_samples)],
            "context": ctx}


def run_bimanual(package, cache_dir, samples, pool=None, dummy_right=False, run_dir=None):
    env_mod, _, bim_mod, proc_cls, action_cls = PACKAGES[package]
    calls = []
    cls = (bim_mod.SoftgymBimanualParallelEvaluator if pool
           else bim_mod.SoftgymBimanualEvaluator)
    ev = cls(cache_dir=str(cache_dir),
             policy=centroid_policy(action_cls, calls, True, dummy_right),
             processor=proc_cls(PROC, partition="test", max_context_length=3),
             image_size=RES, visualize_predictions=run_dir is not None,
             run_dir=None if run_dir is None else str(run_dir),
             **({"pool": pool} if pool else {}))
    install_cheap_envs(ev, env_mod, pool)
    ev.evaluate(samples=samples)
    summary = ev.summary()
    ev.close()
    return summary, calls


@pytest.mark.parametrize("case", ["replay", "single_arm", "parallel"])
def test_bimanual_replay(case, tmp_path):
    samples = bimanual_cache(tmp_path, 3)
    kwargs = {"replay": {}, "single_arm": {"dummy_right": True},
              "parallel": {"pool": 2}}[case]
    run_dir = tmp_path / "run" if case == "replay" else None
    port, port_calls = run_bimanual("port", tmp_path, samples, run_dir=run_dir, **kwargs)
    jax, jax_calls = run_bimanual("jax", tmp_path, samples, **kwargs)
    same_calls(jax_calls, port_calls)
    same_summary(jax, port)
    assert "Tshirt" in port and port["error Tshirt"] > 0
    if case == "parallel":
        assert [len(mask) for mask, _ in port_calls] == [2, 2]
        seq, _ = run_bimanual("port", tmp_path, samples)
        same_summary(seq, port)
    if run_dir is not None:
        assert len(list((run_dir / "eval" / "softgym" / "Tshirt" / "viz").glob("*.png"))) == 3


def test_rollout_evaluators(tmp_path, cache_dir):
    """The open-ended instruction rollout and Deng's two-instruction folds:
    the same policy calls in both packages, and the same final cloth."""
    samples = bimanual_cache(tmp_path, 2)
    finals = {}
    for package in ("jax", "port"):
        env_mod, _, bim_mod, proc_cls, action_cls = PACKAGES[package]
        calls = []
        proc = proc_cls(PROC, partition="test", max_context_length=3)
        ev = bim_mod.SoftgymBimanualRolloutEvaluator(
            cache_dir=str(tmp_path), policy=centroid_policy(action_cls, calls, True),
            processor=proc, image_size=RES)
        install_cheap_envs(ev, env_mod)
        ev.evaluate(samples["frame_start"][1], ["fold the left sleeve", "fold in half"])
        positions = [ev.env.sim.get_positions()]
        deng = bim_mod.SoftgymBimanualRolloutEvaluatorDeng(
            cache_dir=str(cache_dir), policy=centroid_policy(action_cls, calls, True),
            processor=proc, image_size=RES)
        install_cheap_envs(deng, env_mod)
        deng.evaluate(num_evals=1, task="TrousersFold", seed=3)
        positions.append(deng.env.sim.get_positions())
        finals[package] = (calls, positions)
    same_calls(finals["jax"][0], finals["port"][0])
    assert len(finals["port"][0]) == 4
    for a, b in zip(finals["jax"][1], finals["port"][1]):
        np.testing.assert_array_equal(a, b)
