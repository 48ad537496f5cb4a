"""Bimanual closed-loop evaluation: replay dataset frames, dual-arm dispatch.

The port's copy of bifold_tpu/env/bimanual_evaluator.py, a counterpart of
the reference's softgym_evaluator.py:423-624
(SoftgymBimanualEvaluator): for each test sample, the cached scene state for
its start frame is restored, the scripted oracle executes the ground-truth
grasp-vertex action (dual or single arm), the env resets, context frames are
reconstructed by replaying their cached states, and the model acts from the
render; DUMMY (-1) pixels on an arm demote to a single-arm primitive
(reference :519-540). Metrics match the unimanual evaluator.

Cache layout (`<cache>/bimanual.pkl`): configs/states/keypoints keyed by
frame name; keypoints hold left/right pick/place particle indices (built by
our cache tooling, or converted from the reference's bimanual cache).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from bifold_tpu_torch.data.utils import get_mask_from_depth
from bifold_tpu_torch.env.cloth_env import ClothEnv
from bifold_tpu_torch.env.softgym_evaluator import (SoftgymEvaluator, batchify,
                                              batchify_many)
from bifold_tpu_torch.metrics.utils import iou

__all__ = ["SoftgymBimanualEvaluator", "SoftgymBimanualParallelEvaluator",
           "SoftgymBimanualRolloutEvaluator",
           "SoftgymBimanualRolloutEvaluatorDeng"]


class SoftgymBimanualEvaluator(SoftgymEvaluator):
    def evaluate(self, dataloader=None, samples: Optional[Dict] = None,
                 num_evals: Optional[int] = None, **_) -> None:
        self.cloth3d = True
        self.load_cache("bimanual")
        if samples is None:
            samples = self._collect_samples(dataloader, num_evals)
        self._validate_replayable(samples)
        for idx in range(len(samples["frame_start"])):
            name = samples["frame_start"][idx]
            self.task = name.split("_")[1] if "_" in name else name
            self._ensure_task(self.task)
            config = self.cached_configs[name]
            state = self.cached_states[name]
            keypoints = self.cached_keypoints[name]

            oracle_result, oracle_mask = self.execute_oracle(keypoints, config, state)
            self.execute_model(samples, idx, name, oracle_result, oracle_mask)

    def _ensure_task(self, task: str) -> None:
        if task not in self.success:
            self.success[task] = []
            for k in (["error", "iou"]
                      + [f"iou_success_{t}" for t in self.iou_thresholds]):
                self.additional_metrics.setdefault(k, {})[task] = []

    def _validate_replayable(self, samples: Dict) -> None:
        """Every start/context frame the replay will reset to must exist in
        the cache — configs AND states, plus keypoints for the start frames
        the oracle scripts from; raise the fallback-eligible
        FileNotFoundError up front instead of a mid-run KeyError/TypeError
        (which the caller must NOT swallow — that masking hid the task-key
        bug this check replaces)."""
        starts = set(samples["frame_start"])
        needed = set(starts)
        for ctx in samples.get("context", []):
            needed.update(c for c in str(ctx).split("+") if c)
        if self.cached_keypoints is None:
            raise FileNotFoundError(
                "bimanual replay cache has no 'keypoints' — the oracle "
                "cannot script its grasps; rebuild the cache from the "
                "dataset (env/cache_builder.py)")
        missing = sorted(
            n for n in needed
            if n not in self.cached_configs or n not in self.cached_states
        ) + sorted(n for n in starts if n not in self.cached_keypoints)
        if missing:
            raise FileNotFoundError(
                f"bimanual replay cache is missing {len(missing)} frame "
                f"entr{'y' if len(missing) == 1 else 'ies'} the test set "
                f"replays (first: {missing[:3]})")

    @staticmethod
    def _collect_samples(dataloader, limit: Optional[int]) -> Dict:
        """Flatten test-dataloader batches into the parallel-list sample dict
        the replay loop walks (frame_start / raw_instruction / context)."""
        out: Dict = {"frame_start": [], "raw_instruction": [], "context": []}
        n = 0
        done = False
        for batch in dataloader:
            names = batch.get("frame_start")
            instrs = batch.get("raw_instruction")
            if names is None or instrs is None:
                raise FileNotFoundError(
                    "test dataset provides no frame_start/raw_instruction "
                    "replay keys; the bimanual sim eval needs the "
                    "vr-folding replay dataset")
            ctxs = batch.get("context_names", [""] * len(instrs))
            for name, instr, ctx in zip(names, instrs, ctxs):
                out["frame_start"].append(name)
                out["raw_instruction"].append(instr)
                out["context"].append(ctx)
                n += 1
                if limit and n >= limit:
                    done = True
                    break
            if done:
                break
        if not out["frame_start"]:
            raise FileNotFoundError(
                "test dataloader yielded no replayable samples")
        if not any(out["context"]):
            # normalize on EVERY exit (the limited path used to skip this)
            out.pop("context")
        return out

    # ------------------------------------------------------------------

    def execute_oracle(self, keypoints: Dict, config, state, env=None):
        env = env if env is not None else self.env
        self.reset_env(env, config, state)
        pos = env.get_keypoints()
        lp = keypoints.get("left_pick_idx")
        rp = keypoints.get("right_pick_idx")
        if lp is not None and rp is not None:
            env.pick_and_place_dual(
                pos[lp], pos[keypoints["left_place_idx"]],
                pos[rp], pos[keypoints["right_place_idx"]])
        elif lp is not None:
            env.pick_and_place_single(pos[lp], pos[keypoints["left_place_idx"]])
        else:
            assert rp is not None
            env.pick_and_place_single(pos[rp], pos[keypoints["right_place_idx"]])
        _, depth = env.render_image()
        return (env.sim.get_positions()[:, :3],
                get_mask_from_depth(depth))

    def _model_obs(self, samples, idx, name, env):
        """Reconstruct context frames by replaying their cached states, reset
        to the start frame, render: the raw observation for the model."""
        context = None
        if "context" in samples:
            context = []
            for ctx in str(samples["context"][idx]).split("+"):
                if ctx:
                    self.reset_env(env, self.cached_configs[ctx],
                                   self.cached_states[ctx])
                    rgb, depth = env.render_image()
                    context.append({"rgb": rgb, "depth": depth,
                                    "mask": get_mask_from_depth(depth)})

        self.reset_env(env, self.cached_configs[name],
                       self.cached_states[name])
        rgb, depth = env.render_image()
        mask = get_mask_from_depth(depth)
        return dict(rgb=rgb, depth=depth, mask=mask, context=context,
                    instruction=samples["raw_instruction"][idx])

    def _model_sample(self, samples, idx, name, env):
        """Raw observation -> host-processed sample (non-serving policies)."""
        obs = self._model_obs(samples, idx, name, env)
        sample = self.processor(
            depth=obs["depth"], rgb=obs["rgb"], mask=obs["mask"],
            context=obs["context"], instruction=obs["instruction"],
            matrix_world_to_camera=env.camera_matrix, K=self.K)
        return sample, obs["depth"]

    def _apply_and_score(self, env, action, row: int, depth, task: str,
                         oracle_result, oracle_mask,
                         viz_sample: Optional[Dict] = None) -> None:
        """Execute one (possibly batched) Action row on ``env`` with the
        dual-or-single-arm DUMMY dispatch (reference :519-540) and record
        the metrics under ``task``."""
        lp = np.asarray(action.left_pick).reshape(-1, 2)[row]
        lpl = np.asarray(action.left_place).reshape(-1, 2)[row]
        rp = np.asarray(action.right_pick).reshape(-1, 2)[row]
        rpl = np.asarray(action.right_place).reshape(-1, 2)[row]

        left_ok = np.all(lp >= 0) and np.all(lpl >= 0)
        right_ok = np.all(rp >= 0) and np.all(rpl >= 0)
        if left_ok and right_ok:
            env.pick_and_place_dual(
                env.get_world_coord_from_pixel(lp, depth),
                env.get_world_coord_from_pixel(lpl, depth),
                env.get_world_coord_from_pixel(rp, depth),
                env.get_world_coord_from_pixel(rpl, depth))
        elif right_ok:
            env.pick_and_place_single(
                env.get_world_coord_from_pixel(rp, depth),
                env.get_world_coord_from_pixel(rpl, depth))
        else:
            assert left_ok, "confidence gating must leave at least one arm active"
            env.pick_and_place_single(
                env.get_world_coord_from_pixel(lp, depth),
                env.get_world_coord_from_pixel(lpl, depth))

        particle_pos = env.sim.get_positions()[:, :3]
        _, depth = env.render_image()
        mask = get_mask_from_depth(depth)

        error = float(np.linalg.norm(oracle_result - particle_pos, axis=1).mean())
        iou_value = iou(mask, oracle_mask)
        success = error < self.error_threshold
        self.success[task].append(success)
        self.additional_metrics["error"][task].append(error)
        self.additional_metrics["iou"][task].append(iou_value)
        for thresh in self.iou_thresholds:
            self.additional_metrics[f"iou_success_{thresh}"][task].append(
                (iou_value > thresh) * 100)

        if self.visualize_predictions and viz_sample is not None \
                and "raw_rgb" in viz_sample:
            from bifold_tpu_torch.env.softgym_evaluator import action_row
            from bifold_tpu_torch.utils.visualization import visualize_action

            viz = visualize_action(viz_sample, action_row(action, row))[0]
            n = len(self.success[task]) - 1
            self.save_visuals(f"{n:04d}_{int(success)}.png", task=task,
                              viz=viz, particle_pos=particle_pos)

    def execute_model(self, samples, idx, name, oracle_result, oracle_mask) -> None:
        if getattr(self.policy, "wants_raw", False):
            obs = self._model_obs(samples, idx, name, self.env)
            depth = obs["depth"]
            action, _raw = self.policy(obs)
            viz_sample = {"raw_rgb": obs["rgb"]}
        else:
            sample, depth = self._model_sample(samples, idx, name, self.env)
            action, _raw = self.policy(batchify(sample))
            viz_sample = sample
        self._apply_and_score(self.env, action, 0, depth, self.task,
                              oracle_result, oracle_mask,
                              viz_sample=viz_sample)


class SoftgymBimanualParallelEvaluator(SoftgymBimanualEvaluator):
    """Lockstep bimanual replay eval over an env pool: each group of K test
    samples runs oracle + context reconstruction on its own env, then ONE
    padded pool-size policy call serves all K model actions.

    The replay protocol has no RNG, so batched == sequential by
    construction with a deterministic policy (tests/test_torch_evaluators.py).
    Same rationale as SoftgymParallelEvaluator: batch-1 rollout inference is
    dispatch-latency-bound, and the flagship BiFold model is bimanual, so
    this is where the pool pays off in practice."""

    def __init__(self, cache_dir: str, policy: Callable, processor,
                 image_size: int = 224, particle_radius: float = 0.00625,
                 visualize_predictions: bool = False,
                 run_dir: Optional[str] = None, pool: int = 8):
        super().__init__(cache_dir, policy, processor, image_size,
                         particle_radius, visualize_predictions, run_dir)
        self.pool = max(1, int(pool))
        self.envs = [self.env] + [
            ClothEnv(render_dim=image_size, particle_radius=particle_radius)
            for _ in range(self.pool - 1)]

    def close(self) -> None:
        for env in self.envs:
            env.close()

    def evaluate(self, dataloader=None, samples: Optional[Dict] = None,
                 num_evals: Optional[int] = None, **_) -> None:
        self.cloth3d = True
        self.load_cache("bimanual")
        if samples is None:
            samples = self._collect_samples(dataloader, num_evals)
        self._validate_replayable(samples)
        n = len(samples["frame_start"])
        wants_raw = getattr(self.policy, "wants_raw", False)
        for start in range(0, n, self.pool):
            group = []
            for env, idx in zip(self.envs,
                                range(start, min(start + self.pool, n))):
                name = samples["frame_start"][idx]
                task = name.split("_")[1] if "_" in name else name
                self._ensure_task(task)
                oracle_result, oracle_mask = self.execute_oracle(
                    self.cached_keypoints[name], self.cached_configs[name],
                    self.cached_states[name], env=env)
                if wants_raw:
                    obs = self._model_obs(samples, idx, name, env)
                    sample, depth = obs, obs["depth"]
                    viz_sample = {"raw_rgb": obs["rgb"]}
                else:
                    sample, depth = self._model_sample(samples, idx, name, env)
                    viz_sample = sample
                group.append(dict(env=env, task=task, sample=sample,
                                  depth=depth, oracle_result=oracle_result,
                                  oracle_mask=oracle_mask,
                                  viz_sample=viz_sample))
            if wants_raw:
                action, _raw = self.policy([g["sample"] for g in group],
                                           pad_to=self.pool)
            else:
                action, _raw = self.policy(batchify_many(
                    [g["sample"] for g in group], pad_to=self.pool))
            for row, g in enumerate(group):
                self._apply_and_score(g["env"], action, row, g["depth"],
                                      g["task"], g["oracle_result"],
                                      g["oracle_mask"],
                                      viz_sample=g["viz_sample"])


def _dual_arm_rollout_step(evaluator, sample: Dict, depth: np.ndarray) -> None:
    """Shared model-action execution: dual-arm unless an arm is DUMMY-gated
    (reference softgym_evaluator.py:519-540, repeated in the rollout
    evaluators at :674-697 and :826-849)."""
    if getattr(evaluator.policy, "wants_raw", False):
        action, _raw = evaluator.policy(sample)
    else:
        action, _raw = evaluator.policy(batchify(sample))
    env = evaluator.env
    lp = np.asarray(action.left_pick).reshape(-1)[:2]
    lpl = np.asarray(action.left_place).reshape(-1)[:2]
    rp = np.asarray(action.right_pick).reshape(-1)[:2]
    rpl = np.asarray(action.right_place).reshape(-1)[:2]
    left_ok = np.all(lp >= 0) and np.all(lpl >= 0)
    right_ok = np.all(rp >= 0) and np.all(rpl >= 0)
    if left_ok and right_ok:
        env.pick_and_place_dual(
            env.get_world_coord_from_pixel(lp, depth),
            env.get_world_coord_from_pixel(lpl, depth),
            env.get_world_coord_from_pixel(rp, depth),
            env.get_world_coord_from_pixel(rpl, depth))
    elif right_ok:
        env.pick_and_place_single(env.get_world_coord_from_pixel(rp, depth),
                                  env.get_world_coord_from_pixel(rpl, depth))
    else:
        assert left_ok, "confidence gating must leave one arm active"
        env.pick_and_place_single(env.get_world_coord_from_pixel(lp, depth),
                                  env.get_world_coord_from_pixel(lpl, depth))


class SoftgymBimanualRolloutEvaluator(SoftgymEvaluator):
    """Open-ended instruction rollout from one cached frame
    (reference softgym_evaluator.py:627-746): reset to the named state, then
    execute a user-provided instruction sequence closed-loop, feeding each
    executed step back as temporal context. No metrics — a demo/qualitative
    run."""

    def evaluate(self, sample_name: str, instructions, **_) -> None:
        self.cloth3d = True
        self.load_cache("bimanual")
        if sample_name not in self.cached_configs:
            raise KeyError(f"{sample_name} not in the bimanual cache")
        self.task = sample_name.split("_")[1] if "_" in sample_name else sample_name
        self.reset(config=self.cached_configs[sample_name],
                   state=self.cached_states[sample_name])
        self._rollout(instructions)

    def _rollout(self, instructions) -> None:
        rgb, depth = self.env.render_image()
        mask = get_mask_from_depth(depth)
        context = []
        for instruction in instructions:
            if getattr(self.policy, "wants_raw", False):
                sample = dict(rgb=rgb, depth=depth, mask=mask,
                              context=context, instruction=instruction)
            else:
                sample = self.processor(
                    depth=depth, rgb=rgb, mask=mask, context=context,
                    instruction=instruction,
                    matrix_world_to_camera=self.env.camera_matrix, K=self.K)
            _dual_arm_rollout_step(self, sample, depth)
            context.append({"rgb": rgb.copy(), "mask": mask.copy(),
                            "depth": depth.copy()})
            rgb, depth = self.env.render_image()
            mask = get_mask_from_depth(depth)


class SoftgymBimanualRolloutEvaluatorDeng(SoftgymBimanualRolloutEvaluator):
    """Two-instruction folding rollouts of the bimanual model on the Deng
    unimanual cloth types (reference softgym_evaluator.py:750-892): per trial,
    reset a cached Tshirt/Trousers scene (no rotation) and run the fixed
    left-right + top-bottom half-fold instruction pair."""

    instructions = {
        "TshirtFold": ["Fold the Tshirt in half, left to right.",
                       "Fold the Tshirt in half, top to bottom."],
        "TrousersFold": ["Fold the Trousers in half, left to right.",
                         "Fold the Trousers in half, top to bottom."],
    }

    def evaluate(self, num_evals: int, task: str, seed=None, **_) -> None:
        from bifold_tpu_torch.env.softgym_evaluator import task_to_cloth_type
        cloth_type = task_to_cloth_type[task]
        self.cloth3d = cloth_type not in ("Square", "Rectangular")
        self.load_cache(cloth_type)
        rng = np.random.default_rng(seed)
        self.task = task
        for _ in range(num_evals):
            idx = int(rng.integers(len(self.cached_configs)))
            self.reset(config=self.cached_configs[idx],
                       state=self.cached_states[idx], task=task, random_angle=0)
            self._rollout(self.instructions[task])
