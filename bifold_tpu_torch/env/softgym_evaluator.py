"""Closed-loop simulator evaluation: oracle rollout vs model rollout.

The port's copy of bifold_tpu/env/softgym_evaluator.py, a counterpart of the
reference's softgym_evaluator.py: per task
(CornerFold/TriangleFold/StraightFold/TshirtFold/TrousersFold) x trials x 3
instruction regimes (seen / unseen-instruction / unseen-task), a cached scene
is reset with a random rotation, the scripted oracle executes the fold from
keypoints first, the env resets, and the model rolls out from rendered RGB-D
+ instruction; metrics are mean particle error vs the oracle result
(success = error < 2*particle_radius), mask IoU, and IoU-success thresholds
(softgym_evaluator.py:131-421).

The model side is injected as a ``policy(sample_batch) -> (Action, raw)``
callable so the evaluator doesn't depend on the Trainer; ``run_softgym_eval``
adapts a Trainer into one. The simulator is host code (numpy and C++); the
policy runs the model on the card (the flash kernels serve every call).

How the port differs: the evaluators' envs keep no
``dump_visualizations`` frames (JAX's render a 720 px frame and resize it
at every simulator step when ``visualize_predictions`` is on and never
write them; only ``ClothEnv.render_gif`` reads them, and collecting them
would make the Trainer's closed-loop eval about 4x slower); the per-action
PNGs are
written as JAX writes them. The instructions are drawn from a ``random.Random``
seeded by ``evaluate``'s ``seed`` (JAX draws them from the global, unseeded
``random``; the draws come in JAX's order, so JAX gives the same
instructions after ``random.seed(seed)``). Under a ``torch.distributed``
group every rank runs the whole loop with the same draws, so each policy
call is one that every rank makes.
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Callable, Dict, List, Optional

import numpy as np

from bifold_tpu_torch.data.utils import get_mask_from_depth
from bifold_tpu_torch.env.action import Action
from bifold_tpu_torch.env.cloth_env import ClothEnv, rotate_particles
from bifold_tpu_torch.env.demonstrators import Demonstrator
from bifold_tpu_torch.metrics.utils import iou

__all__ = ["task_to_cloth_type", "SoftgymEvaluator", "SoftgymSingleEvaluator",
           "SoftgymParallelEvaluator", "run_softgym_eval", "batchify",
           "batchify_many"]

task_to_cloth_type = {
    "CornerFold": "Square",
    "TriangleFold": "Square",
    "StraightFold": "Rectangular",
    "TshirtFold": "Tshirt",
    "TrousersFold": "Trousers",
}

TASKS = list(task_to_cloth_type)


def batchify(sample: Dict) -> Dict:
    """Per-sample processor output -> batch-1 dict for the model path."""
    out = {}
    for k, v in sample.items():
        if isinstance(v, np.ndarray):
            out[k] = v[None]
        else:
            out[k] = [v]
    return out


def batchify_many(samples: List[Dict], pad_to: Optional[int] = None) -> Dict:
    """Stack N per-sample processor outputs into one batch-N dict; ``pad_to``
    repeats the last sample so every policy call runs at ONE fixed batch
    shape (padded rows are discarded by the caller)."""
    if pad_to and pad_to > len(samples):
        samples = list(samples) + [samples[-1]] * (pad_to - len(samples))
    out = {}
    for k, v0 in samples[0].items():
        vs = [s[k] for s in samples]
        out[k] = np.stack(vs) if isinstance(v0, np.ndarray) else list(vs)
    return out


def action_row(action: Action, row: int) -> Action:
    """Slice one sample's worth out of a (possibly batched) Action."""
    def f(a):
        return np.asarray(a).reshape(-1, 2)[row:row + 1]

    if action.is_bimanual:
        return Action(left_pick=f(action.left_pick),
                      right_pick=f(action.right_pick),
                      left_place=f(action.left_place),
                      right_place=f(action.right_place))
    return Action(pick=f(action.pick), place=f(action.place))


class SoftgymEvaluator:
    def __init__(self, cache_dir: str, policy: Callable, processor,
                 image_size: int = 224, particle_radius: float = 0.00625,
                 visualize_predictions: bool = False,
                 run_dir: Optional[str] = None):
        self.cache = cache_dir
        self.policy = policy
        self.processor = processor
        self.visualize_predictions = visualize_predictions
        self.run_dir = run_dir

        # no dump_visualizations frames: they feed only render_gif, which no
        # evaluator calls (a render + resize at every sim step)
        self.env = ClothEnv(render_dim=image_size,
                            particle_radius=particle_radius)
        self.K = self.env.intrinsic_from_fov(image_size, image_size)
        self.error_threshold = self.env.particle_radius * 2
        self.iou_thresholds = [50, 80, 90]
        self.success: Dict = {}
        self.additional_metrics: Dict = {}
        self.cloth3d = False
        self.task = ""
        # the demonstrators' instruction draws; evaluate() reseeds it
        self.draws = random.Random()

    # ------------------------------------------------------------------

    def load_cache(self, cloth_type: str) -> None:
        path = os.path.join(self.cache, cloth_type + ".pkl")
        if not os.path.exists(path):
            from bifold_tpu_torch.env.cache_builder import CLOTH_TYPES, build_cache
            if cloth_type not in CLOTH_TYPES:
                # the bimanual replay cache is keyed by dataset frame names
                # and cannot be synthesized procedurally
                raise FileNotFoundError(
                    f"{path} not found; the '{cloth_type}' cache must be "
                    f"built from the dataset (see env/cache_builder.py)")
            build_cache(cloth_type, self.cache, n_configs=5)
        with open(path, "rb") as f:
            config_data = pickle.load(f)
        self.cached_configs = config_data["configs"]
        self.cached_states = config_data["states"]
        self.cached_keypoints = config_data.get("keypoints")

    def reset_env(self, env, config, state, task: Optional[str] = None,
                  random_angle: Optional[float] = None,
                  max_wait_step: int = 120,
                  stable_vel_threshold: float = 0.2):
        """Reset one env instance (the parallel evaluator owns a pool);
        returns the fresh demonstrator whose speeds configured the env."""
        demonstrator = Demonstrator[task](self.draws)
        env.reset(config=config, state=state, cloth3d=self.cloth3d,
                  pick_speed=demonstrator.pick_speed,
                  move_speed=demonstrator.move_speed,
                  place_speed=demonstrator.place_speed,
                  lift_height=demonstrator.lift_height)
        if random_angle:
            rotate_particles(env, [0, random_angle, 0])
            for _ in range(max_wait_step):
                env.sim.step()
                if np.all(np.abs(env.sim.get_velocities())
                          < stable_vel_threshold):
                    break
        return demonstrator

    def reset(self, config, state, task: Optional[str] = None,
              random_angle: Optional[float] = None, max_wait_step: int = 120,
              stable_vel_threshold: float = 0.2) -> None:
        self.demonstrator = self.reset_env(
            self.env, config, state, task, random_angle, max_wait_step,
            stable_vel_threshold)
        # task=None must NOT clobber a task set by the caller: the bimanual
        # replay evaluator assigns self.task from the frame name and then
        # resets (oracle, context frames, model start) with no task arg —
        # clobbering to "" sent its metric appends to a missing key
        if task is not None:
            self.task = task

    def close(self) -> None:
        self.env.close()

    def save_visuals(self, out_file_name: str, task: Optional[str] = None,
                     **kwargs) -> None:
        """Per-action rollout artifacts under
        <run_dir>/eval/softgym/<task>/ (reference softgym_evaluator.py:92-98),
        gated on visualize_predictions."""
        if not self.visualize_predictions:
            return
        from bifold_tpu_torch.utils.visualization import save_predictions

        base = os.path.join(self.run_dir or ".", "eval", "softgym",
                            task or self.task)
        save_predictions(out_folder=base, out_file_name=out_file_name,
                         **kwargs)

    def summary(self) -> Dict[str, float]:
        return_dict: Dict[str, float] = {}
        average_success = []
        for task, task_dict in self.success.items():
            if isinstance(task_dict, dict):
                for k, vals in task_dict.items():
                    avg = float(np.array(vals).mean() * 100)
                    return_dict[f"{task} {k}"] = avg
                    average_success.append(avg)
            else:
                avg = float(np.array(task_dict).mean() * 100)
                return_dict[task] = avg
                average_success.append(avg)
        for metric, metric_dicts in self.additional_metrics.items():
            for task, task_dict in metric_dicts.items():
                if isinstance(task_dict, dict):
                    for k, vals in task_dict.items():
                        return_dict[f"{metric} {task} {k}"] = float(np.array(vals).mean())
                else:
                    return_dict[f"{metric} {task}"] = float(np.array(task_dict).mean())
        if average_success:
            return_dict["average_success"] = float(np.mean(average_success))
        return return_dict


class SoftgymSingleEvaluator(SoftgymEvaluator):
    """Unimanual eval: 5 tasks x trials x 3 regimes
    (reference softgym_evaluator.py:131-421)."""

    def evaluate(self, num_evals: int, task: str, seed: Optional[int] = None) -> None:
        cloth_type = task_to_cloth_type[task]
        self.cloth3d = cloth_type not in ("Square", "Rectangular")
        self.load_cache(cloth_type)
        rng = np.random.default_rng(seed)
        self.draws = random.Random(seed)

        if task not in self.success:
            self.success[task] = {}
            for k in (["error", "iou"]
                      + [f"iou_success_{t}" for t in self.iou_thresholds]):
                self.additional_metrics.setdefault(k, {})[task] = {}

        for trial in range(num_evals):
            rand_idx = int(rng.integers(len(self.cached_configs)))
            config = self.cached_configs[rand_idx]
            state = self.cached_states[rand_idx]
            if task == "StraightFold":
                random_angle = float(rng.uniform(-80, 80))
            elif self.cloth3d:
                random_angle = float(rng.uniform(-40, 40))
            else:
                random_angle = float(rng.uniform(0, 40))

            self.reset(config=config, state=state, task=task,
                       random_angle=random_angle)
            if self.cloth3d and self.cached_keypoints is not None:
                keypoints_index = self.cached_keypoints[rand_idx]
            else:
                keypoints_index = self.env.get_square_keypoints_idx()

            if task == "StraightFold":
                angle_mode = int(abs(random_angle) > 45) + int(random_angle < -45)
                eval_datas = self.demonstrator.get_eval_instruction(angle_mode)
            else:
                eval_datas = self.demonstrator.get_eval_instruction()

            for eval_index, (eval_data, eval_name) in enumerate(
                    zip(eval_datas, ["si", "usi", "ut"])):
                if eval_name not in self.success[task]:
                    self.success[task][eval_name] = []
                    for k in self.additional_metrics:
                        self.additional_metrics[k][task][eval_name] = []

                self.reset(config=config, state=state, task=task,
                           random_angle=random_angle)
                oracle_results, oracle_masks = self.execute_oracle(
                    eval_data["pick"], eval_data["place"], eval_data["gammas"],
                    keypoints_index)

                self.reset(config=config, state=state, task=task,
                           random_angle=random_angle)
                self.execute_model(eval_data, keypoints_index, eval_index,
                                   eval_name, oracle_results, oracle_masks)

    # ------------------------------------------------------------------

    def execute_oracle(self, pick_idxs, place_idxs, gammas, keypoints_index,
                       env=None):
        env = env if env is not None else self.env
        oracle_results, oracle_masks = [], []
        for pick_idx, place_idx, gamma in zip(pick_idxs, place_idxs, gammas):
            keypoints_pos = env.get_keypoints(keypoints_index)
            pick_pos = keypoints_pos[pick_idx]
            place_pos = pick_pos + gamma * (keypoints_pos[place_idx] - pick_pos)
            env.pick_and_place_single(pick_pos.copy(), place_pos.copy())
            _, depth = env.render_image()
            oracle_masks.append(get_mask_from_depth(depth))
            oracle_results.append(env.sim.get_positions()[:, :3])
        return oracle_results, oracle_masks

    def execute_model(self, eval_data, keypoints_index, eval_index, eval_name,
                      oracle_results, oracle_masks) -> None:
        rgb, depth = self.env.render_image()
        mask = get_mask_from_depth(depth)
        context: List[Dict] = []

        rows = zip(eval_data["pick"], eval_data["place"], eval_data["gammas"],
                   eval_data["instructions"], eval_data["flags"])
        for action_index, (pick_idx, place_idx, gamma, instruction,
                           unseen_flag) in enumerate(rows):
            # regime dispatch (reference :325-355): within si/usi an action
            # flagged unseen is executed by the oracle; within ut only the
            # flagged (novel) actions go to the model.
            model_turn = (unseen_flag == 0) if eval_index < 2 else (unseen_flag == 1)
            if model_turn:
                if getattr(self.policy, "wants_raw", False):
                    # serving-path policy: raw observation, preprocessing
                    # runs on device inside the one-dispatch program
                    action, _raw = self.policy(dict(
                        rgb=rgb, depth=depth, mask=mask,
                        instruction=instruction, context=context))
                else:
                    sample = self.processor(
                        depth=depth, instruction=instruction, rgb=rgb,
                        mask=mask, context=context,
                        matrix_world_to_camera=self.env.camera_matrix,
                        K=self.K)
                    action, _raw = self.policy(batchify(sample))
                pick_pos = self.env.get_world_coord_from_pixel(
                    np.asarray(action.pick).reshape(-1)[:2], depth)
                place_pos = self.env.get_world_coord_from_pixel(
                    np.asarray(action.place).reshape(-1)[:2], depth)
            else:
                keypoints_pos = self.env.get_keypoints(keypoints_index)
                pick_pos = keypoints_pos[pick_idx]
                place_pos = pick_pos + gamma * (keypoints_pos[place_idx] - pick_pos)

            self.env.pick_and_place_single(np.array(pick_pos), np.array(place_pos))

            frame_rgb = rgb
            context.append({"rgb": rgb.copy(), "depth": depth.copy(),
                            "mask": mask.copy()})
            rgb, depth = self.env.render_image()
            mask = get_mask_from_depth(depth)

            particle_pos = self.env.sim.get_positions()[:, :3]
            error = float(np.linalg.norm(
                oracle_results[action_index] - particle_pos, axis=1).mean())
            success = error < self.error_threshold
            iou_value = iou(mask, oracle_masks[action_index])

            self.success[self.task][eval_name].append(success)
            self.additional_metrics["error"][self.task][eval_name].append(error)
            self.additional_metrics["iou"][self.task][eval_name].append(iou_value)
            for thresh in self.iou_thresholds:
                self.additional_metrics[f"iou_success_{thresh}"][self.task][
                    eval_name].append((iou_value > thresh) * 100)

            if self.visualize_predictions and model_turn:
                from bifold_tpu_torch.utils.visualization import visualize_action
                n = len(self.success[self.task][eval_name]) - 1
                viz = visualize_action({"raw_rgb": frame_rgb},
                                       action_row(action, 0))[0]
                self.save_visuals(
                    f"{eval_name}_{n:04d}_{action_index}_{int(success)}.png",
                    viz=viz, particle_pos=particle_pos)


class SoftgymParallelEvaluator(SoftgymSingleEvaluator):
    """Lockstep multi-env closed-loop eval: K trials at once, ONE batched
    policy call per action step.

    An addition of the JAX package — the reference evaluates strictly
    sequentially at batch 1 (softgym_evaluator.py:161-254), where rollout
    inference is dominated by per-call launch + host<->device transfer
    latency, not by model FLOPs. Stepping a pool of env instances in lockstep and batching
    the live trials' observations into one fixed-shape device call amortizes
    that latency pool-fold (the sim stepping stays host-side and sequential;
    on multi-core hosts it is embarrassingly parallel across envs).

    Protocol parity: the trial parameters consume the SAME np.random stream
    and the instructions the SAME seeded `random` stream, in the same order,
    as SoftgymSingleEvaluator (configs/angles first per trial, then one
    get_eval_instruction per trial — the two streams are independent), and
    the per-action metric definitions are identical — so with a
    deterministic policy ``summary()`` matches the sequential evaluator
    exactly (tests/test_torch_evaluators.py). Policy batches are padded to
    the pool size so the model path runs at one batch shape.
    """

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

    def evaluate(self, num_evals: int, task: str,
                 seed: Optional[int] = None) -> None:
        cloth_type = task_to_cloth_type[task]
        self.cloth3d = cloth_type not in ("Square", "Rectangular")
        self.load_cache(cloth_type)
        rng = np.random.default_rng(seed)
        self.draws = random.Random(seed)
        self.task = task

        if task not in self.success:
            self.success[task] = {}
            for k in (["error", "iou"]
                      + [f"iou_success_{t}" for t in self.iou_thresholds]):
                self.additional_metrics.setdefault(k, {})[task] = {}

        # Trial parameters in the sequential evaluator's exact rng order
        # (np stream: config index + angle per trial)...
        trials = []
        for _ in range(num_evals):
            rand_idx = int(rng.integers(len(self.cached_configs)))
            if task == "StraightFold":
                random_angle = float(rng.uniform(-80, 80))
            elif self.cloth3d:
                random_angle = float(rng.uniform(-40, 40))
            else:
                random_angle = float(rng.uniform(0, 40))
            trials.append((rand_idx, random_angle))
        # ...then instructions in trial order (the seeded `random` stream;
        # the only consumer, so the interleaving with np draws is irrelevant)
        eval_datas_per_trial = []
        for _, angle in trials:
            demonstrator = Demonstrator[task](self.draws)
            if task == "StraightFold":
                angle_mode = int(abs(angle) > 45) + int(angle < -45)
                eval_datas_per_trial.append(
                    demonstrator.get_eval_instruction(angle_mode))
            else:
                eval_datas_per_trial.append(
                    demonstrator.get_eval_instruction())

        for start in range(0, num_evals, self.pool):
            self._run_group(task, trials[start:start + self.pool],
                            eval_datas_per_trial[start:start + self.pool])

    # ------------------------------------------------------------------

    def _run_group(self, task: str, trials, eval_datas_per_trial) -> None:
        group = []
        for env, (rand_idx, angle), eval_datas in zip(
                self.envs, trials, eval_datas_per_trial):
            group.append(dict(env=env, angle=angle, rand_idx=rand_idx,
                              config=self.cached_configs[rand_idx],
                              state=self.cached_states[rand_idx],
                              eval_datas=eval_datas))

        for eval_index, eval_name in enumerate(["si", "usi", "ut"]):
            if eval_name not in self.success[task]:
                self.success[task][eval_name] = []
                for k in self.additional_metrics:
                    self.additional_metrics[k][task][eval_name] = []

            # oracle rollouts: sim-bound, no policy calls
            for g in group:
                self.reset_env(g["env"], g["config"], g["state"], task,
                               g["angle"])
                if self.cloth3d and self.cached_keypoints is not None:
                    g["kp"] = self.cached_keypoints[g["rand_idx"]]
                else:
                    g["kp"] = g["env"].get_square_keypoints_idx()
                ed = g["eval_datas"][eval_index]
                g["eval_data"] = ed
                g["oracle_results"], g["oracle_masks"] = self.execute_oracle(
                    ed["pick"], ed["place"], ed["gammas"], g["kp"],
                    env=g["env"])

            # model rollouts in lockstep, policy batched across the pool
            for g in group:
                self.reset_env(g["env"], g["config"], g["state"], task,
                               g["angle"])
                rgb, depth = g["env"].render_image()
                g.update(rgb=rgb, depth=depth,
                         mask=get_mask_from_depth(depth), context=[])

            max_len = max(len(g["eval_data"]["pick"]) for g in group)
            wants_raw = getattr(self.policy, "wants_raw", False)
            for action_index in range(max_len):
                live = [g for g in group
                        if action_index < len(g["eval_data"]["pick"])]
                model_gs, samples = [], []
                for g in live:
                    flag = g["eval_data"]["flags"][action_index]
                    # regime dispatch identical to execute_model above
                    g["model_turn"] = ((flag == 0) if eval_index < 2
                                       else (flag == 1))
                    if g["model_turn"]:
                        g["model_row"] = len(model_gs)
                        instruction = g["eval_data"]["instructions"][
                            action_index]
                        if wants_raw:
                            samples.append(dict(
                                rgb=g["rgb"], depth=g["depth"],
                                mask=g["mask"], instruction=instruction,
                                context=g["context"]))
                        else:
                            samples.append(self.processor(
                                depth=g["depth"], instruction=instruction,
                                rgb=g["rgb"], mask=g["mask"],
                                context=g["context"],
                                matrix_world_to_camera=g["env"].camera_matrix,
                                K=self.K))
                        model_gs.append(g)
                actions = None
                if samples:
                    if wants_raw:
                        actions, _raw = self.policy(samples,
                                                    pad_to=self.pool)
                    else:
                        actions, _raw = self.policy(
                            batchify_many(samples, pad_to=self.pool))
                for g in live:
                    self._advance_trial(g, action_index, actions, eval_name)

    def _advance_trial(self, g, action_index, actions, eval_name) -> None:
        ed = g["eval_data"]
        if g["model_turn"]:
            i = g["model_row"]
            pick_px = np.asarray(actions.pick)[i].reshape(-1)[:2]
            place_px = np.asarray(actions.place)[i].reshape(-1)[:2]
            pick_pos = g["env"].get_world_coord_from_pixel(pick_px,
                                                           g["depth"])
            place_pos = g["env"].get_world_coord_from_pixel(place_px,
                                                            g["depth"])
        else:
            keypoints_pos = g["env"].get_keypoints(g["kp"])
            pick_pos = keypoints_pos[ed["pick"][action_index]]
            place_pos = pick_pos + ed["gammas"][action_index] * (
                keypoints_pos[ed["place"][action_index]] - pick_pos)

        g["env"].pick_and_place_single(np.array(pick_pos),
                                       np.array(place_pos))
        frame_rgb = g["rgb"]
        g["context"].append({"rgb": g["rgb"].copy(),
                             "depth": g["depth"].copy(),
                             "mask": g["mask"].copy()})
        rgb, depth = g["env"].render_image()
        g.update(rgb=rgb, depth=depth, mask=get_mask_from_depth(depth))

        particle_pos = g["env"].sim.get_positions()[:, :3]
        error = float(np.linalg.norm(
            g["oracle_results"][action_index] - particle_pos, axis=1).mean())
        success = error < self.error_threshold
        iou_value = iou(g["mask"], g["oracle_masks"][action_index])

        self.success[self.task][eval_name].append(success)
        self.additional_metrics["error"][self.task][eval_name].append(error)
        self.additional_metrics["iou"][self.task][eval_name].append(iou_value)
        for thresh in self.iou_thresholds:
            self.additional_metrics[f"iou_success_{thresh}"][self.task][
                eval_name].append((iou_value > thresh) * 100)

        if self.visualize_predictions and g["model_turn"]:
            from bifold_tpu_torch.utils.visualization import visualize_action
            n = len(self.success[self.task][eval_name]) - 1
            viz = visualize_action(
                {"raw_rgb": frame_rgb},
                action_row(actions, g["model_row"]))[0]
            self.save_visuals(
                f"{eval_name}_{n:04d}_{action_index}_{int(success)}.png",
                viz=viz, particle_pos=particle_pos)


def run_softgym_eval(trainer) -> tuple:
    """Trainer adapter: run all 5 unimanual tasks (or the bimanual replay eval
    for bimanual models) and return (has_improved, metric_dict) like
    eval_epoch_pixel. The policy: the port's daemon at ``eval_serving_url``,
    else with ``eval_serving_policy`` a :class:`ServingPolicy` over
    :meth:`Trainer.serving_model` (``serving_quantize``), else the
    Trainer's ``get_action`` on host-processed samples."""
    cfg = trainer.cfg
    if cfg.get("eval_serving_url") and not trainer.processor.requires_graph:
        # rollout inference against a REMOTE serving daemon (the sim host
        # and the card's serving host are different machines)
        from bifold_tpu_torch.serve import RemotePolicy
        policy = RemotePolicy(str(cfg["eval_serving_url"]))
    elif bool(cfg.get("eval_serving_policy", False)) \
            and not trainer.processor.requires_graph:
        # serve rollout inference through the packed wire (uint8 rgb + f16
        # depth upload, preprocessing on the device)
        from bifold_tpu_torch.serving import ServingPolicy
        policy = ServingPolicy(trainer.serving_model(
            depth_wire_dtype="float16",
            quantize=cfg.get("serving_quantize") or None))
    else:
        policy = lambda batch: trainer.get_action(batch, return_raw_output=True)  # noqa: E731
    # under a group every rank runs the loop; rank 0 writes the artifacts
    visualize = bool(cfg.get("visualize_predictions", False)) and trainer.rank == 0
    if trainer.model.is_bimanual:
        from bifold_tpu_torch.env.bimanual_evaluator import (
            SoftgymBimanualEvaluator, SoftgymBimanualParallelEvaluator)
        pool = int(cfg.get("eval_parallel_envs", 1) or 1)
        cls = (SoftgymBimanualParallelEvaluator if pool > 1
               else SoftgymBimanualEvaluator)
        extra = {"pool": pool} if pool > 1 else {}
        evaluator = cls(
            cache_dir=cfg["softgym_cache"], policy=policy,
            processor=trainer.processor,
            image_size=int(dict(cfg["model"])["image_size"]),
            visualize_predictions=visualize,
            run_dir=str(trainer.run_dir), **extra)
        try:
            evaluator.evaluate(dataloader=trainer.test_dataloader,
                               num_evals=int(cfg.get("num_evals", 50)))
        except FileNotFoundError as e:
            # LOUD fallback, and ONLY for the cache/dataset-unavailable
            # cases (load_cache, _collect_samples and _validate_replayable
            # raise FileNotFoundError up front): a broad KeyError/TypeError
            # guard here once masked a real evaluator bug as "cache
            # unavailable" (the reset() task-key clobber) — code bugs must
            # propagate. Prefix every returned metric so a mis-pathed cache
            # can never masquerade as a sim eval.
            print(f"[softgym] bimanual replay eval unavailable ({e}); "
                  f"falling back to pixel metrics (keys prefixed "
                  f"'pixel_fallback/')")
            evaluator.close()
            has_improved, metrics = trainer.eval_epoch_pixel()
            return has_improved, {f"pixel_fallback/{k}": v
                                   for k, v in metrics.items()}
    else:
        pool = int(cfg.get("eval_parallel_envs", 1) or 1)
        cls = SoftgymParallelEvaluator if pool > 1 else SoftgymSingleEvaluator
        extra = {"pool": pool} if pool > 1 else {}
        evaluator = cls(
            cache_dir=cfg["softgym_cache"], policy=policy,
            processor=trainer.processor,
            image_size=int(dict(cfg["model"])["image_size"]),
            visualize_predictions=visualize,
            run_dir=str(trainer.run_dir), **extra)
        for task in TASKS:
            evaluator.evaluate(num_evals=int(cfg.get("num_evals", 50)),
                               task=task, seed=int(cfg.get("seed", 0)))
    metrics = evaluator.summary()
    evaluator.close()
    return False, metrics
