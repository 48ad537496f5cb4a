"""Trainer: the train/eval loop of the PyTorch port.

Counterpart of bifold_tpu/trainer.py:79-763 (``Trainer``): seeding, model
and dataloader construction, the epoch loop with the per-step schedule and
gradient clipping, periodic pixel eval driving best/last checkpoints with
the RNG states for exact resume, eval-result yaml merging.

How the port differs:

- one device per process (``use_cpu: true`` asks for the CPU, else the
  CUDA card, which must be present). Under a ``torch.distributed`` group
  (``parallel.distributed_init``, which ``__main__`` calls) the ``mesh``
  config lays the ranks out as JAX's Trainer reads it (``dcn x dp x fsdp
  x tp x pp x sp x ep`` equal to the ranks, ``dp: -1`` taking what the
  others leave, ``pp_microbatches`` as JAX's; ``parallel.make_mesh``), and
  the model is placed by its family's sharding plan (``parallel.place``:
  tp-sharded projections, fsdp-sharded large leaves, the optimizer on the
  shards, pp stages holding their layers of each pipelined stack, which
  trains and evaluates as a GPipe pipe, ep ranks holding their experts;
  MoE layers route over the global batch). Each data rank (``dcn x dp x
  fsdp``) trains on its slice of every global batch (the loaders slice; a
  tp, pp, sp or ep group shares its slice), the step reduces the gradients as the
  plan says, samples/s counts the global batch, pixel eval sums each
  metric's sums and counts over the data ranks, and only rank 0 writes
  the config snapshot, logs, checkpoints and eval yaml. Checkpoints hold
  full tensors: every rank takes part in gathering them, rank 0 writes,
  the others wait, and every rank resumes from the same file, under any
  mesh. ``async_checkpoint`` writes synchronously under a group, as the
  JAX package does with more than one process;
- frozen parameters are ``requires_grad=False`` and the optimizer updates
  the trainable float32 masters in place; ``donate_state`` is accepted and
  does nothing;
- ``steps_per_dispatch: k``: JAX stacks k batches into one program,
  bitwise equal to k single steps. The port pulls k batches from the loader
  and then steps through them one at a time, each step with its own
  bookkeeping (counters, preemption, ``save_steps``, logging), so its
  numerics and checkpoints are those of single steps. Pulling ahead keeps
  the loader's thread from competing with the steps' launches for the
  interpreter;
- randomness comes from torch generators, not JAX keys (the port cannot
  reproduce JAX's draws, only its own): ``self.key`` is a CPU generator
  seeded by ``seed``; each epoch draws a seed from it for the epoch's step
  generator (``parallel.TrainState.key``, the counterpart of JAX's
  ``loop_key``), from which every step draws its dropout seed. Both states
  ride in every checkpoint (``jax_key``, ``loop_key``; form documented in
  :mod:`bifold_tpu_torch.utils.checkpoint`), and each batch's augmentation
  comes from a generator derived from (seed, epoch, batch index)
  (:mod:`bifold_tpu_torch.data.loader`), so a resume mid-epoch continues
  exactly;
- ``profile_steps`` records the first steps with ``torch.profiler`` into
  ``run_dir/profile``.

The four shipped model families train (``siglip``,
``siglip_sequential``, ``rgb_clip``, ``text_unet`` with a CLIP or a T5 text
encoder; a local T5 checkpoint dir that holds weights is grafted into the
frozen encoder at start, :meth:`Trainer._maybe_load_t5_weights`), the
SigLIP families with every head, fusion and FFN option of the JAX package
(``pick_place_transdecoder``, ``crossattention``, ``moe_experts``; the MoE
load-balance loss weighted in by ``model.moe_aux_weight`` and logged as
``moe_load_balance``, as the JAX Trainer does), and ``precision.remat``
recomputes the blocks in the backward. ``text_unet``'s
BatchNorm running statistics are model buffers that move in every
train-mode forward; checkpoints carry them as JAX's ``extra_vars =
{"batch_stats": ...}`` (:func:`~bifold_tpu_torch.models.convert.to_jax_variables`),
so either package's Trainer resumes the other's file.

The final eval (``eval_epoch(None)``) under ``simulator: softgym`` runs the
closed loop (:func:`bifold_tpu_torch.env.softgym_evaluator.run_softgym_eval`:
the five unimanual tasks, or the bimanual replay for a bimanual model, the
policy through ``get_action``, :meth:`Trainer.serving_model` or a remote
daemon) and writes its metrics to ``eval_<dataset>.yaml``; under a group
every rank runs the whole loop alike and rank 0 writes.
``visualize_model_inputs`` dumps the first train batch's inputs and
targets under ``input_viz/`` and ``visualize_predictions`` each pixel-eval
batch's arrows and heatmap overlays under ``eval_viz/`` (and the closed
loop's under ``eval/softgym/``), on rank 0.

A graph-conditioned config (``model.requires_graph``) trains as JAX's does:
the datasets' Processors build each sample's point-cloud graph on the host
and the loader carries it, while the model never reads it.
"""

from __future__ import annotations

import contextlib
import itertools
import random
import signal
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from bifold_tpu_torch import parallel
from bifold_tpu_torch.config import Config, save as save_config
from bifold_tpu_torch.data import get_dataloaders
from bifold_tpu_torch.env.action import Action
from bifold_tpu_torch.losses import build_loss
from bifold_tpu_torch.metrics import Metrics
from bifold_tpu_torch.models import (MODELS, build_model, decode_action,
                                     precast_frozen, resolve_device,
                                     trainable_mask)
from bifold_tpu_torch.models.convert import (from_jax_variables, load_state_dict,
                                             to_jax_variables)
from bifold_tpu_torch.models.dropout import set_dropout_generator
from bifold_tpu_torch.optim import build_optimizer
from bifold_tpu_torch.utils.checkpoint import (WRITER, AsyncCheckpointer,
                                               latest_checkpoint, load_checkpoint,
                                               save_checkpoint,
                                               unpack_generator_state)
from bifold_tpu_torch.utils.logging import Writer

__all__ = ["Trainer", "Preempted", "seed_randomness", "split_batch"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def seed_randomness(seed: int) -> torch.Generator:
    """Seed python, numpy and torch, and return the root generator (the
    counterpart of the JAX package's root key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def _draw_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen))


_HOST_KEYS = ("raw_instruction", "label_keys")


def split_batch(batch: Dict[str, Any]):
    """(tensors for the model, host-side entries): strings and metadata stay
    on the host."""
    device = {k: v for k, v in batch.items()
              if k not in _HOST_KEYS and not isinstance(v, (list, tuple, str))}
    host = {k: v for k, v in batch.items() if k not in device}
    return device, host


def _numpy(x):
    """A tensor as a host array (bfloat16 as float32); None stays None."""
    if x is None:
        return None
    return x.detach().float().cpu().numpy() if x.dtype == torch.bfloat16 \
        else x.detach().cpu().numpy()


def _inert_states(obj, kind: str):
    """The inert optax states named ``kind`` anywhere in a loaded JAX
    ``opt_state`` (see :mod:`bifold_tpu_torch.utils.checkpoint`)."""
    if type(obj).__qualname__.endswith("." + kind):
        yield obj
    children = getattr(obj, "args", None)
    if isinstance(obj, dict):
        children = obj.values()
    elif isinstance(obj, (list, tuple)):
        children = obj
    for child in children or ():
        yield from _inert_states(child, kind)


def _fill(tree, template):
    """``tree`` with every leaf that is not an array (optax's ``MaskedNode``
    of a frozen parameter) replaced by ``template``'s leaf."""
    if isinstance(template, dict):
        tree = tree if isinstance(tree, dict) else {}
        return {k: _fill(tree.get(k), v) for k, v in template.items()}
    return tree if isinstance(tree, (np.ndarray, torch.Tensor)) else template


class _NoWriter:
    """The logger of a rank other than 0: logs nothing."""

    def log(self, metrics, step) -> None:
        pass

    def close(self) -> None:
        pass


_T5_WEIGHTS = ("model.safetensors", "pytorch_model.bin", "model.safetensors.index.json",
               "pytorch_model.bin.index.json")


class Preempted(Exception):
    """Raised at a step boundary after SIGTERM. train() catches it, writes a
    step-granular last.ckpt and returns; the next run resumes mid-epoch."""


class Trainer:
    def __init__(self, cfg: Config, run_dir: Optional[str | Path] = None,
                 run_name: Optional[str] = None, device=None):
        self.cfg = cfg
        self.run_dir = Path(run_dir if run_dir is not None else cfg["run_dir"])
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._refuse_unported(cfg)
        self._family = dict(cfg["model"])["name"]
        self.mesh = parallel.make_mesh(cfg.get("mesh", {}))
        self.world = self.mesh.world
        self.rank = parallel.rank()
        if self.rank == 0:
            save_config(cfg, self.run_dir / "config.yaml")
        if device is None:
            # under a group, "cuda" is the card distributed_init made current
            device = "cpu" if cfg.get("use_cpu") else "cuda"
        self.device = resolve_device(device)

        self.key = seed_randomness(int(cfg["seed"]))
        self.writer = Writer(self.run_dir, use_wandb=bool(cfg.get("use_wandb")),
                             group=str(dict(cfg["train_dataset"]).get("name")),
                             name=run_name,
                             config=cfg.to_dict() if isinstance(cfg, Config) else dict(cfg)
                             ) if self.rank == 0 else _NoWriter()

        precision = dict(cfg.get("precision", {}))
        self.dtype = _DTYPES[precision.get("compute_dtype", "float32")]
        self.model = build_model(cfg["model"], dtype=self.dtype, device=self.device,
                                 seed=_draw_seed(self.key),
                                 remat=bool(precision.get("remat", False)))
        self._maybe_load_t5_weights()
        (self.train_dataloader, self.test_dataloader,
         self.processor) = get_dataloaders(cfg, device=self.device,
                                           process_id=self.mesh.data_rank,
                                           process_count=self.mesh.data_size)

        self.metrics = Metrics(dict(cfg["metrics"]))
        self.epoch = 0
        self.global_step = 0
        # mid-epoch resume bookkeeping: steps applied within the current
        # epoch and the in-flight step generator; both ride in every
        # checkpoint so an interrupt anywhere resumes exactly
        self._step_in_epoch = 0
        self._loop_key: Optional[torch.Generator] = None
        self._resume_step_in_epoch = 0
        self._resume_loop_key: Optional[torch.Generator] = None
        self._terminate = False
        self.preempted = False
        self._profiler = None
        self._async_ckpt = None
        self.optimizer = None
        self._train_step = None
        self.placement = None
        self._eval_step = parallel.make_eval_step(self.model)
        self.loss_fn = None

        n_params = sum(p.numel() for p in self.model.parameters())
        print(f"[trainer] model={dict(cfg['model'])['name']} params={n_params / 1e6:.1f}M "
              f"device={self.device} rank={self.rank}/{self.world}")

    def _maybe_load_t5_weights(self) -> None:
        """A T5 ``text_encoder`` given as a local Hugging Face checkpoint dir
        that holds weights (bifold_tpu/trainer.py:154-173): graft them into
        the model's ``text_encoder`` (strict names; a file that keeps one
        of the two tied token tables fills both). A dir with only a
        ``config.json`` keeps the seeded initialisation; CLIP names never
        reach here."""
        enc = dict(self.cfg["model"]).get("text_encoder")
        t5 = getattr(self.model, "text_encoder", None)
        if t5 is None or not enc or not Path(str(enc)).is_dir():
            return
        d = Path(str(enc))
        if not any((d / name).exists() for name in _T5_WEIGHTS):
            return
        sd = load_state_dict(d)
        for a, b in (("shared.weight", "encoder.embed_tokens.weight"),
                     ("encoder.embed_tokens.weight", "shared.weight")):
            if a in sd and b not in sd:
                sd[b] = sd[a]
        t5.load_state_dict(sd, strict=True)
        print(f"[trainer] loaded pretrained T5 text encoder from {d}")

    @staticmethod
    def _refuse_unported(cfg) -> None:
        name = dict(cfg["model"]).get("name")
        if name not in MODELS:
            raise NotImplementedError(f"model {name!r} is not ported (have "
                                      f"{sorted(MODELS)})")
        precision = dict(cfg.get("precision", {}))
        if precision.get("param_dtype", "float32") != "float32":
            raise NotImplementedError(
                f"precision.param_dtype {precision['param_dtype']!r}: the port keeps "
                "float32 masters only")

    # ------------------------------------------------------------------

    def prepare_train(self) -> None:
        """Loss, optimizer and schedule, then resume from ``last``."""
        cfg = self.cfg
        self.loss_fn = build_loss(dict(cfg["loss"]))
        max_iters = max(1, len(self.train_dataloader) * int(cfg["epochs"]))
        lora = bool(dict(cfg["model"]).get("lora", False))
        self._tmask = trainable_mask(self.model, lora=lora)
        self._precast = bool(cfg.get("precast_frozen", True))
        if self._precast:
            precast_frozen(self.model, self.dtype)
        self._place()
        sched_cfg = dict(cfg["scheduler"]) if cfg.get("scheduler") else None
        self.optimizer = build_optimizer(
            dict(cfg["optim"]), self.placement.step_params, sched_cfg,
            max_iters=max_iters, gradient_clip=cfg.get("gradient_clip"),
            names=self.placement.step_names)
        moe_aux = (float(getattr(self.model, "moe_aux_weight", 0.0))
                   if int(getattr(self.model, "moe_experts", 0) or 0) else 0.0)
        self._train_step = parallel.make_train_step(
            self.model, self.loss_fn, self.optimizer, moe_aux_weight=moe_aux,
            placement=self.placement)
        self._pull_ahead = max(1, int(cfg.get("steps_per_dispatch") or 1))
        self.load_model(prefer="last")

    # ------------------------------------------------------------------
    # Checkpointing
    # ------------------------------------------------------------------

    @property
    def ckpt_dir(self) -> Path:
        return self.run_dir / "checkpoints"

    def _processors(self) -> Dict[str, Any]:
        """The distinct Processors whose own generators (calls without a
        per-batch generator) a checkpoint keeps."""
        procs, seen = {}, set()
        for name, obj in (("processor", self.processor),
                          ("train_processor", getattr(self.train_dataloader,
                                                      "processor", None)),
                          ("test_processor", getattr(self.test_dataloader,
                                                     "processor", None))):
            if obj is not None and id(obj) not in seen:
                seen.add(id(obj))
                procs[f"torch:{name}"] = obj
        return procs

    def jax_variables(self):
        """(params, extra_vars): the model's weights as the JAX package's
        params tree (float32 numpy leaves; bfloat16 weights as their exact
        float32 upcast) and its BatchNorm statistics as JAX's
        ``{"batch_stats": ...}`` (empty for the families without)."""
        sd = (self.placement.full_state_dict() if self.placement is not None
              else self.model.state_dict())
        return to_jax_variables(
            self._family, {k: v.float() if v.dtype == torch.bfloat16 else v
                           for k, v in sd.items()})

    def _place(self) -> None:
        """Shard the model over the mesh by its family's plan (once; the
        model then holds this rank's parts)."""
        if self.placement is None:
            self.placement = parallel.place(self.model, self._family, self.mesh)

    def _optimizer_state(self):
        """The optimizer's state with whole moments keyed by the model's
        names (a collective under a sharded placement)."""
        if self.optimizer is None:
            return None
        return self.placement.full_optimizer_state(self.optimizer)

    def params_tree(self) -> Dict[str, Any]:
        """The params half of :meth:`jax_variables`."""
        return self.jax_variables()[0]

    def save_model(self, name: str) -> None:
        """Write ``checkpoints/<name>.ckpt`` (rank 0 only). Under a group the
        other ranks wait until it is written, so that a load that follows
        reads it. Under a sharded placement every rank first takes part in
        gathering the full tensors."""
        sharded = self.placement is not None and self.placement.sharded
        if sharded:
            params, extra_vars = self.jax_variables()
            opt_state = self._optimizer_state()
        if self.rank != 0:
            torch.distributed.barrier()
            return
        # async_checkpoint=true moves the pickle and the write off the loop
        # (the copy to host memory stays inline); one process only
        if bool(self.cfg.get("async_checkpoint", False)) and self.world == 1:
            if self._async_ckpt is None:
                self._async_ckpt = AsyncCheckpointer()
            saver = self._async_ckpt.save
        else:
            if self._async_ckpt is not None:
                self._async_ckpt.wait()
            saver = save_checkpoint
        if not sharded:
            params, extra_vars = self.jax_variables()
            opt_state = self._optimizer_state()
        saver(
            self.ckpt_dir / f"{name}.ckpt",
            params=params,
            opt_state=opt_state,
            extra_vars=extra_vars, epoch=self.epoch, step=self.global_step,
            best_eval=self.metrics.best_eval, step_in_epoch=self._step_in_epoch,
            loop_key=None if self._loop_key is None else self._loop_key.get_state(),
            jax_key=self.key.get_state(),
            host_rng_states={k: p.generator_states()
                             for k, p in self._processors().items()},
            metadata={"model": dict(self.cfg["model"]),
                      "tracked_metric": self.metrics.tracked_metric})
        if self.world > 1:
            torch.distributed.barrier()

    def load_model(self, prefer: str = "last", path: Optional[Path] = None) -> bool:
        """Restore the newest ``prefer`` (else last, else best) checkpoint of
        this run: weights and BatchNorm statistics (re-applying
        ``precast_frozen``), optimizer state, counters, the root and step
        generators and the Processors' generators. Reads both the port's
        files and the JAX package's (of which only the weights, the
        statistics, the epoch counters and the Adam moments carry over)."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()     # the file we read must be complete
        path = path or latest_checkpoint(self.ckpt_dir, prefer=prefer)
        if path is None:
            return False
        payload = load_checkpoint(path)
        weights = from_jax_variables(self._family, payload["params"],
                                     payload.get("extra_vars"))
        weights = {k: v if isinstance(v, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in weights.items()}
        if self.placement is not None:
            self.placement.load_full_state_dict(weights)
        else:
            self.model.load_state_dict(weights, strict=True)
            self._place()
        if not getattr(self, "_precast", False):
            low = [n for n, p in self.model.named_parameters()
                   if isinstance(weights[n], torch.Tensor)
                   and weights[n].dtype == torch.bfloat16]
            if low:
                warnings.warn(
                    f"precast_frozen=false but {len(low)} restored weights were "
                    f"bfloat16 in the checkpoint, e.g. {low[0]}", stacklevel=2)
        ours = dict(payload.get("metadata") or {}).get("writer") == WRITER
        if self.optimizer is not None and payload.get("opt_state") is not None:
            self.placement.load_optimizer_state(
                self.optimizer, payload["opt_state"] if ours else self._jax_opt_state(payload))
        self.epoch = int(payload.get("epoch", 0))
        self.global_step = int(payload.get("step", 0))
        self.metrics.best_eval = payload.get("best_eval")
        self._resume_step_in_epoch = int(payload.get("step_in_epoch", 0) or 0)
        self._resume_loop_key = None
        if ours:
            if payload.get("jax_key") is not None:
                self.key.set_state(unpack_generator_state(payload["jax_key"]))
            if payload.get("loop_key") is not None:
                self._resume_loop_key = torch.Generator()
                self._resume_loop_key.set_state(unpack_generator_state(payload["loop_key"]))
            saved = payload.get("host_rng_states") or {}
            for k, proc in self._processors().items():
                if k in saved:
                    proc.set_generator_states(saved[k])
        print(f"[trainer] resumed from {path} (epoch {self.epoch})")
        return True

    def _jax_opt_state(self, payload) -> dict:
        """The Adam moments and update count of a JAX checkpoint's optax
        state (``ScaleByAdamState(count, mu, nu)``), in the port's
        optimizer state form; {} when it has none."""
        adam = next(_inert_states(payload["opt_state"], "ScaleByAdamState"), None)
        if adam is None or self.optimizer.mu is None:
            return {}
        count, mu, nu = adam.args
        names = {n for n, p in self.model.named_parameters() if p.requires_grad}
        out = {"count": int(np.asarray(count))}
        for key, tree in (("mu", mu), ("nu", nu)):
            moments = from_jax_variables(self._family,
                                         _fill(tree, payload["params"]),
                                         payload.get("extra_vars"))
            out[key] = {n: v for n, v in moments.items() if n in names}
        return out

    # ------------------------------------------------------------------
    # Training loop
    # ------------------------------------------------------------------

    def train(self) -> None:
        cfg = self.cfg
        eval_epochs = int(cfg.get("eval_epochs") or 0)
        save_epochs = cfg.get("save_epochs")
        # SIGTERM becomes a checkpoint at the next step boundary and a clean
        # return. Signals reach the main thread only; elsewhere the flag can
        # be set on the trainer directly. _terminate is cleared where it is
        # honoured, not here: a flag set just before train() still preempts.
        self.preempted = False
        installed = False
        prev_handler = None

        def _on_term(signum, frame):
            self._terminate = True
            print("[trainer] SIGTERM: checkpointing at the next step "
                  "boundary", flush=True)

        if threading.current_thread() is threading.main_thread():
            prev_handler = signal.signal(signal.SIGTERM, _on_term)
            installed = True
        try:
            for epoch in range(self.epoch, int(cfg["epochs"])):
                self.epoch = epoch
                self.train_epoch()
                # the epoch is complete: checkpoints from here on resume
                # after it
                self.epoch = epoch + 1
                if self._terminate:   # the notice landed on the last step
                    raise Preempted()
                if eval_epochs and (epoch + 1) % eval_epochs == 0:
                    has_improved, metric_dict = self.eval_epoch(epoch)
                    self.writer.log({f"eval/{k}": v for k, v in metric_dict.items()},
                                    self.global_step)
                    if has_improved:
                        self.save_model("best")
                    if self._terminate:   # the notice landed during the eval
                        raise Preempted()
                if save_epochs and (epoch + 1) % int(save_epochs) == 0:
                    self.save_model("last")
        except Preempted:
            self.preempted = True
            self._terminate = False   # consumed: a later train() resumes
            self.save_model("last")
            print(f"[trainer] preempted at epoch {self.epoch} step "
                  f"{self._step_in_epoch}; saved step-granular last.ckpt — "
                  f"the next run resumes mid-epoch", flush=True)
            if self._async_ckpt is not None:
                self._async_ckpt.wait()
            return
        except (KeyboardInterrupt, Exception):
            # persist progress before dying; a failed save must not mask the
            # original exception
            try:
                if self.optimizer.in_update:
                    # stopped part-way through writing the weights: no
                    # checkpoint can match them, the one on disk stands
                    print(f"[trainer] interrupted inside an optimizer update "
                          f"at epoch {self.epoch}; last.ckpt not rewritten")
                else:
                    self.save_model("last")
                    print(f"[trainer] interrupted at epoch {self.epoch}; "
                          f"saved checkpoints/last.ckpt for resume")
            except Exception as save_err:  # noqa: BLE001
                print(f"[trainer] interrupt checkpoint failed: {save_err!r}")
            raise
        finally:
            self._stop_profiler()
            # restore by whether we installed (signal() returns None for a
            # handler installed from C, and leaking _on_term would make the
            # process unkillable by SIGTERM)
            if installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None
                              else signal.SIG_DFL)
        self.epoch = int(cfg["epochs"])
        if self._terminate:
            # the notice landed after the last step: training is complete,
            # but callers must still skip post-training work
            self._terminate = False
            self.preempted = True
        self.save_model("last")
        if self._async_ckpt is not None:
            self._async_ckpt.wait()     # surface write errors before returning

    def _stop_profiler(self) -> None:
        """Stop the ``profile_steps`` trace (idempotent) and export it to
        ``run_dir/profile/trace.json``."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        try:
            prof.stop()
            out = self.run_dir / "profile"
            out.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(out / "trace.json"))
        except Exception as e:  # noqa: BLE001 - best-effort cleanup
            print(f"[trainer] profiler stop failed: {e!r}")

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pulled_ahead(self):
        """The epoch's batches, taken from the loader ``steps_per_dispatch``
        at a time before the first of them is stepped."""
        it = iter(self.train_dataloader)
        while group := list(itertools.islice(it, self._pull_ahead)):
            yield from group

    def train_epoch(self) -> float:
        # log_every=0 disables step logging (epoch summaries still emit)
        log_every = int(self.cfg.get("log_every", 50) or 0)
        save_steps = int(self.cfg.get("save_steps") or 0)
        running, n_steps = 0.0, 0
        t_epoch = time.time()
        samples = 0
        profile_steps = int(self.cfg.get("profile_steps") or 0)
        if profile_steps and self.epoch == 0 and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            self._profiler = profile(activities=activities)
            self._profiler.start()
        self.train_dataloader.set_epoch(self.epoch)
        start = 0
        if self._resume_step_in_epoch:
            # mid-epoch resume: the same epoch permutation (index-derived),
            # the applied batches skipped, the in-flight step generator
            # continued (self.key was already drawn past this epoch)
            start = self._resume_step_in_epoch
            loop_key = self._resume_loop_key or torch.Generator().manual_seed(
                _draw_seed(self.key))
            self.train_dataloader.start_batch = start
            print(f"[trainer] resuming epoch {self.epoch} at step {start}")
        else:
            loop_key = torch.Generator().manual_seed(_draw_seed(self.key))
        self._resume_step_in_epoch, self._resume_loop_key = 0, None
        self._step_in_epoch = start
        self._loop_key = loop_key
        state = parallel.TrainState(self.optimizer, loop_key, self.global_step)
        checked_grads = not bool(self.cfg.get("debug"))
        readback_window = max(0, int(self.cfg.get("loss_readback_window", 2) or 0))
        pending = []   # loss tensors read back late

        for b in self._pulled_ahead():
            batch = split_batch(b)[0]
            if not checked_grads:
                self._debug_check_gradients(batch)
                checked_grads = True
            if self.cfg.get("visualize_model_inputs") and self.global_step == 0:
                self._visualize_model_inputs(b)
            t0 = time.time()
            key_before, done = loop_key.get_state(), self.optimizer.steps_done
            try:
                state, step_metrics = self._train_step(state, batch)
            except BaseException:
                # keep the counters and the step generator with the weights,
                # so that train()'s interrupt checkpoint matches them
                if self.optimizer.steps_done != done:     # the update went in
                    self.global_step += 1
                    self._step_in_epoch += 1
                elif not self.optimizer.in_update:        # no weight changed
                    loop_key.set_state(key_before)
                raise
            # the step has updated the weights, the optimizer state and the
            # step generator in place: the counters move with it
            self.global_step += 1
            self._step_in_epoch += 1
            n_steps += 1
            pending.append(step_metrics["loss"])
            while len(pending) > readback_window:
                running += float(pending.pop(0))
            first = next(v for v in batch.values() if isinstance(v, torch.Tensor))
            samples += int(first.shape[0]) * self.mesh.data_size   # the global batch
            if self._terminate:
                raise Preempted()
            if save_steps and self.global_step % save_steps == 0:
                self.save_model("last")
            if self._profiler is not None and n_steps >= profile_steps:
                self._synchronize()
                self._stop_profiler()
            if log_every and self.global_step % log_every == 0:
                while pending:           # a sync point: running is current
                    running += float(pending.pop(0))
                self.writer.log(
                    {"train/loss": float(step_metrics["loss"]),
                     **{f"train/{k}": float(v) for k, v in step_metrics.items()
                        if k != "loss"},
                     "train/lr": self.optimizer.schedule(self.global_step),
                     "train/step_time_s": time.time() - t0},
                    self.global_step)
        while pending:
            running += float(pending.pop(0))
        if self._profiler is not None:
            # epoch 0 ended before profile_steps steps: close the trace here
            self._synchronize()
            self._stop_profiler()
        # epoch complete: later checkpoints are epoch-boundary ones
        self._step_in_epoch = 0
        self._loop_key = None
        dt = time.time() - t_epoch
        mean_loss = running / max(n_steps, 1)
        throughput = samples / dt if dt > 0 else 0.0
        self.writer.log({"train/epoch": self.epoch, "train/mean_loss": mean_loss,
                         "train/samples_per_sec": throughput}, self.global_step)
        print(f"[epoch {self.epoch}] loss={mean_loss:.4f} "
              f"({throughput:.1f} samples/s)")
        return mean_loss

    def _visualize_model_inputs(self, batch) -> None:
        """Dump the first train batch's inputs + targets for inspection
        (bifold_tpu/trainer.py:633-645), on rank 0."""
        if self.rank != 0:
            return
        from bifold_tpu_torch.utils.visualization import save_predictions
        out = str(self.run_dir / "input_viz")
        raw_rgb = _numpy(batch.get("raw_rgb"))
        depth = _numpy(batch["depth"]) if "depth" in batch else None
        for j in range(min(len(raw_rgb), 4)):
            heatmaps = {k: _numpy(v)[j] for k, v in batch.items()
                        if k.endswith("_heatmap") and not isinstance(v, list)}
            save_predictions(
                out, f"{j}.png", rgb=raw_rgb[j],
                depth=depth[j] if depth is not None else None, **heatmaps)

    def _debug_check_gradients(self, batch) -> None:
        """Debug-mode invariant: every trainable parameter receives a nonzero
        gradient on the first step (``lora_A`` excluded: it has zero
        gradient at init, since ``lora_B`` starts at zero). Under a
        placement: the tensors its step differentiates by name (those the
        stacks' blocks gather reach their fsdp chunks another way)."""
        named = (self.placement.grad_params if self.placement is not None else
                 [(n, p) for n, p in self.model.named_parameters() if p.requires_grad])
        self.model.train()
        set_dropout_generator(self.model, torch.Generator(self.device).manual_seed(0))
        gathered = (self.placement.gathered() if self.placement is not None
                    else contextlib.nullcontext())
        try:
            with gathered:
                loss, _ = self.loss_fn(self.model(batch), batch)
                grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        finally:
            set_dropout_generator(self.model, None)
        dead = [n for (n, _), g in zip(named, grads)
                if (g is None or float(g.abs().max()) == 0.0) and "lora_A" not in n]
        if dead:
            print(f"[debug] WARNING: {len(dead)} trainable params got zero "
                  f"gradient, e.g. {dead[:5]}")
        else:
            print("[debug] all trainable params received gradients "
                  "(lora_A excluded: zero at init by construction)")

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------

    def get_action(self, batch: Dict[str, Any], return_raw_output: bool = False):
        """No-grad forward (the inference kernel on the card) and decode ->
        Action of numpy (B, 2) pixel arrays. Numpy arrays in ``batch`` (a
        host-processed closed-loop sample) are uploaded to the device."""
        device_batch, _ = split_batch(batch)
        device_batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                        if isinstance(v, np.ndarray) else v
                        for k, v in device_batch.items()}
        with (self.placement.gathered() if self.placement is not None
              else contextlib.nullcontext()):
            out = self._eval_step(device_batch)
        model = self.model
        decoded = decode_action(out, device_batch, is_bimanual=model.is_bimanual,
                                constrain_pick_mask=getattr(model, "constrain_pick_mask", True),
                                threshold=float(model.threshold))
        decoded = {k: _numpy(v) for k, v in decoded.items()}
        if model.is_bimanual:
            action = Action(left_pick=decoded["left_pick"],
                            right_pick=decoded["right_pick"],
                            left_place=decoded["left_place"],
                            right_place=decoded["right_place"])
        else:
            action = Action(pick=decoded["pick"], place=decoded["place"])
        if return_raw_output:
            return action, {k: _numpy(v) for k, v in out.items()}
        return action

    def eval_epoch(self, epoch: Optional[int] = None):
        """Pixel metrics during training; the closed loop at the final eval
        (epoch None) under ``simulator: softgym``
        (bifold_tpu/trainer.py:701-707)."""
        if epoch is None and self.cfg.get("simulator") == "softgym":
            return self.eval_epoch_softgym()
        return self.eval_epoch_pixel()

    def eval_epoch_softgym(self):
        """The closed-loop simulator eval: (False, its metrics)."""
        from bifold_tpu_torch.env.softgym_evaluator import run_softgym_eval
        self._place()
        return run_softgym_eval(self)

    def serving_model(self, **kwargs):
        """A :class:`~bifold_tpu_torch.serving.ServingModel` of the model as
        it stands, on the Trainer's device, with the Trainer's Processor
        (``kwargs``: ``depth_wire_dtype``, ``quantize``, ...). Under a group
        of more than one rank every rank builds it alike (a collective): a
        fresh model given the whole weights, served over the Trainer's
        mesh."""
        from bifold_tpu_torch.serving import ServingModel
        if self.world == 1:
            return ServingModel(self.model, None, self.processor, device=self.device,
                                **kwargs)
        self._place()
        model = build_model(self.cfg["model"], dtype=self.dtype, device=self.device)
        return ServingModel(model, self.placement.full_state_dict(), self.processor,
                            mesh=self.mesh, device=self.device, **kwargs)

    def eval_epoch_pixel(self):
        """Pixel metrics over the test loader; under a group each batch's
        sums and counts are summed over the data ranks first, so the metrics
        are the global batches'."""
        self._place()
        self.metrics.reset()
        group = self.mesh.groups["data"]
        reduce = ((lambda values: parallel.all_reduce_values(values, group))
                  if self.mesh.data_size > 1 else None)
        visualize = bool(self.cfg.get("visualize_predictions")) and self.rank == 0
        for batch_idx, batch in enumerate(self.test_dataloader):
            action, raw_output = self.get_action(batch, return_raw_output=True)
            sample = {k: _numpy(v) if isinstance(v, torch.Tensor) else v
                      for k, v in batch.items()}
            self.metrics(action=action, sample=sample, raw_output=raw_output,
                         reduce=reduce)
            if visualize:
                self._visualize_predictions(sample, action, raw_output, batch_idx)
        return self.metrics.summary()

    def _visualize_predictions(self, sample, action, raw_output, batch_idx) -> None:
        """Arrow overlays + heatmap blends per eval batch
        (bifold_tpu/trainer.py:718-729)."""
        from bifold_tpu_torch.utils.visualization import save_predictions, visualize_action
        out = str(self.run_dir / "eval_viz")
        for j, img in enumerate(visualize_action(sample, action)):
            heatmaps = {k: np.asarray(v)[j] for k, v in raw_output.items()
                        if k.endswith("_heatmap")}
            save_predictions(out, f"{batch_idx:04d}_{j}.png",
                             rgb=np.asarray(sample["raw_rgb"])[j], viz=img,
                             **heatmaps)

    def eval(self) -> Dict[str, float]:
        """Final eval: load best (or last), run, merge into
        ``eval_<dataset>.yaml``."""
        import yaml

        prefer = "best" if self.cfg.get("load_best") else "last"
        self.load_model(prefer=prefer)
        _, metric_dict = self.eval_epoch(None)
        ds_name = dict(self.cfg["test_dataset"]).get("name") or \
            dict(self.cfg["train_dataset"]).get("name")
        out_path = self.run_dir / f"eval_{ds_name}.yaml"
        old: Dict[str, Any] = {}
        if out_path.exists():
            old = yaml.safe_load(out_path.read_text()) or {}
            for k, v in metric_dict.items():
                if k in old and old[k] is not None:
                    print(f"[eval] {k}: {old[k]} -> {v}")
        old.update({k: (None if v is None or (isinstance(v, float) and np.isnan(v))
                        else float(v)) for k, v in metric_dict.items()})
        if self.rank == 0:
            out_path.write_text(yaml.safe_dump(old, sort_keys=False))
        print(f"[eval] {metric_dict}")
        return metric_dict
