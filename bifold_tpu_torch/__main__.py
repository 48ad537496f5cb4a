"""CLI entry point: ``python -m bifold_tpu_torch [overrides...]``.

Counterpart of bifold_tpu/__main__.py:122 (``main``): compose the config
from ``bifold_tpu_torch/conf`` with Hydra-style overrides (``model=siglip``,
``optim.lr=1e-3``, ``+k=v``, ``~k``), make the run dir
``<run_dir>/<override_dirname>``, snapshot the composed config there, then
train and evaluate (``eval_only=true``: evaluate only). An override string
longer than a file name may be (255 bytes) names the run dir by its first
200 bytes and a hash of the whole (:func:`run_dir_name`); the JAX CLI fails
on such a run dir. It trains on the CUDA card, which must be present,
unless the config asks for the CPU (``use_cpu=true``).

Launched by ``python -m torch.distributed.run --nproc_per_node N -m
bifold_tpu_torch ...`` (torchrun's environment), it joins the process
group first (``parallel.distributed_init``: NCCL on ``cuda:LOCAL_RANK``,
gloo under ``use_cpu=true``), trains over the ``mesh`` node's ``dcn x dp x
fsdp x tp x pp x sp x ep`` ranks (``mesh.fsdp=2 mesh.tp=2``, ``mesh.pp=2
mesh.pp_microbatches=2``, ``mesh.ep=2``; the Trainer places the model by
its sharding plan) and leaves the group at the end. A caller that has
joined a group already keeps it. The ``advise`` subcommand of the JAX
package (mesh layouts over many devices) is ROADMAP queue item 5 and
raises.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import torch.distributed as dist

from bifold_tpu_torch import parallel
from bifold_tpu_torch.config import Config, compose
from bifold_tpu_torch.trainer import Trainer

# overrides that do not change the run dir's identity (the reference's
# hydra.job.config.override_dirname exclude list)
_NON_SEMANTIC = {"use_wandb", "num_workers", "debug", "eval_only", "load_best",
                 "visualize_model_inputs", "visualize_predictions", "run_dir",
                 "log_every"}


def override_dirname(overrides: list[str]) -> str:
    parts = []
    for ov in overrides:
        key = ov.lstrip("+~").split("=")[0]
        if key.split(".")[0] in _NON_SEMANTIC:
            continue
        parts.append(ov.replace("/", "_"))
    return ",".join(parts) or "default"


_NAME_MAX = 255


def run_dir_name(dirname: str) -> str:
    """``dirname`` when a file name can hold it, else its first 200 bytes,
    ``-`` and 16 hex digits of its SHA-1."""
    raw = dirname.encode()
    if len(raw) <= _NAME_MAX:
        return dirname
    head = raw[:200].decode(errors="ignore")
    return f"{head}-{hashlib.sha1(raw).hexdigest()[:16]}"


def main(argv: list[str] | None = None) -> int:
    overrides = list(sys.argv[1:] if argv is None else argv)
    if overrides and overrides[0] == "advise":
        raise NotImplementedError(
            "the advise subcommand ranks mesh layouts over many devices; it is "
            "ROADMAP queue item 5, after the daemon's --mesh, a ZeRO-3 gather "
            "per block and pp/sp/ep")
    if "--help" in overrides or "-h" in overrides:
        print(__doc__)
        print("Groups: model, dataset@train_dataset, dataset@test_dataset, "
              "processor, loss, optim, scheduler")
        return 0
    cfg = compose(overrides)
    joined = not dist.is_initialized() and parallel.distributed_init(
        device="cpu" if cfg.get("use_cpu") else None)
    try:
        dirname = override_dirname(overrides)
        run_dir = Path(cfg["run_dir"]) / run_dir_name(dirname)
        trainer = Trainer(Config(cfg), run_dir=run_dir, run_name=dirname)
        if not cfg["eval_only"]:
            trainer.prepare_train()
            trainer.train()
            if trainer.preempted:
                # the checkpoint is written; skip the final eval and exit promptly
                return 0
        trainer.eval()
        return 0
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
