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
joined a group already keeps it.

``python -m bifold_tpu_torch advise [layouts...] [n_devices=N] [--json]
[overrides...]`` ranks mesh layouts for the composed config's train step
(:func:`_advise`); it needs neither a card nor a group.
"""

from __future__ import annotations

import hashlib
import json
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


_MESH_AXES = ("dcn", "dp", "fsdp", "tp", "pp", "sp", "ep")


def _advise(args: list[str]) -> int:
    """``python -m bifold_tpu_torch advise [layouts...] [n_devices=N] [--json]
    [overrides]``

    The mesh-layout advisor on the CLI (bifold_tpu/__main__.py:38-120;
    ``parallel/advisor.py``): runs the composed config's sharded train step
    once per candidate layout as rank 0 of ``n_devices`` (default 8) on
    fake tensors and a fake process group (no card, no group; nothing
    executes) and ranks the layouts by the roofline lower bound of an H100
    step. A layout is comma-separated ``axis=size`` specs over the mesh axes
    (``dp=2,fsdp=2,tp=2``); with none given, every (dp, fsdp, tp)
    factorization of ``n_devices`` is swept. The other arguments are config
    overrides (the model, ``batch_size``, ``precision.compute_dtype``).
    ``--json`` prints the reports as one JSON list."""
    from bifold_tpu_torch.parallel.advisor import scale_report

    layouts, n_devices, overrides, as_json = [], 8, [], False
    for a in args:
        parts = [p.strip() for p in a.replace(";", ",").split(",") if p.strip()]
        keys = {p.partition("=")[0] for p in parts}
        if a == "--json":
            as_json = True
        elif keys and keys <= set(_MESH_AXES):
            layouts.append({k: int(v) for k, _, v in (p.partition("=") for p in parts)})
        elif keys == {"n_devices"}:
            n_devices = int(a.partition("=")[2])
        else:
            overrides.append(a)
    cfg = compose(overrides)
    if not layouts:
        layouts = [{"dp": dp, "fsdp": fsdp, "tp": n_devices // (dp * fsdp)}
                   for dp in range(1, n_devices + 1)
                   for fsdp in range(1, n_devices + 1)
                   if n_devices % (dp * fsdp) == 0]
    precision = dict(cfg.get("precision") or {})
    reports = scale_report(layouts, n_devices=n_devices, batch=int(cfg["batch_size"]),
                           model_cfg=dict(cfg["model"]),
                           processor_cfg=dict(cfg["processor"]),
                           loss_cfg=dict(cfg["loss"]),
                           compute_dtype=precision.get("compute_dtype", "float32"))
    if as_json:
        print(json.dumps(reports))
        return 0
    gib = 1 << 30
    print(f"mesh-layout advisor: model={cfg['model']['name']} "
          f"batch={cfg['batch_size']} over {n_devices} devices "
          f"({len(reports)} layouts; H100 roofline lower bounds, best first; "
          f"HBM bytes unfused)")
    for i, r in enumerate(reports, 1):
        mesh = {k: v for k, v in r["mesh"].items() if v > 1} or {"dp": 1}
        if "error" in r:
            print(f"  {i}. {mesh}  FAILED ({r['error'].splitlines()[0][:90]})")
            continue
        est, wire = r["est"], r["collective_wire_bytes_per_device"]
        at_capacity = " at MoE capacity" if "moe_exchange" in r else ""
        print(f"  {i}. {mesh}  >= {est['step_ms_lower_bound']:.2f} "
              f"ms/step ({est['bottleneck']}-bound; wire{at_capacity} "
              f"{wire / (1 << 20):,.1f} MiB/dev, params+opt "
              f"{(r['param_bytes_per_device'] + r['opt_state_bytes_per_device']) / gib:.2f} "
              f"GiB/dev)")
    best = next((r for r in reports if "error" not in r), None)
    if best is not None:
        rec = " ".join(f"mesh.{k}={v}" for k, v in best["mesh"].items() if v > 1)
        print(f"recommended: {rec or 'mesh.dp=1'}")
    return 0


def main(argv: list[str] | None = None) -> int:
    overrides = list(sys.argv[1:] if argv is None else argv)
    if overrides and overrides[0] == "advise":
        if "--help" in overrides or "-h" in overrides:
            print(_advise.__doc__)
            return 0
        return _advise(overrides[1:])
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
