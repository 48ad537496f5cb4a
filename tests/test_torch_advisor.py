"""The port's mesh-layout advisor (``bifold_tpu_torch/parallel/advisor.py``)
against the JAX package's, in one process on fake tensors.

Held, for the tiny flagship (SiglipSequential, tiny towers, fusion of 4
heads at dim 64, depth 2) over 8 devices:

- ``param_bytes_per_device`` equals JAX's ``_leaf_shard_bytes(pshapes,
  param_sharding(mesh, pshapes))`` (bifold_tpu/parallel/advisor.py:140) under
  ``dp=8``, ``dp=2,fsdp=2,tp=2``, ``fsdp=4,tp=2`` and ``dp=4,pp=2``, with
  JAX's params from ``jax.eval_shape`` of the model's init on the conftest's
  8 CPU devices (no JAX compile);
- ``opt_state_bytes_per_device`` equals JAX's Adam state (optax, masked to
  the trainable leaves) but for optax's scalar count leaves, 4 bytes each;
- the CLI (``python -m bifold_tpu_torch advise``) ranks ``dp=4`` and
  ``dp=2,fsdp=2``, prints ``recommended: mesh.``, and ``--json`` carries
  JAX's report keys.

The advisor's record of collectives is held against four real gloo ranks in
``tests/test_torch_mesh.py``, whose ranks record theirs.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bifold_tpu_torch import __main__ as cli  # noqa: E402
from bifold_tpu_torch.config import compose  # noqa: E402
from bifold_tpu_torch.parallel.advisor import analyze_layout  # noqa: E402

TINY = ("model=siglip_sequential", "model.automodel_name=tiny", "model.dim=64",
        "model.depth=2", "model.heads=4", "model.r=2", "model.lora_dropout=0",
        "train_dataset=synthetic", "train_dataset.image_size=64",
        "train_dataset.is_bimanual=true", "train_dataset.max_context_length=2",
        "precision.compute_dtype=float32", "batch_size=8")
LAYOUTS = [{"dp": 8}, {"dp": 2, "fsdp": 2, "tp": 2}, {"fsdp": 4, "tp": 2},
           {"dp": 4, "pp": 2}]
REPORT_KEYS = {"mesh", "n_devices", "batch_global", "chip", "flops_per_device",
               "hbm_bytes_per_device", "param_bytes_per_device",
               "opt_state_bytes_per_device", "collectives",
               "collective_wire_bytes_per_device", "est"}
COUNT_BYTES = 4          # an optax count leaf: an int32 scalar


@pytest.fixture(scope="module")
def cfg():
    return compose(list(TINY))


@pytest.fixture(scope="module")
def jax_shapes(cfg):
    """The tiny flagship's params and Adam state as JAX's advisor shapes
    them (``jax.eval_shape``, nothing compiled), and the state's scalar
    leaves."""
    import jax
    import jax.numpy as jnp

    from bifold_tpu.models import build_model as jax_build_model
    from bifold_tpu.models import trainable_mask as jax_trainable_mask
    from bifold_tpu.optim import build_optimizer as jax_build_optimizer

    model_cfg = dict(cfg["model"])
    s, ctx, b = int(model_cfg["image_size"]), int(model_cfg["context_length"]), 2
    heads = ("left_pick", "right_pick", "left_place", "right_place")
    batch = {"rgb": jnp.zeros((b, 3, s, s)), "depth": jnp.zeros((b, 1, s, s)),
             "mask": jnp.zeros((b, 1, s, s)), "instruction": jnp.zeros((b, 64), jnp.int32),
             "rgb_context": jnp.zeros((b, ctx, 3, s, s)),
             "context_attention_mask": jnp.ones((b, ctx), jnp.int32),
             **{f"{h}_heatmap": jnp.zeros((b, s, s)) for h in heads}}
    model = jax_build_model(model_cfg, dtype=jnp.float32)
    pshapes = jax.eval_shape(lambda: model.init(jax.random.key(0), batch,
                                                deterministic=True))["params"]
    mask = jax_trainable_mask(pshapes, lora=True)
    tx, _ = jax_build_optimizer({"name": "adam", "lr": 1e-4, "betas": [0.9, 0.999],
                                 "eps": 1e-8, "weight_decay": 0}, None, max_iters=100,
                                trainable=mask, gradient_clip=1.0)
    oshapes = jax.eval_shape(tx.init, pshapes)
    scalars = [leaf for leaf in jax.tree_util.tree_leaves(oshapes) if leaf.shape == ()]
    return pshapes, oshapes, scalars


def _jax_bytes(shapes, layout):
    """JAX's per-device param and Adam-state bytes under ``layout`` (its
    advisor's arithmetic, ``_leaf_shard_bytes`` over ``param_sharding``)."""
    import jax

    from bifold_tpu import parallel as jax_parallel
    from bifold_tpu.parallel.advisor import _leaf_shard_bytes

    pshapes, oshapes, _ = shapes
    mesh = jax_parallel.make_mesh(dict(layout), devices=jax.devices()[:8])
    return (_leaf_shard_bytes(pshapes, jax_parallel.param_sharding(mesh, pshapes)),
            _leaf_shard_bytes(oshapes, jax_parallel.param_sharding(mesh, oshapes)))


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=[",".join(f"{k}={v}" for k, v in l.items()) for l in LAYOUTS])
def test_bytes_per_device_match_jax(cfg, jax_shapes, layout):
    got = analyze_layout(layout, n_devices=8, batch=8, model_cfg=dict(cfg["model"]),
                         processor_cfg=dict(cfg["processor"]),
                         loss_cfg=dict(cfg["loss"]), compute_dtype="float32")
    params, opt = _jax_bytes(jax_shapes, layout)
    scalars = jax_shapes[2]
    assert got["param_bytes_per_device"] == params, (got["param_bytes_per_device"], params)
    # optax keeps an int32 count per stateful transform (Adam's); the port
    # counts its updates in a Python int
    assert all(np.dtype(s.dtype).itemsize == COUNT_BYTES for s in scalars) and scalars
    assert got["opt_state_bytes_per_device"] + COUNT_BYTES * len(scalars) == opt, (
        got["opt_state_bytes_per_device"], opt, len(scalars))
    assert got["flops_per_device"] > 0 and got["hbm_bytes_per_device"] > 0
    assert got["est"]["step_ms_lower_bound"] > 0


def test_cli_ranks_layouts(capsys):
    assert cli.main(["advise", "dp=4", "dp=2,fsdp=2", "n_devices=4", *TINY,
                     "batch_size=4", "use_cpu=true"]) == 0
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if "ms/step" in line]
    assert len(lines) == 2 and "FAILED" not in out, out
    assert "recommended: mesh." in out
    assert cli.main(["advise", "dp=4", "dp=2,fsdp=2", "n_devices=4", *TINY,
                     "batch_size=4", "--json"]) == 0
    reports = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(reports) == 2
    for r in reports:
        assert REPORT_KEYS <= set(r), sorted(REPORT_KEYS - set(r))
        assert set(r["est"]) >= {"compute_ms", "hbm_ms", "link_ms", "bottleneck",
                                 "step_ms_lower_bound"}
    assert {tuple(sorted((k, v) for k, v in r["mesh"].items() if v > 1))
            for r in reports} == {(("dp", 4),), (("dp", 2), ("fsdp", 2))}


def test_cli_reports_a_failed_layout_last(capsys):
    """tp=8 does not divide the tiny fusion's 4 heads: that layout is
    reported FAILED and ranked after the one that runs."""
    assert cli.main(["advise", "tp=8", "dp=8", "n_devices=8", *TINY]) == 0
    out = capsys.readouterr().out
    ranked = [line for line in out.splitlines() if line.startswith("  ")]
    assert "ms/step" in ranked[0] and "FAILED" in ranked[1], out
    assert "recommended: mesh.dp=8" in out


def test_advisor_leaves_no_group_behind():
    assert not torch.distributed.is_initialized()
