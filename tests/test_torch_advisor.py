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
  JAX's report keys;
- an MoE flagship under ``dp=2,ep=2`` over 4 devices: the run's
  all_to_alls equal those of JAX's compiled step (its advisor's parse of
  the HLO), and one MoE layer's FLOPs match XLA's cost analysis of JAX's
  ``expert_parallel_ffn`` within 10% once JAX's dense einsums are added.

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


def test_moe_layouts_report_at_capacity(capsys, monkeypatch):
    """An MoE flagship (4 experts in its one fusion block) over 4 devices
    under dp=2, ep=2 reports numbers, not FAILED, and its expert exchange is
    JAX's: the all_to_alls of the port's run equal, in count, result bytes
    and wire bytes, those that JAX's advisor parses from the compiled HLO
    of the same step on 4 of the conftest's CPU devices (its all-reduces
    and permutes are XLA's own and are not compared). The CLI's line says
    the wire is at MoE capacity."""
    import jax

    from bifold_tpu.config import compose as jax_compose
    from bifold_tpu.parallel.advisor import analyze_layout as jax_analyze_layout
    from bifold_tpu_torch.parallel import advisor

    moe = [*TINY, "model.moe_experts=4", "model.depth=1", "batch_size=4"]
    cfg = compose(moe)
    layout = {"dp": 2, "ep": 2}
    got = analyze_layout(layout, n_devices=4, batch=4, model_cfg=dict(cfg["model"]),
                         processor_cfg=dict(cfg["processor"]), loss_cfg=dict(cfg["loss"]),
                         compute_dtype="float32")
    want = jax_analyze_layout(layout, batch=4, model_cfg=dict(jax_compose(moe)["model"]),
                              devices=jax.devices()[:4])
    assert got["moe_exchange"] == "static capacity"
    assert want["collectives"]["all-to-all"]["count"] == 4       # two each way
    assert got["collectives"]["all-to-all"] == want["collectives"]["all-to-all"]
    # the CLI's report of it (the analysis above, not run again)
    monkeypatch.setattr(advisor, "scale_report", lambda layouts, **kw: [got])
    assert cli.main(["advise", "dp=2,ep=2", "n_devices=4", *moe]) == 0
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if "ms/step" in line]
    assert len(lines) == 1 and "FAILED" not in out and "at MoE capacity" in lines[0], out


def test_moe_layer_flops_match_jax_at_capacity():
    """The FLOPs of one MoE layer's forward and backward as the advisor
    counts them (``advisor._moe_at_capacity`` on rank 0 of a fake dp=2,
    ep=2 group, ``FlopCounterMode``) against XLA's cost analysis of JAX's
    ``expert_parallel_ffn`` and its gradient on 4 CPU devices, at 464
    tokens, D 64, H 256, 4 experts. JAX's shard_map body routes T / ep
    tokens on every device through dense (T / ep, E, C) dispatch and
    combine einsums (forward two, backward three) that the port's route
    does not run: those are added to the port's count, 5 x 2 x (T / ep) x E
    x C x D with JAX's capacity C. The sum is within 10% of XLA's, which
    also counts elementwise ops (softmax, GELU, the routing's one-hots)
    that torch's formulas leave out; the experts' FFN over ep x C slots is
    most of both (counted at C / 2 the ratio would be 0.67)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from torch.utils.flop_counter import FlopCounterMode

    from bifold_tpu import parallel as jax_parallel
    from bifold_tpu.ops import moe as jax_moe
    from bifold_tpu_torch import parallel
    from bifold_tpu_torch.models.layers import MoEFeedForward
    from bifold_tpu_torch.parallel import advisor

    t, d, h, e, ep = 464, 64, 256, 4, 2
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(shape).astype(np.float32)
              for k, shape in (("router", (d, e)), ("w1", (e, d, h)), ("b1", (e, h)),
                               ("w2", (e, h, d)), ("b2", (e, d)))}
    x = rng.standard_normal((t, d)).astype(np.float32)
    mesh = jax_parallel.make_mesh({"dp": 2, "ep": ep}, devices=jax.devices()[:4])
    grad = jax.jit(
        jax.grad(lambda x, p: jnp.sum(jax_moe.expert_parallel_ffn(x, p, mesh) ** 2),
                 argnums=(0, 1)),
        in_shardings=(NamedSharding(mesh, P("dp")),
                      {k: NamedSharding(mesh, P() if k == "router" else P("ep"))
                       for k in params}))
    cost = grad.lower(x, params).compile().cost_analysis()
    jax_flops = (cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"]
    body = t // ep
    dense = 5 * 2 * body * e * jax_moe._capacity(body, e, 1, 1.25) * d

    layer = MoEFeedForward(d, h, e)
    for k, v in params.items():     # rank 0's experts: the first e / ep
        setattr(layer, k, torch.nn.Parameter(torch.from_numpy(v if k == "router"
                                                               else v[:e // ep].copy())))
    with advisor._fake_group(4):
        layer.mesh = parallel.make_mesh({"dp": 2, "ep": ep})
        rows = torch.from_numpy(x[:t // 2]).requires_grad_()     # data rank 0's tokens
        with FlopCounterMode(display=False) as count:
            out, aux = advisor._moe_at_capacity(layer, rows)
            (out.square().sum() + aux).backward()
    ratio = (count.get_total_flops() + dense) / jax_flops
    assert 0.9 <= ratio <= 1.1, (count.get_total_flops(), dense, jax_flops)
