"""Where XLA gathers the JAX package's depth-stacked fsdp leaves.

Compiles the JAX package's sharded train step (the program its mesh-layout
advisor compiles, ``bifold_tpu/parallel/advisor.py``) for the tiny
SiglipSequential on a virtual CPU mesh, with the fsdp rule's ``min_size``
lowered so that the stacked layers' kernels shard, and reads the optimized
HLO (``compiled.as_text()``): every all-gather, with its result shape,
whether it sits inside a while loop's body (the ``nn.scan`` over the depth)
or outside it, and whether its result has a stacked leaf's whole shape (the
whole stack gathered at once) or one layer's (a slice, gathered per
iteration). The answer is what a port of fsdp with one gather per block
(``bifold_tpu_torch/parallel/sharding.py``) is held to.

    python scripts/jax_fsdp_hlo.py [--fsdp 2] [--min-size 256] [--unroll N]

Runs on the CPU (8 virtual devices); needs JAX and the JAX package. Prints
one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

_GATHER = re.compile(r"= (?P<result>[^=]+?) all-gather(?:-start)?\(")
_COMP = re.compile(r"^(?:ENTRY )?%?(?P<name>[\w.\-]+) .*\{\s*$")
_BODY = re.compile(r"while\([^)]*\).*body=%?(?P<body>[\w.\-]+)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--fsdp", type=int, default=2)
    parser.add_argument("--min-size", type=int, default=2 ** 8)
    parser.add_argument("--unroll", type=int, default=0,
                        help="BIFOLD_SCAN_UNROLL (0: the CPU default, a rolled loop)")
    args = parser.parse_args()
    if args.unroll:
        os.environ["BIFOLD_SCAN_UNROLL"] = str(args.unroll)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    jax.config.update("jax_platforms", "cpu")
    from bifold_tpu import parallel
    from bifold_tpu.losses import build_loss
    from bifold_tpu.models import build_model, trainable_mask
    from bifold_tpu.optim import build_optimizer
    from bifold_tpu.parallel.advisor import _TINY_MODEL

    cfg = dict(_TINY_MODEL)
    mesh = parallel.make_mesh({"fsdp": args.fsdp}, devices=jax.devices()[:args.fsdp])
    model = build_model(cfg, dtype=jnp.float32)
    b, s, ctx = 4 * args.fsdp, int(cfg["image_size"]), int(cfg["context_length"])
    heads = ("left_pick", "right_pick", "left_place", "right_place")
    batch = {"rgb": jnp.zeros((b, 3, s, s)), "depth": jnp.zeros((b, 1, s, s)),
             "mask": jnp.zeros((b, 1, s, s)), "instruction": jnp.zeros((b, 64), jnp.int32),
             "rgb_context": jnp.zeros((b, ctx, 3, s, s)),
             "context_attention_mask": jnp.ones((b, ctx), jnp.int32),
             **{f"{h}_heatmap": jnp.zeros((b, s, s)) for h in heads}}
    pshapes = jax.eval_shape(lambda: model.init(jax.random.key(0), batch,
                                                deterministic=True))["params"]
    mask = trainable_mask(pshapes, lora=True)
    tx, _ = build_optimizer({"name": "adam", "lr": 1e-4}, None, max_iters=10,
                            trainable=mask, gradient_clip=1.0)
    oshapes = jax.eval_shape(tx.init, pshapes)
    psh = parallel.param_sharding(mesh, pshapes, min_size=args.min_size)
    osh = parallel.param_sharding(mesh, oshapes, min_size=args.min_size)

    def sds(shapes, shardings):
        return jax.tree_util.tree_map(
            lambda x, h: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=h), shapes, shardings)

    stacked = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(pshapes)[0]:
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        if "blocks" in keys:
            stacked["/".join(keys)] = list(leaf.shape)
    bsh = parallel.batch_sharding(mesh)
    key = jax.eval_shape(lambda: jax.random.key(0))
    step = parallel.make_train_step(
        model, build_loss({"name": "bce_gaussmap", "is_bimanual": True,
                           "mask_pick_heatmap": False}), tx, donate=False, trainable=mask)
    compiled = step.lower(
        (sds(pshapes, psh), sds(oshapes, osh), {},
         jax.ShapeDtypeStruct(key.shape, key.dtype, sharding=NamedSharding(mesh, P()))),
        jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype,
                                                              sharding=bsh), batch)).compile()
    hlo = compiled.as_text()

    bodies, current, gathers = set(), None, []
    for line in hlo.splitlines():
        m = _BODY.search(line)
        if m:
            bodies.add(m.group("body"))
    for line in hlo.splitlines():
        m = _COMP.match(line)        # a computation's header: not indented
        if m and not line[:1].isspace():
            current = m.group("name")
            continue
        m = _GATHER.search(line)
        if m:
            gathers.append({"computation": current, "result": m.group("result").strip()})
    wholes = {tuple(shape) for shape in stacked.values()}
    layers = {tuple(shape[1:]) for shape in stacked.values()}
    for g in gathers:
        g["in_loop_body"] = g["computation"] in bodies
        dims = re.findall(r"\[([0-9,]*)\]", g["result"])
        shape = tuple(int(d) for d in dims[0].split(",") if d) if dims else ()
        # a stacked leaf's whole shape, or one layer's (the shapes of the
        # tiny config tell the two apart; anything else is not a weight's)
        g["gathers"] = ("whole stack" if shape in wholes else
                        "one layer" if shape in layers else "other")
    print(json.dumps({
        "mesh": {"fsdp": args.fsdp}, "min_size": args.min_size,
        "scan_unroll": args.unroll or "rolled (CPU default)",
        "stacked_leaves": len(stacked),
        "stacked_fsdp_axes": {p: str(h.spec) for p, h in zip(
            ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(pshapes)[0]],
            jax.tree_util.tree_leaves(psh, is_leaf=lambda x: hasattr(x, "spec")))
            if "blocks" in p and "fsdp" in str(h.spec)},
        "all_gathers": len(gathers),
        "in_loop_body": sum(g["in_loop_body"] for g in gathers),
        "outside_loops": sum(not g["in_loop_body"] for g in gathers),
        "by_place_and_kind": {f"{'loop body' if loop else 'outside loops'}: {kind}": sum(
            g["in_loop_body"] == loop and g["gathers"] == kind for g in gathers)
            for loop in (True, False) for kind in ("whole stack", "one layer", "other")},
        "gathers": gathers}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
