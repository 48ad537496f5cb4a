"""The port's sharding plan against the JAX package's ``param_sharding``.

For tiny configurations of the flagship (``siglip_sequential``, LoRA on),
``pick_place_transdecoder``, ``rgb_clip`` and ``text_unet`` with a CLIP and
with a T5 text encoder, the JAX model's params tree comes from its own
``init`` (``jax.eval_shape``, nothing compiled) on a batch the port's
processor made. ``bifold_tpu.parallel.param_sharding`` on ``make_mesh``
meshes of the 8 virtual CPU devices (``{fsdp: 2}``, ``{tp: 2}``,
``{fsdp: 2, tp: 2}``, ``{dp: 2, fsdp: 2, tp: 2}``), at ``min_size`` 2**16
and at 2**8 (so that the tiny towers shard), must equal the port's plan
(``parallel.sharding.make_plan``, made on the port's model through its
converter) leaf by leaf: the same paths and shapes, the same axis name on
every axis. The one difference the port makes, the head-wise split of the
fused ``to_qkv`` and of CLIP's ``in_proj_weight``, keeps the axis and moves
only elements, so it does not show in a spec; it shows in the tp parts
(:func:`test_fused_projections_split_by_heads`). A tp size that does not
divide the heads of an attention JAX would shard raises.
"""

import json

import pytest
import torch

import jax
import jax.numpy as jnp

from bifold_tpu import parallel as jax_parallel
from bifold_tpu.config import compose as jax_compose
from bifold_tpu.models import build_model as jax_build_model
from bifold_tpu.models.backbones import clip_backbone as jcb
from bifold_tpu_torch.config import compose
from bifold_tpu_torch.data import build_dataset, collate
from bifold_tpu_torch.models import build_model
from bifold_tpu_torch.models.backbones import clip_backbone as pcb
from bifold_tpu_torch.parallel.collectives import TPGroup
from bifold_tpu_torch.parallel.sharding import make_plan, tp_local

MESHES = ({"fsdp": 2}, {"tp": 2}, {"fsdp": 2, "tp": 2}, {"dp": 2, "fsdp": 2, "tp": 2})
MIN_SIZES = (2 ** 16, 2 ** 8)
TINY_CLIP = dict(image_size=64, patch_size=16, vision_width=64, vision_layers=2,
                 vision_heads=4, text_width=32, text_layers=2, text_heads=4,
                 context_length=77, vocab_size=49408, embed_dim=32)
TINY_T5 = {"model_type": "t5", "vocab_size": 100, "d_model": 32, "d_kv": 16,
           "d_ff": 64, "num_layers": 2, "num_heads": 2, "dropout_rate": 0.0,
           "feed_forward_proj": "relu"}
DATA = ("train_dataset=synthetic", "train_dataset.image_size=64",
        "train_dataset.is_bimanual=true", "train_dataset.n_samples=2",
        "test_dataset=null", "simulator=null")
SIGLIP = ("model=siglip_sequential", "model.automodel_name=tiny", "model.dim=64",
          "model.depth=2", "model.heads=4", "model.r=2",
          "train_dataset.max_context_length=2")
FAMILIES = {
    "flagship": SIGLIP,
    "transdecoder": SIGLIP + ("model.pick_place_model=pick_place_transdecoder",),
    "rgb_clip": ("model=rgb_clip", "model.image_size=64", "model.depth=2",
                 "model.heads=2"),
    "text_unet_clip": ("model=text_unet", "model.features=[8,16,32]"),
    "text_unet_t5": ("model=text_unet", "model.features=[8,16,32]", "T5"),
}


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Tiny CLIP towers in both packages (ViT-B/16 and RN50's text tower)
    and a tiny T5 config dir, for this module."""
    saved = {k: (jcb.CLIP_CONFIGS.get(k), pcb.CLIP_CONFIGS.get(k)) for k in ("ViT-B/16",)}
    text = jcb.CLIP_TEXT_CONFIGS["RN50"], pcb.CLIP_TEXT_CONFIGS["RN50"]
    jcb.CLIP_CONFIGS["ViT-B/16"] = jcb.ClipConfig(**TINY_CLIP)
    pcb.CLIP_CONFIGS["ViT-B/16"] = pcb.ClipConfig(**TINY_CLIP)
    jcb.CLIP_TEXT_CONFIGS["RN50"] = jcb.ClipConfig(**TINY_CLIP)
    pcb.CLIP_TEXT_CONFIGS["RN50"] = pcb.ClipConfig(**TINY_CLIP)
    t5 = tmp_path_factory.mktemp("t5")
    (t5 / "config.json").write_text(json.dumps(TINY_T5))
    yield t5
    jcb.CLIP_CONFIGS["ViT-B/16"], pcb.CLIP_CONFIGS["ViT-B/16"] = saved["ViT-B/16"]
    jcb.CLIP_TEXT_CONFIGS["RN50"], pcb.CLIP_TEXT_CONFIGS["RN50"] = text


def _overrides(family, t5_dir):
    return [f"model.text_encoder={t5_dir}" if o == "T5" else o
            for o in FAMILIES[family]] + list(DATA)


def _models(family, t5_dir):
    """(the port's model, the JAX params tree of shapes) of one family."""
    overrides = _overrides(family, t5_dir)
    cfg = compose(overrides)
    model = build_model(dict(cfg["model"]), device="cpu", seed=0)
    ds = build_dataset(cfg["train_dataset"], cfg["processor"], partition="train",
                       autoprocessor_name=dict(cfg["model"]).get("automodel_name"),
                       seed=0)
    batch = ds.processor.process_batch(collate([ds[0]]), "cpu",
                                       generator=torch.Generator().manual_seed(0))
    sample = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32 if v.dtype in
                                      (torch.int32, torch.int64) else jnp.float32)
              for k, v in batch.items() if isinstance(v, torch.Tensor)}
    jmodel = jax_build_model(dict(jax_compose(overrides)["model"]))
    shapes = jax.eval_shape(lambda s: jmodel.init(jax.random.key(0), s), sample)
    return model, dict(cfg["model"])["name"], shapes["params"]


@pytest.fixture(scope="module")
def families(tiny):
    return {f: _models(f, tiny) for f in FAMILIES}


def _jax_specs(params, mesh, min_size):
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            jax_parallel.param_sharding(mesh, params, min_size))[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path)
        out[keys] = tuple(sh.spec)
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_plan_equals_param_sharding(families, family):
    model, name, params = families[family]
    shapes = {tuple(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    sharded = {"tp": 0, "fsdp": 0}
    for mesh_cfg in MESHES:
        mesh = jax_parallel.make_mesh(mesh_cfg)
        for min_size in MIN_SIZES:
            want = _jax_specs(params, mesh, min_size)
            plan = make_plan(model, name, dict(mesh.shape), min_size)
            got = {leaf.path: leaf for leaf in plan.leaves}
            assert sorted(got) == sorted(want), (family, mesh_cfg)
            for path, spec in want.items():
                leaf = got[path]
                assert leaf.shape == shapes[path], path
                padded = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
                assert leaf.spec == padded, (family, mesh_cfg, min_size, path)
                for axis in sharded:
                    sharded[axis] += axis in leaf.spec
    # every family shards something on both axes at the small min_size,
    # but T5's names (q k v o wi wo) that the tp rule leaves alone
    assert sharded["fsdp"] > 0
    assert (sharded["tp"] > 0) == (family != "text_unet_t5")


def test_fused_projections_split_by_heads(families):
    """The port's tp part of ``to_qkv`` and ``in_proj_weight`` holds its
    heads' rows of q, of k and of v; a plain linear's, its contiguous run."""
    model, name, _ = families["rgb_clip"]
    plan = make_plan(model, name, {"tp": 2})
    state = model.state_dict()
    fused = [n for n in plan.tp if n.endswith(("to_qkv.weight", "in_proj_weight"))]
    assert {n.rsplit(".", 1)[-1] for n in fused} == {"weight", "in_proj_weight"}
    for n in fused:
        assert plan.tp[n] == (0, 3)
        full = state[n]
        third = full.shape[0] // 3
        for r in range(2):
            part = tp_local(full, TPGroup(None, 2, r), 0, 3)
            rows = torch.cat([full[b * third + r * third // 2:
                                   b * third + (r + 1) * third // 2] for b in range(3)])
            assert torch.equal(part, rows), n
    rows = [n for n, (axis, blocks) in plan.tp.items() if axis == 1]
    assert rows and all(plan.tp[n] == (1, 1) for n in rows)


def test_tp_that_does_not_divide_the_heads_raises(families, tiny):
    model, name, _ = families["flagship"]
    with pytest.raises(NotImplementedError, match="heads"):
        make_plan(model, name, {"tp": 8})       # 4 heads, inner 64 divisible by 8
    cfg = compose([o for o in _overrides("rgb_clip", tiny) if o != "model.heads=2"]
                  + ["model.heads=1"])
    one_head = build_model(dict(cfg["model"]), device="cpu", seed=0)
    with pytest.raises(NotImplementedError, match="does not divide its 1 heads"):
        make_plan(one_head, "rgb_clip", {"tp": 2})
    # where JAX leaves every projection whole (tp divides none), so does the port
    plan = make_plan(model, name, {"tp": 5})
    assert not plan.tp and not plan.modules


def test_quantized_plan_equals_param_sharding(families):
    """A server's int8 tree at ``quantize_min_size`` 256, where the stacks'
    one-dim leaves are int8 against one (1, n) scale per stack: the plan of
    the port's payloads and scales (``make_plan(quantized=)``) equals
    ``param_sharding`` of JAX's ``quantize_weights`` tree, leaf by leaf."""
    from bifold_tpu.serving import quantize_weights as jax_quantize
    from bifold_tpu_torch.models.convert import to_jax_variables
    from bifold_tpu_torch.serving import QUANT_TAG, quantize_weights, shared_scales

    model, name, _ = families["flagship"]
    state = {k: v.detach() for k, v in model.state_dict().items()}
    served = quantize_weights({n: p.detach() for n, p in model.named_parameters()}, 256)
    assert shared_scales(served)
    quantized = {n: tuple(v["scale"].shape) for n, v in served.items() if isinstance(v, dict)}
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(name, {
        k: v.numpy() for k, v in state.items()})[0])
    qtree = jax_quantize({"params": params}, min_size=256)["params"]
    assert any(QUANT_TAG in str(path) and len(leaf.shape) == 2 and leaf.shape[0] > 1
               for path, leaf in jax.tree_util.tree_flatten_with_path(qtree)[0])
    for mesh_cfg in MESHES:
        mesh = jax_parallel.make_mesh(mesh_cfg)
        want = _jax_specs(qtree, mesh, 2 ** 8)
        plan = make_plan(model, name, dict(mesh.shape), 2 ** 8, quantized)
        got = {leaf.path: leaf for leaf in plan.leaves}
        assert sorted(got) == sorted(want), mesh_cfg
        for path, spec in want.items():
            padded = tuple(spec) + (None,) * (len(got[path].shape) - len(spec))
            assert got[path].spec == padded, (mesh_cfg, path)
