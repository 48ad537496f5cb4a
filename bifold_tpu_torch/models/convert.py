"""JAX variables <-> the reference's torch state dict, numpy only.

The port's own copies of ``convert_bifold`` (bifold_tpu/models/convert.py
:442, with ``convert_siglip`` :83, ``_convert_clip_openai`` :140 and their
helpers ``_linear``, ``_ln``, ``_wrap_lora``, ``_stack_blocks``,
``_max_index``), ``convert_bifold_inverse`` (:551-737),
``convert_text_unet`` (:340) and ``convert_text_unet_inverse`` (:740-798)
with their T5 branches (``convert_t5`` :261, ``convert_t5_inverse`` :302),
and ``load_state_dict`` (:801), for the four model families this port
serves. The keys of the state dict
are the names the port's modules carry, so
``model.load_state_dict(convert_bifold_inverse(params), strict=True)`` loads
a JAX-trained or JAX-initialised model into the port, and
``convert_bifold(model.state_dict())`` gives the params tree a JAX
checkpoint holds:

- HF SigLIP towers under ``siglip_model.model.`` when the params carry LoRA
  (peft ``base_layer`` / ``lora_A.<adapter>`` / ``lora_B.<adapter>``), else
  under ``siglip_model.``;
- OpenAI CLIP towers under ``clip_encoder.`` (``visual.*``, the text tower
  at the top level; q, k and v fused into ``attn.in_proj_*``), and
  ``project``;
- ``text_token``, ``image_token``, ``context_pos_embedding``,
  ``rgb_pos_embedding``, ``text_pos_embedding``;
- the fusion stack as ``pick_place.fusion.transformer_encoder.layers.i.{0,1}``;
- the conv decoder heads at ``decoder_net.{0,2,4,6,8}``.

The head, fusion and FFN variants the reference's converter names nothing
for (the JAX package's raises for MoE) follow the JAX parameter paths:
``pick_place.{pick,place,pick_place}_fusion`` beside ``pick_place.fusion``;
``<fusion>.registers``; an MoE FFN at ``...layers.i.1.fn.{router,w1,b1,w2,b2}``
and cross-attention at ``<fusion>.cross_attention.{query,key,value,out}
.{kernel,bias}``, both in JAX's shapes; the transformer decoders at
``pick_place.{pick,place}_decoder`` and ``pick_place.mask_head`` as
``decoder_embed``, ``blocks.layers.i`` (the HF block names),
``decoder_norm``, ``decoder_pred``.

``text_unet`` carries BatchNorm statistics besides its params:
``convert_text_unet`` / ``convert_text_unet_inverse`` move (params,
batch_stats) and the state dict's ``running_mean`` / ``running_var``
together; its T5 text encoder (``text_encoder.``, Hugging Face
``T5EncoderModel`` names) becomes JAX's ``text_encoder`` subtree (one
``relative_attention_bias`` at the encoder level, ``block_<i>_*`` dense
kernels), and back with both tied token tables (``shared.weight`` and
``encoder.embed_tokens.weight``). :func:`to_jax_variables` and
:func:`from_jax_variables` take the family's name and look its converter
up, with JAX's ``extra_vars`` layout (``{"batch_stats": ...}``, empty for
the other families).

The inverses also take ``torch.bfloat16`` leaves (a JAX checkpoint's
precast frozen towers, as :mod:`bifold_tpu_torch.utils.checkpoint` reads
them): they move them with the same transposes and indexing, as tensors.

:func:`load_state_dict` reads a checkpoint in the layouts the JAX package
reads: a Hugging Face directory (a ``*.index.json`` shard map,
``model.safetensors`` or ``pytorch_model.bin``), a ``.safetensors`` file
through the port's own reader (:mod:`bifold_tpu_torch.utils.safetensors`),
or a torch pickle through ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from bifold_tpu_torch.utils.safetensors import load_file

__all__ = ["convert_bifold", "convert_siglip", "convert_bifold_inverse",
           "convert_text_unet", "convert_text_unet_inverse", "convert_t5",
           "convert_t5_inverse", "load_state_dict", "to_jax_variables",
           "from_jax_variables"]


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _linear(sd: Dict, prefix: str, bias: bool = True) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[prefix + ".weight"]).T}
    if bias and prefix + ".bias" in sd:
        out["bias"] = _np(sd[prefix + ".bias"])
    return out


def _ln(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[prefix + ".weight"]),
            "bias": _np(sd[prefix + ".bias"])}


def _wrap_lora(dense: Dict[str, np.ndarray], lora: bool, rank: int,
               in_dim: int, out_dim: int) -> Dict:
    """Base kernel under LoRADense layout with zero adapters (peft
    semantics: B = 0, the adapter starts as a no-op)."""
    if not lora:
        return dense
    return {"base": dense,
            "lora_a": np.zeros((in_dim, rank), np.float32),
            "lora_b": np.zeros((rank, out_dim), np.float32)}


def _stack_tree(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack_tree([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _stack_blocks(blocks: list, scan_layers: bool) -> Dict:
    """Per-layer param dicts -> encoder subtree: stacked along a leading
    depth axis under ``blocks/block`` (the JAX Transformer's nn.scan layout,
    used when depth > 1), else unrolled as ``block_i``."""
    if not scan_layers or len(blocks) == 1:
        return {f"block_{i}": b for i, b in enumerate(blocks)}
    return {"blocks": {"block": _stack_tree(blocks)}}


def _max_index(keys, pattern: str) -> int:
    """Highest ``N`` in keys matching ``...{pattern}N...`` + 1 (0 if none)."""
    rx = re.compile(pattern + r"(\d+)")
    hits = [int(m.group(1)) for k in keys for m in [rx.search(k)] if m]
    return max(hits) + 1 if hits else 0


def convert_siglip(sd: Dict, *, layers: int = 12, lora: bool = False,
                   lora_rank: int = 8, scan_layers: bool = True,
                   lora_targets=("q_proj", "v_proj"),
                   lora_values=None) -> Dict:
    """HF SiglipModel state dict -> the ``siglip_model`` params subtree.
    ``lora_values``: optional ``(A, B)`` dicts keyed by the projection path
    (``vision_model.encoder.layers.0.self_attn.q_proj``) holding trained
    peft ``lora_A`` / ``lora_B`` weights."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    out: Dict[str, Any] = {"vision_model": {}, "text_model": {}}

    vm = out["vision_model"]
    patch_w = _np(sd["vision_model.embeddings.patch_embedding.weight"])
    vm["patch_embedding"] = {
        "kernel": patch_w.transpose(2, 3, 1, 0),
        "bias": _np(sd["vision_model.embeddings.patch_embedding.bias"]),
    }
    vm["position_embedding"] = _np(
        sd["vision_model.embeddings.position_embedding.weight"])
    vm["post_layernorm"] = _ln(sd, "vision_model.post_layernorm")

    tm = out["text_model"]
    tm["token_embedding"] = {
        "embedding": _np(sd["text_model.embeddings.token_embedding.weight"])}
    tm["position_embedding"] = _np(
        sd["text_model.embeddings.position_embedding.weight"])
    tm["final_layer_norm"] = _ln(sd, "text_model.final_layer_norm")

    for tower, dst in (("vision_model", vm), ("text_model", tm)):
        blocks = []
        for i in range(layers):
            p = f"{tower}.encoder.layers.{i}"
            attn = {}
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                dense = _linear(sd, f"{p}.self_attn.{proj}")
                if proj in ("q_proj", "k_proj", "v_proj") and proj in lora_targets:
                    d_in, d_out = dense["kernel"].shape
                    dense = _wrap_lora(dense, lora, lora_rank, d_in, d_out)
                    key = f"{p}.self_attn.{proj}"
                    if lora and lora_values and key in lora_values[0]:
                        dense["lora_a"] = _np(lora_values[0][key]).T  # (in, r)
                        dense["lora_b"] = _np(lora_values[1][key]).T  # (r, out)
                attn[proj] = dense
            blocks.append({
                "norm1": _ln(sd, f"{p}.layer_norm1"),
                "norm2": _ln(sd, f"{p}.layer_norm2"),
                "attn": attn,
                "mlp": {"fc1": _linear(sd, f"{p}.mlp.fc1"),
                        "fc2": _linear(sd, f"{p}.mlp.fc2")},
            })
        dst["encoder"] = _stack_blocks(blocks, scan_layers)
    return out


def _clip_blocks(sd: Dict, prefix: str, n: int, scan_layers: bool) -> Dict:
    """OpenAI residual blocks ``<prefix>.resblocks.<i>`` -> the JAX
    Transformer subtree, the fused in-projection split into q, k, v."""
    blocks = []
    for i in range(n):
        p = f"{prefix}.resblocks.{i}"
        w = _np(sd[f"{p}.attn.in_proj_weight"])            # (3D, D)
        b = _np(sd[f"{p}.attn.in_proj_bias"])
        d = w.shape[0] // 3
        attn = {proj: {"kernel": w[j * d:(j + 1) * d].T, "bias": b[j * d:(j + 1) * d]}
                for j, proj in enumerate(("q_proj", "k_proj", "v_proj"))}
        attn["out_proj"] = _linear(sd, f"{p}.attn.out_proj")
        blocks.append({"norm1": _ln(sd, f"{p}.ln_1"), "norm2": _ln(sd, f"{p}.ln_2"),
                       "attn": attn,
                       "mlp": {"fc1": _linear(sd, f"{p}.mlp.c_fc"),
                               "fc2": _linear(sd, f"{p}.mlp.c_proj")}})
    return _stack_blocks(blocks, scan_layers)


def _convert_clip_text(sd: Dict, scan_layers: bool) -> Dict:
    """The text tower's keys of an OpenAI-named CLIP state dict -> the
    ``text`` subtree."""
    layers = _max_index([k for k in sd if k.startswith("transformer.")],
                        r"resblocks\.")
    txt = {"token_embedding": {"embedding": _np(sd["token_embedding.weight"])},
           "positional_embedding": _np(sd["positional_embedding"]),
           "ln_final": _ln(sd, "ln_final"),
           "transformer": _clip_blocks(sd, "transformer", layers, scan_layers)}
    if "text_projection" in sd:
        txt["text_projection"] = _np(sd["text_projection"])
    return txt


def _convert_clip_openai(sd: Dict, scan_layers: bool = True) -> Dict:
    """OpenAI-named CLIP state dict (the keys under ``clip_encoder.``) ->
    the ``clip_encoder`` subtree; without ``visual.`` keys, text only."""
    out: Dict[str, Any] = {"text": _convert_clip_text(sd, scan_layers)}
    if "visual.conv1.weight" in sd:
        layers = _max_index([k for k in sd if k.startswith("visual.")],
                            r"resblocks\.")
        out["visual"] = {
            "conv1": {"kernel": _np(sd["visual.conv1.weight"]).transpose(2, 3, 1, 0)},
            "class_embedding": _np(sd["visual.class_embedding"]),
            "positional_embedding": _np(sd["visual.positional_embedding"]),
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "ln_post": _ln(sd, "visual.ln_post"),
            "transformer": _clip_blocks(sd, "visual.transformer", layers,
                                        scan_layers)}
    return out


def _clip_subdict(sd: Dict) -> Dict:
    return {k.removeprefix("clip_encoder."): v for k, v in sd.items()
            if k.startswith("clip_encoder.")}


def convert_bifold(sd: Dict, *, scan_layers: bool = True) -> Dict:
    """Full SigLip / SiglipSequential / RGBOnly state dict (the reference's
    names, which are the port's) -> the JAX params tree: the optionally
    peft-LoRA-wrapped SigLIP towers or the CLIP towers with ``project``,
    the learned modality tokens and position embeddings, the fusion
    transformer and the ConvDecoder heads. Layer counts, LoRA and its rank,
    and the heads are read from the keys. ``text_unet``'s keys raise (its
    BatchNorm statistics need :func:`convert_text_unet`)."""
    if any(k.startswith("encoder.") for k in sd):
        raise NotImplementedError(
            "a text_unet state dict carries BatchNorm statistics; use "
            "convert_text_unet(sd) -> (params, batch_stats)")
    out: Dict[str, Any] = {}

    # SigLIP towers (strip the peft LoraModel wrapper if present)
    tower_sd, lora_a, lora_b = {}, {}, {}
    for k, v in sd.items():
        if not k.startswith("siglip_model."):
            continue
        k = k.removeprefix("siglip_model.").removeprefix("model.")
        if ".lora_A." in k:            # ...q_proj.lora_A.<adapter>.weight
            lora_a[k.split(".lora_A.")[0]] = v
        elif ".lora_B." in k:
            lora_b[k.split(".lora_B.")[0]] = v
        else:
            tower_sd[k.replace(".base_layer.", ".")] = v
    if tower_sd:
        layers = _max_index(tower_sd, r"vision_model\.encoder\.layers\.")
        lora = bool(lora_a)
        rank = _np(next(iter(lora_a.values()))).shape[0] if lora else 8
        out["siglip_model"] = convert_siglip(
            tower_sd, layers=layers, lora=lora, lora_rank=rank,
            scan_layers=scan_layers, lora_values=(lora_a, lora_b))

    clip_sd = _clip_subdict(sd)
    if clip_sd:
        out["clip_encoder"] = _convert_clip_openai(clip_sd, scan_layers)
    if "project.weight" in sd:
        out["project"] = _linear(sd, "project")
    for name in _TOKENS:
        if name in sd:
            out[name] = _np(sd[name])

    pp: Dict[str, Any] = {}
    for name in _FUSIONS:
        if f"pick_place.{name}.token_type_embeddings.weight" in sd:
            pp[name] = _fusion_tree(sd, f"pick_place.{name}", scan_layers)
    for head in _HEADS:
        p = f"pick_place.{head}"
        if f"{p}.decoder_net.0.weight" in sd:
            pp[head] = _conv_decoder_tree(sd, p)
        elif f"{p}.decoder_embed.weight" in sd:
            pp[head] = _trans_decoder_tree(sd, p, scan_layers)
    if pp:
        out["pick_place"] = pp
    return out


# the fusions of the heads (pick_place_convdecoder's one, the transformer
# decoder's two and its optional place-on-pick conditioning) and the decoders
_FUSIONS = ("fusion", "pick_fusion", "place_fusion", "pick_place_fusion")
_HEADS = ("pick_decoder", "place_decoder", "left_pick_decoder",
          "right_pick_decoder", "left_place_decoder", "right_place_decoder",
          "mask_head")
_MOE = ("router", "w1", "b1", "w2", "b2")
_CROSS = ("query", "key", "value", "out")


def _fusion_tree(sd: Dict, prefix: str, scan_layers: bool) -> Dict:
    """A fusion's keys under ``prefix`` -> its JAX subtree: the token-type
    embeddings, then the cross-attention's DenseGeneral kernels (kept in
    their layout) or the concat stack (reference layer = [PreNorm(Attention),
    PreNorm(FeedForward)], to_out = Sequential(Linear, Dropout); an MoE FFN
    at ``1.fn.{router,w1,b1,w2,b2}``) and its registers."""
    fusion: Dict[str, Any] = {"token_type_embeddings": {
        "embedding": _np(sd[f"{prefix}.token_type_embeddings.weight"])}}
    if f"{prefix}.cross_attention.query.kernel" in sd:
        fusion["cross_attention"] = {
            proj: {leaf: _np(sd[f"{prefix}.cross_attention.{proj}.{leaf}"])
                   for leaf in ("kernel", "bias")} for proj in _CROSS}
        return fusion
    stack = f"{prefix}.transformer_encoder.layers"
    blocks = []
    for i in range(_max_index(sd, re.escape(stack) + r"\.")):
        p = f"{stack}.{i}"
        if f"{p}.1.fn.router" in sd:
            mlp = {k: _np(sd[f"{p}.1.fn.{k}"]) for k in _MOE}
        else:
            mlp = {"fc1": _linear(sd, f"{p}.1.fn.net.0"),
                   "fc2": _linear(sd, f"{p}.1.fn.net.3")}
        blocks.append({
            "norm1": _ln(sd, f"{p}.0.norm"),
            "attn": {"to_qkv": {"kernel": _np(sd[f"{p}.0.fn.to_qkv.weight"]).T},
                     "out_proj": _linear(sd, f"{p}.0.fn.to_out.0")},
            "norm2": _ln(sd, f"{p}.1.norm"),
            "mlp": mlp})
    fusion["transformer_encoder"] = _stack_blocks(blocks, scan_layers)
    if f"{prefix}.registers" in sd:
        fusion["registers"] = _np(sd[f"{prefix}.registers"])
    return fusion


def _conv_decoder_tree(sd: Dict, prefix: str) -> Dict:
    """ConvDecoder head: 1x1 convs at Sequential slots 0, 2, 4, 6, 8."""
    dec = {}
    for j, slot in enumerate((0, 2, 4, 6, 8)):
        w = _np(sd[f"{prefix}.decoder_net.{slot}.weight"])
        dec[f"conv{j}"] = {"kernel": w[:, :, 0, 0].T,  # (out, in, 1, 1) -> (in, out)
                           "bias": _np(sd[f"{prefix}.decoder_net.{slot}.bias"])}
    return dec


def _trans_decoder_tree(sd: Dict, prefix: str, scan_layers: bool) -> Dict:
    """TransformerDecoder head: ``decoder_embed``, the blocks (separate
    biased q/k/v, the JAX Transformer's ``blocks`` subtree), ``decoder_norm``
    and ``decoder_pred``."""
    stack = f"{prefix}.blocks.layers"
    blocks = []
    for i in range(_max_index(sd, re.escape(stack) + r"\.")):
        p = f"{stack}.{i}"
        blocks.append({
            "norm1": _ln(sd, f"{p}.layer_norm1"), "norm2": _ln(sd, f"{p}.layer_norm2"),
            "attn": {proj: _linear(sd, f"{p}.self_attn.{proj}")
                     for proj in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "mlp": {"fc1": _linear(sd, f"{p}.mlp.fc1"),
                    "fc2": _linear(sd, f"{p}.mlp.fc2")}})
    return {"decoder_embed": _linear(sd, f"{prefix}.decoder_embed"),
            "blocks": _stack_blocks(blocks, scan_layers),
            "decoder_norm": _ln(sd, f"{prefix}.decoder_norm"),
            "decoder_pred": _linear(sd, f"{prefix}.decoder_pred")}


_TOKENS = ("text_token", "image_token", "context_pos_embedding",
           "rgb_pos_embedding", "text_pos_embedding")


def _arr(x):
    """A leaf as an array: torch tensors (bfloat16 leaves) stay tensors."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _perm(x, axes):
    """``x`` with its axes permuted, numpy array or tensor."""
    x = _arr(x)
    return x.permute(*axes) if isinstance(x, torch.Tensor) else x.transpose(axes)


def _cat(parts):
    """Concatenate along axis 0: tensors if any part is one."""
    parts = [_arr(p) for p in parts]
    if any(isinstance(p, torch.Tensor) for p in parts):
        return torch.cat([torch.as_tensor(p) for p in parts])
    return np.concatenate(parts, axis=0)


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return _arr(tree)[i]


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _unstack_blocks(enc: Dict) -> list:
    """Encoder subtree -> per-layer dicts: depth-stacked ``blocks/block``
    (nn.scan layout) or unrolled ``block_i``."""
    if "blocks" in enc:
        stacked = enc["blocks"]["block"]
        depth = int(_arr(_first_leaf(stacked)).shape[0])
        return [_index_tree(stacked, i) for i in range(depth)]
    keys = sorted((k for k in enc if k.startswith("block_")),
                  key=lambda s: int(s.split("_")[1]))
    return [enc[k] for k in keys]


def _inv_linear(out: Dict, prefix: str, dense: Dict) -> None:
    out[prefix + ".weight"] = _arr(dense["kernel"]).T
    if "bias" in dense:
        out[prefix + ".bias"] = _arr(dense["bias"])


def _inv_ln(out: Dict, prefix: str, ln: Dict) -> None:
    out[prefix + ".weight"] = _arr(ln["scale"])
    out[prefix + ".bias"] = _arr(ln["bias"])


_ADAPTER = "siglip_adapter"  # the reference's peft adapter name


def _inv_clip_blocks(out: Dict, prefix: str, enc: Dict) -> None:
    """The JAX Transformer subtree -> OpenAI residual blocks, q/k/v
    re-concatenated into the fused in-projection."""
    for i, blk in enumerate(_unstack_blocks(enc)):
        p = f"{prefix}.resblocks.{i}"
        _inv_ln(out, f"{p}.ln_1", blk["norm1"])
        _inv_ln(out, f"{p}.ln_2", blk["norm2"])
        a = blk["attn"]
        qkv = ("q_proj", "k_proj", "v_proj")
        out[f"{p}.attn.in_proj_weight"] = _cat([_arr(a[pr]["kernel"]).T for pr in qkv])
        out[f"{p}.attn.in_proj_bias"] = _cat([a[pr]["bias"] for pr in qkv])
        _inv_linear(out, f"{p}.attn.out_proj", a["out_proj"])
        _inv_linear(out, f"{p}.mlp.c_fc", blk["mlp"]["fc1"])
        _inv_linear(out, f"{p}.mlp.c_proj", blk["mlp"]["fc2"])


def _inv_clip(out: Dict, root: str, tree: Dict) -> None:
    """``clip_encoder`` subtree -> OpenAI names under ``root`` (the vision
    tower only when the tree has one)."""
    txt = tree["text"]
    out[root + "token_embedding.weight"] = _arr(txt["token_embedding"]["embedding"])
    out[root + "positional_embedding"] = _arr(txt["positional_embedding"])
    _inv_ln(out, root + "ln_final", txt["ln_final"])
    if "text_projection" in txt:
        out[root + "text_projection"] = _arr(txt["text_projection"])
    _inv_clip_blocks(out, root + "transformer", txt["transformer"])
    vis = tree.get("visual")
    if vis is not None:
        out[root + "visual.conv1.weight"] = _perm(vis["conv1"]["kernel"], (3, 2, 0, 1))
        out[root + "visual.class_embedding"] = _arr(vis["class_embedding"])
        out[root + "visual.positional_embedding"] = _arr(vis["positional_embedding"])
        _inv_ln(out, root + "visual.ln_pre", vis["ln_pre"])
        _inv_ln(out, root + "visual.ln_post", vis["ln_post"])
        _inv_clip_blocks(out, root + "visual.transformer", vis["transformer"])


def convert_bifold_inverse(params: Dict) -> Dict[str, Any]:
    """SigLip / SiglipSequential / RGBOnly params tree -> reference
    state-dict names. ``text_unet``'s params raise (use
    :func:`convert_text_unet_inverse` with its BatchNorm statistics)."""
    params = dict(params)
    if any(k.startswith("enc0_") for k in params):
        raise NotImplementedError(
            "text_unet params carry BatchNorm statistics; use "
            "convert_text_unet_inverse(params, batch_stats)")
    out: Dict[str, Any] = {}
    if "clip_encoder" in params:
        _inv_clip(out, "clip_encoder.", params["clip_encoder"])
    if "project" in params:
        _inv_linear(out, "project", params["project"])
    if "siglip_model" in params:
        _inv_siglip(out, params["siglip_model"])
    _inv_head(out, params)
    return out


def _inv_siglip(out: Dict, sig: Dict) -> None:
    vm, tm = sig["vision_model"], sig["text_model"]
    lora = any("base" in blk["attn"][p]
               for blk in _unstack_blocks(vm["encoder"])
               for p in ("q_proj", "v_proj"))
    root = "siglip_model.model." if lora else "siglip_model."

    out[root + "vision_model.embeddings.patch_embedding.weight"] = \
        _perm(vm["patch_embedding"]["kernel"], (3, 2, 0, 1))   # (H, W, in, out)
    out[root + "vision_model.embeddings.patch_embedding.bias"] = \
        _arr(vm["patch_embedding"]["bias"])
    out[root + "vision_model.embeddings.position_embedding.weight"] = \
        _arr(vm["position_embedding"])
    _inv_ln(out, root + "vision_model.post_layernorm", vm["post_layernorm"])
    out[root + "text_model.embeddings.token_embedding.weight"] = \
        _arr(tm["token_embedding"]["embedding"])
    out[root + "text_model.embeddings.position_embedding.weight"] = \
        _arr(tm["position_embedding"])
    _inv_ln(out, root + "text_model.final_layer_norm", tm["final_layer_norm"])

    for tower, src in (("vision_model", vm), ("text_model", tm)):
        for i, blk in enumerate(_unstack_blocks(src["encoder"])):
            p = f"{root}{tower}.encoder.layers.{i}"
            _inv_ln(out, f"{p}.layer_norm1", blk["norm1"])
            _inv_ln(out, f"{p}.layer_norm2", blk["norm2"])
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                d = blk["attn"][proj]
                kp = f"{p}.self_attn.{proj}"
                if "base" in d:       # LoRA wrap (peft semantics)
                    _inv_linear(out, kp + ".base_layer", d["base"])
                    out[f"{kp}.lora_A.{_ADAPTER}.weight"] = _arr(d["lora_a"]).T
                    out[f"{kp}.lora_B.{_ADAPTER}.weight"] = _arr(d["lora_b"]).T
                else:
                    _inv_linear(out, kp, d)
            _inv_linear(out, f"{p}.mlp.fc1", blk["mlp"]["fc1"])
            _inv_linear(out, f"{p}.mlp.fc2", blk["mlp"]["fc2"])


def _inv_head(out: Dict, params: Dict) -> None:
    """The learned tokens and position embeddings, the fusions and the
    decoder heads."""
    for name in _TOKENS:
        if name in params:
            out[name] = _arr(params[name])
    pp = params.get("pick_place")
    if pp is None:
        return
    for name in _FUSIONS:
        if name in pp:
            _inv_fusion(out, f"pick_place.{name}", pp[name])
    for head in _HEADS:
        if head not in pp:
            continue
        if "decoder_embed" in pp[head]:
            _inv_trans_decoder(out, f"pick_place.{head}", pp[head])
            continue
        for j, slot in enumerate((0, 2, 4, 6, 8)):
            conv = pp[head][f"conv{j}"]
            out[f"pick_place.{head}.decoder_net.{slot}.weight"] = \
                _arr(conv["kernel"]).T[:, :, None, None]
            out[f"pick_place.{head}.decoder_net.{slot}.bias"] = \
                _arr(conv["bias"])


def _inv_fusion(out: Dict, prefix: str, fusion: Dict) -> None:
    out[f"{prefix}.token_type_embeddings.weight"] = \
        _arr(fusion["token_type_embeddings"]["embedding"])
    if "cross_attention" in fusion:
        for proj in _CROSS:
            for leaf in ("kernel", "bias"):
                out[f"{prefix}.cross_attention.{proj}.{leaf}"] = \
                    _arr(fusion["cross_attention"][proj][leaf])
        return
    if "registers" in fusion:
        out[f"{prefix}.registers"] = _arr(fusion["registers"])
    for i, blk in enumerate(_unstack_blocks(fusion["transformer_encoder"])):
        p = f"{prefix}.transformer_encoder.layers.{i}"
        _inv_ln(out, f"{p}.0.norm", blk["norm1"])
        out[f"{p}.0.fn.to_qkv.weight"] = \
            _arr(blk["attn"]["to_qkv"]["kernel"]).T
        _inv_linear(out, f"{p}.0.fn.to_out.0", blk["attn"]["out_proj"])
        _inv_ln(out, f"{p}.1.norm", blk["norm2"])
        if "router" in blk["mlp"]:
            for k in _MOE:
                out[f"{p}.1.fn.{k}"] = _arr(blk["mlp"][k])
        else:
            _inv_linear(out, f"{p}.1.fn.net.0", blk["mlp"]["fc1"])
            _inv_linear(out, f"{p}.1.fn.net.3", blk["mlp"]["fc2"])


def _inv_trans_decoder(out: Dict, prefix: str, dec: Dict) -> None:
    _inv_linear(out, f"{prefix}.decoder_embed", dec["decoder_embed"])
    for i, blk in enumerate(_unstack_blocks(dec["blocks"])):
        p = f"{prefix}.blocks.layers.{i}"
        _inv_ln(out, f"{p}.layer_norm1", blk["norm1"])
        _inv_ln(out, f"{p}.layer_norm2", blk["norm2"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _inv_linear(out, f"{p}.self_attn.{proj}", blk["attn"][proj])
        _inv_linear(out, f"{p}.mlp.fc1", blk["mlp"]["fc1"])
        _inv_linear(out, f"{p}.mlp.fc2", blk["mlp"]["fc2"])
    _inv_ln(out, f"{prefix}.decoder_norm", dec["decoder_norm"])
    _inv_linear(out, f"{prefix}.decoder_pred", dec["decoder_pred"])


# ---------------------------------------------------------------------------
# text_unet: params and BatchNorm statistics
# ---------------------------------------------------------------------------

_UNET_HEADS = ("pick_decoder", "place_decoder", "left_pick_decoder",
               "right_pick_decoder", "left_place_decoder", "right_place_decoder")


def _conv2d(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    """torch Conv2d (out, in, kh, kw) -> flax HWIO kernel (and bias)."""
    out = {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _bn(sd: Dict, prefix: str):
    return ({"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])},
            {"mean": _np(sd[f"{prefix}.running_mean"]),
             "var": _np(sd[f"{prefix}.running_var"])})


def convert_t5(sd: Dict) -> Dict:
    """HF ``T5EncoderModel`` state dict -> the JAX ``T5Encoder``'s params:
    the token table from ``shared.weight`` (else its tied copy
    ``encoder.embed_tokens.weight``), block 0's relative-position table at
    the encoder level, ``block_<i>_{ln_attn,q,k,v,o,ln_ffn,wi | wi_0,
    wi_1,wo}`` (kernels transposed to (in, out)), ``final_layer_norm``."""
    emb = sd["shared.weight"] if "shared.weight" in sd else sd["encoder.embed_tokens.weight"]
    out: Dict[str, Any] = {
        "shared": {"embedding": _np(emb)},
        "relative_attention_bias": {"embedding": _np(
            sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"])},
        "final_layer_norm": {"scale": _np(sd["encoder.final_layer_norm.weight"])},
    }
    for i in range(_max_index(sd, r"^encoder\.block\.")):
        p = f"encoder.block.{i}."
        out[f"block_{i}_ln_attn"] = {"scale": _np(sd[p + "layer.0.layer_norm.weight"])}
        for m in "qkvo":
            out[f"block_{i}_{m}"] = {
                "kernel": _np(sd[p + f"layer.0.SelfAttention.{m}.weight"]).T}
        out[f"block_{i}_ln_ffn"] = {"scale": _np(sd[p + "layer.1.layer_norm.weight"])}
        ff = p + "layer.1.DenseReluDense."
        names = ("wi", "wo") if ff + "wi.weight" in sd else ("wi_0", "wi_1", "wo")
        for m in names:
            out[f"block_{i}_{m}"] = {"kernel": _np(sd[ff + m + ".weight"]).T}
    return out


def convert_t5_inverse(params: Dict) -> Dict[str, Any]:
    """The JAX ``T5Encoder``'s params -> HF ``T5EncoderModel`` names (the
    inverse of :func:`convert_t5`), both tied token tables included."""
    emb = _arr(params["shared"]["embedding"])
    out: Dict[str, Any] = {"shared.weight": emb, "encoder.embed_tokens.weight": emb}
    out["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = \
        _arr(params["relative_attention_bias"]["embedding"])
    out["encoder.final_layer_norm.weight"] = _arr(params["final_layer_norm"]["scale"])
    i = 0
    while f"block_{i}_q" in params:
        p = f"encoder.block.{i}."
        out[p + "layer.0.layer_norm.weight"] = _arr(params[f"block_{i}_ln_attn"]["scale"])
        for m in "qkvo":
            out[p + f"layer.0.SelfAttention.{m}.weight"] = \
                _arr(params[f"block_{i}_{m}"]["kernel"]).T
        out[p + "layer.1.layer_norm.weight"] = _arr(params[f"block_{i}_ln_ffn"]["scale"])
        ff = p + "layer.1.DenseReluDense."
        names = ("wi", "wo") if f"block_{i}_wi" in params else ("wi_0", "wi_1", "wo")
        for m in names:
            out[ff + m + ".weight"] = _arr(params[f"block_{i}_{m}"]["kernel"]).T
        i += 1
    return out


def convert_text_unet(sd: Dict, *, scan_layers: bool = True):
    """TextConditionedUNet state dict -> (params, batch_stats) of the JAX
    ``text_unet``: the CLIP text tower or the T5 encoder, the double-conv
    encoder blocks, the FiLM decoder blocks (ConvTranspose taps flipped into
    flax's forward-conv order) and the 1x1 heads; BatchNorm running
    statistics go to ``batch_stats``."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    clip_sd = _clip_subdict(sd)
    if clip_sd:
        params["clip_encoder"] = _convert_clip_openai(clip_sd, scan_layers)
    t5_sd = {k.removeprefix("text_encoder."): v for k, v in sd.items()
             if k.startswith("text_encoder.")}
    if t5_sd:
        params["text_encoder"] = convert_t5(t5_sd)
    for i in range(_max_index(sd, r"^encoder\.")):
        for j, (conv_slot, bn_slot) in enumerate(((0, 1), (3, 4))):
            params[f"enc{i}_conv{j}"] = _conv2d(sd, f"encoder.{i}.{conv_slot}")
            params[f"enc{i}_bn{j}"], stats[f"enc{i}_bn{j}"] = \
                _bn(sd, f"encoder.{i}.{bn_slot}")
    for i in range(_max_index(sd, r"^decoder\.")):
        p = f"decoder.{i}"
        w = _np(sd[f"{p}.convt.weight"]).transpose(2, 3, 0, 1)[::-1, ::-1]
        blk = {"convt": {"kernel": np.ascontiguousarray(w),
                         "bias": _np(sd[f"{p}.convt.bias"])},
               "conv1": _conv2d(sd, f"{p}.conv1"), "conv2": _conv2d(sd, f"{p}.conv2"),
               "film_conv": _conv2d(sd, f"{p}.film.conv"),
               "film_gamma": _linear(sd, f"{p}.film.gamma"),
               "film_beta": _linear(sd, f"{p}.film.beta")}
        bst = {}
        for bn in ("bn1", "bn2"):
            blk[bn], bst[bn] = _bn(sd, f"{p}.{bn}")
        params[f"dec{i}"], stats[f"dec{i}"] = blk, bst
    for head in _UNET_HEADS:
        if f"{head}.weight" in sd:
            params[head] = {"kernel": _np(sd[f"{head}.weight"])[:, :, 0, 0].T,
                            "bias": _np(sd[f"{head}.bias"])}
    return params, stats


def convert_text_unet_inverse(params: Dict, batch_stats: Dict) -> Dict[str, Any]:
    """The JAX ``text_unet``'s (params, batch_stats) -> the port's state dict
    (the reference's names, ``running_mean`` / ``running_var`` included,
    ConvTranspose taps re-flipped to torch's order)."""
    out: Dict[str, Any] = {}
    if "clip_encoder" in params:
        _inv_clip(out, "clip_encoder.", params["clip_encoder"])
    if "text_encoder" in params:
        for k, v in convert_t5_inverse(params["text_encoder"]).items():
            out["text_encoder." + k] = v

    def inv_conv(prefix: str, conv: Dict) -> None:
        out[prefix + ".weight"] = _perm(conv["kernel"], (3, 2, 0, 1))
        if "bias" in conv:
            out[prefix + ".bias"] = _arr(conv["bias"])

    def inv_bn(prefix: str, bn: Dict, stats: Dict) -> None:
        _inv_ln(out, prefix, bn)
        out[prefix + ".running_mean"] = _arr(stats["mean"])
        out[prefix + ".running_var"] = _arr(stats["var"])

    i = 0
    while f"enc{i}_conv0" in params:
        for j, (conv_slot, bn_slot) in enumerate(((0, 1), (3, 4))):
            inv_conv(f"encoder.{i}.{conv_slot}", params[f"enc{i}_conv{j}"])
            inv_bn(f"encoder.{i}.{bn_slot}", params[f"enc{i}_bn{j}"],
                   batch_stats[f"enc{i}_bn{j}"])
        i += 1
    i = 0
    while f"dec{i}" in params:
        blk, bst, p = params[f"dec{i}"], batch_stats[f"dec{i}"], f"decoder.{i}"
        k = _arr(blk["convt"]["kernel"])                 # (kh, kw, in, out)
        if isinstance(k, torch.Tensor):
            out[f"{p}.convt.weight"] = torch.flip(k, (0, 1)).permute(2, 3, 0, 1).contiguous()
        else:
            out[f"{p}.convt.weight"] = np.ascontiguousarray(
                k[::-1, ::-1].transpose(2, 3, 0, 1))
        out[f"{p}.convt.bias"] = _arr(blk["convt"]["bias"])
        inv_conv(f"{p}.conv1", blk["conv1"])
        inv_bn(f"{p}.bn1", blk["bn1"], bst["bn1"])
        inv_conv(f"{p}.conv2", blk["conv2"])
        inv_bn(f"{p}.bn2", blk["bn2"], bst["bn2"])
        inv_conv(f"{p}.film.conv", blk["film_conv"])
        _inv_linear(out, f"{p}.film.gamma", blk["film_gamma"])
        _inv_linear(out, f"{p}.film.beta", blk["film_beta"])
        i += 1
    for head in _UNET_HEADS:
        if head in params:
            out[f"{head}.weight"] = _arr(params[head]["kernel"]).T[:, :, None, None]
            out[f"{head}.bias"] = _arr(params[head]["bias"])
    return out


def _bifold_to_jax(sd: Dict):
    return convert_bifold(sd), {}


def _bifold_from_jax(params: Dict, extra_vars: Dict) -> Dict[str, Any]:
    if extra_vars:
        raise NotImplementedError(f"extra_vars {sorted(extra_vars)}: this family "
                                  "carries none")
    return convert_bifold_inverse(params)


def _unet_to_jax(sd: Dict):
    params, stats = convert_text_unet(sd)
    return params, {"batch_stats": stats}


def _unet_from_jax(params: Dict, extra_vars: Dict) -> Dict[str, Any]:
    if "batch_stats" not in extra_vars:
        raise ValueError("text_unet params without batch_stats")
    return convert_text_unet_inverse(params, extra_vars["batch_stats"])


# model family (``cfg["model"]["name"]``) -> (to JAX, from JAX)
_JAX_CONVERTERS = {"siglip": (_bifold_to_jax, _bifold_from_jax),
                   "siglip_sequential": (_bifold_to_jax, _bifold_from_jax),
                   "rgb_clip": (_bifold_to_jax, _bifold_from_jax),
                   "text_unet": (_unet_to_jax, _unet_from_jax)}


def _converters(family: str):
    if family not in _JAX_CONVERTERS:
        raise KeyError(f"no converter for model {family!r} (have "
                       f"{sorted(_JAX_CONVERTERS)})")
    return _JAX_CONVERTERS[family]


def to_jax_variables(family: str, sd: Dict):
    """A state dict of the model family ``family`` (``cfg["model"]["name"]``)
    -> (params, extra_vars) as the JAX Trainer keeps them: ``extra_vars`` is
    ``{"batch_stats": ...}`` for ``text_unet``, else empty."""
    return _converters(family)[0](sd)


def from_jax_variables(family: str, params: Dict,
                       extra_vars: Dict | None = None) -> Dict[str, Any]:
    """The inverse of :func:`to_jax_variables`."""
    return _converters(family)[1](params, extra_vars or {})


def load_state_dict(path) -> Dict[str, torch.Tensor]:
    """A checkpoint's tensors (on the CPU) by name: a Hugging Face directory
    (its ``model.safetensors.index.json`` or ``pytorch_model.bin.index.json``
    shard map, else ``model.safetensors``, else ``pytorch_model.bin``), a
    ``.safetensors`` file, or a torch pickle (``.bin``/``.pt``/``.pth``;
    a reference Trainer file's ``{"model": state_dict, ...}`` unwrapped)."""
    path = Path(path)
    if path.is_dir():
        for index in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
            if (path / index).exists():
                weight_map = json.loads((path / index).read_text())["weight_map"]
                sd: Dict[str, torch.Tensor] = {}
                for shard in sorted(set(weight_map.values())):
                    sd.update(load_state_dict(path / shard))
                return sd
        for name in ("model.safetensors", "pytorch_model.bin"):
            if (path / name).exists():
                path = path / name
                break
    if path.suffix == ".safetensors":
        return load_file(path)
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict) \
            and any("." in k for k in obj["model"]):
        obj = obj["model"]
    return obj
