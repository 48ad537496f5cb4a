"""The port's T5 branch of ``text_unet`` against the JAX package's, on the CPU.

Tiny T5 encoders (vocabulary 100, width 32, 2 layers of 2 heads of 16; relu
and gated-gelu FFNs) carry the same weights in both packages: initialised by
JAX and converted by the port, or written by Hugging Face's
``T5EncoderModel.save_pretrained`` and read by each package's reader.

Held:
- the encoder in f32 within 1e-4 (its outputs are O(1): N(0, 1) token
  tables), in bf16 within 2^-4 x max|JAX| (the two packages round their
  bf16 matmuls at different points inside the dot products: a few bf16
  ulps); the relative-position bucket ids exactly, for every offset up to
  +-512 at four (buckets, max distance) pairs;
- ``resolve_t5_config`` on registry names and dirs equal to JAX's, and the
  same ``ValueError`` on a null, empty, unknown or non-T5 name;
- ``SpmT5Tokenizer`` ids equal to JAX's on ``fixture_model_bytes()`` and on
  a T5-layout model (``<pad>`` 0, ``</s>`` 1), and every ``build_tokenizer``
  T5 branch equal to JAX's with an empty Hugging Face cache (the JAX
  package's AutoTokenizer attempt fails there as on a host without it);
- ``convert_t5`` / ``convert_t5_inverse`` against JAX's, the round trip
  bitwise and a strict load;
- a ``text_unet`` forward with a T5 dir as its text encoder within 1e-4
  (eval and train mode) with equal actions, and one f32 SGD train step
  within 1e-5 (loss, per-head terms, gradient norm, trainable tensors;
  batch statistics 1e-6; the encoder frozen);
- a checkpoint dir written by ``save_pretrained`` in safetensors (f32 and
  bf16) and as ``pytorch_model.bin``: the port's reader equal to JAX's
  ``load_state_dict`` name for name and bit for bit, and both Trainers
  graft it into the same encoder weights; a dir with only a
  ``config.json`` keeps the port's seeded initialisation;
- the port's safetensors writer read back by the ``safetensors`` package
  and its reader on the package's files, every dtype bitwise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu import parallel as jax_parallel
from bifold_tpu.config import Config as JaxConfig
from bifold_tpu.config import compose as jax_compose
from bifold_tpu.data import tokenizers as jax_tokenizers
from bifold_tpu.data.spm import serialize_model_proto as jax_serialize
from bifold_tpu.losses import build_loss as jax_build_loss
from bifold_tpu.models import build_model as jax_build_model
from bifold_tpu.models import decode_action as jax_decode_action
from bifold_tpu.models import trainable_mask as jax_trainable_mask
from bifold_tpu.models.backbones import t5_backbone as jt5
from bifold_tpu.models.convert import convert_t5 as jax_convert_t5
from bifold_tpu.models.convert import convert_t5_inverse as jax_convert_t5_inverse
from bifold_tpu.models.convert import convert_text_unet_inverse as jax_unet_inverse
from bifold_tpu.models.convert import load_state_dict as jax_load_state_dict
from bifold_tpu.optim import build_optimizer as jax_build_optimizer
from bifold_tpu.trainer import Trainer as JaxTrainer
from bifold_tpu_torch.config import Config, compose
from bifold_tpu_torch.data import tokenizers as port_tokenizers
from bifold_tpu_torch.data.spm import CONTROL, NORMAL, UNKNOWN, fixture_model_bytes
from bifold_tpu_torch.losses import build_loss
from bifold_tpu_torch.models import build_model, decode_action, trainable_mask
from bifold_tpu_torch.models.backbones import t5_backbone as pt5
from bifold_tpu_torch.models.convert import (convert_t5, convert_t5_inverse,
                                             convert_text_unet,
                                             convert_text_unet_inverse, load_state_dict)
from bifold_tpu_torch.optim import build_optimizer
from bifold_tpu_torch.parallel import TrainState, make_train_step
from bifold_tpu_torch.trainer import Trainer
from bifold_tpu_torch.utils.safetensors import load_file, save_file

F32_TOL = 1e-4
BF16_REL = 2.0 ** -4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
STATS_ATOL = 1e-6

TINY = dict(vocab_size=100, d_model=32, d_kv=16, d_ff=64, num_layers=2, num_heads=2,
            dropout_rate=0.0)
S, B, N = 64, 2, 77
HEADS = ("left_pick", "right_pick", "left_place", "right_place")
LOSS = {"name": "bce_gaussmap", "is_bimanual": True, "mask_pick_heatmap": False}
SGD = {"name": "sgd", "lr": 0.5, "momentum": 0.0, "nesterov": False}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads per test: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _hf_config(ff="relu", **extra):
    return {"model_type": "t5", "vocab_size": TINY["vocab_size"],
            "d_model": TINY["d_model"], "d_kv": TINY["d_kv"], "d_ff": TINY["d_ff"],
            "num_layers": TINY["num_layers"], "num_heads": TINY["num_heads"],
            "dropout_rate": 0.0, "feed_forward_proj": ff, **extra}


def _config_dir(path, ff="relu"):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(_hf_config(ff)))
    return path


def _jax_params(ff, seed=0):
    enc = jt5.T5Encoder(cfg=jt5.T5Config(**TINY, feed_forward_proj=ff))
    ids = jnp.zeros((1, N), jnp.int32)
    params = enc.init(jax.random.key(seed), ids)["params"]
    return enc, jax.tree_util.tree_map(np.asarray, params)


def _port_encoder(params, ff, dtype=torch.float32):
    enc = pt5.T5Encoder(pt5.T5Config(**TINY, feed_forward_proj=ff), dtype)
    enc.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in convert_t5_inverse(params).items()}, strict=True)
    return enc.eval()


def _ids(seed, b=B):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, N)).astype(np.int32)


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_encoder_matches_jax(ff):
    enc, params = _jax_params(ff)
    ids = _ids(1)
    want = np.asarray(enc.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = _port_encoder(params, ff)(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)

    jb = jt5.T5Encoder(cfg=jt5.T5Config(**TINY, feed_forward_proj=ff), dtype=jnp.bfloat16)
    want = np.asarray(jb.apply({"params": params}, jnp.asarray(ids)).astype(jnp.float32))
    with torch.no_grad():
        got = _port_encoder(params, ff, torch.bfloat16)(torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_REL * np.abs(want).max())


@pytest.mark.parametrize("buckets, distance", [(32, 128), (32, 64), (16, 128), (64, 256)])
def test_bucket_ids_exact(buckets, distance):
    rel = np.arange(-512, 513, dtype=np.int32)
    want = np.asarray(jt5._relative_position_bucket(
        jnp.asarray(rel), num_buckets=buckets, max_distance=distance))
    got = pt5._relative_position_bucket(torch.from_numpy(rel), num_buckets=buckets,
                                        max_distance=distance)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the (n, n) table the encoder uses: memory minus query position
    table = pt5._bucket_table(N, buckets, distance).numpy()
    pos = np.arange(N)
    np.testing.assert_array_equal(table, want[512 + pos[None, :] - pos[:, None]])


def test_resolve_t5_config_matches_jax(tmp_path):
    import dataclasses

    for name in pt5.T5_CONFIGS:
        assert dataclasses.asdict(pt5.resolve_t5_config(name)) == \
            dataclasses.asdict(jt5.resolve_t5_config(name)), name
    assert sorted(pt5.T5_CONFIGS) == sorted(jt5.T5_CONFIGS)
    gated = _config_dir(tmp_path / "gated", "gated-gelu")
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    (legacy / "config.json").write_text(json.dumps(
        {**_hf_config("relu"), "is_gated_act": True, "layer_norm_epsilon": 1e-5,
         "relative_attention_num_buckets": 16}))
    for d in (gated, legacy):
        got, want = pt5.resolve_t5_config(str(d)), jt5.resolve_t5_config(str(d))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.feed_forward_proj == "gated-gelu"
    bert = tmp_path / "bert"
    bert.mkdir()
    (bert / "config.json").write_text(json.dumps({"model_type": "bert"}))
    for bad, match in ((None, "neither a CLIP model"), ("", "neither a CLIP model"),
                       ("bert-base-uncased", "neither a CLIP model"),
                       (str(tmp_path / "missing"), "neither a CLIP model"),
                       (str(bert), "model_type")):
        with pytest.raises(ValueError, match=match) as ours:
            pt5.resolve_t5_config(bad)
        with pytest.raises(ValueError) as theirs:
            jt5.resolve_t5_config(bad)
        assert str(ours.value) == str(theirs.value)


def _t5_layout_model(serialize):
    pieces = [("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL), ("<unk>", 0.0, UNKNOWN),
              ("▁", -3.0, NORMAL)]
    pieces += [("▁" + w, -1.0, NORMAL) for w in ("fold", "the", "towel", "in", "half",
                                                  "Left", "sleeve", ",")]
    pieces += [(c, -8.0, NORMAL) for c in "abcdefghijklmnopqrstuvwxyzLS0123456789,."]
    return serialize(pieces, unk_id=2, eos_id=1, pad_id=0)


TEXTS = ("fold the towel in half", "Left sleeve, then the RIGHT one.", "",
         "fold " * 60, "été 42")


def test_spm_t5_tokenizer_ids_match_jax(tmp_path):
    from bifold_tpu_torch.data.spm import serialize_model_proto

    models = {"fixture": fixture_model_bytes(),
              "t5": _t5_layout_model(serialize_model_proto)}
    assert models["t5"] == _t5_layout_model(jax_serialize)
    for name, blob in models.items():
        ours = port_tokenizers.SpmT5Tokenizer(blob)
        theirs = jax_tokenizers.SpmT5Tokenizer(blob)
        assert (ours.pad, ours.eot, ours.vocab_size) == \
            (theirs.pad, theirs.eot, theirs.vocab_size)
        for text in TEXTS:
            got, want = ours(text), theirs(text)
            assert got.dtype == np.int32 and got.shape == (77,)
            np.testing.assert_array_equal(got, want, err_msg=f"{name}: {text!r}")
    assert (ours.pad, ours.eot) == (0, 1)
    # a local dir's spiece.model is what build_tokenizer takes
    d = _config_dir(tmp_path / "with_spm")
    (d / "spiece.model").write_bytes(models["t5"])
    tok = port_tokenizers.build_tokenizer(None, text_encoder=str(d))
    assert isinstance(tok, port_tokenizers.SpmT5Tokenizer)
    np.testing.assert_array_equal(tok(TEXTS[1]), theirs(TEXTS[1]))


def test_t5_hash_fallbacks_match_jax(tmp_path, monkeypatch):
    """Every T5 branch of build_tokenizer without a spiece.model: a local
    dir's vocabulary, a registry name's, CLIP's for any other name; JAX's
    AutoTokenizer attempt fails on an empty cache and lands on the same
    capped hash."""
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    plain = _config_dir(tmp_path / "no_spm")
    bert = tmp_path / "bert"
    bert.mkdir()
    (bert / "config.json").write_text(json.dumps({"model_type": "bert"}))
    vocab = {str(plain): TINY["vocab_size"], "t5-small": 32128,
             "google/flan-t5-base": 32128, str(bert): 49408, "not-a-t5": 49408}
    for name, size in vocab.items():
        with pytest.warns(UserWarning, match="hashing"):
            ours = port_tokenizers.build_tokenizer(None, text_encoder=name)
        with pytest.warns(UserWarning, match="hashing"):
            theirs = jax_tokenizers.build_tokenizer(name)
        assert isinstance(theirs, jax_tokenizers.HashTokenizer), name
        assert ours.vocab_size == theirs.vocab_size == size, name
        for text in TEXTS:
            np.testing.assert_array_equal(ours(text), theirs(text), err_msg=f"{name}: {text!r}")
    ids = ours("fold it, now")
    assert ids[4] == 1 and (ids[5:] == 0).all()     # punctuation kept, eos, pad 0


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_converters_match_jax_and_round_trip(ff):
    _, params = _jax_params(ff)
    state = convert_t5_inverse(params)
    want = jax_convert_t5_inverse(params)
    assert sorted(state) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(state[k], want[k], err_msg=k)
    port = _port_encoder(params, ff)
    sd = {k: v.detach() for k, v in port.state_dict().items()}
    assert sorted(sd) == sorted(state)
    assert sd["shared.weight"].data_ptr() == sd["encoder.embed_tokens.weight"].data_ptr()
    back = convert_t5(sd)
    ref = jax_convert_t5({k: v.numpy() for k, v in sd.items()})
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # bfloat16 leaves (a precast checkpoint) move as tensors
    bf = convert_t5_inverse(jax.tree_util.tree_map(
        lambda v: torch.from_numpy(np.ascontiguousarray(v)).bfloat16(), params))
    for k, v in bf.items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(v.float().numpy(),
                                      torch.from_numpy(np.ascontiguousarray(state[k]))
                                      .bfloat16().float().numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# text_unet with a T5 text encoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unet_setup(tmp_path_factory):
    t5_dir = _config_dir(tmp_path_factory.mktemp("t5") / "tiny-t5", "gated-gelu")
    cfg = {"name": "text_unet", "image_size": S, "is_bimanual": True,
           "requires_graph": False, "text_encoder": str(t5_dir), "features": [8, 16, 32],
           "threshold": 0.01}
    model = jax_build_model(cfg)
    batch = _batch(0)
    variables = jax.jit(lambda k: model.init(k, _jnp(batch), deterministic=True))(
        jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda v: (0.1 * rng.standard_normal(v.shape)).astype(np.float32),
        variables["batch_stats"])
    for tree in jax.tree_util.tree_leaves(stats, is_leaf=lambda t: "var" in t):
        tree["var"] = rng.uniform(0.5, 1.5, tree["var"].shape).astype(np.float32)
    return cfg, model, params, stats, batch


def _batch(seed):
    rng = np.random.default_rng(seed)
    batch = {"depth": (1.0 + rng.standard_normal((B, 1, S, S))).astype(np.float32),
             "instruction": _ids(seed + 7),
             "mask": (rng.random((B, 1, S, S)) > 0.4).astype(np.float32)}
    for h in HEADS:
        batch[f"{h}_heatmap"] = rng.random((B, S, S)).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _unet(cfg, params, stats):
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           convert_text_unet_inverse(params, stats).items()}, strict=True)
    return model


def test_unet_converters_match_jax(unet_setup):
    cfg, _, params, stats, _ = unet_setup
    assert "text_encoder" in params and "clip_encoder" not in params
    state = convert_text_unet_inverse(params, stats)
    want = jax_unet_inverse(params, stats)
    assert sorted(state) == sorted(want)
    assert "text_encoder.encoder.block.1.layer.1.DenseReluDense.wi_1.weight" in state
    for k in want:
        np.testing.assert_array_equal(state[k], want[k], err_msg=k)
    port_state = {k: v.detach() for k, v in _unet(cfg, params, stats).state_dict().items()}
    got_params, got_stats = convert_text_unet(port_state)
    for tree, ref in ((got_params, params), (got_stats, stats)):
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref)
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a, b)


def test_unet_forward_matches_jax(unet_setup):
    cfg, model, params, stats, batch = unet_setup
    jb, tb = _jnp(batch), _torch(batch)
    port = _unet(cfg, params, stats)
    for train in (False, True):
        if train:
            want, _ = model.apply({"params": params, "batch_stats": stats}, jb,
                                  deterministic=False, mutable=["batch_stats"])
        else:
            want = model.apply({"params": params, "batch_stats": stats}, jb,
                               deterministic=True)
        with torch.no_grad():
            got = port.train(train)(tb)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=F32_TOL,
                                       err_msg=f"{k} train={train}")
    port.eval()
    with torch.no_grad():
        got = port(tb)
    want = model.apply({"params": params, "batch_stats": stats}, jb, deterministic=True)
    ja = jax_decode_action(want, jb, is_bimanual=True, threshold=0.01)
    ta = decode_action(got, tb, is_bimanual=True, threshold=port.threshold)
    for k in HEADS:
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]), err_msg=k)


def test_unet_train_step_matches_jax(unet_setup):
    cfg, model, params, stats, batch = unet_setup
    mask = jax_trainable_mask(params, lora=False)
    tx, _ = jax_build_optimizer(dict(SGD), None, max_iters=10, trainable=mask,
                                gradient_clip=1.0)
    step = jax_parallel.make_train_step(model, jax_build_loss(dict(LOSS)), tx,
                                        has_batch_stats=True, donate=False, trainable=mask)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    (new_params, _, extra, _), jmetrics = step(
        (jparams, tx.init(jparams), {"batch_stats": stats}, jax.random.key(0)),
        _jnp(batch))
    new_params, new_stats = jax.tree_util.tree_map(np.asarray,
                                                   (new_params, extra["batch_stats"]))

    port = _unet(cfg, params, stats)
    pmask = trainable_mask(port, lora=False)
    opt = build_optimizer(dict(SGD), [p for p in port.parameters() if p.requires_grad],
                          max_iters=10, gradient_clip=1.0)
    _, metrics = make_train_step(port, build_loss(dict(LOSS)), opt)(
        TrainState.create(opt), _torch(batch))
    for k in ("loss", "grad_norm") + HEADS:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    assert not any(pmask[n] for n in pmask if n.startswith("text_encoder."))
    old = convert_text_unet_inverse(params, stats)
    new = jax_unet_inverse(new_params, new_stats)
    state = port.state_dict()
    for n, trained in pmask.items():
        if trained:
            np.testing.assert_allclose(state[n].numpy(), new[n], atol=PARAM_ATOL, err_msg=n)
        else:
            np.testing.assert_array_equal(state[n].numpy(), old[n], err_msg=n)
    for n in new:
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[n].numpy(), new[n], atol=STATS_ATOL, err_msg=n)


# ---------------------------------------------------------------------------
# checkpoint dirs written by Hugging Face, and the Trainers' graft
# ---------------------------------------------------------------------------

def _save_hf(d, kind, seed=3):
    transformers = pytest.importorskip("transformers")
    hf = transformers.T5Config(**{k: v for k, v in _hf_config("gated-gelu").items()
                                  if k != "model_type"})
    torch.manual_seed(seed)
    enc = transformers.T5EncoderModel(hf).eval()
    if kind == "bf16":
        enc = enc.to(torch.bfloat16)
    enc.save_pretrained(str(d), safe_serialization=kind != "bin")
    return {k: v.detach().clone() for k, v in enc.state_dict().items()}


def _trainer_overrides(run_dir, t5_dir):
    return ["train_dataset=synthetic", "test_dataset=null", "model=text_unet",
            "train_dataset.n_samples=4", "train_dataset.image_size=32",
            "model.image_size=32", f"model.text_encoder={t5_dir}",
            "model.features=[4,8]", "epochs=1", "eval_epochs=1", "batch_size=2",
            "test_batch_size=2", "simulator=null", f"run_dir={run_dir}"]


@pytest.mark.parametrize("kind", ["f32", "bf16", "bin"])
def test_hf_dir_read_and_grafted_as_jax(tmp_path, kind):
    d = tmp_path / f"t5_{kind}"
    written = _save_hf(d, kind)
    files = sorted(p.name for p in d.iterdir())
    assert files == ["config.json", "pytorch_model.bin" if kind == "bin"
                     else "model.safetensors"]
    ours, theirs = load_state_dict(d), jax_load_state_dict(d)
    assert sorted(ours) == sorted(theirs)
    for k, v in ours.items():
        ref = theirs[k]
        ref = ref.numpy() if isinstance(ref, torch.Tensor) and ref.dtype != torch.bfloat16 \
            else np.asarray(ref)
        assert v.dtype == (torch.bfloat16 if kind == "bf16" else torch.float32), k
        got = v.view(torch.int16).numpy() if kind == "bf16" else v.numpy()
        want = ref.view(np.int16) if kind == "bf16" else ref
        np.testing.assert_array_equal(got, want, err_msg=k)
        np.testing.assert_array_equal(v.float().numpy(), written[k].float().numpy(),
                                      err_msg=k)

    port = Trainer(Config(compose(_trainer_overrides(tmp_path / "port", d)
                                  + ["use_cpu=true"])), run_dir=tmp_path / "port")
    jt = JaxTrainer(JaxConfig(jax_compose(_trainer_overrides(tmp_path / "jax", d))),
                    run_dir=tmp_path / "jax")
    grafted = {k: v.detach() for k, v in port.model.text_encoder.state_dict().items()}
    jax_grafted = jax_convert_t5_inverse(jax.tree_util.tree_map(
        np.asarray, jt.params["text_encoder"]))
    assert sorted(grafted) == sorted(jax_grafted)
    for k, v in grafted.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jax_grafted[k], np.float32),
                                      err_msg=k)
        np.testing.assert_array_equal(v.numpy(), written[
            k if k in written else "shared.weight"].float().numpy(), err_msg=k)


def test_config_only_dir_keeps_the_seeded_init_and_trains(tmp_path):
    d = _config_dir(tmp_path / "cfg_only", "relu")
    overrides = _trainer_overrides(tmp_path / "run", d) + ["use_cpu=true"]
    a = Trainer(Config(compose(overrides)), run_dir=tmp_path / "run")
    b = Trainer(Config(compose(overrides)), run_dir=tmp_path / "run2")
    for (n, x), (_, y) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(x, y), n
    emb = a.model.text_encoder.shared.weight
    assert 0.8 < float(emb.detach().std()) < 1.2            # JAX's N(0, 1) token table
    a.prepare_train()
    assert not any(p.requires_grad for p in a.model.text_encoder.parameters())
    frozen = {n: p.detach().clone() for n, p in a.model.text_encoder.named_parameters()}
    a.train()
    assert np.isfinite(a.eval_epoch_pixel()[1]["kp_mse"])
    for n, p in a.model.text_encoder.named_parameters():
        assert torch.equal(p, frozen[n]), n


def test_safetensors_format_both_ways(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    gen = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=gen),
               "bf16": torch.randn(7, generator=gen).bfloat16(),
               "f16": torch.randn(2, 2, generator=gen).half(),
               "f64": torch.randn(4, generator=gen).double(),
               "i64": torch.arange(6).reshape(2, 3), "i32": torch.arange(5, dtype=torch.int32),
               "u8": torch.arange(9, dtype=torch.uint8), "b": torch.tensor([True, False]),
               "empty": torch.zeros(0, 4), "scalar": torch.tensor(2.5),
               "view": torch.randn(4, 6, generator=gen)[:, ::2]}
    save_file(tensors, tmp_path / "ours.safetensors", {"format": "pt"})
    for name, read in (("ours", st.load_file), ("theirs", load_file)):
        if name == "theirs":
            st.save_file({k: v.contiguous() for k, v in tensors.items()},
                         str(tmp_path / "theirs.safetensors"))
        got = read(str(tmp_path / f"{name}.safetensors"))
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, (name, k)
            assert torch.equal(got[k], v), (name, k)
    (tmp_path / "short.safetensors").write_bytes(b"\x10\x00")
    with pytest.raises(ValueError, match="not a safetensors file"):
        load_file(tmp_path / "short.safetensors")


# ---------------------------------------------------------------------------
# int8 serving: the same tensors quantized as JAX's rule picks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_size", [4096, 1024])
def test_int8_decisions_match_jax(unet_setup, min_size):
    """T5's token and relative-position tables are gathered, never a matmul
    operand: JAX keeps them float (its ``embedding`` leaves), and so must
    the port, under both of the tied token table's names."""
    from bifold_tpu.serving import quantize_weights as jax_quantize
    from test_torch_rgb_clip import check_int8_decisions

    cfg, _, params, stats, _ = unet_setup
    qtree = jax_quantize({"params": params}, min_size=min_size)["params"]
    port = _unet(cfg, params, stats)
    state = convert_text_unet_inverse(params, stats)
    weights = {n: torch.from_numpy(np.array(state[n])) for n, _ in port.named_parameters()}
    _, want = check_int8_decisions(weights, qtree,
                                   lambda tree: convert_text_unet_inverse(tree, stats),
                                   min_size)
    assert ("text_encoder.encoder.block.0.layer.0.SelfAttention.q.weight" in want) == \
        (min_size <= 1024)                                            # 32 x 32
    assert "text_encoder.shared.weight" not in want                   # 100 x 32
    assert "text_encoder.encoder.block.0.layer.0.SelfAttention.relative_attention_bias" \
        ".weight" not in want


def test_int8_decisions_at_full_size():
    """text_unet at its shipped size with T5-base: the decisions JAX's rule
    makes, from shapes alone."""
    from bifold_tpu.serving import quantize_weights as jax_quantize
    from test_torch_rgb_clip import check_int8_decisions

    full = {"name": "text_unet", "image_size": 384, "is_bimanual": True,
            "requires_graph": False, "text_encoder": "t5-base",
            "features": [64, 128, 256, 512, 1024], "threshold": 0.01}
    jmodel = jax_build_model(full)
    sample = {"depth": jax.ShapeDtypeStruct((1, 1, 384, 384), jnp.float32),
              "instruction": jax.ShapeDtypeStruct((1, 77), jnp.int32)}
    shapes = jax.eval_shape(lambda s: jmodel.init(jax.random.key(0), s), sample)
    qtree = jax.eval_shape(lambda p: jax_quantize({"params": p})["params"],
                           shapes["params"])
    with torch.device("meta"):
        port = build_model.__globals__["MODELS"]["text_unet"](
            384, True, text_encoder="t5-base", features=(64, 128, 256, 512, 1024))
    stats = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                   shapes["batch_stats"])
    _, want = check_int8_decisions({n: p.detach() for n, p in port.named_parameters()},
                                   qtree, lambda tree: convert_text_unet_inverse(tree, stats),
                                   2 ** 16)
    assert "text_encoder.encoder.block.11.layer.1.DenseReluDense.wo.weight" in want
    assert "text_encoder.shared.weight" not in want


def test_checkpoint_served_as_jax_and_in_int8(unet_setup, tmp_path):
    """A JAX ``save_checkpoint`` of the T5 text_unet served by the port's
    ``from_checkpoint`` as JAX's ``ServingModel`` serves the same weights
    (the T5 dir's capped hash tokenizes in both), and the port's int8
    server runs on it with the tables kept float."""
    from bifold_tpu.data.processor import Processor as JaxProcessor
    from bifold_tpu.serving import ServingModel as JaxServingModel
    from bifold_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from bifold_tpu_torch.serving import QUANT_TAG, ServingModel, _served_weights
    from test_torch_rgb_clip import PROC_CFG, observation

    cfg_model, model, params, stats, _ = unet_setup
    path = tmp_path / "last.ckpt"
    jax_save_checkpoint(path, params=params, opt_state=None,
                        extra_vars={"batch_stats": stats}, epoch=1)
    cfg = {"model": cfg_model,
           "processor": dict(PROC_CFG, text_encoder=cfg_model["text_encoder"]),
           "precision": {"compute_dtype": "float32"}}
    with pytest.warns(UserWarning, match="hashing"):
        ours = ServingModel.from_checkpoint(path, cfg, device="cpu")
    with pytest.warns(UserWarning, match="hashing"):
        theirs = JaxServingModel(model, {"params": params, "batch_stats": stats},
                                 JaxProcessor(cfg["processor"], partition="test"),
                                 threshold=0.01)
    obs = dict(observation(np.random.default_rng(4)), instruction="fold the towel in half")
    (ja, jr), (ta, tr) = (srv.predict(**obs, return_raw_output=True)
                          for srv in (theirs, ours))
    for k in tr:
        np.testing.assert_allclose(tr[k], np.asarray(jr[k]), atol=F32_TOL, err_msg=k)
    for f in HEADS:
        np.testing.assert_array_equal(getattr(ta, f), np.asarray(getattr(ja, f)), err_msg=f)
    int8 = ServingModel(ours.model, None, ours.processor, device="cpu", quantize="int8",
                        quantize_min_size=1024)
    served = _served_weights(int8.model)
    assert isinstance(served["text_encoder.encoder.block.1.layer.1.DenseReluDense.wo.weight"],
                      dict)
    assert not isinstance(served["text_encoder.shared.weight"], dict)
    qa, qr = int8.predict(**obs, return_raw_output=True)
    assert all(np.isfinite(v).all() for v in qr.values())
    assert QUANT_TAG in served["text_encoder.encoder.block.0.layer.0.SelfAttention.q.weight"]
