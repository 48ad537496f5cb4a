"""The deployment half of the port's serving against the JAX package's, on
the CPU, with the tiny SiglipSequential of ``test_torch_serving.py``
(SigLIP "tiny" towers, 64 px, dim 64, bimanual, 3 context frames, LoRA).

- Conversion: the port's ``convert_bifold`` equals JAX's on the same state
  dict, and ``convert_bifold_inverse`` undoes it bitwise.
- int8: at ``quantize_min_size`` 4096 (and 1024, where a stacked leaf is
  quantized although one layer of it is below the size) the port quantizes
  exactly the tensors JAX quantizes, as ``convert_bifold_inverse`` maps
  them, with equal int8 payloads and scales and bitwise equal f32
  dequantized weights; its int8 server agrees with JAX's: f32 heatmaps
  within 1e-4, actions equal.
- Checkpoint: a JAX trainer checkpoint (Adam state, frozen leaves precast
  to bf16, a sibling spiece.model) serves in the port in a process where
  jax, jaxlib, flax, optax, ml_dtypes and bifold_tpu cannot be imported:
  actions equal to JAX's ``from_checkpoint`` server, heatmaps within 1e-4.
- Export: a port artifact serves bitwise what the live server serves; a
  batch-4 artifact refuses a pool of 5 and another camera size; a JAX
  artifact is refused.
- Daemon: ``/healthz``, ``/metrics``, single, pooled and ``?raw=1``
  requests with actions equal to the in-process JAX server, a 400 for a
  malformed body, coalescing of concurrent single requests, a submit after
  close raising, the batcher's compatibility keys and ``RemotePolicy``.
"""

import http.client
import io
import json
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from bifold_tpu.data.processor import Processor as JaxProcessor
from bifold_tpu.data.spm import fixture_model_bytes
from bifold_tpu.models import precast_frozen as jax_precast_frozen
from bifold_tpu.models import trainable_mask as jax_trainable_mask
from bifold_tpu.models.convert import convert_bifold as jax_convert_bifold
from bifold_tpu.models.convert import convert_bifold_inverse as jax_inverse
from bifold_tpu.serving import _QUANT_TAG as JAX_QUANT_TAG
from bifold_tpu.serving import ServingModel as JaxServingModel
from bifold_tpu.serving import dequantize_weights as jax_dequantize
from bifold_tpu.serving import quantize_weights as jax_quantize
from bifold_tpu.utils import checkpoint as jax_checkpoint_module
from bifold_tpu.utils.checkpoint import save_checkpoint
from bifold_tpu_torch.data.processor import Processor
from bifold_tpu_torch.models import build_model
from bifold_tpu_torch.models.convert import convert_bifold, convert_bifold_inverse
from bifold_tpu_torch.serve import (RemotePolicy, _DynamicBatcher, _npz_bytes,
                                    _parse_observations, build_server, make_httpd)
from bifold_tpu_torch.serving import (QUANT_TAG, ExportedServingModel, ServingModel,
                                      _served_weights, dequantize, quantize_weights,
                                      shared_scales)
from bifold_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_serving import CFG, FIELDS, INSTRUCTIONS, PROC_CFG, _jax_params, _observation

F32_TOL = 1e-4
ROOT = Path(__file__).resolve().parent.parent
TABLES = ("token_embedding.weight", "position_embedding.weight",
          "token_type_embeddings.weight", "text_token", "image_token",
          "context_pos_embedding")


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, f32 params, the port's state dict of them)."""
    model, params = _jax_params(jnp.float32)
    return model, params, convert_bifold_inverse(params)


def _procs():
    spm = fixture_model_bytes()
    return (JaxProcessor(PROC_CFG, partition="test", max_context_length=3,
                         autoprocessor_name="tiny", spm_asset=spm),
            Processor(PROC_CFG, max_context_length=3, autoprocessor_name="tiny",
                      spm_asset=spm))


@pytest.fixture(scope="module")
def servers(tiny):
    """The f32 JAX server and the port's, on the same weights."""
    jax_model, params, state = tiny
    jproc, tproc = _procs()
    return (JaxServingModel(jax_model, {"params": params}, jproc, threshold=0.01),
            ServingModel(build_model(CFG, device="cpu"), state, tproc, device="cpu"))


def _compare(jax_out, port_out):
    (ja, jr), (ta, tr) = jax_out, port_out
    for k in tr:
        np.testing.assert_allclose(tr[k], np.asarray(jr[k]), atol=F32_TOL, err_msg=k)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ta, f), np.asarray(getattr(ja, f)))


def _equal(a, b):
    (aa, ar), (ba, br) = a, b
    assert sorted(ar) == sorted(br)
    for k in ar:
        np.testing.assert_array_equal(ar[k], br[k], err_msg=k)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(aa, f), getattr(ba, f))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_layers", [True, False])
def test_convert_bifold_matches_jax_and_round_trips(tiny, scan_layers):
    _, params, state = tiny
    got = convert_bifold(state, scan_layers=scan_layers)
    want = jax_convert_bifold(state, scan_layers=scan_layers)
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, leaf in want_leaves.items():
        assert got_leaves[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got_leaves[path], leaf, err_msg="/".join(path))
    if scan_layers:              # the JAX model's own layout: its params back
        for path, leaf in _leaves(params):
            np.testing.assert_array_equal(got_leaves[path], leaf)
    back = convert_bifold_inverse(got)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_inverse_moves_bfloat16_leaves_as_tensors(tiny):
    """bf16 leaves (a checkpoint's precast towers) come out as bf16 tensors
    holding the same values, transposed and indexed as numpy leaves are."""
    _, params, state = tiny
    half = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x)).to(torch.bfloat16), params)
    got = convert_bifold_inverse(half)
    assert sorted(got) == sorted(state)
    for k, v in state.items():
        assert got[k].dtype == torch.bfloat16, k
        assert torch.equal(got[k], torch.from_numpy(np.array(v)).to(torch.bfloat16)), k


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------


def _jax_quantized(params, min_size):
    """{port name: (quantized, int8 payload, scale broadcast to the weight)}
    of JAX's quantize_weights, mapped to the port's names by JAX's
    convert_bifold_inverse (flags, payloads and scales as three trees)."""
    qtree = jax_quantize({"params": params}, min_size=min_size)["params"]

    def split(node, which):
        if isinstance(node, dict) and JAX_QUANT_TAG in node:
            q = np.asarray(node[JAX_QUANT_TAG])
            return {"flag": np.ones(q.shape, bool), "q": q,
                    "scale": np.broadcast_to(np.asarray(node["scale"]), q.shape)}[which]
        if isinstance(node, dict):
            return {k: split(v, which) for k, v in node.items()}
        x = np.asarray(node)
        return {"flag": np.zeros(x.shape, bool), "q": np.zeros(x.shape, np.int8),
                "scale": np.zeros(x.shape, np.float32)}[which]

    maps = {w: jax_inverse(split(qtree, w)) for w in ("flag", "q", "scale")}
    deq = jax_inverse(jax.tree_util.tree_map(
        np.asarray, jax_dequantize(qtree, jnp.float32)))
    return {k: (bool(maps["flag"][k].all()), maps["q"][k], maps["scale"][k], deq[k])
            for k in maps["flag"]}


@pytest.mark.parametrize("min_size", [4096, 1024, 256])
def test_quantize_weights_matches_jax(tiny, min_size):
    _, params, state = tiny
    want = _jax_quantized(params, min_size)
    got = quantize_weights({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                           min_size=min_size)
    quantized = sorted(k for k, v in got.items() if isinstance(v, dict))
    assert quantized == sorted(k for k, w in want.items() if w[0])
    assert quantized and not [k for k in quantized if k.endswith(TABLES)]
    assert [k for k in got if k.endswith("patch_embedding.weight")][0] in quantized
    for k in quantized:
        _, q, scale, deq = want[k]
        assert got[k][QUANT_TAG].dtype == torch.int8
        np.testing.assert_array_equal(got[k][QUANT_TAG].numpy(), q, err_msg=k)
        np.testing.assert_array_equal(
            np.broadcast_to(got[k]["scale"].numpy(), q.shape), scale, err_msg=k)
        np.testing.assert_array_equal(
            dequantize(got[k][QUANT_TAG], got[k]["scale"], torch.float32).numpy(), deq,
            err_msg=k)


def test_int8_of_stacked_one_dim_leaves(tiny, tmp_path):
    """At quantize_min_size 256 the stacks' biases and LayerNorm parameters
    are int8 (JAX's (depth, n) leaves), each layer against one scale the
    stack's layers share (JAX's (1, n) leaf): the server agrees with JAX's
    int8 server (heatmaps within 1e-4, actions equal) and its artifact
    serves bitwise what it serves."""
    jax_model, params, state = tiny
    jproc, tproc = _procs()
    kw = dict(quantize="int8", quantize_min_size=256)
    jserver = JaxServingModel(jax_model, {"params": params}, jproc, threshold=0.01, **kw)
    tserver = ServingModel(build_model(CFG, device="cpu"), state, tproc, device="cpu", **kw)
    weights = _served_weights(tserver.model)
    shared = shared_scales(weights)
    assert shared and all(weights[n][QUANT_TAG].dim() == 1 for n in shared)
    for name, first in shared.items():
        assert torch.equal(weights[name]["scale"], weights[first]["scale"]), name
    rng = np.random.default_rng(8)
    obs = _observation(rng, 2)
    _compare(jserver.predict(**obs, instruction="fold", return_raw_output=True),
             tserver.predict(**obs, instruction="fold", return_raw_output=True))
    art = tserver.export(tmp_path / "a.pt", **obs, instruction="fold")
    _equal(ServingModel.load_exported(art, device="cpu").predict(
        **obs, instruction="fold", return_raw_output=True),
        tserver.predict(**obs, instruction="fold", return_raw_output=True))


def test_int8_server_matches_jax(tiny):
    jax_model, params, state = tiny
    jproc, tproc = _procs()
    kw = dict(quantize="int8", quantize_min_size=4096)
    jserver = JaxServingModel(jax_model, {"params": params}, jproc, threshold=0.01, **kw)
    tserver = ServingModel(build_model(CFG, device="cpu"), state, tproc, device="cpu", **kw)
    held = {n: p.dtype for n, p in tserver.model.named_parameters()}
    assert any(d == torch.int8 for d in held.values())
    assert all(held[n] == torch.float32 for n in held if n.endswith(TABLES))
    rng = np.random.default_rng(8)
    for n_ctx, text in zip((3, 1), INSTRUCTIONS):
        obs = _observation(rng, n_ctx)
        _compare(jserver.predict(**obs, instruction=text, return_raw_output=True),
                 tserver.predict(**obs, instruction=text, return_raw_output=True))
    assert tserver.program_memory(**obs, instruction=text) is None   # CPU


# ---------------------------------------------------------------------------
# JAX checkpoints
# ---------------------------------------------------------------------------

_CHILD = """
import json, pickle, sys
for name in ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "bifold_tpu"):
    sys.modules[name] = None          # any import of these now raises
import numpy as np
from bifold_tpu_torch.serving import ServingModel
path, cfg, obs_path, out = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3], sys.argv[4]
with open(obs_path, "rb") as f:
    observations = pickle.load(f)
server = ServingModel.from_checkpoint(path, cfg, device="cpu")
result = {}
for i, obs in enumerate(observations):
    action, raw = server.predict(**obs, return_raw_output=True)
    result.update({f"{i}_{k}": v for k, v in raw.items()})
    result.update({f"{i}_{f}": getattr(action, f) for f in %r})
leaked = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "bifold_tpu")
          and sys.modules[m] is not None]
assert not leaked, leaked
np.savez(out, **result)
""" % (FIELDS,)


@pytest.fixture(scope="module")
def jax_checkpoint(tiny, tmp_path_factory):
    """A checkpoint as the JAX trainer writes it: Adam state over the
    params, frozen leaves of 4096 elements or more precast to bf16, a jax
    key, and the tokenizer model beside it; and the config."""
    _, params, _ = tiny
    mask = jax_trainable_mask(params, lora=True)
    stored = jax_precast_frozen(params, mask, jnp.bfloat16, min_size=4096)
    assert any(np.asarray(x).dtype == jnp.bfloat16
               for x in jax.tree_util.tree_leaves(stored))
    opt_state = optax.adam(1e-4).init(jax.tree_util.tree_map(jnp.asarray, params))
    root = tmp_path_factory.mktemp("run")
    path = save_checkpoint(root / "checkpoints" / "last.ckpt", params=stored,
                           opt_state=opt_state, jax_key=jax.random.key(0),
                           metadata={"model": CFG})
    (path.parent / "spiece.model").write_bytes(fixture_model_bytes())
    cfg = {"model": dict(CFG), "processor": dict(PROC_CFG)}
    (root / "config.yaml").write_text(yaml.safe_dump(cfg))
    return root, path, cfg


def restore_spm_env(monkeypatch):
    """JAX's ``load_checkpoint`` (under its ``from_checkpoint`` too) points
    ``$BIFOLD_SIGLIP_SPM`` at a checkpoint's sibling ``spiece.model`` for the
    rest of the process and marks the value its own. Have ``monkeypatch`` put
    the variable and the mark back when the test ends, so that the tests after
    it in the process tokenize as they would alone."""
    old = os.environ.get("BIFOLD_SIGLIP_SPM")
    monkeypatch.setenv("BIFOLD_SIGLIP_SPM", old or "")   # records the old state
    if old is None:
        monkeypatch.delenv("BIFOLD_SIGLIP_SPM")
    monkeypatch.setattr(jax_checkpoint_module, "_SPM_ENV_OWNED",
                        jax_checkpoint_module._SPM_ENV_OWNED)


def test_from_checkpoint_without_jax_matches_jax(jax_checkpoint, tmp_path, monkeypatch):
    _, path, cfg = jax_checkpoint
    rng = np.random.default_rng(14)
    observations = [dict(_observation(rng, n), instruction=t)
                    for n, t in zip((3, 1), INSTRUCTIONS)]
    obs_path, out = tmp_path / "obs.pkl", tmp_path / "port.npz"
    obs_path.write_bytes(pickle.dumps(observations))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(path), json.dumps(cfg),
                           str(obs_path), str(out)], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = dict(np.load(out))
    restore_spm_env(monkeypatch)
    jserver = JaxServingModel.from_checkpoint(str(path), cfg)
    for i, obs in enumerate(observations):
        action, raw = jserver.predict(**obs, return_raw_output=True)
        for k, v in raw.items():
            if v is not None:
                np.testing.assert_allclose(got[f"{i}_{k}"], np.asarray(v),
                                           atol=F32_TOL, err_msg=k)
        for f in FIELDS:
            np.testing.assert_array_equal(got[f"{i}_{f}"], np.asarray(getattr(action, f)))


def test_checkpoint_reader(jax_checkpoint, tmp_path):
    """bf16 leaves arrive as bf16 tensors, optax state as inert stand-ins,
    and any other global is refused."""
    _, path, _ = jax_checkpoint
    payload = load_checkpoint(path)
    leaves = [x for _, x in _leaves(payload["params"])]
    assert any(isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 for x in leaves)
    assert any(isinstance(x, np.ndarray) and x.dtype == np.float32 for x in leaves)
    assert type(payload["opt_state"][0]).__qualname__.startswith("optax.")
    # numpy 2.3 pickles some arrays as _frombuffer(buf, dtype, shape, "K",
    # axis_order); a reader of such a file must follow the axis order
    want = np.arange(6, dtype=np.float32).reshape(2, 3).T

    class AxisOrdered:
        def __reduce__(self):
            from numpy._core.numeric import _frombuffer
            return (_frombuffer, (np.ascontiguousarray(want.T).tobytes(),
                                  np.dtype(np.float32), (2, 3), "K", (1, 0)))

    newer = tmp_path / "newer.ckpt"
    newer.write_bytes(pickle.dumps({"params": {"w": AxisOrdered()}}, protocol=5))
    np.testing.assert_array_equal(load_checkpoint(newer)["params"]["w"], want)
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(pickle.dumps({"params": {}, "hook": threading.Thread}))
    with pytest.raises(pickle.UnpicklingError, match="threading.Thread"):
        load_checkpoint(bad)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_artifact_serves_what_the_live_server_serves(tiny, tmp_path, quantize):
    _, _, state = tiny
    _, tproc = _procs()
    live = ServingModel(build_model(CFG, dtype=torch.bfloat16, device="cpu"), state,
                        tproc, device="cpu", quantize=quantize, quantize_min_size=4096,
                        depth_wire_dtype="float16")
    rng = np.random.default_rng(9)
    obs = _observation(rng, 3)
    art = live.export(tmp_path / "a.pt", **obs, instruction="fold", batch=4)
    loaded = ServingModel.load_exported(art, device="cpu")
    assert isinstance(loaded, ExportedServingModel) and loaded.batch == 4
    assert loaded.quantize == quantize
    assert ({n: p.dtype for n, p in loaded.server.model.named_parameters()}
            == {n: p.dtype for n, p in live.model.named_parameters()})
    loaded.warmup()
    _equal(loaded.predict(**obs, instruction="fold", return_raw_output=True),
           live.predict(**obs, instruction="fold", return_raw_output=True))
    pool = [dict(_observation(rng, 3), instruction=t) for t in INSTRUCTIONS]
    _equal(loaded.predict_batch(pool, pad_to=4, return_raw_output=True),
           live.predict_batch(pool, pad_to=4, return_raw_output=True))
    with pytest.raises(ValueError, match="exceeds the exported batch"):
        loaded.predict_batch(pool, pad_to=5)
    with pytest.raises(ValueError, match="serves 1..4"):
        loaded.predict_batch(pool + pool[:2])
    other = _observation(rng, 3, size=96)
    with pytest.raises(ValueError, match="does not match"):
        loaded.predict(**other, instruction="fold")


def test_jax_artifact_is_refused(tiny, servers, tmp_path):
    jserver, _ = servers
    obs = _observation(np.random.default_rng(10), 1)
    path = jserver.export(tmp_path / "jax.bifold", **obs, instruction="fold")
    with pytest.raises(ValueError, match="JAX package"):
        ServingModel.load_exported(path, device="cpu")


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _serving(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


def test_daemon_http_matches_jax(servers):
    jserver, tserver = servers
    httpd = make_httpd(tserver)
    port = _serving(httpd)
    rng = np.random.default_rng(11)
    obs = [dict(_observation(rng, 3), instruction=t) for t in INSTRUCTIONS[:2]]
    try:
        info = _get(port, "/healthz")
        assert info["status"] == "ok" and info["fields"] == list(FIELDS)
        assert info["exported"] is False and info["quantize"] is None
        body = RemotePolicy._pack(obs[:1])
        status, data = _post(port, "/predict?raw=1", body)
        assert status == 200, data
        out = dict(np.load(io.BytesIO(data)))
        ja, jr = jserver.predict(**obs[0], return_raw_output=True)
        for f in FIELDS:
            np.testing.assert_array_equal(out[f], np.asarray(getattr(ja, f)))
        np.testing.assert_allclose(out["raw_left_pick_heatmap"],
                                   np.asarray(jr["left_pick_heatmap"]), atol=F32_TOL)
        status, data = _post(port, "/predict?pad=4", RemotePolicy._pack(obs))
        assert status == 200, data
        out = dict(np.load(io.BytesIO(data)))
        ja = jserver.predict_batch(obs, pad_to=4)
        for f in FIELDS:
            assert out[f].shape == (2, 2)
            np.testing.assert_array_equal(out[f], np.asarray(getattr(ja, f)))
        status, data = _post(port, "/predict", b"not an npz")
        assert status == 400 and b"error" in data
        assert _post(port, "/nope", body)[0] == 404
        m = _get(port, "/metrics")
        assert (m["requests"], m["observations"]) == (3, 3)
        assert (m["errors_400"], m["errors_500"]) == (1, 0)
        assert m["latency_p50_ms"] > 0
        policy = RemotePolicy(f"127.0.0.1:{port}")
        action, heat = policy(obs[1])
        assert heat is None
        direct = tserver.predict(**obs[1])
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(action, f), getattr(direct, f))
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_daemon_coalesces_concurrent_requests(servers):
    _, tserver = servers
    httpd = make_httpd(tserver, max_batch=4, batch_window_ms=150.0)
    port = _serving(httpd)
    rng = np.random.default_rng(12)
    obs = [dict(_observation(rng, 2), instruction=f"fold towel {i}") for i in range(6)]
    tserver.predict_batch(obs[:1], pad_to=4)
    results = [None] * len(obs)

    def call(i):
        status, data = _post(port, "/predict", RemotePolicy._pack(obs[i:i + 1]))
        assert status == 200, data
        results[i] = dict(np.load(io.BytesIO(data)))

    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(obs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i, o in enumerate(obs):
            direct = tserver.predict(**o)
            for f in FIELDS:
                np.testing.assert_array_equal(results[i][f], getattr(direct, f))
        assert httpd.batcher.requests == len(obs)
        assert httpd.batcher.batches < len(obs)
        assert _get(port, "/metrics")["batcher_dispatches"] == httpd.batcher.batches
    finally:
        httpd.shutdown()
        httpd.server_close()
    with pytest.raises(RuntimeError, match="shut down"):
        httpd.batcher.submit(obs[0], False)


def test_batcher_keys_and_payload_parse():
    """As tests/test_trainer.py:973-1010 holds the JAX daemon's."""
    rng = np.random.default_rng(0)
    obs = _parse_observations(_npz_bytes(dict(
        depth=rng.random((64, 64)).astype(np.float32),
        instruction=np.asarray("fold the towel"))))
    assert len(obs) == 1 and obs[0]["rgb"] is None
    assert obs[0]["depth"].shape == (64, 64)

    def mk(s):
        return dict(rgb=rng.integers(0, 255, (s, s, 3), dtype=np.uint8),
                    depth=rng.random((s, s)).astype(np.float32),
                    mask=np.ones((s, s), np.float32), instruction="x", context=None)

    k96, k96b, k128 = (_DynamicBatcher._compat_key(mk(s)) for s in (96, 96, 128))
    assert k96 == k96b and k96 != k128

    def mk_ctx(s):
        o = mk(96)
        o["context"] = [dict(depth=rng.random((s, s)).astype(np.float32))]
        return o

    assert _DynamicBatcher._compat_key(mk_ctx(96)) == _DynamicBatcher._compat_key(mk_ctx(96))
    assert _DynamicBatcher._compat_key(mk_ctx(96)) != _DynamicBatcher._compat_key(mk_ctx(64))


def test_build_server_from_run_dir_and_artifact(jax_checkpoint, tmp_path):
    """A run dir's config.yaml and checkpoints/ (best falls back to last),
    its artifact, the batch an artifact pins, and the refusals."""
    root, _, cfg = jax_checkpoint
    server = build_server(run_dir=root, which="best", depth_wire="float32", device="cpu")
    explicit = ServingModel.from_checkpoint(root / "checkpoints" / "last.ckpt", cfg,
                                            device="cpu")
    obs = _observation(np.random.default_rng(13), 2)
    _equal(server.predict(**obs, instruction="fold", return_raw_output=True),
           explicit.predict(**obs, instruction="fold", return_raw_output=True))
    art = server.export(tmp_path / "b.pt", **obs, instruction="fold", batch=2)
    exported = build_server(artifact=art, device="cpu")
    _equal(exported.predict(**obs, instruction="fold", return_raw_output=True),
           server.predict(**obs, instruction="fold", return_raw_output=True))
    with pytest.raises(ValueError, match="exceeds the artifact's pinned batch"):
        make_httpd(exported, max_batch=4)
    bf16 = ServingModel.from_checkpoint(
        root / "checkpoints" / "last.ckpt",
        {**cfg, "precision": {"compute_dtype": "bfloat16"}}, device="cpu")
    assert bf16.model.dtype == torch.bfloat16 and server.model.dtype == torch.float32
    # a mesh of two ranks in one process does not match the ranks
    # (tests/test_torch_mesh.py serves under meshes), and an artifact has
    # no sharded form
    with pytest.raises(ValueError, match="ranks"):
        build_server(run_dir=root, mesh={"dp": 2}, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        build_server(artifact=art, mesh={"dp": 1}, device="cpu")
    with pytest.raises(ValueError, match="need --artifact"):
        build_server(checkpoint=root / "checkpoints" / "last.ckpt")
