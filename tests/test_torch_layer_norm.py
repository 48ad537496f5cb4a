"""The port's LayerNorm kernels' plain versions, their autograd Functions and
the ``BIFOLD_LN_KERNEL`` routing against the JAX package, on the CPU.

The JAX side runs its Pallas LayerNorm kernels in interpret mode
(``BIFOLD_LN_INTERPRET=1``); the port's wrappers take their plain versions
for CPU tensors. Both packages read ``BIFOLD_LN_KERNEL``, so each test sets
the mode before every call.

Tolerances: float32 outputs and stats within 1e-5 (both sides sum in f32
in other orders); float32 dx within 1e-5 · max(1, rstd) of its row (dx is
rstd times a difference of O(1) terms, so its rounding error scales with
rstd, which is 1/sqrt(eps) = 1000 on a constant row); dscale and dbias,
sums over every row, within 1e-4;
bf16 outputs within one bf16 ulp (both round an f32 value once, and the f32
values may differ in their last bits); s bitwise. The tiny SiglipSequential
(fusion dim 128, so that every norm, the fusion stack's included, takes the
kernels in both packages) serves within the 1e-4 of
``test_torch_serving.py`` with equal actions, and one f32 train step agrees
within the 1e-5 of ``test_torch_training.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu import parallel as jax_parallel
from bifold_tpu.data.processor import Processor as JaxProcessor
from bifold_tpu.data.spm import fixture_model_bytes
from bifold_tpu.losses import build_loss as jax_build_loss
from bifold_tpu.models import build_model as jax_build_model
from bifold_tpu.models import trainable_mask as jax_trainable_mask
from bifold_tpu.ops import layer_norm as jln
from bifold_tpu.optim import build_optimizer as jax_build_optimizer
from bifold_tpu.serving import ServingModel as JaxServingModel
from bifold_tpu_torch.data.processor import Processor
from bifold_tpu_torch.losses import build_loss
from bifold_tpu_torch.models import build_model, trainable_mask
from bifold_tpu_torch.models.convert import convert_bifold_inverse
from bifold_tpu_torch.models.layers import LayerNorm, Transformer
from bifold_tpu_torch.ops import layer_norm as tln
from bifold_tpu_torch.optim import build_optimizer
from bifold_tpu_torch.parallel import TrainState, make_train_step
from bifold_tpu_torch.serving import ServingModel

F32_TOL = 1e-5
PARAM_TOL = 1e-4
SERVE_TOL = 1e-4
TRAIN_RTOL = 1e-5
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


@pytest.fixture()
def mode(monkeypatch):
    """Set ``BIFOLD_LN_KERNEL`` for both packages (the JAX kernels run in
    interpret mode)."""
    monkeypatch.setenv("BIFOLD_LN_INTERPRET", "1")

    def set_mode(value):
        monkeypatch.setenv("BIFOLD_LN_KERNEL", value)

    return set_mode


def _inputs(shape, seed=0):
    """x, delta, dy, ds_out (f32 numpy) and scale, bias. Row 1 of x is the
    constant 1.25 and row 2 of x + delta the constant 1.25 (x 1.0, delta
    0.25): sums exact in any order, variance exactly 0."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    delta, dy, ds_out = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    fx, fd = x.reshape(-1, c), delta.reshape(-1, c)
    fx[1], fd[1] = 1.25, 0.0
    fx[2], fd[2] = 1.0, 0.25
    scale = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)
    return x, delta, dy, ds_out, scale, bias


def _both(arr, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    _, jdt, tdt = DTYPES[dtype]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


def _f32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.array(a.astype(jnp.float32)))


def _close(port, ref, what, dtype, rstd=None):
    p, r = _f32(port), _f32(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    if what == "s":
        np.testing.assert_array_equal(p, r, err_msg=what)
    elif what in ("dscale", "dbias"):
        np.testing.assert_allclose(p, r, rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=what)
    elif dtype == "bfloat16" and what not in ("mean", "rstd"):
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
        assert (np.abs(p - r) <= ulp).all(), (what, float(np.abs(p - r).max()))
    elif what == "dx":
        tol = F32_TOL * (np.maximum(1.0, _f32(rstd)) + np.abs(r))
        assert (np.abs(p - r) <= tol).all(), (what, float(np.abs(p - r).max()))
    else:
        np.testing.assert_allclose(p, r, rtol=F32_TOL, atol=F32_TOL, err_msg=what)


SHAPES = [((3, 300, 256), 1e-6), ((2, 5, 128), 1e-5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,eps", SHAPES)
@pytest.mark.parametrize("fused", [False, True], ids=["ln", "fused_ln"])
def test_plain_versions_match_jax_kernels(mode, fused, shape, eps, dtype):
    """Forward and backward plain versions against the Pallas kernels; the
    backward of both sides takes the JAX forward's s and stats."""
    mode("pallas")
    x, delta, dy, ds_out, scale, bias = _inputs(shape)
    (jx, tx), (jd, td), (jdy, tdy), (jds, tds) = (
        _both(a, dtype) for a in (x, delta, dy, ds_out))
    js, ts = jnp.asarray(scale), torch.from_numpy(scale)
    jb, tb = jnp.asarray(bias), torch.from_numpy(bias)
    if fused:
        ref = jln.fused_ln_forward(jx, jd, js, jb, eps)
        got = tln.fused_ln_forward_plain(tx, td, ts, tb, eps)
        names = ("s", "out", "mean", "rstd")
    else:
        ref = jln.ln_forward(jx, js, jb, eps)
        got = tln.ln_forward_plain(tx, ts, tb, eps)
        names = ("out", "mean", "rstd")
    for what, p, r in zip(names, got, ref):
        assert p.dtype == (torch.float32 if what in ("mean", "rstd") else tx.dtype)
        _close(p, r, what, dtype)
    mean, rstd = ref[-2:]
    tmean, trstd = torch.from_numpy(np.array(mean)), torch.from_numpy(np.array(rstd))
    if fused:
        saved, tsaved = ref[0], torch.from_numpy(_f32(ref[0])).to(tx.dtype)
        ref = jln.fused_ln_backward(saved, jdy, jds, mean, rstd, js)
        got = tln.fused_ln_backward_plain(tsaved, tdy, tds, tmean, trstd, ts)
    else:
        ref = jln.ln_backward(jx, jdy, mean, rstd, js)
        got = tln.ln_backward_plain(tx, tdy, tmean, trstd, ts)
    assert got[0].dtype == tx.dtype and got[1].shape == (shape[-1],)
    for what, p, r in zip(("dx", "dscale", "dbias"), got, ref):
        _close(p, r, what, dtype, rstd)


def _module(dim, eps, seed):
    ln = LayerNorm(dim, eps)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(1 + 0.1 * rng.normal(size=dim)))
        ln.bias.copy_(torch.from_numpy(0.1 * rng.normal(size=dim)))
    return ln


@pytest.mark.parametrize("fused", [False, True], ids=["ln", "fused_ln"])
def test_autograd_functions_match_default_layer_norm(mode, fused):
    """``_LayerNormFn`` (pallas) and ``_FusedAddLayerNormFn`` (fused): the
    outputs and the gradients of x (and delta), scale and bias equal
    autograd through the default-mode LayerNorm; the kernel wrappers ran."""
    x, delta, wy, ws = (torch.from_numpy(a) for a in _inputs((2, 9, 256), 1)[:4])
    ln = _module(256, 1e-5, 2)
    leaves = [x.clone().requires_grad_(), delta.clone().requires_grad_(),
              ln.weight, ln.bias]

    def run(kernel_mode):
        mode(kernel_mode)
        if fused:
            s, y = ln(leaves[0], residual=leaves[1])
            loss = (s * ws).sum() + (y * wy).sum()
        else:
            s, y = None, ln(leaves[0])
            loss = (y * wy).sum()
        used = leaves if fused else [leaves[0]] + leaves[2:]
        return y, torch.autograd.grad(loss, used)

    launches = {k: tln.LAUNCHES[k] for k in ("ln_fwd", "fused_ln_fwd")}
    y_ref, g_ref = run("")
    y, g = run("fused" if fused else "pallas")
    assert y.grad_fn is not None and y.grad_fn.name().endswith(
        "_FusedAddLayerNormFnBackward" if fused else "_LayerNormFnBackward")
    assert {k: tln.LAUNCHES[k] for k in launches} == launches    # plain on the CPU
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("fused_qkv", [True, False], ids=["fusion", "tower"])
def test_fused_transformer_wiring_matches_default(mode, fused_qkv):
    """The (residual, pending) carry under ``fused`` is the standard
    pre-norm stack: the same output and input gradient (depth 3, dim
    128), as the JAX package's test of its own wiring holds."""
    torch.manual_seed(0)
    tf = Transformer(128, 3, 4, 256, fused_qkv=fused_qkv, ln_eps=1e-5)
    with torch.no_grad():
        for p in tf.parameters():
            p.add_(0.05 * torch.randn_like(p))
    x = torch.from_numpy(_inputs((2, 17, 128), 3)[0]).requires_grad_()
    mask = torch.ones(2, 17, dtype=torch.int32)
    mask[1, 12:] = 0

    def run(kernel_mode):
        mode(kernel_mode)
        out = tf(x, mask)
        return out, torch.autograd.grad((out * out).sum(), x)[0]

    out_ref, g_ref = run("")
    out, g = run("fused")
    torch.testing.assert_close(out, out_ref, rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(g, g_ref, rtol=1e-4, atol=1e-4)


def test_switch_defaults_off_and_routes_by_width(monkeypatch):
    monkeypatch.delenv("BIFOLD_LN_KERNEL", raising=False)
    assert tln.ln_mode() == "" and not tln.use_kernel_ln(768)
    for value, want in (("pallas", "pallas"), ("FUSED", "fused"), ("xla", ""),
                        ("1", "")):
        monkeypatch.setenv("BIFOLD_LN_KERNEL", value)
        assert tln.ln_mode() == want
    monkeypatch.setenv("BIFOLD_LN_KERNEL", "pallas")
    assert tln.use_kernel_ln(768) and tln.use_kernel_ln(128)
    assert not tln.use_kernel_ln(192)              # the decoders' width
    x = torch.zeros(2, 768, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tln.ln_forward(x, x[0], x[0], 1e-6)


def test_card_wrappers_pass_what_the_signatures_take(monkeypatch):
    """The wrappers' card-side code (checks, allocation, argument lists, the
    launch counts) driven on CPU tensors with a recording launch: each call
    passes one argument per ctypes signature entry (the stream is added by
    ``launch``), and counts one launch under its kernel's name."""
    from bifold_tpu_torch.ops import _cuda
    from bifold_tpu_torch.ops import flash_attention as fa

    launched, blocks = [], []

    def record(name, fn_name, device, *args):
        assert len(args) + 1 == len(_cuda._SIGNATURES[name][fn_name]), fn_name
        launched.append(fn_name)
        if fn_name.endswith("ln_bwd"):     # rows, cols, blocks, dtype, pdtype
            blocks.append(args[-3])

    def query(name, fn_name, device, *args):   # 132 SMs, 4 blocks of 4 warps
        assert len(args) == len(_cuda._SIGNATURES[name][fn_name]), fn_name
        assert fn_name == "bifold_ln_bwd_occupancy"
        for ref, value in zip(args[-3:], (4, 132, 4)):
            ref._obj.value = value

    for mod in (tln, fa):
        monkeypatch.setattr(mod, "launch", record)
        monkeypatch.setattr(mod, "on_card", lambda fn_name, x: True)
    monkeypatch.setattr(tln, "call", query)
    monkeypatch.setattr(tln, "_RESIDENT", {})
    monkeypatch.setattr(fa, "_check_cuda_inputs", lambda *args: None)
    for mod in (tln, fa):          # fresh counters: other tests read them
        monkeypatch.setattr(mod, "LAUNCHES", type(mod.LAUNCHES)())
    x, delta = torch.ones(2, 5, 256), torch.ones(2, 5, 256)
    scale, bias = torch.ones(256), torch.zeros(256)
    out, mean, rstd = tln.ln_forward(x, scale, bias, 1e-6)
    s, _, f_mean, f_rstd = tln.fused_ln_forward(x, delta, scale, bias, 1e-6)
    dx, dscale, _ = tln.ln_backward(x, delta, mean, rstd, scale)
    tln.fused_ln_backward(s, delta, x, f_mean, f_rstd, scale)
    assert out.shape == x.shape and mean.shape == (2, 5, 1) and dscale.shape == (256,)
    q = torch.ones(1, 300, 2, 48)
    o, lse = fa.flash_attention_fwd(q, q, q)
    fa.flash_attention(q, q, q)
    fa.flash_attention_bwd(q, q, q, None, o, torch.zeros(1, 2, 300), q)
    assert launched == ["bifold_ln_fwd", "bifold_fused_ln_fwd", "bifold_ln_bwd",
                        "bifold_fused_ln_bwd", "bifold_flash_fwd_lse",
                        "bifold_flash_fwd_infer", "bifold_flash_bwd"]
    assert dict(tln.LAUNCHES) == dict.fromkeys(
        ("ln_fwd", "fused_ln_fwd", "ln_bwd", "fused_ln_bwd"), 1)
    assert dict(fa.LAUNCHES) == {"fwd_lse_d48_f32": 1, "fwd_infer_d48_f32": 1,
                                 "bwd_d48_f32": 1}
    assert blocks == [3, 3]                  # 10 rows, a warp each, 4 per block
    assert list(tln._RESIDENT.values()) == [(132, 4, 4)] * 2
    with pytest.raises(ValueError, match="multiple of 128"):
        tln.ln_forward(torch.ones(2, 192), torch.ones(192), torch.zeros(192), 1e-6)
    with pytest.raises(ValueError, match="differ"):
        tln.fused_ln_forward(x, delta.to(torch.bfloat16), scale, bias, 1e-6)


@pytest.mark.parametrize("sms,per_sm,warps,rows,want", [
    (132, 3, 4, 4746, 396),    # fused bf16 at the fusion rows: 3 rows a warp
    (132, 4, 4, 4608, 384),    # vision rows
    (132, 4, 4, 40000, 527),   # 19 rows a warp
    (132, 4, 4, 2112, 528),    # exactly one row for every warp of the card
    (132, 4, 4, 2113, 265),    # one past: two rows a warp, half the blocks
    (132, 4, 4, 300, 75),      # fewer rows than warps: one each
    (132, 4, 4, 5, 2),
    (132, 4, 4, 1, 1),
    (1, 1, 4, 9, 1),           # one block: its 4 warps take 2, 2, 2, 3 rows
    (132, 1, 12, 4746, 132),   # one block of 12 warps per SM
    (132, 2, 8, 300, 38),
])
def test_backward_grid_rule(sms, per_sm, warps, rows, want):
    """The backward's grid: resident at once, the fewest blocks that keep
    the largest number of rows per warp at the full card's, so that warps
    differ by one row at most (warp g of W takes rows [g R / W, (g + 1) R /
    W), as csrc/layer_norm.cu splits them)."""
    blocks = tln.backward_grid(sms, per_sm, warps, rows)
    assert blocks == want and 1 <= blocks <= sms * per_sm
    total = warps * blocks
    most = -(-rows // total)
    assert most == -(-rows // (warps * sms * per_sm))
    assert blocks == 1 or -(-rows // (warps * (blocks - 1))) > most
    per_warp = [(g + 1) * rows // total - g * rows // total for g in range(total)]
    assert sum(per_warp) == rows
    assert max(per_warp) == most and max(per_warp) - min(per_warp) <= 1


@pytest.mark.parametrize("args", [(0, 4, 4, 10), (132, 0, 4, 10), (132, 4, 0, 10),
                                  (132, 4, 4, 0)])
def test_backward_grid_rule_refuses_empty(args):
    with pytest.raises(ValueError, match="backward_grid"):
        tln.backward_grid(*args)


def test_backward_state_is_cached_per_device(monkeypatch):
    """The occupancy query (which also sets the instance's shared-memory
    limit) runs once per (device, kernel, dtype, width)."""
    monkeypatch.setattr(tln, "_RESIDENT", {})
    asked = []

    def query(name, fn_name, device, cols, dtype, fused, per_sm, sms, warps):
        asked.append((cols, dtype, fused))
        per_sm._obj.value, sms._obj.value, warps._obj.value = 3 + fused, 132, 4

    monkeypatch.setattr(tln, "call", query)
    cpu = torch.device("cpu")
    for _ in range(2):
        assert tln._resident(cpu, "fused_ln_bwd", 1, 768) == (132, 4, 4)
        assert tln._resident(cpu, "ln_bwd", 1, 768) == (132, 3, 4)
    assert tln._resident(cpu, "ln_bwd", 0, 768) == (132, 3, 4)
    assert asked == [(768, 1, 1), (768, 1, 0), (768, 0, 0)]
    assert tln._resident(torch.device("cpu", 1), "ln_bwd", 1, 768) == (132, 3, 4)
    assert tln._resident(cpu, "ln_bwd", 1, 1024) == (132, 3, 4)
    assert asked[3:] == [(768, 1, 0), (1024, 1, 0)]


# ---------------------------------------------------------------------------
# The tiny slice in each kernel mode against the JAX package
# ---------------------------------------------------------------------------

CFG = {"name": "siglip_sequential", "image_size": 64, "is_bimanual": True,
       "patch_size": 16, "automodel_name": "tiny", "dim": 128, "lora": True,
       "r": 8, "lora_alpha": 32, "lora_dropout": 0.0, "dropout": 0.0,
       "depth": 2, "heads": 4, "context_length": 3, "threshold": 0.01}
PROC_CFG = {"model_image_size": 64, "text_encoder": None, "sigma": 5,
            "requires_graph": False, "spatial_augment": False,
            "strategy": "gmm", "mask_depth": True, "standardize_depth": False}
LOSS = {"name": "bce_gaussmap", "is_bimanual": True, "mask_pick_heatmap": False}
SGD = {"name": "sgd", "lr": 0.5, "momentum": 0.0, "nesterov": False}
FIELDS = ("left_pick", "right_pick", "left_place", "right_place")
HEADS = FIELDS


def _batch(seed, b=2, s=64, t=3):
    rng = np.random.default_rng(seed)
    batch = {"rgb": rng.standard_normal((b, 3, s, s)).astype(np.float32),
             "instruction": rng.integers(0, 30000, (b, 64)).astype(np.int32),
             "rgb_context": rng.standard_normal((b, t, 3, s, s)).astype(np.float32),
             "context_attention_mask": np.array([[1, 1, 1], [1, 0, 0]], np.int32)}
    for h in HEADS:
        batch[f"{h}_heatmap"] = rng.random((b, s, s)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def tiny():
    """A JAX-initialised tiny model (fusion dim 128), its params with
    nonzero LoRA B, and a batch."""
    model = jax_build_model(CFG)
    batch = _batch(0)
    variables = jax.jit(lambda k: model.init(
        k, {n: jnp.asarray(v) for n, v in batch.items()},
        deterministic=True))(jax.random.key(0))
    rng = np.random.default_rng(1)

    def bump(tree):
        return {k: (0.05 * rng.normal(size=v.shape)).astype(np.float32)
                if k == "lora_b" else (bump(v) if isinstance(v, dict) else np.asarray(v))
                for k, v in tree.items()}

    return model, bump(jax.tree_util.tree_map(np.asarray, variables["params"])), batch


def _observation(rng, n_ctx, size=80):
    def frame():
        return dict(rgb=rng.integers(0, 255, (size, size, 3), dtype=np.uint8),
                    depth=rng.random((size, size)).astype(np.float32),
                    mask=(rng.random((size, size)) > 0.3).astype(np.float32))
    obs = frame()
    obs["context"] = [frame() for _ in range(n_ctx)]
    return obs


@pytest.mark.parametrize("kernel_mode", ["pallas", "fused"])
def test_predict_matches_jax_in_kernel_mode(tiny, mode, kernel_mode):
    model, params, _ = tiny
    mode(kernel_mode)
    spm = fixture_model_bytes()
    jserver = JaxServingModel(model, {"params": params}, JaxProcessor(
        PROC_CFG, partition="test", max_context_length=3,
        autoprocessor_name="tiny", spm_asset=spm), threshold=0.01)
    tserver = ServingModel(build_model(CFG, device="cpu"),
                           convert_bifold_inverse(params),
                           Processor(PROC_CFG, max_context_length=3,
                                     autoprocessor_name="tiny", spm_asset=spm),
                           device="cpu")
    calls = {}

    def counting(name):
        fn = getattr(tln, name)

        def wrapper(*args):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        return wrapper

    obs = _observation(np.random.default_rng(2), 2)
    ja, jr = jserver.predict(**obs, instruction="fold it", return_raw_output=True)
    with pytest.MonkeyPatch.context() as patch:
        for name in ("ln_forward", "fused_ln_forward", "ln_backward",
                     "fused_ln_backward"):
            patch.setattr(tln, name, counting(name))
        ta, tr = tserver.predict(**obs, instruction="fold it", return_raw_output=True)
    # 2 x 2 tower norms and 2 x 2 fusion norms in the stacks, plus
    # post_layernorm and final_layer_norm, all 128 wide
    assert calls == ({"ln_forward": 14} if kernel_mode == "pallas"
                     else {"fused_ln_forward": 12, "ln_forward": 2})
    for k in tr:
        np.testing.assert_allclose(tr[k], np.asarray(jr[k]), atol=SERVE_TOL, err_msg=k)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ta, f), np.asarray(getattr(ja, f)))


@pytest.mark.parametrize("kernel_mode", ["pallas", "fused"])
def test_train_step_matches_jax_in_kernel_mode(tiny, mode, kernel_mode):
    """One f32 step of bce_gaussmap + SGD (clip 1.0) through
    ``bifold_tpu.parallel.make_train_step`` and the port's, both in the same
    LayerNorm mode: loss, per-head terms and gradient norm within 1e-5
    relative, every updated tensor within 1e-5."""
    model, params, batch = tiny
    mode(kernel_mode)
    jmask = jax_trainable_mask(params, lora=True)
    tx, _ = jax_build_optimizer(dict(SGD), None, max_iters=10, trainable=jmask,
                                gradient_clip=1.0)
    jstep = jax_parallel.make_train_step(model, jax_build_loss(dict(LOSS)), tx,
                                         donate=False, trainable=jmask)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    (jnew, *_), jmetrics = jstep((jparams, tx.init(jparams), {}, jax.random.key(0)),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    jnew = convert_bifold_inverse(jax.tree_util.tree_map(np.asarray, jnew))

    tmodel = build_model(CFG, device="cpu")
    tmodel.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                            convert_bifold_inverse(params).items()}, strict=True)
    mask = trainable_mask(tmodel, lora=True)
    opt = build_optimizer(dict(SGD), [p for p in tmodel.parameters() if p.requires_grad],
                          max_iters=10, gradient_clip=1.0)
    step = make_train_step(tmodel, build_loss(dict(LOSS)), opt)
    _, metrics = step(TrainState.create(opt),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm") + HEADS:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=TRAIN_RTOL, err_msg=k)
    state = tmodel.state_dict()
    assert sum(mask.values()) > 0
    for k, trained in mask.items():
        if trained:
            np.testing.assert_allclose(state[k].numpy(), jnew[k], atol=TRAIN_RTOL,
                                       err_msg=k)
