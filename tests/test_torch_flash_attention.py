"""The port's flash attention (plain versions, wrapper dispatch, the autograd
Function) against the JAX package's Pallas kernels (interpret mode) and its
XLA path.

Inputs come from a numpy seed and go through both packages. Tolerances:
1e-4 on rows with at least one unmasked key (both sides accumulate in f32,
in different orders), 2e-3 on all-masked rows (their uniform average over
~300 keys sums 300 values of |v| ~ 3 before dividing). lse: 1e-4 of
max(1, |lse|) (an all-masked row's lse is -1e5 + log(nk), where one f32 ulp
is 0.0078). Gradients: 1e-4, and dv 2e-3 where all-masked rows contribute
(against autograd, which needs no lse, the -1e5-scale lse moves those rows'
recomputed 1/nk mass by up to 0.4%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu.ops.attention import dot_product_attention as jax_attention
from bifold_tpu.ops.flash_attention import _fwd_impl as jax_fwd_with_lse
from bifold_tpu.ops.flash_attention import flash_attention as jax_flash
from bifold_tpu_torch.ops import flash_attention as fa
from bifold_tpu_torch.ops.attention import dot_product_attention

NORMAL_TOL = 1e-4
DEGENERATE_TOL = 2e-3


def _inputs(seed, b=2, n=300, h=2, d=48):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3))
    mask = (rng.random((b, n)) > 0.3).astype(np.int32)
    mask[1, :] = 0                     # batch row 1: every key masked
    return q, k, v, mask


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _check(out, ref, mask):
    out, ref = np.asarray(out), np.asarray(ref)
    degenerate = mask.sum(axis=1) == 0
    np.testing.assert_allclose(out[~degenerate], ref[~degenerate], atol=NORMAL_TOL)
    np.testing.assert_allclose(out[degenerate], ref[degenerate], atol=DEGENERATE_TOL)


@pytest.mark.parametrize("d", [48, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_pallas_interpret(d, masked):
    """n=300 is ragged over the Pallas kernel's 256-row q block."""
    q, k, v, mask = _inputs(d, d=d)
    jmask = jnp.asarray(mask) if masked else None
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
                    interpret=True)
    out = fa.flash_attention_plain(_t(q), _t(k), _t(v),
                                   _t(mask) if masked else None)
    _check(out.numpy(), ref, mask if masked else np.ones_like(mask))


@pytest.mark.parametrize("d", [48, 64])
def test_plain_matches_xla_path(d):
    q, k, v, mask = _inputs(10 + d, d=d)
    ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(mask), backend="xla")
    out = fa.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask))
    _check(out.numpy(), ref, mask)


def test_all_masked_rows_average_v():
    q, k, v, mask = _inputs(3)
    out = fa.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask)).numpy()
    np.testing.assert_allclose(out[1], np.broadcast_to(v[1].mean(axis=0), out[1].shape),
                               atol=DEGENERATE_TOL)


def test_cpu_dispatch_matches_jax():
    """On the CPU, "auto" takes the math path (as JAX off the TPU does),
    "flash" the kernel's plain version; neither launches the kernel."""
    q, k, v, mask = _inputs(4, n=260, d=64)
    launches = sum(fa.LAUNCHES.values())
    ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(mask)))
    tq, tk, tv, tm = _t(q), _t(k), _t(v), _t(mask)
    auto = dot_product_attention(tq, tk, tv, tm).numpy()
    flash = dot_product_attention(tq, tk, tv, tm, backend="flash").numpy()
    _check(auto, ref, mask)
    _check(flash, ref, mask)
    assert sum(fa.LAUNCHES.values()) == launches


def test_math_path_masks_match_jax():
    """Legacy query mask, causal and return_weights stay on the math path
    and agree with the JAX XLA backend."""
    q, k, v, mask = _inputs(5, n=24, d=16)
    mask[1, :5] = 1
    tq, tk, tv, tm = _t(q), _t(k), _t(v), _t(mask)
    jq, jk, jv, jm = (jnp.asarray(x) for x in (q, k, v, mask))
    for kw in ({"legacy_query_mask": True}, {"causal": True}):
        jkw = {"legacy_query_mask": jm} if "legacy_query_mask" in kw else kw
        tkw = {"legacy_query_mask": tm} if "legacy_query_mask" in kw else kw
        ref = jax_attention(jq, jk, jv, **jkw)
        out = dot_product_attention(tq, tk, tv, **tkw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=NORMAL_TOL)
    out, probs = dot_product_attention(tq, tk, tv, tm, return_weights=True)
    ref, jprobs = jax_attention(jq, jk, jv, jm, return_weights=True)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5)
    with pytest.raises(NotImplementedError):
        dot_product_attention(tq, tk, tv, causal=True, backend="flash")


def test_env_backend_override(monkeypatch):
    q, k, v, mask = _inputs(6, n=32, d=16)
    tq, tk, tv, tm = _t(q), _t(k), _t(v), _t(mask)
    monkeypatch.setenv("BIFOLD_ATTN_BACKEND", "flash")
    flash = dot_product_attention(tq, tk, tv, tm).numpy()
    np.testing.assert_allclose(
        flash, fa.flash_attention_plain(tq, tk, tv, tm).numpy(), atol=0)
    # unsupported calls keep the math path under the override
    causal = dot_product_attention(tq, tk, tv, causal=True)
    monkeypatch.setenv("BIFOLD_ATTN_BACKEND", "math")
    np.testing.assert_allclose(
        causal.numpy(), dot_product_attention(tq, tk, tv, causal=True).numpy())


def test_wrapper_refuses_other_devices():
    """Off the CPU the wrapper launches the kernel or raises; it never
    carries on with the plain version."""
    q = torch.empty((1, 300, 2, 48), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(q, q, q)



def _lse_check(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert (np.abs(out - ref) <= NORMAL_TOL * np.maximum(1, np.abs(ref))).all()


@pytest.mark.parametrize("d", [48, 64])
def test_fwd_plain_matches_pallas_fwd_kernel(d):
    """out and lse of the plain forward against the Pallas ``_fwd_kernel``
    (``_fwd_impl``, interpret mode), with a key mask, all-masked rows and a
    ragged n=300."""
    q, k, v, mask = _inputs(20 + d, d=d)
    ref_out, ref_lse = jax_fwd_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        d ** -0.5, None, 512, True)
    out, lse = fa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), _t(mask))
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, 300)
    _check(out.numpy(), ref_out, mask)
    _lse_check(lse.numpy(), ref_lse)
    # an all-masked row: m = -1e5, l = nk
    np.testing.assert_allclose(lse[1].numpy(), -1e5 + np.log(np.float32(300)),
                               rtol=0, atol=0.008)


def _grad_inputs(seed, d):
    q, k, v, mask = _inputs(seed, d=d)
    do = np.random.default_rng(seed + 1).normal(size=q.shape).astype(np.float32)
    return q, k, v, mask, do


def _check_grads(got, ref, tol_v=DEGENERATE_TOL):
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   atol=tol_v if name == "v" else NORMAL_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("d", [48, 64])
def test_bwd_plain_matches_pallas_vjp(d):
    """dq, dk, dv of the plain backward against jax.vjp through the Pallas
    flash attention (its ``_dqkv_kernel`` in interpret mode); dq and dk
    exactly 0 on the all-masked batch row."""
    q, k, v, mask, do = _grad_inputs(30 + d, d)
    jmask = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, jmask, interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tm = _t(q), _t(k), _t(v), _t(mask)
    out, lse = fa.flash_attention_fwd_plain(tq, tk, tv, tm)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, tm, out, lse, _t(do))
    _check_grads([g.numpy() for g in got], ref, tol_v=NORMAL_TOL)
    for g in got[:2]:
        assert torch.count_nonzero(g[1]) == 0
    assert torch.count_nonzero(got[2][1]) > 0            # dv keeps 1/nk mass


@pytest.mark.parametrize("d", [48, 64])
def test_bwd_plain_matches_autograd_of_plain(d):
    q, k, v, mask, do = _grad_inputs(40 + d, d)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    tm = _t(mask)
    ref = torch.autograd.grad(fa.flash_attention_plain(*leaves, tm), leaves, _t(do))
    out, lse = fa.flash_attention_fwd_plain(*leaves, tm)
    got = fa.flash_attention_bwd_plain(*[x.detach() for x in leaves], tm,
                                       out.detach(), lse.detach(), _t(do))
    _check_grads([g.numpy() for g in got], [r.numpy() for r in ref])


def test_function_routes_grad_calls_on_the_cpu():
    """A differentiated flash call goes through the autograd Function (its
    plain forward and backward here) and a no-grad call through the
    inference path; both match the plain versions and launch no kernel."""
    q, k, v, mask, do = _grad_inputs(50, 48)
    tm, tdo = _t(mask), _t(do)
    launches = sum(fa.LAUNCHES.values())
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = dot_product_attention(*leaves, tm, backend="flash")
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, tdo)
    p_out, p_lse = fa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), tm)
    ref = fa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), tm, p_out, p_lse, tdo)
    torch.testing.assert_close(out.detach(), p_out, rtol=0, atol=0)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    with torch.no_grad():
        plain = dot_product_attention(*leaves, tm, backend="flash")
    assert plain.grad_fn is None
    torch.testing.assert_close(plain, p_out, rtol=0, atol=0)
    assert sum(fa.LAUNCHES.values()) == launches


def test_train_wrappers_refuse_other_devices():
    q = torch.empty((1, 300, 2, 48), device="meta")
    lse = torch.empty((1, 2, 300), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_bwd(q, q, q, None, q, lse, q)


# ---------------------------------------------------------------------------
# The bf16 kernels' rounding points, emulated
# ---------------------------------------------------------------------------

CHIP_BF16_TOL = 2.0 ** -6     # chip_smoke.py:within, times max(1, |plain|)


def _bf16_kernels_emulated(q, k, v, mask, do):
    """The arithmetic of the bf16 tensor-core kernels (csrc/flash_fwd.cu,
    csrc/flash_bwd.cu) in plain torch: bf16 operands, f32 products, the
    scale applied to q.k^T after the product, P rounded to bf16 before P.V
    and P^T.dO, dS rounded to bf16 before dS.K and dS^T.Q, f32 sums, l and
    lse from the f32 P. Returns (out, lse, dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dead = (mask == 0)[:, None, None, :]
    s = (torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale).masked_fill(dead, -1e5)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), vf)
    out = (acc / l.permute(0, 2, 1)[..., None]).bfloat16()
    lse = m[..., 0] + torch.log(l)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * out.float()).sum(dim=-1).transpose(1, 2)
    ds = (p * (dp - delta[..., None]) * scale).masked_fill(dead, 0.0).bfloat16().float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dof)
    return out, lse, dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _fusion_like_mask(b):
    """[13 text | 3 x 49 context | 49 current] tokens with the last context
    frame masked: the fusion stack's key mask at a small width."""
    mask = np.ones((b, 13 + 4 * 49), np.int32)
    mask[:, 13 + 2 * 49: 13 + 3 * 49] = 0
    return mask


@pytest.mark.parametrize("d", [48, 64])
@pytest.mark.parametrize("masking", ["all-masked rows", "fusion-like"])
def test_bf16_rounding_points_within_chip_tolerance(d, masking):
    """The bf16 kernels' extra rounding points (P and dS to bf16 before their
    products, the scale after q.k^T) keep out, dq, dk and dv within
    chip_smoke.py's bf16 tolerance, 2^-6 * max(1, |plain|), of the plain
    versions fed the same bf16 inputs, and lse within 1e-4 * max(1, |plain|);
    dq and dk stay exactly 0 on an all-masked row. n = 300 with a random
    key mask and an all-masked batch row, or n = 209 with a fusion-like
    mask."""
    if masking == "all-masked rows":
        q, k, v, mask = _inputs(60 + d, d=d)
    else:
        mask = _fusion_like_mask(2)
        q, k, v, _ = _inputs(70 + d, n=mask.shape[1], d=d)
    do = np.random.default_rng(80 + d).normal(size=q.shape).astype(np.float32)
    tq, tk, tv, tdo = (_t(x).bfloat16() for x in (q, k, v, do))
    tm = _t(mask)
    out, lse, *grads = _bf16_kernels_emulated(tq, tk, tv, tm, tdo)
    p_out, p_lse = fa.flash_attention_fwd_plain(tq, tk, tv, tm)
    p_grads = fa.flash_attention_bwd_plain(tq, tk, tv, tm, out, lse, tdo)
    for name, got, ref in zip(("out", "dq", "dk", "dv"), [out, *grads], [p_out, *p_grads]):
        err = (got.float() - ref.float()).abs()
        assert (err <= CHIP_BF16_TOL * ref.float().abs().clamp_min(1)).all(), (
            name, float(err.max()))
    assert ((lse - p_lse).abs() <= NORMAL_TOL * p_lse.abs().clamp_min(1)).all()
    if masking == "all-masked rows":
        assert all(torch.count_nonzero(g[1]) == 0 for g in grads[:2])


# ---------------------------------------------------------------------------
# The f32 kernels' rounding points (3xTF32), emulated
# ---------------------------------------------------------------------------

CHIP_F32_TOL = 1e-4           # chip_smoke.py:F32_TOL, absolute


def _tf32(x):
    """x rounded to TF32 as the kernels' ``cvt.rna.tf32.f32`` rounds it (to
    nearest, ties away from zero, on finite values), low 13 bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _einsum_3xtf32(eq, a, b):
    """An f32 product as the kernels take it on the tensor cores: each
    operand split into hi = tf32(x) and lo = tf32(x - hi), then lo.hi +
    hi.lo + hi.hi summed in f32; lo.lo is dropped."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def _f32_kernels_emulated(q, k, v, mask, do):
    """The arithmetic of the f32 kernels (csrc/flash_fwd.cu ``flash_fwd_tf32``,
    csrc/flash_bwd.cu ``dkdv_tf32`` and ``dq_tf32``) in plain torch: every
    product 3xTF32 (:func:`_einsum_3xtf32`), P and dS split like any other
    operand, the scale applied to q.k^T after the product, masked scores
    -1e5, l and lse from the f32 P, ds 0 on masked keys, delta = rowsum(dO *
    out) in f32 as the wrapper computes it. Returns (out, lse, dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    dead = None if mask is None else (mask == 0)[:, None, None, :]
    s = _einsum_3xtf32("bqhd,bkhd->bhqk", q, k) * scale
    if dead is not None:
        s = s.masked_fill(dead, -1e5)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    out = _einsum_3xtf32("bhqk,bkhd->bqhd", p, v) / l.permute(0, 2, 1)[..., None]
    lse = m[..., 0] + torch.log(l)
    p = torch.exp(s - lse[..., None])
    dp = _einsum_3xtf32("bqhd,bkhd->bhqk", do, v)
    delta = (do * out).sum(dim=-1).transpose(1, 2)
    ds = p * (dp - delta[..., None]) * scale
    if dead is not None:
        ds = ds.masked_fill(dead, 0.0)
    dq = _einsum_3xtf32("bhqk,bkhd->bqhd", ds, k)
    dk = _einsum_3xtf32("bhqk,bqhd->bkhd", ds, q)
    dv = _einsum_3xtf32("bhqk,bqhd->bkhd", p, do)
    return out, lse, dq, dk, dv


def test_tf32_rounding_is_nearest_ties_away():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -11 - 2 ** -23, 3.0])
    np.testing.assert_array_equal(
        _tf32(x).numpy(), np.float32([1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1, 3]))


@pytest.mark.parametrize("d", [32, 48, 64])
@pytest.mark.parametrize("masking", ["unmasked", "fusion-like"])
def test_3xtf32_rounding_points_within_f32_tolerance(d, masking):
    """The f32 kernels' 3xTF32 products keep out, dq, dk and dv within a
    tenth of chip_smoke.py's f32 tolerance (1e-5 absolute) of the plain
    versions, lse within 1e-5 * max(1, |plain|), and all five within this
    file's tolerances of the JAX package's Pallas kernels in interpret mode
    (``_fwd_kernel`` for out and lse, the vjp through ``_dqkv_kernel`` for
    the gradients). n = 300 unmasked, or n = 209 with a fusion-like mask."""
    if masking == "unmasked":
        q, k, v, _ = _inputs(90 + d, d=d)
        mask = None
    else:
        mask = _fusion_like_mask(2)
        q, k, v, _ = _inputs(100 + d, n=mask.shape[1], d=d)
    do = np.random.default_rng(110 + d).normal(size=q.shape).astype(np.float32)
    tq, tk, tv, tdo = (_t(x) for x in (q, k, v, do))
    tm = None if mask is None else _t(mask)
    out, lse, *grads = _f32_kernels_emulated(tq, tk, tv, tm, tdo)
    p_out, p_lse = fa.flash_attention_fwd_plain(tq, tk, tv, tm)
    p_grads = fa.flash_attention_bwd_plain(tq, tk, tv, tm, p_out, p_lse, tdo)
    for name, got, ref in zip(("out", "dq", "dk", "dv"), [out, *grads], [p_out, *p_grads]):
        assert float((got - ref).abs().max()) <= CHIP_F32_TOL / 10, name
    assert ((lse - p_lse).abs() <= CHIP_F32_TOL / 10 * p_lse.abs().clamp_min(1)).all()
    jmask = None if mask is None else jnp.asarray(mask)
    ref_out, ref_lse = jax_fwd_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jmask, d ** -0.5, None, 512, True)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, jmask, interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _check(out.numpy(), ref_out, np.ones((2, k.shape[1]), np.int32) if mask is None else mask)
    _lse_check(lse.numpy(), ref_lse)
    _check_grads([g.numpy() for g in grads], vjp(jnp.asarray(do)), tol_v=NORMAL_TOL)
