"""The port's Mixture-of-Experts FFN against the JAX package's, on the CPU.

``route`` on the same tokens and router: the dispatch and combine tensors
equal (exactly, so the same tokens are dropped once an expert is over its
capacity) at top-k 1 and 2, the Switch aux loss within 1e-6; ``moe_ffn``'s
forward and its gradients with respect to the tokens and every parameter
within 1e-5 (float32); the capacity rule; the fusion block's MoE FFN
(``MoEFeedForward``, through ``ConcatTransformer``) against flax's, with
the per-layer aux losses JAX sows; and expert parallelism on one rank
equal to the dense layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu.models.fusion import ConcatTransformer as JaxConcatTransformer
from bifold_tpu.ops import moe as jax_moe
from bifold_tpu_torch.models.convert import convert_bifold_inverse
from bifold_tpu_torch.models.fusion import ConcatTransformer
from bifold_tpu_torch.ops import moe

TOL = 1e-5
AUX_TOL = 1e-6


def _tokens(seed, t=48, d=16, e=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = (0.5 * rng.standard_normal((d, e))).astype(np.float32)
    return x, router


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity", [3, 40])
def test_route_matches_jax(top_k, capacity):
    x, router = _tokens(top_k)
    jd, jc, jaux = jax_moe.route(jnp.asarray(x), jnp.asarray(router), top_k=top_k,
                                 capacity=capacity, return_aux=True)
    td, tc, taux = moe.route(torch.from_numpy(x), torch.from_numpy(router),
                             top_k=top_k, capacity=capacity, return_aux=True)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy() > 0, np.asarray(jc) > 0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=AUX_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=AUX_TOL)
    kept = td.numpy().sum(axis=(1, 2))
    if capacity == 3:              # 48 tokens over 4 experts of 3 slots
        assert kept.sum() == 4 * 3 and (kept == 0).any()   # slots shared by the passes
    else:
        assert (kept == top_k).all()


def test_capacity_rule():
    for t, e, k, f in ((4746, 8, 1, 1.25), (17, 4, 2, 1.0), (1, 8, 1, 0.01)):
        assert moe.capacity(t, e, k, f) == jax_moe._capacity(t, e, k, f)
    assert moe.capacity(2 * 2373, 8, 1, 1.25) == 742


def _params(seed, d=16, h=32, e=4):
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in
         jax_moe.init_moe_params(jax.random.key(seed), d, h, e).items()}
    p["b1"] = (0.1 * rng.standard_normal(p["b1"].shape)).astype(np.float32)
    p["b2"] = (0.1 * rng.standard_normal(p["b2"].shape)).astype(np.float32)
    p["router"] = (10 * p["router"]).astype(np.float32)
    return p


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_jax(top_k):
    params = _params(3)
    x = np.random.default_rng(4).standard_normal((2, 20, 16)).astype(np.float32)
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jax_loss(xx, pp):
        out, aux = jax_moe.moe_ffn(xx, pp, top_k=top_k, capacity_factor=0.5,
                                   return_aux=True)
        return jnp.sum(out * cot) + 3.0 * aux, (out, aux)

    (_, (jout, jaux)), (jdx, jdp) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out, aux = moe.moe_ffn(tx, tp, top_k=top_k, capacity_factor=0.5, return_aux=True)
    (torch.sum(out * torch.from_numpy(cot)) + 3.0 * aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=AUX_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=TOL)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jdp[k]), atol=TOL,
                                   err_msg=k)
    # at this capacity some tokens are dropped: their outputs are exactly 0
    dropped = moe.route(tx.detach().reshape(-1, 16), tp["router"].detach(),
                        top_k=top_k, capacity=moe.capacity(40, 4, top_k, 0.5))[0]
    gone = dropped.sum(dim=(1, 2)) == 0
    assert gone.any()
    assert (out.detach().reshape(-1, 16)[gone] == 0).all()


def test_init_shapes_and_expert_parallel_refused():
    p = moe.init_moe_params(torch.Generator().manual_seed(0), 8, 24, 4)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (8, 4), "w1": (4, 8, 24), "b1": (4, 24), "w2": (4, 24, 8),
        "b2": (4, 8)}
    assert float(p["w1"].std()) == pytest.approx(0.02, rel=0.2)
    # expert parallelism is ported (tests/test_torch_mesh_axes.py holds it
    # over ranks); on a mesh of one rank it is the dense layer
    from bifold_tpu_torch.parallel import make_mesh

    x = torch.randn(3, 5, 8, generator=torch.Generator().manual_seed(1))
    want, want_aux = moe.moe_ffn(x, p, top_k=2, capacity_factor=0.5, return_aux=True)
    got, aux = moe.expert_parallel_ffn(x, p, make_mesh(None), top_k=2, capacity_factor=0.5,
                                       return_aux=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    assert float(aux) == pytest.approx(float(want_aux), rel=AUX_TOL)


@pytest.mark.parametrize("depth", [1, 2])
def test_moe_fusion_matches_jax(depth):
    """ConcatTransformer with MoE FFNs: output and the per-layer aux losses
    JAX sows into ``moe_losses`` (stacked over the scanned depth)."""
    d, heads, e = 32, 2, 4
    rng = np.random.default_rng(6)
    text = rng.standard_normal((2, 5, d)).astype(np.float32)
    image = rng.standard_normal((2, 9, d)).astype(np.float32)
    mask = np.ones((2, 14), np.int32)
    mask[1, 2:5] = 0
    jmod = JaxConcatTransformer(dim=d, heads=heads, depth=depth, moe_experts=e,
                                moe_top_k=2, moe_capacity_factor=1.0)
    args = (jnp.asarray(text), jnp.asarray(image))
    variables = jmod.init(jax.random.key(1), *args, attention_masks=jnp.asarray(mask))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    (jout, _), sown = jmod.apply({"params": params}, *args,
                                 attention_masks=jnp.asarray(mask),
                                 mutable=["moe_losses"])
    jaux = np.concatenate([np.ravel(v) for v in
                           jax.tree_util.tree_leaves(sown["moe_losses"])])
    port = ConcatTransformer(d, heads, depth, moe_experts=e, moe_top_k=2,
                             moe_capacity_factor=1.0)
    state = convert_bifold_inverse({"pick_place": {"fusion": params}})
    port.load_state_dict({k.removeprefix("pick_place.fusion."): torch.from_numpy(
        np.array(v)) for k, v in state.items()}, strict=True)
    assert tuple(port.transformer_encoder.layers[0][1].fn.w1.shape) == (e, d, 4 * d)
    aux = []
    with torch.no_grad():
        out = port(torch.from_numpy(text), torch.from_numpy(image),
                   attention_masks=torch.from_numpy(mask), aux=aux)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL)
    assert len(aux) == depth
    np.testing.assert_allclose(torch.stack(aux).numpy(), jaux, atol=AUX_TOL)
