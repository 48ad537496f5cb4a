"""The mesh axes pp, ep and sp, MoE over data ranks and the daemon's --mesh,
on the CPU, against the JAX package.

Four gloo ranks are spawned once per run (this file runs itself as a
worker, ``python tests/test_torch_mesh_axes.py RANK PORT OUT``, as
tests/test_torch_mesh.py does; under pytest-xdist the first worker that
needs them spawns them and the others read what they wrote,
tests/_once_per_run.py), and two daemon ranks (``python -m
bifold_tpu_torch.serve --mesh tp=2``) once for the module; each process is
waited on with its own timeout. Meanwhile the test process computes the
references with the JAX package on its 8 virtual CPU devices, from the same
numpy-seeded inputs and converted weights.

Held:
- (a) the port's ``gpipe`` on two stages (``{pp: 2, dp: 2}``) against
  JAX's ``parallel.gpipe`` on a 2-stage mesh: output and the gradients of
  the input and of every stage's layers within 1e-5;
- (b) one f32 SGD step (clip 1.0) of the tiny flagship (towers and fusion of
  depth 2, each pipelined over 2 stages) under ``{pp: 2, dp: 2}``, ``{pp:
  2, tp: 2}`` and, with ``remat``, ``{pp: 2}`` against JAX's unsharded
  ``make_train_step``: loss, per-head terms and gradient norm within 1e-5
  relative, every parameter (gathered whole) within 1e-5; each stage holds
  only its layers;
- (c) the port's ``expert_parallel_ffn`` under ``{ep: 2, dp: 2}`` and ``{ep:
  4}`` against JAX's ``expert_parallel_ffn`` (ep 2 and 4), and under
  ``{dp: 4}`` against JAX's ``moe_ffn`` over the whole global batch, at top
  1 and top 2 and a capacity that drops tokens: outputs, the load-balance
  loss and the gradients of the input and of every parameter within 1e-5;
  one MoE Trainer step (top 2, dropping capacity, aux weight 0.01) under
  ``{ep: 2, dp: 2}`` against JAX's step under the same active mesh and
  under ``{dp: 4}`` against JAX's unsharded step;
- (d) the port's ``ring_attention`` at sp 2 (``{sp: 2, dp: 2}``) and 4
  against JAX's ``ring_attention(interpret=True)``, with a fully masked key
  chunk: output and dq, dk, dv within 1e-5;
- (e) a Trainer of the MoE flagship at dropout 0.1 under ``{pp: 2, ep: 2}``
  writes a checkpoint of whole tensors that JAX's ``load_checkpoint``
  reads, equal to the gathered weights; a run stopped after its first epoch
  and resumed under the same mesh ends bitwise equal to the run that was
  not stopped;
- (f) the daemon under ``--mesh tp=2``: batch-1 requests, a padded pool and
  concurrent single requests coalesced by the batcher, each answered as
  the port's one-process daemon answers and with JAX's ``ServingModel``
  actions; SIGINT to rank 0 stops both ranks with exit code 0.
"""

import http.client
import io
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

from test_torch_mesh import (FLAGSHIP, GLOBAL_BATCH, SGD, _close_metrics,  # noqa: E402
                             _close_state, _family, _free_port, _global_batch,
                             _jax_server_actions, _jax_step, _model, _observations,
                             _step)

from _once_per_run import once_per_run  # noqa: E402
from bifold_tpu_torch import parallel  # noqa: E402
from bifold_tpu_torch.config import Config, compose  # noqa: E402
from bifold_tpu_torch.losses import build_loss  # noqa: E402
from bifold_tpu_torch.ops import moe  # noqa: E402
from bifold_tpu_torch.optim import build_optimizer  # noqa: E402

WORLD = 4
TIMEOUT_S = 300
TOL = 1e-5
PP_STEPS = {"pp_dp": {"pp": 2, "dp": 2}, "pp_tp": {"pp": 2, "tp": 2}}
MOE = ("model.moe_experts=4", "model.moe_top_k=2", "model.moe_capacity_factor=0.5",
       "model.moe_aux_weight=0.01")
MOE_STEPS = {"ep_dp": {"ep": 2, "dp": 2}, "dp": {"dp": 4}}
FFN_MESHES = {"ep2": {"ep": 2, "dp": 2}, "ep4": {"ep": 4}, "dp4": {"dp": 4}}
FFN_CF = 0.6
RING_MESHES = {"sp2": {"sp": 2, "dp": 2}, "sp4": {"sp": 4}}
DROPOUT = ("model.dropout=0.1", "model.lora_dropout=0.1")
DEPTH, WIDTH = 4, 8


def _gpipe_inputs():
    rng = np.random.default_rng(21)
    return {"w": (0.4 * rng.standard_normal((DEPTH, WIDTH, WIDTH))).astype(np.float32),
            "b": (0.1 * rng.standard_normal((DEPTH, WIDTH))).astype(np.float32),
            "x": rng.standard_normal((8, WIDTH)).astype(np.float32),
            "g": rng.standard_normal((8, WIDTH)).astype(np.float32)}


def _gpipe_case():
    """The port's pipe over a stack of tanh layers: (output, dx, this
    stage's dw and db, the stage)."""
    mesh = parallel.make_mesh({"pp": 2, "dp": 2})
    a = _gpipe_inputs()
    per = DEPTH // 2
    lo = mesh.coords["pp"] * per
    w = torch.tensor(a["w"][lo:lo + per], requires_grad=True)
    b = torch.tensor(a["b"][lo:lo + per], requires_grad=True)
    x = torch.tensor(a["x"], requires_grad=True)

    def body(h):
        for i in range(per):
            h = torch.tanh(h @ w[i] + b[i])
        return h

    y = parallel.gpipe(body, [w, b], x, mesh=mesh, microbatches=4)
    dx, dw, db = torch.autograd.grad(y, [x, w, b], torch.tensor(a["g"]))
    return {"y": y.detach(), "dx": dx, "dw": dw, "db": db, "stage": mesh.coords["pp"]}


def _moe_step(mesh_cfg):
    """One SGD step of the MoE flagship with its aux weight: metrics and
    the whole state (rank 0)."""
    cfg, model = _model(FLAGSHIP + MOE)
    mesh = parallel.make_mesh(mesh_cfg)
    placement = parallel.place(model, _family(FLAGSHIP), mesh, 2 ** 8)
    opt = build_optimizer(dict(SGD), placement.step_params, max_iters=10,
                          gradient_clip=1.0, names=placement.step_names)
    step = parallel.make_train_step(model, build_loss(dict(cfg["loss"])), opt,
                                    moe_aux_weight=0.01, placement=placement)
    _, metrics = step(parallel.TrainState.create(opt),
                      parallel.shard_batch(_global_batch(cfg), mesh=mesh))
    full = placement.full_state_dict()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.clone() for k, v in full.items()} if mesh.rank == 0 else None}


def _ffn_inputs(top_k):
    rng = np.random.default_rng(31 + top_k)
    d, h, e = 8, 16, 4
    params = {"router": rng.standard_normal((d, e)), "w1": 0.3 * rng.standard_normal((e, d, h)),
              "b1": 0.1 * rng.standard_normal((e, h)), "w2": 0.3 * rng.standard_normal((e, h, d)),
              "b2": 0.1 * rng.standard_normal((e, d))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((4, 6, d)).astype(np.float32)
    g = rng.standard_normal((4, 6, d)).astype(np.float32)
    return params, x, g


def _ffn_case(mesh_cfg, top_k):
    """The port's layer on this rank's tokens and experts: output, aux
    share, the gradients of sum(out * g) + 0.1 aux."""
    mesh = parallel.make_mesh(mesh_cfg)
    params, x, g = _ffn_inputs(top_k)
    ep, j = mesh.shape["ep"], mesh.coords["ep"]
    local = {k: torch.tensor(v if k == "router" else np.split(v, ep)[j], requires_grad=True)
             for k, v in params.items()}
    xs = torch.tensor(np.split(x, mesh.data_size)[mesh.data_rank], requires_grad=True)
    gs = torch.tensor(np.split(g, mesh.data_size)[mesh.data_rank])
    out, aux = moe.expert_parallel_ffn(xs, local, mesh, top_k=top_k, capacity_factor=FFN_CF,
                                       return_aux=True)
    grads = torch.autograd.grad((out * gs).sum() + 0.1 * aux, [xs, *local.values()])
    return {"out": out.detach(), "aux": float(aux), "dx": grads[0],
            "grads": dict(zip(local, grads[1:])), "data_rank": mesh.data_rank, "ep": j}


def _ring_inputs():
    rng = np.random.default_rng(41)
    q, k, v, g = (rng.standard_normal((2, 32, 2, 16)).astype(np.float32) for _ in range(4))
    mask = np.ones((2, 32), np.int32)
    mask[0, 8:16] = 0          # a whole chunk at sp 4
    mask[1, 16:] = 0           # a whole chunk at sp 2
    mask[1, 3] = 0
    return q, k, v, mask, g


def _ring_case(mesh_cfg):
    mesh = parallel.make_mesh(mesh_cfg)
    q, k, v, mask, g = _ring_inputs()
    q, k, v = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    out = parallel.ring_attention(q, k, v, torch.tensor(mask), mesh=mesh)
    dq, dk, dv = torch.autograd.grad(out, [q, k, v], torch.tensor(g))
    return {"out": out.detach(), "dq": dq, "dk": dk, "dv": dv}


def _trainer_overrides(run_dir, epochs):
    return [*FLAGSHIP, *MOE, *DROPOUT, "optim=sgd", "optim.lr=0.5", "gradient_clip=1.0",
            f"batch_size={GLOBAL_BATCH}", f"test_batch_size={GLOBAL_BATCH}",
            f"epochs={epochs}", "eval_epochs=0", "log_every=0", "mesh.pp=2",
            "mesh.ep=2", f"run_dir={run_dir}", "use_cpu=true"]


def _train(run_dir, epochs):
    from bifold_tpu_torch.trainer import Trainer

    t = Trainer(Config(compose(_trainer_overrides(run_dir, epochs))), run_dir=run_dir)
    t.prepare_train()
    t.train()
    return t


def _worker(rank, port, out):
    torch.set_num_threads(1)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        os.environ.pop(var, None)
    assert parallel.distributed_init(f"tcp://localhost:{port}", WORLD, rank, device="cpu")
    res = {"gpipe": _gpipe_case()}
    res["pp"] = {name: _step(FLAGSHIP, m) for name, m in PP_STEPS.items()}
    res["pp"]["remat"] = _step(FLAGSHIP, {"pp": 2}, remat=True)
    cfg, model = _model(FLAGSHIP)
    placement = parallel.place(model, _family(FLAGSHIP), parallel.make_mesh({"pp": 2, "dp": 2}))
    res["stages"] = {"pipes": dict(placement.plan.pipes), "foreign": placement.foreign,
                     "staged": placement.staged, "held": placement.held_bytes(),
                     "empty": all(model.get_parameter(n).numel() == 0
                                  for n in placement.foreign)}
    res["ffn"] = {(name, k): _ffn_case(m, k) for name, m in FFN_MESHES.items()
                  for k in (1, 2)}
    res["moe"] = {name: _moe_step(m) for name, m in MOE_STEPS.items()}
    res["ring"] = {name: _ring_case(m) for name, m in RING_MESHES.items()}
    runs = Path(out) / "runs"
    full = _train(runs / "full", 2)
    res["full"] = full.placement.full_state_dict()
    res["plan"] = {"pipes": dict(full.placement.plan.pipes), "ep": list(full.placement.plan.ep)}
    _train(runs / "resumed", 1)
    resumed = _train(runs / "resumed", 2)
    res["resumed"] = resumed.placement.full_state_dict()
    torch.save(res, Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "ok": True}))


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "BIFOLD_LN_KERNEL", "BIFOLD_ATTN_BACKEND")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(HERE.parent),
                                                      env.get("PYTHONPATH")]))
    return env


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _start_ranks(out):
    port = _free_port()
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(r),
                              str(port), str(out)], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, cwd=str(HERE.parent),
                             env=_env()) for r in range(WORLD)]


def _wait_ranks(procs):
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{stderr[-4000:]}"
            assert json.loads(stdout.strip().splitlines()[-1])["ok"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def computed(tmp_path_factory):
    """The ranks' results and JAX's flagship step (computed while the ranks
    run), once per run (tests/_once_per_run.py): the directory holding
    ``rank<r>.pt``, the ranks' runs and ``flagship_reference.pt``."""
    def compute(out):
        procs = _start_ranks(out)
        try:
            torch.save(_jax_step(FLAGSHIP, _global_batch(compose(list(FLAGSHIP)))),
                       out / "flagship_reference.pt")
        finally:
            _wait_ranks(procs)

    return once_per_run(tmp_path_factory, "torch_mesh_axes", compute)


@pytest.fixture(scope="module")
def results(computed):
    return computed, [torch.load(computed / f"rank{r}.pt", weights_only=False)
                      for r in range(WORLD)]


@pytest.fixture(scope="module")
def flagship_reference(computed):
    return torch.load(computed / "flagship_reference.pt", weights_only=False)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=TOL, rtol=TOL, err_msg=what)


def test_gpipe_matches_jax(results, devices):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bifold_tpu.parallel import gpipe as jax_gpipe

    _, ranks = results
    a = _gpipe_inputs()
    mesh = Mesh(np.asarray(devices[:2]), ("pp",))

    def body(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def f(params, x):
        return jax_gpipe(body, params, x, mesh=mesh, microbatches=4)

    def run(params, x, g):
        y, vjp = jax.vjp(f, params, x)
        return (y, *vjp(g))

    params = {"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"])}
    y, dparams, dx = jax.jit(run)(params, jnp.asarray(a["x"]), jnp.asarray(a["g"]))
    for r in ranks:
        got = r["gpipe"]
        _close(got["y"], y, "gpipe y")
        _close(got["dx"], dx, "gpipe dx")
        lo = got["stage"] * (DEPTH // 2)
        _close(got["dw"], np.asarray(dparams["w"])[lo:lo + DEPTH // 2], "gpipe dw")
        _close(got["db"], np.asarray(dparams["b"])[lo:lo + DEPTH // 2], "gpipe db")


@pytest.mark.parametrize("name", ["pp_dp", "pp_tp", "remat"])
def test_pp_step_matches_the_jax_step(results, flagship_reference, name):
    _, ranks = results
    want_metrics, want_state = flagship_reference
    for r in ranks:
        _close_metrics(r["pp"][name]["metrics"], want_metrics, name)
    _close_state(ranks[0]["pp"][name]["state"], want_state, name)


def test_each_stage_holds_its_layers(results):
    _, ranks = results
    cfg, model = _model(FLAGSHIP)
    whole = sum(p.numel() * p.element_size() for p in model.parameters())
    for r in ranks:
        s = r["stages"]
        assert len(s["pipes"]) == 3 and set(s["pipes"].values()) == {2}
        assert s["foreign"] and s["staged"] and s["empty"]
        assert not set(s["foreign"]) & set(s["staged"])
        assert s["held"] < whole
    # {pp: 2, dp: 2}: ranks 0 and 1 are the two stages of one pipe
    assert ranks[0]["stages"]["staged"] == ranks[1]["stages"]["foreign"]


def _jax_ffn(name, top_k, devices):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bifold_tpu.ops import moe as jax_moe

    params, x, g = _ffn_inputs(top_k)
    ep = FFN_MESHES[name].get("ep", 1)

    def f(p, xx):
        x2 = xx.reshape(-1, xx.shape[-1])
        if ep > 1:
            mesh = Mesh(np.asarray(devices[:ep]), ("ep",))
            out = jax_moe.expert_parallel_ffn(x2, p, mesh, top_k=top_k,
                                              capacity_factor=FFN_CF)
            _, _, aux = jax_moe.route(x2, p["router"], top_k=1, capacity=1, return_aux=True)
        else:
            out, aux = jax_moe.moe_ffn(x2, p, top_k=top_k, capacity_factor=FFN_CF,
                                       return_aux=True)
        return out.reshape(xx.shape), aux

    def run(p, xx, gg):
        (out, aux), vjp = jax.vjp(f, p, xx)
        return (out, aux, *vjp((gg, jnp.asarray(0.1, jnp.float32))))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    out, aux, dp, dx = jax.jit(run)(jp, jnp.asarray(x), jnp.asarray(g))
    # the (token, pass) slots JAX's routing keeps, group by group
    groups = np.split(x.reshape(-1, x.shape[-1]), ep)
    cap = jax_moe._capacity(len(groups[0]), params["router"].shape[1], top_k, FFN_CF)
    kept = sum(float(jax_moe.route(jnp.asarray(t), jp["router"], top_k=top_k,
                                   capacity=cap)[0].sum()) for t in groups)
    return (np.asarray(out), float(aux), np.asarray(dx),
            {k: np.asarray(v) for k, v in dp.items()}, kept / (x.size // x.shape[-1] * top_k))


@pytest.mark.parametrize("name, top_k", [(n, k) for n in FFN_MESHES for k in (1, 2)],
                         ids=[f"{n}-top{k}" for n in FFN_MESHES for k in (1, 2)])
def test_expert_parallel_ffn_matches_jax(results, devices, name, top_k):
    _, ranks = results
    out, aux, dx, dp, kept = _jax_ffn(name, top_k, devices)
    assert kept < 1.0, "the capacity drops no token"
    cases = [r["ffn"][name, top_k] for r in ranks]
    data = sorted({c["data_rank"] for c in cases})
    ep = max(c["ep"] for c in cases) + 1
    first = {c["data_rank"]: c for c in cases if c["ep"] == 0}
    _close(np.concatenate([first[d]["out"] for d in data]), out, f"{name} out")
    _close(np.concatenate([first[d]["dx"] for d in data]), dx, f"{name} dx")
    _close(sum(first[d]["aux"] for d in data), aux, f"{name} aux")
    _close(sum(first[d]["grads"]["router"] for d in data), dp["router"], f"{name} router")
    for key in ("w1", "b1", "w2", "b2"):
        got = [sum(c["grads"][key] for c in cases if c["ep"] == j) for j in range(ep)]
        _close(np.concatenate(got), dp[key], f"{name} {key}")


def _jax_moe_step(mesh_cfg, devices):
    """JAX's MoE flagship step, under ``mesh_cfg``'s active mesh when it
    has an ep axis (routing by ep shard), else unsharded (dp's global
    routing is the unsharded step's)."""
    import jax
    import jax.numpy as jnp

    from bifold_tpu import parallel as jax_parallel
    from bifold_tpu.config import compose as jax_compose
    from bifold_tpu.losses import build_loss as jax_build_loss
    from bifold_tpu.models import build_model as jax_build_model
    from bifold_tpu.models import trainable_mask as jax_trainable_mask
    from bifold_tpu.optim import build_optimizer as jax_build_optimizer
    from bifold_tpu_torch.models.convert import from_jax_variables, to_jax_variables

    overrides = FLAGSHIP + MOE
    cfg, model = _model(overrides)
    params, extra = to_jax_variables(_family(overrides), model.state_dict())
    jcfg = jax_compose(list(overrides))
    jmodel = jax_build_model(dict(jcfg["model"]))
    mask = jax_trainable_mask(params, lora=True)
    tx, _ = jax_build_optimizer(dict(SGD), None, max_iters=10, trainable=mask,
                                gradient_clip=1.0)
    if mesh_cfg.get("ep", 1) > 1:
        jax_parallel.set_active_mesh(jax_parallel.make_mesh(mesh_cfg, devices=devices[:4]))
    try:
        step = jax_parallel.make_train_step(jmodel, jax_build_loss(dict(jcfg["loss"])), tx,
                                            donate=False, trainable=mask,
                                            moe_aux_weight=0.01)
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        state = (jparams, tx.init(jparams), extra, jax.random.key(0))
        batch = _global_batch(cfg)
        (new, _, _, _), metrics = step(
            state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    finally:
        jax_parallel.set_active_mesh(None)
    return ({k: float(v) for k, v in metrics.items()},
            from_jax_variables(_family(overrides), jax.tree_util.tree_map(np.asarray, new)))


@pytest.mark.parametrize("name", list(MOE_STEPS))
def test_moe_step_matches_jax(results, devices, name):
    _, ranks = results
    want_metrics, want_state = _jax_moe_step(MOE_STEPS[name], devices)
    for r in ranks:
        got = r["moe"][name]["metrics"]
        _close_metrics(got, want_metrics, name)
        np.testing.assert_allclose(got["moe_load_balance"], want_metrics["moe_load_balance"],
                                   rtol=TOL)
    _close_state(ranks[0]["moe"][name]["state"], want_state, name)


@pytest.mark.parametrize("name", list(RING_MESHES))
def test_ring_attention_matches_jax(results, devices, name):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bifold_tpu.parallel import ring_attention as jax_ring

    _, ranks = results
    sp = RING_MESHES[name]["sp"]
    q, k, v, mask, g = (jnp.asarray(t) for t in _ring_inputs())
    mesh = Mesh(np.asarray(devices[:sp]), ("sp",))
    def run(a, b, c):
        out, vjp = jax.vjp(lambda a, b, c: jax_ring(a, b, c, mask, mesh=mesh, interpret=True),
                           a, b, c)
        return (out, *vjp(g))

    out, *grads = jax.jit(run)(q, k, v)
    grads = dict(zip(("dq", "dk", "dv"), grads))
    for r in ranks:
        got = r["ring"][name]
        _close(got["out"], out, f"{name} out")
        for key, want in grads.items():
            _close(got[key], want, f"{name} {key}")


def test_pp_ep_checkpoint_loads_in_jax_and_resumes_bitwise(results):
    from bifold_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
    from bifold_tpu_torch.models.convert import from_jax_variables

    out, ranks = results
    for r in ranks:
        assert len(r["plan"]["pipes"]) == 2 and r["plan"]["ep"]   # towers piped, experts cut
        assert sorted(r["full"]) == sorted(r["resumed"])
        for k, v in r["full"].items():
            assert torch.equal(v, r["resumed"][k]), k
            assert torch.equal(v, ranks[0]["full"][k]), k
    payload = jax_load_checkpoint(out / "runs" / "full" / "checkpoints" / "last.ckpt",
                                  restore_rng=False)
    assert payload["epoch"] == 2 and payload["step"] == 4
    weights = from_jax_variables(_family(FLAGSHIP), payload["params"])
    for k, v in ranks[0]["full"].items():
        np.testing.assert_array_equal(np.asarray(weights[k], np.float32),
                                      v.float().numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# the daemon under --mesh
# ---------------------------------------------------------------------------


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _daemon_files(root):
    from bifold_tpu_torch.config import save as save_config
    from bifold_tpu_torch.models.convert import to_jax_variables
    from bifold_tpu_torch.utils.checkpoint import save_checkpoint

    cfg, model = _model(FLAGSHIP)
    params, extra = to_jax_variables(_family(FLAGSHIP), model.state_dict())
    ckpt = save_checkpoint(root / "last.ckpt", params=params, extra_vars=extra,
                           metadata={"model": dict(cfg["model"])})
    save_config(cfg, root / "config.yaml")
    return ckpt, root / "config.yaml"


ARGS = ("--device", "cpu", "--depth-wire", "float32", "--max-batch", "4",
        "--batch-window-ms", "300")


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    root = tmp_path_factory.mktemp("daemon_mesh")
    ckpt, config = _daemon_files(root)
    port = _free_port()
    procs = []
    for r in range(2):
        env = {**_env(), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
               "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": "0"}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "bifold_tpu_torch.serve", "--checkpoint", str(ckpt),
             "--config", str(config), "--mesh", "tp=2", "--port", "0", *ARGS],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(HERE.parent), env=env))
    lines, listening = [], threading.Event()

    def read():
        for line in procs[0].stdout:
            lines.append(line)
            if "listening on" in line:
                listening.set()

    threading.Thread(target=read, daemon=True).start()
    try:
        assert listening.wait(TIMEOUT_S), f"rank 0 never listened:\n{''.join(lines)}"
        http_port = int(next(x for x in lines if "listening on" in x)
                        .split("http://")[1].split()[0].rsplit(":", 1)[1])
        yield procs, http_port, ckpt, config
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def test_daemon_mesh_serves_like_one_process_and_jax(daemon):
    from bifold_tpu_torch.serve import RemotePolicy, build_server, make_httpd

    procs, port, ckpt, config = daemon
    one = make_httpd(build_server(checkpoint=ckpt, config=config, depth_wire="float32",
                                  device="cpu"), max_batch=4, batch_window_ms=300)
    threading.Thread(target=one.serve_forever, daemon=True).start()
    one_port = one.server_address[1]
    try:
        singles, pool = _observations(3, 7), _observations(3, 1)
        answers = {}
        for name, p in (("mesh", port), ("one", one_port)):
            got = [_post(p, "/predict?raw=1", RemotePolicy._pack([o])) for o in singles[:1]]
            got.append(_post(p, "/predict?pad=4", RemotePolicy._pack(pool)))
            threads, coalesced = [], [None] * 3
            for i, o in enumerate(singles):
                def go(i=i, o=o):
                    coalesced[i] = _post(p, "/predict", RemotePolicy._pack([o]))
                threads.append(threading.Thread(target=go))
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            answers[name] = got + coalesced
            conn = http.client.HTTPConnection("127.0.0.1", p, timeout=60)
            conn.request("GET", "/metrics")
            answers[name + "_metrics"] = json.loads(conn.getresponse().read())
            conn.close()
        for (sa, da), (sb, db) in zip(answers["mesh"], answers["one"]):
            assert sa == 200 and sb == 200, (da, db)
            a, b = dict(np.load(io.BytesIO(da))), dict(np.load(io.BytesIO(db)))
            assert sorted(a) == sorted(b)
            for key in a:
                if key.startswith("raw_"):
                    np.testing.assert_allclose(a[key], b[key], atol=TOL, rtol=0, err_msg=key)
                else:
                    np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert answers["mesh_metrics"]["batcher_dispatches"] < 3
        jax_one = _jax_server_actions(singles[:1], None)
        jax_pool = _jax_server_actions(pool, 4)
        first = dict(np.load(io.BytesIO(answers["mesh"][0][1])))
        pooled = dict(np.load(io.BytesIO(answers["mesh"][1][1])))
        for f in (k for k in first if not k.startswith("raw_")):
            np.testing.assert_array_equal(first[f], np.asarray(jax_one[f]), err_msg=f)
            np.testing.assert_array_equal(pooled[f], np.asarray(jax_pool[f]), err_msg=f)
    finally:
        one.shutdown()
        one.server_close()
    procs[0].send_signal(signal.SIGINT)
    for p in procs:
        p.wait(timeout=120)
    assert [p.returncode for p in procs] == [0, 0], procs[1].stderr.read()[-3000:]


def test_serve_mesh_without_a_launcher_is_refused(monkeypatch):
    from bifold_tpu_torch import serve

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        serve.main(["--checkpoint", "last.ckpt", "--config", "config.yaml",
                    "--mesh", "tp=2", "--device", "cpu"])


def test_check_mesh_takes_the_seven_axes():
    assert parallel.check_mesh({"pp": 2, "sp": 2, "ep": 2}, world=16) == 16
    assert parallel._axis_sizes({"pp": 2, "ep": 2, "pp_microbatches": 4}, 8)["dp"] == 2
    with pytest.raises(ValueError, match="ranks"):
        parallel.check_mesh({"pp": 3}, world=4)
    mesh = parallel.make_mesh({"dp": 1, "pp_microbatches": 2})
    assert mesh.pp_microbatches == 2 and mesh.shape["pp"] == 1


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
