"""fsdp and tp over ``torch.distributed``, on the CPU, against the JAX package.

Four gloo ranks are spawned once per run (under pytest-xdist the first
worker that needs them spawns them and the others read what they wrote,
tests/_once_per_run.py): this file runs itself as a worker (``python
tests/test_torch_mesh.py RANK PORT OUT``), joins the group through
``parallel.distributed_init``, runs every case under its mesh and writes
what each gives to ``OUT/rank<RANK>.pt``; each worker's
``communicate`` has its own timeout, so a hang fails this module's tests
and not the suite's clock. Meanwhile the test process computes the
references: the JAX package's unsharded ``make_train_step`` and
``ServingModel`` on the same converted weights and numpy-seeded batch, and
the port's unsharded server.

Held:
- one f32 SGD step (clip 1.0) of a tiny flagship (SiglipSequential, LoRA
  on, fusion of 4 heads) and of ``text_unet`` (its CLIP text tower of 4
  heads, global BatchNorm statistics) under ``{fsdp: 2, dp: 2}``, ``{tp: 2,
  dp: 2}`` and ``{fsdp: 2, tp: 2}`` at ``min_size`` 2**8 (so that the tiny
  towers shard): loss, per-head terms and gradient norm within 1e-5
  relative of JAX's, every parameter (gathered whole) and BatchNorm
  statistic within 1e-5; the flagship again under ``{fsdp: 2, tp: 2}``
  with ``remat`` and with ``BIFOLD_LN_KERNEL=fused`` (the kernels' plain
  versions on the CPU);
- at dropout 0.1 (fusion and LoRA) under ``{tp: 2, dp: 2}``, the tp ranks'
  replicated tensors stay bitwise equal after two steps;
- the flagship at odd widths (towers and fusion of 3 heads at width 27)
  under ``{fsdp: 2, dp: 2}``, where fsdp shards stacked leaves along their
  depth (the blocks gather their layers from the ranks owning them): the
  step within 1e-5 of JAX's, its peak within two blocks' shares;
- the fsdp steps' peak of whole fsdp tensors (weights and gradients) at
  most the tensors outside the stacks' blocks and two blocks' shares,
  below the whole model's: the stacks gather their units a block at a
  time (ZeRO-3);
- ``ServingModel(mesh=)`` under ``{tp: 2, dp: 2}`` and ``{fsdp: 2, dp:
  2}``, plain and int8, and int8 under ``{fsdp: 2, tp: 2}`` (``quantize_min_size`` 2**10, so that the stacks'
  weights are int8; the fsdp rule at ``min_size`` 2**8, so that they and
  some scales shard), at a pool of 4 (cut over the data ranks) and at batch
  1 (served whole): actions equal to the unsharded port server's and raw
  outputs within 1e-5, and the plain server's actions equal to JAX's
  ``ServingModel``; under fsdp a request's peak of whole tensors within one
  block's share of the rest, and each int8 rank holding half of the int8
  payload bytes (within one chunk); ``export`` raises;
- each step case records its first step's collectives
  (``parallel.collectives.recording``) for ``tests/test_torch_advisor.py``
  to hold the advisor's record against;
- a Trainer under ``{fsdp: 2, tp: 2}`` writes a checkpoint of whole
  tensors that JAX's ``load_checkpoint`` reads, equal to the gathered
  weights; a run stopped after its first epoch and resumed under the same
  mesh ends bitwise equal to the run that was not stopped.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

from _once_per_run import once_per_run  # noqa: E402
from bifold_tpu_torch import parallel  # noqa: E402
from bifold_tpu_torch.config import Config, compose  # noqa: E402
from bifold_tpu_torch.data import build_dataset, collate  # noqa: E402
from bifold_tpu_torch.data.processor import Processor  # noqa: E402
from bifold_tpu_torch.losses import build_loss  # noqa: E402
from bifold_tpu_torch.models import build_model, trainable_mask  # noqa: E402
from bifold_tpu_torch.models.backbones import clip_backbone as pcb  # noqa: E402
from bifold_tpu_torch.models.backbones import siglip_backbone as psb  # noqa: E402
from bifold_tpu_torch.models.convert import to_jax_variables  # noqa: E402
from bifold_tpu_torch.optim import build_optimizer  # noqa: E402
from bifold_tpu_torch.serving import ServingModel  # noqa: E402

WORLD = 4
TIMEOUT_S = 240
RTOL = 1e-5
ATOL = 1e-5
MIN_SIZE = 2 ** 8
INT8_MIN_SIZE = 2 ** 10
GLOBAL_BATCH = 4
COMMON = ("train_dataset=synthetic", "train_dataset.image_size=64",
          "train_dataset.is_bimanual=true", "train_dataset.n_samples=8",
          "test_dataset=null", "precision.compute_dtype=float32", "simulator=null")
FLAGSHIP = ("model=siglip_sequential", "model.automodel_name=tiny", "model.dim=64",
            "model.depth=2", "model.heads=4", "model.r=2", "model.lora_dropout=0",
            "train_dataset.max_context_length=2") + COMMON
UNET = ("model=text_unet", "model.features=[8,16,32]") + COMMON
DROPOUT = ("model.dropout=0.1", "model.lora_dropout=0.1")
# odd widths (SigLIP towers of 3 heads at width 27, a fusion of 3 heads):
# fsdp=2 then shards the stacks' (2, 27, 27) and (2, 27, 81) leaves along
# their depth, the one axis it divides
ODD_SIGLIP = dict(layers=2, heads=3, mlp_dim=81)
ODD = ("model=siglip_sequential", "model.automodel_name=tiny_odd", "model.dim=27",
       "model.depth=2", "model.heads=3", "model.r=2", "model.lora_dropout=0",
       "train_dataset.max_context_length=2") + COMMON
TINY_TEXT = dict(text_width=32, text_layers=2, text_heads=4, context_length=77,
                 vocab_size=49408, embed_dim=64)
SGD = {"name": "sgd", "lr": 0.5, "momentum": 0.0, "nesterov": False}
FSDP_DP, TP_DP, FSDP_TP = {"fsdp": 2, "dp": 2}, {"tp": 2, "dp": 2}, {"fsdp": 2, "tp": 2}
STEPS = [("flagship", FLAGSHIP, m) for m in (FSDP_DP, TP_DP, FSDP_TP)] + \
        [("unet", UNET, m) for m in (FSDP_DP, TP_DP, FSDP_TP)]
SERVE_MESHES = [("tp_dp", TP_DP, None), ("tp_dp_int8", TP_DP, "int8"),
                ("fsdp_dp", FSDP_DP, None), ("fsdp_dp_int8", FSDP_DP, "int8"),
                ("fsdp_tp_int8", FSDP_TP, "int8")]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tiny_clip():
    pcb.CLIP_TEXT_CONFIGS["RN50"] = pcb.ClipConfig(**TINY_TEXT)
    psb.SIGLIP_BASE_CONFIGS["tiny_odd"] = psb.SiglipConfig(**ODD_SIGLIP)


def _family(overrides):
    return dict(compose(list(overrides))["model"])["name"]


def _global_batch(cfg):
    """The first global batch of the train partition, processed on the CPU
    with a seeded generator."""
    ds = build_dataset(cfg["train_dataset"], cfg["processor"], partition="train",
                       autoprocessor_name=dict(cfg["model"]).get("automodel_name"), seed=5)
    batch = collate([ds[i] for i in range(GLOBAL_BATCH)])
    out = ds.processor.process_batch(batch, "cpu", generator=torch.Generator().manual_seed(11))
    return {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}


def _model(overrides, remat=False):
    cfg = compose(list(overrides))
    model = build_model(dict(cfg["model"]), device="cpu", seed=3, remat=remat)
    trainable_mask(model, lora=True)
    return cfg, model


def _step(overrides, mesh_cfg, steps=1, remat=False):
    """SGD steps from the seeded init on this rank's slice of the global
    batch: metrics, whole state (rank 0), the hash of each local
    replicated tensor, the first step's collectives (summarized) and the
    placement's peak of whole fsdp tensors with what bounds it."""
    from bifold_tpu_torch.parallel.collectives import recording, summarize

    cfg, model = _model(overrides, remat)
    mesh = parallel.make_mesh(mesh_cfg)
    placement = parallel.place(model, _family(overrides), mesh, MIN_SIZE)
    opt = build_optimizer(dict(SGD), placement.step_params, max_iters=10,
                          gradient_clip=1.0, names=placement.step_names)
    step = parallel.make_train_step(model, build_loss(dict(cfg["loss"])), opt,
                                    placement=placement)
    state = parallel.TrainState.create(opt)
    batch = parallel.shard_batch(_global_batch(cfg), mesh=mesh)
    with recording() as record:
        state, metrics = step(state, batch)
    for _ in range(steps - 1):
        state, metrics = step(state, batch)
    shares = [s.nbytes + s.grad_bytes for s in placement.shares]
    whole = sum(int(np.prod(placement._full_shapes[n])) * p.element_size()
                * (1 + p.requires_grad) for n, p in model.named_parameters()
                if n in placement.managed)
    full = placement.full_state_dict()
    h = hashlib.sha256()
    for n, p in model.named_parameters():
        if n not in placement.plan.tp and n not in placement.managed:
            h.update(n.encode() + p.detach().contiguous().numpy().tobytes())
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "depth_units": sum(u.axis == 0 and "blocks" in u.leaf.path
                               for u in placement.units),
            "state": {k: v.clone() for k, v in full.items()} if mesh.rank == 0 else None,
            "replicated": h.hexdigest(), "tp_rank": mesh.tp_rank,
            "collectives": summarize(record), "peak": placement.peak_bytes,
            "stepwise": placement.stepwise_bytes, "shares": shares, "whole": whole}


def _observations(n, seed):
    rng = np.random.default_rng(seed)

    def frame():
        return dict(rgb=rng.integers(0, 255, (72, 72, 3), dtype=np.uint8),
                    depth=rng.random((72, 72)).astype(np.float32),
                    mask=(rng.random((72, 72)) > 0.3).astype(np.float32))
    return [dict(frame(), instruction=f"fold the towel {i}", context=[frame()])
            for i in range(n)]


def _server(mesh_cfg, quantize):
    cfg, model = _model(FLAGSHIP)
    proc = Processor(dict(cfg["processor"]), max_context_length=2,
                     autoprocessor_name="tiny")
    return ServingModel(model, None, proc, quantize=quantize,
                        quantize_min_size=INT8_MIN_SIZE, mesh=mesh_cfg, device="cpu",
                        shard_min_size=MIN_SIZE)


def _held(server):
    """Bytes of int8 payloads this rank holds (fsdp chunks included), the
    largest unit chunk, and the request peak of whole fsdp tensors with
    its bound."""
    p = server.placement
    chunks = [u.shard for u in p.units]
    held = sum(t.numel() for t in [*server.model.parameters(), *chunks]
               if t.dtype == torch.int8)
    return {"int8": held, "chunk": max([t.numel() for t in chunks if t.dtype == torch.int8],
                                       default=0),
            "peak": p.peak_bytes, "bound": p.stepwise_bytes + 2 * max(
                [s.nbytes for s in p.shares], default=0), "shares": len(p.shares)}


def _serve(server):
    out = {}
    for name, obs, pool in (("pool", _observations(3, 1), 4), ("one", _observations(1, 2), None)):
        action, raw = server.predict_batch(obs, pad_to=pool, return_raw_output=True)
        out[name] = (dict(vars(action)), raw)
    return out


def _trainer_overrides(run_dir, epochs):
    return [*FLAGSHIP, "optim=sgd", "optim.lr=0.5", "gradient_clip=1.0",
            f"batch_size={GLOBAL_BATCH}", f"test_batch_size={GLOBAL_BATCH}",
            f"epochs={epochs}", "eval_epochs=0", "log_every=0", "mesh.fsdp=2",
            "mesh.tp=2", f"run_dir={run_dir}", "use_cpu=true"]


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
    _tiny_clip()
    res = {"steps": [_step(o, m) for _, o, m in STEPS]}
    res["remat"] = _step(FLAGSHIP, FSDP_TP, remat=True)
    os.environ["BIFOLD_LN_KERNEL"] = "fused"
    res["fused"] = _step(FLAGSHIP, FSDP_TP)
    del os.environ["BIFOLD_LN_KERNEL"]
    res["dropout"] = _step(FLAGSHIP + DROPOUT, TP_DP, steps=2)
    res["depth_axis"] = _step(ODD, FSDP_DP)
    res["serve"] = {}
    for name, mesh_cfg, quantize in SERVE_MESHES:
        server = _server(mesh_cfg, quantize)
        server.placement.reset_peak()
        res["serve"][name] = _serve(server)
        res["serve"][name]["held"] = _held(server)
    try:
        server.export(Path(out) / "a.pt", **_observations(1, 3)[0])
        res["export"] = "exported"
    except NotImplementedError as e:
        res["export"] = str(e)
    runs = Path(out) / "runs"
    full = _train(runs / "full", 2)
    res["full"] = full.placement.full_state_dict()
    _train(runs / "resumed", 1)
    resumed = _train(runs / "resumed", 2)
    res["resumed"] = resumed.placement.full_state_dict()
    torch.save(res, Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "ok": True}))


@pytest.fixture(scope="module", autouse=True)
def _no_spm_env():
    """'tiny' tokenizes by its hash in this process and in the ranks: a
    ``$BIFOLD_SIGLIP_SPM`` that an earlier test in this process left set
    (JAX's ``load_checkpoint`` of a checkpoint with a sibling
    ``spiece.model`` and ``ensure_spm_fixture`` set it) would give this
    process other token ids than the ranks, which are spawned without it,
    perhaps by another process."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("BIFOLD_SIGLIP_SPM", raising=False)
        yield


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny_clip():
    from bifold_tpu.models.backbones import clip_backbone as jcb
    from bifold_tpu.models.backbones import siglip_backbone as jsb

    saved = jcb.CLIP_TEXT_CONFIGS["RN50"], pcb.CLIP_TEXT_CONFIGS["RN50"]
    jcb.CLIP_TEXT_CONFIGS["RN50"] = jcb.ClipConfig(**TINY_TEXT)
    jsb.SIGLIP_BASE_CONFIGS["tiny_odd"] = jsb.SiglipConfig(**ODD_SIGLIP)
    _tiny_clip()
    yield
    jcb.CLIP_TEXT_CONFIGS["RN50"], pcb.CLIP_TEXT_CONFIGS["RN50"] = saved
    del jsb.SIGLIP_BASE_CONFIGS["tiny_odd"], psb.SIGLIP_BASE_CONFIGS["tiny_odd"]


def _start_ranks(out):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "BIFOLD_LN_KERNEL", "BIFOLD_ATTN_BACKEND", "BIFOLD_SIGLIP_SPM")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(HERE.parent),
                                                      env.get("PYTHONPATH")]))
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(r),
                              str(port), str(out)], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, cwd=str(HERE.parent),
                             env=env) for r in range(WORLD)]


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
def computed(tmp_path_factory, tiny_clip):
    """The ranks' results and the JAX steps of both families (computed while
    the ranks run), once per run (tests/_once_per_run.py): the directory
    holding ``rank<r>.pt``, the ranks' runs and ``references.pt``."""
    def compute(out):
        procs = _start_ranks(out)
        try:
            torch.save({name: _jax_step(overrides, _global_batch(compose(list(overrides))))
                        for name, overrides in (("flagship", FLAGSHIP), ("unet", UNET),
                                                ("odd", ODD))},
                       out / "references.pt")
        finally:
            _wait_ranks(procs)

    return once_per_run(tmp_path_factory, "torch_mesh", compute)


@pytest.fixture(scope="module")
def results(computed):
    return computed, [torch.load(computed / f"rank{r}.pt", weights_only=False)
                      for r in range(WORLD)]


def _jax_step(overrides, batch):
    """The JAX package's unsharded step on the port's seeded weights:
    (metrics, the new weights and statistics in the port's names)."""
    import jax
    import jax.numpy as jnp

    from bifold_tpu import parallel as jax_parallel
    from bifold_tpu.config import compose as jax_compose
    from bifold_tpu.losses import build_loss as jax_build_loss
    from bifold_tpu.models import build_model as jax_build_model
    from bifold_tpu.models import trainable_mask as jax_trainable_mask
    from bifold_tpu.optim import build_optimizer as jax_build_optimizer
    from bifold_tpu_torch.models.convert import from_jax_variables

    cfg, model = _model(overrides)
    family = _family(overrides)
    params, extra = to_jax_variables(family, model.state_dict())
    jcfg = jax_compose(list(overrides))
    jmodel = jax_build_model(dict(jcfg["model"]))
    mask = jax_trainable_mask(params, lora=True)
    tx, _ = jax_build_optimizer(dict(SGD), None, max_iters=10, trainable=mask,
                                gradient_clip=1.0)
    step = jax_parallel.make_train_step(jmodel, jax_build_loss(dict(jcfg["loss"])), tx,
                                        has_batch_stats=bool(extra), donate=False,
                                        trainable=mask)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = (jparams, tx.init(jparams), extra, jax.random.key(0))
    (new, _, new_extra, _), metrics = step(
        state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    host = jax.tree_util.tree_map(np.asarray, (new, new_extra))
    return ({k: float(v) for k, v in metrics.items()},
            from_jax_variables(family, *host))


@pytest.fixture(scope="module")
def references(computed):
    """The JAX steps of both families."""
    return torch.load(computed / "references.pt", weights_only=False)


def _close_state(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(v, np.float32),
                                   atol=ATOL, rtol=0, err_msg=f"{what} {k}")


def _close_metrics(got, want, what):
    for k in ("loss", "grad_norm") + tuple(k for k in want if k.endswith("_heatmap")):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("index", range(len(STEPS)),
                         ids=[f"{f}-{'_'.join(f'{k}{v}' for k, v in m.items())}"
                              for f, _, m in STEPS])
def test_sharded_step_matches_the_jax_step(references, results, index):
    _, ranks = results
    family, _, mesh_cfg = STEPS[index]
    want_metrics, want_state = references[family]
    for r in ranks:
        _close_metrics(r["steps"][index]["metrics"], want_metrics, family)
        if "fsdp" in mesh_cfg:
            _peak_within_a_block(r["steps"][index], family)
    _close_state(ranks[0]["steps"][index]["state"], want_state, family)


def _peak_within_a_block(got, what):
    """The step's peak of whole fsdp tensors (weights and gradients) is at
    most the tensors outside the stacks' blocks (with their gradients) and
    two blocks' shares (each with its gradients): the stacks' units are
    gathered a block at a time, and their gradients reduce-scattered
    before the next block's backward; the whole model's figure (what the
    step held when it gathered every unit) is above it."""
    bound = got["stepwise"] + 2 * max(got["shares"])
    assert got["shares"] and 0 < got["peak"] <= bound and got["peak"] < got["whole"], (
        what, got["peak"], bound, got["whole"])


def test_fsdp_along_the_depth_axis_matches_the_jax_step(references, results):
    """fsdp=2 shards the odd-width flagship's stacked leaves along their
    depth: each block gathers its layers from the ranks that own them and
    returns their gradients to them; the step equals JAX's within 1e-5."""
    _, ranks = results
    want_metrics, want_state = references["odd"]
    for r in ranks:
        assert r["depth_axis"]["depth_units"] > 0
        _close_metrics(r["depth_axis"]["metrics"], want_metrics, "odd")
        _peak_within_a_block(r["depth_axis"], "odd")
    _close_state(ranks[0]["depth_axis"]["state"], want_state, "odd")


@pytest.mark.parametrize("case", ["remat", "fused"])
def test_remat_and_fused_layer_norm_under_fsdp_tp(references, results, case):
    _, ranks = results
    want_metrics, want_state = references["flagship"]
    for r in ranks:
        _close_metrics(r[case]["metrics"], want_metrics, case)
        _peak_within_a_block(r[case], case)
    _close_state(ranks[0][case]["state"], want_state, case)


@pytest.mark.parametrize("index", [i for i, (f, _, m) in enumerate(STEPS) if f == "flagship"],
                         ids=["_".join(f"{k}{v}" for k, v in STEPS[i][2].items())
                              for i, (f, _, m) in enumerate(STEPS) if f == "flagship"])
def test_advisor_records_the_ranks_collectives(results, index):
    """The advisor's fake run of the step (rank 0 of 4 on fake tensors and a
    fake group) records the collectives that rank 0 of the real gloo ranks
    recorded, by kind, count and bytes."""
    from bifold_tpu_torch.parallel.advisor import analyze_layout

    _, ranks = results
    cfg = compose(list(FLAGSHIP))
    got = analyze_layout(STEPS[index][2], n_devices=WORLD, batch=GLOBAL_BATCH,
                         model_cfg=dict(cfg["model"]), processor_cfg=dict(cfg["processor"]),
                         loss_cfg=dict(cfg["loss"]), compute_dtype="float32",
                         min_size=MIN_SIZE)
    assert got["collectives"] == ranks[0]["steps"][index]["collectives"]


def test_tp_group_stays_in_step_under_dropout(results):
    _, ranks = results
    groups = {}
    for i, r in enumerate(ranks):
        groups.setdefault(i // 2, []).append(r["dropout"]["replicated"])
    for hashes in groups.values():
        assert len(hashes) == 2 and hashes[0] == hashes[1]
    assert ranks[0]["dropout"]["tp_rank"] == 0 and ranks[1]["dropout"]["tp_rank"] == 1


def _jax_server_actions(observations, pool):
    import jax

    from bifold_tpu.config import compose as jax_compose
    from bifold_tpu.data.processor import Processor as JaxProcessor
    from bifold_tpu.models import build_model as jax_build_model
    from bifold_tpu.serving import ServingModel as JaxServingModel

    cfg, model = _model(FLAGSHIP)
    params, _ = to_jax_variables(_family(FLAGSHIP), model.state_dict())
    jcfg = jax_compose(list(FLAGSHIP))
    proc = JaxProcessor(dict(jcfg["processor"]), partition="test", max_context_length=2,
                        autoprocessor_name="tiny")
    server = JaxServingModel(jax_build_model(dict(jcfg["model"])),
                             {"params": jax.tree_util.tree_map(np.asarray, params)}, proc)
    return dict(vars(server.predict_batch(observations, pad_to=pool)))


@pytest.mark.parametrize("name, mesh_cfg, quantize", SERVE_MESHES,
                         ids=[n for n, _, _ in SERVE_MESHES])
def test_sharded_server_matches_one_device(results, name, mesh_cfg, quantize):
    _, ranks = results
    want = _serve(_server(None, quantize))
    for r in ranks:
        got = r["serve"][name]
        for case in ("pool", "one"):
            (ga, gr), (wa, wr) = got[case], want[case]
            for f in wa:
                np.testing.assert_array_equal(ga[f], wa[f], err_msg=f"{name} {case} {f}")
            assert sorted(gr) == sorted(wr)
            for k in wr:
                np.testing.assert_allclose(gr[k], wr[k], atol=ATOL, rtol=0,
                                           err_msg=f"{name} {case} {k}")
    if name.startswith("fsdp"):
        # a request holds the whole tensors outside the stacks and one
        # block's share of theirs at a time
        for r in ranks:
            held = r["serve"][name]["held"]
            assert held["shares"] and 0 < held["peak"] <= held["bound"], held
    if name == "fsdp_dp_int8":
        one = _server(None, "int8")
        total = sum(t.numel() for t in one.model.parameters() if t.dtype == torch.int8)
        for r in ranks:
            held = r["serve"][name]["held"]
            assert abs(held["int8"] - total / 2) <= held["chunk"] < total / 2, (held, total)
    if quantize is None and name == "tp_dp":
        for case, obs, pool in (("pool", _observations(3, 1), 4),
                                ("one", _observations(1, 2), None)):
            jax_actions = _jax_server_actions(obs, pool)
            for f, v in ranks[0]["serve"][name][case][0].items():
                np.testing.assert_array_equal(v, np.asarray(jax_actions[f]), err_msg=f)


def test_export_from_a_sharded_server_raises(results):
    _, ranks = results
    assert all("mesh-sharded" in r["export"] for r in ranks)


def test_fsdp_checkpoint_loads_in_jax_and_resumes_bitwise(results):
    from bifold_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
    from bifold_tpu_torch.models.convert import from_jax_variables

    out, ranks = results
    for r in ranks:
        assert sorted(r["full"]) == sorted(r["resumed"])
        for k, v in r["full"].items():
            assert torch.equal(v, r["resumed"][k]), k
    payload = jax_load_checkpoint(out / "runs" / "full" / "checkpoints" / "last.ckpt",
                                  restore_rng=False)
    assert payload["epoch"] == 2 and payload["step"] == 4
    weights = from_jax_variables(_family(FLAGSHIP), payload["params"])
    for k, v in ranks[0]["full"].items():
        np.testing.assert_array_equal(np.asarray(weights[k], np.float32),
                                      v.float().numpy(), err_msg=k)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
