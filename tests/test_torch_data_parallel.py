"""Data parallelism of the port over ``torch.distributed``, on the CPU.

Two gloo ranks are spawned once for the module: this file runs itself as a
worker (``python tests/test_torch_data_parallel.py RANK PORT OUT``), joins
the group through ``parallel.distributed_init`` and writes what each
scenario gives to ``OUT/rank<RANK>.pt``; each worker's ``communicate`` has
its own 120 s timeout, so a hang fails this module's tests and not the
suite's clock. The test process computes the one-process reference on the
global batch with the same code and seeds.

Held:
- one f32 SGD step of a tiny flagship (SiglipSequential, SigLIP "tiny"
  towers, 2 context frames, dropout 0) over 2 ranks equal to the
  one-process step on the global batch within 1e-5 (loss, per-head terms,
  gradient norm, every trainable tensor), with a mean-reduced loss
  (``bce_gaussmap``) and with ``composed_dice_focal`` (40 x bce_gaussmap +
  20 x focal + 1 x dice; focal and dice sum over the batch), and both
  ranks' parameters bitwise equal (a hash);
- ``text_unet``'s BatchNorm: the train-mode statistics are the global
  batch's, so the moved running statistics equal the one-process step's
  within 1e-6, and its step within 1e-5;
- the loader's process slices partition each global batch in order, and
  with spatial augmentation on each slice is the slice of the batch one
  process builds (the global batch's draws, cut to the slice);
- a Trainer over the group: only rank 0 writes checkpoints (the other rank
  calls no writer), the JAX package's ``load_checkpoint`` reads the file
  and its Trainer loads the weights and counters from it; the weights
  after two steps equal a one-process Trainer's within 1e-5, and the pixel
  metrics, summed over the ranks as sums and counts, equal a one-process
  eval of the same weights;
- ``distributed_init`` is a no-op without an environment, and
  ``check_mesh`` takes fsdp, tp, pp, sp and ep (tests/test_torch_mesh.py
  and tests/test_torch_mesh_axes.py run them) and MoE over data ranks,
  refuses a mesh that does not match the ranks, and a stack whose depth pp
  does not divide stays off the pipe, as JAX's does.
"""

import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bifold_tpu_torch import parallel
from bifold_tpu_torch.config import Config, compose
from bifold_tpu_torch.data import DataLoader, build_dataset, collate
from bifold_tpu_torch.losses import build_loss
from bifold_tpu_torch.models import build_model, trainable_mask
from bifold_tpu_torch.models.backbones import clip_backbone as pcb
from bifold_tpu_torch.optim import build_optimizer

HERE = Path(__file__).resolve().parent
WORLD = 2
TIMEOUT_S = 120
STEP_ATOL = 1e-5
STATS_ATOL = 1e-6
METRIC_RTOL = 1e-6

FLAGSHIP = ("model=siglip_sequential", "model.automodel_name=tiny", "model.dim=64",
            "model.depth=1", "model.heads=4", "model.r=2", "model.lora_dropout=0",
            "train_dataset=synthetic", "train_dataset.image_size=64",
            "train_dataset.is_bimanual=true", "train_dataset.max_context_length=2",
            "train_dataset.n_samples=8", "test_dataset=null",
            "precision.compute_dtype=float32", "simulator=null")
UNET = ("model=text_unet", "model.features=[8,16,32]", "train_dataset=synthetic",
        "train_dataset.image_size=64", "train_dataset.is_bimanual=true",
        "train_dataset.n_samples=8", "test_dataset=null",
        "precision.compute_dtype=float32", "simulator=null")
TINY_TEXT = dict(text_width=32, text_layers=2, text_heads=4, context_length=77,
                 vocab_size=49408, embed_dim=64)
SGD = {"name": "sgd", "lr": 0.5, "momentum": 0.0, "nesterov": False}
GLOBAL_BATCH = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tiny_clip():
    pcb.CLIP_TEXT_CONFIGS["RN50"] = pcb.ClipConfig(**TINY_TEXT)


def _global_batch(cfg):
    """The first global batch of the train partition, processed on the CPU
    with a seeded generator."""
    ds = build_dataset(cfg["train_dataset"], cfg["processor"], partition="train",
                       autoprocessor_name=dict(cfg["model"]).get("automodel_name"), seed=5)
    batch = collate([ds[i] for i in range(GLOBAL_BATCH)])
    gen = torch.Generator().manual_seed(11)
    out = ds.processor.process_batch(batch, "cpu", generator=gen)
    return {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}


def _mask_alias(loss_fn):
    """``composed_dice_focal`` on a model without a mask head: its left
    pick heatmap stands in for ``mask_heatmap``."""
    def fn(out, sample, batch_share=1.0):
        return loss_fn({**out, "mask_heatmap": out["left_pick_heatmap"]}, sample,
                       batch_share=batch_share)
    return fn


def _loss(cfg, name):
    if name == "composed_dice_focal":
        node = dict(compose([f"loss={name}", "train_dataset.is_bimanual=true"])["loss"])
        return _mask_alias(build_loss(node))
    return build_loss(dict(cfg["loss"]))


def _param_hash(model) -> str:
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _step(overrides, loss_name, shard):
    """One SGD step from the seeded init on the global batch, or on this
    rank's slice of it (``shard``): metrics, trainable tensors, buffers."""
    cfg = compose(list(overrides))
    batch = _global_batch(cfg)
    if shard:
        batch = parallel.shard_batch(batch)
    model = build_model(dict(cfg["model"]), device="cpu", seed=3)
    mask = trainable_mask(model, lora=True)
    opt = build_optimizer(dict(SGD), [p for p in model.parameters() if p.requires_grad],
                          max_iters=10, gradient_clip=1.0)
    step = parallel.make_train_step(model, _loss(cfg, loss_name), opt)
    _, metrics = step(parallel.TrainState.create(opt), batch)
    state = model.state_dict()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "trainable": {n: state[n].clone() for n, t in mask.items() if t},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "hash": _param_hash(model)}


def _loader_batches(shard, count):
    cfg = compose(list(FLAGSHIP))
    ds = build_dataset(cfg["train_dataset"], cfg["processor"], partition="train",
                       autoprocessor_name="tiny", seed=5)
    loader = DataLoader(ds, batch_size=GLOBAL_BATCH, shuffle=True, seed=5,
                        process_id=shard, process_count=count)
    loader.set_epoch(1)
    return [{k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
            for batch in loader]


def _indices(shard, count):
    class _DS:
        processor = None

        def __len__(self):
            return 13

    loader = DataLoader(_DS(), batch_size=GLOBAL_BATCH, shuffle=True, seed=5,
                        process_id=shard, process_count=count)
    return [list(map(int, idx)) for _, idx in loader.index_batches()]


def _trainer_overrides(run_dir):
    return [*FLAGSHIP, "optim=sgd", "optim.lr=0.5", "gradient_clip=1.0",
            f"batch_size={GLOBAL_BATCH}", f"test_batch_size={GLOBAL_BATCH}", "epochs=1",
            "eval_epochs=1", "steps_per_dispatch=1", "log_every=1",
            f"run_dir={run_dir}", "use_cpu=true"]


def _trainer(run_dir):
    from bifold_tpu_torch.trainer import Trainer

    return Trainer(Config(compose(_trainer_overrides(run_dir))), run_dir=run_dir)


def _worker(rank, port, out):
    """One rank: every scenario, its results saved for the test process."""
    torch.set_num_threads(1)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        os.environ.pop(var, None)
    assert parallel.distributed_init(f"tcp://localhost:{port}", WORLD, rank, device="cpu")
    assert parallel.distributed_init() and parallel.world_size() == WORLD
    _tiny_clip()
    res = {"rank": rank,
           "flagship_bce": _step(FLAGSHIP, "bce_gaussmap", True),
           "flagship_composed": _step(FLAGSHIP, "composed_dice_focal", True),
           "unet": _step(UNET, "bce_gaussmap", True),
           "indices": _indices(rank, WORLD),
           "loader": _loader_batches(rank, WORLD)}

    from bifold_tpu_torch import trainer as trainer_mod
    writes = []
    real = trainer_mod.save_checkpoint
    trainer_mod.save_checkpoint = lambda *a, **k: (writes.append(str(a[0])), real(*a, **k))
    t = _trainer(Path(out) / "run")
    t.prepare_train()
    t.train()
    res["writes"] = writes
    res["trainer_hash"] = _param_hash(t.model)
    res["trainer_state"] = {k: v.clone() for k, v in t.model.state_dict().items()}
    res["eval"] = t.eval_epoch_pixel()[1]
    torch.save(res, Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "ok": True}))


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(HERE.parent),
                                                      env.get("PYTHONPATH")]))
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(r),
                               str(port), str(out)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=str(HERE.parent),
                              env=env) for r in range(WORLD)]
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
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def tiny_clip():
    saved = pcb.CLIP_TEXT_CONFIGS["RN50"]
    _tiny_clip()
    yield
    pcb.CLIP_TEXT_CONFIGS["RN50"] = saved


def _close(got, want, atol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=0,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("scenario, overrides, loss", [
    ("flagship_bce", FLAGSHIP, "bce_gaussmap"),
    ("flagship_composed", FLAGSHIP, "composed_dice_focal"),
    ("unet", UNET, "bce_gaussmap")], ids=["bce_gaussmap", "composed_dice_focal", "text_unet"])
def test_step_equals_the_global_batch_step(ranks, tiny_clip, scenario, overrides, loss):
    _, results = ranks
    want = _step(overrides, loss, shard=False)
    for r in results:
        got = r[scenario]
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=STEP_ATOL, err_msg=k)
        _close(got["trainable"], want["trainable"], STEP_ATOL, scenario)
        _close(got["buffers"], want["buffers"], STATS_ATOL, scenario)
    assert results[0][scenario]["hash"] == results[1][scenario]["hash"]
    if scenario == "unet":
        moved = [k for k, v in want["buffers"].items()
                 if k.endswith("running_mean") and float(v.abs().max()) > 0]
        assert len(moved) == len(want["buffers"]) // 2


def test_loader_slices_partition_each_global_batch(ranks):
    _, (a, b) = ranks
    full = _indices(0, 1)
    assert len(a["indices"]) == len(b["indices"]) == 13 // GLOBAL_BATCH
    for f, x, y in zip(full, a["indices"], b["indices"]):
        assert f == x + y and len(x) == len(y) == GLOBAL_BATCH // WORLD
    one = _loader_batches(0, 1)
    assert len(one) == len(a["loader"]) == len(b["loader"]) == 2
    for f, x, y in zip(one, a["loader"], b["loader"]):
        assert sorted(f) == sorted(x) == sorted(y)
        for k in f:
            np.testing.assert_allclose(torch.cat([x[k], y[k]]).float().numpy(),
                                       f[k].float().numpy(), atol=1e-6, rtol=0, err_msg=k)
    with pytest.raises(ValueError, match="divisible"):
        DataLoader(type("D", (), {"processor": None})(), batch_size=3,
                   process_id=0, process_count=2)


def test_rank_zero_writes_checkpoints_the_jax_trainer_reads(ranks, tmp_path):
    import jax

    from bifold_tpu.config import Config as JaxConfig
    from bifold_tpu.config import compose as jax_compose
    from bifold_tpu.trainer import Trainer as JaxTrainer
    from bifold_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
    from bifold_tpu_torch.models.convert import convert_bifold_inverse

    out, (a, b) = ranks
    assert a["writes"] and not b["writes"]
    assert {Path(w).name for w in a["writes"]} == {"best.ckpt", "last.ckpt"}
    assert a["trainer_hash"] == b["trainer_hash"]
    run = tmp_path / "run"
    shutil.copytree(out / "run", run)
    payload = jax_load_checkpoint(run / "checkpoints" / "last.ckpt", restore_rng=False)
    assert payload["epoch"] == 1 and payload["step"] == 2
    overrides = [o for o in _trainer_overrides(run) if o != "use_cpu=true"]
    jt = JaxTrainer(JaxConfig(jax_compose(overrides)), run_dir=run)
    # the weights and counters (the port's optimizer state is its own)
    assert jt.load_model(prefer="last")
    assert jt.epoch == 1 and jt.global_step == 2
    resumed = convert_bifold_inverse(jax.tree_util.tree_map(np.asarray, jt.params))
    for k, v in a["trainer_state"].items():
        np.testing.assert_array_equal(np.asarray(resumed[k], np.float32), v.numpy(),
                                      err_msg=k)


def test_trainer_weights_and_global_eval_metrics(ranks, tmp_path):
    out, (a, b) = ranks
    np.testing.assert_equal(a["eval"], b["eval"])        # NaN (no mask head) included
    one = _trainer(tmp_path / "one")
    one.prepare_train()
    one.train()
    state = one.model.state_dict()
    for k, v in a["trainer_state"].items():
        np.testing.assert_allclose(v.numpy(), state[k].numpy(), atol=STEP_ATOL, rtol=0,
                                   err_msg=k)
    # the one-process eval of the dp run's own weights
    same = _trainer(tmp_path / "same")
    same.model.load_state_dict(a["trainer_state"], strict=True)
    want = same.eval_epoch_pixel()[1]
    assert sorted(want) == sorted(a["eval"])
    for k, v in want.items():
        if np.isnan(v):
            assert np.isnan(a["eval"][k]), k
        else:
            np.testing.assert_allclose(a["eval"][k], v, rtol=METRIC_RTOL, err_msg=k)


def test_distributed_init_is_a_no_op_without_an_environment(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.distributed_init() is False
    assert not torch.distributed.is_initialized()
    assert parallel.world_size() == 1 and parallel.rank() == 0
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="all three"):
        parallel.distributed_init()


@pytest.mark.parametrize("axis, step", [
    ("fsdp", "fsdp/tp"), ("tp", "fsdp/tp"), ("pp", "pipeline"), ("sp", "ring attention"),
    ("ep", "expert parallelism")])
def test_check_mesh_refuses_what_is_not_ported(axis, step):
    # every axis is ported (tests/test_torch_mesh.py, tests/test_torch_mesh_axes.py):
    # taken, and refused only where it does not divide the ranks; MoE runs
    # under every axis, data axes included
    assert parallel.check_mesh({axis: 2}, world=4) == 4
    with pytest.raises(ValueError, match="ranks"):
        parallel.check_mesh({axis: 3}, world=4)
    assert parallel.check_mesh({"dp": -1}, world=2) == 2
    if step == "pipeline":
        # a depth pp does not divide, or of 1, stays off the pipe, as in JAX
        from bifold_tpu_torch.models.layers import Transformer
        from bifold_tpu_torch.parallel.sharding import pipelined

        stacks = torch.nn.ModuleDict({f"d{d}": Transformer(16, d, 2, 32) for d in (1, 3, 4)})
        assert pipelined(stacks, 2) == {"d4": 4}
    if step == "expert parallelism":
        # experts that ep does not divide stay whole, as JAX's rule leaves them
        from bifold_tpu_torch.parallel.sharding import make_plan

        for experts, cut in ((3, False), (4, True)):
            model = build_model(dict(compose([
                "model=siglip", "model.automodel_name=tiny", "model.dim=64",
                "model.depth=1", "model.heads=4", f"model.moe_experts={experts}"])["model"]),
                device="cpu", seed=0)
            plan = make_plan(model, "siglip", {"ep": 2})
            assert bool(plan.ep) is cut and all(n.endswith(("w1", "b1", "w2", "b2"))
                                               for n in plan.ep)


def test_check_mesh_takes_the_data_axes(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert parallel.check_mesh({"dp": -1, "pp_microbatches": 0}, world=1) == 1
    assert parallel.check_mesh({"dcn": 1, "dp": -1}, world=4) == 4
    assert parallel.check_mesh({"dcn": 2, "dp": 2}, world=4) == 4
    assert parallel.check_mesh({"dcn": 1, "dp": 1}, world=1) == 1
    for mesh, world in (({"dp": 2}, 1), ({"dcn": 3, "dp": -1}, 4), ({"dcn": 2, "dp": 3}, 4)):
        with pytest.raises(ValueError):
            parallel.check_mesh(mesh, world=world)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="straddle"):
        parallel.check_mesh({"dcn": 4, "dp": 2}, world=8)
    assert parallel.check_mesh({"dcn": 2, "dp": -1}, world=8) == 8
    with pytest.raises(KeyError):
        parallel.check_mesh({"dq": 2}, world=1)


def test_shard_batch_slices_and_refuses_a_ragged_batch():
    batch = {"x": torch.arange(8).reshape(4, 2), "y": np.arange(4),
             "raw_instruction": ["a", "b", "c", "d"], "label_keys": ("pick",)}
    got = parallel.shard_batch(batch, shard=1, shards=2)
    assert got["x"].tolist() == [[4, 5], [6, 7]] and got["y"].tolist() == [2, 3]
    assert got["raw_instruction"] is batch["raw_instruction"]
    assert got["label_keys"] == ("pick",)
    assert parallel.shard_batch(batch)["x"] is not None      # one rank: the whole batch
    with pytest.raises(ValueError, match="must be divisible by the 3 data-axis shards"):
        parallel.shard_batch(batch, shard=0, shards=3)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
