"""The port's Trainer and CLI on the CPU, at the tiny size of
``tests/test_trainer.py`` (SigLIP "tiny" towers, 64 px, dim 64, depth 1).

Resume is held bitwise against an uninterrupted run of the port itself (at
an epoch boundary, after a mid-epoch interrupt, from a ``save_steps``
checkpoint and after a preemption), with the default processor (spatial
augmentation on) and LoRA dropout 0.01, so the per-batch augmentation
generators and the step generator must resume exactly. A checkpoint of the
port is read by the JAX package's ``load_checkpoint`` and served by its
``ServingModel.from_checkpoint`` with the actions the port's server gives
(heatmaps within 1e-4). Gradient accumulation with the non-finite skip is
held against optax.
"""

import json
import pickle
import signal
import shutil

import numpy as np
import yaml
import pytest
import torch

from bifold_tpu_torch import __main__ as cli
from bifold_tpu_torch.config import Config, compose
from bifold_tpu_torch.trainer import Trainer


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads per test: the suite runs several workers at
    once, and torch's default (every core per process) oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


TINY = ("train_dataset=synthetic", "test_dataset=null", "model=siglip",
        "train_dataset.n_samples=16", "train_dataset.image_size=64",
        "model.image_size=64", "model.automodel_name=tiny", "model.dim=64",
        "model.depth=1", "model.heads=4", "model.r=2", "epochs=2", "eval_epochs=2",
        "batch_size=8", "test_batch_size=8", "simulator=null", "log_every=1")


# resume runs: 4 steps of batch 4 per epoch, no eval
RESUME = ("batch_size=4", "eval_epochs=0", "steps_per_dispatch=1")


def tiny_trainer(run_dir, *extra):
    cfg = compose(list(TINY) + [f"run_dir={run_dir}", "use_cpu=true", *extra])
    return Trainer(Config(cfg), run_dir=run_dir)


def _same_weights(a, b):
    pa = dict(a.model.named_parameters())
    for n, p in b.model.named_parameters():
        assert torch.equal(p, pa[n]), n
    for x, y in zip(a.optimizer.mu, b.optimizer.mu):
        assert torch.equal(x, y)
    assert a.optimizer.count == b.optimizer.count
    assert torch.equal(a.key.get_state(), b.key.get_state())


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """4 steps per epoch x 2 epochs, uninterrupted."""
    run = tmp_path_factory.mktemp("straight")
    t = tiny_trainer(run, *RESUME)
    t.prepare_train()
    t.train()
    assert t.global_step == 8
    return t


def test_epoch_resume_bitwise(straight, tmp_path):
    first = tiny_trainer(tmp_path, *RESUME,
                         "epochs=1")
    first.prepare_train()
    first.train()
    second = tiny_trainer(tmp_path, *RESUME)
    second.prepare_train()
    assert second.epoch == 1 and second.global_step == 4
    second.train()
    _same_weights(straight, second)


def test_midepoch_interrupt_resume_bitwise(straight, tmp_path):
    tb = tiny_trainer(tmp_path, *RESUME)
    tb.prepare_train()
    real_step, calls = tb._train_step, {"n": 0}

    def boom(state, batch):
        calls["n"] += 1
        if calls["n"] == 6:
            raise KeyboardInterrupt
        return real_step(state, batch)

    tb._train_step = boom
    with pytest.raises(KeyboardInterrupt):
        tb.train()
    assert tb.global_step == 5
    tc = tiny_trainer(tmp_path, *RESUME)
    tc.prepare_train()
    assert tc.epoch == 1 and tc._resume_step_in_epoch == 1
    assert tc._resume_loop_key is not None
    tc.train()
    assert tc.global_step == 8
    _same_weights(straight, tc)


def test_save_steps_resume_bitwise(straight, tmp_path):
    """save_steps=3 writes a mid-epoch last.ckpt at global step 3; a run
    resumed from that file ends as the uninterrupted run does."""
    ta = tiny_trainer(tmp_path / "a", *RESUME, "save_steps=3")
    ta.prepare_train()
    saved = []
    real_save = ta.save_model

    def keep(name):
        real_save(name)
        if ta.global_step == 3:
            shutil.copytree(ta.ckpt_dir, tmp_path / "b" / "checkpoints")
            saved.append(ta._step_in_epoch)

    ta.save_model = keep
    ta.train()
    assert saved == [3]
    tb = tiny_trainer(tmp_path / "b", *RESUME)
    tb.prepare_train()
    assert (tb.epoch, tb.global_step, tb._resume_step_in_epoch) == (0, 3, 3)
    tb.train()
    _same_weights(straight, tb)


def test_sigterm_flag_preempts_and_resumes(straight, tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    ta = tiny_trainer(tmp_path, *RESUME)
    ta.prepare_train()
    real_step, calls = ta._train_step, {"n": 0}

    def notice(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            ta._terminate = True          # what the SIGTERM handler sets
        return real_step(state, batch)

    ta._train_step = notice
    ta.train()
    assert ta.preempted and ta.global_step == 3 and not ta._terminate
    assert signal.getsignal(signal.SIGTERM) == before
    tb = tiny_trainer(tmp_path, *RESUME)
    tb.prepare_train()
    assert (tb.epoch, tb._resume_step_in_epoch) == (0, 3)
    tb.train()
    assert not tb.preempted
    _same_weights(straight, tb)


@pytest.mark.parametrize("where", ["forward", "update", "after_update"])
def test_interrupt_inside_a_step_resumes_bitwise(straight, tmp_path, where):
    """steps_per_dispatch=3: the interrupt lands inside step 6 (the second
    batch of epoch 1's first group of 3). Before the update the step is taken back (its
    dropout-seed draw too), after it the step counts, and inside it the
    torn state is not written; each resumed run ends as the straight one."""
    tb = tiny_trainer(tmp_path, *RESUME[:-1], "steps_per_dispatch=3")
    tb.prepare_train()
    opt, calls = tb.optimizer, {"n": 0}

    def hit():
        calls["n"] += 1
        if calls["n"] == 6:
            raise KeyboardInterrupt

    if where == "forward":
        real = tb.model.forward
        tb.model.forward = lambda *a, **k: (hit(), real(*a, **k))[1]
    elif where == "update":
        real = opt._direction
        opt._direction = lambda g: (hit(), real(g))[1]
    else:
        real = opt.step
        opt.step = lambda g: (real(g), hit())[0]
    with pytest.raises(KeyboardInterrupt):
        tb.train()
    saved = tb.ckpt_dir / "last.ckpt"
    assert saved.exists() == (where != "update")
    tc = tiny_trainer(tmp_path, *RESUME[:-1], "steps_per_dispatch=3")
    tc.prepare_train()
    assert (tc.global_step, tc._resume_step_in_epoch) == {
        "forward": (5, 1), "update": (0, 0), "after_update": (6, 2)}[where]
    tc.train()
    _same_weights(straight, tc)


def test_steps_per_dispatch_groups_equal_single_steps(straight, tmp_path):
    """k=3 over 4 batches per epoch: batches pulled 3 and then 1 at a time,
    bitwise the k=1 run; async checkpoints and the profiler on."""
    t = tiny_trainer(tmp_path, *RESUME[:-1], "steps_per_dispatch=3",
                     "async_checkpoint=true", "profile_steps=2", "debug=true",
                     "log_every=0")
    t.prepare_train()
    t.train()
    _same_weights(straight, t)
    assert (t.run_dir / "profile" / "trace.json").exists()
    logged = [json.loads(line) for line in
              (t.run_dir / "metrics.jsonl").read_text().splitlines()]
    assert not [r for r in logged if "train/loss" in r]
    assert [r["train/epoch"] for r in logged if "train/epoch" in r] == [0, 1]


def test_port_checkpoint_read_and_served_by_jax(tmp_path):
    import jax

    from bifold_tpu.config import compose as jax_compose
    from bifold_tpu.serving import ServingModel as JaxServingModel
    from bifold_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
    from bifold_tpu_torch.serving import ServingModel

    t = tiny_trainer(tmp_path, "epochs=1", "eval_epochs=1",
                     "processor.spatial_augment=false")
    t.prepare_train()
    t.train()
    path = t.ckpt_dir / "last.ckpt"
    payload = jax_load_checkpoint(path, restore_rng=False)
    assert payload["epoch"] == 1 and payload["step"] == 2
    assert payload["metadata"]["writer"] == "bifold_tpu_torch"
    assert payload["opt_state"]["format"] == "bifold_tpu_torch.optim/1"
    leaves = jax.tree_util.tree_leaves(payload["params"])
    assert len(leaves) == len(jax.tree_util.tree_leaves(t.params_tree()))
    assert all(np.asarray(v).dtype == np.float32 for v in leaves)

    # the JAX package's from_checkpoint builds float32 whatever the config says
    overrides = list(TINY) + ["epochs=1", "processor.spatial_augment=false",
                              "precision.compute_dtype=float32"]
    theirs = JaxServingModel.from_checkpoint(str(path), jax_compose(overrides))
    ours = ServingModel.from_checkpoint(path, compose(overrides), device="cpu")
    rng = np.random.default_rng(0)
    obs = {"rgb": rng.integers(0, 255, (96, 96, 3), dtype=np.uint8),
           "depth": rng.random((96, 96)).astype(np.float32),
           "mask": (rng.random((96, 96)) > 0.5).astype(np.float32),
           "instruction": "fold the towel in half"}
    a, raw_a = theirs.predict(**obs, return_raw_output=True)
    b, raw_b = ours.predict(**obs, return_raw_output=True)
    np.testing.assert_array_equal(a.pick, b.pick)
    np.testing.assert_array_equal(a.place, b.place)
    for k in ("pick_heatmap", "place_heatmap"):
        np.testing.assert_allclose(raw_b[k], np.asarray(raw_a[k]), atol=1e-4)


def test_main_on_the_cpu_writes_the_run_dir(tmp_path):
    """The final eval under simulator=softgym is the closed loop: one trial
    of each task (the caches written first, at the small cloth sizes of
    tests/test_torch_evaluators.py, so the loop is short; nothing is read or
    written outside tmp_path)."""
    from test_torch_evaluators import small_caches

    small_caches(tmp_path / "cache")
    overrides = ["train_dataset=synthetic", "test_dataset=null", "model=siglip",
                 "train_dataset.n_samples=8", "train_dataset.image_size=64",
                 "model.image_size=64", "model.automodel_name=tiny", "model.dim=64",
                 "model.depth=1", "epochs=1", "eval_epochs=1", "batch_size=4",
                 "simulator=softgym", "num_evals=1", f"softgym_cache={tmp_path}/cache",
                 f"run_dir={tmp_path}", "use_cpu=true"]
    assert cli.main(overrides) == 0
    run = tmp_path / cli.run_dir_name(cli.override_dirname(overrides))
    for name in ("config.yaml", "metrics.jsonl", "eval_synthetic.yaml",
                 "checkpoints/best.ckpt", "checkpoints/last.ckpt"):
        assert (run / name).exists(), name
    metrics = yaml.safe_load((run / "eval_synthetic.yaml").read_text())
    assert "average_success" in metrics
    for task in ("CornerFold", "TriangleFold", "StraightFold", "TshirtFold", "TrousersFold"):
        for regime in ("si", "usi", "ut"):
            for key in (f"{task} {regime}", f"error {task} {regime}",
                        f"iou {task} {regime}"):
                assert np.isfinite(metrics[key]), key
    assert sorted(p.name for p in (tmp_path / "cache").iterdir()) == [
        "Rectangular.pkl", "Square.pkl", "Trousers.pkl", "Tshirt.pkl"]
    assert cli.main(["--help"]) == 0
    # a run dir name too long for a file name is shortened, deterministically
    long = cli.override_dirname([f"+k{i}=" + "v" * 40 for i in range(8)])
    assert len(long) > 255
    short = cli.run_dir_name(long)
    assert len(short.encode()) <= 255 and short == cli.run_dir_name(long)
    assert short.startswith(long[:200]) and cli.run_dir_name("model=siglip") == "model=siglip"


@pytest.mark.parametrize("extra, error", [
    # precision.remat trains now (tests/test_torch_remat.py); graph
    # conditioning too (test_graph_config_trains)
    # text_unet trains with a CLIP or a T5 text encoder; a name that is
    # neither raises (TINY's SigLIP keys dropped, so that the model's own
    # refusal is what raises)
    (["model=text_unet", "model.text_encoder=definitely-not-a-model",
      *(f"~model.{k}" for k in ("automodel_name", "dim", "depth", "heads", "r"))],
     ValueError),
    # data and model parallelism train (tests/test_torch_data_parallel.py,
    # tests/test_torch_mesh.py): a dp or tp of 2 in one process is a mesh
    # that does not match the ranks
    (["mesh.dp=2"], ValueError),
    (["mesh.tp=2"], ValueError),
    (["precision.param_dtype=bfloat16"], NotImplementedError),
], ids=lambda v: v[0] if isinstance(v, list) else "")
def test_unported_keys_raise(tmp_path, extra, error):
    with pytest.raises(error):
        tiny_trainer(tmp_path, *extra)


def _cloth_pkl(path, n=16, size=64):
    """A unimanual pkl dataset (the ``single`` schema) whose every scene has
    cloth: depth stored x 255, a third of the pixels below the 0.996 mask
    threshold."""
    rng = np.random.default_rng(0)
    data = {"rgbs": [rng.integers(0, 255, (size, size, 3), dtype=np.uint8) for _ in range(n)],
            "depth": [np.full((size, size), 254.9, np.float32)
                      - 30 * (rng.random((size, size)) > 0.66) for _ in range(n)],
            "pick": [rng.uniform(8, size - 8, 2) for _ in range(n)],
            "place": [rng.uniform(8, size - 8, 2) for _ in range(n)],
            "instruction": [f"fold corner {i}" for i in range(n)]}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def test_graph_config_trains(tmp_path):
    """``model.requires_graph=true`` trains, its batches carrying the
    scenes' graphs (200 nodes at most, 16 edges a node), and the model
    never reads them: the weights end bitwise equal to a run without
    graphs. The scenes are a ``single`` pkl with cloth in each: a graph
    needs cloth (an empty mask raises, in JAX's package too)."""
    pkl = _cloth_pkl(tmp_path / "All_16.pkl")
    runs = {}
    for graph in ("false", "true"):
        t = tiny_trainer(tmp_path / graph, *RESUME, "epochs=1", "train_dataset=single",
                         f"train_dataset.dataset_path={pkl}", "train_dataset.n_samples=16",
                         "train_dataset.image_size=64", f"model.requires_graph={graph}")
        t.prepare_train()
        t.train()
        assert t.global_step == 4
        runs[graph] = t
    batch = next(iter(runs["true"].train_dataloader))
    assert batch["graph_x"].shape == (4, 200, 3)
    assert batch["graph_edge_index"].shape == (4, 2, 3200)
    assert batch["graph_node_mask"].sum() > 0 and batch["pick_node_heatmap"].sum() == 4
    assert "graph_x" not in next(iter(runs["false"].train_dataloader))
    _same_weights(runs["false"], runs["true"])


def test_visualize_model_inputs_writes_pngs(tmp_path):
    """The first train batch's inputs and targets, as JAX's Trainer dumps
    them (bifold_tpu/trainer.py:633-645): 4 samples' rgb, depth and
    heatmaps under input_viz/."""
    from PIL import Image

    trainer = tiny_trainer(tmp_path, "visualize_model_inputs=true", "epochs=1",
                           "eval_epochs=0")
    trainer.prepare_train()
    trainer.train()
    out = tmp_path / "input_viz"
    assert sorted(p.name for p in out.iterdir()) == ["depth", "pick_heatmap",
                                                     "place_heatmap", "rgb"]
    for sub in out.iterdir():
        names = sorted(p.name for p in sub.iterdir())
        assert names == [f"{j}.png" for j in range(4)], sub.name
        assert np.asarray(Image.open(sub / "0.png")).shape == (64, 64, 3)


def test_visualize_predictions_writes_pngs(tmp_path):
    """Each pixel-eval batch's arrows and heatmap overlays under eval_viz/
    (bifold_tpu/trainer.py:718-729)."""
    from PIL import Image

    trainer = tiny_trainer(tmp_path, "visualize_predictions=true")
    batch = next(iter(trainer.test_dataloader))
    trainer.eval_epoch_pixel()
    out = tmp_path / "eval_viz"
    assert sorted(p.name for p in out.iterdir()) == ["pick_heatmap", "place_heatmap",
                                                     "rgb", "viz"]
    n = len(batch["raw_rgb"])
    rgb = np.asarray(Image.open(out / "rgb" / "0000_0.png"))
    np.testing.assert_array_equal(rgb, batch["raw_rgb"][0].numpy())
    viz = np.asarray(Image.open(out / "viz" / "0000_0.png"))
    assert viz.shape == rgb.shape and (viz != rgb).any()     # the arrows
    assert len(list((out / "viz").glob("0000_*.png"))) == n


def test_cli_refuses_advise_and_a_missing_card(tmp_path, monkeypatch):
    # advise is ported (tests/test_torch_advisor.py); the CLI still refuses
    # to train without the card it was not told to do without
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(list(TINY) + [f"run_dir={tmp_path}"])


def _optax_run(optim, sched, params, grads, clip=0.5):
    import jax.numpy as jnp
    import optax

    from bifold_tpu.optim import build_optimizer as jax_build_optimizer

    tx, _ = jax_build_optimizer(dict(optim), sched, max_iters=12, gradient_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    trace = []
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        trace.append({k: np.asarray(v) for k, v in jp.items()})
    return trace


@pytest.mark.parametrize("optim, clip", [
    ({"name": "adam", "lr": 1e-2, "accumulate_steps": 2}, 0.5),
    ({"name": "sgd", "lr": 1e-2, "momentum": 0.9, "accumulate_steps": 3}, None),
], ids=["adam_clip", "sgd_momentum"])
def test_accumulation_matches_optax(optim, clip):
    """accumulate_steps (optax.MultiSteps) over clip + Adam, and over SGD
    with momentum (which, unlike Adam behind a clip, sees the gradients'
    scale), with the linear-warmup schedule: every micro-step's parameters
    equal optax's."""
    from bifold_tpu_torch.optim import build_optimizer

    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(12)]
    sched = {"name": "linear_warmup", "warmup_portion": 0.25}
    want = _optax_run(optim, sched, params, grads, clip)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = build_optimizer(dict(optim), tp, sched, max_iters=12, gradient_clip=clip,
                          names=["a", "b"])
    for i, g in enumerate(grads):
        opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
        for k, t in zip(("a", "b"), tp):
            np.testing.assert_allclose(t.numpy(), want[i][k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"micro-step {i} {k}")
    k = optim["accumulate_steps"]
    assert (opt.count, opt.mini_step) == (12 // k, 0)
    restored = build_optimizer(dict(optim), [t.clone() for t in tp], sched, max_iters=12,
                               gradient_clip=clip, names=["a", "b"])
    restored.load_state_dict(opt.state_dict())
    assert restored.state_dict().keys() == opt.state_dict().keys()
    moments = ("mu", "nu") if optim["name"] == "adam" else ("trace",)
    for key in moments:
        assert all(torch.equal(x, y) for x, y in zip(getattr(restored, key),
                                                     getattr(opt, key)))


def test_accumulation_skips_a_nonfinite_micro_batch():
    """With skip_nonfinite=1, a micro-batch with a NaN spoils only its own
    update, which is skipped: the run ends as optax's run without that
    update's two micro-batches. (optax itself keeps the NaN in MultiSteps'
    accumulator, 0 x NaN, and ends with NaN parameters: shown here too.)"""
    from bifold_tpu_torch.optim import build_optimizer

    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(12)]
    grads[4]["a"][0, 0] = np.nan
    optim = {"name": "adam", "lr": 1e-2, "accumulate_steps": 2, "skip_nonfinite": 1}
    sched = {"name": "linear_warmup", "warmup_portion": 0.25}
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = build_optimizer(dict(optim), tp, sched, max_iters=12, gradient_clip=0.5,
                          names=["a", "b"])
    for g in grads:
        opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
    assert (opt.count, opt.total_notfinite, opt.notfinite_count) == (5, 1, 0)
    want = _optax_run(optim, sched, params, grads[:4] + grads[6:])[-1]
    for k, t in zip(("a", "b"), tp):
        np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert np.isnan(_optax_run(optim, sched, params, grads)[-1]["a"]).all()
