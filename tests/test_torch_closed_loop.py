"""The closed loop with a model in it: the port's policies against the JAX
package's, in float32 on the CPU.

A tiny SiglipSequential (SigLIP "tiny" towers, 64 px, dim 64, depth 1, 3
context frames), unimanual and bimanual, is initialised by the JAX
package's Trainer and loaded into the port's Trainer through
``convert_bifold_inverse``. Each package then runs the same loops, both on
the native simulator core in the cheap env of tests/test_parallel_eval.py
(64 px, substeps 2, iterations 6), over the caches of
tests/test_torch_evaluators.py:

- the ``get_action`` route (host-processed samples through the Trainer's
  ``get_action``): the sequential evaluator;
- the ``eval_serving_policy`` route (``ServingPolicy`` over the Trainer's
  served model, float16 depth on the wire, preprocessing on the device):
  the parallel pool of 2;

unimanual over TriangleFold (one trial, 3 regimes), bimanual over a replay
of 3 samples. Held: the same policy calls with pixel-identical actions at
every step, heatmaps within 1e-4, and summaries equal to rtol 1e-9. Each
model kind's loops run once per run (under pytest-xdist the first worker
that needs them runs them and the others read their records,
tests/_once_per_run.py).

Under ``dp=2`` (two gloo ranks, this file run as a worker: ``python
tests/test_torch_closed_loop.py RANK PORT OUT``) every rank runs the
bimanual loops with the same weights; each rank's summaries equal one
process's.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from bifold_tpu_torch import parallel
from bifold_tpu_torch.config import Config, compose
from bifold_tpu_torch.env import bimanual_evaluator as port_bim
from bifold_tpu_torch.env import softgym_evaluator as port_eval
from bifold_tpu_torch.trainer import Trainer

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from _once_per_run import once_per_run  # noqa: E402
from test_torch_evaluators import (bimanual_cache, install_cheap_envs,  # noqa: E402
                                   same_summary, small_caches)

HEATMAP_TOL = 1e-4
WORLD = 2
TIMEOUT_S = 240
POOL = 2


def overrides(run_dir, cache, bimanual):
    return ["train_dataset=synthetic", "test_dataset=null", "model=siglip_sequential",
            "train_dataset.n_samples=4", "train_dataset.image_size=64",
            f"train_dataset.is_bimanual={str(bimanual).lower()}",
            "train_dataset.max_context_length=3", "model.automodel_name=tiny",
            "model.dim=64", "model.depth=1", "model.heads=4", "model.r=2",
            "batch_size=2", "test_batch_size=2", "simulator=softgym",
            f"softgym_cache={cache}", "num_evals=1", "eval_parallel_envs=2",
            "precision.compute_dtype=float32", "processor.spatial_augment=false",
            f"run_dir={run_dir}"]


class Recorder:
    """A closed-loop policy that records every call's actions and heatmaps:
    the ``get_action`` route (``trainer``), or ``ServingPolicy``'s call
    with the raw outputs kept (``server``)."""

    def __init__(self, trainer=None, server=None):
        self.trainer, self.server, self.calls = trainer, server, []
        self.wants_raw = server is not None

    def __call__(self, obs, pad_to=None):
        if self.server is None:
            action, raw = self.trainer.get_action(obs, return_raw_output=True)
        elif isinstance(obs, (list, tuple)):
            action, raw = self.server.predict_batch(list(obs), pad_to=pad_to,
                                                    return_raw_output=True)
        else:
            action, raw = self.server.predict(**obs, return_raw_output=True)
        self.calls.append(({k: np.asarray(v) for k, v in action.fields()},
                           {k: np.asarray(v) for k, v in raw.items()
                            if k.endswith("_heatmap")}))
        return action, None


def run_loops(trainer, serving_model, bimanual, cache, run_dir):
    """The two routes' loops on one package; (summaries, recorders)."""
    eval_mod, bim_mod = port_eval, port_bim
    if type(trainer).__module__.startswith("bifold_tpu."):
        from bifold_tpu.env import bimanual_evaluator as bim_mod
        from bifold_tpu.env import softgym_evaluator as eval_mod
    from bifold_tpu.env import cloth_env as jax_env
    from bifold_tpu_torch.env import cloth_env as port_env

    env_mod = port_env if eval_mod is port_eval else jax_env
    routes = {"get_action": Recorder(trainer=trainer),
              "serving": Recorder(server=serving_model)}
    summaries = {}
    for name, policy in routes.items():
        pool = POOL if name == "serving" else None
        kwargs = {"pool": pool} if pool else {}
        if bimanual:
            cls = (bim_mod.SoftgymBimanualParallelEvaluator if pool
                   else bim_mod.SoftgymBimanualEvaluator)
        else:
            cls = (eval_mod.SoftgymParallelEvaluator if pool
                   else eval_mod.SoftgymSingleEvaluator)
        ev = cls(cache_dir=str(cache), policy=policy, processor=trainer.processor,
                 image_size=64, **kwargs)
        install_cheap_envs(ev, env_mod, pool)
        if bimanual:
            ev.evaluate(samples=bimanual_cache(Path(cache), 3))
        else:
            import random
            random.seed(0)           # JAX's draws; the port's come from seed
            ev.evaluate(num_evals=1, task="TriangleFold", seed=0)
        summaries[name] = ev.summary()
        ev.close()
    return summaries, routes


def port_trainer(run_dir, cache, bimanual, state, extra=()):
    trainer = Trainer(Config(compose(overrides(run_dir, cache, bimanual)
                                     + ["use_cpu=true", *extra])), run_dir=run_dir)
    trainer.model.load_state_dict(state, strict=True)
    return trainer


_PAIRS = {}


def _compute_pair(bimanual, root):
    """Both packages' loops into ``root``: the caches, the port's weights
    (``state.pt``) and each package's summaries and recorded calls
    (``loops.pkl``)."""
    from bifold_tpu.config import Config as JaxConfig
    from bifold_tpu.config import compose as jax_compose
    from bifold_tpu.serving import ServingModel as JaxServingModel
    from bifold_tpu.trainer import Trainer as JaxTrainer
    from bifold_tpu_torch.models.convert import convert_bifold_inverse

    cache = small_caches(root / "cache")
    jt = JaxTrainer(JaxConfig(jax_compose(overrides(root / "jax", cache, bimanual))),
                    run_dir=root / "jax")
    params = jax.tree_util.tree_map(np.asarray, jt.params)
    state = {k: torch.from_numpy(np.array(v))
             for k, v in convert_bifold_inverse(params).items()}
    pt = port_trainer(root / "port", cache, bimanual, state)
    jax_server = JaxServingModel(jt.model, {"params": jt.params, **(jt.extra_vars or {})},
                                 jt.processor, depth_wire_dtype="float16")
    got = run_loops(pt, pt.serving_model(depth_wire_dtype="float16"), bimanual,
                    cache, root / "port")
    want = run_loops(jt, jax_server, bimanual, cache, root / "jax")
    torch.save(state, root / "state.pt")
    with open(root / "loops.pkl", "wb") as f:
        pickle.dump({name: (summaries, {route: rec.calls for route, rec in routes.items()})
                     for name, (summaries, routes) in (("got", got), ("want", want))}, f)


def loop_pair(bimanual, tmp_path_factory):
    """Both packages' loops: computed once per run and model kind
    (tests/_once_per_run.py), read once per process. Returns (cache dir,
    the port's weights, (summaries, recorders) of the port, of JAX); a
    recorder here holds only its ``calls``."""
    if bimanual in _PAIRS:
        return _PAIRS[bimanual]
    root = once_per_run(tmp_path_factory,
                        f"closed_loop_{'bimanual' if bimanual else 'unimanual'}",
                        lambda out: _compute_pair(bimanual, out))
    with open(root / "loops.pkl", "rb") as f:
        loops = pickle.load(f)
    got, want = ((summaries, {route: types.SimpleNamespace(calls=calls)
                              for route, calls in recorded.items()})
                 for summaries, recorded in (loops["got"], loops["want"]))
    _PAIRS[bimanual] = (root / "cache", torch.load(root / "state.pt"), got, want)
    return _PAIRS[bimanual]


@pytest.mark.parametrize("bimanual", [False, True], ids=["unimanual", "bimanual"])
@pytest.mark.parametrize("route", ["get_action", "serving"])
def test_closed_loop_matches_jax(bimanual, route, tmp_path_factory):
    _, _, (got, got_rec), (want, want_rec) = loop_pair(bimanual, tmp_path_factory)
    a, b = got_rec[route].calls, want_rec[route].calls
    assert len(a) == len(b) > 0
    if route == "serving" and bimanual:      # 3 samples over a pool of 2
        assert [len(acts["left_pick"]) for acts, _ in a] == [2, 1]
    for (acts_a, heat_a), (acts_b, heat_b) in zip(a, b):
        assert acts_a.keys() == acts_b.keys()
        for k in acts_a:
            np.testing.assert_array_equal(acts_a[k], acts_b[k], err_msg=k)
        assert heat_a.keys() == heat_b.keys() and heat_a
        for k in heat_a:
            np.testing.assert_allclose(heat_a[k], heat_b[k], atol=HEATMAP_TOL, rtol=0,
                                       err_msg=k)
    same_summary(want[route], got[route])
    key = "Tshirt" if bimanual else "TriangleFold si"
    assert key in got[route] and np.isfinite(got[route][f"error {key}"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, port, out):
    torch.set_num_threads(1)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        os.environ.pop(var, None)
    assert parallel.distributed_init(f"tcp://localhost:{port}", WORLD, rank, device="cpu")
    out = Path(out)
    state = torch.load(out / "state.pt")
    trainer = port_trainer(out / f"run{rank}", out / "cache", True, state)
    assert trainer.world == WORLD and trainer.mesh.data_size == WORLD
    summaries, _ = run_loops(trainer, trainer.serving_model(depth_wire_dtype="float16"),
                             True, out / "cache", out / f"run{rank}")
    (out / f"rank{rank}.json").write_text(json.dumps(summaries))
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "ok": True}))


def test_two_ranks_equal_one_process(tmp_path, tmp_path_factory):
    import shutil

    cache, state, (got, _), _ = loop_pair(True, tmp_path_factory)
    shutil.copytree(cache, tmp_path / "cache")
    torch.save(state, tmp_path / "state.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(HERE.parent), env.get("PYTHONPATH")]))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(r), str(port),
                               str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=str(HERE.parent), env=env) for r in range(WORLD)]
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
    for r in range(WORLD):
        ranked = json.loads((tmp_path / f"rank{r}.json").read_text())
        for route in ("get_action", "serving"):
            same_summary(got[route], ranked[route])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
