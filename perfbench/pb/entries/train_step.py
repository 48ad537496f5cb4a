"""Driver of a train cell: ``Processor.process_batch`` then the step of
``parallel.make_train_step``, back to back.

Set-up builds one train step object from the configuration as
``python -m bifold_tpu_torch`` composes it (the model at its compute dtype,
frozen towers but their LoRA adapters, frozen weights precast, the
optimizer over the float32 trainable leaves, the loss), loads the
benchmark's seeded weights into it, and drives it through its first
``check_steps`` steps on distinct batches with the window's own call and
feed; the first step's head logits (read off the model's forward), its
gradient (from Adam's first moment) and the leaves after the last checked
step are kept for the check. One more step warms
up, then the window runs steps for ``seconds`` with the host synchronising
at its edges only (``--trace 1``: the cell's ``trace_steps`` steps under the
profiler instead). After the window the program is freed and the
reference follows the checked steps (``reference/train_steps.py``).

``fault`` plants one of the faults the check has to catch (tests and
``tools/calibrate.py`` only): ``"unchanged"`` (the optimizer leaves the
state as it was), ``"half_batch"`` (the step sees the first half of each
batch only), ``"altered"`` (one sample's answer garbage where the model
produces it: every head's logits of the first sample set to 8).
"""

from __future__ import annotations

import contextlib
import time

import torch

from pb import check, trace, traffic, weights, work
from pb import device as device_
from pb.cells import reference

REFERENCE_BLOCK = 4      # samples per reference forward and backward


def _fixture_spm(cfg):
    if cfg.get("autoprocessor_name") is None:
        return None
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    return fixture_model_bytes()


def _kept(cfg, raw) -> int:
    mask = cfg.get("key_mask")
    if not mask:
        return 0
    return int(sum(mask["base"] + mask["per_context_frame"] * int(c) for c in raw["ctx_count"]))


def _plant(fault, model, opt):
    if fault is None:
        return lambda sample: sample
    if fault == "unchanged":
        opt.step = lambda grads: None
        return lambda sample: sample
    if fault == "half_batch":
        def half(sample):
            b = sample["rgb"].shape[0]
            return {k: (v[: b // 2] if torch.is_tensor(v) and v.dim() and v.shape[0] == b else v)
                    for k, v in sample.items()}
        return half
    if fault == "altered":
        inner = model.forward

        def forward(sample):
            out = dict(inner(sample))
            for key in [k for k in out if k.endswith("_logits")]:
                garbage = out[key].clone()
                garbage[0] = 8.0
                out[key] = garbage
                out[key.replace("_logits", "_heatmap")] = torch.sigmoid(garbage)
            return out
        model.forward = forward
        return lambda sample: sample
    raise ValueError(f"unknown fault {fault!r}")


def _change_norms(named, w0) -> dict:
    return {n: float((p.detach().float().cpu() - w0[n].float()).norm()) for n, p in named}


@contextlib.contextmanager
def _first_logits(model):
    """Keeps each head's logits of the model's forward while open (float32,
    on the host, by head name), reading what the step's own call produced."""
    kept = {}
    had = "forward" in model.__dict__
    inner = model.forward

    def forward(sample):
        out = inner(sample)
        kept.update({k[:-len("_logits")]: v.detach().float().cpu()
                     for k, v in out.items() if k.endswith("_logits")})
        return out
    model.forward = forward
    try:
        yield kept
    finally:
        if had:
            model.forward = inner
        else:
            del model.forward


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        fault=None) -> dict:
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.losses import build_loss
    from bifold_tpu_torch.models import build_model, precast_frozen, trainable_mask
    from bifold_tpu_torch.ops import flash_attention as fa
    from bifold_tpu_torch.optim import build_optimizer
    from bifold_tpu_torch.parallel import TrainState, make_train_step

    cfg, mix = cell["config_data"], cell["traffic_data"]
    tcfg = cfg["train"]
    dtype = getattr(torch, tcfg["compute_dtype"])
    ref = reference(cell["config"])
    w0 = weights.make(ref.param_shapes(cfg), cfg["init"], traffic.sub_seed(seed, "weights"),
                      device)
    w0 = {n: t.cpu() for n, t in w0.items()}       # the reference's copy, off the card
    batches = traffic.train_batches(mix, cfg, seed, device)
    device_.reset_peak(device)                     # the peak is the program's from here
    model = build_model(cfg["model"], dtype=dtype, device=device, seed=None)
    model.load_state_dict(w0, strict=True)
    trainable_mask(model, lora=bool(cfg["model"].get("lora", False)))
    if tcfg.get("precast_frozen", True):
        precast_frozen(model, dtype)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    opt = build_optimizer(dict(tcfg["optim"]), [p for _, p in named], tcfg.get("scheduler"),
                          max_iters=10 ** 6, gradient_clip=tcfg.get("gradient_clip"),
                          names=[n for n, _ in named])
    step = make_train_step(model, build_loss(dict(tcfg["loss"])), opt)
    dropout_seed = traffic.sub_seed(seed, "dropout")
    state = TrainState.create(opt, seed=dropout_seed)
    proc = Processor(cfg["processor"], partition="train",
                     max_context_length=cfg.get("max_context_length"),
                     autoprocessor_name=cfg.get("autoprocessor_name"),
                     spm_asset=_fixture_spm(cfg), seed=0)
    plant = _plant(fault, model, opt)
    losses = []

    def one(i):
        nonlocal state
        raw, draws = batches[i % len(batches)]
        sample = plant(proc.process_batch(raw, device, draws=draws))
        state, metrics = step(state, sample)
        return metrics

    checks = int(cell["check_steps"])
    grad1 = None
    for i in range(checks):
        if i == 0:
            with _first_logits(model) as logits1:
                losses.append(one(i)["loss"])
        else:
            losses.append(one(i)["loss"])
        if i == 0:          # the first gradient as Adam took it, from its first moment
            b1 = float(tcfg["optim"]["betas"][0])
            grad1 = {n: (mu.float() / (1 - b1)).cpu() for n, mu in zip(opt.names, opt.mu)}
            after1 = _change_norms(named, w0)
    after = _change_norms(named, w0)
    losses = [float(x) for x in losses]
    one(checks)                                     # warm-up beyond the checked steps
    device_.sync(device)
    record = {"kind": "train", "config": cell["config"], "setup_s": time.perf_counter() - t0}
    n_steps, ctx_counts, kept = 0, [], []
    if traced:
        fa.SHAPES.clear()
        steps = int(cell["trace_steps"])
        with trace.traced(device) as holder:
            for i in range(steps):
                one(checks + 1 + i)
        for i in range(steps):
            raw = batches[(checks + 1 + i) % len(batches)][0]
            ctx_counts += list(raw.get("ctx_count", [0] * int(mix["batch"])))
            kept.append(_kept(cfg, raw))
        n_steps = steps
        record.update(trace.reduce(holder.profile))
        record["flash_shapes"] = [[k, list(s), c] for (k, s), c in fa.SHAPES.items()]
        record["flash_kept_per_step"] = kept
        record["key_mask_dim"] = (cfg.get("key_mask") or {}).get("head_dim")
    else:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            raw = batches[(checks + 1 + n_steps) % len(batches)][0]
            ctx_counts += list(raw.get("ctx_count", [0] * int(mix["batch"])))
            one(checks + 1 + n_steps)
            n_steps += 1
        device_.sync(device)
        record["window_s"] = time.perf_counter() - t_start
    record["steps"] = n_steps
    record["samples"] = n_steps * int(mix["batch"])
    record["flops"] = sum(work.sample_flops(cfg["work"], int(c), train=True) for c in ctx_counts)
    record["memory_peak_bytes"] = device_.peak(device)
    record["attempted"], record["failed"] = n_steps, 0

    del model, opt, step, state, proc, named
    device_.free(device)
    prog = {"losses": losses, "logits": logits1, "grads": grad1, "change_norms": after,
            "change_norms_1": after1}
    t_check = time.perf_counter()
    record["numbers"], record["check_detail"] = check_against_reference(
        ref, cfg, w0, batches, checks, dropout_seed, device, prog)
    record["check_s"] = time.perf_counter() - t_check
    return record


def check_against_reference(ref, cfg, w0, batches, checks, dropout_seed, device,
                            prog) -> dict:
    from ref_common import Prec, float32_matmuls
    import ref_train_steps as train_steps

    float32_matmuls()
    W = {n: t.to(device) for n, t in w0.items()}
    got = train_steps.run(ref, cfg, W, batches, checks, dropout_seed, device, Prec("float32"),
                          REFERENCE_BLOCK)
    return check.train_numbers(prog, got), check.train_detail(prog, got)
