#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: python3 chip_smoke.py (one card).

Drives the port's served path and its train step on the card and prints,
one JSON object per line:

1. the card (``nvidia-smi`` name and power limit) and the kernel build time
   (every ``bifold_tpu_torch/csrc`` source built by ``nvcc`` for sm_90a,
   all builds started together);
2. each CUDA kernel against its plain PyTorch version on the card, at the
   main paths' shapes and on all-masked rows with a ragged n, in bf16 and in
   f32 (TF32 off), with the tolerance it is held to: the inference forward,
   the forward with lse (out and lse) and the backward (dq, dk, dv; dq and
   dk exactly 0 on all-masked rows); then gradients through
   ``dot_product_attention`` (the autograd Function over the kernels) against
   autograd through the plain forward;
3. kernel timings (CUDA events): each kernel, its plain version and
   ``scaled_dot_product_attention`` as a yardstick (every SDPA backend that
   runs the inputs, pinned and timed; a row takes the fastest and names it;
   the backward's library time is forward+backward minus forward), with the
   bound max(FLOP / bf16 peak, bytes / HBM rate);
4. flagship training: SiglipSequential at full width and depth (384 px,
   12-layer SigLIP-base towers, LoRA r8, depth-8 fusion with 16 heads, bf16,
   bimanual, 3 context frames), batch 2, raw frames through the train
   Processor (spatial augmentation on), bce_gaussmap, Adam 1e-4, clip 1.0:
   3 warm-up and 10 timed steps with per-step losses, p50, samples/s, peak
   memory and a profiler breakdown; gates on finite losses, frozen weights
   bitwise unchanged, trainable weights updated, exactly 8 + 12
   forward-with-lse and 8 + 12 backward launches and no inference launch
   per step; then the trained model serves one request through the
   inference kernel only;
5. one f32 train step (SGD) through the kernels and through the math path
   from the same weights, batch and draws: loss and trainable-gradient norm
   agree;
6. flagship serving: 5 ``predict`` requests at 720 px and
   one ``predict_batch`` of 8; launch counts per request, finite outputs of
   the right shape, the same forward through ``backend="math"``, predict p50
   latency and where its time goes;
7. the ``kernels`` line (six kernel instances), then the card line, then the
   result line ``{"ok": true, "device": {...}}``.

Each path's launch counts are reset just before it and read just after.
Any failed phase raises, so the exit code is non-zero and no result line is
printed; so does a machine without a CUDA card. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

FLAGSHIP = {  # bifold_tpu/conf/model/siglip_sequential.yaml at 384 px
    "name": "siglip_sequential", "image_size": 384, "is_bimanual": True,
    "patch_size": 16, "automodel_name": "google/siglip-base-patch16-384",
    "dim": 768, "emb_dropout": 0.0, "lora": True, "r": 8, "lora_alpha": 32,
    "lora_dropout": 0.01, "target_modules": ["q_proj", "v_proj"],
    "threshold": 0.01, "text_encoder": None,
    "pick_place_model": "pick_place_convdecoder",
    "fusion_model": "concat_transformer", "depth": 8, "heads": 16,
    "mlp_ratio": 4, "dropout": 0.0, "context_length": 3,
    "requires_graph": False}
PROCESSOR = {"model_image_size": 384, "text_encoder": None, "sigma": 5,
             "requires_graph": False, "spatial_augment": True,
             "strategy": "gmm", "mask_depth": True, "standardize_depth": False}
CAMERA = 720
INSTRUCTIONS = ("fold the left sleeve to the center",
                "fold the towel in half from bottom to top",
                "fold the right sleeve in", "fold the tshirt in half",
                "flatten the cloth")
# dense bf16 tensor-core rate and memory rate (NVIDIA data sheets)
_PEAKS = {"PCIe": (756e12, 2.0e12), "NVL": (835e12, 3.9e12),
          "H200": (989e12, 4.8e12), "H100": (989e12, 3.35e12)}
F32_TOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    for key in ("PCIe", "NVL", "H200"):
        if key in name:
            return _PEAKS[key]
    return _PEAKS["H100"]


@contextlib.contextmanager
def smi_samples(samples: list):
    """Append (SM clock MHz, power draw W) to ``samples``, read by
    ``nvidia-smi`` every 100 ms while the block runs; the sampler is stopped
    on the way out. Unreadable lines are skipped."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, text=True)
    try:
        yield samples
    finally:
        proc.terminate()
        text, _ = proc.communicate(timeout=30)
    for line in text.splitlines():
        fields = line.split(",")
        if len(fields) == 2:
            try:
                samples.append((float(fields[0]), float(fields[1])))
            except ValueError:       # "[N/A]", or a line cut by the terminate
                continue


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(gen, b, n, h, d, dtype, fused):
    """q, k, v as the main path hands them over: strided views of one fused
    qkv projection (fusion stack) or contiguous (towers)."""
    if fused:
        qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).to(dtype)
        return [t.reshape(b, n, h, d) for t in qkv.chunk(3, dim=-1)]
    return [torch.randn(b, n, h, d, device="cuda", generator=gen).to(dtype)
            for _ in range(3)]


def fusion_mask(b, n, masked_frames):
    """[65 text | 3 x 577 context | 577 current] with the last
    ``masked_frames`` context frames masked."""
    mask = torch.ones(b, n, dtype=torch.int32, device="cuda")
    for f in range(3 - masked_frames, 3):
        mask[:, 65 + 577 * f: 65 + 577 * (f + 1)] = 0
    return mask


def case_mask(gen, b, n, masking):
    """None, the fusion mask with ``masking`` context frames masked, or
    ("rows") a random key mask whose batch row 1 is all masked."""
    if masking == "rows":
        mask = (torch.rand(b, n, device="cuda", generator=gen) > 0.3).int()
        mask[1] = 0
        return mask
    return None if masking is None else fusion_mask(b, n, masking)


def within(out, ref, dtype):
    """bf16: two ulps of the plain value (both sides compute in f32 from the
    same bf16 inputs and round once); f32: 1e-4 absolute."""
    err = (out.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        tol = "2^-6 * max(1, |plain|)"
        ok = bool((err <= 2.0 ** -6 * ref.float().abs().clamp_min(1)).all())
    else:
        tol, ok = F32_TOL, bool((err <= F32_TOL).all())
    return float(err.max()), tol, ok


def check_kernels(fa):
    """Phase 2: the inference kernel against its plain version. Returns the
    largest bf16 error per kernel name."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"flash_fwd_infer_d48": 0.0, "flash_fwd_infer_d64": 0.0}
    cases = [("fusion, 1 context frame masked", 1, 2373, 16, 48, True, 1),
             ("fusion, 2 context frames masked", 1, 2373, 16, 48, True, 2),
             ("vision", 4, 576, 12, 64, False, None),
             ("ragged n=300, all-masked rows", 2, 300, 3, 48, False, "rows"),
             ("ragged n=300, all-masked rows", 2, 300, 3, 64, False, "rows")]
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, n, h, d, fused, masking in cases:
            q, k, v = attention_inputs(gen, b, n, h, d, dtype, fused)
            mask = case_mask(gen, b, n, masking)
            out = fa.flash_attention(q, k, v, mask)
            torch.cuda.synchronize()
            err, tol, ok = within(out, fa.flash_attention_plain(q, k, v, mask), dtype)
            emit({"phase": "kernel_vs_plain", "kernel": f"flash_fwd_infer_d{d}",
                  "case": label, "shape": [b, n, h, d], "dtype": str(dtype),
                  "max_abs_err": err, "tol": tol, "ok": ok})
            if not ok:
                raise AssertionError(f"flash kernel disagrees with plain: {label}")
            if dtype == torch.bfloat16:
                worst[f"flash_fwd_infer_d{d}"] = max(worst[f"flash_fwd_infer_d{d}"], err)
    return worst


TRAIN_SHAPES = {48: (2, 2373, 16, True), 64: (8, 576, 12, False)}


def train_cases():
    """(label, b, n, h, d, fused, masking) of the training kernels' checks:
    the train step's shapes, and the ragged n=300 case with all-masked rows
    at both head dims."""
    b48, n48, h48, _ = TRAIN_SHAPES[48]
    b64, n64, h64, _ = TRAIN_SHAPES[64]
    return [("fusion, 1 context frame masked", b48, n48, h48, 48, True, 1),
            ("vision", b64, n64, h64, 64, False, None),
            ("ragged n=300, all-masked rows", 2, 300, 3, 48, False, "rows"),
            ("ragged n=300, all-masked rows", 2, 300, 3, 64, False, "rows")]


def within_lse(out, ref):
    """lse is f32 whatever the inputs: 1e-4 of max(1, |plain|) (an all-masked
    row's lse is -1e5 + log(nk), where one f32 ulp is 0.0078)."""
    err = (out - ref).abs()
    return float(err.max()), "1e-4 * max(1, |plain|)", bool(
        (err <= F32_TOL * ref.abs().clamp_min(1)).all())


def check_train_kernels(fa):
    """The forward-with-lse and backward kernels against their plain
    versions, in bf16 and in f32; dq and dk exactly 0 on all-masked rows.
    Returns the largest bf16 error per kernel name."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, n, h, d, fused, masking in train_cases():
            q, k, v = attention_inputs(gen, b, n, h, d, dtype, fused)
            mask = case_mask(gen, b, n, masking)
            do = torch.randn(b, n, h, d, device="cuda", generator=gen).to(dtype)
            out, lse = fa.flash_attention_fwd(q, k, v, mask)
            grads = fa.flash_attention_bwd(q, k, v, mask, out, lse, do)
            torch.cuda.synchronize()
            p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, mask)
            # the backward's reference takes the kernel's own out and lse,
            # so the check isolates the backward kernel
            p_grads = fa.flash_attention_bwd_plain(q, k, v, mask, out, lse, do)
            results = [("flash_fwd_lse", "out", *within(out, p_out, dtype)),
                       ("flash_fwd_lse", "lse", *within_lse(lse, p_lse))]
            results += [("flash_bwd", g, *within(x, ref, dtype)) for g, x, ref
                         in zip(("dq", "dk", "dv"), grads, p_grads)]
            zero_rows = {}
            if masking == "rows":
                zero_rows = {g: float(x[1].float().abs().max())
                             for g, x in zip(("dq", "dk"), grads[:2])}
            for kernel, what, err, tol, ok in results:
                emit({"phase": "kernel_vs_plain", "kernel": f"{kernel}_d{d}",
                      "output": what, "case": label, "shape": [b, n, h, d],
                      "dtype": str(dtype), "max_abs_err": err, "tol": tol,
                      "ok": ok})
                if not ok:
                    raise AssertionError(f"{kernel}_d{d} {what} disagrees with "
                                         f"plain: {label}, {dtype}")
                if dtype == torch.bfloat16:
                    name = f"{kernel}_d{d}"
                    worst[name] = max(worst.get(name, 0.0), err)
            if zero_rows:
                emit({"phase": "all_masked_rows", "kernel": f"flash_bwd_d{d}",
                      "dtype": str(dtype), "max_abs": zero_rows})
                if any(zero_rows.values()):
                    raise AssertionError(f"flash_bwd_d{d}: dq/dk not exactly 0 "
                                         "on all-masked rows")
    return worst


def check_function_grads(fa):
    """Gradients through dot_product_attention on the card (the autograd
    Function over the two kernels) equal autograd through
    flash_attention_plain, in f32: 1e-4 at the fusion shape; on the ragged
    case with all-masked rows, dv within 2e-3 (the saved lse of such a row,
    -1e5 + log(nk), is one f32 ulp = 0.0078 coarse, which moves its
    recomputed 1/nk mass by up to 0.4%; autograd needs no lse)."""
    from bifold_tpu_torch.ops.attention import dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for label, b, n, h, d, fused, masking in train_cases()[::2]:
        leaves = [x.detach().requires_grad_() for x in
                  attention_inputs(gen, b, n, h, d, torch.float32, False)]
        mask = case_mask(gen, b, n, masking)
        do = torch.randn(b, n, h, d, device="cuda", generator=gen)
        before = dict(fa.LAUNCHES)
        got = torch.autograd.grad(dot_product_attention(*leaves, mask), leaves, do)
        launched = {key: fa.LAUNCHES[key] - before.get(key, 0)
                    for key in (f"fwd_lse_d{d}", f"bwd_d{d}", f"fwd_infer_d{d}")}
        ref = torch.autograd.grad(fa.flash_attention_plain(*leaves, mask), leaves, do)
        errs = {g: float((x - r).abs().max()) for g, x, r in zip("qkv", got, ref)}
        tol = {"q": F32_TOL, "k": F32_TOL,
               "v": 2e-3 if masking == "rows" else F32_TOL}
        emit({"phase": "function_grads_vs_autograd_plain", "case": label,
              "shape": [b, n, h, d], "max_abs_err": errs, "tol": tol,
              "launches": launched})
        if any(errs[g] > tol[g] for g in tol) or launched != {
                f"fwd_lse_d{d}": 1, f"bwd_d{d}": 1, f"fwd_infer_d{d}": 0}:
            raise AssertionError(f"gradients through the kernels: {label}")
        out.append(errs)
    return out


def time_kernels(fa, peaks):
    """The kernel, its plain version and SDPA (its fastest backend) at the
    main path's shapes in bf16 (fusion: all 3 context frames present; vision:
    4 frames)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for d, (b, n, h, fused) in {48: (1, 2373, 16, True),
                                64: (4, 576, 12, False)}.items():
        q, k, v = attention_inputs(gen, b, n, h, d, torch.bfloat16, fused)
        mask = fusion_mask(b, n, 0) if fused else None
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_mask = None if mask is None else (mask != 0)[:, None, None, :]
        library = sdpa_times(qt, kt, vt, sdpa_mask)
        backend = min(library, key=lambda name: library[name][0])
        valid = n if mask is None else int(mask.sum()) // b
        fwd_bound = bound(4.0 * b * h * n * valid * d,
                          4.0 * b * n * h * d * 2 + (0 if mask is None else 4 * b * n),
                          peaks)
        rows[f"flash_fwd_infer_d{d}"] = {
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, mask)),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, mask)),
            "library_ms": library[backend][0], "library_backend": backend,
            "library_by_backend": library,
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
            "shape": [b, n, h, d]}
    return rows


def bound(flops, nbytes, peaks):
    """max(operations / dense bf16 peak, bytes / memory rate), in ms."""
    ops_ms, bytes_ms = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


SDPA_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH")


def sdpa_times(qt, kt, vt, sdpa_mask, dot=None):
    """The library yardstick: for each SDPA backend that runs these inputs
    (pinned with ``sdpa_kernel``, so each time names what it timed), ms of
    the forward and, given the output cotangent ``dot``, of forward +
    backward: {backend: [forward ms, forward+backward ms or None]}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def forward():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask)

    def both():
        return torch.autograd.grad(forward(), (qt, kt, vt), dot)

    times = {}
    for name in SDPA_BACKENDS:
        with sdpa_kernel(getattr(SDPBackend, name)):
            try:                         # a backend refuses what it lacks
                forward() if dot is None else both()
            except RuntimeError:
                continue
            times[name] = [time_ms(forward), None if dot is None else time_ms(both)]
    if not times:
        raise AssertionError("no SDPA backend runs these inputs")
    return times


def time_train_kernels(fa, peaks):
    """The forward-with-lse and backward kernels, their plain versions and
    SDPA (forward with grad, and forward + backward: the backward's library
    time is the difference; each row takes the backend fastest at its part),
    bf16, at the train step's shapes (fusion B=2 with all 3 context frames
    present; vision 8 frames)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = {}
    for d, (b, n, h, fused) in TRAIN_SHAPES.items():
        q, k, v = attention_inputs(gen, b, n, h, d, torch.bfloat16, fused)
        mask = fusion_mask(b, n, 0) if fused else None
        do = torch.randn(b, n, h, d, device="cuda", generator=gen).to(torch.bfloat16)
        out, lse = fa.flash_attention_fwd(q, k, v, mask)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
        sdpa_mask = None if mask is None else (mask != 0)[:, None, None, :]
        library = sdpa_times(qt, kt, vt, sdpa_mask, do.transpose(1, 2))
        lib_fwd = min(library, key=lambda name: library[name][0])
        lib_bwd = min(library, key=lambda name: library[name][1] - library[name][0])
        kept = n if mask is None else int(mask.sum()) // b
        act = b * n * h * d * 2                   # one bf16 (B, N, H, D) tensor
        mask_bytes = 0 if mask is None else 4 * b * n
        lse_bytes = 4 * b * h * n
        fwd_bound = bound(4.0 * b * h * n * kept * d,
                          4 * act + mask_bytes + lse_bytes, peaks)
        bwd_bound = bound(10.0 * b * h * n * kept * d,
                          8 * act + mask_bytes + lse_bytes, peaks)
        rows[f"flash_fwd_lse_d{d}"] = {
            "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, mask)),
            "plain_ms": time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, mask)),
            "library_ms": library[lib_fwd][0], "library_backend": lib_fwd,
            "library_by_backend": library,
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
            "shape": [b, n, h, d]}
        rows[f"flash_bwd_d{d}"] = {
            "ms": time_ms(lambda: fa.flash_attention_bwd(q, k, v, mask, out, lse, do)),
            "plain_ms": time_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, mask, out, lse, do)),
            "library_ms": library[lib_bwd][1] - library[lib_bwd][0],
            "library_backend": lib_bwd,
            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
            "shape": [b, n, h, d]}
    return rows


TRAIN_PROCESSOR = {**PROCESSOR, "image_mean": [0.48145466, 0.4578275, 0.40821073],
                   "image_std": [0.26862954, 0.26130258, 0.27577711],
                   "spatial_augmentations": {"max_augmentation_trials": 5,
                                             "rotate_augmentation": [-5, 6],
                                             "translate_augmentation": [-5, 6]},
                   "depth_augmentations": {"add_depth_noise": False,
                                           "random_depth_shift": False,
                                           "min_shift": -0.2, "max_shift": 0.2}}
LOSS = {"name": "bce_gaussmap", "is_bimanual": True, "mask_pick_heatmap": False}
ADAM = {"name": "adam", "lr": 1e-4, "betas": [0.9, 0.999], "eps": 1e-8,
        "weight_decay": 0}
TRAIN_BATCH = 2
LABELS = ("left_pick", "left_place", "right_pick", "right_place")
PER_STEP = {"fwd_lse_d48": 8, "fwd_lse_d64": 12, "bwd_d48": 8, "bwd_d64": 12}


def raw_train_batch(proc, seed, batch=TRAIN_BATCH):
    """A collated raw batch as bench.py builds it: uint8 frames at 384 px,
    3 context frames, one label point per arm and action, tokenized
    instructions."""
    rng = np.random.default_rng(seed)
    s, t = FLAGSHIP["image_size"], FLAGSHIP["context_length"]
    raw = {"rgb": rng.integers(0, 255, (batch, s, s, 3), dtype=np.uint8),
           "depth": rng.random((batch, s, s), dtype=np.float32),
           "mask": (rng.random((batch, s, s)) > 0.5).astype(np.float32),
           "ctx_rgb": rng.integers(0, 255, (batch, t, s, s, 3), dtype=np.uint8),
           "ctx_depth": rng.random((batch, t, s, s), dtype=np.float32),
           "ctx_mask": np.ones((batch, t, s, s), np.float32),
           "ctx_count": np.full((batch,), t, np.int32),
           "label_keys": LABELS,
           "instruction": np.stack([proc.tokenize(INSTRUCTIONS[i % len(INSTRUCTIONS)])
                                    for i in range(batch)])}
    for key in LABELS:
        lab = -np.ones((batch, 8, 2), np.float32)
        lab[:, 0] = rng.uniform(50, 300, (batch, 2))
        raw[key] = lab
    return raw


def trainer(dtype, optim_cfg, precast):
    """The flagship with the train step's pieces: frozen towers but their
    LoRA adapters, frozen weights precast to the compute dtype, the optimizer
    over the trainable float32 masters with gradient clip 1.0."""
    from bifold_tpu_torch.losses import build_loss
    from bifold_tpu_torch.models import build_model, precast_frozen, trainable_mask
    from bifold_tpu_torch.optim import build_optimizer
    from bifold_tpu_torch.parallel import TrainState, make_train_step

    model = build_model(FLAGSHIP, dtype=dtype, device="cuda", seed=0)
    mask = trainable_mask(model, lora=True)
    if precast:
        precast_frozen(model, dtype)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = build_optimizer(dict(optim_cfg), params, None, max_iters=100,
                          gradient_clip=1.0)
    step = make_train_step(model, build_loss(dict(LOSS)), opt)
    return model, mask, step, TrainState.create(opt, seed=0)


def train_flagship(fa, card, warmup=3, steps=10):
    """The bf16 flagship train step at full width and depth, batch 2: raw
    frames -> train Processor on the card -> forward -> loss -> backward
    through the lse and backward kernels -> clip -> Adam. Then serves the
    trained model once, which must launch only the inference kernel."""
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.serving import ServingModel

    t0 = time.perf_counter()
    proc = Processor(TRAIN_PROCESSOR, partition="train", max_context_length=3,
                     autoprocessor_name=FLAGSHIP["automodel_name"],
                     spm_asset=fixture_model_bytes(), seed=0)
    model, mask, step, state = trainer(torch.bfloat16, ADAM, precast=True)
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    raws = [raw_train_batch(proc, seed) for seed in range(warmup + steps)]
    emit({"phase": "train_setup", "seconds": time.perf_counter() - t0,
          "parameters": sum(p.numel() for p in named.values()),
          "trainable": sum(p.numel() for n, p in named.items() if mask[n])})

    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.clear()                  # the train path's run starts here
    losses, process_ms, step_ms, smi = [], [], [], []
    with smi_samples(smi):
        for i, raw in enumerate(raws):
            torch.cuda.synchronize()
            t = time.perf_counter()
            sample = proc.process_batch(raw, "cuda")
            torch.cuda.synchronize()
            t_mid = time.perf_counter()
            counts = dict(fa.LAUNCHES)
            state, metrics = step(state, sample)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            delta = {key: fa.LAUNCHES[key] - counts.get(key, 0) for key in fa.LAUNCHES}
            delta = {key: n for key, n in delta.items() if n}
            if delta != PER_STEP:
                raise AssertionError(f"train step {i}: kernel launches {delta}, "
                                     f"want {PER_STEP}")
            losses.append(float(metrics["loss"]))
            if i >= warmup:
                process_ms.append((t_mid - t) * 1e3)
                step_ms.append((t_end - t_mid) * 1e3)
    launches = dict(fa.LAUNCHES)         # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train losses {losses}")
    frozen_changed = [n for n, p in named.items()
                      if not mask[n] and not torch.equal(p.detach(), before[n])]
    stale = [n for n, p in named.items()
             if mask[n] and torch.equal(p.detach(), before[n])]
    if frozen_changed or [n for n in stale if "lora_A" not in n]:
        raise AssertionError(f"frozen changed {frozen_changed[:3]}, "
                             f"trainable unchanged {stale[:3]}")
    p50 = statistics.median(step_ms)
    emit({"phase": "train_flagship", "batch": TRAIN_BATCH, "warmup": warmup,
          "steps": steps, "losses": losses,
          "grad_norm_last": float(metrics["grad_norm"]),
          "p50_step_ms": p50, "p50_process_ms": statistics.median(process_ms),
          "samples_per_s": TRAIN_BATCH / (p50 / 1e3),
          "samples_per_s_with_processor": TRAIN_BATCH / (
              (p50 + statistics.median(process_ms)) / 1e3),
          "max_memory_allocated_bytes": peak,
          "sm_clock_mhz_min_median": [min(s[0] for s in smi),
                                      statistics.median(s[0] for s in smi)] if smi else None,
          "power_draw_w_median_max": [statistics.median(s[1] for s in smi),
                                      max(s[1] for s in smi)] if smi else None,
          "smi_samples": len(smi),
          "launches_per_step": PER_STEP, "launches": launches,
          "lora_A_unchanged": len(stale), **card})

    sample = proc.process_batch(raws[-1], "cuda")
    profile = device_profile(lambda: step(state, sample), p50)
    emit({"phase": "where_the_time_goes", "path": "train_step", "p50_ms": p50,
          "process_ms": statistics.median(process_ms),
          **train_stages(model, state.optimizer, sample), **profile})

    # serve the trained model: the copy leaves the float32 masters as they
    # are, and predict launches the inference kernel only
    test_proc = Processor(PROCESSOR, max_context_length=3,
                          autoprocessor_name=FLAGSHIP["automodel_name"],
                          spm_asset=fixture_model_bytes())
    server = ServingModel(model, None, test_proc, device="cuda")
    if any(p.dtype != torch.float32 for n, p in named.items() if mask[n]):
        raise AssertionError("serving rounded the trainable float32 masters")
    fa.LAUNCHES.clear()
    obs = observation(np.random.default_rng(1), n_ctx=3)
    action, raw_out = server.predict(**obs, instruction=INSTRUCTIONS[0],
                                     return_raw_output=True)
    check_action(action, raw_out, 1, FLAGSHIP["image_size"])
    served = {key: n for key, n in fa.LAUNCHES.items() if n}
    emit({"phase": "predict_after_training", "launches": served})
    if served != {"fwd_infer_d48": 8, "fwd_infer_d64": 12}:
        raise AssertionError(f"predict launched {served}")
    return launches


def train_stages(model, optimizer, sample, iters: int = 5):
    """Median ms of the train step's stages, synchronised between stages:
    forward + loss, backward (gradients of the trainable parameters) and the
    optimizer (global norm, clip, update in place). Updates the model."""
    from bifold_tpu_torch.losses import build_loss
    from bifold_tpu_torch.models.dropout import set_dropout_generator

    loss_fn = build_loss(dict(LOSS))
    stages = {"forward_loss": [], "backward": [], "optimizer": []}
    model.train()
    for i in range(iters):
        set_dropout_generator(model, torch.Generator("cuda").manual_seed(i))
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        loss, _ = loss_fn(model(sample), sample)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        grads = list(torch.autograd.grad(loss, optimizer.params))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        optimizer.step(grads)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for key, a, b in zip(stages, t, t[1:]):
            stages[key].append((b - a) * 1e3)
    set_dropout_generator(model, None)
    return {f"{k}_ms": statistics.median(v) for k, v in stages.items()}


F32_LOSS_RTOL = 1e-4
F32_NORM_RTOL = 1e-3


def f32_step_equivalence(fa):
    """One f32 train step (TF32 off) with SGD from the same weights, batch
    and dropout seed, through the kernels and through the math path: loss
    within 1e-4 and trainable-gradient norm within 1e-3, relative."""
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes

    proc = Processor(TRAIN_PROCESSOR, partition="train", max_context_length=3,
                     autoprocessor_name=FLAGSHIP["automodel_name"],
                     spm_asset=fixture_model_bytes(), seed=0)
    raw = raw_train_batch(proc, 99)
    draws = proc.draw(proc._spec(raw), TRAIN_BATCH, raw["rgb"].shape[1:3], "cuda")
    sgd = {"name": "sgd", "lr": 1e-3}
    results = {}
    for path in ("kernels", "math"):
        model, mask, step, state = trainer(torch.float32, sgd, precast=False)
        sample = proc.process_batch(raw, "cuda", draws=draws)
        before = dict(fa.LAUNCHES)
        if path == "math":
            os.environ["BIFOLD_ATTN_BACKEND"] = "math"
        try:
            state, metrics = step(state, sample)
            torch.cuda.synchronize()
        finally:
            os.environ.pop("BIFOLD_ATTN_BACKEND", None)
        launched = {k: fa.LAUNCHES[k] - before.get(k, 0) for k in PER_STEP}
        results[path] = {"loss": float(metrics["loss"]),
                         "grad_norm_trainable": float(metrics["grad_norm_trainable"]),
                         "launches": launched}
        del model, step, state
        torch.cuda.empty_cache()
    k, m = results["kernels"], results["math"]
    loss_rel = abs(k["loss"] - m["loss"]) / abs(m["loss"])
    norm_rel = abs(k["grad_norm_trainable"] - m["grad_norm_trainable"]) / m["grad_norm_trainable"]
    emit({"phase": "f32_train_step_kernels_vs_math", **results,
          "loss_rel_diff": loss_rel, "grad_norm_rel_diff": norm_rel,
          "tol": {"loss": F32_LOSS_RTOL, "grad_norm": F32_NORM_RTOL}})
    if (loss_rel > F32_LOSS_RTOL or norm_rel > F32_NORM_RTOL
            or k["launches"] != PER_STEP or any(m["launches"].values())):
        raise AssertionError("f32 train step: kernels and math path disagree")


def observation(rng, n_ctx):
    def frame():
        mask = np.zeros((CAMERA, CAMERA), np.float32)
        top, left = rng.integers(60, 300, size=2)
        mask[top: top + 360, left: left + 360] = 1.0     # the cloth
        return dict(rgb=rng.integers(0, 255, (CAMERA, CAMERA, 3), dtype=np.uint8),
                    depth=(0.8 + 0.2 * rng.random((CAMERA, CAMERA))).astype(np.float32),
                    mask=mask)
    obs = frame()
    obs["context"] = [frame() for _ in range(n_ctx)]
    return obs


def check_action(action, raw, n, size):
    for f in ("left_pick", "right_pick", "left_place", "right_place"):
        px = np.asarray(getattr(action, f))
        if px.shape != (n, 2) or not np.isfinite(px).all():
            raise AssertionError(f"{f}: shape {px.shape} or non-finite values")
        if not (((px >= 0) & (px < size)) | (px == -1)).all():
            raise AssertionError(f"{f}: pixel outside the {size}px heatmap")
    for k, v in raw.items():
        if v.shape != (n, size, size) or not np.isfinite(v).all():
            raise AssertionError(f"{k}: shape {v.shape} or non-finite values")


def decoded_apart(action, other, raw):
    """Fields two forwards decode differently: both pixels ([x, y]) and the
    first forward's heatmap at each, which shows how close the tie was."""
    apart = {}
    for f in ("left_pick", "right_pick", "left_place", "right_place"):
        a, b = getattr(action, f)[0], getattr(other, f)[0]
        if not np.array_equal(a, b):
            hm = raw[f"{f}_heatmap"][0]
            apart[f] = {"pixels": [a.tolist(), b.tolist()],
                        "heatmap": [None if p[0] < 0 else float(hm[int(p[1]), int(p[0])])
                                    for p in (a, b)]}
    return apart


def math_forward(server, obs, text):
    """One request with every attention call on the math path."""
    os.environ["BIFOLD_ATTN_BACKEND"] = "math"
    try:
        return server.predict(**obs, instruction=text, return_raw_output=True)
    finally:
        del os.environ["BIFOLD_ATTN_BACKEND"]


def serve_flagship(fa, card):
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.models import build_model
    from bifold_tpu_torch.serving import ServingModel

    t0 = time.perf_counter()
    model = build_model(FLAGSHIP, dtype=torch.bfloat16, device="cuda", seed=0)
    proc = Processor(PROCESSOR, max_context_length=3,
                     autoprocessor_name=FLAGSHIP["automodel_name"],
                     spm_asset=fixture_model_bytes())
    server = ServingModel(model, None, proc, device="cuda")
    server.warmup(CAMERA)
    server.warmup(CAMERA, pool=8)
    emit({"phase": "flagship_setup", "seconds": time.perf_counter() - t0,
          "parameters": sum(p.numel() for p in model.parameters())})

    rng = np.random.default_rng(0)
    per_request = {"fwd_infer_d48": 8, "fwd_infer_d64": 12}  # fusion + vision layers
    size = FLAGSHIP["image_size"]
    fa.LAUNCHES.clear()                  # the main path's run starts here
    requests = []
    for i, text in enumerate(INSTRUCTIONS):
        obs = observation(rng, n_ctx=1 + i % 3)
        before = dict(fa.LAUNCHES)
        action, raw = server.predict(**obs, instruction=text, return_raw_output=True)
        delta = {d: fa.LAUNCHES[d] - before.get(d, 0) for d in per_request}
        if delta != per_request:
            raise AssertionError(f"request {i}: flash launches {delta}, "
                                 f"want {per_request}")
        check_action(action, raw, 1, size)
        requests.append((obs, text, action, raw))
    before = dict(fa.LAUNCHES)
    pool = [dict(observation(rng, n_ctx=1 + i % 3), instruction=INSTRUCTIONS[i % 5])
            for i in range(8)]
    action, raw = server.predict_batch(pool, pad_to=8, return_raw_output=True)
    delta = {d: fa.LAUNCHES[d] - before.get(d, 0) for d in per_request}
    if delta != per_request:
        raise AssertionError(f"predict_batch: flash launches {delta}")
    check_action(action, raw, 8, size)
    launches = {k: n for k, n in fa.LAUNCHES.items() if n}   # ... and ends here
    if set(launches) != set(per_request):
        raise AssertionError(f"serving launched {launches}")
    emit({"phase": "flagship_serving", "requests": len(requests), "pool": 8,
          "launches_per_request": per_request, "launches": launches})

    # the same forward through the math path: in bf16 (reported; the math
    # path rounds the scores to bf16 before its softmax, so near-tied
    # heatmap peaks may decode apart) and in f32 (held: the two paths then
    # differ by summation order only, and must decode the same actions)
    obs, text, action, raw = requests[-1]
    f32_server = ServingModel(build_model(FLAGSHIP, dtype=torch.float32,
                                          device="cuda", seed=0),
                              None, proc, device="cuda")
    f32_action, f32_raw = f32_server.predict(**obs, instruction=text,
                                             return_raw_output=True)
    for dtype, srv, act, out in (("bfloat16", server, action, raw),
                                 ("float32", f32_server, f32_action, f32_raw)):
        m_action, m_raw = math_forward(srv, obs, text)
        hm_diff = max(float(np.abs(out[k] - m_raw[k]).max())
                      for k in out if k.endswith("_heatmap"))
        same = all(np.array_equal(getattr(act, f), getattr(m_action, f))
                   for f in ("left_pick", "right_pick", "left_place", "right_place"))
        emit({"phase": "kernel_vs_math_forward", "dtype": dtype,
              "max_heatmap_diff": hm_diff, "actions_identical": same,
              "decoded_apart": decoded_apart(act, m_action, out)})
        if dtype == "float32" and not (same and hm_diff < 1e-3):
            raise AssertionError("f32 kernel and math forwards disagree")
        if hm_diff > 0.05:
            raise AssertionError(f"{dtype} kernel and math heatmaps differ by {hm_diff}")
    del f32_server

    lat = {}
    for name, call in (
            ("batch1", lambda: server.predict(**obs, instruction=text)),
            ("pool8", lambda: server.predict_batch(pool, pad_to=8))):
        times = []
        for _ in range(11):
            t = time.perf_counter()
            call()
            times.append((time.perf_counter() - t) * 1e3)
        lat[name] = statistics.median(times)
    emit({"phase": "predict_latency", "p50_ms_batch1": lat["batch1"],
          "p50_ms_pool8": lat["pool8"], "requests_each": 11, **card})
    for name, obs_list in (("batch1", [dict(obs, instruction=text)]),
                           ("pool8", pool)):
        emit({"phase": "where_the_time_goes", "batch": name,
              "p50_ms": lat[name], **stage_breakdown(server, obs_list),
              **device_profile(lambda: server.predict_batch(obs_list),
                               lat[name])})
    return launches


def stage_breakdown(server, obs_list, iters: int = 5):
    """Median ms of each serving stage, synchronised between stages."""
    stages = {"host_prepare": [], "upload": [], "preprocess": [], "forward": [],
              "decode_fetch": []}
    with torch.inference_mode():
        for _ in range(iters):
            t = [time.perf_counter()]
            batched, spec = server._prepare(obs_list, None)
            t.append(time.perf_counter())
            x = server._upload(batched)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            sample = server._preprocess(spec, x)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            out = server.model(sample)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            server._decode(out, sample).cpu()
            t.append(time.perf_counter())
            for key, a, b in zip(stages, t, t[1:]):
                stages[key].append((b - a) * 1e3)
    return {f"{k}_ms": statistics.median(v) for k, v in stages.items()}


def device_profile(call, wall_ms: float, iters: int = 3):
    """torch.profiler over ``iters`` calls after one warm-up step: device
    busy time per call, its idle share of ``wall_ms`` (the unprofiled p50 of
    the same call), launches per call and the top kernels."""
    from torch.profiler import ProfilerActivity, profile, schedule

    traces = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=iters),
                 on_trace_ready=lambda p: traces.append(p.key_averages())) as prof:
        for _ in range(iters + 1):
            call()
            torch.cuda.synchronize()
            prof.step()
    kernels = [e for e in traces[0]          # device ops, not step annotations
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or 0

    busy = sum(dev_us(e) for e in kernels) / 1e3 / iters
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms,
            "device_ops_per_call": sum(e.count for e in kernels) // iters,
            "top_kernels": [{"name": e.key[:80], "calls": e.count // iters,
                             "ms": dev_us(e) / 1e3 / iters} for e in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke needs a "
              "CUDA card", file=sys.stderr)
        return 2
    from bifold_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    card = {"card": smi.split(",")[0].strip(), "power_limit": smi.split(",")[1].strip()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:      # one nvcc per csrc source, all
        libs = [f.result() for f in         # started together
                [pool.submit(fa.build, source) for source in fa.SOURCES]]
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_seconds": time.perf_counter() - t0,
          "built": [os.path.basename(str(p)) for p in libs]})

    peaks = card_peaks(name)
    worst = {**check_kernels(fa), **check_train_kernels(fa)}
    check_function_grads(fa)
    timings = {**time_kernels(fa, peaks), **time_train_kernels(fa, peaks)}
    for kernel, row in timings.items():
        emit({"phase": "kernel_timing", "kernel": kernel, **row})
    launches = train_flagship(fa, card)
    torch.cuda.empty_cache()
    f32_step_equivalence(fa)
    launches.update(serve_flagship(fa, card))

    sources = {"flash_fwd_infer": ("flash_fwd.cu", 250, "serving: predict"),
               "flash_fwd_lse": ("flash_fwd.cu", 241, "training: train step"),
               "flash_bwd": ("flash_bwd.cu", 360, "training: train step")}
    kernels = []
    for kernel, (src, line, where) in sources.items():
        for d, stack in ((48, "fusion"), (64, "vision")):
            key = f"{kernel}_d{d}"
            count = launches.get(key.replace("flash_", ""), 0)
            if count == 0:
                raise AssertionError(f"{key} never ran on its main path")
            row = timings[key]
            kernels.append({
                "name": key, "route": "cuda",
                "source": f"bifold_tpu_torch/csrc/{src}",
                "replaces": f"bifold_tpu/ops/flash_attention.py:{line}",
                "launches": count, "max_abs_err": worst[key], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "library_backend": row["library_backend"],
                "shape": row["shape"], "where": f"{where}, {stack}"})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
