#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: python3 chip_smoke.py (one card).

Drives the port's served path on the card and prints, one JSON object per
line:

1. the card (``nvidia-smi`` name and power limit) and the kernel build time
   (every ``bifold_tpu_torch/csrc`` source built by ``nvcc`` for sm_90a,
   all builds started together);
2. each CUDA kernel against its plain PyTorch version on the card, at the
   main path's shapes and on all-masked rows with a ragged n, in bf16 and in
   f32 (TF32 off), with the tolerance it is held to;
3. flagship serving: SiglipSequential at full width (384 px, 12-layer
   SigLIP-base towers, LoRA r8, depth-8 fusion with 16 heads, bf16,
   bimanual, 3 context frames) with seeded random weights, serving 5
   ``predict`` requests at 720 px and one ``predict_batch`` of 8; launch
   counts per request, finite outputs of the right shape, the same forward
   through ``backend="math"``, and predict p50 latency;
4. the ``kernels`` line, then the card line, then the result line
   ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the exit code is non-zero and no result line is
printed; so does a machine without a CUDA card. Imports nothing of JAX.
"""

from __future__ import annotations

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
    """Phase 2: the flash kernel against its plain version. Returns the
    largest bf16 error per head dim."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {48: 0.0, 64: 0.0}
    cases = [("fusion, 1 context frame masked", 1, 2373, 16, 48, True, 1),
             ("fusion, 2 context frames masked", 1, 2373, 16, 48, True, 2),
             ("vision", 4, 576, 12, 64, False, None),
             ("ragged n=300, all-masked rows", 2, 300, 3, 48, False, "rows"),
             ("ragged n=300, all-masked rows", 2, 300, 3, 64, False, "rows")]
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, n, h, d, fused, masking in cases:
            q, k, v = attention_inputs(gen, b, n, h, d, dtype, fused)
            if masking == "rows":
                mask = (torch.rand(b, n, device="cuda", generator=gen) > 0.3).int()
                mask[1] = 0
            elif masking is not None:
                mask = fusion_mask(b, n, masking)
            else:
                mask = None
            out = fa.flash_attention(q, k, v, mask)
            torch.cuda.synchronize()
            err, tol, ok = within(out, fa.flash_attention_plain(q, k, v, mask), dtype)
            emit({"phase": "kernel_vs_plain", "kernel": f"flash_fwd_infer_d{d}",
                  "case": label, "shape": [b, n, h, d], "dtype": str(dtype),
                  "max_abs_err": err, "tol": tol, "ok": ok})
            if not ok:
                raise AssertionError(f"flash kernel disagrees with plain: {label}")
            if dtype == torch.bfloat16:
                worst[d] = max(worst[d], err)
    return worst


def time_kernels(fa, peaks):
    """The kernel, its plain version and SDPA at the main path's shapes in
    bf16 (fusion: all 3 context frames present; vision: 4 frames)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    flops_peak, bytes_peak = peaks
    rows = {}
    for d, (b, n, h, fused) in {48: (1, 2373, 16, True),
                                64: (4, 576, 12, False)}.items():
        q, k, v = attention_inputs(gen, b, n, h, d, torch.bfloat16, fused)
        mask = fusion_mask(b, n, 0) if fused else None
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_mask = None if mask is None else (mask != 0)[:, None, None, :]
        valid = n if mask is None else int(mask.sum()) // b
        flops = 4.0 * b * h * n * valid * d
        nbytes = 4.0 * b * n * h * d * 2 + (0 if mask is None else 4 * b * n)
        bound_flops, bound_bytes = flops / flops_peak * 1e3, nbytes / bytes_peak * 1e3
        rows[d] = {
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, mask)),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, mask)),
            "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask)),
            "bound_ms": max(bound_flops, bound_bytes),
            "bound_by": "operations" if bound_flops >= bound_bytes else "bytes",
            "shape": [b, n, h, d]}
    return rows


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
    per_request = {48: 8, 64: 12}        # 8 fusion + 12 vision layers
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
    launches = dict(fa.LAUNCHES)         # ... and ends here
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
    builders = (fa.build,)                  # one nvcc per csrc source
    with ThreadPoolExecutor() as pool:      # all started together
        libs = [f.result() for f in [pool.submit(b) for b in builders]]
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_seconds": time.perf_counter() - t0,
          "built": [os.path.basename(str(p)) for p in libs]})

    worst = check_kernels(fa)
    timings = time_kernels(fa, card_peaks(name))
    launches = serve_flagship(fa, card)

    kernels = []
    for d, where in ((48, "fusion"), (64, "vision")):
        if launches.get(d, 0) == 0:
            raise AssertionError(f"flash_fwd_infer_d{d} never ran on the main path")
        row = timings[d]
        kernels.append({
            "name": f"flash_fwd_infer_d{d}", "route": "cuda",
            "source": "bifold_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "bifold_tpu/ops/flash_attention.py:250",
            "launches": launches[d], "max_abs_err": worst[d], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "where": where})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
