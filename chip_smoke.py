#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: python3 chip_smoke.py (one card).

Drives the port's served path and its train step on the card and prints,
one JSON object per line:

1. the card (``nvidia-smi`` name and power limit), the kernel build time
   (every ``bifold_tpu_torch/csrc`` source built by ``nvcc`` for sm_90a,
   all builds started together) and, from the builds' ``-Xptxas -v``
   reports, the registers, shared memory and spill bytes of every kernel
   instance (flash and LayerNorm);
2. each CUDA kernel against its plain PyTorch version on the card, at the
   main paths' shapes (the flash kernels at head dims 48 and 64 for the
   flagship, 32 for rgb_clip's fusion: 1 and 8 x 275 x 16 x 32 served, 2 x
   275 x 16 x 32 trained; a mesh rank's shapes: 8 and 6 heads under tp=2,
   half the batch under fsdp=2), on all-masked rows with a ragged n and at the
   mma tile edges (n = 17, n = 65, B*H = 96 at n = 300, the fused-qkv views,
   at every head dim), in bf16 and in f32 (TF32 off), with the tolerance it is
   held to: the inference forward, the forward with lse (out and lse) and
   the backward (dq, dk, dv; dq and dk exactly 0 on all-masked rows; two
   calls bitwise equal); q/k/v views that break the 16-byte row rule
   raise in the wrappers and the C entry points and compute nothing (at
   d 32 and d 48, bf16 and f32), while a tp rank's views of its fused
   ``to_qkv`` rows (token strides 1152 and 576) pass; the
   four LayerNorm kernels (out, s, mean, rstd; dx, dscale, dbias) at
   C = 128, 256, 768 and 1024 (1-4 chunks per lane) times R = 1, 2, 5,
   300 and the train step's fusion and vision rows, and at 40000 x 768,
   with constant rows (the f32 dx within 1e-5 x max(1, |plain|) off them,
   and on every row no further from the float64 dx than the plain version
   plus 1e-5 and its own rounding bound; both versions' distance from the
   float64 dx printed on the constant rows); the backward's dx, dscale and dbias bitwise equal
   across two calls, and backward calls of four shapes queued back to
   back on two streams, each equal to its plain version; the f32 head-dim-32
   instances at the transformer decoder's shape (1, 2 and 8 x 577 x 16 x
   32, no mask, q/k/v as three Linear outputs reshaped without a copy) and
   the four LayerNorm kernels at its rows (C = 512, 577 x 1, 2, 8), in bf16
   and f32; then gradients through
   ``dot_product_attention`` (the autograd Function over the kernels) against
   autograd through the plain forward; and ``dot_product_attention("auto")``
   routing by shape (an uninstanced head dim raises);
3. kernel timings: each flash kernel, its plain version and
   ``scaled_dot_product_attention`` as a yardstick (every SDPA backend that
   runs the inputs, pinned and timed; a row takes the fastest and names
   it; the backward's library time is forward+backward minus forward) by
   CUDA events around calls queued behind a sleep kernel (also the
   kernel's profiler device time and back-to-back events), with the bound
   max(FLOP / bf16 peak, bytes / HBM rate), and every f32 instance (the f32
   flagship's fusion and vision shapes, the decoder's 577 tokens) beside
   f32 SDPA (with the names of the CUDA kernels it launched, from the
   profiler) and both f32 bounds, max(FLOP / f32 CUDA-core peak, bytes /
   HBM rate) and max(3 x FLOP / TF32 tensor-core peak, bytes / HBM rate),
   the smaller being the bound (the f32 kernels run 3xTF32); each
   LayerNorm kernel, its
   plain version and ``F.layer_norm`` / ``native_layer_norm_backward`` by
   queued events, profiler device time and back-to-back events, with the
   bound max(bytes / HBM rate, FLOP / f32 CUDA-core peak); the profiler's
   time is reported beside, never gated on;
4. flagship training: SiglipSequential at full width and depth (384 px,
   12-layer SigLIP-base towers, LoRA r8, depth-8 fusion with 16 heads, bf16,
   bimanual, 3 context frames), batch 2, raw frames through the train
   Processor (spatial augmentation on), bce_gaussmap, Adam 1e-4, clip 1.0:
   3 warm-up and 10 timed steps with per-step losses, p50, samples/s, peak
   memory and a profiler breakdown; gates on finite losses, frozen weights
   bitwise unchanged, trainable weights updated, exactly 8 + 12
   forward-with-lse and 8 + 12 backward launches and no inference launch
   per step; then the trained model serves one request through the
   inference kernel only. Then the same under ``BIFOLD_LN_KERNEL=pallas``
   (66 ``ln_fwd`` + 64 ``ln_bwd`` per step) and ``fused`` (64
   ``fused_ln_fwd`` + 2 ``ln_fwd``, 62 ``fused_ln_bwd`` + 2 ``ln_bwd``),
   counts derived from the model's norms; then 10 more steps of each mode,
   the three modes in turns, for a p50 that host drift affects alike;
5. one f32 train step (SGD) through the kernels, through the math path and
   through the kernels under ``BIFOLD_LN_KERNEL=fused``, from the same
   weights, batch and draws: loss and trainable-gradient norm agree; then
   the training entry point (:func:`trainer_cli`): ``main`` of
   ``bifold_tpu_torch.__main__`` trains the bf16 flagship on synthetic
   data for an epoch of 8 steps with pixel eval and ``best``/``last``
   checkpoints (exact launches per step and per eval batch, finite
   metrics, the best checkpoint served), resumes it for a second epoch,
   and holds a fused-mode run interrupted at its third step and resumed
   bitwise equal to an uninterrupted one, and an abandoned loader iterator
   (its thread gone, its batch equal to the batch rebuilt); the Trainer's
   step p50 beside the train step's, checkpoint and resume seconds, and
   (with the profiler, at the end) its device idle share; then the
   Trainer's step p50 and samples/s with ``steps_per_dispatch`` 1 and 8 in
   turns (:func:`trainer_pull_ahead`);
6. flagship serving in each LayerNorm mode (default, ``pallas``,
   ``fused``): 5 ``predict`` requests at 720 px and one ``predict_batch``
   of 8; launch counts per request (20 flash, and 66 LayerNorm forwards in
   the kernel modes), finite outputs of the right shape, the same forward
   through ``backend="math"`` and, in f32, the kernel modes' actions equal
   to the default mode's; predict p50 latency and where its time goes;
7. the deployment half of serving on the same flagship
   (:func:`deployment_phase`): int8 weights, a JAX trainer checkpoint read
   without JAX, batch-1 and batch-8 artifacts and the HTTP daemon, each
   bitwise against the live server with exact launches per request in
   every LayerNorm mode; weight bytes, artifact load times, the daemon's
   coalescing and its p50 beside in-process;
8. the two CLIP families at their composed configs (:func:`serve_family`,
   :func:`trainer_cli_families`): ``rgb_clip`` and ``text_unet`` served
   (bimanual, bf16, seeded weights; requests and a pool of 8 in each
   LayerNorm mode with exact launches: 8 ``fwd_infer_d32`` per rgb_clip
   request, none for text_unet, whose 25 text-tower norms take ``ln_fwd``
   under ``pallas``), the f32 kernel forward against the math path, int8
   decisions as on the CPU, a text_unet checkpoint with BatchNorm
   statistics served bitwise as the live model; each family trained
   through ``main`` (8 steps, eval, best/last; exact launches per step and
   eval batch; text_unet's statistics moved) and text_unet interrupted and
   resumed bitwise; p50s and samples/s; then peak train memory per
   LayerNorm mode;
9. the SigLIP variants of the flagship (:func:`variant_phase`):
   ``pick_place_transdecoder``, ``crossattention`` and 8-expert MoE, each
   at full width with 2-layer towers and fusions (every kernel instance
   and shape as at full depth), served in each LayerNorm mode (5 requests
   and a pool of 8, exact launches: 4 d48 + 2 d64 + 4 f32 d32 per
   transdecoder request, 2 d64 for cross-attention, 2 + 2 for MoE), the
   f32 kernel forward against the math path, int8, JAX-format checkpoint
   and artifact bitwise against the live server (transdecoder and MoE),
   trained through ``main`` (4 steps, eval, exact
   launches per step and eval batch, finite losses and MoE load-balance
   terms, peak memory; the transformer decoder again under ``pallas``, so
   its f32 512-wide LayerNorms train on the kernels: 26 ``ln_fwd`` + 24
   ``ln_bwd`` per step); then one f32 flagship step with and without
   ``remat`` at dropout 0.1 (:func:`remat_phase`: loss and gradient norm
   within 1e-6, exact f32 launches per step, peak memory of each, the
   warm steps' p50 and, from the profiler after both, device busy time
   and idle share);
10. ``text_unet`` with a T5 text encoder (:func:`t5_family`: T5-base and
   Flan-T5-base at full width, served and trained through ``main`` with no
   flash or LayerNorm launch at all; a T5-base checkpoint dir written by
   the port's safetensors writer grafted by the Trainer, bitwise), then
   the configurations the port once refused (:func:`refused_configs`:
   ``rgb_clip`` at 224 px with the transformer-decoder head, 16
   ``fwd_infer_d32`` per request and one bf16 train step with 16
   ``fwd_lse_d32`` + 16 ``bwd_d32``, and with the cross-attention fusion,
   which launches none, each at batch 1 and a pool of 8 with its f32
   kernel forward against the math path; the graph-conditioned flagship
   through the two-dispatch server at batch 1 and 8 observations, 8
   ``fwd_infer_d48`` + 12 ``fwd_infer_d64`` per observation, the host's
   graph build timed, its f32 actions equal to the one-dispatch server's;
   the bf16 flagship served int8 at ``quantize_min_size`` 1024, the stacks'
   one-dim leaves against shared scales, the kernel route against the math
   path), then the closed loop, the simulator on the host and the policy on the card:
   the full-width bf16 flagship through ``ServingPolicy`` in the pooled
   bimanual replay (:func:`closed_loop_bimanual`: 16 samples of a cache
   the port's ``build_cache`` makes, 2 calls of 8; exact flash launches
   per call, a repeated run equal, the sequential evaluator under
   ``pallas`` with 66 ``ln_fwd`` per call, the f32 loop through the
   kernels and through the plain versions deciding the same action at
   every step; the policy's p50s, the host's seconds per sample, actions
   per second and, from the profiler at the end, the card's busy share),
   ``rgb_clip`` at 224 px through the Trainer's ``get_action`` in the
   unimanual pool of 8 over all 5 tasks x 3 regimes
   (:func:`closed_loop_unimanual`: 8 ``fwd_infer_d32`` per call) and
   ``main`` with ``simulator=softgym`` (:func:`trainer_softgym`: 2 steps
   under ``pallas``, the closed loop as the final eval with its keys in
   ``eval_synthetic.yaml``, the ``visualize_*`` PNGs, one task through
   the port's daemon on 127.0.0.1 recording the in-process summary; in a
   process of its own, ``softgym-cli``, beside the unimanual loop), then
   the port's last host modules (:func:`host_tools_and_gif`, in a process
   of its own, ``host-tools``, beside the unimanual loop too: the flagship
   through ``ServingPolicy`` at batch 1 in a 2-instruction bimanual rollout
   on ``ClothEnv(dump_visualizations=True)``, written by ``render_gif``,
   exact flash launches per call, the GIF's frames read back from its
   graphic-control blocks; the ``pyflex_compat`` cloth scene on the C++
   core repeated bitwise, every ``env/scenes.py`` scene stepped, an
   ``XMLModel`` edit), then data parallelism: ``python -m torch.distributed.run --nproc_per_node 1``
   over ``main`` on the flagship (:func:`dp_nccl`: a one-rank NCCL group,
   bitwise equal to the run without the launcher, steps and checkpoints)
   and two gloo ranks on the one card (:func:`dp_two_ranks`: the f32
   flagship and f32 text_unet, each rank's half of a global batch of 2
   within 1e-4 of the one-process step, running statistics within 1e-5,
   the ranks bitwise equal, each rank's flash launches the one-process
   step's); then fsdp and tp with two gloo ranks on the card
   (:func:`mesh_two_ranks`: the f32 flagship step under ``{fsdp: 2}`` and
   ``{tp: 2}`` against one process's, 1e-5 and 1e-6, exact launches per
   rank at the heads each rank runs, bytes held per rank, a tp step at
   dropout 0.1 under ``fused``; the server under ``{tp: 2}`` and ``{dp:
   2}`` in f32, and bf16 int8 under tp; ``export`` refused) and ``main``
   under ``mesh.fsdp=2`` and ``mesh.tp=2`` (:func:`mesh_cli`: steps, eval,
   checkpoints served by one process in f32, a stopped and resumed run
   bitwise); then pp and ep with two gloo ranks (:func:`mesh_axes_two_ranks`:
   the f32 flagship step under ``{pp: 2}``, its three stacks as GPipe pipes,
   against one process's, 1e-6 and 1e-8, each stage's exact launches per
   microbatch, eval through the pipe, the step under ``pallas`` with each
   stage's LayerNorm launches; the f32 MoE variant under ``{ep: 2}`` and
   ``{dp: 2}`` at a capacity that drops tokens against one process routing
   as JAX routes), ring attention over three gloo ranks
   (:func:`ring_three_ranks`: sp = 3 at the tower's and the fusion's
   shapes, bf16 and f32, forward and backward, a wholly masked chunk,
   against the single-device kernels) and the daemon's ``--mesh tp=2``
   (:func:`daemon_mesh`: HTTP to rank 0, actions equal to an in-process
   sharded server's, exact launches per rank, a clean stop); each worker
   is this script run with arguments (``dp-cli``, ``dp-rank``,
   ``mesh-rank``, ``mesh-cli``, ``axes-rank``, ``ring-rank``,
   ``daemon-rank``, ``serve-rank``); these multi-rank phases run the
   flagship at its full widths and heads but at a cut depth
   (:func:`cut_depth`: 2-layer towers and a 2-layer fusion, their launch
   counts re-derived), and ``mesh_two_ranks`` also an f32 fsdp step of an
   odd-width flagship whose stacked leaves fsdp shards along their depth,
   and its advise sweep an MoE layout at JAX's static capacity;
11. the script's seconds, the ``kernels`` line (twenty-two kernel
   instances: the flash kernels at three head dims in bf16, and in f32
   those a main path launches (the decoder's d32, the f32 flagship's d48
   and d64 forward with lse and backward in remat_phase and
   mesh_two_ranks, and its inference forwards in mesh_two_ranks' server),
   with their ptxas numbers (f32 rows: both
   bounds, FMA and 3xTF32, and the library's kernel names); the LayerNorm rows
   with those of their bf16 C = 768 instance and their largest f32 error
   at the decoder's C = 512 rows; each row names its design; its launches
   are the sum of the main paths' own counts, the data-parallel and mesh
   workers' included), then the card line, then the result line ``{"ok": true,
   "device": {...}}``.

Each path's launch counts are reset just before it and read just after.
Every torch.profiler session (the ``where_the_time_goes`` windows and the
kernel device timings, so phase 3 runs last) comes after every host-clock
measurement: once the profiler has traced the card, later launches in the
process cost more host time.
Any failed phase raises, so the exit code is non-zero and no result line is
printed; so does a machine without a CUDA card. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
# requests per latency p50, each call in turns
LATENCY_ROUNDS = 5
INSTRUCTIONS = ("fold the left sleeve to the center",
                "fold the towel in half from bottom to top",
                "fold the right sleeve in", "fold the tshirt in half",
                "flatten the cloth")
# dense bf16 tensor-core rate, memory rate, f32 CUDA-core rate and dense
# TF32 tensor-core rate (NVIDIA data sheets)
_PEAKS = {"PCIe": (756e12, 2.0e12, 51e12, 378e12),
          "NVL": (835e12, 3.9e12, 60e12, 417e12),
          "H200": (989e12, 4.8e12, 67e12, 495e12),
          "H100": (989e12, 3.35e12, 67e12, 495e12)}
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


def edge_cases():
    """(label, b, n, h, d, fused, masking) of the tile edges, at every head
    dim: n = 17 (one partial 16-row mma tile of a 64-row block) and n = 65
    (one row past a full block), each with an all-masked batch row; B*H =
    96 at n = 300 with all-masked rows; the fused-qkv strided views at
    d 64 (the fusion cases take them at d 48 and d 32)."""
    cases = []
    for d in HEAD_DIMS:
        cases += [("n=17, all-masked rows", 2, 17, 3, d, True, "rows"),
                  ("n=65, all-masked rows", 2, 65, 3, d, False, "rows"),
                  ("B*H=96, n=300, all-masked rows", 8, 300, 12, d, d == 64,
                   "rows")]
    return cases + [("fused qkv views, d 64", 2, 576, 12, 64, True, None)]


def check_kernels(fa):
    """Phase 2: the inference kernel against its plain version. Returns the
    largest error per kernel name (``<name>_f32`` for the f32 instances)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {f"flash_fwd_infer_d{d}{suffix}": 0.0 for d in HEAD_DIMS
             for suffix in ("", "_f32")}
    cases = [("fusion, 1 context frame masked", 1, 2373, 16, 48, True, 1),
             ("fusion, 2 context frames masked", 1, 2373, 16, 48, True, 2),
             ("vision", 4, 576, 12, 64, False, None),
             ("rgb_clip fusion, batch 1", 1, 275, 16, 32, True, None),
             ("rgb_clip fusion, pool of 8", 8, 275, 16, 32, True, None)]
    cases += TP_CASES["infer"]
    cases += [("ragged n=300, all-masked rows", 2, 300, 3, d, False, "rows")
              for d in HEAD_DIMS]
    cases += edge_cases()
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
            name = f"flash_fwd_infer_d{d}" + ("" if dtype == torch.bfloat16 else "_f32")
            worst[name] = max(worst[name], err)
    return worst


# the flash kernels' instances: the flagship's fusion (48) and SigLIP
# vision (64) stacks, rgb_clip's fusion stack (32)
HEAD_DIMS = (32, 48, 64)
# the shapes a rank of a mesh launches at: under tp=2 half the heads (the
# fusion's q, k, v views of the rank's to_qkv rows, 3 x 384 wide), under
# fsdp=2 half the batch
TP_CASES = {
    "infer": [("fusion, tp=2 rank: 8 heads", 1, 2373, 8, 48, True, 1),
              ("vision, tp=2 rank: 6 heads", 4, 576, 6, 64, False, None)],
    "train": [("fusion, tp=2 rank: 8 heads", 2, 2373, 8, 48, True, 1),
              ("vision, tp=2 rank: 6 heads", 8, 576, 6, 64, False, None),
              ("fusion, fsdp=2 rank: batch 1", 1, 2373, 16, 48, True, 1),
              ("vision, fsdp=2 rank: batch 4", 4, 576, 12, 64, False, None)]}
# the train steps' shapes: (B, N, H, fused qkv views)
TRAIN_SHAPES = {48: (2, 2373, 16, True), 64: (8, 576, 12, False),
                32: (2, 275, 16, True)}


def train_cases():
    """(label, b, n, h, d, fused, masking) of the training kernels' checks:
    the train steps' shapes, and the ragged n=300 case with all-masked rows
    at every head dim (every other one also feeds check_function_grads)."""
    b48, n48, h48, _ = TRAIN_SHAPES[48]
    b64, n64, h64, _ = TRAIN_SHAPES[64]
    b32, n32, h32, _ = TRAIN_SHAPES[32]
    return [("fusion, 1 context frame masked", b48, n48, h48, 48, True, 1),
            ("vision", b64, n64, h64, 64, False, None),
            ("ragged n=300, all-masked rows", 2, 300, 3, 48, False, "rows"),
            ("ragged n=300, all-masked rows", 2, 300, 3, 64, False, "rows"),
            ("rgb_clip fusion", b32, n32, h32, 32, True, None),
            ("ragged n=300, all-masked rows", 2, 300, 3, 32, False, "rows")]


def train_check_cases():
    """:func:`train_cases`, the tile edges (:func:`edge_cases`) and a mesh
    rank's shapes (:data:`TP_CASES`)."""
    return train_cases() + edge_cases() + TP_CASES["train"]


def within_lse(out, ref):
    """lse is f32 whatever the inputs: 1e-4 of max(1, |plain|) (an all-masked
    row's lse is -1e5 + log(nk), where one f32 ulp is 0.0078)."""
    err = (out - ref).abs()
    return float(err.max()), "1e-4 * max(1, |plain|)", bool(
        (err <= F32_TOL * ref.abs().clamp_min(1)).all())


def check_train_kernels(fa):
    """The forward-with-lse and backward kernels against their plain
    versions, in bf16 and in f32; dq and dk exactly 0 on all-masked rows;
    dq, dk and dv bitwise equal across two backward calls on the same
    inputs. Returns the largest error per kernel name (``<name>_f32`` for
    the f32 instances)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, n, h, d, fused, masking in train_check_cases():
            q, k, v = attention_inputs(gen, b, n, h, d, dtype, fused)
            mask = case_mask(gen, b, n, masking)
            do = torch.randn(b, n, h, d, device="cuda", generator=gen).to(dtype)
            out, lse = fa.flash_attention_fwd(q, k, v, mask)
            grads = fa.flash_attention_bwd(q, k, v, mask, out, lse, do)
            again = fa.flash_attention_bwd(q, k, v, mask, out, lse, do)
            torch.cuda.synchronize()
            repeat = all(torch.equal(x, y) for x, y in zip(grads, again))
            emit({"phase": "flash_bwd_deterministic", "kernel": f"flash_bwd_d{d}",
                  "case": label, "dtype": str(dtype), "bitwise_equal": repeat})
            if not repeat:
                raise AssertionError(f"flash_bwd_d{d}: two calls differ: {label}")
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
                name = f"{kernel}_d{d}" + ("" if dtype == torch.bfloat16 else "_f32")
                worst[name] = max(worst.get(name, 0.0), err)
            if zero_rows:
                emit({"phase": "all_masked_rows", "kernel": f"flash_bwd_d{d}",
                      "dtype": str(dtype), "max_abs": zero_rows})
                if any(zero_rows.values()):
                    raise AssertionError(f"flash_bwd_d{d}: dq/dk not exactly 0 "
                                         "on all-masked rows")
    return worst


# views that break the kernels' 16-byte row rule, per dtype: one starting
# one element past a 16-byte boundary, and one whose token stride is not a
# multiple of 16 bytes (h*d + 4 bf16 elements, h*d + 2 f32 elements)
MISALIGNED = {torch.bfloat16: ("2 bytes past 16", 4), torch.float32: ("4 bytes past 16", 2)}


def check_alignment(fa, d=48, dtype=torch.bfloat16):
    """At head dim ``d`` in ``dtype``: q, k or v views that break the
    kernels' 16-byte row rule (:data:`MISALIGNED`) raise and compute
    nothing. The wrappers raise before any launch; the C entry points,
    called directly, return cudaErrorMisalignedAddress and leave their
    outputs untouched."""
    from bifold_tpu_torch.ops._cuda import DTYPE_CODES, launch

    b, n, h = 2, 300, 2
    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    past, extra = MISALIGNED[dtype]
    good = randn(b, n, h, d)
    bad = {past: randn(b * n * h * d + 8)[1:1 + b * n * h * d].view(b, n, h, d),
           f"token stride h*d+{extra}": randn(b, n, h * d + extra)[..., :h * d].view(b, n, h, d)}
    lse = torch.zeros(b, h, n, device="cuda")
    before = launch_counts()
    for label, view in bad.items():
        calls = {"flash_attention": lambda: fa.flash_attention(view, good, good),
                 "flash_attention_fwd": lambda: fa.flash_attention_fwd(good, view, good),
                 "flash_attention_bwd": lambda: fa.flash_attention_bwd(
                     good, good, view, None, good, lse, good)}
        for name, call in calls.items():
            try:
                call()
            except ValueError:
                continue
            raise AssertionError(f"{name} took a misaligned view: {label}, {dtype}")
        sentinel = [torch.full((b, n, h, d), float("nan"), device="cuda",
                               dtype=dtype) for _ in range(3)]
        strides = fa._strides(view, good, good)
        c_calls = {
            "bifold_flash_fwd_infer": ("flash_fwd", [view.data_ptr(), good.data_ptr(),
                                                     good.data_ptr(), None,
                                                     sentinel[0].data_ptr()]),
            "bifold_flash_bwd": ("flash_bwd", [view.data_ptr(), good.data_ptr(),
                                               good.data_ptr(), None, good.data_ptr(),
                                               lse.data_ptr(), lse.data_ptr()]
                                 + [t.data_ptr() for t in sentinel])}
        for fn_name, (source, ptrs) in c_calls.items():
            try:
                launch(source, fn_name, good.device, *ptrs, b, n, n, h, d, strides,
                       d ** -0.5, DTYPE_CODES[dtype])
            except RuntimeError as err:
                if "misaligned" not in str(err):
                    raise
            else:
                raise AssertionError(f"{fn_name} took a misaligned view: {label}, {dtype}")
        torch.cuda.synchronize()
        if not all(bool(t.isnan().all()) for t in sentinel):
            raise AssertionError(f"a refused call wrote its output: {label}, {dtype}")
    launched = launched_since(before)
    emit({"phase": "alignment_refused", "head_dim": d, "dtype": str(dtype),
          "cases": list(bad), "launches": launched})
    if launched:
        raise AssertionError(f"refused calls counted launches: {launched}")


def check_tp_views(fa):
    """The per-rank views of a tensor-parallel fused projection pass the
    wrappers' 16-byte row rule: q, k and v of a rank's ``to_qkv`` rows
    (token stride 3 x heads/tp x 48: 1152 elements at tp=2, 576 at tp=4),
    in bf16 and f32, each within its plain version's tolerance."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for tp in (2, 4):
            q, k, v = attention_inputs(gen, 1, 300, 16 // tp, 48, dtype, True)
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            err, tol, ok = within(out, fa.flash_attention_plain(q, k, v), dtype)
            rows.append({"tp": tp, "dtype": str(dtype), "token_stride": q.stride(1),
                         "max_abs_err": err, "tol": tol, "ok": ok})
            if not ok:
                raise AssertionError(f"tp={tp} to_qkv views disagree with plain ({dtype})")
    emit({"phase": "tp_views_accepted", "cases": rows})


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
                    for key in (f"fwd_lse_d{d}_f32", f"bwd_d{d}_f32",
                                f"fwd_infer_d{d}_f32")}
        ref = torch.autograd.grad(fa.flash_attention_plain(*leaves, mask), leaves, do)
        errs = {g: float((x - r).abs().max()) for g, x, r in zip("qkv", got, ref)}
        tol = {"q": F32_TOL, "k": F32_TOL,
               "v": 2e-3 if masking == "rows" else F32_TOL}
        emit({"phase": "function_grads_vs_autograd_plain", "case": label,
              "shape": [b, n, h, d], "max_abs_err": errs, "tol": tol,
              "launches": launched})
        if any(errs[g] > tol[g] for g in tol) or launched != {
                f"fwd_lse_d{d}_f32": 1, f"bwd_d{d}_f32": 1, f"fwd_infer_d{d}_f32": 0}:
            raise AssertionError(f"gradients through the kernels: {label}")
        out.append(errs)
    return out


def check_auto_route(fa):
    """``dot_product_attention("auto")`` on the card chooses by shape, as
    JAX does: N >= 256 launches the kernel at every instanced head dim; an
    uninstanced head dim (16) raises instead of taking the math path; N <
    256 takes the math path and launches nothing."""
    from bifold_tpu_torch.ops.attention import dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(9)
    got = {}
    for d in HEAD_DIMS:
        q, k, v = attention_inputs(gen, 1, 275, 4, d, torch.bfloat16, True)
        before = launch_counts()
        dot_product_attention(q, k, v)
        got[d] = launched_since(before)
    q, k, v = attention_inputs(gen, 1, 275, 4, 16, torch.bfloat16, True)
    try:
        dot_product_attention(q, k, v)
        refused = False
    except ValueError:
        refused = True
    q, k, v = attention_inputs(gen, 1, 197, 4, 16, torch.bfloat16, False)
    before = launch_counts()
    dot_product_attention(q, k, v)
    short = launched_since(before)
    emit({"phase": "auto_route", "launches_by_head_dim": got,
          "uninstanced_head_dim_raises": refused, "n197_launches": short})
    if (got != {d: {f"fwd_infer_d{d}": 1} for d in HEAD_DIMS} or not refused
            or short):
        raise AssertionError("dot_product_attention('auto') routed otherwise")


# the transformer decoder's attention (pick_place_transdecoder): f32, 577
# tokens (a cls slot and 24 x 24 patches), 16 heads of 32, no key mask: a
# request, a train batch, a pool
DECODER_BATCHES = {"request": 1, "train batch": 2, "pool": 8}
DECODER_TOKENS, DECODER_HEADS, DECODER_WIDTH = 577, 16, 512


def decoder_qkv(gen, b):
    """q, k, v as the decoder's blocks hand them over: the outputs of three
    biased f32 Linear layers (fused_qkv=False) on one (B, 577, 512) input,
    each reshaped to (B, 577, 16, 32) without a copy."""
    x = torch.randn(b, DECODER_TOKENS, DECODER_WIDTH, device="cuda", generator=gen)
    out = []
    for _ in range(3):
        w = torch.randn(DECODER_WIDTH, DECODER_WIDTH, device="cuda",
                        generator=gen) * DECODER_WIDTH ** -0.5
        bias = 0.1 * torch.randn(DECODER_WIDTH, device="cuda", generator=gen)
        y = torch.nn.functional.linear(x, w, bias)
        view = y.reshape(b, DECODER_TOKENS, DECODER_HEADS, DECODER_WIDTH // DECODER_HEADS)
        if view.data_ptr() != y.data_ptr():
            raise AssertionError("the decoder's q/k/v reshape copied")
        out.append(view)
    return out


def check_decoder_flash(fa):
    """The f32 head-dim-32 instances at the transformer decoder's shape,
    before any model phase: the inference forward, the forward with lse
    (out and lse) and the backward (dq, dk, dv; two calls bitwise equal)
    against their plain versions on q/k/v as :func:`decoder_qkv` makes
    them, which the wrappers take as they are (no copy on the main path).
    Returns the largest error per kernel name (``_f32``)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    worst = {}
    for label, b in DECODER_BATCHES.items():
        q, k, v = decoder_qkv(gen, b)
        do = torch.randn(q.shape, device="cuda", generator=gen)
        out = fa.flash_attention(q, k, v)
        out_l, lse = fa.flash_attention_fwd(q, k, v)
        grads = fa.flash_attention_bwd(q, k, v, None, out_l, lse, do)
        again = fa.flash_attention_bwd(q, k, v, None, out_l, lse, do)
        torch.cuda.synchronize()
        repeat = all(torch.equal(x, y) for x, y in zip(grads, again))
        p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v)
        p_grads = fa.flash_attention_bwd_plain(q, k, v, None, out_l, lse, do)
        results = [("flash_fwd_infer", "out", *within(out, p_out, torch.float32)),
                   ("flash_fwd_lse", "out", *within(out_l, p_out, torch.float32)),
                   ("flash_fwd_lse", "lse", *within_lse(lse, p_lse))]
        results += [("flash_bwd", g, *within(x, ref, torch.float32))
                    for g, x, ref in zip(("dq", "dk", "dv"), grads, p_grads)]
        for kernel, what, err, tol, ok in results:
            emit({"phase": "kernel_vs_plain", "kernel": f"{kernel}_d32",
                  "output": what, "case": f"transformer decoder, {label}",
                  "shape": list(q.shape), "dtype": "torch.float32",
                  "qkv_strides": list(q.stride()), "max_abs_err": err, "tol": tol,
                  "ok": ok})
            if not ok:
                raise AssertionError(f"{kernel}_d32 f32 {what} disagrees with plain: "
                                     f"decoder {label}")
            worst[f"{kernel}_d32_f32"] = max(worst.get(f"{kernel}_d32_f32", 0.0), err)
        emit({"phase": "flash_bwd_deterministic", "kernel": "flash_bwd_d32",
              "case": f"transformer decoder, {label}", "dtype": "torch.float32",
              "bitwise_equal": repeat})
        if not repeat:
            raise AssertionError(f"flash_bwd_d32 f32: two calls differ: decoder {label}")
    return worst


def queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: CUDA events around ``iters`` calls queued
    behind a sleep kernel, so that the card runs them back to back however
    long the host takes to enqueue them (the sleep is lengthened until it
    outlasts the enqueue). Unlike the profiler's device time
    (:func:`device_ms`), which reads low in a process that has already run
    many profiler sessions, it reads the same anywhere in the script."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 10 ** 8                       # ~50 ms at 2 GHz
    while True:
        slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t) * 1e3
        end.synchronize()
        if host_ms < slept.elapsed_time(start):
            return start.elapsed_time(end) / iters
        cycles *= 4


def both_times(fn) -> dict:
    """``ms``: device time per call (:func:`queued_ms`); ``profiler_ms``:
    the profiler's (:func:`device_ms`); ``event_ms``: CUDA events over
    back-to-back calls, which time the host for a call shorter than its
    host enqueue."""
    return {"ms": queued_ms(fn), "profiler_ms": device_ms(fn), "event_ms": time_ms(fn)}


# the shapes each instance is timed at, from the main paths: (B, N, H,
# fused qkv views); in bf16 the flagship's fusion (all 3 context frames
# present) and vision, rgb_clip's fusion; in f32 the same flagship stacks
# (the f32 model's) and the transformer decoder
INFER_TIMING = {torch.bfloat16: {48: (1, 2373, 16, True), 64: (4, 576, 12, False),
                                 32: (1, 275, 16, True)},
                torch.float32: {48: (1, 2373, 16, True), 64: (4, 576, 12, False),
                                32: (1, DECODER_TOKENS, DECODER_HEADS, False)}}


def timing_key(name, dtype):
    return name + ("" if dtype == torch.bfloat16 else "_f32")


def time_kernels(fa, peaks, dtype=torch.bfloat16):
    """The kernel, its plain version and SDPA (its fastest backend) at the
    main paths' shapes (:data:`INFER_TIMING`), by device time and by CUDA
    events (:func:`both_times`); the f32 rows carry both f32 bounds
    (:func:`bound`)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for d, (b, n, h, fused) in INFER_TIMING[dtype].items():
        q, k, v = attention_inputs(gen, b, n, h, d, dtype, fused)
        mask = fusion_mask(b, n, 0) if d == 48 else None
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_mask = None if mask is None else (mask != 0)[:, None, None, :]
        library = sdpa_times(qt, kt, vt, sdpa_mask)
        backend = min(library, key=lambda name: library[name][0])
        valid = n if mask is None else int(mask.sum()) // b
        size = q.element_size()
        fwd_bound = bound(4.0 * b * h * n * valid * d,
                          size * 4.0 * b * n * h * d + (0 if mask is None else 4 * b * n),
                          peaks, dtype)
        kernel = both_times(lambda: fa.flash_attention(q, k, v, mask))
        plain = queued_ms(lambda: fa.flash_attention_plain(q, k, v, mask))
        rows[timing_key(f"flash_fwd_infer_d{d}", dtype)] = {
            **kernel, "plain_ms": plain,
            "library_ms": library[backend][0], "library_backend": backend,
            "library_by_backend": library,
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], **fwd_bound[2],
            "shape": [b, n, h, d], "dtype": str(dtype)}
    return rows


def bound(flops, nbytes, peaks, dtype=torch.bfloat16):
    """(ms, "operations" or "bytes", the f32 bounds by name): max(operations
    / peak, bytes / memory rate), in ms. bf16: the dense bf16 tensor-core
    peak. f32 work reaches f32 accuracy two ways, each named in the third
    item: FMA on the CUDA cores (``bound_fma_ms``: FLOP / the f32 peak) and
    3xTF32 on the tensor cores (``bound_3xtf32_ms``: 3 x FLOP / the dense
    TF32 peak, the f32 kernels' design); the least time is the smaller."""
    bytes_ms = nbytes / peaks[1] * 1e3
    named = {}
    if dtype == torch.bfloat16:
        ops_ms = flops / peaks[0] * 1e3
    else:
        named = {"bound_fma_ms": max(flops / peaks[2] * 1e3, bytes_ms),
                 "bound_3xtf32_ms": max(3 * flops / peaks[3] * 1e3, bytes_ms)}
        ops_ms = min(flops / peaks[2], 3 * flops / peaks[3]) * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", named


SDPA_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH")


def sdpa_call(qt, kt, vt, sdpa_mask, dot=None):
    """One SDPA forward, or with the output cotangent ``dot`` forward and
    backward, on (B, H, N, D) inputs."""
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=sdpa_mask)
    return out if dot is None else torch.autograd.grad(out, (qt, kt, vt), dot)


def library_kernels(backend, call, iters: int = 20):
    """The CUDA kernels ``call`` launches under the SDPA ``backend``, by
    name, from the profiler over ``iters`` calls (late in a process it
    records only some of a window's kernels; run after every host-clock
    measurement): it shows how the library computes f32 attention (a
    CUTLASS kernel on the tensor cores, or f32 GEMMs on the CUDA cores)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    with sdpa_kernel(getattr(SDPBackend, backend)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
    return sorted({e.key[:160] for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def f32_library_kernels():
    """{f32 timing row: {SDPA backend: CUDA kernel names}} at the shapes
    :func:`time_kernels` and :func:`time_train_kernels` time the f32 rows
    at (forward, or forward and backward for a backward row), for every
    backend that runs them."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    names = {}
    for kinds, shapes in ((("flash_fwd_infer",), INFER_TIMING),
                          (("flash_fwd_lse", "flash_bwd"), TRAIN_TIMING)):
        for d, (b, n, h, fused) in shapes[torch.float32].items():
            q, k, v = attention_inputs(gen, b, n, h, d, torch.float32, fused)
            mask = fusion_mask(b, n, 0) if d == 48 else None
            qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
            sdpa_mask = None if mask is None else (mask != 0)[:, None, None, :]
            dot = torch.randn(qt.shape, device="cuda", generator=gen)
            for kind in kinds:
                grad = None if kind.startswith("flash_fwd") else dot
                row = names.setdefault(timing_key(f"{kind}_d{d}", torch.float32), {})
                for backend in SDPA_BACKENDS:
                    try:                 # a backend refuses what it lacks
                        row[backend] = library_kernels(
                            backend, lambda: sdpa_call(qt, kt, vt, sdpa_mask, grad))
                    except RuntimeError:
                        continue
    return names


def sdpa_times(qt, kt, vt, sdpa_mask, dot=None):
    """The library yardstick: for each SDPA backend that runs these inputs
    (pinned with ``sdpa_kernel``, so each time names what it timed), device
    ms (:func:`queued_ms`) of the forward and, given the output cotangent
    ``dot``, of forward + backward: {backend: [forward ms, forward+backward
    ms or None]}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def forward():
        return sdpa_call(qt, kt, vt, sdpa_mask)

    def both():
        return sdpa_call(qt, kt, vt, sdpa_mask, dot)

    times = {}
    for name in SDPA_BACKENDS:
        with sdpa_kernel(getattr(SDPBackend, name)):
            try:                         # a backend refuses what it lacks
                forward() if dot is None else both()
            except RuntimeError:
                continue
            times[name] = [queued_ms(forward), None if dot is None else queued_ms(both)]
    if not times:
        raise AssertionError("no SDPA backend runs these inputs")
    return times


TRAIN_TIMING = {torch.bfloat16: TRAIN_SHAPES,
                torch.float32: {48: TRAIN_SHAPES[48], 64: TRAIN_SHAPES[64],
                                32: (2, DECODER_TOKENS, DECODER_HEADS, False)}}


def time_train_kernels(fa, peaks, dtype=torch.bfloat16):
    """The forward-with-lse and backward kernels, their plain versions and
    SDPA (forward with grad, and forward + backward: the backward's library
    time is the difference; each row takes the backend fastest at its part)
    at the train steps' shapes (:data:`TRAIN_TIMING`: the flagship's fusion
    B=2 with all 3 context frames present and vision 8 frames; rgb_clip's
    fusion in bf16, the transformer decoder's train batch in f32, unmasked),
    by device time and by CUDA events (:func:`both_times`; the backward's
    device time includes delta's torch ops)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = {}
    for d, (b, n, h, fused) in TRAIN_TIMING[dtype].items():
        q, k, v = attention_inputs(gen, b, n, h, d, dtype, fused)
        mask = fusion_mask(b, n, 0) if d == 48 else None
        do = torch.randn(b, n, h, d, device="cuda", generator=gen).to(dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, mask)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
        sdpa_mask = None if mask is None else (mask != 0)[:, None, None, :]
        library = sdpa_times(qt, kt, vt, sdpa_mask, do.transpose(1, 2))
        lib_fwd = min(library, key=lambda name: library[name][0])
        lib_bwd = min(library, key=lambda name: library[name][1] - library[name][0])
        kept = n if mask is None else int(mask.sum()) // b
        act = b * n * h * d * q.element_size()    # one (B, N, H, D) tensor
        mask_bytes = 0 if mask is None else 4 * b * n
        lse_bytes = 4 * b * h * n
        fwd_bound = bound(4.0 * b * h * n * kept * d,
                          4 * act + mask_bytes + lse_bytes, peaks, dtype)
        bwd_bound = bound(10.0 * b * h * n * kept * d,
                          8 * act + mask_bytes + lse_bytes, peaks, dtype)
        fwd = both_times(lambda: fa.flash_attention_fwd(q, k, v, mask))
        fwd_plain = queued_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, mask))
        bwd = both_times(lambda: fa.flash_attention_bwd(q, k, v, mask, out, lse, do))
        bwd_plain = queued_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, mask, out, lse, do))
        rows[timing_key(f"flash_fwd_lse_d{d}", dtype)] = {
            **fwd, "plain_ms": fwd_plain,
            "library_ms": library[lib_fwd][0], "library_backend": lib_fwd,
            "library_by_backend": library,
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], **fwd_bound[2],
            "shape": [b, n, h, d], "dtype": str(dtype)}
        rows[timing_key(f"flash_bwd_d{d}", dtype)] = {
            **bwd, "plain_ms": bwd_plain,
            "library_ms": library[lib_bwd][1] - library[lib_bwd][0],
            "library_backend": lib_bwd,
            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], **bwd_bound[2],
            "shape": [b, n, h, d], "dtype": str(dtype)}
    return rows


LN_KERNELS = ("ln_fwd", "ln_bwd", "fused_ln_fwd", "fused_ln_bwd")
LN_LINES = {"ln_fwd": 141, "ln_bwd": 199, "fused_ln_fwd": 271, "fused_ln_bwd": 322}
LN_WHERE = {"ln_fwd": "BIFOLD_LN_KERNEL=pallas|fused: training and serving",
            "ln_bwd": "BIFOLD_LN_KERNEL=pallas|fused: training",
            "fused_ln_fwd": "BIFOLD_LN_KERNEL=fused: training and serving",
            "fused_ln_bwd": "BIFOLD_LN_KERNEL=fused: training"}
LN_DESIGN = {"ln_fwd": "one warp per row, row held in registers",
             "ln_bwd": "one cooperative launch: rows staged per warp by 1-D bulk TMA "
                       "(2-slot ring), partials per block, grid sync, column sums"}
# the train step's LayerNorm rows (B * N, 768) and eps: fusion 2 x 2373
# tokens, eps 1e-5; vision 8 frames x 576 patches, eps 1e-6
LN_SHAPES = {"fusion": ((2, 2373, 768), 1e-5), "vision": ((8, 576, 768), 1e-6)}
LN_F32_TOL = 1e-5
LN_STAT_RTOL = 1e-5
LN_PARAM_TOL = 1e-4


def ln_inputs(gen, shape, dtype):
    """x, delta, dy, ds_out in ``dtype`` and float32 scale and bias. With
    three rows or more, two middle rows of x are constant (1.25 and 1.0),
    and so are those rows of s = x + delta (1.25, with delta 0 and 0.25):
    their sums are exact in any order, so their variance is exactly 0 and
    the clamp and rstd = 1/sqrt(eps) are exercised."""
    c = shape[-1]

    def randn(*s):
        return torch.randn(*s, device="cuda", generator=gen)

    x, delta = randn(*shape) * 2 + 0.5, randn(*shape) * 0.5
    flat_x, flat_d = x.view(-1, c), delta.view(-1, c)
    mid = flat_x.shape[0] // 2
    if flat_x.shape[0] >= 3:
        flat_x[mid], flat_d[mid] = 1.25, 0.0
        flat_x[mid - 1], flat_d[mid - 1] = 1.0, 0.25
    rows = [t.to(dtype) for t in (x, delta, randn(*shape), randn(*shape))]
    return (*rows, randn(c) * 0.1 + 1.0, randn(c) * 0.1)


def ln_close(out, ref, what, dtype, exact=None, against_plain=True, rows=None):
    """(max |err| from the plain version, tolerance text, ok, within the
    plain version's bound everywhere) of one LayerNorm output. The bound is
    tol x max(1, |plain|): tol is LN_PARAM_TOL for dscale and dbias, 2^-7
    for bf16 rows and LN_F32_TOL for f32 rows; s is bitwise, rstd within
    LN_STAT_RTOL x |plain|, and the mean within LN_STAT_RTOL x |plain| +
    2 C u mean|row| (u = 2^-24; ``rows``, the rows it is the mean of): each
    version's f32 row sum, in whatever order it adds, is within (C - 1) u
    sum|row| of the exact sum (Higham), so the two means are within 2 C u
    mean|row| of each other, which a purely relative bound misses on a row
    whose mean cancels to near 0. A mean that leaves out or doubles one
    element is off by about mean|row| / C: 2^23 / C^2 times that term,
    8 times or more for C <= 1024. rstd keeps the relative bound: its sum
    is of squares.
    ``exact`` (the backward's float64 result on the same inputs,
    :func:`ln_exact`) adds two checks beside it: dscale and dbias within
    LN_PARAM_TOL x max(1, |float64|) of it, and an f32 dx no further from
    it than the plain version is, plus LN_F32_TOL x max(1, |plain|), plus
    the rounding bound of the kernel's two f32 row sums times rstd
    (``exact["sum_bound"]``). That float64 check alone holds an f32 dx on
    the constant rows: there rstd = 1/sqrt(eps) (up to 1000) multiplies
    the last ulps of the plain version's own row means (the kernel sums
    them with compensation), so the two versions may be more than 1e-5
    apart while the kernel is the nearer to float64.
    ``against_plain`` False leaves the bound out of ``ok`` (dscale and dbias
    over many rows, :func:`ln_against_plain`). The fourth value reports the
    bound on every element whether or not it is required."""
    err = (out.float() - ref.float()).abs()
    if what == "s":
        ok = bool(torch.equal(out, ref))
        return float(err.max()), "bitwise", ok, ok
    if what == "mean":
        c = rows.shape[-1]
        cancel = 2 * c * 2.0 ** -24 * rows.float().abs().mean(-1)
        ok = bool((err <= LN_STAT_RTOL * ref.abs() + cancel.reshape(ref.shape)).all())
        return (float(err.max()), f"{LN_STAT_RTOL} * |plain| + 2 C 2^-24 mean|row|",
                ok, ok)
    if what == "rstd":
        ok = bool((err <= LN_STAT_RTOL * ref.abs()).all())
        return float(err.max()), f"{LN_STAT_RTOL} * |plain|", ok, ok
    if what in ("dscale", "dbias"):
        tol = LN_PARAM_TOL
    else:
        tol = 2.0 ** -7 if dtype == torch.bfloat16 else LN_F32_TOL
    name = "2^-7" if tol == 2.0 ** -7 else str(tol)
    plain_allowed = tol * ref.double().abs().clamp_min(1)
    if exact is not None and what == "dx" and dtype == torch.float32:
        checks = [(f"{name} * max(1, |plain|) off the constant rows",
                   err.double().masked_fill(exact["constant"], 0.0), plain_allowed,
                   against_plain)]
    else:
        checks = [(f"{name} * max(1, |plain|)", err.double(), plain_allowed,
                   against_plain)]
    if exact is not None and what in ("dscale", "dbias"):
        checks.append((f"{name} * max(1, |float64 sum|) from it",
                       (out.double() - exact[what]).abs(),
                       tol * exact[what].abs().clamp_min(1), True))
    if exact is not None and what == "dx" and dtype == torch.float32:
        checks.append((f"|plain - float64 dx| + {name} * max(1, |plain|) + rstd x the "
                       "row sums' rounding bound from it",
                       (out.double() - exact[what]).abs(),
                       (ref.double() - exact[what]).abs() + plain_allowed
                       + exact["sum_bound"], True))
    texts, ok = [], True
    for text, dist, allowed, required in checks:
        held = bool((dist <= allowed).all())
        if not held:
            at = int((dist - allowed).argmax())
            text += (f" (missed; worst at flat index {at} of {tuple(ref.shape)}: got "
                     f"{float(out.flatten()[at])!r}, plain {float(ref.flatten()[at])!r})")
        if required:
            texts.append(text)
            ok = ok and held
    return (float(err.max()), " and ".join(texts), ok,
            bool((err.double() <= plain_allowed).all()))


def constant_row_errors(results, exact):
    """{backward kernel: {"plain": max |plain - float64 dx|, "kernel": max
    |kernel - float64 dx|}} over the constant rows of one case, or {} when
    it has none: how far each version is from the exact dx where rstd is
    largest."""
    errs = {}
    for kernel in ("ln_bwd", "fused_ln_bwd"):
        constant = exact[kernel]["constant"]
        if not bool(constant.any()):
            continue
        _, got, plain = results[kernel][0]
        want = exact[kernel]["dx"][constant]
        errs[kernel] = {"plain": float((plain.double()[constant] - want).abs().max()),
                        "kernel": float((got.double()[constant] - want).abs().max())}
    return errs


def ln_exact(rows, dy, ds_out, m, r, scale):
    """{"dx", "dscale", "dbias"}: the backward in float64 on the same rows
    (x or s), dy, ds_out (None but in the fused backward), row stats and
    scale as the kernel and its plain version took, the result their f32
    arithmetic rounds; "constant": the elements of rows whose values are
    all equal; "sum_bound": per element, rstd x (mean|dxhat| + |xhat| x
    mean|dxhat xhat|) x (8S + 6) x 2^-24, S = ceil(C / 256): how far the
    kernel's f32 row means can be from exact (each term takes part in at
    most 8S - 1 additions in its lane, 5 across the warp, one division and
    the product's rounding: Higham's gamma_n bound), carried into dx."""
    c = rows.shape[-1]
    r64 = r.double().reshape(-1, 1)
    flat = rows.reshape(-1, c)
    xhat = (flat.double() - m.double().reshape(-1, 1)) * r64
    g = dy.double().reshape(-1, c)
    gh = g * scale.double()
    dx = r64 * (gh - gh.mean(-1, keepdim=True) - xhat * (gh * xhat).mean(-1, keepdim=True))
    if ds_out is not None:
        dx = dx + ds_out.double().reshape(-1, c)
    constant = (flat == flat[:, :1]).all(-1, keepdim=True).expand(-1, c)
    depth = 8 * -(-c // 256) + 6
    sum_bound = r64 * depth * 2.0 ** -24 * (gh.abs().mean(-1, keepdim=True) + xhat.abs()
                                           * (gh * xhat).abs().mean(-1, keepdim=True))
    return {"dx": dx.reshape(rows.shape), "dscale": (g * xhat).sum(0), "dbias": g.sum(0),
            "constant": constant.reshape(rows.shape),
            "sum_bound": sum_bound.reshape(rows.shape)}


def ln_against_plain(label, what):
    """Whether ``what`` of case ``label`` is held to its plain version's
    bound (:func:`ln_close`): every output of every case but dscale and
    dbias over the many rows, where torch's f32 column sum is itself ~1.1e-4
    of max(1, |sum|) from the float64 sum (over LN_PARAM_TOL); the float64
    sum holds them there."""
    return not (what in ("dscale", "dbias") and label == "many rows")


LN_WIDTHS = (128, 256, 768, 1024)          # 1-4 chunks of 8 columns per lane
LN_ROWS = (1, 2, 5, 300, 4608, 4746)
LN_MANY_ROWS = (40000, 768)                 # every backward warp walks many
                                            # rows and its staging ring wraps
# the transformer decoder's blocks: f32 rows of 512 (a cls slot and 24 x 24
# patches per image), eps 1e-6: a request, a train batch, a pool
LN_DECODER = {"decoder request": (1, 577, 512), "decoder train batch": (2, 577, 512),
              "decoder pool": (8, 577, 512)}


def ln_cases():
    """(label, shape, eps) of the LayerNorm checks: every width of
    :data:`LN_WIDTHS` at every row count of :data:`LN_ROWS`, the train
    step's two shapes as they come (labelled as in :data:`LN_SHAPES`), the
    transformer decoder's (:data:`LN_DECODER`, C = 512) and
    :data:`LN_MANY_ROWS`."""
    train = {shape[0] * shape[1]: (name, shape, eps)
             for name, (shape, eps) in LN_SHAPES.items()}
    cases = []
    for c in LN_WIDTHS:
        for r in LN_ROWS:
            if c == 768 and r in train:
                cases.append(train[r])
            else:
                cases.append((f"R={r} C={c}", (r, c), 1e-5 if r % 2 else 1e-6))
    cases += [(label, shape, 1e-6) for label, shape in LN_DECODER.items()]
    return cases + [("many rows", LN_MANY_ROWS, 1e-5)]


def ln_results(ln, x, delta, dy, ds_out, scale, bias, eps):
    """(the two backward kernels' outputs from a second call, {backward
    kernel: its float64 result (:func:`ln_exact`)}, every LayerNorm
    kernel's outputs on these inputs beside its plain version's as {kernel:
    [(output, got, plain), ...]}); the backward kernels take the forward
    kernels' own stats, so the check isolates them."""
    out, mean, rstd = ln.ln_forward(x, scale, bias, eps)
    s, f_out, f_mean, f_rstd = ln.fused_ln_forward(x, delta, scale, bias, eps)

    def backward():
        return (ln.ln_backward(x, dy, mean, rstd, scale),
                ln.fused_ln_backward(s, dy, ds_out, f_mean, f_rstd, scale))

    grads, f_grads = backward()
    again = [t for g in backward() for t in g]

    exact = {"ln_bwd": ln_exact(x, dy, None, mean, rstd, scale),
             "fused_ln_bwd": ln_exact(s, dy, ds_out, f_mean, f_rstd, scale)}
    return again, exact, {
        "ln_fwd": list(zip(("out", "mean", "rstd"), (out, mean, rstd),
                           ln.ln_forward_plain(x, scale, bias, eps))),
        "fused_ln_fwd": list(zip(("s", "out", "mean", "rstd"), (s, f_out, f_mean, f_rstd),
                                 ln.fused_ln_forward_plain(x, delta, scale, bias, eps))),
        "ln_bwd": list(zip(("dx", "dscale", "dbias"), grads,
                           ln.ln_backward_plain(x, dy, mean, rstd, scale))),
        "fused_ln_bwd": list(zip(("dx", "dscale", "dbias"), f_grads,
                                 ln.fused_ln_backward_plain(s, dy, ds_out, f_mean,
                                                            f_rstd, scale)))}


def check_ln_kernels():
    """The four LayerNorm kernels against their plain versions (and the
    backward against its float64 result), in bf16 and in f32, at every
    case of :func:`ln_cases` (constant rows wherever R >= 3), as
    :func:`ln_close` says: one line per case and dtype with each output's
    largest error and tolerance, the outputs that miss the plain
    version's bound where it is not required (as :func:`ln_against_plain`
    says) and, in f32, both versions' distance from the float64 dx on the
    constant rows (:func:`constant_row_errors`).
    Both backward kernels bitwise equal (dx, dscale, dbias) across two
    calls; then :func:`check_ln_back_to_back`. Returns the largest bf16
    error per kernel at the train shapes, and (``<kernel>_decoder_f32``)
    the largest f32 error at the transformer decoder's rows."""
    from bifold_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = dict.fromkeys(LN_KERNELS, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        for label, shape, eps in ln_cases():
            x, delta, dy, ds_out, scale, bias = ln_inputs(gen, shape, dtype)
            again, exact, results = ln_results(ln, x, delta, dy, ds_out, scale, bias, eps)
            # the rows each forward's mean is taken over: x, and the plain s
            mean_rows = {"ln_fwd": x, "fused_ln_fwd": results["fused_ln_fwd"][0][2]}
            torch.cuda.synchronize()
            first = [t for k in ("ln_bwd", "fused_ln_bwd") for _, t, _ in results[k]]
            deterministic = all(torch.equal(a, b) for a, b in zip(again, first))
            errs, tols, failed, missed = {}, {}, [], []
            for kernel, outputs in results.items():
                for what, got, ref in outputs:
                    err, tol, ok, plain_ok = ln_close(got, ref, what, dtype,
                                                      exact.get(kernel),
                                                      ln_against_plain(label, what),
                                                      mean_rows.get(kernel))
                    errs.setdefault(kernel, {})[what] = err
                    tols[what if ok else f"{kernel} {what}"] = tol
                    if not ok:
                        failed.append(f"{kernel} {what}")
                    if not plain_ok:
                        missed.append(f"{kernel} {what}")
                    if dtype == torch.bfloat16 and label in LN_SHAPES:
                        worst[kernel] = max(worst[kernel], err)
                    if dtype == torch.float32 and label in LN_DECODER:
                        name = f"{kernel}_decoder_f32"
                        worst[name] = max(worst.get(name, 0.0), err)
            emit({"phase": "ln_kernels_vs_plain", "case": label, "shape": list(shape),
                  "dtype": str(dtype), "max_abs_err": errs, "tol": tols,
                  "ok": not failed, "plain_bound_missed_where_exempt": missed,
                  "constant_rows_dx_from_float64": constant_row_errors(results, exact)
                  if dtype == torch.float32 else None,
                  "bwd_bitwise_equal_across_calls": deterministic})
            if failed:
                raise AssertionError(f"{failed} disagree with plain: {label}, {dtype}: {tols}")
            if not deterministic:
                raise AssertionError(f"a LayerNorm backward differs between two calls: "
                                     f"{label}, {dtype}")
            del results, again, first, exact
    check_ln_back_to_back(ln, gen)
    return worst


def check_ln_back_to_back(ln, gen):
    """Backward calls of both kernels on four different shapes and dtypes,
    queued with no synchronisation between them, half on a second stream
    (so two grids may run at once), each against its plain version and its
    float64 result as :func:`ln_close` holds them."""
    cases = [((2, 2373, 768), torch.bfloat16), ((300, 1024), torch.float32),
             ((8, 576, 768), torch.bfloat16), ((5, 128), torch.float32)]
    inputs = []
    for shape, dtype in cases:
        x, delta, dy, ds_out, scale, bias = ln_inputs(gen, shape, dtype)
        _, mean, rstd = ln.ln_forward(x, scale, bias, 1e-5)
        s, _, f_mean, f_rstd = ln.fused_ln_forward(x, delta, scale, bias, 1e-5)
        inputs.append((x, dy, mean, rstd, scale, s, ds_out, f_mean, f_rstd))
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    got = []
    for i, (x, dy, mean, rstd, scale, s, ds_out, f_mean, f_rstd) in enumerate(inputs):
        with torch.cuda.stream(side if i % 2 else torch.cuda.current_stream()):
            got.append((ln.ln_backward(x, dy, mean, rstd, scale),
                        ln.fused_ln_backward(s, dy, ds_out, f_mean, f_rstd, scale)))
    torch.cuda.synchronize()
    errs = []
    for (shape, dtype), args, (plain_in, fused_in) in zip(cases, inputs, got):
        x, dy, mean, rstd, scale, s, ds_out, f_mean, f_rstd = args
        refs = (ln.ln_backward_plain(x, dy, mean, rstd, scale),
                ln.fused_ln_backward_plain(s, dy, ds_out, f_mean, f_rstd, scale))
        exact = (ln_exact(x, dy, None, mean, rstd, scale),
                 ln_exact(s, dy, ds_out, f_mean, f_rstd, scale))
        for kernel, outs, ref, ex in zip(("ln_bwd", "fused_ln_bwd"), (plain_in, fused_in), refs,
                                         exact):
            for what, a, b in zip(("dx", "dscale", "dbias"), outs, ref):
                err, _, ok, _ = ln_close(a, b, what, dtype, ex)
                errs.append(err)
                if not ok:
                    raise AssertionError(f"{kernel} {what} back to back: {shape} {dtype}")
    emit({"phase": "ln_bwd_back_to_back", "cases": [[list(s), str(d)] for s, d in cases],
          "streams": 2, "max_abs_err": max(errs), "ok": True})


def device_ms(fn, iters: int = 20, warmup: int = 3):
    """Device time per call: the CUDA kernels' self device time summed over
    a torch.profiler window of ``iters`` calls, over ``iters``, or None when
    the profiler saw no device time. It leaves out the gaps between
    kernels, but once a process has run many profiler sessions it reads low
    or sees nothing, so it is reported beside :func:`queued_ms`, never in
    place of it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in kernels)
    return busy_us / 1e3 / iters if busy_us > 0 else None


LN_TIMING_SETS = 8     # input sets in turn: > 100 MB between two uses of one


def time_ln_kernels(peaks):
    """The four LayerNorm kernels, their plain versions and, where one
    PyTorch call computes the same function, that call (``F.layer_norm``;
    ``aten.native_layer_norm_backward``; scale and bias in bf16 for it), in
    bf16 at the train step's fusion and vision rows. Each is timed three
    ways: ``*ms`` CUDA events around calls queued behind a sleep kernel
    (:func:`queued_ms`; at these sizes it includes the card's gap between
    two kernels), ``*profiler_ms`` the profiler's device time
    (:func:`device_ms`, None when it saw nothing) and ``*event_ms`` CUDA
    events over 20 back-to-back calls, which at these sizes measure the
    host's enqueue. The calls take :data:`LN_TIMING_SETS` input sets in
    turn, so more than the 50 MB L2 passes between two uses of one set and
    the inputs come from device memory, as the main path's fresh
    activations mostly do. Bound: max(bytes / HBM rate, f32 operations /
    f32 CUDA-core rate), each input read and each output written once."""
    import itertools

    from bifold_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = {}
    for stack, (shape, eps) in LN_SHAPES.items():
        n, c = int(np.prod(shape)), shape[-1]
        sets = []
        for _ in range(LN_TIMING_SETS):
            x, delta, dy, ds_out, scale, bias = ln_inputs(gen, shape, torch.bfloat16)
            t = dict(x=x, delta=delta, dy=dy, ds_out=ds_out, scale=scale, bias=bias,
                     w=scale.to(x.dtype), b=bias.to(x.dtype))
            _, t["mean"], t["rstd"] = ln.ln_forward(x, scale, bias, eps)
            t["s"], _, t["f_mean"], t["f_rstd"] = ln.fused_ln_forward(
                x, delta, scale, bias, eps)
            _, t["lib_mean"], t["lib_rstd"] = torch.ops.aten.native_layer_norm(
                x, [c], t["w"], t["b"], eps)
            sets.append(t)
        row, stat, par = 2 * n, 4 * n // c, 4 * c   # bytes of one (R, C) bf16, (R,) f32, (C,) f32
        calls = {
            "ln_fwd": (lambda t: ln.ln_forward(t["x"], t["scale"], t["bias"], eps),
                       lambda t: ln.ln_forward_plain(t["x"], t["scale"], t["bias"], eps),
                       lambda t: torch.nn.functional.layer_norm(
                           t["x"], (c,), t["w"], t["b"], eps),
                       2 * row + 2 * stat + 2 * par, 7 * n),
            "ln_bwd": (lambda t: ln.ln_backward(t["x"], t["dy"], t["mean"], t["rstd"],
                                                t["scale"]),
                       lambda t: ln.ln_backward_plain(t["x"], t["dy"], t["mean"],
                                                      t["rstd"], t["scale"]),
                       lambda t: torch.ops.aten.native_layer_norm_backward(
                           t["dy"], t["x"], [c], t["lib_mean"], t["lib_rstd"], t["w"],
                           t["b"], [True, True, True]),
                       3 * row + 2 * stat + 3 * par, 13 * n),
            "fused_ln_fwd": (lambda t: ln.fused_ln_forward(t["x"], t["delta"], t["scale"],
                                                           t["bias"], eps),
                             lambda t: ln.fused_ln_forward_plain(
                                 t["x"], t["delta"], t["scale"], t["bias"], eps),
                             None, 4 * row + 2 * stat + 2 * par, 9 * n),
            "fused_ln_bwd": (lambda t: ln.fused_ln_backward(
                                 t["s"], t["dy"], t["ds_out"], t["f_mean"], t["f_rstd"],
                                 t["scale"]),
                             lambda t: ln.fused_ln_backward_plain(
                                 t["s"], t["dy"], t["ds_out"], t["f_mean"], t["f_rstd"],
                                 t["scale"]),
                             None, 4 * row + 2 * stat + 3 * par, 14 * n)}

        def in_turn(fn):
            turn = itertools.cycle(sets)
            return lambda: fn(next(turn))

        for kernel, (call, plain, library, nbytes, ops) in calls.items():
            bytes_ms, ops_ms = nbytes / peaks[1] * 1e3, ops / peaks[2] * 1e3
            timed = {"": call, "plain_": plain, "library_": library}
            row_out = {}
            for prefix, fn in timed.items():
                row_out[f"{prefix}ms"] = None if fn is None else queued_ms(in_turn(fn))
                row_out[f"{prefix}profiler_ms"] = None if fn is None else device_ms(in_turn(fn))
                row_out[f"{prefix}event_ms"] = None if fn is None else time_ms(in_turn(fn))
            rows[f"{kernel}_{stack}"] = {
                **row_out,
                "library_call": (None if library is None else
                                 "F.layer_norm" if kernel == "ln_fwd"
                                 else "aten.native_layer_norm_backward"),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "shape": list(shape), "eps": eps}
        del sets
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


def f32_keys(counts: dict) -> dict:
    """Flash launch counts with each key renamed to its float32
    instance's (``LAUNCHES`` keys f32 launches ``<kernel>_d<d>_f32``)."""
    return {f"{k}_f32": n for k, n in counts.items()}


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


LN_MODES = ("", "pallas", "fused")
# the flagship's 768-wide LayerNorms: 2 in each of the 12 blocks of either
# tower and of the 8 fusion blocks (in the stacks), post_layernorm and
# final_layer_norm (outside them)
FLAGSHIP_NORMS = (64, 2)
# stacks whose first norm is not differentiated: in either frozen tower,
# block 0's first norm has an input (the frozen embeddings, plus zeros under
# "fused") and parameters that carry no gradient
FROZEN_STACKS = 2


def launch_counts() -> dict:
    """Every kernel's launch count so far, flash and LayerNorm, nonzero
    ones only."""
    from bifold_tpu_torch.ops import flash_attention as fa
    from bifold_tpu_torch.ops import layer_norm as ln

    return {k: n for counter in (fa.LAUNCHES, ln.LAUNCHES)
            for k, n in counter.items() if n}


def clear_launch_counts() -> None:
    from bifold_tpu_torch.ops import flash_attention as fa
    from bifold_tpu_torch.ops import layer_norm as ln

    fa.LAUNCHES.clear()
    fa.SHAPES.clear()
    ln.LAUNCHES.clear()


def launched_since(before: dict) -> dict:
    now = launch_counts()
    return {k: n - before.get(k, 0) for k, n in now.items() if n != before.get(k, 0)}


@contextlib.contextmanager
def ln_mode(mode: str):
    """``BIFOLD_LN_KERNEL=mode`` inside the block ('' unsets it)."""
    old = os.environ.pop("BIFOLD_LN_KERNEL", None)
    if mode:
        os.environ["BIFOLD_LN_KERNEL"] = mode
    try:
        yield
    finally:
        os.environ.pop("BIFOLD_LN_KERNEL", None)
        if old is not None:
            os.environ["BIFOLD_LN_KERNEL"] = old


def kernel_norms(model):
    """(norms inside a pre-norm stack, other norms) of ``model``'s
    LayerNorms whose width is a multiple of 128, those the kernel modes
    send to the kernels."""
    from bifold_tpu_torch.models.layers import ClipTransformer, LayerNorm, Transformer

    in_stacks = {id(m) for t in model.modules()
                 if isinstance(t, (Transformer, ClipTransformer))
                 for m in t.modules() if isinstance(m, LayerNorm)}
    norms = [m for m in model.modules()
             if isinstance(m, LayerNorm) and m.weight.numel() % 128 == 0]
    stacked = sum(id(m) in in_stacks for m in norms)
    return stacked, len(norms) - stacked


def norm_launches(model, mode):
    """The LayerNorm kernel launches of one forward of ``model`` under
    ``BIFOLD_LN_KERNEL=mode``: under "pallas" every kernel norm takes
    ``ln_fwd``; under "fused" those inside a stack (fusion or tower) take
    ``fused_ln_fwd`` and the others ``ln_fwd``."""
    stacked, other = kernel_norms(model)
    if mode == "pallas":
        return {"ln_fwd": stacked + other}
    if mode == "fused":
        return {k: n for k, n in (("fused_ln_fwd", stacked), ("ln_fwd", other)) if n}
    return {}


def ln_launches(model, mode, train, norms=None):
    """The LayerNorm kernel launches of one forward (and, ``train``, its
    backward) of the flagship ``model`` (or a variant with ``norms``
    kernel norms) under ``BIFOLD_LN_KERNEL=mode``, counted from the model
    (:func:`norm_launches`); the backward skips the first norm of either
    frozen tower."""
    stacked, other = kernel_norms(model)
    norms = norms or FLAGSHIP_NORMS
    if (stacked, other) != norms:
        raise AssertionError(f"{stacked} + {other} LayerNorms, want {norms}")
    fwd = norm_launches(model, mode)
    if mode == "pallas":
        bwd = {"ln_bwd": stacked + other - FROZEN_STACKS}
    elif mode == "fused":
        bwd = {"fused_ln_bwd": stacked - FROZEN_STACKS, "ln_bwd": other}
    else:
        bwd = {}
    return {**fwd, **bwd} if train else fwd


def train_flagship(card, mode="", warmup=3, steps=10) -> dict:
    """The bf16 flagship train step at full width and depth, batch 2, with
    ``BIFOLD_LN_KERNEL=mode``: raw frames -> train Processor on the card ->
    forward -> loss -> backward through the lse and backward kernels (and
    the LayerNorm kernels of the mode) -> clip -> Adam. In the default mode
    it then serves the trained model once, which must launch only the
    inference kernel. Peak memory is counted above what was allocated
    before the phase. Returns the phase: its launch counts, ``one_step``
    (one more launch-checked step on a batch made from a seed -> its ms),
    and what :func:`where_the_time_goes` needs; the model lives as long as
    the phase."""
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.serving import ServingModel

    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    proc = Processor(TRAIN_PROCESSOR, partition="train", max_context_length=3,
                     autoprocessor_name=FLAGSHIP["automodel_name"],
                     spm_asset=fixture_model_bytes(), seed=0)
    model, mask, step, state = trainer(torch.bfloat16, ADAM, precast=True)
    per_step = {**PER_STEP, **ln_launches(model, mode, train=True)}
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    raws = [raw_train_batch(proc, seed) for seed in range(warmup + steps)]

    def one_step(raw, label):
        """(process ms, step ms, loss) of one step on ``raw``, its launches
        held to ``per_step``."""
        nonlocal state, metrics
        with ln_mode(mode):
            torch.cuda.synchronize()
            t = time.perf_counter()
            sample = proc.process_batch(raw, "cuda")
            torch.cuda.synchronize()
            t_mid = time.perf_counter()
            counts = launch_counts()
            state, metrics = step(state, sample)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        delta = launched_since(counts)
        if delta != per_step:
            raise AssertionError(f"train step {label} ({mode or 'default'}): "
                                 f"kernel launches {delta}, want {per_step}")
        return (t_mid - t) * 1e3, (t_end - t_mid) * 1e3, float(metrics["loss"])

    metrics = None
    emit({"phase": "train_setup", "ln_mode": mode,
          "seconds": time.perf_counter() - t0,
          "parameters": sum(p.numel() for p in named.values()),
          "trainable": sum(p.numel() for n, p in named.items() if mask[n])})

    torch.cuda.reset_peak_memory_stats()
    losses, process_ms, step_ms, smi = [], [], [], []
    with smi_samples(smi):
        clear_launch_counts()            # the train path's run starts here
        for i, raw in enumerate(raws):
            p_ms, s_ms, loss = one_step(raw, i)
            losses.append(loss)
            if i >= warmup:
                process_ms.append(p_ms)
                step_ms.append(s_ms)
        launches = launch_counts()       # ... and ends here
    peak = torch.cuda.max_memory_allocated() - base
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
    emit({"phase": "train_flagship", "ln_mode": mode, "batch": TRAIN_BATCH,
          "warmup": warmup, "steps": steps, "losses": losses,
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
          "launches_per_step": per_step, "launches": launches,
          "lora_A_unchanged": len(stale), **card})

    sample = proc.process_batch(raws[-1], "cuda")

    def stages():
        with ln_mode(mode):
            return train_stages(model, state.optimizer, sample)

    def profile():
        with ln_mode(mode):
            return device_profile(lambda: step(state, sample), p50)

    phase = {"mode": mode, "launches": launches, "stages": stages, "profile": profile,
             "one_step": lambda seed: one_step(raw_train_batch(proc, seed), seed)[1],
             "where": {"phase": "where_the_time_goes", "path": "train_step",
                       "ln_mode": mode, "p50_ms": p50,
                       "process_ms": statistics.median(process_ms),
                       "max_memory_allocated_bytes": peak}}
    if mode:
        return phase

    # serve the trained model: the copy leaves the float32 masters as they
    # are, and predict launches the inference kernel only
    test_proc = Processor(PROCESSOR, max_context_length=3,
                          autoprocessor_name=FLAGSHIP["automodel_name"],
                          spm_asset=fixture_model_bytes())
    server = ServingModel(model, None, test_proc, device="cuda")
    if any(p.dtype != torch.float32 for n, p in named.items() if mask[n]):
        raise AssertionError("serving rounded the trainable float32 masters")
    clear_launch_counts()
    obs = observation(np.random.default_rng(1), n_ctx=3)
    action, raw_out = server.predict(**obs, instruction=INSTRUCTIONS[0],
                                     return_raw_output=True)
    check_action(action, raw_out, 1, FLAGSHIP["image_size"])
    served = launch_counts()
    emit({"phase": "predict_after_training", "launches": served})
    if served != {"fwd_infer_d48": 8, "fwd_infer_d64": 12}:
        raise AssertionError(f"predict launched {served}")
    del server
    return phase


def train_interleaved(steppers, card, rounds=5):
    """The train step p50 of each LayerNorm mode, with the modes' steps
    taken in turns (default, pallas, fused, default, ...) on the same
    batches, so that drift of the shared host's speed falls on all modes
    alike."""
    step_ms = {mode: [] for mode in steppers}
    for r in range(rounds):
        for mode, one_step in steppers.items():
            step_ms[mode].append(one_step(1000 + r))
    p50 = {mode: statistics.median(v) for mode, v in step_ms.items()}
    emit({"phase": "train_step_interleaved", "rounds": rounds, "batch": TRAIN_BATCH,
          "p50_step_ms": p50,
          "samples_per_s": {m: TRAIN_BATCH / (v / 1e3) for m, v in p50.items()},
          "step_ms": step_ms, **card})


def train_stages(model, optimizer, sample, iters: int = 3):
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


def f32_step_equivalence():
    """One f32 train step (TF32 off) with SGD from the same weights, batch
    and dropout seed, three ways: through the flash kernels ("kernels"),
    through the math path ("math"), and through the flash kernels with
    ``BIFOLD_LN_KERNEL=fused`` ("ln_fused", every LayerNorm on its kernels).
    Against "kernels", each of the other two holds the loss within 1e-4 and
    the trainable-gradient norm within 1e-3, relative."""
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes

    proc = Processor(TRAIN_PROCESSOR, partition="train", max_context_length=3,
                     autoprocessor_name=FLAGSHIP["automodel_name"],
                     spm_asset=fixture_model_bytes(), seed=0)
    raw = raw_train_batch(proc, 99)
    draws = proc.draw(proc._spec(raw), TRAIN_BATCH, raw["rgb"].shape[1:3], "cuda")
    sgd = {"name": "sgd", "lr": 1e-3}
    want = {"kernels": f32_keys(PER_STEP), "math": {}, "ln_fused": None}
    results = {}
    for path in want:
        model, mask, step, state = trainer(torch.float32, sgd, precast=False)
        if path == "ln_fused":
            want[path] = {**f32_keys(PER_STEP), **ln_launches(model, "fused", train=True)}
        sample = proc.process_batch(raw, "cuda", draws=draws)
        before = launch_counts()
        if path == "math":
            os.environ["BIFOLD_ATTN_BACKEND"] = "math"
        try:
            with ln_mode("fused" if path == "ln_fused" else ""):
                state, metrics = step(state, sample)
            torch.cuda.synchronize()
        finally:
            os.environ.pop("BIFOLD_ATTN_BACKEND", None)
        results[path] = {"loss": float(metrics["loss"]),
                         "grad_norm_trainable": float(metrics["grad_norm_trainable"]),
                         "launches": launched_since(before)}
        del model, step, state
        torch.cuda.empty_cache()
    ref = results["kernels"]
    for path in ("math", "ln_fused"):
        got = results[path]
        loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        norm_rel = (abs(got["grad_norm_trainable"] - ref["grad_norm_trainable"])
                    / ref["grad_norm_trainable"])
        emit({"phase": f"f32_train_step_kernels_vs_{path}", "kernels": ref,
              path: got, "loss_rel_diff": loss_rel, "grad_norm_rel_diff": norm_rel,
              "tol": {"loss": F32_LOSS_RTOL, "grad_norm": F32_NORM_RTOL}})
        if (loss_rel > F32_LOSS_RTOL or norm_rel > F32_NORM_RTOL
                or ref["launches"] != want["kernels"] or got["launches"] != want[path]):
            raise AssertionError(f"f32 train step: kernels and {path} disagree")


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


def serve_requests(server, mode):
    """The served path in one ``BIFOLD_LN_KERNEL`` mode: 5 ``predict``
    requests (1-3 context frames) and one ``predict_batch`` of 8, each with
    its exact launch counts and finite actions of the right shape. The
    observations come from seed 0 in every mode."""
    rng = np.random.default_rng(0)
    per_request = {"fwd_infer_d48": 8, "fwd_infer_d64": 12,  # fusion + vision
                   **ln_launches(server.model, mode, train=False)}
    size = FLAGSHIP["image_size"]
    requests = []
    with ln_mode(mode):
        clear_launch_counts()            # the main path's run starts here
        for i, text in enumerate(INSTRUCTIONS):
            obs = observation(rng, n_ctx=1 + i % 3)
            before = launch_counts()
            action, raw = server.predict(**obs, instruction=text,
                                         return_raw_output=True)
            delta = launched_since(before)
            if delta != per_request:
                raise AssertionError(f"request {i} ({mode or 'default'}): "
                                     f"launches {delta}, want {per_request}")
            check_action(action, raw, 1, size)
            requests.append((obs, text, action, raw))
        before = launch_counts()
        pool = [dict(observation(rng, n_ctx=1 + i % 3), instruction=INSTRUCTIONS[i % 5])
                for i in range(8)]
        action, raw = server.predict_batch(pool, pad_to=8, return_raw_output=True)
        delta = launched_since(before)
        if delta != per_request:
            raise AssertionError(f"predict_batch ({mode or 'default'}): "
                                 f"launches {delta}, want {per_request}")
        check_action(action, raw, 8, size)
        launches = launch_counts()       # ... and ends here
    emit({"phase": "flagship_serving", "ln_mode": mode, "requests": len(requests),
          "pool": 8, "launches_per_request": per_request, "launches": launches})
    return requests, pool, launches


def serve_flagship(card):
    """The bf16 flagship served at a 720 px camera in the default mode and
    under ``BIFOLD_LN_KERNEL=pallas`` and ``fused``; the kernel forward
    against the math path, and the LayerNorm modes against the default
    mode, in f32; latency in every mode. Returns each mode's launch counts
    and the phases for :func:`where_the_time_goes`."""
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
    served = {mode: serve_requests(server, mode) for mode in LN_MODES}
    requests, pool, _ = served[""]

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
        if hm_diff > BF16_MATH_TOL:
            raise AssertionError(f"{dtype} kernel and math heatmaps differ by {hm_diff}")
    # the LayerNorm kernels against the default LayerNorm, in f32: the same
    # actions, heatmaps within 1e-3
    for mode in LN_MODES[1:]:
        with ln_mode(mode):
            ln_action, ln_raw = f32_server.predict(**obs, instruction=text,
                                                   return_raw_output=True)
        hm_diff = max(float(np.abs(f32_raw[k] - ln_raw[k]).max())
                      for k in f32_raw if k.endswith("_heatmap"))
        same = all(np.array_equal(getattr(f32_action, f), getattr(ln_action, f))
                   for f in ("left_pick", "right_pick", "left_place", "right_place"))
        emit({"phase": "ln_mode_vs_default_forward", "ln_mode": mode,
              "dtype": "float32", "max_heatmap_diff": hm_diff,
              "actions_identical": same,
              "decoded_apart": decoded_apart(f32_action, ln_action, f32_raw)})
        if not (same and hm_diff < 1e-3):
            raise AssertionError(f"f32 forwards under {mode} and default disagree")
    del f32_server

    # latency with the modes in turns (default, pallas, fused, default,
    # ...), LATENCY_ROUNDS requests each, so that drift of the shared host's speed falls
    # on all modes alike
    calls = {"batch1": lambda: server.predict(**obs, instruction=text),
             "pool8": lambda: server.predict_batch(pool, pad_to=8)}
    times = {mode: {name: [] for name in calls} for mode in LN_MODES}
    for name, call in calls.items():
        for _ in range(LATENCY_ROUNDS):
            for mode in LN_MODES:
                with ln_mode(mode):
                    t = time.perf_counter()
                    call()
                    times[mode][name].append((time.perf_counter() - t) * 1e3)
    phases = []
    for mode in LN_MODES:
        lat = {name: statistics.median(v) for name, v in times[mode].items()}
        emit({"phase": "predict_latency", "ln_mode": mode,
              "p50_ms_batch1": lat["batch1"], "p50_ms_pool8": lat["pool8"],
              "requests_each": LATENCY_ROUNDS, "in_turns_with": list(LN_MODES), **card})
        for name, obs_list in (("batch1", [dict(obs, instruction=text)]),
                               ("pool8", pool)):
            phases.append(serving_phase(server, mode, name, obs_list, lat[name]))
    return {mode: launches for mode, (_, _, launches) in served.items()}, phases


ACTION_FIELDS = ("left_pick", "right_pick", "left_place", "right_place")


def same_output(a, b) -> bool:
    """Two (Action, raw outputs) results bitwise equal."""
    (aa, ar), (ba, br) = a, b
    return (sorted(ar) == sorted(br) and all(np.array_equal(ar[k], br[k]) for k in ar)
            and all(np.array_equal(getattr(aa, f), getattr(ba, f)) for f in ACTION_FIELDS))


def counted(call, mode, want, label):
    """``call()`` under ``BIFOLD_LN_KERNEL=mode``, its kernel launches held
    to ``want``."""
    with ln_mode(mode):
        before = launch_counts()
        out = call()
        got = launched_since(before)
    if got != want:
        raise AssertionError(f"{label} ({mode or 'default'}): launches {got}, want {want}")
    return out


def write_jax_checkpoint(path, params, model_cfg=None) -> None:
    """A checkpoint in the JAX trainer's format (the pickled payload of
    bifold_tpu/utils/checkpoint.py:_build_payload) holding ``params``, a
    params tree of numpy arrays, and nothing to resume from; its metadata
    names ``model_cfg`` (the flagship's by default)."""
    import pickle
    import random

    payload = {"params": params, "opt_state": None, "extra_vars": None, "epoch": 0,
               "step": 0, "step_in_epoch": 0, "best_eval": None,
               "np_rng_state": np.random.get_state(), "py_rng_state": random.getstate(),
               "host_rng_states": {}, "jax_key": None, "loop_key": None,
               "metadata": {"model": model_cfg or FLAGSHIP}}
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def http_call(port, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def http_predict(port, observations, query=""):
    """(Action, raw outputs) of one POST /predict of ``observations``."""
    import io

    from bifold_tpu_torch.env.action import Action
    from bifold_tpu_torch.serve import RemotePolicy

    status, data = http_call(port, "POST", "/predict" + query,
                             RemotePolicy._pack(observations))
    if status != 200:
        raise AssertionError(f"daemon answered {status}: {data[:300]!r}")
    out = dict(np.load(io.BytesIO(data)))
    return (Action(**{f: out[f] for f in ACTION_FIELDS}),
            {k[4:]: v for k, v in out.items() if k.startswith("raw_")})


def deployment_phase(card, device="cuda"):
    """The deployment half of serving on the bf16 flagship (384 px, 3
    context frames, seeded weights) at a 720 px camera, each path against
    the live in-process server on the same observation, with exact flash
    and LayerNorm launches per request in every ``BIFOLD_LN_KERNEL`` mode:

    - int8: the quantized weights are int8 on the card, and the heatmaps
      and actions bitwise equal a server that holds their dequantized
      values as plain bf16 tensors and every other weight as the int8
      server does; weight bytes and per-request peak against the bf16
      server (``program_memory``);
    - checkpoint: the live weights written as a JAX trainer checkpoint
      through the port's ``convert_bifold`` serve, by
      ``ServingModel.from_checkpoint``, bitwise what the live server serves;
    - artifacts: batch-1 and batch-8 exports, loaded back (load time
      printed), serve bitwise what the live server serves;
    - daemon: an in-process HTTP daemon on an ephemeral localhost port
      answers single, pooled and raw requests bitwise as in-process
      ``predict`` / ``predict_batch`` do, and a bad body with a 400; a
      second one with ``--max-batch 8`` coalesces 8 concurrent clients into
      fewer dispatches, each client's actions those of its observation in an
      in-process pool of 8; HTTP p50 beside in-process p50
      (:data:`LATENCY_ROUNDS` requests each, in turns).

    Returns the launches of every request here. ``device="cpu"`` runs the
    same steps on the CPU (a rehearsal at a tiny size, with the launch
    checks stubbed by the caller)."""
    import tempfile
    import threading

    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.models import build_model
    from bifold_tpu_torch.models.convert import convert_bifold
    from bifold_tpu_torch.serve import make_httpd
    from bifold_tpu_torch.serving import (QUANT_TAG, ServingModel, _install,
                                          _served_weights, dequantize_weights)

    t0 = time.perf_counter()
    model = build_model(FLAGSHIP, dtype=torch.bfloat16, device=device, seed=0)
    proc = Processor(PROCESSOR, max_context_length=3,
                     autoprocessor_name=FLAGSHIP["automodel_name"],
                     spm_asset=fixture_model_bytes())
    live = ServingModel(model, None, proc, device=device)
    rng = np.random.default_rng(21)
    obs = dict(observation(rng, n_ctx=3), instruction=INSTRUCTIONS[1])
    pool = [dict(observation(rng, n_ctx=1 + i % 3), instruction=INSTRUCTIONS[i % 5])
            for i in range(8)]
    want = {mode: {"fwd_infer_d48": 8, "fwd_infer_d64": 12,
                   **ln_launches(live.model, mode, train=False)} for mode in LN_MODES}
    clear_launch_counts()                # the deployment paths' run starts here

    def one(server, mode, label):
        return counted(lambda: server.predict(**obs, return_raw_output=True), mode,
                       want[mode], label)

    def pooled(server, mode, label):
        return counted(lambda: server.predict_batch(pool, pad_to=8, return_raw_output=True),
                       mode, want[mode], label)

    ref = {mode: one(live, mode, "live") for mode in LN_MODES}
    ref_pool = {mode: pooled(live, mode, "live pool") for mode in LN_MODES}
    check_action(*ref[""], 1, FLAGSHIP["image_size"])
    results = {}

    # int8
    int8 = ServingModel(model, None, proc, device=device, quantize="int8")
    served = _served_weights(int8.model)
    quantized = [k for k, v in served.items() if isinstance(v, dict)]
    on_card = [n for n, p in int8.model.named_parameters()
               if p.dtype == torch.int8 and p.device.type == torch.device(device).type]
    if not quantized or len(on_card) != len(quantized):
        raise AssertionError(f"{len(quantized)} quantized weights, {len(on_card)} int8 "
                             "tensors on the card")
    plain_model = build_model(FLAGSHIP, dtype=torch.bfloat16, device=device, seed=0)
    _install(plain_model, dequantize_weights(served, torch.bfloat16), torch.bfloat16)
    dequantized = ServingModel._served(plain_model, proc, None, "float32", None)
    live_params = dict(live.model.named_parameters())
    q_bytes = sum(v[QUANT_TAG].numel() + 4 * v["scale"].numel() for k, v in served.items()
                  if isinstance(v, dict))
    bf16_bytes = sum(live_params[k].numel() * live_params[k].element_size() for k in quantized)
    mem = {"bf16": live.program_memory(**obs), "int8": int8.program_memory(**obs)}
    if device == "cuda" and None in mem.values():
        raise AssertionError("program_memory measured nothing on the card")
    same = {mode: same_output(one(int8, mode, "int8"), one(dequantized, mode, "dequantized"))
            for mode in LN_MODES}
    results["int8"] = same
    emit({"phase": "deploy_int8", "quantized_tensors": len(quantized),
          "int8_on_card": len(on_card), "bitwise_vs_dequantized_bf16": same,
          "quantized_bytes_int8_with_scales": q_bytes,
          "same_tensors_bytes_bf16": bf16_bytes,
          "weight_bytes": {k: m and m.weight_bytes for k, m in mem.items()},
          "request_peak_over_weights_bytes": {k: m and m.peak_over_weights_bytes
                                              for k, m in mem.items()}, **card})
    del int8, dequantized, plain_model, served

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # a JAX trainer checkpoint of the live weights
        t = time.perf_counter()
        write_jax_checkpoint(tmp / "last.ckpt", convert_bifold(
            {k: v.float() for k, v in model.state_dict().items()}))
        (tmp / "spiece.model").write_bytes(fixture_model_bytes())
        written = time.perf_counter() - t
        t = time.perf_counter()
        from_ckpt = ServingModel.from_checkpoint(
            tmp / "last.ckpt", {"model": FLAGSHIP, "processor": PROCESSOR,
                                "precision": {"compute_dtype": "bfloat16"}},
            device=device)
        loaded = time.perf_counter() - t
        same = {mode: same_output(one(from_ckpt, mode, "checkpoint"), ref[mode])
                for mode in LN_MODES}
        results["checkpoint"] = same
        emit({"phase": "deploy_checkpoint", "bytes": (tmp / "last.ckpt").stat().st_size,
              "write_seconds": written, "load_seconds": loaded,
              "bitwise_vs_live": same})
        del from_ckpt

        # artifacts
        for batch in (1, 8):
            t = time.perf_counter()
            path = live.export(tmp / f"serve_b{batch}.pt", **obs, batch=batch)
            exported_s = time.perf_counter() - t
            t = time.perf_counter()
            art = ServingModel.load_exported(path, device=device)
            loaded = time.perf_counter() - t
            if batch == 1:
                same = {mode: same_output(one(art, mode, "artifact b1"), ref[mode])
                        for mode in LN_MODES}
            else:
                same = {mode: same_output(pooled(art, mode, "artifact b8"), ref_pool[mode])
                        for mode in LN_MODES}
            results[f"artifact_b{batch}"] = same
            emit({"phase": "deploy_artifact", "batch": batch,
                  "bytes": path.stat().st_size, "export_seconds": exported_s,
                  "load_seconds": loaded, "bitwise_vs_live": same})
            del art

    # the daemon, without and with the dynamic batcher
    httpd = make_httpd(live)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        health = json.loads(http_call(port, "GET", "/healthz")[1])
        same = {mode: same_output(counted(lambda: http_predict(port, [obs], "?raw=1"),
                                          mode, want[mode], "daemon"), ref[mode])
                for mode in LN_MODES}
        same_pool = {mode: same_output(counted(
            lambda: http_predict(port, pool, "?raw=1&pad=8"), mode, want[mode],
            "daemon pool"), ref_pool[mode]) for mode in LN_MODES}
        bad = http_call(port, "POST", "/predict", b"not an npz")[0]
        times = {"http": [], "in_process": []}
        for _ in range(LATENCY_ROUNDS):
            for name, call in (("http", lambda: http_predict(port, [obs])),
                               ("in_process", lambda: live.predict(**obs))):
                t = time.perf_counter()
                call()
                times[name].append((time.perf_counter() - t) * 1e3)
        metrics = json.loads(http_call(port, "GET", "/metrics")[1])
    finally:
        httpd.shutdown()
        httpd.server_close()
    results["daemon"], results["daemon_pool"] = same, same_pool

    httpd = make_httpd(live, max_batch=8, batch_window_ms=50.0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    answers = [None] * 8

    def client(i):
        answers[i] = http_predict(port, [pool[i]])[0]

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        coalesced = (httpd.batcher.requests, httpd.batcher.batches)
    finally:
        httpd.shutdown()
        httpd.server_close()
    alone = [live.predict_batch([o], pad_to=8) for o in pool]
    clients_ok = all(a is not None and all(
        np.array_equal(getattr(a, f), getattr(b, f)) for f in ACTION_FIELDS)
        for a, b in zip(answers, alone))
    emit({"phase": "deploy_daemon", "healthz": health, "bitwise_vs_in_process": same,
          "pool8_bitwise_vs_in_process": same_pool, "bad_body_status": bad,
          "concurrent_clients": 8, "requests_dispatches": list(coalesced),
          "clients_actions_equal_in_process": clients_ok,
          "p50_ms": {k: statistics.median(v) for k, v in times.items()},
          "requests_each": LATENCY_ROUNDS, "daemon_metrics": metrics, **card})
    launches = launch_counts()           # ... and ends here
    failed = [f"{path} {mode}" for path, by_mode in results.items()
              for mode, ok in by_mode.items() if not ok]
    if failed or bad != 400 or not clients_ok or not coalesced[1] < coalesced[0] == 8:
        raise AssertionError(f"deployment: differs from live {failed}, bad body {bad}, "
                             f"clients ok {clients_ok}, requests/dispatches {coalesced}")
    emit({"phase": "deployment", "seconds": time.perf_counter() - t0,
          "launches": launches, "ok": True})
    return launches


CLI_OVERRIDES = ("train_dataset=synthetic", "train_dataset.image_size=384",
                 "train_dataset.is_bimanual=true",
                 "train_dataset.max_context_length=3", "train_dataset.n_samples=16",
                 "test_dataset=null", "model=siglip_sequential", "batch_size=2",
                 "test_batch_size=2", "epochs=1", "eval_epochs=1", "simulator=null",
                 "log_every=1")
INFER = {"fwd_infer_d48": 8, "fwd_infer_d64": 12}


def observed_trainer(record):
    """A Trainer subclass that records, in ``record``, every train step's
    and eval batch's kernel launches, the time of the first step's end,
    the epochs it trains and its checkpoint write and load seconds."""
    from bifold_tpu_torch.trainer import Trainer

    class Observed(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            record.setdefault("trainers", []).append(self)
            eval_step = self._eval_step

            def counted_eval(batch):
                before = launch_counts()
                out = eval_step(batch)
                record.setdefault("evals", []).append(launched_since(before))
                return out

            self._eval_step = counted_eval

        def prepare_train(self):
            super().prepare_train()
            step = self._train_step

            def counted_step(state, batch):
                before = launch_counts()
                out = step(state, batch)
                record.setdefault("steps", []).append(launched_since(before))
                if "first_step_end" not in record:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize()
                    record["first_step_end"] = time.perf_counter()
                return out

            self._train_step = counted_step

        def train_epoch(self):
            record.setdefault("epochs", []).append(self.epoch)
            return super().train_epoch()

        def save_model(self, name):
            t = time.perf_counter()
            super().save_model(name)
            record.setdefault("saves", []).append(time.perf_counter() - t)

        def load_model(self, *args, **kwargs):
            t = time.perf_counter()
            loaded = super().load_model(*args, **kwargs)
            if loaded:
                record.setdefault("loads", []).append(time.perf_counter() - t)
            return loaded

    return Observed


def run_cli(overrides, record):
    """``python -m bifold_tpu_torch`` in this process, its Trainer observed
    into ``record``; returns (exit code, run dir, seconds)."""
    from bifold_tpu_torch import __main__ as cli
    from bifold_tpu_torch.config import compose

    run_dir = Path(compose(overrides)["run_dir"]) / cli.run_dir_name(
        cli.override_dirname(overrides))
    real = cli.Trainer
    cli.Trainer = observed_trainer(record)
    t = time.perf_counter()
    record["start"] = t
    try:
        code = cli.main(list(overrides))
    finally:
        cli.Trainer = real
    return code, run_dir, time.perf_counter() - t


def trainer_cli(card, flagship_p50, device="cuda"):
    """The port's training entry point on the card: ``main`` of
    ``bifold_tpu_torch.__main__`` trains the full-width bf16 flagship
    (:data:`CLI_OVERRIDES`: synthetic 384 px bimanual data with 3 context
    frames, 16 samples, batch 2, one epoch of 8 steps), evaluates pixel
    metrics and writes ``best`` and ``last``. Gates: exit code 0, exactly
    ``PER_STEP`` launches per step and only the inference kernel's per eval
    batch, finite metrics, the run dir's files, and the port's server serving
    ``best.ckpt`` with the launches of a request. Then ``epochs=2`` from the
    first run's checkpoints trains epoch 1 only; under
    ``BIFOLD_LN_KERNEL=fused`` a 5-step run, its per-step launches those of
    ``train_flagship`` in that mode, against a run interrupted at its third
    step and resumed: the weights end bitwise equal; the fused run's loader
    abandoned after one batch: its thread ends within the join, and the
    batch taken equals the batch a fresh iterator rebuilds. Prints the
    Trainer's step p50 (``train/step_time_s``) and samples/s beside
    ``flagship_p50``, the time to the first step, checkpoint write and resume
    seconds. Returns the launches and the trainer for :func:`trainer_profile`.
    ``device="cpu"`` runs the same steps on the CPU (``use_cpu=true``; a
    rehearsal at a tiny size, with the launch checks stubbed by the
    caller)."""
    import shutil
    import tempfile
    import threading

    from bifold_tpu_torch.__main__ import override_dirname, run_dir_name
    from bifold_tpu_torch.config import Config, compose, load_yaml
    from bifold_tpu_torch.serving import ServingModel

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_cli_"))
    overrides = list(CLI_OVERRIDES) + [f"run_dir={tmp}"] + (
        ["use_cpu=true"] if device == "cpu" else [])
    first = {}
    clear_launch_counts()                # the Trainer's runs start here
    code, run_dir, seconds = run_cli(overrides, first)
    files = [f for f in ("config.yaml", "metrics.jsonl", "eval_synthetic.yaml",
                         "checkpoints/best.ckpt", "checkpoints/last.ckpt")
             if not (run_dir / f).exists()]
    evals = load_yaml(run_dir / "eval_synthetic.yaml") if not files else {}
    logged = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    step_s = [r["train/step_time_s"] for r in logged if "train/step_time_s" in r]
    sps = [r["train/samples_per_sec"] for r in logged if "train/samples_per_sec" in r]
    bad_steps = [d for d in first.get("steps", []) if d != PER_STEP]
    bad_evals = [d for d in first.get("evals", []) if d != INFER]
    finite = bool(evals) and all(v is None or np.isfinite(v) for v in evals.values()) \
        and evals.get("kp_mse") is not None

    # the best checkpoint served by the port's server
    cfg = load_yaml(run_dir / "config.yaml")
    server = ServingModel.from_checkpoint(run_dir / "checkpoints/best.ckpt", cfg,
                                          device=device)
    obs = observation(np.random.default_rng(7), n_ctx=3)
    action, raw = counted(lambda: server.predict(**obs, instruction=INSTRUCTIONS[0],
                                                 return_raw_output=True),
                          "", INFER, "served best.ckpt")
    check_action(action, raw, 1, FLAGSHIP["image_size"])
    del server

    # epochs=2 from the first run's checkpoints: only epoch 1 trains
    second = {}
    overrides2 = [o if o != "epochs=1" else "epochs=2" for o in overrides]
    run_dir2 = Path(compose(overrides2)["run_dir"]) / run_dir_name(override_dirname(overrides2))
    shutil.copytree(run_dir / "checkpoints", run_dir2 / "checkpoints")
    code2, _, seconds2 = run_cli(overrides2, second)
    resumed_ok = (code2 == 0 and second.get("epochs") == [1]
                  and second["trainers"][0].global_step == 16
                  and all(d == PER_STEP for d in second.get("steps", [])))
    logged = [json.loads(line) for line in (run_dir2 / "metrics.jsonl").read_text().splitlines()]
    step_s += [r["train/step_time_s"] for r in logged if "train/step_time_s" in r]
    sps += [r["train/samples_per_sec"] for r in logged if "train/samples_per_sec" in r]
    del first["trainers"], second["trainers"]

    # fused LayerNorms: 5 steps straight, and interrupted at the 3rd + resumed
    def fused_trainer(name, record):
        cfg = compose([o for o in overrides if not o.startswith("log_every")] + [
            "train_dataset.n_samples=10", "eval_epochs=0", "loss_readback_window=2",
            f"run_dir={tmp / name}"])
        return observed_trainer(record)(Config(cfg), run_dir=tmp / name)

    straight, broken, resumed = {}, {}, {}
    with ln_mode("fused"):
        ta = fused_trainer("a", straight)
        ta.prepare_train()
        ta.train()
        tb = fused_trainer("b", broken)
        tb.prepare_train()
        real_step, calls = tb._train_step, [0]

        def interrupted(state, batch):
            calls[0] += 1
            if calls[0] == 3:
                raise KeyboardInterrupt
            return real_step(state, batch)

        tb._train_step = interrupted
        try:
            tb.train()
            raise AssertionError("the interrupted run did not stop")
        except KeyboardInterrupt:
            pass
        tc = fused_trainer("b", resumed)
        tc.prepare_train()
        start = (tc.epoch, tc._resume_step_in_epoch)
        tc.train()
    # an abandoned prefetch iterator: its thread gone within the join, and
    # the batch taken before it (made on the loader's side stream) equal to
    # the same batch rebuilt by a fresh iterator
    loader = ta.train_dataloader
    loader.set_epoch(0)
    it = iter(loader)
    taken = next(it)
    t = time.perf_counter()
    it.close()
    close_s = time.perf_counter() - t
    alive = [th.name for th in threading.enumerate() if th.name == "bifold-loader"]
    it = iter(loader)
    rebuilt = next(it)
    it.close()
    rebuilt_equal = all(torch.equal(v, rebuilt[k]) for k, v in taken.items()
                        if isinstance(v, torch.Tensor))
    del taken, rebuilt
    fused_step = {**PER_STEP, **ln_launches(ta.model, "fused", train=True)}
    bad_fused = [d for d in straight["steps"] + broken["steps"] + resumed["steps"]
                 if d != fused_step]
    a_params = dict(ta.model.named_parameters())
    diffs = {n: float((p.detach().float() - a_params[n].detach().float()).abs().max())
             for n, p in tc.model.named_parameters() if p.requires_grad}
    bitwise = all(torch.equal(p, a_params[n]) for n, p in tc.model.named_parameters())
    launches = launch_counts()           # ... and end here
    del tb, tc, broken["trainers"], resumed["trainers"]

    p50 = statistics.median(step_s) * 1e3 if step_s else None
    emit({"phase": "trainer_cli", "exit_codes": [code, code2], "seconds": seconds,
          "steps": len(first.get("steps", [])), "launches_per_step": PER_STEP,
          "steps_with_other_launches": bad_steps, "eval_batches": len(first.get("evals", [])),
          "eval_batches_with_other_launches": bad_evals, "eval": evals,
          "missing_files": files, "served_best": True,
          "trainer_step_p50_ms": p50, "trainer_step_time_samples_ms": [s * 1e3 for s in step_s],
          "trainer_samples_per_s": sps, "train_flagship_p50_ms": flagship_p50,
          "time_to_first_step_s": first["first_step_end"] - first["start"],
          "checkpoint_write_s": first.get("saves"), "resume_load_s": second.get("loads"),
          "resumed_epochs": second.get("epochs"), "resumed_ok": resumed_ok,
          "seconds_epochs2": seconds2, "fused_launches_per_step": fused_step,
          "fused_steps_with_other_launches": bad_fused,
          "interrupted_resume_start": list(start),
          "interrupt_resume_bitwise": bitwise,
          "interrupt_resume_max_abs_diff": max(diffs.values()),
          "interrupt_resume_load_s": resumed.get("loads"),
          "abandoned_loader": {"close_s": close_s, "threads_alive": alive,
                               "batch_rebuilt_equal": rebuilt_equal},
          "phase_seconds": time.perf_counter() - t0, "launches": launches, **card})
    if (code != 0 or files or bad_steps or bad_evals or not finite
            or len(first.get("steps", [])) != 8 or not first.get("evals")
            or not resumed_ok or bad_fused or start != (0, 2) or not bitwise
            or alive or not rebuilt_equal or close_s > 6):
        raise AssertionError("trainer_cli failed (see its line)")
    shutil.rmtree(tmp, ignore_errors=True)
    return launches, ta, p50


# steps of a Trainer's epoch that trainer_profile traces: its last ones
TRAINER_PROFILE_STEPS = 2


def trainer_profile(trainer, card, step_ms, label="trainer_device_profile"):
    """torch.profiler over the last :data:`TRAINER_PROFILE_STEPS` steps of
    one more epoch of ``trainer`` (its loader started at that batch), in the
    default LayerNorm mode, the mode of the CLI runs that gave ``step_ms``:
    the device's busy time per step and its idle share of ``step_ms`` (the
    Trainer's unprofiled step p50, as :func:`device_profile` takes it) and
    of the profiled steps' wall time (the profiler slows the host's
    launches)."""
    from torch.profiler import ProfilerActivity, profile

    steps = min(TRAINER_PROFILE_STEPS, len(trainer.train_dataloader))
    trainer.epoch = 1
    trainer.train_dataloader.start_batch = len(trainer.train_dataloader) - steps
    with ln_mode(""), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_epoch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0) or 0 for e in kernels) / 1e3 / steps
    emit({"phase": label, "steps": steps, "ln_mode": "default",
          "profiled_wall_ms_per_step": wall / steps, "device_busy_ms_per_step": busy or None,
          "unprofiled_step_p50_ms": step_ms,
          "device_idle_share": 1 - busy / step_ms if busy and step_ms else None,
          "device_idle_share_profiled": 1 - busy / (wall / steps) if busy else None,
          "device_ops_per_step": sum(e.count for e in kernels) // steps, **card})


PULL_AHEAD_ORDER = (1, 8, 8, 1)


def trainer_pull_ahead(card):
    """The Trainer of :data:`CLI_OVERRIDES` with ``steps_per_dispatch`` 1
    (each batch stepped as it arrives, the loader's thread making the next
    ones meanwhile) and 8 (the default: 8 batches pulled, then stepped),
    one epoch of 8 steps each in turns (1, 8, 8, 1), checkpoints
    off: each setting's step p50 (``train/step_time_s``) and samples/s per
    epoch. A measurement; no gate."""
    import shutil
    import tempfile

    from bifold_tpu_torch.config import Config, compose
    from bifold_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_pull_"))
    clear_launch_counts()
    trainers = {}
    for k in (1, 8):
        cfg = compose(list(CLI_OVERRIDES) + [
            "epochs=2", "eval_epochs=0", f"steps_per_dispatch={k}",
            f"run_dir={tmp / str(k)}"])
        trainers[k] = Trainer(Config(cfg), run_dir=tmp / str(k))
        trainers[k].save_model = lambda name: None
        trainers[k].prepare_train()
    step_ms = {1: [], 8: []}
    samples_per_s = {1: [], 8: []}
    for epoch, k in enumerate(PULL_AHEAD_ORDER):
        tr = trainers[k]
        tr.epoch = epoch // 2
        tr.train_epoch()
        rows = [json.loads(line) for line in
                (tr.run_dir / "metrics.jsonl").read_text().splitlines()]
        last = max(i for i, r in enumerate(rows) if "train/epoch" in r)
        first = max([i for i, r in enumerate(rows[:last]) if "train/epoch" in r],
                    default=-1) + 1
        step_ms[k] += [r["train/step_time_s"] * 1e3 for r in rows[first:last]
                       if "train/step_time_s" in r]
        samples_per_s[k].append(rows[last]["train/samples_per_sec"])
    launches = launch_counts()
    del trainers, tr
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "trainer_pull_ahead", "order": list(PULL_AHEAD_ORDER),
          "step_p50_ms": {k: statistics.median(v) for k, v in step_ms.items()},
          "step_ms": step_ms, "samples_per_s_per_epoch": samples_per_s,
          "seconds": time.perf_counter() - t0, "launches": launches, **card})
    return launches


# the two CLIP families, composed from the port's conf as the CLI composes
# them: bimanual data at the dataset's 384 px (rgb_clip resizes to its 224)
FAMILIES = ("rgb_clip", "text_unet")
FAMILY_DATA = ("train_dataset=synthetic", "train_dataset.image_size=384",
               "train_dataset.is_bimanual=true", "test_dataset=null")
# flash launches of one forward: rgb_clip's 8 fusion layers at head dim 32
# (its CLIP towers take the math path, as in JAX: 197 vision tokens < 256,
# the text tower causal); text_unet's only attention is its causal text tower
FAMILY_INFER = {"rgb_clip": {"fwd_infer_d32": 8}, "text_unet": {}}
FAMILY_STEP = {"rgb_clip": {"fwd_lse_d32": 8, "bwd_d32": 8}, "text_unet": {}}
INT8_MIN_SIZE = 2 ** 16                  # the serving default
# the tables JAX's int8 rule keeps float (bifold_tpu/serving.py:117)
FAMILY_TABLES = ("clip_encoder.visual.positional_embedding",
                 "clip_encoder.positional_embedding",
                 "clip_encoder.token_embedding.weight", "rgb_pos_embedding",
                 "text_pos_embedding")


def family_config(family, *extra):
    from bifold_tpu_torch.config import compose

    return compose([f"model={family}", *FAMILY_DATA, *extra])


@torch.no_grad()
def seeded_stats(model, seed=11):
    """Non-trivial BatchNorm running statistics (means N(0, 0.1), variances
    in [0.5, 1.5]), the same for every model of one configuration."""
    gen = torch.Generator().manual_seed(seed)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
        elif name.endswith("running_var"):
            buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))


def serve_family(card, family, device="cuda"):
    """One CLIP family served as a user serves it: the composed
    ``model=<family>`` config (bimanual, bf16, seeded weights; text_unet
    with non-trivial BatchNorm statistics) behind ``ServingModel`` at a
    720 px camera. In each ``BIFOLD_LN_KERNEL`` mode, 11 ``predict``
    requests and one ``predict_batch`` of 8, each with exactly
    :data:`FAMILY_INFER` flash launches and the LayerNorm launches its
    modules give (text_unet under "pallas": its text tower's 25); an f32
    model's kernel forward against the math path (heatmaps within 1e-4,
    the same actions); int8 serving, its decisions those of
    ``quantize_weights`` on the CPU, the tables kept float, its actions
    reported; for text_unet a checkpoint of the live weights and statistics
    written by the port's ``save_checkpoint`` in JAX's format served by
    ``from_checkpoint`` bitwise as the live server serves. The batch-1 and
    pool-8 p50s (default mode), and the phases for
    :func:`where_the_time_goes`. ``device="cpu"`` is a rehearsal at a tiny
    size, the launch checks stubbed by the caller."""
    import tempfile

    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.models import build_model
    from bifold_tpu_torch.models.convert import to_jax_variables
    from bifold_tpu_torch.serving import ServingModel, _served_weights, quantize_weights
    from bifold_tpu_torch.utils.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    cfg = family_config(family)
    mcfg = dict(cfg["model"])
    size = int(mcfg["image_size"])

    def make(dtype):
        model = build_model(mcfg, dtype=dtype, device=device, seed=0)
        seeded_stats(model)
        return model

    model = make(torch.bfloat16)
    proc = Processor(dict(cfg["processor"]), partition="test")
    live = ServingModel(model, None, proc, device=device)
    live.warmup(CAMERA)
    live.warmup(CAMERA, pool=8)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(31)

    def frame():
        obs = observation(rng, 0)
        del obs["context"]
        return obs

    requests = [(frame(), INSTRUCTIONS[i % 5]) for i in range(11)]
    pool = [dict(frame(), instruction=INSTRUCTIONS[i % 5]) for i in range(8)]
    want = {mode: {**FAMILY_INFER[family], **norm_launches(live.model, mode)}
            for mode in LN_MODES}
    if family == "text_unet" and want["pallas"] != {"ln_fwd": 25}:
        raise AssertionError(f"text_unet's text tower: {want['pallas']}, want 25 ln_fwd")
    clear_launch_counts()                # the family's served run starts here
    ref = {}
    for mode in LN_MODES:
        for i, (obs, text) in enumerate(requests):
            out = counted(lambda: live.predict(**obs, instruction=text,
                                               return_raw_output=True),
                          mode, want[mode], f"{family} request {i}")
            check_action(*out, 1, size)
            ref.setdefault(mode, out)
        out = counted(lambda: live.predict_batch(pool, pad_to=8, return_raw_output=True),
                      mode, want[mode], f"{family} pool")
        check_action(*out, 8, size)
    launches = launch_counts()           # ... and ends here
    emit({"phase": f"serve_{family}", "requests_per_mode": len(requests), "pool": 8,
          "launches_per_request": want, "launches": launches, "setup_s": setup_s,
          "parameters": sum(p.numel() for p in model.parameters())})

    # the f32 kernel forward against the math path
    obs, text = requests[0]
    f32 = ServingModel(make(torch.float32), None, proc, device=device)
    k_action, k_raw = f32.predict(**obs, instruction=text, return_raw_output=True)
    m_action, m_raw = math_forward(f32, obs, text)
    hm_diff = max(float(np.abs(k_raw[k] - m_raw[k]).max())
                  for k in k_raw if k.endswith("_heatmap"))
    same = all(np.array_equal(getattr(k_action, f), getattr(m_action, f))
               for f in ACTION_FIELDS)
    emit({"phase": f"serve_{family}_kernel_vs_math", "dtype": "float32",
          "max_heatmap_diff": hm_diff, "tol": 1e-4, "actions_identical": same,
          "decoded_apart": decoded_apart(k_action, m_action, k_raw)})
    if not (same and hm_diff <= 1e-4):
        raise AssertionError(f"{family}: f32 kernel and math forwards disagree")
    del f32

    # int8: the CPU's decisions, tables float, actions reported
    int8 = ServingModel(model, None, proc, device=device, quantize="int8",
                        quantize_min_size=INT8_MIN_SIZE)
    on_card = sorted(k for k, v in _served_weights(int8.model).items() if isinstance(v, dict))
    on_cpu = sorted(k for k, v in quantize_weights(
        {n: p.detach().float().cpu() for n, p in model.named_parameters()},
        min_size=INT8_MIN_SIZE).items() if isinstance(v, dict))
    kept = [t for t in FAMILY_TABLES if t in dict(model.named_parameters())]
    q_action, q_raw = int8.predict(**obs, instruction=text, return_raw_output=True)
    check_action(q_action, q_raw, 1, size)
    emit({"phase": f"serve_{family}_int8", "quantized_tensors": len(on_card),
          "decisions_as_on_the_cpu": on_card == on_cpu, "tables_kept_float": kept,
          "actions": {f: getattr(q_action, f).tolist() for f in ACTION_FIELDS},
          "bf16_actions": {f: getattr(ref[""][0], f).tolist() for f in ACTION_FIELDS}})
    if on_card != on_cpu or not on_card or set(kept) & set(on_card):
        raise AssertionError(f"{family}: int8 decisions differ from the CPU's or "
                             "quantize a table")
    del int8

    if family == "text_unet":
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "last.ckpt"
            params, extra = to_jax_variables(family, {k: v.float() for k, v in
                                                      model.state_dict().items()})
            save_checkpoint(path, params=params, extra_vars=extra,
                            metadata={"model": mcfg})
            from_ckpt = ServingModel.from_checkpoint(path, cfg, device=device)
            same = {mode: same_output(counted(
                lambda: from_ckpt.predict(**obs, instruction=text, return_raw_output=True),
                mode, want[mode], "text_unet checkpoint"), ref[mode])
                for mode in LN_MODES}
            emit({"phase": "serve_text_unet_checkpoint",
                  "batch_stats_tensors": len(nested_leaves(extra)),
                  "bytes": path.stat().st_size, "bitwise_vs_live": same})
            if not all(same.values()):
                raise AssertionError("text_unet: the checkpoint serves other outputs")
            del from_ckpt

    times = {"batch1": [], "pool8": []}
    for _ in range(LATENCY_ROUNDS):
        for name, call in (("batch1", lambda: live.predict(**obs, instruction=text)),
                           ("pool8", lambda: live.predict_batch(pool, pad_to=8))):
            t = time.perf_counter()
            call()
            times[name].append((time.perf_counter() - t) * 1e3)
    lat = {name: statistics.median(v) for name, v in times.items()}
    emit({"phase": f"serve_{family}_latency", "p50_ms_batch1": lat["batch1"],
          "p50_ms_pool8": lat["pool8"], "requests_each": LATENCY_ROUNDS, "ln_mode": "default",
          "seconds": time.perf_counter() - t0, **card})
    phases = [serving_phase(live, "", f"{family} {name}", obs_list, lat[name])
              for name, obs_list in (("batch1", [dict(obs, instruction=text)]),
                                     ("pool8", pool))]
    return launches, phases


def nested_leaves(tree):
    """The leaves of a nested dict."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in nested_leaves(v)]
    return [tree]


FAMILY_CLI = ("train_dataset.n_samples=16", "batch_size=2", "test_batch_size=2",
              "epochs=1", "eval_epochs=1", "simulator=null", "log_every=1")


def trainer_cli_families(card, device="cuda"):
    """``main`` of ``bifold_tpu_torch.__main__`` with ``model=rgb_clip``,
    then ``model=text_unet``: synthetic bimanual data at 384 px, 16
    samples, batch 2, one epoch of 8 steps, pixel eval, ``best`` and
    ``last``. Gates: exit 0, exactly :data:`FAMILY_STEP` launches per step
    and :data:`FAMILY_INFER` per eval batch, finite metrics, text_unet's
    running statistics moved; then text_unet 5 steps straight against a
    run interrupted at its third step and resumed: every weight and
    statistic bitwise equal. Reports each family's step p50 and samples/s.
    ``device="cpu"``: a rehearsal at a tiny size."""
    import shutil
    import tempfile

    from bifold_tpu_torch.config import Config, load_yaml

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_families_"))
    cpu = ["use_cpu=true"] if device == "cpu" else []
    launches, ok = collections.Counter(), True
    for family in FAMILIES:
        record = {}
        overrides = [f"model={family}", *FAMILY_DATA, *FAMILY_CLI,
                     f"run_dir={tmp / family}", *cpu]
        clear_launch_counts()            # the family's Trainer run starts here
        code, run_dir, seconds = run_cli(overrides, record)
        trainer = record.pop("trainers")[0]
        run_launches = launch_counts()   # ... and ends here
        launches.update(run_launches)
        evals = load_yaml(run_dir / "eval_synthetic.yaml")
        logged = [json.loads(line) for line in
                  (run_dir / "metrics.jsonl").read_text().splitlines()]
        step_s = [r["train/step_time_s"] for r in logged if "train/step_time_s" in r]
        sps = [r["train/samples_per_sec"] for r in logged if "train/samples_per_sec" in r]
        bad_steps = [d for d in record.get("steps", []) if d != FAMILY_STEP[family]]
        bad_evals = [d for d in record.get("evals", []) if d != FAMILY_INFER[family]]
        finite = evals.get("kp_mse") is not None and all(
            v is None or np.isfinite(v) for v in evals.values())
        moved = None
        if family == "text_unet":
            moved = all(bool(b.abs().max() > 0) for n, b in trainer.model.named_buffers()
                        if n.endswith("running_mean"))
        line = {"phase": f"trainer_cli_{family}", "exit_code": code, "seconds": seconds,
                "steps": len(record.get("steps", [])),
                "launches_per_step": FAMILY_STEP[family],
                "steps_with_other_launches": bad_steps,
                "eval_batches": len(record.get("evals", [])),
                "eval_batches_with_other_launches": bad_evals, "eval": evals,
                "running_stats_moved": moved,
                "trainer_step_p50_ms": statistics.median(step_s) * 1e3 if step_s else None,
                "trainer_samples_per_s": sps, "launches": run_launches, **card}
        emit(line)
        ok &= (code == 0 and not bad_steps and not bad_evals and finite
               and line["steps"] == 8 and line["eval_batches"] > 0 and moved is not False)
        del trainer

    # text_unet: 5 steps straight, and interrupted at the 3rd + resumed
    def unet_trainer(name, record):
        cfg = family_config("text_unet", "train_dataset.n_samples=10", "batch_size=2",
                            "epochs=1", "eval_epochs=0", "simulator=null",
                            f"run_dir={tmp / name}", *cpu)
        return observed_trainer(record)(Config(cfg), run_dir=tmp / name)

    straight, broken, resumed = {}, {}, {}
    ta = unet_trainer("a", straight)
    ta.prepare_train()
    ta.train()
    tb = unet_trainer("b", broken)
    tb.prepare_train()
    real_step, calls = tb._train_step, [0]

    def interrupted(state, batch):
        calls[0] += 1
        if calls[0] == 3:
            raise KeyboardInterrupt
        return real_step(state, batch)

    tb._train_step = interrupted
    try:
        tb.train()
        raise AssertionError("the interrupted run did not stop")
    except KeyboardInterrupt:
        pass
    tc = unet_trainer("b", resumed)
    tc.prepare_train()
    start = (tc.epoch, tc._resume_step_in_epoch)
    tc.train()
    a_state = ta.model.state_dict()
    bitwise = {kind: all(torch.equal(v, a_state[k]) for k, v in tc.model.state_dict().items()
                         if k.endswith(("running_mean", "running_var")) == (kind == "stats"))
               for kind in ("weights", "stats")}
    emit({"phase": "trainer_cli_text_unet_resume", "interrupted_resume_start": list(start),
          "steps": [len(straight.get("steps", [])), len(broken.get("steps", [])),
                    len(resumed.get("steps", []))],
          "bitwise": bitwise, "seconds": time.perf_counter() - t0})
    ok &= start == (0, 2) and all(bitwise.values())
    del ta, tb, tc, straight["trainers"], broken["trainers"], resumed["trainers"]
    shutil.rmtree(tmp, ignore_errors=True)
    if not ok:
        raise AssertionError("trainer_cli_families failed (see its lines)")
    return dict(launches)


# the SigLIP head, fusion and FFN variants of the flagship, each a model
# option of bifold_tpu_torch/conf/model/siglip_sequential.yaml
VARIANTS = {
    "transdecoder": {"pick_place_model": "pick_place_transdecoder"},
    "crossattention": {"fusion_model": "crossattention"},
    "moe": {"moe_experts": 8, "moe_top_k": 1, "moe_capacity_factor": 1.25,
            "moe_aux_weight": 0.01},
}
# The variants run at the flagship's widths and heads but the cut depth
# of the multi-rank phases (CUT_LAYERS-layer towers, fusions of CUT_DEPTH,
# defined with them below): every kernel instance and shape is the same.
# Flash launches of one served forward (any batch): two fusions (d48) and
# two depth-2 f32 decoders at 577 tokens (d32) for the transformer
# decoder; cross-attention's query and key lengths differ, so its fusion
# takes the math path (as in JAX) and only the vision tower (d64)
# launches; MoE changes the FFNs only
VARIANT_LAYERS, VARIANT_DEPTH = 2, 2
VARIANT_INFER = {"transdecoder": {"fwd_infer_d48": 2 * VARIANT_DEPTH,
                                  "fwd_infer_d64": VARIANT_LAYERS, "fwd_infer_d32_f32": 4},
                 "crossattention": {"fwd_infer_d64": VARIANT_LAYERS},
                 "moe": {"fwd_infer_d48": VARIANT_DEPTH, "fwd_infer_d64": VARIANT_LAYERS}}
VARIANT_STEP = {name: {f"{kind}_{key.split('_', 2)[2]}": n
                       for key, n in infer.items() for kind in ("fwd_lse", "bwd")}
                for name, infer in VARIANT_INFER.items()}
# the variants whose deployment paths (int8, checkpoint, artifact) run here
VARIANT_DEPLOY = ("transdecoder", "moe")
VARIANT_AUTOMODEL = "google/siglip-base-patch16-384-2-layers"
VARIANT_CLI = ("train_dataset=synthetic", "train_dataset.image_size=384",
               "train_dataset.is_bimanual=true", "train_dataset.max_context_length=3",
               "train_dataset.n_samples=8", "test_dataset=null",
               "model=siglip_sequential", f"model.automodel_name={VARIANT_AUTOMODEL}",
               f"model.depth={VARIANT_DEPTH}", "batch_size=2", "test_batch_size=2",
               "epochs=1", "eval_epochs=1", "simulator=null", "log_every=1")


def variant_config(variant):
    """The variant's model config at the variants' depth (the 384 px SigLIP
    towers cut to :data:`VARIANT_LAYERS` layers, registered here)."""
    register_siglip(VARIANT_AUTOMODEL, layers=VARIANT_LAYERS)
    return {**FLAGSHIP, "automodel_name": VARIANT_AUTOMODEL, "depth": VARIANT_DEPTH,
            **VARIANTS[variant]}


def variant_phase(card, variant, device="cuda"):
    """One variant of the flagship (:data:`VARIANTS`) at full width and the
    variants' depth (:func:`variant_config`; 384 px, bimanual, 3 context
    frames, bf16, seeded weights), as a user serves and trains it:

    - served behind ``ServingModel`` at a 720 px camera in each
      ``BIFOLD_LN_KERNEL`` mode: 5 ``predict`` requests (1-3 context
      frames) and one ``predict_batch`` of 8, each with exactly
      :data:`VARIANT_INFER` flash launches and the LayerNorm launches its
      modules give, finite actions of the right shape; an f32 model's
      kernel forward against the math path (the same actions, heatmaps
      within 1e-3, as the flagship's); batch-1 and pool-8 p50s;
    - for :data:`VARIANT_DEPLOY`: int8 serving (the CPU's decisions; in
      each mode bitwise a server holding the dequantized weights as bf16),
      the live weights as a JAX trainer checkpoint and as a batch-1 export
      artifact, each served bitwise as the live server serves, in each
      mode;
    - trained through ``main`` (:func:`variant_trainer`), the transformer
      decoder also under ``BIFOLD_LN_KERNEL=pallas``
      (:data:`VARIANT_TRAIN_MODES`), with exact launches per step and
      eval batch, and the default run's peak memory.

    Returns (the launches of its runs, its serving phases for
    :func:`where_the_time_goes`, its train peak bytes). ``device="cpu"``
    is a rehearsal at a tiny size, the launch checks stubbed by the
    caller."""
    import tempfile

    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.models import build_model
    from bifold_tpu_torch.models.convert import convert_bifold
    from bifold_tpu_torch.serving import (ServingModel, _install, _served_weights,
                                          dequantize_weights, quantize_weights)

    t0 = time.perf_counter()
    mcfg = variant_config(variant)
    size = int(mcfg["image_size"])
    model = build_model(mcfg, dtype=torch.bfloat16, device=device, seed=0)
    proc = Processor(PROCESSOR, max_context_length=3,
                     autoprocessor_name=mcfg["automodel_name"],
                     spm_asset=fixture_model_bytes())
    live = ServingModel(model, None, proc, device=device)
    live.warmup(CAMERA)
    live.warmup(CAMERA, pool=8)
    rng = np.random.default_rng(41)
    requests = [dict(observation(rng, n_ctx=1 + i % 3), instruction=INSTRUCTIONS[i])
                for i in range(5)]
    pool = [dict(observation(rng, n_ctx=1 + i % 3), instruction=INSTRUCTIONS[i % 5])
            for i in range(8)]
    want = {mode: {**VARIANT_INFER[variant], **norm_launches(live.model, mode)}
            for mode in LN_MODES}
    obs = requests[0]
    launches = collections.Counter()
    clear_launch_counts()                # the variant's served run starts here

    def one(server, mode, label):
        return counted(lambda: server.predict(**obs, return_raw_output=True), mode,
                       want[mode], f"{variant} {label}")

    ref = {}
    for mode in LN_MODES:
        for i, request in enumerate(requests):
            out = counted(lambda: live.predict(**request, return_raw_output=True),
                          mode, want[mode], f"{variant} request {i}")
            check_action(*out, 1, size)
            ref.setdefault(mode, out)
        out = counted(lambda: live.predict_batch(pool, pad_to=8, return_raw_output=True),
                      mode, want[mode], f"{variant} pool")
        check_action(*out, 8, size)
    launches.update(launch_counts())     # ... and ends here
    emit({"phase": f"variant_{variant}_serve", "config": VARIANTS[variant],
          "requests_per_mode": len(requests), "pool": 8,
          "launches_per_request": want, "launches": launch_counts(),
          "parameters": sum(p.numel() for p in model.parameters()),
          "setup_s": time.perf_counter() - t0})

    # the f32 kernel forward against the math path
    f32 = ServingModel(build_model(mcfg, dtype=torch.float32, device=device, seed=0),
                       None, proc, device=device)
    text = obs["instruction"]
    frame = {k: v for k, v in obs.items() if k != "instruction"}
    k_action, k_raw = f32.predict(**obs, return_raw_output=True)
    m_action, m_raw = math_forward(f32, frame, text)
    hm_diff = max(float(np.abs(k_raw[k] - m_raw[k]).max())
                  for k in k_raw if k.endswith("_heatmap"))
    same = all(np.array_equal(getattr(k_action, f), getattr(m_action, f))
               for f in ACTION_FIELDS)
    emit({"phase": f"variant_{variant}_kernel_vs_math", "dtype": "float32",
          "max_heatmap_diff": hm_diff, "tol": 1e-3, "actions_identical": same,
          "decoded_apart": decoded_apart(k_action, m_action, k_raw)})
    if not (same and hm_diff < 1e-3):
        raise AssertionError(f"{variant}: f32 kernel and math forwards disagree")
    del f32

    if variant in VARIANT_DEPLOY:
        clear_launch_counts()            # the deployment paths' run starts here
        results = {}
        int8 = ServingModel(model, None, proc, device=device, quantize="int8")
        served = _served_weights(int8.model)
        on_card = sorted(k for k, v in served.items() if isinstance(v, dict))
        on_cpu = sorted(k for k, v in quantize_weights(
            {n: p.detach().float().cpu() for n, p in model.named_parameters()}).items()
            if isinstance(v, dict))
        plain_model = build_model(mcfg, dtype=torch.bfloat16, device=device, seed=0)
        _install(plain_model, dequantize_weights(served, torch.bfloat16), torch.bfloat16)
        dequantized = ServingModel._served(plain_model, proc, None, "float32", None)
        results["int8"] = {mode: same_output(one(int8, mode, "int8"),
                                             one(dequantized, mode, "dequantized"))
                           for mode in LN_MODES}
        new = [k for k in on_card if ".fn.w" in k or "_decoder." in k]
        emit({"phase": f"variant_{variant}_int8", "quantized_tensors": len(on_card),
              "variant_tensors_quantized": new[:6] + (["..."] if len(new) > 6 else []),
              "decisions_as_on_the_cpu": on_card == on_cpu,
              "bitwise_vs_dequantized_bf16": results["int8"]})
        if on_card != on_cpu or not new:
            raise AssertionError(f"{variant}: int8 decisions differ from the CPU's")
        del int8, dequantized, plain_model, served
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            write_jax_checkpoint(tmp / "last.ckpt", convert_bifold(
                {k: v.float() for k, v in model.state_dict().items()}), mcfg)
            (tmp / "spiece.model").write_bytes(fixture_model_bytes())
            from_ckpt = ServingModel.from_checkpoint(
                tmp / "last.ckpt", {"model": mcfg, "processor": PROCESSOR,
                                    "precision": {"compute_dtype": "bfloat16"}},
                device=device)
            results["checkpoint"] = {mode: same_output(one(from_ckpt, mode, "checkpoint"),
                                                       ref[mode]) for mode in LN_MODES}
            del from_ckpt
            path = live.export(tmp / "serve_b1.pt", **obs, batch=1)
            art = ServingModel.load_exported(path, device=device)
            results["artifact_b1"] = {mode: same_output(one(art, mode, "artifact"),
                                                        ref[mode]) for mode in LN_MODES}
            del art
        launches.update(launch_counts())     # ... and ends here
        emit({"phase": f"variant_{variant}_deployment", "bitwise": results})
        failed = [f"{k} {m}" for k, by_mode in results.items()
                  for m, ok in by_mode.items() if not ok]
        if failed:
            raise AssertionError(f"{variant}: deployment paths differ from live: {failed}")

    times = {"batch1": [], "pool8": []}
    for _ in range(LATENCY_ROUNDS):
        for name, call in (("batch1", lambda: live.predict(**obs)),
                           ("pool8", lambda: live.predict_batch(pool, pad_to=8))):
            t = time.perf_counter()
            call()
            times[name].append((time.perf_counter() - t) * 1e3)
    lat = {name: statistics.median(v) for name, v in times.items()}
    emit({"phase": f"variant_{variant}_latency", "p50_ms_batch1": lat["batch1"],
          "p50_ms_pool8": lat["pool8"], "requests_each": LATENCY_ROUNDS, "ln_mode": "default",
          **card})
    phases = [serving_phase(live, "", f"{variant} {name}", obs_list, lat[name])
              for name, obs_list in (("batch1", [obs]), ("pool8", pool))]

    # trained through the entry point
    lines = [variant_trainer(card, variant, mode, model, device)
             for mode in VARIANT_TRAIN_MODES.get(variant, ("",))]
    emit({"phase": f"variant_{variant}", "seconds": time.perf_counter() - t0})
    for line in lines:
        launches.update(line["launches"])
    return dict(launches), phases, lines[0]["peak_train_memory_bytes"]


# the transformer decoder's f32 512-wide LayerNorms train through the
# LayerNorm kernels too: in stacks 2 a layer of the towers and of the two
# fusions and 8 in the two decoders, and 2 others (decoder_norm, flax's own
# LayerNorm in JAX, is a plain torch.nn.LayerNorm's parameters under the
# plain forward and never takes them)
VARIANT_TRAIN_MODES = {"transdecoder": ("", "pallas")}
VARIANT_NORMS = {"transdecoder": (2 * (2 * VARIANT_LAYERS + 2 * VARIANT_DEPTH) + 8, 2)}


def variant_trainer(card, variant, mode, model, device="cuda"):
    """``main`` of ``bifold_tpu_torch.__main__`` on the variant under
    ``BIFOLD_LN_KERNEL=mode`` (synthetic data, 8 samples, batch 2: 4
    steps, pixel eval, best/last), with exactly :data:`VARIANT_STEP`
    launches per step (and the mode's LayerNorm launches, counted from
    ``model``) and :data:`VARIANT_INFER` per eval batch, finite losses
    (and, for MoE, the logged load-balance term); returns its line, with
    the run's peak memory."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix=f"bifold_{variant}_"))
    overrides = [*VARIANT_CLI,
                 *(f"model.{k}={v}" for k, v in VARIANTS[variant].items()),
                 f"run_dir={tmp}", *(["use_cpu=true"] if device == "cpu" else [])]
    per_step, per_eval = dict(VARIANT_STEP[variant]), dict(VARIANT_INFER[variant])
    if mode:
        per_step.update(ln_launches(model, mode, True, VARIANT_NORMS[variant]))
        per_eval.update(norm_launches(model, mode))
    record = {}
    if device == "cuda":
        gc.collect()                     # the dropped models' cycles, first
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    with ln_mode(mode):
        clear_launch_counts()            # the variant's Trainer run starts here
        code, run_dir, seconds = run_cli(overrides, record)
        run_launches = launch_counts()   # ... and ends here
    peak = (torch.cuda.max_memory_allocated() - base) if device == "cuda" else None
    record.pop("trainers")
    logged = [json.loads(line) for line in
              (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in logged if "train/loss" in r]
    balance = [r["train/moe_load_balance"] for r in logged
               if "train/moe_load_balance" in r]
    step_s = [r["train/step_time_s"] for r in logged if "train/step_time_s" in r]
    bad_steps = [d for d in record.get("steps", []) if d != per_step]
    bad_evals = [d for d in record.get("evals", []) if d != per_eval]
    line = {"phase": f"variant_{variant}_trainer_cli", "ln_mode": mode or "default",
            "exit_code": code, "seconds": seconds, "steps": len(record.get("steps", [])),
            "launches_per_step": per_step, "steps_with_other_launches": bad_steps,
            "eval_batches": len(record.get("evals", [])),
            "eval_batches_with_other_launches": bad_evals, "losses": losses,
            "moe_load_balance": balance,
            "trainer_step_p50_ms": statistics.median(step_s) * 1e3 if step_s else None,
            "peak_train_memory_bytes": peak, "launches": run_launches, **card}
    emit(line)
    shutil.rmtree(tmp, ignore_errors=True)
    ok = (code == 0 and not bad_steps and not bad_evals and line["steps"] == 4
          and line["eval_batches"] > 0 and len(losses) == 4
          and all(np.isfinite(losses))
          and (variant != "moe" or (len(balance) == 4 and all(np.isfinite(balance)))))
    if not ok:
        raise AssertionError(f"{variant}: the Trainer run failed (see its line)")
    return line


REMAT_RTOL = 1e-6


def remat_phase(card, device="cuda"):
    """One f32 flagship train step (SGD, dropout 0.1 in the fusion and the
    config's LoRA dropout) with ``remat`` (every tower and fusion block
    recomputed in the backward, its dropout draws replayed) and without,
    from the same weights, batch and draws: loss and trainable-gradient
    norm within 1e-6 relative; the peak memory of each step above the
    model and optimizer, and the seconds of that first step and of two
    more (the same batch, on the updated weights), their p50 after the
    first, and (after both runs' host clocks) the device busy time and
    idle share of a warm step from the profiler. Each of the two runs
    is a main path of the f32 flash instances at d48 and d64: its counts
    are reset just before its three steps and read just after, and each
    step launches exactly :data:`PER_STEP` at f32, with every forward
    with lse launched twice under ``remat`` (each block's forward runs
    again in the backward). Returns (the two runs' lines, their launches)."""
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.losses import build_loss
    from bifold_tpu_torch.models import build_model, trainable_mask
    from bifold_tpu_torch.optim import build_optimizer
    from bifold_tpu_torch.parallel import TrainState, make_train_step

    proc = Processor(TRAIN_PROCESSOR, partition="train", max_context_length=3,
                     autoprocessor_name=FLAGSHIP["automodel_name"],
                     spm_asset=fixture_model_bytes(), seed=0)
    raw = raw_train_batch(proc, 77)
    draws = proc.draw(proc._spec(raw), TRAIN_BATCH, raw["rgb"].shape[1:3], device)
    cfg = {**FLAGSHIP, "dropout": 0.1}
    results, launches, runs = {}, collections.Counter(), {}
    for remat in (False, True):
        want = f32_keys({k: n * (2 if remat and k.startswith("fwd") else 1)
                         for k, n in PER_STEP.items()})
        model = build_model(cfg, dtype=torch.float32, device=device, seed=0,
                            remat=remat)
        trainable_mask(model, lora=True)
        params = [p for p in model.parameters() if p.requires_grad]
        opt = build_optimizer({"name": "sgd", "lr": 1e-3}, params, None, max_iters=10,
                              gradient_clip=1.0)
        step = make_train_step(model, build_loss(dict(LOSS)), opt)
        state = TrainState.create(opt, seed=0)
        sample = proc.process_batch(raw, device, draws=draws)
        if device == "cuda":
            gc.collect()                 # the other model's cycles, first
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        seconds, steps = [], []
        clear_launch_counts()            # this run's steps start here
        for i in range(3):
            before = launch_counts()
            t = time.perf_counter()
            state, metrics = step(state, sample)
            if device == "cuda":
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
            steps.append(launched_since(before))
            if i == 0:
                first = {"loss": float(metrics["loss"]),
                         "grad_norm_trainable": float(metrics["grad_norm_trainable"]),
                         "peak_memory_bytes": (torch.cuda.max_memory_allocated() - base
                                               if device == "cuda" else None)}
        launches.update(launch_counts())     # ... and end here
        name = "remat" if remat else "plain"
        results[name] = {
            **first, "launches_per_step": want, "launches": launch_counts(),
            "steps_with_other_launches": [d for d in steps if d != want],
            "step_seconds": seconds,
            "warm_p50_ms": statistics.median(seconds[1:]) * 1e3}
        runs[name] = (step, state, sample)
        del model, opt, params, metrics
    if device == "cuda":                 # the profiler, after both host clocks
        for name, (step, state, sample) in runs.items():
            results[name].update(device_profile(
                lambda step=step, state=state, sample=sample: step(state, sample),
                results[name]["warm_p50_ms"]))
    del runs, step, state, sample
    plain, remat = results["plain"], results["remat"]
    rel = {k: abs(remat[k] - plain[k]) / abs(plain[k])
           for k in ("loss", "grad_norm_trainable")}
    emit({"phase": "remat_train_step", "dtype": "float32", "dropout": 0.1,
          **results, "rel_diff": rel, "tol": REMAT_RTOL, **card})
    if any(v > REMAT_RTOL for v in rel.values()):
        raise AssertionError(f"remat changes the f32 step: {rel}")
    if device == "cuda" and (plain["steps_with_other_launches"]
                             or remat["steps_with_other_launches"]):
        raise AssertionError("remat_phase: a step launched other kernels (see its line)")
    return results, dict(launches)


# The configurations the port once refused, each on the card at full
# width: rgb_clip with the transformer-decoder head and with the
# cross-attention fusion, the graph-conditioned flagship through the
# two-dispatch server, and int8 of the stacks' one-dim leaves.
REFUSED_RGB = {"transdecoder": {"pick_place_model": "pick_place_transdecoder"},
               "crossattention": {"fusion_model": "crossattention"}}
# flash launches of one rgb_clip request at 224 px (any batch): the
# transformer decoder's pick and place fusions, 8 layers each over 197
# image + 78 text tokens at head dim 32; its decoders (197 tokens), the CLIP
# towers and cross-length attention take the math path (as in JAX), so
# crossattention launches none
REFUSED_INFER = {"transdecoder": {"fwd_infer_d32": 16}, "crossattention": {}}
REFUSED_STEP = {"fwd_lse_d32": 16, "bwd_d32": 16}
# the graph features of bifold_tpu_torch/conf/dataset/single.yaml
GRAPH = {"num_nodes": 200, "neighbor_radius": 0.045, "voxel_size": 0.0125}
GRAPH_POOL = 8
GRAPH_INT8_MIN_SIZE = 2 ** 10
# bf16 kernel and math forwards of one network: the gate serve_flagship
# holds its heatmaps to
BF16_MATH_TOL = 0.05


def refused_rgb_clip(card, variant, device="cuda"):
    """``rgb_clip`` (ViT-B/16 CLIP towers, 224 px, fusion depth 8 of 16
    heads, bimanual, bf16, seeded weights) with the head or fusion of
    ``variant`` (:data:`REFUSED_RGB`), behind ``ServingModel`` at a 720 px
    camera: a request and a pool of 8, each with exactly
    :data:`REFUSED_INFER` flash launches; the f32 kernel forward against
    the math path (heatmaps within :data:`F32_TOL`, the same actions); for
    the transformer decoder one bf16 train step through the train
    Processor with exactly :data:`REFUSED_STEP` launches and a finite
    loss. Returns (its main paths' launches, its line)."""
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.losses import build_loss
    from bifold_tpu_torch.models import build_model, precast_frozen, trainable_mask
    from bifold_tpu_torch.optim import build_optimizer
    from bifold_tpu_torch.parallel import TrainState, make_train_step
    from bifold_tpu_torch.serving import ServingModel

    t0 = time.perf_counter()
    cfg = family_config("rgb_clip",
                        *(f"model.{k}={v}" for k, v in REFUSED_RGB[variant].items()))
    mcfg = dict(cfg["model"])
    size, want = int(mcfg["image_size"]), REFUSED_INFER[variant]
    proc = Processor(dict(cfg["processor"]), partition="test")
    live = ServingModel(build_model(mcfg, dtype=torch.bfloat16, device=device, seed=0),
                        None, proc, device=device)
    live.warmup(CAMERA)
    live.warmup(CAMERA, pool=8)
    rng = np.random.default_rng(41)

    def frame():
        obs = observation(rng, 0)
        del obs["context"]
        return obs

    obs, text = frame(), INSTRUCTIONS[0]
    pool = [dict(frame(), instruction=INSTRUCTIONS[i % 5]) for i in range(8)]
    clear_launch_counts()                # the variant's served run starts here
    one = counted(lambda: live.predict(**obs, instruction=text, return_raw_output=True),
                  "", want, f"rgb_clip {variant} request")
    check_action(*one, 1, size)
    check_action(*counted(lambda: live.predict_batch(pool, pad_to=8, return_raw_output=True),
                          "", want, f"rgb_clip {variant} pool"), 8, size)
    launches = collections.Counter(launch_counts())   # ... and ends here
    times = {"batch1": [], "pool8": []}
    for _ in range(LATENCY_ROUNDS):
        for name, call in (("batch1", lambda: live.predict(**obs, instruction=text)),
                           ("pool8", lambda: live.predict_batch(pool, pad_to=8))):
            t = time.perf_counter()
            call()
            times[name].append((time.perf_counter() - t) * 1e3)
    del live
    f32 = ServingModel(build_model(mcfg, dtype=torch.float32, device=device, seed=0),
                       None, proc, device=device)
    k_action, k_raw = f32.predict(**obs, instruction=text, return_raw_output=True)
    m_action, m_raw = math_forward(f32, obs, text)
    del f32
    hm_diff = max(float(np.abs(k_raw[k] - m_raw[k]).max()) for k in k_raw
                  if k.endswith("_heatmap"))
    same = all(np.array_equal(getattr(k_action, f), getattr(m_action, f))
               for f in ACTION_FIELDS)
    line = {"variant": variant, "image_size": size, "launches_per_request": want,
            "p50_ms_batch1": statistics.median(times["batch1"]),
            "p50_ms_pool8": statistics.median(times["pool8"]),
            "f32_kernel_vs_math_max_heatmap_diff": hm_diff, "tol": F32_TOL,
            "f32_actions_identical": same}
    ok = same and hm_diff <= F32_TOL
    if variant == "transdecoder":
        model = build_model(mcfg, dtype=torch.bfloat16, device=device, seed=0)
        trainable_mask(model, lora=False)
        precast_frozen(model, torch.bfloat16)
        opt = build_optimizer(dict(ADAM), [p for p in model.parameters() if p.requires_grad],
                              None, max_iters=100, gradient_clip=1.0)
        step = make_train_step(model, build_loss(dict(LOSS)), opt)
        train_proc = Processor(dict(cfg["processor"]), partition="train", seed=0)
        raw = {k: v for k, v in raw_train_batch(train_proc, 77).items()
               if not k.startswith("ctx_")}
        sample = train_proc.process_batch(raw, device,
                                          generator=torch.Generator(device).manual_seed(5))
        clear_launch_counts()            # the train step starts here
        _, metrics = counted(lambda: step(TrainState.create(opt, seed=0), sample), "",
                             REFUSED_STEP, "rgb_clip transdecoder train step")
        launches.update(launch_counts())  # ... and ends here
        loss = float(metrics["loss"])
        line.update({"train_step_launches": REFUSED_STEP, "train_loss": loss,
                     "train_grad_norm": float(metrics["grad_norm"])})
        ok &= bool(np.isfinite(loss))
        del model, opt, step
    line["seconds"] = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"refused_configs: rgb_clip {variant} failed ({line})")
    return dict(launches), line


def graph_observation(rng, n_ctx):
    """:func:`observation` with a depth map a camera sees: a table plane
    0.9 away with the cloth 5 mm above it, gently curved, and 0.2 mm of
    noise, so that the cloth's points have neighbours within the radius."""
    obs = observation(rng, n_ctx)
    yy, xx = np.mgrid[0:CAMERA, 0:CAMERA].astype(np.float32)
    surface = 0.9 - 0.004 * np.sin(xx / 60.0) * np.cos(yy / 80.0)
    for frame in [obs, *obs["context"]]:
        noise = 0.0002 * rng.standard_normal((CAMERA, CAMERA))
        frame["depth"] = (surface - 0.005 * frame["mask"] + noise).astype(np.float32)
    return obs


def graph_camera():
    """(matrix_world_to_camera, K) of the 720 px unimanual camera: the
    camera a graph observation is unprojected through."""
    from bifold_tpu_torch.data.datasets import deng_camera_matrices
    from bifold_tpu_torch.ops.geometry import intrinsic_from_fov

    return deng_camera_matrices()[0], intrinsic_from_fov(CAMERA, CAMERA, fov=45)


def refused_graph(card, device="cuda"):
    """The graph-conditioned flagship (``requires_graph``: the flagship's
    config at full width and depth, 384 px, 3 context frames, with the
    graph of :data:`GRAPH`) through the two-dispatch server: per
    observation the host Processor builds the sample and its point-cloud
    graph, then the forward and the decode run on the card. bf16 at batch
    1 and ``predict_batch`` of :data:`GRAPH_POOL`, exactly :data:`INFER`
    flash launches per observation (``pad_to`` adds none); the host's graph
    build timed alone; in f32, the graph server's actions equal to the
    one-dispatch server's on the same weights and observations. Returns
    (the bf16 runs' launches, its line)."""
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.models import build_model
    from bifold_tpu_torch.serving import ServingModel

    t0 = time.perf_counter()
    m_w2c, k = graph_camera()
    cfg = {**FLAGSHIP, "requires_graph": True}

    def processor(graph):
        return Processor({**PROCESSOR, "requires_graph": graph}, max_context_length=3,
                         autoprocessor_name=FLAGSHIP["automodel_name"],
                         spm_asset=fixture_model_bytes(), **(GRAPH if graph else {}))

    rng = np.random.default_rng(43)
    obs = [dict(graph_observation(rng, n_ctx=i % 4), instruction=INSTRUCTIONS[i % 5],
                matrix_world_to_camera=m_w2c, K=k) for i in range(GRAPH_POOL)]
    proc = processor(True)
    build_ms = []
    for o in obs[:3]:
        t = time.perf_counter()
        sample = proc(**o)
        build_ms.append((time.perf_counter() - t) * 1e3)
    nodes = int(sample["graph_node_mask"].sum())
    edges = int(sample["graph_edge_mask"].sum())
    live = ServingModel(build_model(cfg, dtype=torch.bfloat16, device=device, seed=0),
                        None, proc, device=device)
    live.predict(**obs[0])                     # warm
    clear_launch_counts()                      # the graph server's run starts here
    one = counted(lambda: live.predict(**obs[0], return_raw_output=True), "", INFER,
                  "graph request")
    check_action(*one, 1, FLAGSHIP["image_size"])
    t = time.perf_counter()
    pooled = counted(lambda: live.predict_batch(obs, pad_to=16, return_raw_output=True), "",
                     {k2: n * GRAPH_POOL for k2, n in INFER.items()}, "graph pool")
    pool_ms = (time.perf_counter() - t) * 1e3
    check_action(*pooled, GRAPH_POOL, FLAGSHIP["image_size"])
    launches = launch_counts()                 # ... and ends here
    t = time.perf_counter()
    live.predict(**obs[0])
    batch1_ms = (time.perf_counter() - t) * 1e3
    del live
    # f32: the two-dispatch path decodes what the one-dispatch path does
    model = build_model(cfg, dtype=torch.float32, device=device, seed=0)
    graph = ServingModel(model, None, proc, device=device)
    plain = ServingModel(model, None, processor(False), device=device)
    del model
    apart, heat = {}, 0.0
    for name, batch in (("batch_1", obs[:1]), ("pool", obs)):
        (ga, gr), (pa, pr) = (srv.predict_batch(batch, return_raw_output=True)
                              for srv in (graph, plain))
        heat = max([heat] + [float(np.abs(gr[k2] - pr[k2]).max()) for k2 in gr
                             if k2.endswith("_heatmap")])
        apart[name] = [f for f in ACTION_FIELDS
                       if not np.array_equal(getattr(ga, f), getattr(pa, f))]
    del graph, plain
    line = {"nodes": nodes, "edges": edges, **GRAPH, "graph_build_ms": build_ms,
            "launches_per_observation": INFER, "pool": GRAPH_POOL,
            "bf16_batch1_ms": batch1_ms, "bf16_pool_ms": pool_ms,
            "f32_fields_apart_from_one_dispatch": apart,
            "f32_max_heatmap_diff_vs_one_dispatch": heat,
            "seconds": time.perf_counter() - t0}
    if any(apart.values()) or not nodes or not edges:
        raise AssertionError(f"refused_configs: the graph server failed ({line})")
    return launches, line


def refused_int8(card, device="cuda"):
    """The bf16 flagship served int8 at ``quantize_min_size``
    :data:`GRAPH_INT8_MIN_SIZE`, where the stacks' biases and LayerNorm
    parameters are int8 against one scale per stack (JAX's (1, n) scale
    leaves): a request with exactly :data:`INFER` launches, its actions
    equal to the math path's on the same dequantized weights or its
    heatmaps within :data:`BF16_MATH_TOL`; the count of those one-dim
    int8 tensors and of their stacks' shared scales, the weight bytes
    beside the default (2**16) int8 server's. Returns (launches, line)."""
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.models import build_model
    from bifold_tpu_torch.serving import (QUANT_TAG, ServingModel, _served_weights,
                                          shared_scales)

    t0 = time.perf_counter()
    model = build_model(FLAGSHIP, dtype=torch.bfloat16, device=device, seed=0)
    proc = Processor(PROCESSOR, max_context_length=3,
                     autoprocessor_name=FLAGSHIP["automodel_name"],
                     spm_asset=fixture_model_bytes())

    def weight_bytes(server):
        """Bytes of the served weights, each storage once (a stack's layers
        share one scale)."""
        storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                    for v in _served_weights(server.model).values()
                    for t in ((v[QUANT_TAG], v["scale"]) if isinstance(v, dict) else (v,))}
        return sum(storages.values())

    default = ServingModel(model, None, proc, quantize="int8", device=device)
    default_bytes = weight_bytes(default)
    del default
    server = ServingModel(model, None, proc, quantize="int8",
                          quantize_min_size=GRAPH_INT8_MIN_SIZE, device=device)
    del model
    shared = shared_scales(_served_weights(server.model))
    rng = np.random.default_rng(47)
    obs, text = observation(rng, n_ctx=3), INSTRUCTIONS[1]
    server.predict(**obs, instruction=text)           # warm
    clear_launch_counts()                              # the int8 request starts here
    k_action, k_raw = counted(lambda: server.predict(**obs, instruction=text,
                                                     return_raw_output=True), "", INFER,
                              "int8 request at min_size 1024")
    launches = launch_counts()                         # ... and ends here
    check_action(k_action, k_raw, 1, FLAGSHIP["image_size"])
    m_action, m_raw = math_forward(server, obs, text)
    hm_diff = max(float(np.abs(k_raw[k] - m_raw[k]).max()) for k in k_raw
                  if k.endswith("_heatmap"))
    same = all(np.array_equal(getattr(k_action, f), getattr(m_action, f))
               for f in ACTION_FIELDS)
    line = {"quantize_min_size": GRAPH_INT8_MIN_SIZE, "one_dim_int8_tensors": len(shared),
            "shared_scales": len(set(shared.values())),
            "weight_bytes": weight_bytes(server), "weight_bytes_min_size_65536": default_bytes,
            "kernel_vs_math_max_heatmap_diff": hm_diff, "tol": BF16_MATH_TOL,
            "actions_identical": same,
            "decoded_apart": decoded_apart(k_action, m_action, k_raw),
            "seconds": time.perf_counter() - t0}
    if not shared or not (same or hm_diff <= BF16_MATH_TOL):
        raise AssertionError(f"refused_configs: int8 at min_size 1024 failed ({line})")
    return launches, line


def refused_configs(card, device="cuda"):
    """The on-card paths of the configurations the port once refused
    (:func:`refused_rgb_clip` for each of :data:`REFUSED_RGB`,
    :func:`refused_graph`, :func:`refused_int8`), in one line. Returns
    their launches."""
    t0 = time.perf_counter()
    launches, lines = collections.Counter(), {}
    for variant in REFUSED_RGB:
        got, lines[f"rgb_clip_{variant}"] = refused_rgb_clip(card, variant, device)
        launches.update(got)
    for name, phase in (("graph", refused_graph), ("int8_min_size_1024", refused_int8)):
        got, lines[name] = phase(card, device)
        launches.update(got)
    emit({"phase": "refused_configs", **lines, "launches": dict(launches),
          "seconds": time.perf_counter() - t0, **card})
    return dict(launches)


# the T5 branch of text_unet: the two encoders a user names (the relu
# T5-base and the gated-GELU Flan-T5-base), with text_unet's composed
# config around them
T5_ENCODERS = ("t5-base", "google/flan-t5-base")
T5_GRAFT = "t5-base"                     # the checkpoint dir the Trainer grafts
T5_GRAFT_SEED = 5


def t5_checkpoint_dir(path, name, device="cuda"):
    """A Hugging Face T5 checkpoint dir for the registry config ``name``
    (``config.json`` and ``model.safetensors``, the latter written by the
    port's own writer, with HF's tied layout: ``shared.weight`` only) from
    a T5 encoder seeded with :data:`T5_GRAFT_SEED`. Returns the written
    tensors (on the CPU)."""
    import dataclasses

    from bifold_tpu_torch.models import init_weights
    from bifold_tpu_torch.models.backbones.t5_backbone import T5_CONFIGS, T5Encoder
    from bifold_tpu_torch.utils.safetensors import save_file

    cfg = T5_CONFIGS[name]
    with torch.device(device):
        enc = T5Encoder(cfg)
    init_weights(enc, torch.Generator(device).manual_seed(T5_GRAFT_SEED))
    written = {k: v.detach().cpu() for k, v in enc.state_dict().items()
               if k != "encoder.embed_tokens.weight"}
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps({"model_type": "t5",
                                                  **dataclasses.asdict(cfg)}))
    save_file(written, path / "model.safetensors", {"format": "pt"})
    return written


def t5_family(card, device="cuda"):
    """``text_unet`` with a T5 text encoder (:data:`T5_ENCODERS`) as a user
    runs it, at full width with seeded weights, bf16: served behind
    ``ServingModel`` at a 720 px camera (3 requests and a pool of 8 in each
    LayerNorm mode, then 11 requests and a pool of 8 for the p50s) and
    trained through ``main`` (16 synthetic bimanual samples at 384 px,
    batch 2, one epoch of 8 steps, pixel eval, best/last; the Trainer's
    step p50 and the run's peak memory above what the process held before
    it). Gates: T5 runs its attention
    inline (77 tokens, under the flash threshold) and RMS norms, and the
    UNet BatchNorms, so every request, train step and eval batch launches
    no flash and no LayerNorm kernel, and the phase's counts stay 0; exit
    0, 8 steps, finite metrics. Then a T5-base checkpoint dir written with
    the port's safetensors writer (:func:`t5_checkpoint_dir`) is grafted by
    the Trainer: its encoder's weights are the written ones, bitwise, and
    its output on a batch of ids equals the written weights' own forward,
    bitwise. Returns the serving phases for :func:`where_the_time_goes` and
    (name, trainer, p50) for :func:`trainer_profile`. ``device="cpu"``: a
    rehearsal (the caller swaps the configs for tiny ones)."""
    import shutil
    import tempfile

    from bifold_tpu_torch.config import Config, load_yaml
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.models import build_model
    from bifold_tpu_torch.models.backbones.t5_backbone import T5Encoder, resolve_t5_config
    from bifold_tpu_torch.serving import ServingModel
    from bifold_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_t5_"))
    cpu = ["use_cpu=true"] if device == "cpu" else []
    phases, trainers, ok = [], [], True
    clear_launch_counts()                # the T5 paths start here
    for enc in T5_ENCODERS:
        label = f"text_unet {enc}"
        cfg = family_config("text_unet", f"model.text_encoder={enc}")
        mcfg = dict(cfg["model"])
        size = int(mcfg["image_size"])
        model = build_model(mcfg, dtype=torch.bfloat16, device=device, seed=0)
        seeded_stats(model)
        live = ServingModel(model, None, Processor(dict(cfg["processor"]), partition="test"),
                            device=device)
        live.warmup(CAMERA)
        live.warmup(CAMERA, pool=8)
        rng = np.random.default_rng(41)

        def frame():
            obs = observation(rng, 0)
            del obs["context"]
            return obs

        requests = [(frame(), INSTRUCTIONS[i % 5]) for i in range(11)]
        pool = [dict(frame(), instruction=INSTRUCTIONS[i % 5]) for i in range(8)]
        for mode in LN_MODES:
            for i, (obs, text) in enumerate(requests[:3]):
                check_action(*counted(lambda: live.predict(**obs, instruction=text,
                                                           return_raw_output=True),
                                      mode, {}, f"{label} request {i}"), 1, size)
            check_action(*counted(lambda: live.predict_batch(pool, pad_to=8,
                                                             return_raw_output=True),
                                  mode, {}, f"{label} pool"), 8, size)
        times = {"batch1": [], "pool8": []}
        for obs, text in requests:
            for name, call in (("batch1", lambda: live.predict(**obs, instruction=text)),
                               ("pool8", lambda: live.predict_batch(pool, pad_to=8))):
                t = time.perf_counter()
                call()
                times[name].append((time.perf_counter() - t) * 1e3)
        lat = {name: statistics.median(v) for name, v in times.items()}
        obs, text = requests[0]
        phases += [serving_phase(live, "", f"{label} {name}", obs_list, lat[name])
                   for name, obs_list in (("batch1", [dict(obs, instruction=text)]),
                                          ("pool8", pool))]

        record = {}
        overrides = ["model=text_unet", f"model.text_encoder={enc}", *FAMILY_DATA,
                     *FAMILY_CLI, f"run_dir={tmp / enc.replace('/', '_')}", *cpu]
        if device == "cuda":
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        code, run_dir, seconds = run_cli(overrides, record)
        peak = torch.cuda.max_memory_allocated() - base if device == "cuda" else None
        trainer = record.pop("trainers")[0]
        evals = load_yaml(run_dir / "eval_synthetic.yaml")
        logged = [json.loads(line) for line in
                  (run_dir / "metrics.jsonl").read_text().splitlines()]
        step_s = [r["train/step_time_s"] for r in logged if "train/step_time_s" in r]
        p50 = statistics.median(step_s) * 1e3 if step_s else None
        bad = [d for d in record.get("steps", []) + record.get("evals", []) if d]
        finite = evals.get("kp_mse") is not None and all(
            v is None or np.isfinite(v) for v in evals.values())
        line = {"phase": f"t5_family_{enc}", "parameters": sum(
                    p.numel() for p in model.parameters()),
                "text_encoder_parameters": sum(p.numel() for p in
                                               model.text_encoder.parameters()),
                "p50_ms_batch1": lat["batch1"], "p50_ms_pool8": lat["pool8"],
                "trainer_exit_code": code, "trainer_seconds": seconds,
                "steps": len(record.get("steps", [])),
                "eval_batches": len(record.get("evals", [])),
                "steps_or_evals_with_launches": bad, "eval": evals,
                "trainer_step_p50_ms": p50,
                "trainer_samples_per_s": [r["train/samples_per_sec"] for r in logged
                                          if "train/samples_per_sec" in r],
                "trainer_peak_bytes_above_start": peak, **card}
        emit(line)
        ok &= (code == 0 and not bad and finite and line["steps"] == 8
               and line["eval_batches"] > 0)
        trainers.append((enc, trainer, p50))
        del live, model

    # a checkpoint dir the port writes, grafted by the Trainer
    t5_dir = tmp / "t5-ckpt"
    written = t5_checkpoint_dir(t5_dir, T5_GRAFT, device)
    cfg = family_config("text_unet", f"model.text_encoder={t5_dir}", *FAMILY_CLI,
                        f"run_dir={tmp / 'graft'}", *cpu)
    grafted = Trainer(Config(cfg), run_dir=tmp / "graft").model.text_encoder.eval()
    got = grafted.state_dict()
    same_weights = all(torch.equal(got[k].cpu(), v) for k, v in written.items()) \
        and torch.equal(got["encoder.embed_tokens.weight"].cpu(), written["shared.weight"])
    with torch.device(device):
        reference = T5Encoder(resolve_t5_config(str(t5_dir)), grafted.dtype)
    reference.load_state_dict({**written, "encoder.embed_tokens.weight":
                               written["shared.weight"]}, strict=True)
    reference.eval()
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, reference.cfg.vocab_size, (2, 77))).to(device)
    with torch.no_grad():
        same_output = torch.equal(grafted(ids), reference(ids))
    launches = launch_counts()           # ... and end here: none
    emit({"phase": "t5_family_graft", "text_encoder": f"{T5_GRAFT} (written by the port)",
          "tensors": len(written), "bytes": (t5_dir / "model.safetensors").stat().st_size,
          "weights_bitwise": same_weights, "output_bitwise": same_output,
          "dtype": str(grafted.dtype), "launches": launches,
          "seconds": time.perf_counter() - t0, **card})
    del grafted, reference
    shutil.rmtree(tmp, ignore_errors=True)
    if not (ok and same_weights and same_output) or launches:
        raise AssertionError("t5_family failed (see its lines)")
    return phases, trainers


# the closed loop: the simulator on the host, the policy on the card
LOOP_POOL = 8                            # eval_parallel_envs: envs stepped in lockstep
BIMANUAL_SAMPLES = 16                    # two pooled calls of 8
UNIMANUAL_FAMILY = ("model=rgb_clip", "train_dataset=synthetic",
                    "train_dataset.image_size=224", "train_dataset.is_bimanual=false",
                    "train_dataset.max_context_length=3", "train_dataset.n_samples=2",
                    "test_dataset=null", "batch_size=2", "test_batch_size=2")
SOFTGYM_CLI = ("train_dataset=synthetic", "train_dataset.image_size=224",
               "train_dataset.is_bimanual=false", "train_dataset.max_context_length=3",
               "train_dataset.n_samples=4", "test_dataset=null", "model=siglip_sequential",
               "batch_size=2", "test_batch_size=2", "epochs=1", "eval_epochs=1",
               "log_every=1", "simulator=softgym", "num_evals=1",
               f"eval_parallel_envs={LOOP_POOL}", "eval_serving_policy=true",
               "visualize_predictions=true", "visualize_model_inputs=true")
# the trainer_softgym loop's square and rectangular cloths (build_cache's
# are 28-52 particles a side; closed_loop_unimanual runs those)
SOFTGYM_CLI_CLOTHS = {"Square": (16, 16), "Rectangular": (14, 20)}
URL_TASK = "TshirtFold"
# the unimanual flagship's train step at 224 px: the fusion's flash
# launches only (196 vision tokens < 256: its towers take the math path,
# as in JAX)
SOFTGYM_STEP = {"fwd_lse_d48": 8, "bwd_d48": 8}
# closed_loop_unimanual's simulator: the cheap env of the CPU tests
# (tests/test_parallel_eval.py); at the evaluator's defaults (4 substeps,
# 12 iterations) its 16525 steps took 166 s of host time on the host of an
# H100 80GB HBM3 (700.00 W), beside trainer_softgym
UNIMANUAL_SIM = {"substeps": 2, "iterations": 6}


class TimedPolicy:
    """A closed-loop policy wrapped to time each call (its actions come back
    to the host, so a call ends when the card is done with it), count its
    rows and keep its actions."""

    def __init__(self, policy, wants_raw):
        self.policy, self.wants_raw = policy, wants_raw
        self.ms, self.rows, self.actions = [], [], []

    def __call__(self, obs, pad_to=None):
        t = time.perf_counter()
        action, raw = (self.policy(obs, pad_to=pad_to) if pad_to is not None
                       else self.policy(obs))
        self.ms.append((time.perf_counter() - t) * 1e3)
        fields = {k: np.asarray(v).copy() for k, v in action.fields()}
        self.rows.append(len(next(iter(fields.values()))))
        self.actions.append(fields)
        return action, raw


def timed_envs(evaluator):
    """Count the host seconds of the evaluator's simulator steps and of its
    renders (720 px render + resize to the model's size)."""
    spent = {"sim_step_s": 0.0, "render_resize_s": 0.0, "sim_steps": 0, "renders": 0}

    def wrap(obj, name, key, count):
        real = getattr(obj, name)

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t
                spent[count] += 1

        setattr(obj, name, timed)

    for env in getattr(evaluator, "envs", [evaluator.env]):
        wrap(env.sim, "step", "sim_step_s", "sim_steps")
        wrap(env, "render_image", "render_resize_s", "renders")
    return spent


def loop_summary_ok(summary, keys) -> bool:
    return all(k in summary and np.isfinite(summary[k]) for k in keys)


def bimanual_replay_cache(root, n_samples):
    """A replay cache keyed by frame names, built from the port's
    ``build_cache`` Tshirt garments (2 configs, 10 settle steps): left/right
    pick the sleeves, place the hems, each frame after the first with the
    two frames before as context (tests/test_parallel_eval.py builds its
    cache so)."""
    import pickle

    from bifold_tpu_torch.env.cache_builder import build_cache

    root.mkdir(parents=True, exist_ok=True)
    with open(build_cache("Tshirt", root, n_configs=2, settle_steps=10), "rb") as f:
        data = pickle.load(f)
    names = [f"{i:04d}_Tshirt_f{i}" for i in range(1, n_samples + 1)]
    configs, states, kps = {}, {}, {}
    for i, name in enumerate(names):
        j = i % 2
        kp = data["keypoints"][j]
        configs[name], states[name] = data["configs"][j], data["states"][j]
        kps[name] = {"left_pick_idx": kp[2], "left_place_idx": kp[6],
                     "right_pick_idx": kp[5], "right_place_idx": kp[7]}
    with open(root / "bimanual.pkl", "wb") as f:
        pickle.dump({"configs": configs, "states": states, "keypoints": kps}, f)
    context = [names[0]] + [f"{names[i - 2]}+{names[i - 1]}" if i > 1 else names[0]
                            for i in range(1, n_samples)]
    return {"frame_start": names,
            "raw_instruction": [INSTRUCTIONS[i % len(INSTRUCTIONS)] for i in range(n_samples)],
            "context": context}


def bimanual_loop(server, cache, samples, pool, size):
    """One run of the bimanual replay through ``ServingPolicy(server)``:
    the parallel evaluator over a pool of ``pool`` (the sequential one for
    ``pool`` None). Returns (summary, policy, host seconds, loop seconds)."""
    from bifold_tpu_torch.env.bimanual_evaluator import (
        SoftgymBimanualEvaluator, SoftgymBimanualParallelEvaluator)
    from bifold_tpu_torch.serving import ServingPolicy

    policy = TimedPolicy(ServingPolicy(server), wants_raw=True)
    if pool:
        ev = SoftgymBimanualParallelEvaluator(cache_dir=str(cache), policy=policy,
                                              processor=server.processor,
                                              image_size=size, pool=pool)
    else:
        ev = SoftgymBimanualEvaluator(cache_dir=str(cache), policy=policy,
                                      processor=server.processor, image_size=size)
    spent = timed_envs(ev)
    t = time.perf_counter()
    ev.evaluate(samples=samples)
    seconds = time.perf_counter() - t
    summary = ev.summary()
    recorded = sum(len(v) for v in ev.success.values())
    ev.close()
    return summary, policy, spent, seconds, recorded


def closed_loop_bimanual(card, device="cuda"):
    """The closed loop on the full-width bf16 flagship (384 px, bimanual, 3
    context frames, 12-layer SigLIP-base towers, depth-8 fusion, seeded
    weights): :data:`BIMANUAL_SAMPLES` replay samples of a cache the port's
    ``build_cache`` makes (:func:`bimanual_replay_cache`) through
    ``SoftgymBimanualParallelEvaluator(pool=8)`` and ``ServingPolicy`` (the
    simulator at its defaults, 720 px renders resized to 384): two pooled
    calls. Gates: exactly 8 ``fwd_infer_d48`` and 12 ``fwd_infer_d64`` per
    call and no other launch; every sample recorded, every metric finite;
    a second run's summary equal to the first's; the same samples through
    the sequential ``SoftgymBimanualEvaluator`` under
    ``BIFOLD_LN_KERNEL=pallas`` (batch 1: 66 ``ln_fwd`` per call besides
    the flash launches); in f32 the pooled loop through the kernels and
    through the plain versions (``BIFOLD_ATTN_BACKEND=math``) decode the
    same action at every step and give equal summaries. Prints the policy
    call's p50 at the pool of 8 (default mode) and at batch 1 (pallas), the
    simulator's host seconds per sample (steps, renders and resizes) and
    actions per second of the loop. Returns the launches and a closure that
    profiles one pooled loop for the card's busy share (run it after every
    host-clock measurement)."""
    import shutil
    import tempfile

    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.models import build_model
    from bifold_tpu_torch.serving import ServingModel

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_closed_loop_"))
    samples = bimanual_replay_cache(tmp / "cache", BIMANUAL_SAMPLES)
    size = FLAGSHIP["image_size"]
    proc = Processor(PROCESSOR, max_context_length=3,
                     autoprocessor_name=FLAGSHIP["automodel_name"],
                     spm_asset=fixture_model_bytes())

    def server_of(dtype):
        return ServingModel(build_model(FLAGSHIP, dtype=dtype, device=device, seed=0),
                            None, proc, device=device, depth_wire_dtype="float16")

    server = server_of(torch.bfloat16)
    server.warmup(720, pool=LOOP_POOL)
    server.warmup(720)
    keys = ["Tshirt", "error Tshirt", "iou Tshirt", "average_success"]

    clear_launch_counts()                # the main path's run starts here
    first, policy, spent, loop_s, recorded = bimanual_loop(server, tmp / "cache", samples,
                                                           LOOP_POOL, size)
    launches = launch_counts()           # ... and ends here
    calls = len(policy.ms)
    want = {"fwd_infer_d48": 8 * calls, "fwd_infer_d64": 12 * calls}
    second, policy2, _, loop2_s, _ = bimanual_loop(server, tmp / "cache", samples,
                                                   LOOP_POOL, size)
    clear_launch_counts()
    with ln_mode("pallas"):
        seq, seq_policy, _, seq_s, seq_recorded = bimanual_loop(server, tmp / "cache",
                                                                samples, None, size)
    seq_launches = launch_counts()
    per_call = {"fwd_infer_d48": 8, "fwd_infer_d64": 12,
                **ln_launches(server.model, "pallas", train=False)}
    seq_want = {k: n * len(seq_policy.ms) for k, n in per_call.items()}

    # f32: the kernels against their plain versions over the whole loop
    f32 = server_of(torch.float32)
    clear_launch_counts()
    f32_kernel, f32_policy, _, _, _ = bimanual_loop(f32, tmp / "cache", samples,
                                                    LOOP_POOL, size)
    f32_launches = launch_counts()
    os.environ["BIFOLD_ATTN_BACKEND"] = "math"
    try:
        f32_plain, plain_policy, _, _, _ = bimanual_loop(f32, tmp / "cache", samples,
                                                         LOOP_POOL, size)
    finally:
        del os.environ["BIFOLD_ATTN_BACKEND"]
    f32_same_actions = (len(f32_policy.actions) == len(plain_policy.actions) and all(
        a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        for a, b in zip(f32_policy.actions, plain_policy.actions)))
    del f32

    host_s = loop_s - sum(policy.ms) / 1e3
    emit({"phase": "closed_loop_bimanual", "samples": BIMANUAL_SAMPLES, "pool": LOOP_POOL,
          "policy_calls": calls, "rows_per_call": policy.rows,
          "launches": launches, "launches_want": want,
          "summary": first, "second_run_equal": second == first, "recorded": recorded,
          "sequential_pallas": {"calls": len(seq_policy.ms), "launches": seq_launches,
                                "launches_want": seq_want, "recorded": seq_recorded,
                                "summary": seq, "loop_s": seq_s},
          "f32_kernel_vs_plain": {"same_actions_every_step": f32_same_actions,
                                  "summaries_equal": f32_kernel == f32_plain,
                                  "calls": len(f32_policy.ms), "launches": f32_launches,
                                  "summary": f32_kernel},
          "policy_p50_ms_pool8": statistics.median(policy.ms + policy2.ms),
          "policy_p50_ms_batch1_pallas": statistics.median(seq_policy.ms),
          "loop_s": loop_s, "loop2_s": loop2_s, "policy_s": sum(policy.ms) / 1e3,
          "host_s": host_s, "host_s_per_sample": host_s / BIMANUAL_SAMPLES,
          **{k: v for k, v in spent.items()},
          "sim_host_s_per_sample": (spent["sim_step_s"] + spent["render_resize_s"])
          / BIMANUAL_SAMPLES,
          "actions_per_s": recorded / loop_s,
          "phase_seconds": time.perf_counter() - t0, **card})
    if (device == "cuda" and (launches != want or seq_launches != seq_want
                              or f32_launches != {f"{k}_f32": n for k, n in want.items()})):
        raise AssertionError("closed_loop_bimanual: launches (see its line)")
    if (calls != 2 or policy.rows != [LOOP_POOL, LOOP_POOL] or second != first
            or recorded != BIMANUAL_SAMPLES or seq_recorded != BIMANUAL_SAMPLES
            or not loop_summary_ok(first, keys) or not loop_summary_ok(seq, keys)
            or not f32_same_actions or f32_kernel != f32_plain):
        raise AssertionError("closed_loop_bimanual failed (see its line)")

    def profile():
        """torch.profiler over one pooled loop: the card's busy share of the
        loop's unprofiled wall time."""
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, _, profiled_s, _ = bimanual_loop(server, tmp / "cache", samples,
                                                   LOOP_POOL, size)
        busy_ms = sum(getattr(e, "self_device_time_total", 0) or 0
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        emit({"phase": "closed_loop_device_profile", "loop": "bimanual pool 8",
              "device_busy_ms": busy_ms, "loop_s": loop_s, "profiled_loop_s": profiled_s,
              "device_busy_share": busy_ms / 1e3 / loop_s,
              "device_idle_share": 1 - busy_ms / 1e3 / loop_s, **card})
        shutil.rmtree(tmp, ignore_errors=True)
        if busy_ms <= 0:
            raise AssertionError("the profiler saw no device time in the loop")

    return dict(collections.Counter(launches) + collections.Counter(seq_launches)
                + collections.Counter(f32_launches)), profile


def unimanual_caches(root):
    """One config per cloth type from the port's ``build_cache`` (seed 0,
    its defaults)."""
    from bifold_tpu_torch.env.cache_builder import CLOTH_TYPES, build_cache

    for cloth_type in CLOTH_TYPES:
        build_cache(cloth_type, root, n_configs=1)
    return root


def closed_loop_unimanual(card, device="cuda"):
    """``rgb_clip`` (frozen CLIP ViT-B/16 towers at 224 px, a depth-8 fusion
    of 16 heads of 32, bf16, seeded weights, unimanual, 3 context frames)
    through the Trainer's ``get_action`` route (host-processed samples,
    ``wants_raw`` false) in ``SoftgymParallelEvaluator(pool=8)``: all 5 tasks
    x ``num_evals=1`` x 3 regimes on caches the port's ``build_cache`` makes
    (one config per cloth type), the simulator at :data:`UNIMANUAL_SIM`. Gates:
    exactly 8 ``fwd_infer_d32`` per policy call and no other launch; every
    task and regime recorded with finite metrics. Returns the launches."""
    import random
    import shutil
    import tempfile

    from bifold_tpu_torch.config import Config
    from bifold_tpu_torch.env.cloth_env import ClothEnv
    from bifold_tpu_torch.env.softgym_evaluator import TASKS, SoftgymParallelEvaluator
    from bifold_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_unimanual_"))
    unimanual_caches(tmp / "cache")
    cfg = family_config("rgb_clip", *UNIMANUAL_FAMILY[1:], f"run_dir={tmp / 'run'}",
                        *(["use_cpu=true"] if device == "cpu" else []))
    trainer = Trainer(Config(cfg), run_dir=tmp / "run")
    policy = TimedPolicy(lambda batch: trainer.get_action(batch, return_raw_output=True),
                         wants_raw=False)
    size = int(dict(cfg["model"])["image_size"])
    ev = SoftgymParallelEvaluator(cache_dir=str(tmp / "cache"), policy=policy,
                                  processor=trainer.processor, image_size=size,
                                  pool=LOOP_POOL)
    ev.envs = [ClothEnv(render_dim=size, **UNIMANUAL_SIM) for _ in range(LOOP_POOL)]
    ev.env = ev.envs[0]
    spent = timed_envs(ev)
    random.seed(0)
    clear_launch_counts()                # the main path's run starts here
    t = time.perf_counter()
    per_task = {}
    for task in TASKS:
        ts = time.perf_counter()
        ev.evaluate(num_evals=1, task=task, seed=0)
        per_task[task] = time.perf_counter() - ts
    loop_s = time.perf_counter() - t
    launches = launch_counts()           # ... and ends here
    summary = ev.summary()
    steps = sum(len(v) for regimes in ev.success.values() for v in regimes.values())
    ev.close()
    calls = len(policy.ms)
    want = {"fwd_infer_d32": 8 * calls}
    keys = [f"{k}{task} {regime}" for task in TASKS for regime in ("si", "usi", "ut")
            for k in ("", "error ", "iou ")] + ["average_success"]
    host_s = loop_s - sum(policy.ms) / 1e3
    emit({"phase": "closed_loop_unimanual", "family": "rgb_clip",
          "image_size": int(dict(cfg["model"])["image_size"]),
          "tasks": TASKS, "num_evals": 1, "pool": LOOP_POOL, "sim": UNIMANUAL_SIM,
          "policy_calls": calls,
          "rows_per_call": policy.rows, "launches": launches, "launches_want": want,
          "summary": summary, "policy_p50_ms": statistics.median(policy.ms),
          "loop_s": loop_s, "task_s": per_task, "policy_s": sum(policy.ms) / 1e3,
          "host_s": host_s, **spent, "action_steps": steps,
          "host_s_per_action_step": host_s / steps, "actions_per_s": steps / loop_s,
          "phase_seconds": time.perf_counter() - t0, **card})
    if device == "cuda" and launches != want:
        raise AssertionError("closed_loop_unimanual: launches (see its line)")
    if not calls or not loop_summary_ok(summary, keys):
        raise AssertionError("closed_loop_unimanual failed (see its line)")
    del trainer
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


def small_softgym_caches(root):
    """build_cache's garments and its square and rectangular layout at
    :data:`SOFTGYM_CLI_CLOTHS` particles a side (one config each)."""
    import pickle

    from bifold_tpu_torch.env.cache_builder import build_cache
    from bifold_tpu_torch.env.cloth_env import ClothEnv, square_cloth_config

    root.mkdir(parents=True, exist_ok=True)
    for cloth_type in ("Tshirt", "Trousers"):
        build_cache(cloth_type, root, n_configs=1)
    env = ClothEnv(render_dim=224)
    for cloth_type, dims in SOFTGYM_CLI_CLOTHS.items():
        config = square_cloth_config(*dims)
        env.reset(config)
        pos = env.sim.get_positions()[:, :3]
        extent = pos.max(axis=0) - pos.min(axis=0)
        state = env.get_state()
        state["max_area"] = float(extent[0] * extent[2])
        with open(root / f"{cloth_type}.pkl", "wb") as f:
            pickle.dump({"configs": [config], "states": [state]}, f)
    return root


def trainer_softgym(card, device="cuda"):
    """``python -m bifold_tpu_torch`` in this process with the closed loop as
    its final eval: the unimanual bf16 flagship (siglip_sequential at 224
    px, 3 context frames) trains 2 steps on synthetic data under
    ``BIFOLD_LN_KERNEL=pallas`` (:data:`SOFTGYM_CLI`: ``simulator=softgym``,
    ``num_evals=1``, a pool of 8, ``eval_serving_policy``, both
    ``visualize_*`` keys; the cache of :func:`small_softgym_caches`). Gates:
    exit code 0; ``eval_synthetic.yaml`` holds every closed-loop key
    (``average_success``, ``<task> <regime>``, ``error ...``, ``iou ...``),
    finite; PNGs under ``eval/softgym/<task>/`` for every task, under
    ``eval_viz/`` and ``input_viz/``; the steps' launches those of the
    pallas train step. Then one task (:data:`URL_TASK`) through
    ``RemotePolicy`` against the port's daemon on 127.0.0.1 serving the
    trained model records the summary the in-process server recorded.
    Returns the launches of the run."""
    import shutil
    import tempfile
    import threading

    from bifold_tpu_torch.config import load_yaml
    from bifold_tpu_torch.env.softgym_evaluator import TASKS, SoftgymParallelEvaluator
    from bifold_tpu_torch.serve import RemotePolicy, make_httpd

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_softgym_cli_"))
    small_softgym_caches(tmp / "cache")
    overrides = list(SOFTGYM_CLI) + [f"softgym_cache={tmp / 'cache'}", f"run_dir={tmp}"] + (
        ["use_cpu=true"] if device == "cpu" else [])
    record = {}
    with ln_mode("pallas"):
        clear_launch_counts()            # the main path's run starts here
        code, run_dir, seconds = run_cli(overrides, record)
        launches = launch_counts()       # ... and ends here
    trainer = record["trainers"][-1]
    evals = load_yaml(run_dir / "eval_synthetic.yaml") if (
        run_dir / "eval_synthetic.yaml").exists() else {}
    keys = [f"{k}{task} {regime}" for task in TASKS for regime in ("si", "usi", "ut")
            for k in ("", "error ", "iou ")] + ["average_success"]
    pngs = {task: len(list((run_dir / "eval" / "softgym" / task).rglob("*.png")))
            for task in TASKS}
    viz = {d: len(list((run_dir / d).rglob("*.png"))) for d in ("eval_viz", "input_viz")}
    step = {**SOFTGYM_STEP, **ln_launches(trainer.model, "pallas", train=True)}
    bad_steps = [d for d in record.get("steps", []) if d != step]

    # one task against the daemon serving the trained model
    server = trainer.serving_model(depth_wire_dtype="float16")
    httpd = make_httpd(server)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        policy = RemotePolicy(f"http://127.0.0.1:{httpd.server_address[1]}")
        ev = SoftgymParallelEvaluator(cache_dir=str(tmp / "cache"), policy=policy,
                                      processor=trainer.processor,
                                      image_size=int(dict(trainer.cfg["model"])["image_size"]),
                                      pool=LOOP_POOL)
        with ln_mode("pallas"):
            t = time.perf_counter()
            ev.evaluate(num_evals=1, task=URL_TASK, seed=int(trainer.cfg["seed"]))
            url_s = time.perf_counter() - t
        remote = ev.summary()
        ev.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
    in_process = {k: v for k, v in evals.items()
                  if k != "average_success" and URL_TASK in k}
    remote_task = {k: v for k, v in remote.items() if k != "average_success"}
    emit({"phase": "trainer_softgym", "exit_code": code, "seconds": seconds,
          "steps": len(record.get("steps", [])), "launches_per_step": step,
          "steps_with_other_launches": bad_steps, "eval": evals,
          "missing_keys": [k for k in keys if k not in evals],
          "softgym_pngs": pngs, "viz_pngs": viz, "launches": launches,
          "url_task": URL_TASK, "url_summary": remote_task, "url_s": url_s,
          "url_equal_in_process": remote_task == in_process,
          "phase_seconds": time.perf_counter() - t0, **card})
    if (code != 0 or not loop_summary_ok(evals, keys) or not all(pngs.values())
            or not all(viz.values()) or len(record.get("steps", [])) != 2
            or (device == "cuda" and bad_steps) or remote_task != in_process):
        raise AssertionError("trainer_softgym failed (see its line)")
    del record["trainers"], trainer, server
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


def softgym_cli_worker(out, card_json, device="cuda"):
    """``python3 chip_smoke.py softgym-cli OUT CARD_JSON [DEVICE]``:
    :func:`trainer_softgym` in this process (its line printed here); writes
    its launches to the JSON file ``OUT``."""
    Path(out).write_text(json.dumps(trainer_softgym(json.loads(card_json), device)))
    return 0


def start_worker(card, out, worker, device="cuda"):
    """One of :data:`WORKERS` (``softgym-cli`` runs :func:`trainer_softgym`,
    ``host-tools`` :func:`host_tools_and_gif`) in a process of its own,
    started now, so that its host work runs beside another phase's;
    :func:`finish_worker` waits for it."""
    script = str(Path(__file__).resolve())
    return subprocess.Popen([sys.executable, script, worker, str(out),
                             json.dumps(card), device], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=str(Path(script).parent))


def finish_worker(proc, out, label, timeout=900):
    """Wait for :func:`start_worker`'s process, print its lines, and
    return its launches; raise with its error output (as ``label``) if it
    failed."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    for line in stdout.splitlines():
        if line.startswith("{"):
            print(line, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}\n{stderr[-3000:]}")
    return json.loads(Path(out).read_text())


GIF_FPS = 30
GIF_STEPS = 2                            # instructions of the episode
PYFLEX_STEPS = 30
SCENE_STEPS = 10
# softgym_cloth.h's packed layout: ClothPos, ClothSize, stiffness (stretch,
# bend, shear), render mode, camera (pos, angle, width, height), mass,
# flip_mesh; the cloth of square_cloth_config's defaults (40 x 40)
PYFLEX_CLOTH = (-0.12, 0.05, -0.12, 40, 40, 0.9, 0.3, 0.9, 2,
                0.0, 0.8, 0.0, 0.0, -1.5707964, 0.0, 720, 720, 0.5, 0)
FLEXCOMP = """<mujoco model="cloth">
  <asset><texture name="cloth_texture" type="2d" file="cloth.png"/></asset>
  <worldbody>
    <flexcomp name="cloth" type="grid" count="9 7 1" spacing="0.05 0.05 0.05" mass="1">
      <edge equality="true" damping="0.01"/>
      <plugin plugin="mujoco.elasticity.shell">
        <config key="poisson" value="0"/><config key="thickness" value="8e-3"/>
      </plugin>
    </flexcomp>
  </worldbody>
</mujoco>
"""


def host_tools_worker(out, card_json, device="cuda"):
    """``python3 chip_smoke.py host-tools OUT CARD_JSON [DEVICE]``:
    :func:`host_tools_and_gif` in this process (its line printed here);
    writes its launches to the JSON file ``OUT``."""
    Path(out).write_text(json.dumps(host_tools_and_gif(json.loads(card_json), device)))
    return 0


def gif_delays(data: bytes) -> list:
    """The delay (hundredths of a second) of every graphic-control block of
    a GIF89a file, walking its blocks (so no byte of image data is read as
    a block)."""
    def colour_table(packed):
        return 3 << ((packed & 7) + 1) if packed & 0x80 else 0

    def sub_blocks(at):
        while data[at]:
            at += data[at] + 1
        return at + 1

    if data[:6] != b"GIF89a":
        raise ValueError("not a GIF89a file")
    at, delays = 13 + colour_table(data[10]), []
    while data[at] != 0x3B:
        if data[at] == 0x21:                       # extension
            if data[at + 1] == 0xF9:
                delays.append(int.from_bytes(data[at + 4:at + 6], "little"))
            at = sub_blocks(at + 2)
        elif data[at] == 0x2C:                     # image: descriptor, table, LZW
            at = sub_blocks(at + 10 + colour_table(data[at + 9]) + 1)
        else:
            raise ValueError(f"unknown GIF block {data[at]:#x} at byte {at}")
    return delays


def frames_covered(delay: int, fps: float = GIF_FPS) -> int:
    """How many source frames a GIF frame of ``delay`` covers under the
    rule ``write_gif`` follows (imageio's): a frame lasts 1000 / fps ms, a
    repeated frame's duration is added to the one before, and the delay is
    the sum in hundredths of a second, truncated (one to one for fps up to
    100)."""
    duration = 1000 * 1 / fps
    total, count = duration, 1
    while int(total / 10) < delay:
        total += duration
        count += 1
    if int(total / 10) != delay:
        raise ValueError(f"no count of {duration} ms frames gives a delay of {delay}")
    return count


def host_tools_and_gif(card, device="cuda"):
    """The port's last host modules beside a GIF of a policy-driven episode.
    The full-width bf16 flagship (seeded weights) serves the bimanual
    rollout evaluator through ``ServingPolicy``: ``ServingModel.predict`` at
    batch 1, :data:`GIF_STEPS` instructions, from a Tshirt state of the
    port's ``build_cache``, on ``ClothEnv(dump_visualizations=True)`` at the
    closed loop's defaults (384 px renders, 4 substeps, 12 iterations); the
    episode ends with ``render_gif``. Gates: exactly 8 ``fwd_infer_d48`` and
    12 ``fwd_infer_d64`` per call and no other launch; the GIF's graphic-
    control blocks, read back from the file, cover ``len(env.frames)``
    frames, as the writer reported; the ``pyflex_compat`` cloth scene (the
    packed softgym layout, 40 x 40) stepped on the C++ core and repeated
    bitwise; each scene of ``env/scenes.py`` at its defaults stepped and
    finite; an ``XMLModel`` edit read back. The dataset tools need pandas,
    which this host may lack: the CPU tests hold them. Returns the
    launches."""
    import shutil

    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.env import pyflex_compat as pyflex
    from bifold_tpu_torch.env import scenes
    from bifold_tpu_torch.env.bimanual_evaluator import SoftgymBimanualRolloutEvaluator
    from bifold_tpu_torch.env.cloth_env import ClothEnv
    from bifold_tpu_torch.env.sim import ClothSim
    from bifold_tpu_torch.env.xml_model import XMLModel
    from bifold_tpu_torch.models import build_model
    from bifold_tpu_torch.serving import ServingModel, ServingPolicy

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_gif_"))
    name = bimanual_replay_cache(tmp / "cache", 1)["frame_start"][0]
    size = FLAGSHIP["image_size"]
    proc = Processor(PROCESSOR, max_context_length=3,
                     autoprocessor_name=FLAGSHIP["automodel_name"],
                     spm_asset=fixture_model_bytes())
    server = ServingModel(build_model(FLAGSHIP, dtype=torch.bfloat16, device=device, seed=0),
                          None, proc, device=device, depth_wire_dtype="float16")
    server.warmup(720)
    policy = TimedPolicy(ServingPolicy(server), wants_raw=True)
    ev = SoftgymBimanualRolloutEvaluator(cache_dir=str(tmp / "cache"), policy=policy,
                                         processor=proc, image_size=size)
    ev.env = ClothEnv(render_dim=size, dump_visualizations=True)
    clear_launch_counts()                # the main path's run starts here
    t = time.perf_counter()
    ev.evaluate(name, INSTRUCTIONS[:GIF_STEPS])
    episode_s = time.perf_counter() - t
    t = time.perf_counter()
    covered = ev.env.render_gif(str(tmp / "episode.gif"), fps=GIF_FPS)
    gif_s = time.perf_counter() - t
    launches = launch_counts()           # ... and ends here
    calls, policy_ms = len(policy.ms), policy.ms
    want = {"fwd_infer_d48": 8 * calls, "fwd_infer_d64": 12 * calls}
    data = (tmp / "episode.gif").read_bytes()
    delays = gif_delays(data)
    read_back = [frames_covered(d) for d in delays]
    n_frames = len(ev.env.frames)
    frame_shape = list(ev.env.frames[0].shape) if n_frames else None
    del ev, server, policy

    # the pyflex-shaped API: the packed cloth scene on the C++ core, twice
    runs = []
    for _ in range(2):
        pyflex.init(camera_width=720, camera_height=720)
        try:
            pyflex.set_scene(0, np.asarray(PYFLEX_CLOTH, np.float32))
            native = pyflex._sim._native is not None
            t = time.perf_counter()
            for _ in range(PYFLEX_STEPS):
                pyflex.step()
            runs.append((pyflex.get_positions(), pyflex.get_velocities(),
                         time.perf_counter() - t, native, pyflex.get_n_particles()))
        finally:
            pyflex.clean()
    pyflex_repeated = all(np.array_equal(a, b) for a, b in zip(runs[0][:2], runs[1][:2]))
    pyflex_moved = bool(np.isfinite(runs[0][0]).all()) and runs[0][0].reshape(-1, 4)[:, 1].mean() \
        < np.asarray(PYFLEX_CLOTH[1], np.float32)

    # every scene of env/scenes.py at its defaults
    scene_rows = {}
    for index, builder in scenes.SCENES.items():
        if not callable(builder):
            continue
        sim = ClothSim(iterations=8)
        builder(sim)
        t = time.perf_counter()
        for _ in range(SCENE_STEPS):
            sim.step()
        scene_rows[builder.__name__] = {
            "index": index, "particles": sim.get_n_particles(),
            "step_ms": (time.perf_counter() - t) / SCENE_STEPS * 1e3,
            "extended": bool(sim._uses_extended_features()),
            "finite": bool(np.isfinite(sim.get_positions()).all())}

    # XMLModel: an edit written and read back
    xml = tmp / "cloth.xml"
    xml.write_text(FLEXCOMP)
    XMLModel(str(xml)).modify_params({"mass": 2.5, "edge_damping": 0.02,
                                      "plugin_config_thickness_value": 0.01})
    reread = XMLModel(str(xml))
    xml_ok = (reread.cloth.get("mass") == "2.5" and reread.get_cloth_size() == (9, 7)
              and reread.cloth.find("edge").get("damping") == "0.02"
              and [c.get("value") for c in reread.cloth.iter("config")] == ["0", "0.01"])
    shutil.rmtree(tmp, ignore_errors=True)

    emit({"phase": "host_tools_and_gif", "instructions": GIF_STEPS, "policy_calls": calls,
          "launches": launches, "launches_want": want,
          "policy_ms": policy_ms,
          "episode_s": episode_s, "env_frames": n_frames, "frame_shape": frame_shape,
          "gif_frames": len(delays), "gif_frames_covered": sum(read_back),
          "gif_bytes": len(data), "gif_write_s": gif_s, "fps": GIF_FPS,
          "pyflex_cloth": {"particles": runs[0][4], "steps": PYFLEX_STEPS,
                           "native": runs[0][3] and runs[1][3],
                           "repeated_bitwise": pyflex_repeated, "fell": bool(pyflex_moved),
                           "step_ms": [r[2] / PYFLEX_STEPS * 1e3 for r in runs]},
          "scenes": scene_rows, "xml_model_round_trip": xml_ok,
          "phase_seconds": time.perf_counter() - t0, **card})
    if device == "cuda" and launches != want:
        raise AssertionError("host_tools_and_gif: launches (see its line)")
    if (calls != GIF_STEPS or not n_frames or read_back != covered
            or sum(read_back) != n_frames or not runs[0][3] or not runs[1][3]
            or not pyflex_repeated or not pyflex_moved or len(scene_rows) != 6
            or not all(r["finite"] for r in scene_rows.values()) or not xml_ok):
        raise AssertionError("host_tools_and_gif failed (see its line)")
    return launches


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_cli_worker(out, *overrides):
    """``python3 chip_smoke.py dp-cli OUT OVERRIDES...``: ``main`` of
    ``bifold_tpu_torch.__main__`` in this process, as ``python -m
    bifold_tpu_torch`` runs it (under ``torch.distributed.run`` it joins the
    group from the launcher's environment), its Trainer observed; writes
    the launches of each step and eval batch, the group it ran in and the
    run dir to the JSON file ``OUT``."""
    record = {}
    code, run_dir, seconds = run_cli(list(overrides), record)
    trainer = record.pop("trainers")[0]
    Path(out).write_text(json.dumps({
        "exit_code": code, "seconds": seconds, "run_dir": str(run_dir),
        "world": trainer.world, "device": str(trainer.device),
        "launcher": bool(os.environ.get("TORCHELASTIC_RUN_ID")),
        "steps": record.get("steps", []), "evals": record.get("evals", [])}))
    return code


def dp_nccl(card, device="cuda"):
    """Data parallelism through the launcher a user runs: ``python -m
    torch.distributed.run --standalone --nproc_per_node 1`` over
    :func:`dp_cli_worker` (``main``) on the flagship's CLI config with
    ``mesh.dp=-1``: a one-rank NCCL group (the card host has one card,
    and NCCL refuses two ranks on one card), whose step all-reduces the
    flat gradient buffer through NCCL. The same run without the launcher
    beside it, each in its own process. Gates: both exit 0 with 8 steps of
    exactly :data:`PER_STEP` launches and :data:`INFER` per eval batch; the
    launcher's run in a group of 1; every logged step's loss, gradient norm
    and per-head terms and every tensor of ``last.ckpt`` and ``best.ckpt``
    bitwise equal. Reports both runs' step p50 (``train/step_time_s``).
    Returns the two runs' launches."""
    import shutil
    import tempfile

    from bifold_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_dp_nccl_"))
    script = str(Path(__file__).resolve())
    overrides = list(CLI_OVERRIDES) + ["mesh.dp=-1"] + (
        ["use_cpu=true"] if device == "cpu" else [])
    runs, launches, procs = {}, collections.Counter(), {}
    for name in ("plain", "launcher"):       # both at once, each on the card
        launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node", "1"] if name == "launcher" else [sys.executable])
        cmd = launcher + [script, "dp-cli", str(tmp / f"{name}.json"), *overrides,
                          f"run_dir={tmp / name}"]
        procs[name] = (time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(Path(script).parent)))
    try:
        for name, (t, proc) in procs.items():
            _, err = proc.communicate(timeout=600)
            procs[name] = (time.perf_counter() - t, proc)
            if proc.returncode != 0:
                raise AssertionError(f"dp_nccl {name}: exit {proc.returncode}\n{err[-3000:]}")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for name, (seconds, _) in procs.items():
        run = json.loads((tmp / f"{name}.json").read_text())
        run["process_seconds"] = seconds
        logged = [json.loads(line) for line in
                  (Path(run["run_dir"]) / "metrics.jsonl").read_text().splitlines()]
        run["logged"] = [{k: v for k, v in r.items() if k not in ("time", "train/step_time_s")}
                         for r in logged if "train/loss" in r]
        run["step_ms"] = [r["train/step_time_s"] * 1e3 for r in logged
                          if "train/step_time_s" in r]
        for d in run["steps"] + run["evals"]:
            launches.update(d)
        runs[name] = run
    plain, dp = runs["plain"], runs["launcher"]
    ckpts = {}
    for which in ("last", "best"):
        a, b = (load_checkpoint(Path(r["run_dir"]) / "checkpoints" / f"{which}.ckpt")["params"]
                for r in (plain, dp))
        leaves_a, leaves_b = nested_leaves(a), nested_leaves(b)
        ckpts[which] = len(leaves_a) == len(leaves_b) and all(
            np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(leaves_a, leaves_b))
    per_step = {name: [d == PER_STEP for d in r["steps"]] for name, r in runs.items()}
    per_eval = {name: [d == INFER for d in r["evals"]] for name, r in runs.items()}
    steps_bitwise = plain["logged"] == dp["logged"] and len(dp["logged"]) == 8
    emit({"phase": "dp_nccl", "launcher": "python -m torch.distributed.run --standalone "
          "--nproc_per_node 1 (main)", "world": dp["world"], "device": dp["device"],
          "in_launcher": [plain["launcher"], dp["launcher"]],
          "steps": [len(plain["steps"]), len(dp["steps"])],
          "launches_per_step": PER_STEP, "launches_per_eval_batch": INFER,
          "steps_bitwise": steps_bitwise, "checkpoints_bitwise": ckpts,
          "step_p50_ms": {"plain": statistics.median(plain["step_ms"]),
                          "launcher": statistics.median(dp["step_ms"])},
          "step_ms": {"plain": plain["step_ms"], "launcher": dp["step_ms"]},
          "process_seconds": {k: r["process_seconds"] for k, r in runs.items()},
          "seconds": time.perf_counter() - t0, **card})
    shutil.rmtree(tmp, ignore_errors=True)
    if not (steps_bitwise and all(ckpts.values()) and dp["world"] == 1
            and dp["launcher"] and not plain["launcher"]
            and all(r["exit_code"] == 0 for r in runs.values())
            and (device == "cpu" or all(all(v) and v for v in per_step.values())
                 and all(all(v) and v for v in per_eval.values()))):
        raise AssertionError("dp_nccl failed (see its line)")
    return dict(launches)


DP_RANKS = 2
DP_SGD = {"name": "sgd", "lr": 1e-3}
DP_TOL = 1e-4                            # f32: loss, grad norm, trainable tensors
DP_STATS_TOL = 1e-5                      # f32: BatchNorm running statistics
# flash launches of one f32 step: the flagship's fusion and vision tower
# through the 3xTF32 instances; text_unet's only attention is its causal
# CLIP text tower (the math path)
DP_FAMILY_STEP = {"flagship": f32_keys(PER_STEP), "text_unet": {}}
# The multi-rank phases (their gloo ranks stage every collective through
# host memory) run the flagship at its full widths and heads, so every
# kernel instance and shape they gate is the one-process flagship's, but
# at the variants' cut depth: SigLIP towers of CUT_LAYERS layers and a
# fusion of CUT_DEPTH (the pp=2 pipes want even depths). :func:`cut_depth` rebinds
# the flagship's config and every count derived from its depth; the ranks
# (this script run as a worker) read CUT_ENV and do the same.
CUT_LAYERS, CUT_DEPTH, CUT_AUTOMODEL = VARIANT_LAYERS, VARIANT_DEPTH, VARIANT_AUTOMODEL
CUT_ENV = "BIFOLD_SMOKE_CUT_DEPTH"
# a flagship at odd widths (SigLIP towers of 3 heads at width 27 and a
# fusion of 3 heads, 64 px: every sequence takes the math path): fsdp=2
# divides its stacked leaves only along their depth, where it shards them
# (at min_size 2**8); at the published widths every axis is even, so fsdp=2
# never does
DEPTH_AXIS_SIGLIP = {"layers": 2, "heads": 3, "mlp_dim": 81}
DEPTH_AXIS = {"automodel_name": "siglip-odd-widths", "image_size": 64, "dim": 27,
              "depth": 2, "heads": 3, "r": 2}
DEPTH_AXIS_MIN_SIZE = 2 ** 8


# recorded figures, not measured by this run: each phase's seconds in the
# script before its multi-rank phases and variants ran at a cut depth and
# before refused_configs existed (867.42 s in all, one run on an H100 80GB
# HBM3 at 700.00 W; PERF.md section 7), printed beside this run's as the
# comparison the cut was made for
PHASE_SECONDS_UNCUT = {
    "build": 16.56, "checks": 5.35, "train_flagship": 10.74,
    "train_interleaved": 3.26, "f32_step_equivalence": 1.32,
    "trainer_cli": 34.84, "trainer_pull_ahead": 8.45, "serve_flagship": 9.43,
    "deployment_phase": 18.47, "families": 21.96, "variants": 86.02,
    "remat_phase": 20.77, "t5_family": 17.72, "closed_loop_bimanual": 50.53,
    "closed_loop_unimanual + trainer_softgym + host_tools_and_gif": 57.18,
    "dp_nccl": 62.56, "dp_two_ranks": 22.07, "mesh_two_ranks": 80.07,
    "mesh_cli": 91.33, "mesh_axes_two_ranks": 63.13, "ring_three_ranks": 18.98,
    "daemon_mesh": 32.9, "where_the_time_goes": 75.39,
    "closed_loop_profile": 12.2, "trainer_profiles": 22.32,
    "f32_library_kernels": 5.08, "flash_timings": 15.07, "ln_timings": 3.2,
    "kernels_line": 0.02}
PHASE_SECONDS_UNCUT_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def register_siglip(name, **fields):
    """Add the SigLIP tower config ``name`` (the 384 px base's ``fields``
    replaced) to the port's registry, as ``automodel_name`` finds them."""
    import dataclasses

    from bifold_tpu_torch.models.backbones import siglip_backbone

    configs = siglip_backbone.SIGLIP_BASE_CONFIGS
    configs[name] = dataclasses.replace(configs["google/siglip-base-patch16-384"], **fields)


def cut_depth():
    """From here on, in this process and the ranks it starts: the flagship
    at :data:`CUT_LAYERS` tower layers and a fusion of :data:`CUT_DEPTH`,
    its launch counts (:data:`PER_STEP`, :data:`INFER`,
    :data:`FLAGSHIP_NORMS`, :data:`DP_FAMILY_STEP`, :data:`PP_STACKS`) and
    the CLI's and the advisor's overrides rebound to it."""
    global FLAGSHIP, PER_STEP, INFER, FLAGSHIP_NORMS, CLI_OVERRIDES, DP_FAMILY_STEP
    global PP_STACKS, ADVISE_OVERRIDES
    register_siglip(CUT_AUTOMODEL, layers=CUT_LAYERS)
    os.environ[CUT_ENV] = "1"
    FLAGSHIP = {**FLAGSHIP, "automodel_name": CUT_AUTOMODEL, "depth": CUT_DEPTH}
    PER_STEP = {"fwd_lse_d48": CUT_DEPTH, "fwd_lse_d64": CUT_LAYERS,
                "bwd_d48": CUT_DEPTH, "bwd_d64": CUT_LAYERS}
    INFER = {"fwd_infer_d48": CUT_DEPTH, "fwd_infer_d64": CUT_LAYERS}
    FLAGSHIP_NORMS = (2 * (2 * CUT_LAYERS + CUT_DEPTH), FLAGSHIP_NORMS[1])
    cut = (f"model.automodel_name={CUT_AUTOMODEL}", f"model.depth={CUT_DEPTH}")
    CLI_OVERRIDES = tuple(CLI_OVERRIDES) + cut
    ADVISE_OVERRIDES = tuple(ADVISE_OVERRIDES) + cut
    DP_FAMILY_STEP = {**DP_FAMILY_STEP, "flagship": f32_keys(PER_STEP)}
    PP_STACKS = {"vision": (CUT_LAYERS, 4 * TRAIN_BATCH, True),
                 "text": (CUT_LAYERS, TRAIN_BATCH, True),
                 "fusion": (CUT_DEPTH, TRAIN_BATCH, False)}


def jax_ep_routing(model, ep):
    """Make every MoE layer of ``model`` compute what JAX's layer computes
    on one device under an ep mesh of size ``ep``: the ``j``-th of ``ep``
    contiguous chunks of the token order routed alone, with the capacity of
    its own tokens (``moe_ffn`` on the chunk), when ``ep`` divides the
    tokens; the load-balance loss over every token (JAX's ``route`` at
    top 1)."""
    import types

    from bifold_tpu_torch.models.layers import MoEFeedForward
    from bifold_tpu_torch.ops import moe

    def forward(self, x):
        params = {k: getattr(self, k) for k in ("router", "w1", "b1", "w2", "b2")}
        x2 = x.to(self.dtype).reshape(-1, x.shape[-1])
        parts = x2.chunk(ep) if x2.shape[0] % ep == 0 else (x2,)
        out = torch.cat([moe.moe_ffn(part, params, top_k=self.top_k,
                                     capacity_factor=self.capacity_factor)
                         for part in parts])
        _, _, aux = moe.route(x2, params["router"], top_k=1, capacity=1, return_aux=True)
        return self.dropout(out.reshape(x.shape)), aux

    for mod in model.modules():
        if isinstance(mod, MoEFeedForward):
            mod.forward = types.MethodType(forward, mod)


def dp_step(family, device="cuda", shard=False, mesh=None, dropout=0.0, mode="",
            optim=DP_SGD, extra=None, aux_weight=0.0, ep_groups=1, evaluate=False,
            min_size=2 ** 16):
    """One f32 SGD step (clip 1.0) at ``dropout`` (0 by default) of
    ``family`` ("flagship": SiglipSequential at :data:`FLAGSHIP`;
    "text_unet": its composed config, CLIP RN50) from the seeded init, on
    the seeded global batch of :data:`TRAIN_BATCH` raw 384 px frames through
    the train Processor on ``device``, or on this rank's slice of it
    (``shard``), or placed on ``mesh`` (a config node: the model sharded by
    its plan, the batch cut over the data ranks), under
    ``BIFOLD_LN_KERNEL=mode``: its metrics, launches (and their shapes),
    trainable tensors (gathered whole) and buffers (on the CPU), a hash of
    every parameter this rank holds replicated, the bytes of parameters and
    optimizer state it holds after the step, and the LayerNorm launches
    one train step of this model takes in ``mode``. ``extra``: model
    options over the flagship's (the MoE variant), ``aux_weight`` its
    load-balance weight; ``ep_groups`` > 1 routes the MoE layers in this
    one process as JAX's ``expert_parallel_ffn`` routes them under an ep
    mesh of that size (:func:`jax_ep_routing`); ``evaluate``: also the eval step on the same batch after
    the train step (its launches, their shapes and the heatmaps).
    "depth_axis" is the flagship at :data:`DEPTH_AXIS`'s odd widths;
    ``min_size`` the fsdp rule's; ``depth_units`` counts the placement's
    units that fsdp shards along a stack's depth."""
    import hashlib

    from bifold_tpu_torch import parallel
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.losses import build_loss
    from bifold_tpu_torch.models import build_model, trainable_mask
    from bifold_tpu_torch.ops import flash_attention as fa
    from bifold_tpu_torch.optim import build_optimizer
    from bifold_tpu_torch.parallel import TrainState, make_train_step, shard_batch

    if family in ("flagship", "depth_axis"):
        cfg = {**FLAGSHIP, **(extra or {}), "lora_dropout": dropout, "dropout": dropout}
        proc_cfg = TRAIN_PROCESSOR
        if family == "depth_axis":
            register_siglip(DEPTH_AXIS["automodel_name"], **DEPTH_AXIS_SIGLIP)
            cfg.update(DEPTH_AXIS)
            proc_cfg = {**TRAIN_PROCESSOR, "model_image_size": DEPTH_AXIS["image_size"]}
        proc = Processor(proc_cfg, partition="train", max_context_length=3,
                         autoprocessor_name=cfg["automodel_name"],
                         spm_asset=fixture_model_bytes(), seed=0)
        raw = raw_train_batch(proc, 77)
    else:
        fcfg = family_config("text_unet")
        cfg = dict(fcfg["model"])
        proc = Processor(dict(fcfg["processor"]), partition="train", seed=0)
        raw = {k: v for k, v in raw_train_batch(proc, 77).items()
               if not k.startswith("ctx_")}
    sample = proc.process_batch(raw, device,
                                generator=torch.Generator(device).manual_seed(5))
    if shard:
        sample = shard_batch(sample)
    model = build_model(cfg, dtype=torch.float32, device=device, seed=0)
    mask = trainable_mask(model, lora=True)
    if ep_groups > 1:
        jax_ep_routing(model, ep_groups)
    ln_want = ln_launches(model, mode, True) if family == "flagship" else {}
    placement, t = None, time.perf_counter()
    if mesh is not None:
        mesh = parallel.make_mesh(mesh)
        placement = parallel.place(model, cfg["name"], mesh, min_size)
        sample = shard_batch(sample, mesh=mesh)
        params, names = placement.step_params, placement.step_names
    else:
        params, names = [p for p in model.parameters() if p.requires_grad], None
    opt = build_optimizer(dict(optim), params, None, max_iters=10, gradient_clip=1.0,
                          names=names)
    step = make_train_step(model, build_loss(dict(LOSS)), opt, placement=placement,
                           moe_aux_weight=aux_weight)
    place_s = time.perf_counter() - t
    if placement is not None and hasattr(placement, "reset_peak"):
        placement.reset_peak()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with ln_mode(mode):
        clear_launch_counts()            # the step starts here
        t = time.perf_counter()
        _, metrics = step(TrainState.create(opt, seed=0), sample)
        if device == "cuda":
            torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        launches = launch_counts()       # ... and ends here
    step_peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    shapes = {f"{k} {list(shape)}": n for (k, shape), n in fa.SHAPES.items()}
    evaluated = None
    if evaluate:
        clear_launch_counts()
        out = parallel.make_eval_step(model)(sample)
        if device == "cuda":
            torch.cuda.synchronize()
        evaluated = {"launches": launch_counts(),
                     "shapes": {f"{k} {list(shape)}": n for (k, shape), n in fa.SHAPES.items()},
                     "out": {k: v.float().cpu() for k, v in out.items()
                             if isinstance(v, torch.Tensor) and k.endswith("heatmap")}}
    gathered = {}
    if placement is not None:
        held = placement.held_bytes(opt)
        # the step's peak of whole fsdp tensors (weights and gradients),
        # and what it was when a step gathered every unit at once
        gathered = {"peak_gathered_bytes": getattr(placement, "peak_bytes", None),
                    "whole_fsdp_bytes": sum(
                        int(np.prod(placement._full_shapes[n])) * p.element_size()
                        * (1 + p.requires_grad) for n, p in model.named_parameters()
                        if n in placement.managed),
                    "held_param_bytes": placement.held_bytes(),
                    # the tensors outside the stacks' blocks and two blocks'
                    # shares, each with its gradients
                    "gathered_bound": (placement.stepwise_bytes + 2 * max(
                        s.nbytes + s.grad_bytes for s in placement.shares)
                        if getattr(placement, "shares", None) else None)}
        gathered["depth_units"] = sum(u.axis == 0 and "blocks" in u.leaf.path
                                      for u in placement.units)
        state = placement.full_state_dict()
        local = [(n, p) for n, p in model.named_parameters()
                 if n not in placement.plan.tp and n not in placement.managed]
    else:
        held = sum(t.numel() * t.element_size() for t in [
            *model.parameters(), *(v for key in opt._MOMENTS for v in getattr(opt, key) or ())])
        state = model.state_dict()
        local = list(model.named_parameters())
    digest = hashlib.sha256()
    for name, p in local:
        digest.update(p.detach().cpu().numpy().tobytes())
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "launches": launches,
            "shapes": shapes, "batch": int(sample["depth"].shape[0]),
            "trainable": {n: state[n].detach().cpu() for n, t in mask.items() if t},
            "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()},
            "hash": digest.hexdigest(), "held_bytes": held, "eval": evaluated,
            "ln_want": ln_want, "place_seconds": place_s, "step_seconds": step_s,
            "step_max_memory_allocated_bytes": step_peak, **gathered}


def dp_rank_worker(rank, port, out, device="cuda"):
    """``python3 chip_smoke.py dp-rank RANK PORT OUT [DEVICE]``: rank
    ``RANK`` of :data:`DP_RANKS` in a gloo group on the one card (NCCL
    refuses two ranks on one card; the collective helper stages each flat
    buffer through host memory for gloo), TF32 off as in :func:`main`;
    runs :func:`dp_step` for both families on its slice and saves the
    results to ``OUT/rank<RANK>.pt``."""
    from bifold_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(rank)
    parallel.distributed_init(f"tcp://localhost:{port}", DP_RANKS, rank,
                              device="cuda:0" if device == "cuda" else "cpu",
                              backend="gloo")
    results = {family: dp_step(family, device, shard=True) for family in DP_FAMILY_STEP}
    results["world"] = parallel.world_size()
    results["backend"] = str(torch.distributed.get_backend())
    torch.save(results, Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def dp_two_ranks(card, device="cuda"):
    """Two ranks on the one card in a gloo group (:func:`dp_rank_worker`),
    each training the f32 flagship at dropout 0 through the 3xTF32 flash
    kernels, then f32 ``text_unet`` (CLIP RN50, its BatchNorms' statistics
    global), on its half (batch 1) of a global batch of 2; against the
    one-process step on the same global batch in this process. Gates: loss,
    gradient norm and per-head terms within :data:`DP_TOL` relative, every
    updated trainable tensor within :data:`DP_TOL`, text_unet's running
    statistics within :data:`DP_STATS_TOL`; both ranks' parameters bitwise
    equal (a hash); each rank's flash launches those of the one-process
    step (:data:`DP_FAMILY_STEP`). Returns every rank's launches."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_dp_ranks_"))
    script = str(Path(__file__).resolve())
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, script, "dp-rank", str(r), str(port),
                               str(tmp), device], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=str(Path(script).parent))
             for r in range(DP_RANKS)]
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"dp_two_ranks rank {r}: exit {proc.returncode}\n"
                                     f"{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(DP_RANKS)]
    shutil.rmtree(tmp, ignore_errors=True)
    launches, ok, lines = collections.Counter(), True, {}
    for family, want_launches in DP_FAMILY_STEP.items():
        one = dp_step(family, device)
        worst = {"metrics": 0.0, "trainable": 0.0, "buffers": 0.0}
        for r in ranks:
            got = r[family]
            launches.update(got["launches"])
            worst["metrics"] = max([worst["metrics"]] + [
                abs(got["metrics"][k] - v) / max(abs(v), 1e-30)
                for k, v in one["metrics"].items()])
            for kind in ("trainable", "buffers"):
                worst[kind] = max([worst[kind]] + [
                    float((got[kind][n] - v).abs().max()) for n, v in one[kind].items()
                    if v.numel()])
        same_keys = all(sorted(r[family]["metrics"]) == sorted(one["metrics"]) and
                        sorted(r[family]["trainable"]) == sorted(one["trainable"])
                        for r in ranks)
        replicated = len({r[family]["hash"] for r in ranks}) == 1
        rank_launches = [r[family]["launches"] for r in ranks]
        lines[family] = {"loss": one["metrics"]["loss"],
                         "grad_norm": one["metrics"]["grad_norm"],
                         "batch_per_rank": [r[family]["batch"] for r in ranks],
                         "one_process_batch": one["batch"],
                         "max_rel_diff_metrics": worst["metrics"],
                         "max_abs_diff_trainable": worst["trainable"],
                         "max_abs_diff_buffers": worst["buffers"],
                         "ranks_bitwise_equal": replicated,
                         "launches_per_rank": rank_launches,
                         "one_process_launches": one["launches"]}
        ok &= (same_keys and replicated and worst["metrics"] <= DP_TOL
               and worst["trainable"] <= DP_TOL and worst["buffers"] <= DP_STATS_TOL
               and (device == "cpu" or (one["launches"] == want_launches and all(
                   d == want_launches for d in rank_launches))))
        del one
    emit({"phase": "dp_two_ranks", "ranks": DP_RANKS, "device": "one card, each rank",
          "backend": ranks[0]["backend"], "world": ranks[0]["world"], "dtype": "float32",
          "tol": DP_TOL, "stats_tol": DP_STATS_TOL, **lines,
          "seconds": time.perf_counter() - t0, **card})
    if not ok:
        raise AssertionError("dp_two_ranks failed (see its line)")
    return dict(launches)


MESH_RANKS = 2
# per step mesh ("fsdp", "tp"): the parameter bytes each rank of
# mesh_two_ranks holds, which advise_phase holds its figures against
MESH_HELD: dict = {}
# f32 flagship steps under a mesh against the one-process step: loss and
# gradient norm relative, every trainable tensor absolute
MESH_TOL = 1e-5
MESH_PARAM_TOL = 1e-6
MESH_SGD = {"name": "sgd", "lr": 1e-3, "momentum": 0.9}   # a moment to shard
MESH_STEPS = {"fsdp": {"fsdp": 2}, "tp": {"tp": 2}}
# the heads each rank's flash launches run at, per head dim
MESH_HEADS = {"fsdp": {48: 16, 64: 12}, "tp": {48: 8, 64: 6}}
MESH_SERVE = {"tp": {"tp": 2}, "dp": {"dp": 2}}
MESH_SERVED = (("tp", torch.float32, None), ("dp", torch.float32, None),
               ("tp_int8", torch.bfloat16, "int8"), ("fsdp_int8", torch.bfloat16, "int8"))
# the step cases: name -> (mesh, BIFOLD_LN_KERNEL mode); "fsdp_pallas" runs
# the LayerNorm kernels inside the blocks that gather their fsdp share
MESH_CASES = {"fsdp": ("fsdp", ""), "tp": ("tp", ""), "fsdp_pallas": ("fsdp", "pallas")}
MESH_POOL = 8
MESH_F32_HEATMAP_TOL = 1e-4
# a whole bf16 network's heatmaps, two summation orders apart (the tp
# ranks' row-parallel halves summed in f32 and rounded once more): 0.084
# at most over 9 x 4 heatmaps of 384^2 on an H100 80GB HBM3 at 700 W, as
# far as one process's own bf16 int8 server is from its f32 int8 one
# (0.085), its decoded actions 1-2 px apart (PERF.md)
MESH_BF16_HEATMAP_TOL = 2.0 ** -3


def heads_of(shapes: dict, mesh: str) -> bool:
    """Every flash launch in ``shapes`` ("<key> [B, N, H, D]" -> count) at
    the heads a rank of ``mesh`` computes."""
    want = MESH_HEADS[mesh]
    return bool(shapes) and all(
        json.loads(k.split(" ", 1)[1])[2] == want[json.loads(k.split(" ", 1)[1])[3]]
        for k in shapes)


def mesh_serve(mesh, dtype, quantize, device="cuda"):
    """The flagship served in ``dtype`` (``quantize``) on ``mesh`` (None:
    one process) at batch 1 and at a pool of :data:`MESH_POOL`: each
    request's actions, raw outputs and launches (and their shapes), and
    whether ``export`` refused the sharded server."""
    from bifold_tpu_torch.data.processor import Processor
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.models import build_model
    from bifold_tpu_torch.ops import flash_attention as fa
    from bifold_tpu_torch.serving import ServingModel

    model = build_model(FLAGSHIP, dtype=dtype, device=device, seed=0)
    proc = Processor(PROCESSOR, max_context_length=3,
                     autoprocessor_name=FLAGSHIP["automodel_name"],
                     spm_asset=fixture_model_bytes())
    server = ServingModel(model, None, proc, quantize=quantize, mesh=mesh, device=device)
    del model
    rng = np.random.default_rng(17)
    chunks = [u.shard for u in server.placement.units] if server.placement else []
    out = {"int8_bytes": sum(t.numel() for t in [*server.model.parameters(), *chunks]
                             if t.dtype == torch.int8)}
    if server.placement is not None:
        server.placement.reset_peak()
    for name, n in (("batch_1", 1), ("pool", MESH_POOL)):
        obs = [observation(rng, n_ctx=3) for _ in range(n)]
        texts = [INSTRUCTIONS[i % len(INSTRUCTIONS)] for i in range(n)]
        batch = [dict(o, instruction=t) for o, t in zip(obs, texts)]
        server.predict_batch(batch)              # warm
        clear_launch_counts()
        action, raw = server.predict_batch(batch, return_raw_output=True)
        if device == "cuda":
            torch.cuda.synchronize()
        out[name] = {"action": {f: np.asarray(getattr(action, f)) for f in ACTION_FIELDS},
                     "raw": raw, "launches": launch_counts(),
                     "shapes": {f"{k} {list(s)}": c for (k, s), c in fa.SHAPES.items()}}
        check_action(action, raw, n, FLAGSHIP["image_size"])
    if server.placement is not None:
        out["peak_gathered_bytes"] = server.placement.peak_bytes
    if mesh is not None:
        try:
            server.export(Path(tempfile.gettempdir()) / "never.pt", **obs[0])
            out["export"] = "exported"
        except NotImplementedError as err:
            out["export"] = str(err)
    return out


def mesh_rank_worker(rank, port, out, device="cuda"):
    """``python3 chip_smoke.py mesh-rank RANK PORT OUT [DEVICE]``: rank
    ``RANK`` of :data:`MESH_RANKS` in a gloo group on the one card, TF32 off
    as in :func:`main`: the f32 flagship step in each of
    :data:`MESH_CASES`, a tp step at dropout 0.1 under
    ``BIFOLD_LN_KERNEL=fused``, and the flagship served under each of
    :data:`MESH_SERVE` in f32 and, under tp and under fsdp, in bf16 int8;
    saves the results to ``OUT/rank<RANK>.pt``."""
    from bifold_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(rank)
    parallel.distributed_init(f"tcp://localhost:{port}", MESH_RANKS, rank,
                              device="cuda:0" if device == "cuda" else "cpu",
                              backend="gloo")
    results = {"steps": {}, "serve": {}}
    for name, (mesh, mode) in MESH_CASES.items():
        results["steps"][name] = dp_step("flagship", device, mesh=MESH_STEPS[mesh],
                                         optim=MESH_SGD, mode=mode)
    results["dropout"] = dp_step("flagship", device, mesh=MESH_STEPS["tp"], dropout=0.1,
                                 mode="fused", optim=MESH_SGD)
    results["depth_axis"] = dp_step("depth_axis", device, mesh=MESH_STEPS["fsdp"],
                                    optim=MESH_SGD, min_size=DEPTH_AXIS_MIN_SIZE)
    for name, mesh in MESH_SERVE.items():
        results["serve"][name] = mesh_serve(mesh, torch.float32, None, device)
    for mesh in ("tp", "fsdp"):
        results["serve"][f"{mesh}_int8"] = mesh_serve(MESH_STEPS[mesh], torch.bfloat16,
                                                      "int8", device)
    results["backend"] = str(torch.distributed.get_backend())
    torch.save(results, Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def spawn_ranks(worker, out, *args, n=MESH_RANKS):
    """``n`` processes of this script as ``worker`` ranks (``worker RANK
    PORT OUT ARGS...``), started; :func:`wait_ranks` waits."""
    script = str(Path(__file__).resolve())
    port = _free_port()
    Path(out).mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen([sys.executable, script, worker, str(r), str(port), str(out),
                              *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, cwd=str(Path(script).parent))
            for r in range(n)]


def wait_ranks(procs, worker, out, timeout=900, n=MESH_RANKS, name="rank"):
    """Wait for :func:`spawn_ranks`' processes and load each rank's
    ``OUT/<name><R>.pt``; raises with a rank's error output if one fails,
    and stops every rank on the way out."""
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise AssertionError(f"{worker} rank {r}: exit {proc.returncode}\n"
                                     f"{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return [torch.load(Path(out) / f"{name}{r}.pt", weights_only=False) for r in range(n)]


def mesh_two_ranks(card, device="cuda"):
    """fsdp and tp on the one card: two gloo ranks (:func:`mesh_rank_worker`;
    every collective staged through host memory, so their times measure
    that staging and not NCCL). The full-width f32 flagship at the cut
    depth (:func:`cut_depth`) at
    dropout 0, global batch 2, SGD (momentum 0.9), from the same weights
    and batch, under ``{fsdp: 2}`` and ``{tp: 2}``, each held against the
    one-process step in this process: loss and gradient norm within
    :data:`MESH_TOL` relative, every trainable tensor (gathered whole)
    within :data:`MESH_PARAM_TOL`; per rank exactly the f32 flash launches
    of one step (:data:`PER_STEP`: forwards with lse and backwards), at 16 and 12
    heads under fsdp and 8 and 6 under tp; the tp ranks' replicated
    tensors bitwise equal; under fsdp each rank's bytes of parameters and
    optimizer state beside one process's, and the step's peak of whole
    fsdp tensors (weights and gradients) at most the tensors outside the
    stacks' blocks and two blocks' shares, below the whole model's (the
    blocks gather a block at a time), with ``max_memory_allocated`` over
    the step beside one process's; the same fsdp step under
    ``BIFOLD_LN_KERNEL=pallas``, its LayerNorm launches exact. A tp step at dropout 0.1 under
    ``BIFOLD_LN_KERNEL=fused``: replicated tensors bitwise equal across
    the tp group, the fused LayerNorm launches exact. The f32 flagship
    served under ``{tp: 2}`` and ``{dp: 2}`` at batch 1 and a pool of 8:
    actions identical to the one-process server's, heatmaps within
    :data:`MESH_F32_HEATMAP_TOL`, exact inference launches per request;
    bf16 int8 under ``{tp: 2}``: heatmaps within
    :data:`MESH_BF16_HEATMAP_TOL`, decoded actions reported beside one
    process's, and one process's own bf16 int8 heatmaps' distance from its
    f32 int8 ones beside them; bf16 int8 under ``{fsdp: 2}`` alike, at 16
    and 12 heads, each rank holding fewer int8 bytes than one process;
    ``export`` refused. While the ranks run, this process sweeps the
    advisor (:func:`advise_sweep`), held against the ranks' bytes
    (:func:`advise_phase`). Returns every rank's launches; leaves each
    step mesh's parameter bytes per rank in :data:`MESH_HELD`."""
    import shutil

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_mesh_ranks_"))
    procs = spawn_ranks("mesh-rank", tmp, device)
    # the one-process references while the ranks run (launches of this
    # process are not counted: only the ranks' own counts are summed)
    one = dp_step("flagship", device, optim=MESH_SGD)
    one_depth_axis = dp_step("depth_axis", device, optim=MESH_SGD)
    refs = {}
    for _, dtype, quantize in MESH_SERVED:
        if (dtype, quantize) not in refs:
            refs[dtype, quantize] = mesh_serve(None, dtype, quantize, device)
    # how far one process's bf16 int8 server is from its f32 one: the
    # scale of bf16's own error, beside the tp ranks' distance from it
    f32_int8 = mesh_serve(None, torch.float32, "int8", device)
    bf16_int8 = refs[torch.bfloat16, "int8"]
    bf16_error = {case: max(float(np.abs(bf16_int8[case]["raw"][k]
                                         - f32_int8[case]["raw"][k]).max())
                            for k in f32_int8[case]["raw"]) for case in ("batch_1", "pool")}
    del f32_int8
    # the advise sweep (host only) while the ranks still run; held against
    # their bytes once they are done
    swept = advise_sweep()
    ranks = wait_ranks(procs, "mesh-rank", tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    launches, ok, lines = collections.Counter(), True, {}
    want_step = f32_keys(PER_STEP)
    for name, (mesh, mode) in MESH_CASES.items():
        worst = {"metrics": 0.0, "trainable": 0.0}
        for r in ranks:
            got = r["steps"][name]
            launches.update(got["launches"])
            worst["metrics"] = max([worst["metrics"]] + [
                abs(got["metrics"][k] - one["metrics"][k]) / max(abs(one["metrics"][k]), 1e-30)
                for k in ("loss", "grad_norm")])
            worst["trainable"] = max([worst["trainable"]] + [
                float((got["trainable"][n] - v).abs().max()) for n, v in
                one["trainable"].items() if v.numel()])
        same_keys = all(sorted(r["steps"][name]["trainable"]) == sorted(one["trainable"])
                        for r in ranks)
        rank_launches = [r["steps"][name]["launches"] for r in ranks]
        want = {**want_step, **(ranks[0]["steps"][name]["ln_want"] if mode else {})}
        heads = all(heads_of(r["steps"][name]["shapes"], mesh) for r in ranks)
        replicated = len({r["steps"][name]["hash"] for r in ranks}) == 1
        got = [r["steps"][name] for r in ranks]
        # fsdp: the blocks gather their share one at a time (ZeRO-3)
        gathered = mesh != "fsdp" or all(
            0 < g["peak_gathered_bytes"] <= g["gathered_bound"] < g["whole_fsdp_bytes"]
            for g in got)
        lines[name] = {
            "mesh": MESH_STEPS[mesh], "ln_mode": mode or "default", "want": want,
            "held_param_bytes_per_rank": [g["held_param_bytes"] for g in got],
            "peak_gathered_bytes_per_rank": [g["peak_gathered_bytes"] for g in got],
            "gathered_bound_per_rank": [g["gathered_bound"] for g in got],
            "whole_fsdp_bytes": got[0]["whole_fsdp_bytes"], "gathered_ok": gathered,
            "step_max_memory_allocated_bytes_per_rank": [
                g["step_max_memory_allocated_bytes"] for g in got],
            "one_process_step_max_memory_allocated_bytes":
                one["step_max_memory_allocated_bytes"],
            "loss": one["metrics"]["loss"], "grad_norm": one["metrics"]["grad_norm"],
            "max_rel_diff_loss_grad_norm": worst["metrics"],
            "max_abs_diff_trainable": worst["trainable"],
            "launches_per_rank": rank_launches, "shapes_per_rank": [
                r["steps"][name]["shapes"] for r in ranks], "heads_ok": heads,
            "batch_per_rank": [r["steps"][name]["batch"] for r in ranks],
            "held_bytes_per_rank": [r["steps"][name]["held_bytes"] for r in ranks],
            "one_process_held_bytes": one["held_bytes"],
            "replicated_bitwise_equal": replicated,
            "first_step_seconds_host_staged": [r["steps"][name]["step_seconds"]
                                               for r in ranks],
            "one_process_first_step_seconds": one["step_seconds"],
            "place_seconds": [r["steps"][name]["place_seconds"] for r in ranks]}
        ok &= (same_keys and gathered and worst["metrics"] <= MESH_TOL
               and worst["trainable"] <= MESH_PARAM_TOL
               and (name != "tp" or replicated)
               and (device == "cpu" or (heads and all(d == want for d in rank_launches))))
        MESH_HELD[mesh] = [g["held_param_bytes"] for g in got]
    drop = [r["dropout"] for r in ranks]
    for d in drop:
        launches.update(d["launches"])
    fused_want = {**want_step, **drop[0]["ln_want"]}
    lines["tp_dropout_fused"] = {
        "replicated_bitwise_equal": drop[0]["hash"] == drop[1]["hash"],
        "launches_per_rank": [d["launches"] for d in drop], "want": fused_want,
        "loss": [d["metrics"]["loss"] for d in drop]}
    ok &= drop[0]["hash"] == drop[1]["hash"] and (device == "cpu" or all(
        d["launches"] == fused_want for d in drop))
    # fsdp along the stacks' depth: each block gathers its layers from the
    # ranks owning them (no flash launch: the odd widths' sequences are short)
    got = [r["depth_axis"] for r in ranks]
    gap = max(abs(g["metrics"][k] - one_depth_axis["metrics"][k])
              / max(abs(one_depth_axis["metrics"][k]), 1e-30)
              for g in got for k in ("loss", "grad_norm"))
    tensors = max(float((g["trainable"][n] - v).abs().max()) for g in got
                  for n, v in one_depth_axis["trainable"].items() if v.numel())
    for g in got:
        launches.update(g["launches"])
    lines["fsdp_depth_axis"] = {
        "model": DEPTH_AXIS, "siglip": DEPTH_AXIS_SIGLIP, "min_size": DEPTH_AXIS_MIN_SIZE,
        "depth_units_per_rank": [g["depth_units"] for g in got],
        "max_rel_diff_loss_grad_norm": gap, "max_abs_diff_trainable": tensors,
        "launches_per_rank": [g["launches"] for g in got],
        "peak_gathered_bytes_per_rank": [g["peak_gathered_bytes"] for g in got],
        "gathered_bound_per_rank": [g["gathered_bound"] for g in got]}
    ok &= (gap <= MESH_TOL and tensors <= MESH_PARAM_TOL
           and all(g["depth_units"] > 0 and g["launches"] == {} for g in got)
           and all(0 < g["peak_gathered_bytes"] <= g["gathered_bound"] for g in got))
    del one, one_depth_axis
    infer = f32_keys(INFER)
    for name, dtype, quantize in MESH_SERVED:
        ref = refs[dtype, quantize]
        rows = {}
        for case in ("batch_1", "pool"):
            want = ref[case]
            heat = max(float(np.abs(r["serve"][name][case]["raw"][k]
                                    - want["raw"][k]).max())
                       for r in ranks for k in want["raw"])
            same = all(np.array_equal(r["serve"][name][case]["action"][f], want["action"][f])
                       for r in ranks for f in ACTION_FIELDS)
            per_rank = [r["serve"][name][case]["launches"] for r in ranks]
            for d in per_rank:
                launches.update(d)
            want_launches = want["launches"]
            ok &= want_launches == (infer if dtype == torch.float32 else INFER) or \
                device == "cpu"
            heads = all(heads_of(r["serve"][name][case]["shapes"], name.split("_")[0])
                        for r in ranks) if name.endswith("int8") or name == "tp" else True
            rows[case] = {"max_abs_diff_heatmaps": heat, "actions_identical": same,
                          "launches_per_rank": per_rank, "shapes_per_rank": [
                              r["serve"][name][case]["shapes"] for r in ranks],
                          "actions": {f: ranks[0]["serve"][name][case]["action"][f].tolist()
                                      for f in ACTION_FIELDS},
                          "one_process_actions": {f: want["action"][f].tolist()
                                                  for f in ACTION_FIELDS}}
            tol = MESH_F32_HEATMAP_TOL if dtype == torch.float32 else MESH_BF16_HEATMAP_TOL
            ok &= heat <= tol and (dtype != torch.float32 or same) and (
                device == "cpu" or (heads and all(d == want_launches for d in per_rank)))
        refused = all("mesh-sharded" in r["serve"][name].get("export", "") for r in ranks)
        ok &= refused
        lines[f"serve_{name}"] = {**rows, "export_refused": refused, "dtype": str(dtype),
                                  "quantize": quantize}
        if dtype == torch.bfloat16:
            lines[f"serve_{name}"]["one_process_bf16_vs_f32_heatmaps"] = bf16_error
        if name.startswith("fsdp"):
            # each rank holds its chunks of the int8 payloads
            held = [r["serve"][name]["int8_bytes"] for r in ranks]
            lines[f"serve_{name}"].update({
                "int8_bytes_per_rank": held, "one_process_int8_bytes": ref["int8_bytes"],
                "request_peak_gathered_bytes_per_rank": [
                    r["serve"][name]["peak_gathered_bytes"] for r in ranks]})
            ok &= all(h < ref["int8_bytes"] for h in held)
    del refs
    emit({"phase": "mesh_two_ranks", "ranks": MESH_RANKS, "device": "one card, each rank",
          "backend": ranks[0]["backend"], "collectives": "gloo, staged through host memory",
          "dtype": "float32 steps", "tol": MESH_TOL, "param_tol": MESH_PARAM_TOL,
          **lines, "seconds": time.perf_counter() - t0, **card})
    if not ok:
        raise AssertionError("mesh_two_ranks failed (see its line)")
    advise_phase(card, swept)
    return dict(launches)


# 2 steps per epoch; pixel eval after the second epoch, in the unstopped
# run only (the stopped and resumed runs write last.ckpt alone)
MESH_CLI = ("train_dataset.n_samples=4", "test_batch_size=2")
MESH_CLI_MESHES = {"fsdp": "mesh.fsdp=2", "tp": "mesh.tp=2"}


def f32_config(run_dir):
    """A run's config with the model computing in float32: its checkpoint
    (float32 masters, the frozen bf16 towers' exact upcasts) served so that
    a sharded server and one process agree to f32 rounding."""
    from bifold_tpu_torch.config import load_yaml

    cfg = load_yaml(Path(run_dir) / "config.yaml")
    return {**cfg, "precision": {**dict(cfg.get("precision") or {}),
                                 "compute_dtype": "float32"}}


def mesh_cli_worker(rank, port, out, device="cuda", name="fsdp"):
    """``python3 chip_smoke.py mesh-cli RANK PORT OUT DEVICE MESH``: rank
    ``RANK`` of :data:`MESH_RANKS` joins a gloo group on the card, then runs
    ``main`` of ``bifold_tpu_torch.__main__`` (which finds the group up and
    keeps it) under ``MESH`` (:data:`MESH_CLI_MESHES`) three times on the
    bf16 flagship: 2 epochs of 2 steps with pixel eval and checkpoints; 1
    epoch; and 2 epochs again from that one's checkpoints (a resume).
    Saves each run's launches, exit code, run dir, checkpoint seconds and
    the sharded server's output on the last checkpoint to
    ``OUT/rank<RANK>.pt``."""
    import shutil

    from bifold_tpu_torch import __main__ as cli
    from bifold_tpu_torch import parallel
    from bifold_tpu_torch.config import compose
    from bifold_tpu_torch.serving import ServingModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(rank)
    torch.set_num_threads(2)             # two pairs of ranks share the host
    parallel.distributed_init(f"tcp://localhost:{port}", MESH_RANKS, rank,
                              device="cuda:0" if device == "cuda" else "cpu",
                              backend="gloo")
    base = [o for o in CLI_OVERRIDES
            if not o.startswith(("epochs", "eval_epochs", "train_dataset.n_samples"))]
    base += list(MESH_CLI) + [MESH_CLI_MESHES[name]] + (
        ["use_cpu=true"] if device == "cpu" else [])
    runs = {}
    for run, epochs, root in (("straight", 2, "a"), ("first", 1, "b"), ("resumed", 2, "b")):
        overrides = base + [f"epochs={epochs}", f"run_dir={Path(out) / root}",
                            f"eval_epochs={2 if run == 'straight' else 0}"]
        run_dir = Path(compose(overrides)["run_dir"]) / cli.run_dir_name(
            cli.override_dirname(overrides))
        if run == "resumed" and rank == 0:
            shutil.copytree(runs["first"]["run_dir"] / "checkpoints",
                            run_dir / "checkpoints")
        torch.distributed.barrier()
        record = {}
        clear_launch_counts()
        code, _, seconds = run_cli(overrides, record)
        trainer = record.pop("trainers")[0]
        runs[run] = {"code": code, "seconds": seconds, "run_dir": run_dir,
                     "steps": record.get("steps", []), "evals": record.get("evals", []),
                     "epochs": record.get("epochs", []), "global_step": trainer.global_step,
                     "data_size": trainer.mesh.data_size,
                     "save_seconds": record.get("saves", []),
                     "load_seconds": record.get("loads", [])}
        del trainer, record
    server = ServingModel.from_checkpoint(
        runs["straight"]["run_dir"] / "checkpoints" / "last.ckpt",
        f32_config(runs["straight"]["run_dir"]),
        mesh={"tp": 2} if name == "tp" else {"dp": 2}, device=device)
    obs = observation(np.random.default_rng(23), n_ctx=3)
    action, raw = server.predict(**obs, instruction=INSTRUCTIONS[1],
                                 return_raw_output=True)
    runs["served"] = {"action": {f: np.asarray(getattr(action, f)) for f in ACTION_FIELDS},
                      "raw": raw}
    del server
    runs = {k: ({**v, "run_dir": str(v["run_dir"])} if "run_dir" in v else v)
            for k, v in runs.items()}
    torch.save(runs, Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def mesh_cli(card, device="cuda"):
    """``main`` under a mesh: two gloo ranks on the card
    (:func:`mesh_cli_worker`) train the bf16 flagship through
    ``bifold_tpu_torch.__main__.main`` with ``mesh.fsdp=2`` and then with
    ``mesh.tp=2``: 4 steps, pixel eval and checkpoints each; exactly
    ``PER_STEP`` launches per step and ``INFER`` per eval batch on each
    rank. Then, in this process: each ``last.ckpt`` served in f32 by a
    one-process ``ServingModel.from_checkpoint`` (the gathered weights,
    read back), its actions identical to the ranks' sharded server's on
    the same file and its heatmaps within :data:`MESH_F32_HEATMAP_TOL`;
    and a run stopped after its first epoch and
    resumed under the same mesh, whose ``last.ckpt`` equals the unstopped
    run's bitwise (every leaf, the optimizer's moments gathered whole
    included). Returns every rank's launches."""
    import shutil

    from bifold_tpu_torch.serving import ServingModel
    from bifold_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_mesh_cli_"))
    # both meshes at once, each a pair of ranks of its own
    pairs = {name: spawn_ranks("mesh-cli", tmp / name, device, name)
             for name in MESH_CLI_MESHES}
    ranks = {name: wait_ranks(procs, "mesh-cli", tmp / name) for name, procs in pairs.items()}
    launches, ok, lines = collections.Counter(), True, {}
    for name in MESH_CLI_MESHES:
        runs = ranks[name]
        for r in runs:
            for run in ("straight", "first", "resumed"):
                for d in r[run]["steps"] + r[run]["evals"]:
                    launches.update(d)
        straight, resumed = (Path(runs[0][k]["run_dir"]) / "checkpoints" / "last.ckpt"
                             for k in ("straight", "resumed"))
        a, b = load_checkpoint(straight), load_checkpoint(resumed)
        leaves = {k: (nested_leaves(a[k]), nested_leaves(b[k]))
                  for k in ("params", "opt_state")}
        bitwise = all(len(x) == len(y) and all(np.array_equal(np.asarray(p), np.asarray(q))
                                               for p, q in zip(x, y))
                      for x, y in leaves.values())
        server = ServingModel.from_checkpoint(
            straight, f32_config(Path(runs[0]["straight"]["run_dir"])), device=device)
        obs = observation(np.random.default_rng(23), n_ctx=3)
        action, raw = server.predict(**obs, instruction=INSTRUCTIONS[1],
                                     return_raw_output=True)
        check_action(action, raw, 1, FLAGSHIP["image_size"])
        del server
        heat = max(float(np.abs(r["served"]["raw"][k] - raw[k]).max())
                   for r in runs for k in raw)
        same = all(np.array_equal(r["served"]["action"][f], np.asarray(getattr(action, f)))
                   for r in runs for f in ACTION_FIELDS)
        per_step = [d == PER_STEP for r in runs for run in ("straight", "first", "resumed")
                    for d in r[run]["steps"]]
        per_eval = [d == INFER for r in runs for run in ("straight", "first", "resumed")
                    for d in r[run]["evals"]]
        counts = [(len(r["straight"]["steps"]), len(r["first"]["steps"]),
                   len(r["resumed"]["steps"])) for r in runs]
        lines[name] = {
            "exit_codes": [[r[k]["code"] for k in ("straight", "first", "resumed")] for r in runs],
            "steps_per_run": counts, "resumed_epochs": [r["resumed"]["epochs"] for r in runs],
            "global_step": [r["resumed"]["global_step"] for r in runs],
            "data_ranks": runs[0]["straight"]["data_size"],
            "launches_ok": [all(per_step), all(per_eval)],
            "resume_bitwise": bitwise,
            "served_f32_max_abs_diff_heatmaps": heat, "served_actions_identical": same,
            "actions_sharded": {f: runs[0]["served"]["action"][f].tolist()
                                for f in ACTION_FIELDS},
            "actions_one_process": {f: np.asarray(getattr(action, f)).tolist()
                                    for f in ACTION_FIELDS},
            "seconds_per_run": [[r[k]["seconds"] for k in ("straight", "first", "resumed")]
                                for r in runs],
            "checkpoint_write_seconds": [[r[k]["save_seconds"] for k in
                                          ("straight", "first", "resumed")] for r in runs],
            "resume_load_seconds": [r["resumed"]["load_seconds"] for r in runs]}
        ok &= (all(r[k]["code"] == 0 for r in runs for k in ("straight", "first", "resumed"))
               and all(c == (4, 2, 2) for c in counts) and bitwise
               and all(r["resumed"]["epochs"] == [1] for r in runs)
               and heat <= MESH_F32_HEATMAP_TOL and same
               and (device == "cpu" or (all(per_step) and all(per_eval)
                                        and bool(per_step) and bool(per_eval))))
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "mesh_cli", "ranks": MESH_RANKS, "entry": "bifold_tpu_torch.__main__.main",
          "collectives": "gloo, staged through host memory", **lines,
          "seconds": time.perf_counter() - t0, **card})
    if not ok:
        raise AssertionError("mesh_cli failed (see its line)")
    return dict(launches)


# the mesh axes pp and ep and MoE over data ranks, two gloo ranks on the
# card: the f32 flagship step under {pp: 2} (each stage's layers of the
# three stacks, microbatched), again under BIFOLD_LN_KERNEL=pallas, eval
# through the pipe, and the f32 MoE variant under {ep: 2} and {dp: 2} at a
# capacity that drops tokens
AXES_PP = {"pp": 2}
AXES_TOL = 1e-6                          # loss, grad norm: relative to one process
AXES_PARAM_TOL = 1e-8                    # trainable tensors after one step
AXES_EVAL_TOL = 1e-5                     # heatmaps of the eval step
AXES_MOE = {"ep": {"ep": 2}, "dp": {"dp": 2}}
AXES_MOE_MODEL = {**VARIANTS["moe"], "moe_capacity_factor": 0.5}   # drops tokens
AXES_MOE_AUX = AXES_MOE_MODEL["moe_aux_weight"]
# the flagship's pipelined stacks at TRAIN_BATCH: (depth, rows, whether its
# input carries no gradient: the frozen towers' embeddings); the text tower
# runs the math path (64 tokens), the vision tower sees 1 + 3 frames a sample
PP_STACKS = {"vision": (12, 4 * TRAIN_BATCH, True), "text": (12, TRAIN_BATCH, True),
             "fusion": (8, TRAIN_BATCH, False)}


def pp_flash_want(one_shapes: dict, pp: int) -> dict:
    """A pp rank's flash launches, from one process's ("<key> [B, N, H,
    D]" -> count): a stack's ``n`` launches at batch B become ``n / pp``
    layers, each launched once per microbatch."""
    from bifold_tpu_torch.parallel.pipeline import microbatch_count

    want = collections.Counter()
    for k, n in one_shapes.items():
        key, shape = k.split(" ", 1)
        want[key] += n // pp * microbatch_count(json.loads(shape)[0], pp)
    return dict(want)


def pp_ln_want(stage: int, pp: int, other: int = FLAGSHIP_NORMS[1]) -> dict:
    """A pp stage's LayerNorm kernel launches of one ``pallas`` train step:
    two norms a layer, once per microbatch, forward and backward, but no
    backward for the first norm of a frozen tower's first layer (stage 0);
    the ``other`` norms outside the stacks on every stage."""
    from bifold_tpu_torch.parallel.pipeline import microbatch_count

    if sum(2 * depth for depth, _, _ in PP_STACKS.values()) != FLAGSHIP_NORMS[0]:
        raise AssertionError("PP_STACKS does not hold the flagship's stacked norms")
    fwd = bwd = other
    for depth, rows, frozen in PP_STACKS.values():
        m = microbatch_count(rows, pp)
        fwd += depth // pp * 2 * m
        bwd += depth // pp * 2 * m - (m if frozen and stage == 0 else 0)
    return {"ln_fwd": fwd, "ln_bwd": bwd}


def axes_rank_worker(rank, port, out, device="cuda"):
    """``python3 chip_smoke.py axes-rank RANK PORT OUT [DEVICE]``: rank
    ``RANK`` of :data:`MESH_RANKS` in a gloo group on the one card, TF32 off
    as in :func:`main`: the f32 flagship step under :data:`AXES_PP` with its
    eval step, the same step under ``pallas``, and the f32 MoE variant's
    step under each of :data:`AXES_MOE`; saves to ``OUT/rank<RANK>.pt``."""
    from bifold_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(rank)
    parallel.distributed_init(f"tcp://localhost:{port}", MESH_RANKS, rank,
                              device="cuda:0" if device == "cuda" else "cpu",
                              backend="gloo")
    results = {"pp": dp_step("flagship", device, mesh=AXES_PP, optim=MESH_SGD, evaluate=True),
               "pp_pallas": dp_step("flagship", device, mesh=AXES_PP, mode="pallas",
                                    optim=MESH_SGD),
               "stage": parallel.make_mesh(AXES_PP).coords["pp"]}
    results["moe"] = {name: dp_step("flagship", device, mesh=mesh, optim=MESH_SGD,
                                    extra=AXES_MOE_MODEL, aux_weight=AXES_MOE_AUX)
                      for name, mesh in AXES_MOE.items()}
    torch.save(results, Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def _axes_gap(got, want):
    """(largest relative gap of loss and grad norm, largest absolute gap of
    a trainable tensor) of a rank's step from one process's."""
    metrics = max(abs(got["metrics"][k] - want["metrics"][k]) / max(abs(want["metrics"][k]), 1e-30)
                  for k in ("loss", "grad_norm"))
    tensors = max(float((got["trainable"][n] - v).abs().max())
                  for n, v in want["trainable"].items() if v.numel())
    return metrics, tensors


def mesh_axes_two_ranks(card, device="cuda"):
    """pp and ep on the one card: two gloo ranks (:func:`axes_rank_worker`;
    every transfer staged through host memory, so its times measure that
    staging, not NCCL). The full-width f32 flagship at the cut depth
    (:func:`cut_depth`) at dropout
    0, global batch 2, SGD with momentum, under ``{pp: 2}``: its three
    stacks (:data:`PP_STACKS`) run as GPipe pipes, each
    stage holding half the layers. Against the one-process step in this
    process: loss and gradient norm within :data:`AXES_TOL` relative, every
    trainable tensor within :data:`AXES_PARAM_TOL`; per rank exactly one
    process's f32 flash launches cut into stages and microbatches
    (:func:`pp_flash_want`: a stage's vision layers x 4 microbatches of 2
    frames at d64, its fusion layers x 2 microbatches of 1 at d48, forward
    with lse and
    backward); the bytes each rank holds beside one process's; the eval
    step through the pipe, its heatmaps within :data:`AXES_EVAL_TOL` and
    its inference launches exact; the same step under ``pallas`` with each
    stage's ``ln_fwd``/``ln_bwd`` launches exact (:func:`pp_ln_want`). The
    f32 MoE variant (8 experts, capacity factor 0.5: tokens drop) under
    ``{ep: 2}`` against one process routing by JAX's two ep shards, and
    under ``{dp: 2}`` against one process routing the whole batch (JAX's
    global routing), within :data:`MESH_TOL` and :data:`MESH_PARAM_TOL`;
    the experts' bytes halve under ep. Returns every rank's launches."""
    import shutil

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_axes_ranks_"))
    procs = spawn_ranks("axes-rank", tmp, device)
    one = dp_step("flagship", device, optim=MESH_SGD, evaluate=True)
    moe_one = {"ep": dp_step("flagship", device, optim=MESH_SGD, extra=AXES_MOE_MODEL,
                             aux_weight=AXES_MOE_AUX, ep_groups=AXES_MOE["ep"]["ep"]),
               "dp": dp_step("flagship", device, optim=MESH_SGD, extra=AXES_MOE_MODEL,
                             aux_weight=AXES_MOE_AUX)}
    ranks = wait_ranks(procs, "axes-rank", tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    launches, ok, lines = collections.Counter(), True, {}
    pp = AXES_PP["pp"]
    want_step = pp_flash_want(one["shapes"], pp)
    want_eval = pp_flash_want(one["eval"]["shapes"], pp)
    for name in ("pp", "pp_pallas"):
        gaps = [_axes_gap(r[name], one) for r in ranks]
        per_rank = [r[name]["launches"] for r in ranks]
        for d in per_rank:
            launches.update(d)
        want = [want_step if name == "pp" or device == "cpu" else
                {**want_step, **pp_ln_want(r["stage"], pp)} for r in ranks]
        lines[name] = {"loss": one["metrics"]["loss"], "grad_norm": one["metrics"]["grad_norm"],
                       "max_rel_diff_loss_grad_norm": max(g[0] for g in gaps),
                       "max_abs_diff_trainable": max(g[1] for g in gaps),
                       "launches_per_rank": per_rank, "want_per_rank": want,
                       "shapes_per_rank": [r[name]["shapes"] for r in ranks],
                       "held_bytes_per_rank": [r[name]["held_bytes"] for r in ranks],
                       "one_process_held_bytes": one["held_bytes"],
                       "first_step_seconds_host_staged": [r[name]["step_seconds"]
                                                          for r in ranks],
                       "one_process_first_step_seconds": one["step_seconds"],
                       "place_seconds": [r[name]["place_seconds"] for r in ranks]}
        ok &= (max(g[0] for g in gaps) <= AXES_TOL and max(g[1] for g in gaps) <= AXES_PARAM_TOL
               and all(r[name]["held_bytes"] < one["held_bytes"] for r in ranks)
               and (device == "cpu" or all(d == w for d, w in zip(per_rank, want))))
    heat = max(float((r["pp"]["eval"]["out"][k] - v).abs().max())
               for r in ranks for k, v in one["eval"]["out"].items())
    eval_launches = [r["pp"]["eval"]["launches"] for r in ranks]
    for d in eval_launches:
        launches.update(d)
    lines["pp_eval"] = {"max_abs_diff_heatmaps": heat, "launches_per_rank": eval_launches,
                        "want_per_rank": want_eval,
                        "shapes_per_rank": [r["pp"]["eval"]["shapes"] for r in ranks]}
    ok &= heat <= AXES_EVAL_TOL and bool(one["eval"]["out"]) and (
        device == "cpu" or all(d == want_eval for d in eval_launches))
    for name, ref in moe_one.items():
        gaps = [_axes_gap(r["moe"][name], ref) for r in ranks]
        per_rank = [r["moe"][name]["launches"] for r in ranks]
        for d in per_rank:
            launches.update(d)
        # each rank launches what one process does (under dp at half the batch)
        want = ref["launches"]
        lines[f"moe_{name}"] = {
            "loss": ref["metrics"]["loss"],
            "moe_load_balance": ref["metrics"]["moe_load_balance"],
            "rank_moe_load_balance": [r["moe"][name]["metrics"]["moe_load_balance"]
                                      for r in ranks],
            "max_rel_diff_loss_grad_norm": max(g[0] for g in gaps),
            "max_abs_diff_trainable": max(g[1] for g in gaps),
            "launches_per_rank": per_rank, "want": want,
            "batch_per_rank": [r["moe"][name]["batch"] for r in ranks],
            "held_bytes_per_rank": [r["moe"][name]["held_bytes"] for r in ranks],
            "one_process_held_bytes": ref["held_bytes"],
            "first_step_seconds_host_staged": [r["moe"][name]["step_seconds"] for r in ranks]}
        ok &= (max(g[0] for g in gaps) <= MESH_TOL and max(g[1] for g in gaps) <= MESH_PARAM_TOL
               and (name != "ep" or all(r["moe"][name]["held_bytes"] < ref["held_bytes"]
                                        for r in ranks))
               and (device == "cpu" or all(d == want for d in per_rank)))
    emit({"phase": "mesh_axes_two_ranks", "ranks": MESH_RANKS, "device": "one card, each rank",
          "collectives": "gloo, staged through host memory", "dtype": "float32",
          "tol": AXES_TOL, "param_tol": AXES_PARAM_TOL, **lines,
          "seconds": time.perf_counter() - t0, **card})
    if not ok:
        raise AssertionError("mesh_axes_two_ranks failed (see its line)")
    return dict(launches)


# ring attention over three gloo ranks on the card (sp = 3): the vision
# tower's and the fusion stack's attention shapes, cut into 192- and
# 791-token chunks, forward and backward, in bf16 and f32
RING_RANKS = 3
RING_SHAPES = {"tower": (4, 576, 12, 64), "fusion": (1, 2373, 16, 48)}
RING_MASKS = ("flagship", "dead_chunk")


def ring_inputs(name, dtype, masking, device="cuda"):
    """q, k, v, the output cotangent (seeded, the same on every rank) and
    the key mask: the flagship's (the tower none; the fusion its last
    context frame masked) or one with the middle sp chunk wholly masked
    besides."""
    b, n, h, d = RING_SHAPES[name]
    gen = torch.Generator(device).manual_seed(7 + d)
    q, k, v, g = (torch.randn(b, n, h, d, device=device, generator=gen).to(dtype)
                  for _ in range(4))
    if name == "fusion":
        mask = torch.ones(b, n, dtype=torch.int32, device=device)
        mask[:, 65 + 577 * 2: 65 + 577 * 3] = 0
    else:
        mask = None
    if masking == "dead_chunk":
        mask = torch.ones(b, n, dtype=torch.int32, device=device) if mask is None else mask
        chunk = n // RING_RANKS
        mask[:, chunk:2 * chunk] = 0
    return q, k, v, g, mask


def ring_rank_worker(rank, port, out, device="cuda"):
    """``python3 chip_smoke.py ring-rank RANK PORT OUT [DEVICE]``: rank
    ``RANK`` of :data:`RING_RANKS` in a gloo group on the card. For each
    shape, dtype and mask: its chunk of the ring's output and of dq, dk,
    dv (launches counted from just before the forward to just after the
    backward), then the single-device kernels on the whole sequence, and
    each chunk's largest difference from them (:func:`within`); saves to
    ``OUT/rank<RANK>.pt``."""
    from bifold_tpu_torch import parallel
    from bifold_tpu_torch.ops import flash_attention as fa
    from bifold_tpu_torch.parallel import make_mesh
    from bifold_tpu_torch.ops.ring_attention import ring_attention_shard

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(rank)
    parallel.distributed_init(f"tcp://localhost:{port}", RING_RANKS, rank,
                              device="cuda:0" if device == "cuda" else "cpu",
                              backend="gloo")
    mesh = make_mesh({"sp": RING_RANKS})
    results = {}
    for name in RING_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for masking in RING_MASKS:
                q, k, v, g, mask = ring_inputs(name, dtype, masking, device)
                n = q.shape[1] // RING_RANKS
                part = [t[:, rank * n:(rank + 1) * n].contiguous().requires_grad_()
                        for t in (q, k, v)]
                clear_launch_counts()
                t = time.perf_counter()
                o = ring_attention_shard(*part, None if mask is None else
                                         mask[:, rank * n:(rank + 1) * n].contiguous(),
                                         ranks=mesh.ranks["sp"], me=mesh.coords["sp"])
                grads = torch.autograd.grad(o, part, g[:, rank * n:(rank + 1) * n])
                if device == "cuda":
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t
                counts = launch_counts()
                whole = [t.clone().requires_grad_() for t in (q, k, v)]
                ref = fa.flash_attention_train(*whole, mask)
                ref_grads = torch.autograd.grad(ref, whole, g)
                errs = {}
                for key, got, want in (("out", o, ref), *zip(("dq", "dk", "dv"), grads,
                                                            ref_grads)):
                    err, tol, good = within(got.detach(), want.detach()[:, rank * n:(rank + 1) * n],
                                            dtype)
                    errs[key] = {"max_abs_err": err, "tol": tol, "ok": good}
                dead = mask is not None and not bool(mask[:, rank * n:(rank + 1) * n].any())
                results[f"{name} {str(dtype).split('.')[-1]} {masking}"] = {
                    "errors": errs, "launches": counts, "seconds_host_staged": seconds,
                    "chunk": [int(s) for s in part[0].shape], "chunk_fully_masked": dead}
    torch.save(results, Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def ring_three_ranks(card, device="cuda"):
    """``ring_attention`` over ``sp`` = :data:`RING_RANKS` gloo ranks on the
    card (:func:`ring_rank_worker`; k, v, the mask and the dk/dv
    accumulators staged through host memory at each ring step) at the
    vision tower's shape (4x576x12x64, chunks of 192) and the fusion
    stack's (1x2373x16x48, chunks of 791), bf16 and f32, forward and
    backward, with the flagship's key masks and with a wholly masked
    chunk: every chunk of the output and of dq, dk, dv against the
    single-device kernels on the whole sequence (f32 within 1e-4, bf16
    within 2^-6 of the plain value, :func:`within`); exactly ``sp``
    forwards with lse and ``sp`` backwards per rank and call. Returns every
    rank's launches."""
    import shutil

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_ring_ranks_"))
    ranks = wait_ranks(spawn_ranks("ring-rank", tmp, device, n=RING_RANKS), "ring-rank", tmp,
                       n=RING_RANKS)
    shutil.rmtree(tmp, ignore_errors=True)
    launches, ok, cases = collections.Counter(), True, {}
    for case in ranks[0]:
        d = RING_SHAPES[case.split()[0]][3]
        suffix = "_f32" if "float32" in case else ""
        want = {f"fwd_lse_d{d}{suffix}": RING_RANKS, f"bwd_d{d}{suffix}": RING_RANKS}
        per_rank = [r[case]["launches"] for r in ranks]
        for c in per_rank:
            launches.update(c)
        good = all(e["ok"] for r in ranks for e in r[case]["errors"].values())
        cases[case] = {"max_abs_err": {k: max(r[case]["errors"][k]["max_abs_err"] for r in ranks)
                                       for k in ranks[0][case]["errors"]},
                       "tol": ranks[0][case]["errors"]["out"]["tol"], "ok": good,
                       "launches_per_rank": per_rank, "want_per_rank": want,
                       "chunk": ranks[0][case]["chunk"],
                       "fully_masked_chunk_on_rank": [r[case]["chunk_fully_masked"]
                                                      for r in ranks],
                       "seconds_host_staged": [r[case]["seconds_host_staged"] for r in ranks]}
        ok &= good and (device == "cpu" or all(c == want for c in per_rank))
        ok &= "dead_chunk" not in case or any(r[case]["chunk_fully_masked"] for r in ranks)
    emit({"phase": "ring_three_ranks", "ranks": RING_RANKS, "sp": RING_RANKS,
          "collectives": "gloo, staged through host memory", "cases": cases,
          "seconds": time.perf_counter() - t0, **card})
    if not ok:
        raise AssertionError("ring_three_ranks failed (see its line)")
    return dict(launches)


# the daemon under --mesh tp=2: two ranks of `python -m bifold_tpu_torch.serve`
# (its main, in this script's worker) on the card over gloo, serving the
# bf16 flagship from a JAX-format checkpoint
DAEMON_MESH = "tp=2"
DAEMON_POOL = 4
DAEMON_SINGLES = 5


def daemon_files(root):
    """The bf16 flagship's seeded weights as a JAX trainer checkpoint, and
    its config, under ``root``."""
    from bifold_tpu_torch.config import save as save_config
    from bifold_tpu_torch.models import build_model
    from bifold_tpu_torch.data.spm import fixture_model_bytes
    from bifold_tpu_torch.models.convert import to_jax_variables

    model = build_model(FLAGSHIP, dtype=torch.float32, device="cpu", seed=0)
    params, _ = to_jax_variables(FLAGSHIP["name"], model.state_dict())
    write_jax_checkpoint(root / "last.ckpt", params)
    (root / "spiece.model").write_bytes(fixture_model_bytes())
    save_config({"model": FLAGSHIP, "processor": PROCESSOR,
                 "precision": {"compute_dtype": "bfloat16"}}, root / "config.yaml")
    return root / "last.ckpt", root / "config.yaml"


def daemon_observations():
    """Observations of one layout (3 context frames), so that the batcher
    may pool any of them."""
    rng = np.random.default_rng(29)
    return [dict(observation(rng, n_ctx=3), instruction=INSTRUCTIONS[i % 5])
            for i in range(DAEMON_SINGLES + DAEMON_POOL)]


def daemon_rank_worker(rank, port, out, device="cuda"):
    """``python3 chip_smoke.py daemon-rank RANK PORT OUT [DEVICE]``: rank
    ``RANK`` of the daemon: a group of :data:`MESH_RANKS`, then ``bifold_tpu_torch.serve.main`` with ``--mesh
    tp=2`` on the checkpoint in ``OUT`` (rank 0 listens on an ephemeral
    port, which it prints), until the stop message; saves this rank's
    launches and their shapes to ``OUT/rank<RANK>.pt``. The rank joins a
    gloo group first (NCCL refuses two ranks on one card), which ``main``
    keeps."""
    from bifold_tpu_torch import parallel, serve
    from bifold_tpu_torch.ops import flash_attention as fa

    device = "cuda:0" if device == "cuda" else "cpu"
    parallel.distributed_init(f"tcp://localhost:{port}", MESH_RANKS, int(rank),
                              device=device, backend="gloo")
    clear_launch_counts()
    code = serve.main(["--checkpoint", str(Path(out) / "last.ckpt"),
                       "--config", str(Path(out) / "config.yaml"), "--mesh", DAEMON_MESH,
                       "--device", device, "--port", "0",
                       "--max-batch", str(DAEMON_POOL), "--batch-window-ms", "200"])
    torch.save({"code": code, "launches": launch_counts(),
                "shapes": {f"{k} {list(s)}": n for (k, s), n in fa.SHAPES.items()}},
               Path(out) / f"rank{rank}.pt")
    return code


def serve_rank_worker(rank, port, out, device="cuda"):
    """``python3 chip_smoke.py serve-rank RANK PORT OUT [DEVICE]``: rank
    ``RANK`` of a gloo group on the card serving the daemon's checkpoint
    in process, ``ServingModel.from_checkpoint(mesh={"tp": 2})``, on
    :func:`daemon_observations`: each single one, and the pool padded to
    :data:`DAEMON_POOL`; saves the actions to ``OUT/serve<RANK>.pt``."""
    from bifold_tpu_torch import parallel
    from bifold_tpu_torch.serve import build_server, parse_mesh

    rank = int(rank)
    parallel.distributed_init(f"tcp://localhost:{port}", MESH_RANKS, rank,
                              device="cuda:0" if device == "cuda" else "cpu",
                              backend="gloo")
    server = build_server(checkpoint=Path(out) / "last.ckpt", config=Path(out) / "config.yaml",
                          mesh=parse_mesh(DAEMON_MESH), device=device)
    obs = daemon_observations()
    actions = [server.predict(**o) for o in obs[:DAEMON_SINGLES]]
    pool = server.predict_batch(obs[DAEMON_SINGLES:], pad_to=DAEMON_POOL)
    torch.save({"singles": [{f: np.asarray(getattr(a, f)) for f in ACTION_FIELDS}
                            for a in actions],
                "pool": {f: np.asarray(getattr(pool, f)) for f in ACTION_FIELDS}},
               Path(out) / f"serve{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def daemon_mesh(card, device="cuda"):
    """The daemon's ``--mesh tp=2``: two ranks on the card over gloo
    (:func:`daemon_rank_worker`), rank 0 answering HTTP on localhost. After
    its warm-up request: :data:`DAEMON_SINGLES` batch-1 requests one by
    one (host p50), then :data:`DAEMON_POOL` concurrent single clients,
    which the batcher coalesces; then SIGINT to rank 0, and every rank
    exits 0. Held: each answer's actions equal those of the in-process
    ``ServingModel(mesh={"tp": 2})`` on two more ranks
    (:func:`serve_rank_worker`) for the same observations (a pool padded
    as the batcher pads it); per rank exactly ``INFER`` at tp's heads (8
    fusion at d48, 6 tower at d64) per forward the daemon made (the
    warm-up, the batch-1 requests, sent with ``?pad=1`` so that they skip
    the batcher's window, and the batcher's dispatches from ``/metrics``).
    Returns the daemon ranks' launches."""
    import shutil
    import signal
    import threading

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_daemon_mesh_"))
    ckpt, _ = daemon_files(tmp)
    reference = spawn_ranks("serve-rank", tmp, device)
    daemon = spawn_ranks("daemon-rank", tmp, device)
    obs = daemon_observations()
    try:
        port, seen = None, []
        deadline = time.perf_counter() + 600
        while port is None and time.perf_counter() < deadline:
            line = daemon[0].stdout.readline()
            if not line:
                break
            seen.append(line)
            if "listening on" in line:
                port = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])
        if port is None:
            raise AssertionError("daemon rank 0 never listened:\n" + "".join(seen[-20:]))
        # batch-1 requests that manage their own pool shape (?pad=1) skip
        # the batcher's window
        http_predict(port, obs[:1], "?pad=1")        # warm-up
        singles, ms = [], []
        for o in obs[:DAEMON_SINGLES]:
            t = time.perf_counter()
            singles.append(http_predict(port, [o], "?pad=1")[0])
            ms.append((time.perf_counter() - t) * 1e3)
        pooled = [None] * DAEMON_POOL

        def client(i):
            pooled[i] = http_predict(port, [obs[DAEMON_SINGLES + i]])[0]

        threads = [threading.Thread(target=client, args=(i,)) for i in range(DAEMON_POOL)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        metrics = json.loads(http_call(port, "GET", "/metrics")[1])
        health = json.loads(http_call(port, "GET", "/healthz")[1])
        daemon[0].send_signal(signal.SIGINT)
        for proc in daemon:
            proc.stdout.read()
        ranks = wait_ranks(daemon, "daemon-rank", tmp)
        served = wait_ranks(reference, "serve-rank", tmp, name="serve")
    finally:
        for proc in daemon + reference:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    shutil.rmtree(tmp, ignore_errors=True)
    ref = served[0]
    same_singles = all(np.array_equal(np.asarray(getattr(a, f)), ref["singles"][i][f])
                       for i, a in enumerate(singles) for f in ACTION_FIELDS)
    # the batcher's pools hold any subset of the concurrent clients, each
    # row computed alone in the padded forward: the in-process pool's rows
    same_pool = all(np.array_equal(np.asarray(getattr(a, f))[0], ref["pool"][f][i])
                    for i, a in enumerate(pooled) for f in ACTION_FIELDS)
    forwards = 1 + DAEMON_SINGLES + metrics.get("batcher_dispatches", 0)
    want = {k: n * forwards for k, n in INFER.items()}
    heads = all(heads_of(r["shapes"], "tp") for r in ranks)
    codes = [r["code"] for r in ranks]
    ok = (same_singles and same_pool and codes == [0] * MESH_RANKS
          and metrics.get("batcher_requests") == DAEMON_POOL
          and metrics.get("batcher_dispatches", DAEMON_POOL) < DAEMON_POOL
          and health["status"] == "ok"
          and (device == "cpu" or (heads and all(r["launches"] == want for r in ranks))))
    launches = collections.Counter()
    for r in ranks:
        launches.update(r["launches"])
    emit({"phase": "daemon_mesh", "mesh": DAEMON_MESH, "ranks": MESH_RANKS,
          "entry": "bifold_tpu_torch.serve.main --mesh", "dtype": "bfloat16",
          "collectives": "gloo, staged through host memory",
          "actions_equal_in_process_mesh_server": {"singles": same_singles, "pool": same_pool},
          "exit_codes": codes, "requests": metrics.get("requests"),
          "batcher_dispatches": metrics.get("batcher_dispatches"),
          "http_p50_ms_batch_1_host_staged": statistics.median(ms), "http_ms": ms,
          "launches_per_rank": [r["launches"] for r in ranks], "want_per_rank": want,
          "shapes_per_rank": [r["shapes"] for r in ranks],
          "seconds": time.perf_counter() - t0, **card})
    if not ok:
        raise AssertionError("daemon_mesh failed (see its line)")
    return dict(launches)


ADVISE_DEVICES = 8
ADVISE_OVERRIDES = ("model=siglip_sequential", "train_dataset.image_size=384",
                    "train_dataset.is_bimanual=true", "train_dataset.max_context_length=3",
                    "batch_size=8")
ADVISE_TOL = 0.01        # parameter bytes per device against the ranks' held bytes
# an MoE layout: 8 experts in each fusion block, cut over ep = 4 (its
# expert exchange and FLOPs counted at JAX's static capacity)
ADVISE_MOE = ("dp=2,ep=4", "model.moe_experts=8")


def advise_sweep():
    """``python -m bifold_tpu_torch advise n_devices=8`` for the flagship,
    in this process (``bifold_tpu_torch.__main__.main`` with ``--json``;
    fake tensors and a fake group, no card), and the MoE layout of
    :data:`ADVISE_MOE`: (reports, the MoE layout's reports, seconds); a
    sweep that exits non-zero reports one error."""
    import io

    from bifold_tpu_torch.__main__ import main as cli_main

    t0 = time.perf_counter()
    reports = []
    for extra in ((), ADVISE_MOE):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = cli_main(["advise", f"n_devices={ADVISE_DEVICES}", *ADVISE_OVERRIDES,
                             *extra, "--json"])
        reports.append(json.loads(out.getvalue().strip().splitlines()[-1]) if code == 0
                       else [{"mesh": {}, "error": f"exit {code}"}])
    return reports[0], reports[1], time.perf_counter() - t0


def advise_phase(card, swept):
    """The advise sweep's ranked layouts (:func:`advise_sweep`), and the
    ``param_bytes_per_device`` of the layouts whose only sharded axis is
    fsdp = 2 or tp = 2 within :data:`ADVISE_TOL` of what a rank of
    :func:`mesh_two_ranks` holds under ``{fsdp: 2}`` and ``{tp: 2}``
    (:data:`MESH_HELD`); the MoE layout (:data:`ADVISE_MOE`) reported with
    numbers at JAX's static capacity."""
    reports, moe, seconds = swept
    ranked = []
    for r in reports:
        mesh = {k: v for k, v in r["mesh"].items() if v > 1}
        ranked.append({"mesh": mesh, "error": r["error"].splitlines()[0][:160]}
                      if "error" in r else
                      {"mesh": mesh, "ms_lower_bound": r["est"]["step_ms_lower_bound"],
                       "bottleneck": r["est"]["bottleneck"],
                       "param_bytes_per_device": r["param_bytes_per_device"],
                       "opt_state_bytes_per_device": r["opt_state_bytes_per_device"],
                       "wire_bytes_per_device": r["collective_wire_bytes_per_device"],
                       "flops_per_device": r["flops_per_device"],
                       "hbm_bytes_per_device_unfused": r["hbm_bytes_per_device"]})
    checks, ok = {}, any("error" not in r for r in reports)
    for axis in ("fsdp", "tp"):
        report = next((r for r in reports if "error" not in r and
                       {k for k, v in r["mesh"].items() if v > 1} <= {"dp", axis}
                       and r["mesh"][axis] == 2), None)
        held = MESH_HELD.get(axis)
        got = None if report is None else report["param_bytes_per_device"]
        rel = (None if got is None or not held else
               max(abs(got - h) / h for h in held))
        checks[axis] = {"advisor_param_bytes_per_device": got,
                        "mesh_two_ranks_held_param_bytes": held, "max_rel_diff": rel,
                        "layout": None if report is None else
                        {k: v for k, v in report["mesh"].items() if v > 1}}
        ok &= rel is not None and rel <= ADVISE_TOL
    moe_report = moe[0]
    checks["moe"] = {"layout": ADVISE_MOE, "moe_exchange": moe_report.get("moe_exchange"),
                     "error": moe_report.get("error"),
                     **({"ms_lower_bound": moe_report["est"]["step_ms_lower_bound"],
                         "collectives": moe_report["collectives"],
                         "flops_per_device": moe_report["flops_per_device"]}
                        if "est" in moe_report else {})}
    ok &= "error" not in moe_report and moe_report.get("moe_exchange") == "static capacity"
    emit({"phase": "advise", "n_devices": ADVISE_DEVICES, "overrides": ADVISE_OVERRIDES,
          "chip_constants": "H100 80GB HBM3 (SXM) datasheet, 700 W: lower bounds",
          "ranked": ranked, "held_bytes_check": checks, "tol": ADVISE_TOL,
          "seconds": seconds, "while": "mesh_two_ranks' ranks run", **card})
    if not ok:
        raise AssertionError("advise_phase failed (see its line)")


FSDP_PEAK_KEYS = ("peak_gathered_bytes", "whole_fsdp_bytes", "held_param_bytes",
                  "held_bytes", "step_max_memory_allocated_bytes")


def peak_rank_worker(rank, port, out, root, device="cuda"):
    """``python3 chip_smoke.py peak-rank RANK PORT OUT ROOT [DEVICE]``: rank
    ``RANK`` of :data:`MESH_RANKS` in a gloo group on the one card, with
    the package of the checkout at ``ROOT`` (another commit's, to compare):
    :func:`dp_step`'s f32 flagship step under ``{fsdp: 2}``; saves its
    memory figures and metrics to ``OUT/rank<RANK>.pt``."""
    sys.path.insert(0, str(Path(root).resolve()))
    from bifold_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parallel.distributed_init(f"tcp://localhost:{port}", MESH_RANKS, int(rank),
                              device="cuda:0" if device == "cuda" else "cpu",
                              backend="gloo")
    got = dp_step("flagship", device, mesh=MESH_STEPS["fsdp"], optim=MESH_SGD)
    torch.save({k: got.get(k) for k in FSDP_PEAK_KEYS + ("metrics", "launches")},
               Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def fsdp_peak(root=".", device="cuda"):
    """``python3 chip_smoke.py fsdp-peak [ROOT] [DEVICE]``: the memory of
    ``mesh_two_ranks``' f32 flagship step under ``{fsdp: 2}`` for the
    package of the checkout at ``ROOT`` (default: this one), so that
    another commit's figures can be read on the same card: per rank, the
    placement's peak of whole fsdp tensors (None where the package has no
    such counter), what a step that gathers every unit holds of them,
    the bytes held, and ``torch.cuda.max_memory_allocated`` over the step;
    one line of JSON with the card's name and power limit."""
    import shutil

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="bifold_fsdp_peak_"))
    ranks = wait_ranks(spawn_ranks("peak-rank", tmp, str(Path(root).resolve()), device),
                       "peak-rank", tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
           if device == "cuda" else "cpu")
    emit({"phase": "fsdp_peak", "root": str(Path(root).resolve()), "mesh": {"fsdp": 2},
          **{k: [r[k] for r in ranks] for k in FSDP_PEAK_KEYS},
          "loss": [r["metrics"]["loss"] for r in ranks],
          "launches_per_rank": [r["launches"] for r in ranks],
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    return 0


WORKERS = {"softgym-cli": softgym_cli_worker, "host-tools": host_tools_worker,
           "dp-cli": dp_cli_worker,
           "dp-rank": dp_rank_worker, "fsdp-peak": fsdp_peak, "peak-rank": peak_rank_worker,
           "mesh-rank": mesh_rank_worker, "mesh-cli": mesh_cli_worker,
           "axes-rank": axes_rank_worker, "ring-rank": ring_rank_worker,
           "daemon-rank": daemon_rank_worker, "serve-rank": serve_rank_worker}


def serving_phase(server, mode, name, obs_list, p50):
    """What :func:`where_the_time_goes` needs for one served batch."""
    def stages():
        with ln_mode(mode):
            return stage_breakdown(server, obs_list)

    def profile():
        with ln_mode(mode):
            return device_profile(lambda: server.predict_batch(obs_list), p50)

    return {"stages": stages, "profile": profile,
            "where": {"phase": "where_the_time_goes", "batch": name,
                      "ln_mode": mode, "p50_ms": p50}}


def where_the_time_goes(phases):
    """The ``where_the_time_goes`` line of each phase: first every phase's
    synchronised stages (host clock), then every phase's profiler window.
    Once torch.profiler has traced the card, later launches in the process
    cost more host time, so no host-clock measurement may follow it."""
    stages = [phase["stages"]() for phase in phases]
    for phase, stage in zip(phases, stages):
        emit({**phase["where"], **stage, **phase["profile"]()})


def stage_breakdown(server, obs_list, iters: int = 3):
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


def device_profile(call, wall_ms: float, iters: int = 1):
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
    kernels = [e for e in (traces[0] if traces else [])   # device ops, not
               if e.device_type == torch.autograd.DeviceType.CUDA  # step marks
               and not e.key.startswith("ProfilerStep")]

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or 0

    busy = sum(dev_us(e) for e in kernels) / 1e3 / iters
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    if busy <= 0:                        # the profiler saw nothing
        busy = None
    return {"device_busy_ms": busy,
            "device_idle_share": None if busy is None else 1 - busy / wall_ms,
            "device_ops_per_call": sum(e.count for e in kernels) // iters,
            "top_kernels": [{"name": e.key[:80], "calls": e.count // iters,
                             "ms": dev_us(e) / 1e3 / iters} for e in top]}


# the kernel templates in the nvcc symbol names: flash (template, head dim,
# lse flag of the forward); LayerNorm (template, row type, chunks per lane,
# fused flag)
_FLASH_SYMBOL = re.compile(r"(flash_fwd_mma|flash_fwd_tf32|dkdv_mma|dq_mma|"
                           r"dkdv_tf32|dq_tf32)ILi(\d+)E(?:Lb([01])E)?")
_LN_SYMBOL = re.compile(r"(ln_fwd|ln_bwd)_kernelI(13__nv_bfloat16|f)Li(\d)ELb([01])E")


def _ptxas_key(symbol: str):
    """The ``kernels`` line's name of a kernel instance from its symbol, or
    None: flash as ``flash_bwd_d48 (dkdv)``, LayerNorm as ``fused_ln_bwd
    S3`` (S chunks of 8 columns per lane: S = 3 is C = 768); f32 instances
    end in "_f32"."""
    found = _FLASH_SYMBOL.search(symbol)
    if found:
        kernel, d, with_lse = found.groups()
        if kernel.startswith("flash_fwd"):
            key = f"flash_fwd_{'lse' if with_lse == '1' else 'infer'}_d{d}"
        else:
            key = f"flash_bwd_d{d} ({kernel.split('_')[0]})"
        return key + ("_f32" if kernel.endswith("_tf32") else "")
    found = _LN_SYMBOL.search(symbol)
    if found:
        kernel, dtype, slots, fused = found.groups()
        return (f"{'fused_' if fused == '1' else ''}{kernel} S{slots}"
                + ("" if dtype.endswith("bfloat16") else "_f32"))
    return None


def ptxas_of(ptxas, name, dtype):
    """The :func:`ptxas_rows` entries of one kernel instance (the backward
    has two kernels, ``(dkdv)`` and ``(dq)``)."""
    suffix = "" if dtype == torch.bfloat16 else "_f32"
    return {k: v for k, v in ptxas.items()
            if k == name + suffix or (k.startswith(name + " (") and k.endswith(")" + suffix))}


def ptxas_rows(fa) -> dict:
    """Registers, static shared memory (ptxas leaves out 0; the LayerNorm
    backward's is dynamic, sized by C) and spill bytes of every kernel
    instance of every csrc source, from the builds' ``-Xptxas -v`` reports,
    keyed by :func:`_ptxas_key`."""
    rows = {}
    for source in fa.SOURCES:
        row = None
        for line in fa.ptxas_report(source).splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                key = _ptxas_key(entry.group(1))
                row = None if key is None else rows.setdefault(key, {"smem_bytes": 0})
                continue
            if row is None:
                continue
            for field, pattern in (("registers", r"Used (\d+) registers"),
                                   ("smem_bytes", r"(\d+) bytes smem"),
                                   ("spill_store_bytes", r"(\d+) bytes spill stores"),
                                   ("spill_load_bytes", r"(\d+) bytes spill loads")):
                found = re.search(pattern, line)
                if found:
                    row[field] = int(found.group(1))
    return dict(sorted(rows.items()))


def main() -> int:
    started = time.perf_counter()
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
    ptxas = ptxas_rows(fa)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_seconds": time.perf_counter() - t0,
          "built": [os.path.basename(str(p)) for p in libs], "ptxas": ptxas})

    peaks = card_peaks(name)
    marks = [("build", t0), ("checks", time.perf_counter())]

    def mark(phase):                     # each phase's seconds, in one line at the end
        marks.append((phase, time.perf_counter()))

    worst = {**check_kernels(fa), **check_train_kernels(fa), **check_ln_kernels()}
    for key, err in check_decoder_flash(fa).items():
        worst[key] = max(worst.get(key, 0.0), err)
    for dtype in (torch.bfloat16, torch.float32):
        for d in (32, 48):
            check_alignment(fa, d, dtype)
    check_tp_views(fa)
    check_function_grads(fa)
    check_auto_route(fa)
    mark("train_flagship")
    # every main-path run, each with its counts reset just before it and
    # read just after: the train step and the served path, in each
    # LayerNorm mode, the Trainer, deployment, the families, the variants
    # and remat; the checks between them are not counted
    phases = [train_flagship(card, mode) for mode in LN_MODES]
    mark("train_interleaved")
    train_interleaved({phase["mode"]: phase["one_step"] for phase in phases}, card)
    mark("f32_step_equivalence")
    f32_step_equivalence()
    mark("trainer_cli")
    trained, cli_trainer, trainer_p50 = trainer_cli(card, phases[0]["where"]["p50_ms"])
    mark("trainer_pull_ahead")
    pulled = trainer_pull_ahead(card)
    mark("serve_flagship")
    served, serve_phases = serve_flagship(card)
    mark("deployment_phase")
    deployed = deployment_phase(card)
    mark("families")
    family_runs = []
    for family in FAMILIES:
        family_launches, family_phases = serve_family(card, family)
        family_runs.append(family_launches)
        serve_phases += family_phases
    family_runs.append(trainer_cli_families(card))
    mark("variants")
    variant_peaks = {}
    for variant in VARIANTS:
        variant_launches, variant_phases, variant_peaks[variant] = variant_phase(
            card, variant)
        family_runs.append(variant_launches)
        serve_phases += variant_phases
    mark("remat_phase")
    remat, remat_launches = remat_phase(card)
    mark("t5_family")
    t5_phases, t5_trainers = t5_family(card)
    serve_phases += t5_phases
    mark("refused_configs")
    family_runs.append(refused_configs(card))
    # the closed loop: the simulator on the host, the policy on the card
    mark("closed_loop_bimanual")
    loop_launches, loop_profile = closed_loop_bimanual(card)
    # trainer_softgym and host_tools_and_gif each in a process of its own
    # beside closed_loop_unimanual: all three are host work most of the time
    mark("closed_loop_unimanual + trainer_softgym + host_tools_and_gif")
    worker_dir = Path(tempfile.mkdtemp(prefix="bifold_softgym_"))
    softgym_out, gif_out = worker_dir / "launches.json", worker_dir / "host_tools.json"
    softgym = start_worker(card, softgym_out, "softgym-cli")
    try:
        host_tools = start_worker(card, gif_out, "host-tools")
        try:
            unimanual_launches = closed_loop_unimanual(card)
        finally:
            gif_launches = finish_worker(host_tools, gif_out, "host_tools_and_gif")
    finally:
        softgym_launches = finish_worker(softgym, softgym_out, "trainer_softgym")
    # the multi-rank phases, one after the other, at a cut depth
    cut_depth()
    emit({"phase": "cut_depth", "tower_layers": CUT_LAYERS, "fusion_depth": CUT_DEPTH,
          "per_step": PER_STEP, "infer": INFER, "norms": FLAGSHIP_NORMS})
    dp_runs = []
    for phase in (dp_nccl, dp_two_ranks, mesh_two_ranks, mesh_cli, mesh_axes_two_ranks,
                  ring_three_ranks, daemon_mesh):
        mark(phase.__name__)
        dp_runs.append(phase(card))
    mark("where_the_time_goes")
    emit({"phase": "train_peak_memory", "max_memory_allocated_bytes": {
        phase["mode"] or "default": phase["where"]["max_memory_allocated_bytes"]
        for phase in phases}, "variants_trainer_cli_bytes": variant_peaks,
        "remat_f32_step_bytes": {k: v["peak_memory_bytes"] for k, v in remat.items()},
        **card})
    launches = collections.Counter()
    for run in ([phase["launches"] for phase in phases] + [trained, pulled]
                + list(served.values()) + [deployed] + family_runs + [remat_launches]
                + [loop_launches, unimanual_launches, softgym_launches, gif_launches]
                + dp_runs):
        launches.update(run)
    # the profiler from here on: after every host-clock measurement
    where_the_time_goes(phases + serve_phases)
    mark("closed_loop_profile")
    loop_profile()
    mark("trainer_profiles")
    trainer_profile(cli_trainer, card, trainer_p50)
    for enc, t5_trainer, t5_p50 in t5_trainers:
        trainer_profile(t5_trainer, card, t5_p50, f"t5_trainer_device_profile {enc}")
    del t5_trainers
    mark("f32_library_kernels")
    library_names = f32_library_kernels()
    del phases, serve_phases, cli_trainer, t5_trainer
    torch.cuda.empty_cache()
    mark("flash_timings")
    timings = {**time_kernels(fa, peaks), **time_train_kernels(fa, peaks),
               **time_kernels(fa, peaks, torch.float32),
               **time_train_kernels(fa, peaks, torch.float32)}
    mark("ln_timings")
    timings.update(time_ln_kernels(peaks))
    mark("kernels_line")
    for kernel, row in timings.items():
        if kernel in library_names:
            row["library_kernels"] = library_names[kernel].get(row["library_backend"])
        emit({"phase": "kernel_timing", "kernel": kernel, **row})

    sources = {"flash_fwd_infer": ("flash_fwd.cu", 250, "serving: predict"),
               "flash_fwd_lse": ("flash_fwd.cu", 241, "training: train step"),
               "flash_bwd": ("flash_bwd.cu", 360, "training: train step")}
    stacks = {torch.bfloat16: {48: "flagship fusion (16 heads; 8 per tp=2 rank; "
                                   "ring_three_ranks: 791-token chunks)",
                               64: "flagship vision (12 heads; 6 per tp=2 rank; "
                                   "ring_three_ranks: 192-token chunks)",
                               32: "rgb_clip fusion"},
              torch.float32: {48: "f32 flagship fusion (remat_phase, mesh_two_ranks; "
                                  "8 heads per tp=2 rank; mesh_axes_two_ranks: per pp "
                                  "stage and microbatch; ring_three_ranks)",
                              64: "f32 flagship vision (remat_phase, mesh_two_ranks; "
                                  "6 heads per tp=2 rank; mesh_axes_two_ranks: per pp "
                                  "stage and microbatch; ring_three_ranks)",
                              32: "transformer decoder (pick_place_transdecoder)"}}
    # the f32 instances that a main path launches: the transformer
    # decoder's, served and trained, the f32 flagship's, trained in
    # remat_phase and mesh_two_ranks and served in mesh_two_ranks
    f32_on_path = {"flash_fwd_infer": (32, 48, 64), "flash_fwd_lse": (48, 64, 32),
                   "flash_bwd": (48, 64, 32)}
    kernels = []
    for dtype, design in ((torch.bfloat16, "mma.sync bf16"),
                          (torch.float32, "3xTF32 mma.sync m16n8k8, cp.async ring")):
        for kernel, (src, line, where) in sources.items():
            for d, stack in stacks[dtype].items():
                if dtype == torch.float32 and d not in f32_on_path[kernel]:
                    continue
                key = timing_key(f"{kernel}_d{d}", dtype)
                count = launches.get(key.removeprefix("flash_"), 0)
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
                    "library_backend": row["library_backend"], "design": design,
                    **{k: row[k] for k in ("bound_fma_ms", "bound_3xtf32_ms",
                                           "library_kernels") if k in row},
                    "ptxas": ptxas_of(ptxas, f"{kernel}_d{d}", dtype),
                    "shape": row["shape"], "dtype": str(dtype),
                    "where": f"{where}, {stack}"})
    for kernel in LN_KERNELS:
        if launches.get(kernel, 0) == 0:
            raise AssertionError(f"{kernel} never ran on its main path")
        row = timings[f"{kernel}_fusion"]
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": "bifold_tpu_torch/csrc/layer_norm.cu",
            "replaces": f"bifold_tpu/ops/layer_norm.py:{LN_LINES[kernel]}",
            "launches": launches[kernel], "max_abs_err": worst[kernel],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "library_call": row["library_call"],
            "design": LN_DESIGN[kernel.replace("fused_", "")],
            "max_abs_err_f32_c512": worst[f"{kernel}_decoder_f32"],
            "ptxas_bf16_c768": ptxas.get(f"{kernel} S3"),
            "shape": row["shape"], "where": LN_WHERE[kernel]})
    mark("end")
    after = {name: round(b - a, 2) for (name, a), (_, b) in zip(marks, marks[1:])}
    emit({"phase": "phase_seconds", **after, **card})
    emit({"phase": "phase_seconds_recorded_uncut_vs_this_run",
          "recorded_uncut_on": PHASE_SECONDS_UNCUT_CARD, **{
              name: [PHASE_SECONDS_UNCUT.get(name), after.get(name)]
              for name in {**PHASE_SECONDS_UNCUT, **after}}, **card})
    emit({"phase": "script", "seconds": time.perf_counter() - started, **card})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        if os.environ.get(CUT_ENV):
            cut_depth()
        sys.exit(WORKERS[sys.argv[1]](*sys.argv[2:]))
    sys.exit(main())
