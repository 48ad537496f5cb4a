"""Operations and bytes: the model's work per sample and each flash launch's
least time on the card.

The peaks are NVIDIA's data-sheet numbers (dense, no sparsity) at the full
power limit: bf16 tensor-core rate, HBM rate, f32 CUDA-core rate, dense TF32
tensor-core rate. ``bound`` is max(operations / peak, bytes / HBM rate).

Model work (``sample_flops``) is counted from the configuration's ``work``
section alone, whatever implements it: a transformer stack is
2 x tokens x (4 w^2 + 2 w mlp) per layer for its projections and MLP plus
4 x tokens x kept keys x w for q.k and p.v; a dense entry is 2 m k n.
``passes`` says what the train step does with each: 1 the forward only, 2
the forward and the activation gradients (a frozen tower under trainable
LoRA adapters, or a trainable layer whose input needs no gradient), 3 the
forward and both gradients. LoRA adapters add their own 2 m (k r + r n)
per target with 3 passes. Recomputation is never counted.
"""

from __future__ import annotations

PEAKS = {"PCIe": (756e12, 2.0e12, 51e12, 378e12),
         "NVL": (835e12, 3.9e12, 60e12, 417e12),
         "H200": (989e12, 4.8e12, 67e12, 495e12),
         "H100": (989e12, 3.35e12, 67e12, 495e12)}


def card_peaks(name: str):
    """(bf16 FLOP/s, HBM B/s, f32 FLOP/s, TF32 FLOP/s) of the card named
    ``name`` (``torch.cuda.get_device_name``)."""
    for key in ("PCIe", "NVL", "H200"):
        if key in name:
            return PEAKS[key]
    return PEAKS["H100"]


def bound(flops: float, nbytes: float, peaks, dtype: str = "bfloat16"):
    """(seconds, "operations" or "bytes"): the least time of ``flops``
    operations moving ``nbytes`` bytes. float32 work counts the faster of
    FMA on the CUDA cores and 3xTF32 on the tensor cores."""
    bytes_s = nbytes / peaks[1]
    if dtype == "bfloat16":
        ops_s = flops / peaks[0]
    else:
        ops_s = min(flops / peaks[2], 3 * flops / peaks[3])
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def _kept(keys, context_frames: int) -> int:
    if isinstance(keys, int):
        return keys
    return int(keys["base"]) + int(keys["per_context_frame"]) * context_frames


def stack_flops(stack: dict, context_frames: int) -> float:
    """Forward FLOPs of one instance of a transformer stack."""
    n, w, mlp = int(stack["tokens"]), int(stack["width"]), int(stack["mlp"])
    kept = _kept(stack.get("keys", n), context_frames)
    per_layer = 2.0 * n * (4 * w * w + 2 * w * mlp) + 4.0 * n * kept * w
    return per_layer * int(stack["depth"])


def lora_flops(stack: dict) -> float:
    """Forward FLOPs of one instance's LoRA adapters."""
    lora = stack.get("lora")
    if not lora:
        return 0.0
    n, w, r = int(stack["tokens"]), int(stack["width"]), int(lora["rank"])
    return 2.0 * n * (w * r + r * w) * int(lora["targets"]) * int(stack["depth"])


def sample_flops(work: dict, context_frames: int, train: bool) -> float:
    """Model FLOPs of one sample with ``context_frames`` context frames, for
    a train step (``train``: each entry times its ``passes``) or a forward."""
    total = 0.0
    for stack in work.get("stacks", ()):
        inst = _instances(stack, context_frames)
        passes = int(stack["passes"]) if train else 1
        total += inst * passes * stack_flops(stack, context_frames)
        total += inst * (3 if train else 1) * lora_flops(stack)
    for dense in work.get("dense", ()):
        inst = _instances(dense, context_frames)
        passes = int(dense["passes"]) if train else 1
        total += inst * passes * 2.0 * dense["m"] * dense["k"] * dense["n"]
    return total


def _instances(entry: dict, context_frames: int) -> int:
    inst = entry.get("per_sample", 1)
    if inst == "frames":               # the current frame and every context slot
        return 1 + int(entry["context_slots"])
    return int(inst)


def flash_launch(kind: str, shape, kept_sum: float, mask: bool,
                 dtype: str = "bfloat16"):
    """(FLOPs, bytes) of one flash launch of ``kind`` (``fwd_infer``,
    ``fwd_lse`` or ``bwd``) on q of ``shape`` (B, N, H, D), whose rows
    attend ``kept_sum`` keys summed over the batch (B x N unmasked). Each
    input byte is read once and each output byte written once: q, k, v, out
    (and lse, the mask) forward; q, k, v, out, dout in, dq, dk, dv out (and
    lse, the mask) backward."""
    b, n, h, d = (int(x) for x in shape)
    size = 2 if dtype == "bfloat16" else 4
    act = b * n * h * d * size
    mask_bytes = 4 * b * n if mask else 0
    lse_bytes = 4 * b * h * n
    if kind == "fwd_infer":
        return 4.0 * h * n * kept_sum * d, 4 * act + mask_bytes
    if kind == "fwd_lse":
        return 4.0 * h * n * kept_sum * d, 4 * act + mask_bytes + lse_bytes
    if kind == "bwd":
        return 10.0 * h * n * kept_sum * d, 8 * act + mask_bytes + lse_bytes
    raise ValueError(f"unknown flash launch kind {kind!r}")
