"""A kernel family's share of its roofline in a traced window.

The numerator adds the least time of every launch of the listed kinds that
``ops/flash_attention.py:SHAPES`` counted in the window (the benchmark
clears it at the window's start): ``pb/work.py:flash_launch`` gives each
launch's operations and bytes from q's shape and the keys its rows attend,
``bound`` their least time at the card's peaks. Launches at the
configuration's masked head dim attend the keys the window's batches kept,
the step's sum of ``key_mask`` base plus per-frame keys (``flash_kept_per_step``);
the others attend every key. The denominator is the profiler's device time
of the kernels whose names contain one of the listed names. Nothing found
on either side gives None, never 0.
"""

from __future__ import annotations

from pb.work import bound, card_peaks, flash_launch


def share(record: dict, kinds, kernels):
    shapes = record.get("flash_shapes") or []
    kernel_s = sum(t for name, t in (record.get("kernel_s") or {}).items()
                   if any(k in name for k in kernels))
    if not shapes or kernel_s <= 0:
        return None
    peaks = card_peaks(record.get("card", ""))
    kept = record.get("flash_kept_per_step") or []
    steps = len(kept)
    least = 0.0
    for key, shape, count in shapes:
        f32 = key.endswith("_f32")
        base = key[: -len("_f32")] if f32 else key
        kind, d = base.rsplit("_d", 1)
        if kind not in kinds:
            continue
        dtype = "float32" if f32 else "bfloat16"
        b, n = int(shape[0]), int(shape[1])
        masked = int(d) == record.get("key_mask_dim") and steps
        if masked:
            per_step = count / steps
            for kept_sum in kept:
                flops, nbytes = flash_launch(kind, shape, kept_sum, True, dtype)
                least += per_step * bound(flops, nbytes, peaks, dtype)[0]
        else:
            flops, nbytes = flash_launch(kind, shape, b * n, False, dtype)
            least += count * bound(flops, nbytes, peaks, dtype)[0]
    if least <= 0:
        return None
    return 100.0 * least / kernel_s
