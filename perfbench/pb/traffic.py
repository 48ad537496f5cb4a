"""The one traffic generator: a mix's parameters and a seed -> raw inputs.

A mix (``traffic/<mix>.json``) is data: its ``entry`` names the driver
that consumes what this module makes. Two shapes of input are made here.

- ``train_batches``: collated raw train batches as the data loader hands
  them to ``Processor.process_batch`` (uint8 frames at ``frame_px``, float
  depth, a {0, 1} cloth mask, context frames padded to the configuration's
  ``max_context_length`` with ones, ``ctx_count``, label pixels padded to 8
  points with -1, instruction ids in the configuration's
  ``instruction_ids`` layout) and the spatial-augmentation trials each
  batch's ``draws`` hand in;
- ``observations``: a pool of camera observations as a served caller sends
  them (uint8 frame at ``camera_px``, float depth, a {0, 1} cloth mask, a
  list of context frames, an instruction drawn from the mix's sentences).

Every batch and every pool has the same multiset of sizes for every seed
(``context_counts`` is cycled to fill it, then shuffled by the seed), so the
seed changes the values and the order, never the amount of work. Pixels
are drawn on a generator of ``device`` seeded from the run's seed.
"""

from __future__ import annotations

import numpy as np
import torch

_MAX_LABEL_POINTS = 8


def sub_seed(seed: int, what: str) -> int:
    """A seed for one use of the run's seed (weights, traffic, draws...)."""
    h = 1469598103934665603
    for ch in what.encode():
        h = ((h ^ ch) * 1099511628211) % 2 ** 64
    return (int(seed) * 6364136223846793005 + h) % 2 ** 63


def _counts(mix: dict, n: int, gen: torch.Generator) -> list:
    base = list(mix.get("context_counts") or [0])
    counts = [base[i % len(base)] for i in range(n)]
    order = torch.randperm(n, generator=gen).tolist()
    return [counts[i] for i in order]


def _frames(gen, device, n: int, px: int, mix: dict):
    """n frames: uint8 rgb, depth in ``depth``, a cloth box of ``cloth_px``
    at a random offset; numpy on the host."""
    rgb = torch.randint(0, 256, (n, px, px, 3), generator=gen, device=device,
                        dtype=torch.uint8)
    lo, hi = mix["depth"]
    depth = lo + (hi - lo) * torch.rand((n, px, px), generator=gen, device=device)
    box = int(mix["cloth_px"])
    top = torch.randint(0, px - box + 1, (n,), generator=gen, device=device)
    left = torch.randint(0, px - box + 1, (n,), generator=gen, device=device)
    ar = torch.arange(px, device=device)
    rows = (ar[None] >= top[:, None]) & (ar[None] < top[:, None] + box)
    cols = (ar[None] >= left[:, None]) & (ar[None] < left[:, None] + box)
    mask = (rows[:, :, None] & cols[:, None, :]).float()
    return rgb.cpu().numpy(), depth.cpu().numpy(), mask.cpu().numpy()


def _instruction_ids(gen, layout: dict, words: tuple, n: int) -> np.ndarray:
    length = int(layout["length"])
    lo, hi = layout["word_ids"]
    out = np.full((n, length), int(layout["pad"]), np.int32)
    sizes = torch.randint(int(words[0]), int(words[1]) + 1, (n,), generator=gen).tolist()
    for i, k in enumerate(sizes):
        ids = torch.randint(int(lo), int(hi) + 1, (k,), generator=gen).tolist()
        seq = ([layout["start"]] if layout.get("start") is not None else []) + ids + [layout["end"]]
        out[i, : len(seq)] = seq[:length]
    return out


def train_batches(mix: dict, cfg: dict, seed: int, device) -> list:
    """``mix["distinct_batches"]`` raw train batches, each (raw, draws)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "traffic"))
    cpu_gen = torch.Generator().manual_seed(sub_seed(seed, "traffic.host"))
    b, px = int(mix["batch"]), int(mix["frame_px"])
    t = int(cfg.get("max_context_length") or 0)
    keys = tuple(cfg["label_keys"])
    trials = int(cfg["processor"]["spatial_augmentations"]["max_augmentation_trials"])
    rot = cfg["processor"]["spatial_augmentations"]["rotate_augmentation"]
    move = cfg["processor"]["spatial_augmentations"]["translate_augmentation"]
    out = []
    for _ in range(int(mix["distinct_batches"])):
        rgb, depth, mask = _frames(gen, device, b, px, mix)
        raw = {"rgb": rgb, "depth": depth, "mask": mask}
        if t:
            counts = _counts(mix, b, cpu_gen)
            crgb, cdepth, cmask = _frames(gen, device, b * t, px, mix)
            crgb, cdepth, cmask = (a.reshape(b, t, *a.shape[1:]) for a in (crgb, cdepth, cmask))
            for i, c in enumerate(counts):      # padding slots hold ones, as make_raw pads
                crgb[i, c:], cdepth[i, c:], cmask[i, c:] = 1, 1.0, 1.0
            raw.update(ctx_rgb=crgb, ctx_depth=cdepth, ctx_mask=cmask,
                       ctx_count=np.asarray(counts, np.int32))
        raw["label_keys"] = keys
        lo, hi = mix["label_px"]
        for k in keys:
            lab = -np.ones((b, _MAX_LABEL_POINTS, 2), np.float32)
            pts = lo + (hi - lo) * torch.rand((b, int(mix["label_points"]), 2), generator=gen,
                                              device=device)
            lab[:, : pts.shape[1]] = pts.cpu().numpy()
            raw[k] = lab
        raw["instruction"] = _instruction_ids(cpu_gen, cfg["instruction_ids"],
                                              mix["instruction_words"], b)

        def uniform(rng):
            return rng[0] + (rng[1] - rng[0]) * torch.rand((b, trials), generator=gen,
                                                           device=device)
        draws = {"angles": uniform(rot), "dxs": uniform(move), "dys": uniform(move)}
        out.append((raw, draws))
    return out


def observations(mix: dict, seed: int, device) -> list:
    """``mix["pool"]`` observations for ``predict_batch``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "traffic"))
    cpu_gen = torch.Generator().manual_seed(sub_seed(seed, "traffic.host"))
    n, px = int(mix["pool"]), int(mix["camera_px"])
    counts = _counts(mix, n, cpu_gen)
    rgb, depth, mask = _frames(gen, device, n + sum(counts), px, mix)
    texts = mix["instructions"]
    picks = torch.randint(0, len(texts), (n,), generator=cpu_gen).tolist()
    out, at = [], n
    for i, c in enumerate(counts):
        ctx = [dict(rgb=rgb[j], depth=depth[j], mask=mask[j]) for j in range(at, at + c)]
        at += c
        out.append(dict(rgb=rgb[i], depth=depth[i], mask=mask[i], context=ctx,
                        instruction=texts[picks[i]]))
    return out
