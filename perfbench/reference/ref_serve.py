"""The reference's side of a served observation, and the gap of a served
action.

:func:`tokenize` is SigLIP's tokenizer over the configuration's word
vocabulary (``spm_words``: piece "▁word" has id 3 + its index, "</s>" id 1):
lower case, ASCII punctuation dropped, whitespace split, one piece per
word, "</s>" appended, padded with "</s>" to the text length. A word outside
the vocabulary raises: the traffic's sentences are written in it.
:func:`raw_batch` builds the raw record of each observation as a served
caller's host builds it (context frames, latest last, padded with ones to
``max_context_length``) and stacks them.

:func:`action_gaps` judges the actions the server returned against the
reference's logits. A served pixel is right to the degree that the logit
that chose it is close to the reference's best: for a place head the gap is
the reference's largest logit minus its logit at the served pixel; a pick
is snapped to the nearest cloth pixel of the processed mask, so its gap is
the largest logit minus the best logit among the pixels the served one is a
nearest cloth pixel of, ties included (infinite off the cloth). An arm
the server gated off (-1) or on against the reference's decision adds the
reference's margin from deciding otherwise: from the threshold, or from
the other arm's confidence. The gaps are in logits: 0 is an exact
decision.
"""

from __future__ import annotations

import math
import string

import numpy as np
import torch
from scipy import ndimage

import ref_preprocess as preprocess

_PUNCT = str.maketrans("", "", string.punctuation)


def tokenize(cfg: dict, text: str) -> np.ndarray:
    vocab = {w: 3 + i for i, w in enumerate(cfg["spm_words"])}
    length = int(cfg["instruction_ids"]["length"])
    words = text.lower().translate(_PUNCT).split()
    missing = [w for w in words if w not in vocab]
    if missing:
        raise ValueError(f"words outside the configuration's vocabulary: {missing}")
    ids = [vocab[w] for w in words][: length - 1] + [1]
    out = np.full((length,), 1, np.int32)
    out[: len(ids)] = ids
    return out


def raw_batch(cfg: dict, observations) -> dict:
    t = int(cfg.get("max_context_length") or 0)
    raws = []
    for o in observations:
        h, w = o["depth"].shape
        raw = {"rgb": np.asarray(o["rgb"], np.uint8), "depth": np.asarray(o["depth"], np.float32),
               "mask": np.asarray(o["mask"], np.float32),
               "instruction": tokenize(cfg, o["instruction"])}
        if t:
            frames = list(o.get("context") or [])[-t:]
            raw["ctx_depth"] = np.ones((t, h, w), np.float32)
            raw["ctx_mask"] = np.ones((t, h, w), np.float32)
            raw["ctx_rgb"] = np.ones((t, h, w, 3), np.uint8)
            for i, f in enumerate(frames):
                raw["ctx_depth"][i] = f["depth"]
                raw["ctx_mask"][i] = f["mask"]
                raw["ctx_rgb"][i] = f["rgb"]
            raw["ctx_count"] = np.int32(len(frames))
        raws.append(raw)
    batch = {k: np.stack([r[k] for r in raws]) for k in raws[0]}
    batch["label_keys"] = ()
    return batch


def logits(ref, cfg, W, observations, device, prec, block: int) -> tuple:
    """(logits by head, processed masks): numpy (N, S, S), in blocks."""
    out, masks = {}, []
    for i in range(0, len(observations), block):
        sample = preprocess.process(cfg, raw_batch(cfg, observations[i:i + block]), None,
                                    False, device)
        with torch.no_grad():
            got = ref.forward(W, cfg, sample, prec)
        for h, x in got.items():
            out.setdefault(h, []).append(x.float().cpu().numpy())
        masks.append(sample["mask"][:, 0].cpu().numpy())
    return {h: np.concatenate(v) for h, v in out.items()}, np.concatenate(masks)


def _logit(p: float) -> float:
    p = min(max(p, 1e-30), 1 - 1e-7)
    return math.log(p / (1 - p))


def nearest(mask: np.ndarray):
    """For every pixel, the flat index of a nearest cloth pixel and the
    squared distance to it, exact in integers (None without cloth)."""
    if not (mask > 0).any():
        return None
    _, idx = ndimage.distance_transform_edt(mask <= 0, return_indices=True)
    rows, cols = np.indices(mask.shape)
    return {"flat": (idx[0] * mask.shape[1] + idx[1]).reshape(-1),
            "d2": ((rows - idx[0]) ** 2 + (cols - idx[1]) ** 2).reshape(-1),
            "rows": rows.reshape(-1), "cols": cols.reshape(-1)}


def action_gaps(heads, logits_by_head: dict, near, served: np.ndarray,
                threshold: float, bimanual: bool) -> list:
    """The gap of each field of one observation's served action ``served``
    (fields, 2) [x, y], fields in ``heads`` order (module doc); ``near`` is
    :func:`nearest` of its processed mask."""
    gaps, conf, decided = [], {}, {}
    for f, head in enumerate(heads):
        lg = logits_by_head[head]
        best = float(lg.max())
        if head.endswith("pick") and near is not None:
            snapped = int(near["flat"][int(np.argmax(lg))])
            conf[head] = float(lg.reshape(-1)[snapped])
            x, y = served[f]
            if x < 0:
                gaps.append(0.0)
                decided[head] = False
                continue
            w = lg.shape[1]
            if not (0 <= x < w and 0 <= y < lg.shape[0]) or near["d2"][int(y) * w + int(x)]:
                gaps.append(math.inf)                  # off the image or off the cloth
                decided[head] = True
                continue
            # the pixels the served one is a nearest cloth pixel of (ties included)
            sel = (near["rows"] - int(y)) ** 2 + (near["cols"] - int(x)) ** 2 == near["d2"]
            gaps.append(best - float(lg.reshape(-1)[sel].max()))
        else:
            if head.endswith("pick"):
                conf[head] = best
            x, y = served[f]
            if x < 0:
                gaps.append(0.0)
            elif not (0 <= x < lg.shape[1] and 0 <= y < lg.shape[0]):
                gaps.append(math.inf)
            else:
                gaps.append(best - float(lg[int(y), int(x)]))
        decided[head] = served[f][0] >= 0
    if bimanual:
        arms = ("left", "right")
        c = [conf[f"{a}_pick"] for a in arms]
        for i, a in enumerate(arms):
            # an arm acts when its confidence reaches the threshold or the
            # other arm's: the reference's margin from deciding otherwise
            margin = max(c[i] - _logit(threshold), c[i] - c[1 - i])
            if (margin >= 0) != decided[f"{a}_pick"]:
                gaps.append(abs(margin))
    return gaps


def decode(heads, logits_by_head: dict, near, threshold: float, bimanual: bool) -> np.ndarray:
    """One observation's action from its logits, as the served decode
    rules it: the argmax (first on ties), a pick snapped to its nearest
    cloth pixel with its confidence read there, and, bimanual, an arm
    acting when its pick confidence reaches the threshold or beats the
    other's (-1 for an idle arm's fields). (fields, 2) [x, y]."""
    out, conf = [], {}
    for head in heads:
        lg = logits_by_head[head]
        flat = int(np.argmax(lg))
        if head.endswith("pick") and near is not None:
            flat = int(near["flat"][flat])
        conf[head] = float(lg.reshape(-1)[flat])
        out.append([flat % lg.shape[1], flat // lg.shape[1]])
    out = np.asarray(out, np.float32)
    if bimanual:
        c = [conf["left_pick"], conf["right_pick"]]
        for i, arm in enumerate(("left", "right")):
            winner = (i == 0 and c[0] >= c[1]) or (i == 1 and c[1] > c[0])
            if not (c[i] >= _logit(threshold) or winner):
                for f, head in enumerate(heads):
                    if head.startswith(arm):
                        out[f] = -1.0
    return out
