"""Partition builder CLI: mined per-category actions -> train/test CSVs.

The port's copy of bifold_tpu/data/create_dataset_partitions.py
(``get_frame`` :27, ``create_context`` :40, ``main`` :58), a counterpart
of the reference's create_dataset_partitions.py: mines (or reloads) each
category's actions dataframe, drops bad sequences, computes per-frame
context lists (all earlier action-start frames of the same capture
sequence), shuffles and splits 90/10. It writes ``<category>_actions.csv``,
``train.csv`` and ``test.csv`` byte-equal to the JAX package's with the same
``--seed``: the categories in ``os.listdir`` order, one
``random.Random(seed)`` for the mining draws and then each category's
shuffle, in the JAX package's order (there the global ``random``, seeded
once). A cached category CSV is re-read by ``pd.read_csv`` as there (its
index column comes back as ``Unnamed: 0``, an absent arm as NaN).

Usage: python -m bifold_tpu_torch.data.create_dataset_partitions \
    --actions_path <dataset>/actions [--train_portion 0.9] \
    [--remove_bad_sequences | --no-remove_bad_sequences] [--seed 42]
"""

from __future__ import annotations

import argparse
import os
import random

import pandas as pd

from bifold_tpu_torch.data.vr_folding import create_groups_df
from bifold_tpu_torch.data.zarr_lite import open_group

__all__ = ["get_frame", "create_context", "main"]


def get_frame(action) -> str:
    """Start frame of a joint action: the earlier arm's start
    (reference create_dataset_partitions.py:14-33)."""
    lval, rval = action["left_start_idx"], action["right_start_idx"]
    l_idx = int(str(lval).split("_")[-1]) if isinstance(lval, str) else None
    r_idx = int(str(rval).split("_")[-1]) if isinstance(rval, str) else None
    if l_idx is None:
        return rval
    if r_idx is None:
        return lval
    return lval if l_idx <= r_idx else rval


def create_context(frames) -> list:
    """Per-frame context: earlier action frames of the same sequence prefix
    (reference :36-55)."""
    grouped: dict = {}
    for frame in frames:
        *prefix, idx = frame.split("_")
        grouped.setdefault("_".join(prefix), []).append(idx)
    for k in grouped:
        grouped[k] = sorted(grouped[k])
    context = []
    for frame in frames:
        *prefix, idx = frame.split("_")
        prefix = "_".join(prefix)
        seq_idx = grouped[prefix].index(idx)
        context.append([prefix + "_" + c for c in grouped[prefix][:seq_idx]])
    return context


def main(args) -> None:
    rng = random.Random(args.seed)
    zarr_root = os.path.join(args.actions_path, os.pardir, "vr_folding_dataset.zarr")
    categories = [c for c in os.listdir(zarr_root)
                  if os.path.isdir(os.path.join(zarr_root, c))]

    dfs = {}
    for category in categories:
        df_file = os.path.join(args.actions_path, category + "_actions.csv")
        if os.path.isfile(df_file):
            dfs[category] = pd.read_csv(df_file)
        else:
            root = open_group(os.path.join(zarr_root, category))
            dfs[category] = create_groups_df(root["samples"], rng)
            dfs[category].to_csv(df_file)

    train_indices, test_indices = {}, {}
    removed = total = 0
    for category in categories:
        n = len(dfs[category])
        total += n
        if args.remove_bad_sequences:
            indices = list((~dfs[category]["bad_sequence"]).to_numpy().nonzero()[0])
            removed += n - len(indices)
        else:
            indices = list(range(n))
        rng.shuffle(indices)
        split = int(len(indices) * args.train_portion)
        train_indices[category] = indices[:split]
        test_indices[category] = indices[split:]

        frames = [get_frame(a) for _, a in dfs[category].iterrows()]
        dfs[category].insert(len(dfs[category].columns), "context",
                             create_context(frames))

    pd.concat([dfs[c].iloc[train_indices[c]] for c in categories],
              ignore_index=True).to_csv(os.path.join(args.actions_path, "train.csv"))
    pd.concat([dfs[c].iloc[test_indices[c]] for c in categories],
              ignore_index=True).to_csv(os.path.join(args.actions_path, "test.csv"))
    if total:
        print(f"Filtered out {removed}/{total} actions "
              f"({removed / total * 100:.2f}%)")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--actions_path", type=str, required=True)
    parser.add_argument("--train_portion", type=float, default=0.9)
    parser.add_argument("--remove_bad_sequences",
                        action=argparse.BooleanOptionalAction, default=True)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args()
    os.makedirs(args.actions_path, exist_ok=True)
    main(args)
