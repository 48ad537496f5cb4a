"""Bimanual action mining: grip-vertex streams -> pick/place actions + text.

The port's copy of bifold_tpu/data/vr_folding.py (``PPAction`` :29,
``filter_bad_meshes`` :54, ``nocs_to_text`` :85, ``get_text_location``
:107, ``clean_actions`` :162, ``add_actions_to_dataset`` :205,
``segment_grip_streams`` :247, ``create_groups_df`` :297), a counterpart of
the reference's vr_folding_utils.py (minus the plotly debugging figures):
segments per-frame left/right grip-vertex ids into PPActions, filters
fast/small actions and time-aligns the two arms into joint actions, infers
instruction text from NOCS canonical coordinates by majority vote with
opposite-side heuristics, flags bad source meshes via the edge-length
z-score test (on raw face edges, the simulator's own edge extraction), and
assembles the actions dataframe. The partition-builder CLI lives in
:mod:`bifold_tpu_torch.data.create_dataset_partitions`.

How the port differs: the JAX package draws the instruction templates with
the global ``random.choice``; the port draws them from the
``random.Random`` passed in (``rng``), in the same order, so
``random.Random(s)`` here gives the texts that ``random.seed(s)`` gives
there. pandas is imported by this module (and the partition builder) only:
these are offline host tools.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from bifold_tpu_torch.data.templates import folding_actions, opposite_locations
from bifold_tpu_torch.env.sim import _edges_from_faces

__all__ = ["PPAction", "filter_bad_meshes", "nocs_to_text", "get_text_location",
           "clean_actions", "add_actions_to_dataset", "create_groups_df",
           "segment_grip_streams"]


class PPAction:
    """One contiguous grasp: start/end frames, grip-vertex ids over time, and
    grip world positions over time."""

    def __init__(self):
        self.start_idx: Optional[str] = None
        self.end_idx: Optional[str] = None
        self.start_mesh: Optional[np.ndarray] = None
        self.end_mesh: Optional[np.ndarray] = None
        self.world_trajectory: List[np.ndarray] = []
        self.vertex_trajectory: List[np.ndarray] = []
        self.counts: List[int] = []

    def __repr__(self):
        return f"Pick {self.start_idx} and place {self.end_idx}"


def filter_bad_meshes(vertices, nocs_vertices, faces, method: str = "zscore",
                      max_edge_length: float = 0.07,
                      max_edge_length_ratio: float = 80,
                      zscore_ratio: float = 3.5) -> bool:
    """True when the tracked mesh is corrupted: its longest edge is an outlier
    relative to the (clean) NOCS mesh's edge distribution."""
    faces = np.asarray(faces)
    edges = _edges_from_faces(faces)
    vertices = np.asarray(vertices)
    lengths = np.linalg.norm(vertices[edges[:, 0]] - vertices[edges[:, 1]], axis=-1)
    if method == "length":
        return not np.all(lengths < max_edge_length)
    if method == "ratio":
        return bool(lengths.max() / lengths.min() >= max_edge_length_ratio)
    if method == "zscore":
        nocs = np.asarray(nocs_vertices)
        nocs_lengths = np.linalg.norm(nocs[edges[:, 0]] - nocs[edges[:, 1]], axis=-1)
        z = (lengths.max() - lengths.mean()) / lengths.std()
        z_nocs = (nocs_lengths.max() - nocs_lengths.mean()) / nocs_lengths.std()
        return bool(z / z_nocs >= zscore_ratio)
    raise NotImplementedError(f"Method {method} not recognized")


def _aggregate_text(a: Optional[str], b: Optional[str]) -> Optional[str]:
    if a is None:
        return b
    if b is None or a == b:
        return a
    return None


def nocs_to_text(action: Optional[PPAction], action_type: str, nocs_vertices,
                 x_thresh: float = 0.5, z_thresh: float = 0.5):
    """Left/right + top/bottom of an action endpoint from NOCS coordinates,
    by majority vote over the gripped vertices (reference :323-349). Place
    endpoints are located by matching the final grip world position against
    the start-time mesh."""
    if action is None:
        return None, None, None
    if action_type == "pick":
        vertex_index = np.asarray(action.vertex_trajectory[0])
    else:
        vertex_index = np.linalg.norm(
            action.start_mesh[:, None, :] - action.world_trajectory[-1], axis=-1
        ).argmin(axis=0)
    nocs = np.asarray(nocs_vertices)
    lr = ("left" if (nocs[vertex_index, 0] >= x_thresh).sum() > len(vertex_index) // 2
          else "right")
    tb = ("top" if (nocs[vertex_index, -1] >= z_thresh).sum() > len(vertex_index) // 2
          else "bottom")
    return lr, tb, vertex_index


def get_text_location(action_l, action_r, nocs_vertices, category: str):
    """Resolve (pick, place) location words for a joint action; tshirt picks
    in the top corners are sleeves (reference :352-427)."""
    is_sleeve = False
    info = ""
    action_text: Dict[str, Optional[str]] = {}

    for action_type in ("pick", "place"):
        l_lr, l_tb, _ = nocs_to_text(action_l, action_type, nocs_vertices)
        r_lr, r_tb, _ = nocs_to_text(action_r, action_type, nocs_vertices)
        lr = _aggregate_text(l_lr, r_lr)
        tb = _aggregate_text(l_tb, r_tb)
        if lr:
            if tb:
                if action_type == "place":
                    if action_text["pick"] == lr:
                        action_text[action_type] = tb
                    elif action_text["pick"] == tb:
                        action_text[action_type] = lr
                    elif action_text["pick"] == opposite_locations[lr]:
                        action_text[action_type] = lr
                    elif action_text["pick"] == opposite_locations[tb]:
                        action_text[action_type] = tb
                    else:
                        action_text[action_type] = tb + " " + lr
                else:
                    if category == "tshirt" and tb == "top":
                        action_text[action_type] = lr
                        is_sleeve = True
                        action_text["place"] = None
                        break
                    action_text[action_type] = tb + " " + lr
            else:
                action_text[action_type] = lr
        elif tb:
            action_text[action_type] = tb
        else:
            info += "Using heuristics."
            if action_type == "place":
                pick_text = action_text["pick"]
                if pick_text in opposite_locations:
                    action_text[action_type] = opposite_locations[pick_text]
                else:
                    action_text[action_type] = " ".join(
                        opposite_locations[w] for w in pick_text.split())
            else:
                raise ValueError(
                    "Combination of NOCS pick coordinates not supported for "
                    f"{action_l} {action_r}")
    pick, place = action_text["pick"], action_text["place"]
    if pick == place:
        info += "Same pick and place location."
    return pick, place, is_sleeve, info


def clean_actions(pp_actions_l: List[PPAction], pp_actions_r: List[PPAction],
                  fast_action_threshold: int = 5,
                  small_action_threshold: float = 0.1):
    """Drop too-fast/too-small grasps, then align left/right grasps that
    overlap in time into joint actions (reference :491-549)."""

    def keep(actions):
        return [a for a in actions
                if len(a.counts) > fast_action_threshold
                and np.linalg.norm(np.asarray(a.world_trajectory[-1])
                                   - np.asarray(a.world_trajectory[0]))
                > small_action_threshold]

    clean_l, clean_r = keep(pp_actions_l), keep(pp_actions_r)
    aligned_l: List[Optional[PPAction]] = []
    aligned_r: List[Optional[PPAction]] = []
    i = j = 0
    while i < len(clean_l) or j < len(clean_r):
        if i >= len(clean_l):
            aligned_l.append(None)
            aligned_r.append(clean_r[j])
            j += 1
        elif j >= len(clean_r):
            aligned_l.append(clean_l[i])
            aligned_r.append(None)
            i += 1
        elif set(clean_l[i].counts) & set(clean_r[j].counts):
            aligned_l.append(clean_l[i])
            aligned_r.append(clean_r[j])
            i += 1
            j += 1
        elif clean_l[i].counts[0] < clean_r[j].counts[0]:
            aligned_l.append(clean_l[i])
            aligned_r.append(None)
            i += 1
        else:
            aligned_l.append(None)
            aligned_r.append(clean_r[j])
            j += 1
    assert len(aligned_l) == len(aligned_r)
    return aligned_l, aligned_r


def add_actions_to_dataset(pp_actions_l, pp_actions_r, category: str,
                           actions: Dict[str, list], nocs_vertices, is_bad: Dict,
                           rng: random.Random):
    """Phrase + append each aligned joint action (reference :430-488); one
    template draw from ``rng`` per action."""
    pp_actions_l, pp_actions_r = clean_actions(pp_actions_l, pp_actions_r)
    for action_l, action_r in zip(pp_actions_l, pp_actions_r):
        bad_sequence = False
        pick, place, is_sleeve, info = get_text_location(
            action_l, action_r, nocs_vertices, category)
        one_arm = None
        if action_l is None:
            one_arm = " only using the right arm."
        elif action_r is None:
            one_arm = " only using the left arm."
        if category == "tshirt" and is_sleeve:
            text = rng.choice(folding_actions["sleeves"]).format(which=pick)
        elif pick == place:
            text = rng.choice(folding_actions["refine"]).format(
                garment=category, which=pick)
        else:
            text = rng.choice(folding_actions["fold"]).format(
                garment=category, which1=pick, which2=place)
        if one_arm is not None:
            text = text.replace(".", one_arm)

        for arm, action in (("left", action_l), ("right", action_r)):
            if action is not None:
                actions[f"{arm}_start_idx"].append(action.start_idx)
                actions[f"{arm}_grip_from"].append(
                    np.asarray(action.vertex_trajectory[0]).tolist())
                actions[f"{arm}_grip_to"].append(
                    np.asarray(action.vertex_trajectory[-1]).tolist())
                actions[f"{arm}_end_idx"].append(action.end_idx)
                bad_sequence |= is_bad.get(action.start_idx, False)
                bad_sequence |= is_bad.get(action.end_idx, False)
            else:
                for col in ("start_idx", "grip_from", "grip_to", "end_idx"):
                    actions[f"{arm}_{col}"].append(None)
        actions["text"].append(text)
        actions["bad_sequence"].append(bad_sequence)
        actions["info"].append(info)


def segment_grip_streams(samples_group, frame_keys: List[str]):
    """Walk ordered frames of one instance, opening/closing a PPAction per arm
    whenever its grip-vertex stream toggles on/off (reference :109-177).

    Returns (pp_actions_l, pp_actions_r, nocs_vertices, is_bad).
    """
    pp_l: List[PPAction] = []
    pp_r: List[PPAction] = []
    curr = {"l": PPAction(), "r": PPAction()}
    prev = {"l": -1, "r": -1}
    prev_index = None
    nocs_vertices = None
    is_bad: Dict[str, bool] = {}

    for count, index in enumerate(frame_keys):
        sample = samples_group[index]
        mesh = sample["mesh"]
        verts = np.asarray(mesh["cloth_verts"])
        is_bad[index] = filter_bad_meshes(
            vertices=verts,
            nocs_vertices=np.asarray(mesh["cloth_nocs_verts"]),
            faces=np.asarray(mesh["cloth_faces_tri"]))
        if nocs_vertices is None:
            nocs_vertices = np.asarray(mesh["cloth_nocs_verts"])
        grips = {
            "l": np.asarray(sample["grip_vertex_id"]["left_grip_vertex_id"]),
            "r": np.asarray(sample["grip_vertex_id"]["right_grip_vertex_id"]),
        }
        for arm, done in (("l", pp_l), ("r", pp_r)):
            grip = grips[arm]
            if grip[0] != -1 and prev[arm] == -1:
                curr[arm].start_idx = index
                curr[arm].start_mesh = verts
                curr[arm].vertex_trajectory.append(grip)
                curr[arm].world_trajectory.append(verts[grip])
                curr[arm].counts.append(count)
            elif grip[0] == -1 and prev[arm] != -1:
                curr[arm].end_idx = prev_index
                done.append(curr[arm])
                curr[arm] = PPAction()
            elif grip[0] != -1 and prev[arm] != -1:
                curr[arm].vertex_trajectory.append(grip)
                curr[arm].world_trajectory.append(verts[grip])
                curr[arm].counts.append(count)
            prev[arm] = grip[0]
        prev_index = index

    return pp_l, pp_r, nocs_vertices, is_bad


def create_groups_df(samples_group, rng: random.Random) -> pd.DataFrame:
    """Full mining pass over a category's samples group -> actions dataframe
    (reference :76-196); the templates are drawn from ``rng``."""
    rows = {}
    for key in samples_group.keys():
        attrs = samples_group[key].attrs
        rows[key] = dict(attrs.asdict() if hasattr(attrs, "asdict") else attrs)
    df = pd.DataFrame(data=list(rows.values()), index=list(rows.keys()))
    df["group_key"] = df.index

    actions: Dict[str, list] = {k: [] for k in (
        "left_start_idx", "left_grip_from", "left_grip_to", "left_end_idx",
        "right_start_idx", "right_grip_from", "right_grip_to", "right_end_idx",
        "text", "bad_sequence", "info")}

    for instance_id, df_instance in df.groupby("instance_id"):
        categories = df_instance["garment_name"].unique()
        assert len(categories) == 1, "Non-unique garment name in instance"
        category = categories[0].lower()
        frame_keys = list(df_instance.sort_values("sample_id").index)
        pp_l, pp_r, nocs_vertices, is_bad = segment_grip_streams(
            samples_group, frame_keys)
        try:
            add_actions_to_dataset(pp_l, pp_r, category, actions,
                                   nocs_vertices, is_bad, rng)
        except ValueError as e:
            print(f"Ignoring {instance_id} due to {e}.")

    return pd.DataFrame(data=actions)
