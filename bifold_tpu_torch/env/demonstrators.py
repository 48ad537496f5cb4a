"""Task oracles: scripted fold actions + language instruction pools.

The port's copy of bifold_tpu/env/demonstrators.py, a counterpart of the
reference's softgym_demonstrators.py (CornerFold,
TriangleFold, StraightFold, TshirtFold, TrousersFold). The *action tables* —
which keypoint indices are picked/placed, per-step gamma overshoot, speeds and
lift heights — match the reference exactly (they define the tasks:
softgym_demonstrators.py:79-84, 285-297, 487-494, 763-775, 965-985). The
paraphrase pools are our own writing with the same structure: a large "seen"
pool + a small held-out "unseen" pool per template slot, and position-word
paraphrase sets, supporting the three eval regimes (seen instruction /
unseen instruction / unseen task).

Keypoint index conventions:
- square/rect cloth: 3x3 grid 0..8 (corners 0/2/6/8, edge mids 1/3/5/7,
  center 4) from ClothEnv.get_square_keypoints_idx;
- tshirt (8): 0,1 = left/right shoulder, 2 = left sleeve, 3 = left chest,
  4 = right chest, 5 = right sleeve, 6,7 = left/right hem;
- trousers (8): 0..3 = waist left->right, 4..7 = hem left->right.

How the port differs: the JAX package draws the instructions from Python's
global, unseeded ``random`` module, so its draws cannot be reproduced from
an evaluator's seed. Here each demonstrator draws from the
``random.Random`` it is given (``rng``), which the evaluators seed from
their ``seed``; the draws are made in the JAX package's order, so a
generator seeded with s gives the instructions that JAX gives after
``random.seed(s)``.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

__all__ = ["CornerFold", "TriangleFold", "StraightFold", "TshirtFold",
           "TrousersFold", "Demonstrator"]


CORNER_POSITIONS: Dict[str, List[str]] = {
    "top_left": ["upper left", "leftmost top", "topmost left", "left upper",
                 "top left-hand", "left-hand top"],
    "top_right": ["upper right", "rightmost top", "topmost right", "right upper",
                  "top right-hand", "right-hand top"],
    "bottom_left": ["lower left", "leftmost bottom", "bottommost left",
                    "left lower", "bottom left-hand", "left-hand bottom"],
    "bottom_right": ["lower right", "rightmost bottom", "bottommost right",
                     "right lower", "bottom right-hand", "right-hand bottom"],
}

EDGE_POSITIONS: Dict[str, List[str]] = {
    "left": ["left", "leftmost", "left-hand"],
    "right": ["right", "rightmost", "right-hand"],
    "up": ["top", "upper", "topmost"],
    "down": ["bottom", "lower", "bottommost"],
}


def _pack(pick, place, gammas, flags, instructions) -> Dict:
    return {"pick": list(pick), "place": list(place), "gammas": list(gammas),
            "flags": list(flags), "instructions": list(instructions)}


class CornerFold:
    """Fold each of the 4 corners to the center, in random order
    (reference :4-171). bottom_right is the held-out unseen task."""

    def __init__(self, rng: Optional[random.Random] = None):
        self.rng = rng if rng is not None else random.Random()
        self.gammas = [0.9] * 4
        self.pick_speed = 0.005
        self.move_speed = 0.005
        self.place_speed = 0.005
        self.lift_height = 0.1
        self.primitives = ["single"] * 4
        self.seen_tasks = ["top_left", "top_right", "bottom_left"]
        self.unseen_tasks = ["bottom_right"]
        self.act_templates = {"top_left": 0, "top_right": 2,
                              "bottom_left": 6, "bottom_right": 8}
        self.seen_lang_templates = [
            "Fold the {which} corner of the cloth in to the center.",
            "Take the {which} corner of the fabric and fold it to the middle.",
            "Fold over the {which} corner so it reaches the center of the cloth.",
            "Bring the {which} corner inward to the middle of the fabric.",
            "Pick up the {which} corner and lay it on the center.",
            "Fold the fabric's {which} corner toward its middle.",
            "Move the {which} corner of the cloth onto the center point.",
            "Crease the cloth by folding the {which} corner to the middle.",
        ]
        self.unseen_lang_templates = [
            "Tuck the {which} corner of the cloth into its center.",
            "Carry the {which} corner across to the midpoint of the fabric.",
            "Double the {which} corner over onto the middle of the cloth.",
            "Flip the {which} corner of the fabric onto the central point.",
        ]

    def get_eval_instruction(self):
        corners = list(self.act_templates)
        self.rng.shuffle(corners)
        pick_idxs = [self.act_templates[c] for c in corners]
        place_idxs = [4] * 4
        flags = [int(c in self.unseen_tasks) for c in corners]
        seen, unseen = [], []
        for c in corners:
            pos = self.rng.choice(CORNER_POSITIONS[c])
            seen.append(self.rng.choice(self.seen_lang_templates).format(which=pos))
            unseen.append(self.rng.choice(self.unseen_lang_templates).format(which=pos))
        return (_pack(pick_idxs, place_idxs, self.gammas, flags, seen),
                _pack(pick_idxs, place_idxs, self.gammas, flags, unseen),
                _pack(pick_idxs, place_idxs, self.gammas, flags, seen))


class TriangleFold:
    """Two diagonal corner folds (reference :174-427). The pick corner goes to
    its diagonally opposite corner; unseen tasks start from top/bottom-right."""

    def __init__(self, rng: Optional[random.Random] = None):
        self.rng = rng if rng is not None else random.Random()
        self.gammas = [1.0] * 2
        self.pick_speed = 0.005
        self.move_speed = 0.005
        self.place_speed = 0.005
        self.lift_height = 0.1
        self.primitives = ["single"] * 2
        self.act_templates = {"top_left": 0, "top_right": 2,
                              "bottom_left": 6, "bottom_right": 8}
        self.corner_pairs = {"top_left": "bottom_right", "top_right": "bottom_left",
                             "bottom_left": "top_right", "bottom_right": "top_left"}
        self.seen_tasks = [
            ["top_left", "top_right"], ["top_left", "bottom_left"],
            ["top_right", "top_left"], ["bottom_left", "bottom_right"],
            ["bottom_left", "top_left"], ["bottom_right", "bottom_left"],
        ]
        self.unseen_tasks = [["top_right", "bottom_right"],
                             ["bottom_right", "top_right"]]
        self.seen_lang_templates1 = [
            "Fold the {which} corner across to its diagonal opposite.",
            "Take the {which} corner of the cloth to the far diagonal corner.",
            "Fold the {which} corner onto the corner diagonally across from it.",
            "Bring the {which} corner of the fabric over to its opposite corner.",
            "Fold the cloth's {which} corner to the diagonally opposing point.",
            "Carry the {which} corner to the corner straight across the diagonal.",
            "Fold the {which} vertex of the fabric onto its opposite vertex.",
            "Lay the {which} corner of the cloth on the diagonal corner.",
        ]
        self.unseen_lang_templates1 = [
            "Double the {which} corner of the cloth over to the far diagonal point.",
            "Flip the {which} corner across the diagonal onto the opposite corner.",
        ]
        self.seen_lang_templates2 = [
            "Fold the {which1} corner over to the {which2} corner.",
            "Bring the {which1} corner of the cloth onto the {which2} corner.",
            "Fold from the {which1} corner across to the {which2}.",
            "Make a diagonal fold taking the {which1} corner to the {which2} corner.",
            "Move the {which1} corner of the fabric to meet the {which2} corner.",
            "Form a triangle by folding the {which1} corner to the {which2}.",
            "Take the {which1} corner across and place it at the {which2} corner.",
            "Crease the cloth diagonally from the {which1} corner to the {which2}.",
        ]
        self.unseen_lang_templates2 = [
            "Halve the cloth on the diagonal, {which1} corner onto the {which2} corner.",
            "Flip the {which1} corner down to the {which2} corner along the diagonal.",
        ]

    def _instructions(self, corners, pool1, pool2):
        out = []
        for c in corners:
            if self.rng.random() < 0.5:
                pos = self.rng.choice(CORNER_POSITIONS[c])
                out.append(self.rng.choice(pool1).format(which=pos))
            else:
                pos1 = self.rng.choice(CORNER_POSITIONS[c])
                pos2 = self.rng.choice(CORNER_POSITIONS[self.corner_pairs[c]])
                out.append(self.rng.choice(pool2).format(which1=pos1, which2=pos2))
        return out

    def get_eval_instruction(self):
        seen_corners = self.rng.choice(self.seen_tasks)
        seen_pick = [self.act_templates[c] for c in seen_corners]
        seen_place = [self.act_templates[self.corner_pairs[c]] for c in seen_corners]
        seen_flags = [0, 0]
        seen_instr = self._instructions(seen_corners, self.seen_lang_templates1,
                                        self.seen_lang_templates2)
        unseen_instr = self._instructions(seen_corners, self.unseen_lang_templates1,
                                          self.unseen_lang_templates2)

        unseen_corners = self.rng.choice(self.unseen_tasks)
        ut_pick = [self.act_templates[c] for c in unseen_corners]
        ut_place = [self.act_templates[self.corner_pairs[c]] for c in unseen_corners]
        ut_flags = [int(unseen_corners in self.unseen_tasks)] * 2
        ut_instr = self._instructions(unseen_corners, self.seen_lang_templates1,
                                      self.seen_lang_templates2)
        return (_pack(seen_pick, seen_place, self.gammas, seen_flags, seen_instr),
                _pack(seen_pick, seen_place, self.gammas, seen_flags, unseen_instr),
                _pack(ut_pick, ut_place, self.gammas, ut_flags, ut_instr))


class StraightFold:
    """Half folds of a rectangular cloth: a two-picker edge fold (executed as
    two single steps) then a perpendicular single fold (reference :430-689).
    Action tables depend on the random initial rotation's angle mode."""

    def __init__(self, rng: Optional[random.Random] = None):
        self.rng = rng if rng is not None else random.Random()
        self.gammas = [0.9, 0.9, 1.0]
        self.pick_speed = 0.006
        self.move_speed = 0.006
        self.place_speed = 0.005
        self.lift_height = 0.125
        self.primitives = ["multi", "multi", "single"]
        self.seen_tasks = ["left", "right", "up"]
        self.unseen_tasks = ["down"]
        self.edge_pairs = {"left": "right", "right": "left",
                           "up": "down", "down": "up"}
        # angle mode 0: |angle| <= 45; 1: angle > 45; 2: angle < -45
        self.act_templates = [
            {"up": [0, 2], "down": [6, 8], "left": 3, "right": 5},
            {"left": [0, 2], "right": [6, 8], "up": 5, "down": 3},
            {"left": [6, 8], "right": [0, 2], "up": 3, "down": 5},
        ]
        self.seen_lang_templates1 = [
            "Fold the cloth in half from the {which1} edge to the {which2} edge.",
            "Crease the fabric down the middle, {which1} side onto the {which2} side.",
            "Bring the {which1} edge of the cloth over to the {which2} edge.",
            "Halve the cloth by carrying its {which1} side to the {which2} side.",
            "Fold the fabric across so the {which1} edge meets the {which2} edge.",
            "Make a half fold of the cloth going from {which1} to {which2}.",
            "Double the cloth over from its {which1} side to its {which2} side.",
            "Fold along the middle so the {which1} edge lands on the {which2} edge.",
        ]
        self.unseen_lang_templates1 = [
            "Close the cloth like a book from the {which1} edge to the {which2} edge.",
            "Collapse the fabric in half, {which1} side meeting the {which2} side.",
        ]
        self.seen_lang_templates2 = [
            "Fold the cloth in half starting from the {which} side.",
            "Halve the fabric beginning at its {which} edge.",
            "Fold the cloth evenly in two from the {which} side.",
            "Make a symmetric half fold starting on the {which} edge.",
            "Fold the fabric in half, leading with the {which} side.",
            "Double the cloth over starting from its {which} edge.",
            "Fold the material in two beginning from the {which} side.",
            "Crease the cloth in half from the {which} part.",
        ]
        self.unseen_lang_templates2 = [
            "Close the cloth in half beginning at the {which} edge.",
            "Collapse the fabric into two halves from the {which} side.",
        ]

    def _build(self, edges, table, pool1, pool2):
        pick, place, instr = [], [], []
        multi = edges[0]
        for i in range(2):
            pick.append(table[multi][i])
            place.append(table[self.edge_pairs[multi]][i])
            p1 = self.rng.choice(EDGE_POSITIONS[multi])
            p2 = self.rng.choice(EDGE_POSITIONS[self.edge_pairs[multi]])
            instr.append(self.rng.choice(pool1).format(which1=p1, which2=p2))
        single = edges[1]
        pick.append(table[single])
        place.append(table[self.edge_pairs[single]])
        instr.append(self.rng.choice(pool2).format(
            which=self.rng.choice(EDGE_POSITIONS[single])))
        return pick, place, instr

    def get_eval_instruction(self, angle_mode: int = 0):
        if angle_mode > 0:
            seen_lists = [["left", "up"], ["right", "up"]]
            unseen_lists = [["left", "down"], ["right", "down"]]
        else:
            seen_lists = [["up", "left"], ["up", "right"]]
            unseen_lists = [["down", "left"], ["down", "right"]]
        table = self.act_templates[angle_mode]

        seen_edges = self.rng.choice(seen_lists)
        sp, sl, seen_instr = self._build(seen_edges, table,
                                         self.seen_lang_templates1,
                                         self.seen_lang_templates2)
        # unseen-instruction regime: same actions, held-out phrasings
        unseen_instr = []
        multi = seen_edges[0]
        for _ in range(2):
            p1 = self.rng.choice(EDGE_POSITIONS[multi])
            p2 = self.rng.choice(EDGE_POSITIONS[self.edge_pairs[multi]])
            unseen_instr.append(self.rng.choice(self.unseen_lang_templates1)
                                .format(which1=p1, which2=p2))
        unseen_instr.append(self.rng.choice(self.unseen_lang_templates2).format(
            which=self.rng.choice(EDGE_POSITIONS[seen_edges[1]])))

        ut_edges = self.rng.choice(unseen_lists)
        up_, ul_, ut_instr = self._build(ut_edges, table,
                                         self.seen_lang_templates1,
                                         self.seen_lang_templates2)
        ut_flags = [0, 0, 0]
        if ut_edges[0] in self.unseen_tasks:
            ut_flags[0] = ut_flags[1] = 1
        if ut_edges[1] in self.unseen_tasks:
            ut_flags[2] = 1
        seen_flags = [0, 0, 0]
        return (_pack(sp, sl, self.gammas, seen_flags, seen_instr),
                _pack(sp, sl, self.gammas, seen_flags, unseen_instr),
                _pack(up_, ul_, self.gammas, ut_flags, ut_instr))


class TshirtFold:
    """Sleeves in, then bottom-up half fold (reference :692-902).

    Keypoints: 0/1 shoulders, 2 left sleeve, 3 left chest, 4 right chest,
    5 right sleeve, 6/7 hems. Left-sleeve fold is the held-out task.
    """

    def __init__(self, rng: Optional[random.Random] = None):
        self.rng = rng if rng is not None else random.Random()
        self.gammas = [1.0, 1.0, 1.1, 1.1]
        self.pick_speed = 0.005
        self.move_speed = 0.005
        self.place_speed = 0.005
        self.lift_height = 0.125
        self.primitives = ["single", "single", "multi", "multi"]
        self.seen_tasks = ["right"]
        self.unseen_tasks = ["left"]
        self.single_templates = {"left": [2, 3], "right": [5, 4]}
        self.multi_templates = {"upwards": [[6, 7], [0, 1]],
                                "left-to-right": [[0, 6], [1, 7]],
                                "right-to-left": [[1, 7], [0, 6]]}
        self.seen_lang_templates1 = [
            "Fold the {which} sleeve of the shirt onto its chest.",
            "Bring the {which} sleeve in toward the middle of the shirt.",
            "Fold the shirt's {which} sleeve across the body.",
            "Tuck the {which} sleeve of the t-shirt inward.",
            "Fold the {which} arm of the shirt over the torso.",
            "Lay the {which} sleeve flat on the shirt's body.",
            "Fold in the {which} sleeve so it rests on the chest.",
            "Move the {which} sleeve of the shirt onto the center panel.",
        ]
        self.unseen_lang_templates1 = [
            "Sweep the {which} sleeve of the shirt in over the front.",
            "Double the {which} sleeve across onto the shirt's middle.",
        ]
        self.seen_lang_templates2 = [
            "Fold the shirt in half from the bottom up.",
            "Bring the bottom hem of the shirt up to the shoulders.",
            "Fold the lower half of the shirt up over the top half.",
            "Halve the t-shirt by folding the hem to the collar.",
            "Fold the shirt upward so the hem meets the shoulders.",
            "Lift the bottom edge of the shirt and fold it to the top.",
            "Fold the t-shirt in two, bottom edge to top edge.",
            "Crease the shirt across the middle, folding the hem upward.",
        ]
        self.unseen_lang_templates2 = [
            "Close the shirt in half by carrying the hem up to the neck.",
            "Collapse the shirt upward so its bottom edge reaches the top.",
        ]

    def get_eval_instruction(self):
        singles = ["left", "right"]
        self.rng.shuffle(singles)
        pick_idxs, place_idxs = [], []
        flags = [0, 0, 0, 0]
        seen_instr, unseen_instr = [], []
        for i, action in enumerate(singles):
            if action in self.unseen_tasks:
                flags[i] = 1
            pick_idxs.append(self.single_templates[action][0])
            place_idxs.append(self.single_templates[action][1])
            pos = self.rng.choice(EDGE_POSITIONS[action])
            seen_instr.append(self.rng.choice(self.seen_lang_templates1)
                              .format(which=pos))
            unseen_instr.append(self.rng.choice(self.unseen_lang_templates1)
                                .format(which=pos))
        picks, places = self.multi_templates["upwards"]
        for i in range(2):
            pick_idxs.append(picks[i])
            place_idxs.append(places[i])
            seen_instr.append(self.rng.choice(self.seen_lang_templates2))
            unseen_instr.append(self.rng.choice(self.unseen_lang_templates2))
        return (_pack(pick_idxs, place_idxs, self.gammas, flags, seen_instr),
                _pack(pick_idxs, place_idxs, self.gammas, flags, unseen_instr),
                _pack(pick_idxs, place_idxs, self.gammas, flags, seen_instr))


class TrousersFold:
    """Fold one leg column onto the other (two-step multi), then waist-to-hem
    half fold (reference :905-1123). Keypoints: 0..3 waist L->R, 4..7 hem
    L->R. Folding from the right is the held-out task."""

    def __init__(self, rng: Optional[random.Random] = None):
        self.rng = rng if rng is not None else random.Random()
        self.gammas = [1.0, 1.0, 1.0]
        self.pick_speed = 0.005
        self.move_speed = 0.005
        self.place_speed = 0.005
        self.lift_height = 0.15
        self.primitives = ["multi", "multi", "single"]
        self.seen_tasks = ["left"]
        self.unseen_tasks = ["right"]
        self.position_pairs = {"left": "right", "right": "left"}
        self.dual_templates = {"left": [[0, 4], [3, 7]], "right": [[3, 7], [0, 4]]}
        self.single_templates = {"left": [2, 6], "right": [1, 5]}
        self.seen_lang_templates1 = [
            "Fold the {which1} leg of the trousers onto the {which2} leg.",
            "Bring the {which1} side of the trousers over to the {which2} side.",
            "Fold the trousers in half, {which1} leg on top of the {which2} leg.",
            "Lay the {which1} leg of the pants across the {which2} leg.",
            "Fold the pants sideways from the {which1} leg to the {which2}.",
            "Stack the trousers' {which1} leg on the {which2} leg.",
            "Fold the {which1} half of the trousers over the {which2} half.",
            "Carry the {which1} leg of the pants onto the {which2} one.",
        ]
        self.unseen_lang_templates1 = [
            "Close the trousers in half, sweeping the {which1} leg to the {which2}.",
            "Double the pants over from the {which1} side onto the {which2} side.",
        ]
        self.seen_lang_templates2 = [
            "Fold the trousers in half from the waist down to the hem.",
            "Bring the waistband of the trousers down to the trouser cuffs.",
            "Fold the pants in two, top edge to bottom edge.",
            "Halve the trousers vertically, folding the waist to the hem.",
            "Fold the trousers downward so the waist meets the cuffs.",
            "Crease the pants across the middle, waist folded to the bottom.",
            "Fold the upper half of the trousers onto the lower half.",
            "Fold the trousers top-to-bottom into a half.",
        ]
        self.unseen_lang_templates2 = [
            "Close the trousers by folding the waistband down to the cuffs.",
            "Collapse the pants in half from the top edge to the bottom.",
        ]

    def _leg_instr(self, action, pool):
        p1 = self.rng.choice(EDGE_POSITIONS[action])
        p2 = self.rng.choice(EDGE_POSITIONS[self.position_pairs[action]])
        return self.rng.choice(pool).format(which1=p1, which2=p2)

    def get_eval_instruction(self):
        out = []
        for fold_action, lang1, lang2 in (
                ("left", self.seen_lang_templates1, self.seen_lang_templates2),
                ("left", self.unseen_lang_templates1, self.unseen_lang_templates2),
                (self.rng.choice(["left", "right"]), self.seen_lang_templates1,
                 self.seen_lang_templates2)):
            flags = [1, 1, 0] if fold_action in self.unseen_tasks else [0, 0, 0]
            picks = [self.dual_templates[fold_action][0][0],
                     self.dual_templates[fold_action][0][1],
                     self.single_templates[fold_action][0]]
            places = [self.dual_templates[fold_action][1][0],
                      self.dual_templates[fold_action][1][1],
                      self.single_templates[fold_action][1]]
            instr = [self._leg_instr(fold_action, lang1),
                     self._leg_instr(fold_action, lang1),
                     self.rng.choice(lang2)]
            out.append(_pack(picks, places, self.gammas, flags, instr))
        return tuple(out)


Demonstrator = {
    "CornerFold": CornerFold,
    "TriangleFold": TriangleFold,
    "StraightFold": StraightFold,
    "TshirtFold": TshirtFold,
    "TrousersFold": TrousersFold,
    None: TshirtFold,
}
