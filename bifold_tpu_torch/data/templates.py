"""Instruction template pools for bimanual action mining + real-world eval.

The port's copy of bifold_tpu/data/templates.py. Counterpart of the
``folding_actions`` table in
the reference's bifold/data/vr_folding_utils.py:13-66: three slot-typed pools
(sleeves: {which}; refine: {which}/{garment}; fold: {garment}/{which1}/
{which2}) used to phrase mined actions and to enumerate real-dataset
paraphrase sets. Phrasings here are our own; pool sizes and slot conventions
match so downstream sampling behaves the same.
"""

from __future__ import annotations

__all__ = ["folding_actions", "opposite_locations"]

folding_actions = {
    "sleeves": [
        "Fold the {which} sleeve in toward the middle.",
        "Bring the {which} sleeve onto the body of the shirt.",
        "Fold the {which} sleeve across to the center.",
        "Tuck the {which} sleeve in toward the chest.",
        "Fold in the {which} sleeve.",
        "Sweep the {which} sleeve inward.",
        "Lay the {which} sleeve over the middle of the shirt.",
        "Fold the {which} sleeve toward the center line.",
        "Bend the {which} sleeve in to the midline.",
        "Move the {which} sleeve onto the torso.",
        "Fold the {which} sleeve until it reaches the center.",
        "Bring the {which} sleeve in to the middle seam.",
        "Fold the {which} sleeve flat against the body.",
        "Place the {which} sleeve onto the center of the garment.",
        "Fold the {which} sleeve to the middle of the shirt.",
        "Carry the {which} sleeve across toward the center.",
        "Fold the {which} sleeve inward onto the shirt.",
        "Draw the {which} sleeve in to the central axis.",
        "Fold the {which} sleeve over to the midpoint.",
        "Press the {which} sleeve in toward the center crease.",
    ],
    "refine": [
        "Tidy up the {which} part of the {garment}.",
        "Neaten the {which} side of the {garment}.",
        "Smooth the {which} part of the {garment} into place.",
        "Adjust the {which} section of the {garment} so it lies flat.",
        "Fix the {which} part of the {garment} into position.",
        "Square up the {which} side of the {garment}.",
    ],
    "fold": [
        "Fold the {garment} in half from {which1} to {which2}.",
        "Fold the {garment} so the {which1} side lands on the {which2} side.",
        "Bring the {which1} side of the {garment} over to the {which2} side.",
        "Halve the {garment}, folding {which1} onto {which2}.",
        "Fold the {garment} across, {which1} edge to {which2} edge.",
        "Double the {garment} over from the {which1} toward the {which2}.",
        "Fold the {garment} in two, with {which1} meeting {which2}.",
        "Crease the {garment} through the middle from {which1} to {which2}.",
        "Fold the {garment} over so its {which1} half covers the {which2} half.",
        "Take the {which1} side of the {garment} across to the {which2} side.",
        "Fold the {garment} in half, {which1} edge onto the {which2} edge.",
        "Make one half fold of the {garment}, from the {which1} to the {which2}.",
        "Fold the {garment} down the middle, {which1} side toward {which2} side.",
        "Lay the {which1} half of the {garment} on top of the {which2} half.",
        "Fold the {garment} cleanly in half from its {which1} side to its {which2}.",
        "Bend the {garment} in two so the {which1} part reaches the {which2} part.",
        "Close the {garment} like a book from {which1} to {which2}.",
        "Fold the {garment} once, carrying the {which1} edge to the {which2} edge.",
        "Collapse the {garment} in half in the {which1}-to-{which2} direction.",
        "Fold the {garment} evenly, moving the {which1} side to the {which2} side.",
    ],
}

opposite_locations = {
    "bottom": "top",
    "top": "bottom",
    "right": "left",
    "left": "right",
}
