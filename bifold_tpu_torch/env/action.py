"""Action container (the port's copy of bifold_tpu/env/action.py).

Two-field (pick, place) or four-field (left/right x pick/place) depending on
which kwargs are given; pixels are ``[x, y]`` arrays, DUMMY (-1, -1) marks an
inactive arm.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["Action", "DUMMY_PICK"]

DUMMY_PICK = -np.ones(2)


@dataclass
class Action:
    pick: Optional[np.ndarray] = None
    place: Optional[np.ndarray] = None
    left_pick: Optional[np.ndarray] = None
    left_place: Optional[np.ndarray] = None
    right_pick: Optional[np.ndarray] = None
    right_place: Optional[np.ndarray] = None

    def __post_init__(self):
        single = self.pick is not None or self.place is not None
        dual = any(
            x is not None
            for x in (self.left_pick, self.left_place, self.right_pick, self.right_place)
        )
        if single and dual:
            raise ValueError("Action is either unimanual (pick/place) or bimanual")
        if single and (self.pick is None or self.place is None):
            raise ValueError("Unimanual action needs both pick and place")
        if dual and any(
            x is None
            for x in (self.left_pick, self.left_place, self.right_pick, self.right_place)
        ):
            raise ValueError("Bimanual action needs all four left/right pick/place")

    @property
    def is_bimanual(self) -> bool:
        return self.left_pick is not None

    def fields(self):
        """(name, value) pairs of the populated pick/place fields, in the
        declaration order the reference's ``action.__dict__`` iteration sees."""
        return [(k, v) for k, v in self.__dict__.items() if v is not None]
