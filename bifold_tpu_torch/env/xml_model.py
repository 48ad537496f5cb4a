"""MuJoCo flexcomp XML editing utility.

The port's copy of bifold_tpu/env/xml_model.py (``XMLModel`` :18), a
counterpart of the reference's env/utils.py XMLModel: a vestigial helper
from the reference's abandoned MuJoCo path, unused by any other module and
kept for API-surface parity. It edits flexcomp attributes via
underscore-separated key paths, swaps the cloth texture and queries the
cloth grid size, on stdlib ``ElementTree``; the files it writes equal the
JAX package's byte for byte.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, Optional

__all__ = ["XMLModel"]


class XMLModel:
    def __init__(self, xml_file: str):
        self.path = xml_file
        self.tree = ET.parse(self.path)
        self.cloth = next(self.tree.iter("flexcomp"))

    def save_changes_to_file(self, output_file: Optional[str] = None) -> None:
        with open(output_file or self.path, "wb") as f:
            self.tree.write(f, encoding="utf-8")

    def modify_params(self, params: Dict) -> None:
        """Keys are attribute names on the flexcomp element, or
        ``sub_element..._attr`` paths walking child elements (disambiguated by
        each child's ``key`` attribute when several match)."""
        for k, val in params.items():
            if "_" not in k:
                self.cloth.set(k, str(val))
                continue
            *subelements, attr = k.split("_")
            candidates = [self.cloth]
            for name in subelements:
                if len(candidates) > 1:
                    candidates = [c for c in candidates if c.get("key") == name][:1]
                elif len(candidates) == 1:
                    candidates = candidates[0].findall(name)
                else:
                    raise ValueError(f"Cannot modify {k}: no matching element")
            assert len(candidates) == 1, f"Non-unique element for {k}"
            candidates[0].set(attr, str(val))
        self.save_changes_to_file()

    def change_texture(self, texture_file: str) -> None:
        for tex in self.tree.iter("texture"):
            if tex.attrib.get("name") == "cloth_texture":
                tex.set("file", texture_file)
                return
        raise ValueError("Could not change texture")

    def get_cloth_size(self):
        num_rows, num_cols, _ = map(int, self.cloth.attrib["count"].split())
        return num_rows, num_cols
