"""SoftGym-style state cache builder: {configs, states[, keypoints]} pickles.

The port's copy of bifold_tpu/env/cache_builder.py, a counterpart of the
reference's create_softgym_meshes.py (which
loads CLOTH3D meshes into FleX, waits for stability, and pickles configs +
settled particle states + keypoint vertex indices,
create_softgym_meshes.py:425-441). Here caches are built from procedural
cloth (square/rect grids, generated tshirt/trousers silhouettes) — fully
self-contained — or from a directory of .obj meshes when CLOTH3D data is
available. Evaluators load `<cache>/<ClothType>.pkl`
(softgym_evaluator.py:78-87). The pickles hold numpy arrays and plain
Python values only, so either package loads the other's; the same
``(cloth_type, n_configs, seed, settle_steps)`` and simulator backend give
the JAX package's configs, states and keypoints.

CLI: python -m bifold_tpu_torch.env.cache_builder --out <dir> [--n 10]
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from bifold_tpu_torch.env.cloth_env import ClothEnv, square_cloth_config
from bifold_tpu_torch.env.garments import trousers_mesh, tshirt_mesh

__all__ = ["build_cache", "CLOTH_TYPES"]

CLOTH_TYPES = ("Square", "Rectangular", "Tshirt", "Trousers")


def _square_configs(cloth_type: str, n: int, rng: np.random.Generator) -> List[Dict]:
    configs = []
    for _ in range(n):
        if cloth_type == "Square":
            dim = int(rng.integers(28, 37))
            dimx = dimy = dim
        else:
            dimx = int(rng.integers(28, 37))
            dimy = int(rng.integers(40, 53))
        configs.append(square_cloth_config(dimx, dimy,
                                           mass=float(rng.uniform(0.3, 0.7))))
    return configs


def _garment_configs(cloth_type: str, n: int, rng: np.random.Generator):
    configs, keypoints = [], []
    for _ in range(n):
        scale = float(rng.uniform(0.8, 1.2))
        if cloth_type == "Tshirt":
            verts, faces, kp = tshirt_mesh(scale=0.22 * scale)
        else:
            verts, faces, kp = trousers_mesh(scale=0.24 * scale)
        cfg = square_cloth_config(2, 2)  # camera scaffold; cloth overridden
        cfg.pop("ClothSize")
        cfg.update({"vertices": verts, "faces": faces,
                    "cloth_type": cloth_type, "mass": 0.5,
                    "scale": 1.0, "rot": 0.0})
        configs.append(cfg)
        keypoints.append(kp)
    return configs, keypoints


def _obj_configs(cloth_type: str, mesh_dir: Path, n: int):
    """Configs pointing at real CLOTH3D-style .obj files (keypoints must be
    provided separately — reference keypoint mining needs the action data)."""
    meshes = sorted(mesh_dir.glob("*.obj"))[:n]
    configs = []
    for path in meshes:
        cfg = square_cloth_config(2, 2)
        cfg.pop("ClothSize")
        cfg.update({"mesh_path": str(path), "cloth_type": cloth_type,
                    "mass": 0.5, "scale": 1.0, "rot": 0.0})
        configs.append(cfg)
    return configs


def build_cache(cloth_type: str, out_dir: str | Path, n_configs: int = 10,
                seed: int = 0, mesh_dir: Optional[str] = None,
                settle_steps: int = 60) -> Path:
    """Settle each config in the simulator and pickle configs/states/keypoints."""
    assert cloth_type in CLOTH_TYPES, cloth_type
    rng = np.random.default_rng(seed)
    cloth3d = cloth_type in ("Tshirt", "Trousers")

    keypoints: Optional[List] = None
    if cloth3d:
        if mesh_dir:
            configs = _obj_configs(cloth_type, Path(mesh_dir), n_configs)
            keypoints = None  # requires external annotation
        else:
            configs, keypoints = _garment_configs(cloth_type, n_configs, rng)
    else:
        configs = _square_configs(cloth_type, n_configs, rng)

    env = ClothEnv(render_dim=224)
    states = []
    for cfg in configs:
        env.reset(cfg, state=None, cloth3d=cloth3d, settle_steps=settle_steps)
        pos = env.sim.get_positions()[:, :3]
        extent = pos.max(axis=0) - pos.min(axis=0)
        state = env.get_state()
        state["max_area"] = float(extent[0] * extent[2])
        states.append(state)

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    payload: Dict = {"configs": configs, "states": states}
    if keypoints is not None:
        payload["keypoints"] = keypoints
    out_path = out_dir / f"{cloth_type}.pkl"
    with open(out_path, "wb") as f:
        pickle.dump(payload, f)
    return out_path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--types", nargs="*", default=list(CLOTH_TYPES))
    ap.add_argument("--mesh-dir", default=None,
                    help="directory of CLOTH3D .obj meshes (Tshirt/Trousers)")
    args = ap.parse_args()
    for cloth_type in args.types:
        path = build_cache(cloth_type, args.out, n_configs=args.n,
                           seed=args.seed, mesh_dir=args.mesh_dir)
        print(f"[cache_builder] wrote {path}")


if __name__ == "__main__":
    main()
