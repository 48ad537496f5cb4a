"""Non-cloth particle scenes: rope, fluid, rigid plates, torus, softbody.

The port's copy of bifold_tpu/env/scenes.py (``square_cloth_scene`` :36,
``rope_scene`` :48, ``fluid_scene`` :84, ``rigid_cloth_scene`` :107,
``torus_scene`` :145, ``softbody_scene`` :172, ``set_scene`` :209),
counterparts of the reference's FleX demo scenes (PyFlex's
softgym_scenes/{softgym_fluid, softgym_rope, softgym_rigid_cloth,
softgym_torus, softgym_softbody}.h) and of the scene registry in
pyflex.cpp:24-41. The reference builds these on the NvFlex CUDA solver
(rigid shape-matching clusters, a fluid solver, spring ropes); these build
them on the XPBD core the cloth scenes use (:mod:`bifold_tpu_torch.env.sim`):
distance constraints for rope/softbody, shape-matching rigid clusters for
rigid plates and tori, and a PBF density solver for fluids. Like the JAX
package's, every scene but the square cloth runs the simulator's extended
step, which is numpy (the C++ core runs the cloth step): host code, nothing
of it on the card. The states equal the JAX package's bitwise.

Scene indices in SCENES match pyflex's ``set_scene(idx, params)`` registry
order: 0 cloth, 1 fluid, 2 rope, 3 tshirt, 4 rigid cloth, 5 torus,
6 cloth3d, 7 softbody. Params are keyword arguments rather than the
reference's packed float arrays (:mod:`bifold_tpu_torch.env.pyflex_compat`
decodes those).

bifold's tasks only ever drive scenes 0/3/6 (the cloth family); the rest
exist for pyflex API-surface parity.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from bifold_tpu_torch.env.sim import ClothSim, grid_cloth, make_phase

__all__ = ["rope_scene", "fluid_scene", "rigid_cloth_scene", "torus_scene",
           "softbody_scene", "square_cloth_scene", "set_scene", "SCENES"]


def square_cloth_scene(sim: ClothSim, *, dimx: int = 32, dimy: int = 32,
                       spacing: Optional[float] = None, height: float = 0.05,
                       mass: float = 0.5, stretch: float = 0.9,
                       bend: float = 0.3):
    """Procedural square cloth (reference softgym_cloth.h SoftgymCloth:
    grid from ClothPos/ClothSize/ClothStiff)."""
    spacing = spacing or sim.particle_radius * 1.2
    verts, faces = grid_cloth(dimx, dimy, spacing, center=(0.0, height, 0.0))
    sim.set_cloth(verts, faces, mass=mass, stretch=stretch, bend=bend)
    return sim


def rope_scene(sim: ClothSim, *, segments: int = 40,
               spacing: Optional[float] = None,
               start=(0.0, 0.5, 0.0), direction=(1.0, 0.0, 0.0),
               stretch_stiffness: float = 1.0, bend_stiffness: float = 0.5,
               mass: float = 0.2, pin_first: bool = True):
    """Particle rope: a chain of distance constraints with second-neighbor
    bending (reference softgym_rope.h: CreateRope with stretch/bend
    stiffness and a segment count derived from the radius)."""
    spacing = spacing or sim.particle_radius
    d = np.asarray(direction, np.float64)
    d = d / (np.linalg.norm(d) + 1e-12)
    pos = np.asarray(start, np.float64)[None] + \
        np.arange(segments + 1)[:, None] * spacing * d[None]
    n = len(pos)
    inv_mass = np.full(n, n / max(mass, 1e-9), np.float32)
    if pin_first:
        inv_mass[0] = 0.0
    stretch = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    bend = np.stack([np.arange(n - 2), np.arange(2, n)], axis=1)
    edges = np.concatenate([stretch, bend])
    stiff = np.concatenate([
        np.full(len(stretch), stretch_stiffness, np.float32),
        np.full(len(bend), bend_stiffness, np.float32)])
    sim.set_particles(pos, inv_mass, edges=edges, stiffness=stiff,
                      phases=make_phase(0, True, True),
                      color=(0.8, 0.6, 0.2))
    return sim


def _box_lattice(lower, dims, spacing) -> np.ndarray:
    """Cubic particle lattice: lower corner + (nx, ny, nz) * spacing."""
    nx, ny, nz = dims
    g = np.mgrid[0:nx, 0:ny, 0:nz].reshape(3, -1).T.astype(np.float64)
    return np.asarray(lower, np.float64)[None] + g * spacing


def fluid_scene(sim: ClothSim, *, dim=(8, 16, 8), lower=(0.0, 0.1, 0.0),
                radius: float = 0.05, rest_dis_coef: float = 0.55,
                bounds_lo=(-0.4, 0.0, -0.4), bounds_hi=(0.4, 10.0, 0.4)):
    """Block of fluid particles in a container (reference softgym_fluid.h:
    CreateParticleGrid at restDistance = radius * rest_dis_coef with the
    interaction radius as the smoothing length). PBF density solve."""
    spacing = radius * rest_dis_coef
    pos = _box_lattice(lower, dim, spacing)
    # SelfCollide|Fluid, matching softgym_fluid.h's NvFlexMakePhase — with
    # self-collide OFF the phase gate in _step_numpy_ext would drop every
    # fluid-fluid pair and the rest-distance separation pass (the
    # anti-clustering mechanism replacing PBF artificial pressure) would
    # never run
    sim.set_particles(pos, 1.0, phases=make_phase(0, True, False, True),
                      color=(0.3, 0.5, 0.9))
    # rest density of the emission lattice itself (computed by
    # set_fluid_params at OUR spacing), so pressure is neutral in the
    # initial block interior
    sim.set_fluid_params(radius, rest_spacing=spacing)
    sim.set_scene_bounds(bounds_lo, bounds_hi)
    return sim


def rigid_cloth_scene(sim: ClothSim, *, plates: int = 3,
                      dims=(12, 1, 8), radius: float = 0.02,
                      gap: float = 3.0, stiffness: float = 1.0):
    """Rigid plates dropped side by side (reference softgym_rigid_cloth.h:
    CreateParticleShape over box meshes, rigid=true). Each plate is one
    shape-matching cluster."""
    all_pos, offsets, phases = [], [], []
    sx = dims[0] * radius
    for i in range(plates):
        lower = ((gap * radius + sx) * i, radius, 0.0)
        p = _box_lattice(lower, dims, radius)
        offsets.append((sum(len(a) for a in all_pos), len(p)))
        all_pos.append(p)
        # one collision group per plate, no intra-plate collision
        phases.append(np.full(len(p), make_phase(i + 1, False, False),
                              np.int32))
    pos = np.concatenate(all_pos)
    sim.set_particles(pos, 1.0, phases=np.concatenate(phases),
                      color=(0.7, 0.7, 0.75))
    for start, count in offsets:
        sim.add_rigid_body(np.arange(start, start + count),
                           stiffness=stiffness)
    return sim


def _torus_points(center, big_r: float, small_r: float,
                  spacing: float) -> np.ndarray:
    """Volume sampling of a torus (axis = +y): lattice points whose
    distance to the center circle is <= small_r."""
    m = big_r + small_r
    g = np.mgrid[-m:m + spacing / 2:spacing,
                 -small_r:small_r + spacing / 2:spacing,
                 -m:m + spacing / 2:spacing].reshape(3, -1).T
    ring = np.sqrt(g[:, 0] ** 2 + g[:, 2] ** 2) - big_r
    keep = ring ** 2 + g[:, 1] ** 2 <= small_r ** 2
    return np.asarray(center, np.float64)[None] + g[keep]


def torus_scene(sim: ClothSim, *, n_tori: int = 2, big_r: float = 0.08,
                small_r: float = 0.03, radius: float = 0.02,
                lower=(0.0, 0.0, 0.0), height: float = 0.25,
                stiffness: float = 1.0):
    """Stack of rigid tori dropped from height (reference softgym_torus.h:
    CreateParticleShape(torus.obj, rigid=true) per torus; ours samples the
    torus volume procedurally instead of loading an .obj)."""
    all_pos, spans, phases = [], [], []
    for i in range(n_tori):
        c = (lower[0] + (i % 3) * height / 3.0, height * (i + 1),
             lower[2] + (i % 3) * height / 3.0)
        p = _torus_points(c, big_r, small_r, radius * 0.5)
        start = sum(len(a) for a in all_pos)
        spans.append((start, len(p)))
        all_pos.append(p)
        phases.append(np.full(len(p), make_phase(i + 1, False, False),
                              np.int32))
    pos = np.concatenate(all_pos)
    # invMass 0.125 per particle, like the reference's CreateParticleShape
    sim.set_particles(pos, 0.125, phases=np.concatenate(phases),
                      color=(0.85, 0.4, 0.3))
    for start, count in spans:
        sim.add_rigid_body(np.arange(start, start + count),
                           stiffness=stiffness)
    return sim


def softbody_scene(sim: ClothSim, *, dims=(6, 6, 6), spacing: float = 0.02,
                   lower=(0.0, 0.3, 0.0), stiffness: float = 0.3,
                   link_radius_factor: float = 1.8, mass: float = 1.0):
    """Deformable particle block (reference softgym_softbody.h: CreateSoftBody
    builds overlapping shape-matched clusters; ours links lattice neighbors
    within link_radius_factor*spacing with soft distance constraints — a
    constraint-lattice softbody, same observable behavior class: holds its
    shape, deforms on impact, rests on the floor)."""
    pos = _box_lattice(lower, dims, spacing)
    n = len(pos)
    from scipy.spatial import cKDTree
    pairs = cKDTree(pos).query_pairs(link_radius_factor * spacing,
                                     output_type="ndarray")
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    edges = pairs[order]
    sim.set_particles(pos, n / max(mass, 1e-9), edges=edges,
                      stiffness=stiffness,
                      phases=make_phase(0, False, False),
                      color=(0.5, 0.8, 0.4))
    return sim


# pyflex set_scene registry order (pyflex.cpp:25-41); tshirt/cloth3d load
# meshes through env/cloth_env.py + env/garments.py and are listed here for
# the index mapping only.
SCENES: Dict[int, object] = {
    0: square_cloth_scene,
    1: fluid_scene,
    2: rope_scene,
    3: "tshirt (env/garments.py procedural tshirt via cloth_env)",
    4: rigid_cloth_scene,
    5: torus_scene,
    6: "cloth3d (env/cloth_env.py set_cloth3d_scene)",
    7: softbody_scene,
}


def set_scene(sim: ClothSim, scene, **params) -> ClothSim:
    """pyflex.set_scene(idx, params) equivalent over the registry above."""
    builder = SCENES.get(scene, scene)
    if not callable(builder):
        raise ValueError(
            f"scene {scene!r} is mesh-driven; use env.cloth_env ({builder})")
    return builder(sim, **params)
