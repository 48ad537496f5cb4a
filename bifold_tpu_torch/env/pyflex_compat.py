"""pyflex-compatible module API over the native/numpy XPBD simulator.

The port's copy of bifold_tpu/env/pyflex_compat.py (``init`` :87,
``set_scene`` :144, ``step`` :255, ``render`` :271, the getters and setters
:305-490). The reference ships a pybind11 module (``import pyflex``, PyFlex's
bindings/pyflex.cpp:1121-1188): module-level functions over one implicit
global solver, flat float32 arrays, (x, y, z, w) quaternions, and packed
per-scene parameter arrays. softgym's envs (and therefore bifold's) drive
exactly that surface.

This module is the drop-in equivalent on the port's solver stack: one
implicit global :class:`~bifold_tpu_torch.env.sim.ClothSim`, the same
function names and marshalling conventions, the packed ``set_scene``
layouts decoded per scene (each layout cited to its softgym_scenes/*.h
header), quats converted at the boundary (the sim stores (w, x, y, z);
pyflex stores (x, y, z, w), pyflex.cpp:319-335 ``Quat(ptr[0..3])``).

Use ``import bifold_tpu_torch.env.pyflex_compat as pyflex``: softgym call
sites then run unmodified. New code should prefer the explicit
:class:`ClothSim` / :mod:`bifold_tpu_torch.env.scenes` APIs.

How the port differs: ``init()`` builds ``ClothSim()``, which in the port
builds the C++ core (:mod:`bifold_tpu_torch.env.native`) or raises; it
never falls back to numpy quietly (the JAX package's ``ClothSim()`` runs
numpy when ``csrc/build`` is missing). The states it gives equal the JAX
package's bitwise.

Deliberate deviations from pyflex, all documented inline: fluid parameters
the PBF solver has no counterpart for (cohesion/adhesion/vorticity/...) are
accepted and ignored; ``main()`` (the interactive FleX demo loop) is a
no-op; capture/path GIF capture in ``step``/``render`` is unsupported
(softgym's own envs pass capture=0; ``ClothEnv.render_gif`` writes GIFs).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

import numpy as np

from bifold_tpu_torch.env import scenes as _scenes
from bifold_tpu_torch.env.sim import ClothSim, load_obj, make_phase

__all__ = [
    "init", "main", "clean", "set_scene", "step", "render", "render_cloth",
    "get_camera_params", "set_camera_params", "add_box", "add_sphere",
    "add_capsule", "pop_box", "clear_shapes", "set_shape_color",
    "get_n_particles", "get_n_shapes", "get_n_rigids",
    "get_n_rigidPositions", "get_phases", "set_phases", "get_groups",
    "set_groups", "get_positions", "set_positions", "get_restPositions",
    "get_rigidOffsets", "get_rigidIndices", "get_rigidLocalPositions",
    "get_rigidGlobalPositions", "get_rigidRotations",
    "get_rigidTranslations", "get_velocities", "set_velocities",
    "get_shape_states", "set_shape_states", "get_scene_upper",
    "get_scene_lower", "add_rigid_body",
]

_sim: Optional[ClothSim] = None


def _require_sim() -> ClothSim:
    if _sim is None:
        raise RuntimeError("pyflex_compat: call init() before other functions"
                           " (pyflex.cpp requires pyflex.init() first too)")
    return _sim


def _quat_wxyz(q_xyzw) -> np.ndarray:
    q = np.asarray(q_xyzw, np.float32).reshape(4)
    return np.array([q[3], q[0], q[1], q[2]], np.float32)


def _states_ours_to_pyflex(states: np.ndarray) -> np.ndarray:
    """(n, 14) shape states: [pos(3) prev_pos(3) quat(4) prev_quat(4)];
    roll our (w,x,y,z) quat slots to pyflex (x,y,z,w)."""
    out = np.asarray(states, np.float32).reshape(-1, 14).copy()
    out[:, 6:10] = np.roll(out[:, 6:10], -1, axis=1)
    out[:, 10:14] = np.roll(out[:, 10:14], -1, axis=1)
    return out


def _states_pyflex_to_ours(states: np.ndarray) -> np.ndarray:
    out = np.asarray(states, np.float32).reshape(-1, 14).copy()
    out[:, 6:10] = np.roll(out[:, 6:10], 1, axis=1)
    out[:, 10:14] = np.roll(out[:, 10:14], 1, axis=1)
    return out


# ---------------------------------------------------------------------------
# lifecycle (pyflex.cpp: pyflex_init / pyflex_clean / main)

def init(headless: bool = False, render: bool = True,
         camera_width: int = 720, camera_height: int = 720,
         msaa_samples: int = 8, device: int = 0) -> None:
    """pyflex.init (pyflex.cpp:14): a fresh global ``ClothSim()``, which
    builds the C++ core or raises (never a numpy fallback). headless/msaa/
    device are GL/CUDA concerns with no counterpart here; accepted for
    signature parity."""
    global _sim
    del headless, render, msaa_samples, device
    _sim = ClothSim()
    _sim.camera_params.update(width=camera_width, height=camera_height)


def main() -> None:
    """The reference's interactive FleX demo loop (pyflex.cpp:1122). A
    documented no-op: there is no GL window; nothing to run."""
    warnings.warn("pyflex_compat.main() is a no-op (no interactive demo "
                  "loop); use init() + set_scene() + step()")


def clean() -> None:
    global _sim
    if _sim is not None:
        _sim.clear()
    _sim = None


# ---------------------------------------------------------------------------
# scenes (pyflex_set_scene, pyflex.cpp:276; packed layouts cited per scene)

def _cam_from(ptr: np.ndarray, at: int) -> None:
    """Scene headers all tail with [cam_x..z, cam_angle_x..z, w, h]."""
    sim = _require_sim()
    sim.set_camera_params({
        **sim.camera_params,
        "pos": np.asarray(ptr[at:at + 3], np.float32),
        "angle": np.asarray(ptr[at + 3:at + 6], np.float32),
        "width": int(ptr[at + 6]), "height": int(ptr[at + 7]),
    })


def _garment_scene(sim: ClothSim, ptr: np.ndarray, verts: np.ndarray,
                   faces: np.ndarray) -> None:
    """Shared tshirt/cloth3d placement (softgym_tshirt.h:313-331 /
    softgym_cloth3d.h:318-339): scale + y-rotation + translation + initial
    velocity + stiffness + mass."""
    init_pos = np.asarray(ptr[0:3], np.float64)
    scale, rot = float(ptr[3]), float(ptr[4])
    vel = np.asarray(ptr[5:8], np.float32)
    stiff, mass = float(ptr[8]), float(ptr[9])
    v = np.asarray(verts, np.float64) * scale
    c, s = np.cos(rot), np.sin(rot)
    # rotate about +y like createCloth3d's `rot` (a yaw angle)
    v = v @ np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float64).T
    v = v + init_pos[None]
    sim.set_cloth(v, faces, mass=mass, stretch=stiff, bend=stiff)
    sim.velocities[:] = vel[None]


def set_scene(scene_idx: int, scene_params, thread_idx: int = 0) -> None:
    """pyflex.set_scene(idx, packed_float_params) — registry order
    pyflex.cpp:25-41 (0 cloth, 1 fluid, 2 rope, 3 tshirt, 4 rigid cloth,
    5 torus, 6 cloth3d, 7 softbody)."""
    del thread_idx
    sim = _require_sim()
    sim.clear()
    ptr = np.asarray(scene_params, np.float32).reshape(-1)

    if scene_idx == 0:
        # softgym_cloth.h:33-58: ClothPos(3), dims, stiffs, render_type,
        # cam(8), total mass, flip_mesh (mesh halves — render-only, ignored)
        dimx, dimz = int(ptr[3]), int(ptr[4])
        spacing = sim.particle_radius * 1.2
        lower = np.asarray(ptr[0:3], np.float64)
        center = lower + spacing * np.array(
            [(dimx - 1) / 2.0, 0.0, (dimz - 1) / 2.0])
        _scenes.square_cloth_scene(
            sim, dimx=dimx, dimy=dimz, spacing=spacing,
            height=float(center[1]), mass=float(ptr[17]),
            stretch=float(ptr[5]), bend=float(ptr[6]))
        sim.positions[:, 0] += center[0]
        sim.positions[:, 2] += center[2]
        sim.rest_positions[:, 0] += center[0]
        sim.rest_positions[:, 2] += center[2]
        _cam_from(ptr, 9)
    elif scene_idx == 1:
        # softgym_fluid.h:39-62: radius, rest_dis_coef, then 6 NvFlex fluid
        # params our PBF solver has no counterpart for (cohesion, viscosity,
        # surface tension, adhesion, vorticity, solid pressure — ignored,
        # documented deviation), lower(3), dims(3), cam(8)
        _scenes.fluid_scene(
            sim, dim=tuple(int(d) for d in ptr[11:14]),
            lower=tuple(float(v) for v in ptr[8:11]),
            radius=float(ptr[0]), rest_dis_coef=float(ptr[1]))
        _cam_from(ptr, 14)
    elif scene_idx == 2:
        # softgym_rope.h:22-39: init(3), stretch, bend, radius (segment
        # spacing), segment count, mass, scale (render-only), cam(8)
        _scenes.rope_scene(
            sim, segments=int(ptr[6]),
            spacing=float(ptr[5]) * 0.5,  # CreateRope spaces at radius/2
            start=tuple(float(v) for v in ptr[0:3]),
            stretch_stiffness=float(ptr[3]), bend_stiffness=float(ptr[4]),
            mass=float(ptr[7]), pin_first=False)
        _cam_from(ptr, 9)
    elif scene_idx == 3:
        # softgym_tshirt.h:313-331 loads PYFLEXROOT/data's tshirt obj; ours
        # builds the procedural tshirt (env/garments.py) — same topology
        # class, no asset dependency
        from bifold_tpu_torch.env.garments import tshirt_mesh
        verts, faces, _ = tshirt_mesh(scale=1.0)
        _garment_scene(sim, ptr, verts, faces)
        _cam_from(ptr, 11)
    elif scene_idx == 4:
        # softgym_rigid_cloth.h:23-34: dims(3), numPiece, invMass,
        # rigidStiffness, cam(8)
        _scenes.rigid_cloth_scene(
            sim, plates=int(ptr[3]),
            dims=(int(ptr[0]), int(ptr[1]), int(ptr[2])),
            stiffness=float(ptr[5]))
        inv = float(ptr[4])
        if inv > 0:
            sim.positions[:, 3] = inv
        _cam_from(ptr, 6)
    elif scene_idx == 5:
        # softgym_torus.h:40-58: radius, rest_dis_coef, num, size,
        # lowerx, height, lowerz, frictions (ignored), cam(8)
        _scenes.torus_scene(
            sim, n_tori=int(ptr[2]), big_r=float(ptr[3]),
            small_r=float(ptr[3]) * 0.375, radius=float(ptr[0]),
            lower=(float(ptr[4]), 0.0, float(ptr[6])),
            height=float(ptr[5]))
        _cam_from(ptr, 9)
    elif scene_idx == 6:
        # softgym_cloth3d.h:318-364: garment params + cloth_type
        # (0 Tshirt / 1 Trousers / 2 Bimanual) + index resolving
        # $CLOTH3D_PATH/<prefix>/<index:04d>.obj
        cloth_type, index = int(ptr[20]), int(ptr[21])
        prefix = {0: "Tshirt", 1: "Trousers", 2: "Bimanual"}[cloth_type]
        root = os.environ.get("CLOTH3D_PATH", "")
        path = os.path.join(root, prefix, f"{index:04d}.obj")
        if root and os.path.exists(path):
            verts, faces = load_obj(path)
        elif cloth_type in (0, 1):
            from bifold_tpu_torch.env.garments import trousers_mesh, tshirt_mesh
            warnings.warn(
                f"CLOTH3D mesh {path!r} not found; using the procedural "
                f"{prefix} garment (env/garments.py) instead")
            verts, faces, _ = (tshirt_mesh if cloth_type == 0
                               else trousers_mesh)(scale=1.0)
        else:
            raise FileNotFoundError(
                f"CLOTH3D mesh {path!r} not found (set $CLOTH3D_PATH)")
        _garment_scene(sim, ptr, verts, faces)
        _cam_from(ptr, 11)
    elif scene_idx == 7:
        # softgym_softbody.h:134-152: per-instance cluster params; the
        # cluster spacing maps to our constraint-lattice link radius and
        # cluster stiffness to the constraint stiffness
        _scenes.softbody_scene(
            sim, stiffness=float(ptr[3]),
            link_radius_factor=max(float(ptr[1]), 1.2))
    else:
        raise ValueError(f"unknown scene index {scene_idx} "
                         "(pyflex.cpp:25-41 registers 0..7)")


# ---------------------------------------------------------------------------
# stepping + rendering (pyflex_step :252, pyflex_render :871)

def step(update_params=None, capture: int = 0, path: str = "",
         render: int = 0):
    """Advance one frame. GIF capture (capture/path) is unsupported —
    softgym's envs always pass capture=0; use ClothEnv.render_gif instead."""
    sim = _require_sim()
    if capture:
        raise NotImplementedError(
            "pyflex_compat.step: capture is unsupported; use "
            "ClothEnv.render_gif (bifold_tpu_torch/env/cloth_env.py)")
    del update_params, path
    sim.step()
    if render:
        return globals()["render"]()
    return None


def render(capture: int = 0, path: str = "") -> Tuple[np.ndarray, np.ndarray]:
    """(rgba uint8 flat (h*w*4), camera-space depth float32 flat (h*w)),
    row 0 = image top — matching pyflex_render's post-GL-flip output
    (pyflex.cpp:871-960)."""
    sim = _require_sim()
    if capture:
        raise NotImplementedError(
            "pyflex_compat.render: capture is unsupported; use "
            "ClothEnv.render_gif (bifold_tpu_torch/env/cloth_env.py)")
    del path
    img, depth = sim.render()
    return img.reshape(-1).copy(), depth.astype(np.float32).reshape(-1)


def render_cloth(capture: int = 0, path: str = "") -> Tuple[np.ndarray, np.ndarray]:
    """pyflex_render_cloth draws cloth only (g_clothOnly, pyflex.cpp:1142);
    our rasterizer draws the particle system's mesh already, so this is
    render() with colliders hidden for the call."""
    sim = _require_sim()
    # hide ALL shape buffers symmetrically: the two render backends take
    # their shape count from different arrays (sim.py:789, native.py:87-88)
    fields = ("shape_states", "shape_types", "shape_params", "shape_radii",
              "shape_colors")
    saved = {f: getattr(sim, f) for f in fields}
    try:
        sim.shape_states = np.zeros((0, 14), np.float32)
        sim.shape_types = np.zeros((0,), np.int32)
        sim.shape_params = np.zeros((0, 3), np.float32)
        sim.shape_radii = np.zeros((0,), np.float32)
        sim.shape_colors = np.zeros((0, 3), np.float32)
        return render(capture, path)
    finally:
        for f, v in saved.items():
            setattr(sim, f, v)


def get_camera_params() -> np.ndarray:
    """[cam_pos(3), cam_angle(3), width, height] float32 — the layout
    set_camera_params consumes (pyflex.cpp:842-869)."""
    sim = _require_sim()
    p = sim.camera_params
    return np.concatenate([
        np.asarray(p["pos"], np.float32).reshape(3),
        np.asarray(p["angle"], np.float32).reshape(3),
        np.asarray([p["width"], p["height"]], np.float32)])


def set_camera_params(update_camera_param) -> None:
    ptr = np.asarray(update_camera_param, np.float32).reshape(-1)
    sim = _require_sim()
    sim.set_camera_params({
        **sim.camera_params,
        "pos": ptr[0:3], "angle": ptr[3:6],
        "width": int(ptr[6]), "height": int(ptr[7])})


# ---------------------------------------------------------------------------
# kinematic shapes (pyflex.cpp:300-343, 748-841)

def add_box(halfEdge, center, quat, trigger: int = 0) -> None:
    _require_sim().add_box(np.asarray(halfEdge, np.float32).reshape(3),
                           np.asarray(center, np.float32).reshape(3),
                           quat=_quat_wxyz(quat), trigger=trigger)


def add_sphere(radius: float, position, quat) -> None:
    _require_sim().add_sphere(float(radius),
                              np.asarray(position, np.float32).reshape(3),
                              quat=_quat_wxyz(quat))


def add_capsule(params, lower_pos, quat) -> None:
    p = np.asarray(params, np.float32).reshape(-1)
    _require_sim().add_capsule(float(p[0]), float(p[1]),
                               np.asarray(lower_pos, np.float32).reshape(3),
                               quat=_quat_wxyz(quat))


def pop_box(num: int) -> None:
    _require_sim().pop_box(int(num))


def clear_shapes() -> None:
    _require_sim().clear_shapes()


def set_shape_color(color) -> None:
    _require_sim().set_shape_color(np.asarray(color, np.float32).reshape(3))


def get_shape_states() -> np.ndarray:
    return _states_ours_to_pyflex(_require_sim().get_shape_states()).reshape(-1)


def set_shape_states(states) -> None:
    _require_sim().set_shape_states(_states_pyflex_to_ours(states))


# ---------------------------------------------------------------------------
# particle state (pyflex.cpp:436-470, 1154-1177)

def get_n_particles() -> int:
    return _require_sim().get_n_particles()


def get_n_shapes() -> int:
    return _require_sim().get_n_shapes()


def get_positions() -> np.ndarray:
    """Flat (n*4,) float32 [x, y, z, invMass] per particle."""
    return _require_sim().get_positions().reshape(-1)


def set_positions(positions) -> None:
    _require_sim().set_positions(positions)


def get_restPositions() -> np.ndarray:
    """Flat (n*4,) like get_positions (pyflex.cpp get_restPositions pads
    w with the rest w); our rest buffer is xyz-only so w echoes invMass."""
    sim = _require_sim()
    rest = sim.get_rest_positions()
    return np.concatenate([rest, sim.positions[:, 3:4]], 1).reshape(-1)


def get_velocities() -> np.ndarray:
    return _require_sim().get_velocities().reshape(-1)


def set_velocities(velocities) -> None:
    _require_sim().set_velocities(velocities)


def get_phases() -> np.ndarray:
    return _require_sim().get_phases()


def set_phases(phases) -> None:
    _require_sim().set_phases(phases)


def get_groups() -> np.ndarray:
    return _require_sim().get_groups()


def set_groups(groups) -> None:
    _require_sim().set_groups(groups)


def get_scene_lower() -> np.ndarray:
    lo = _require_sim().get_scene_lower()
    return (np.full(3, -np.inf, np.float32) if lo is None
            else np.asarray(lo, np.float32))


def get_scene_upper() -> np.ndarray:
    hi = _require_sim().get_scene_upper()
    return (np.full(3, np.inf, np.float32) if hi is None
            else np.asarray(hi, np.float32))


# ---------------------------------------------------------------------------
# rigid bodies (pyflex.cpp:471-747)

def get_n_rigids() -> int:
    return _require_sim().get_n_rigids()


def get_n_rigidPositions() -> int:
    return _require_sim().get_n_rigid_positions()


def get_rigidOffsets() -> np.ndarray:
    return _require_sim().get_rigid_offsets().astype(np.int32)


def get_rigidIndices() -> np.ndarray:
    return _require_sim().get_rigid_indices().astype(np.int32)


def get_rigidLocalPositions() -> np.ndarray:
    return _require_sim().get_rigid_local_positions().reshape(-1)


def get_rigidGlobalPositions() -> np.ndarray:
    return _require_sim().get_rigid_global_positions().reshape(-1)


def get_rigidRotations() -> np.ndarray:
    """Flat (n_rigids*4,) quats in pyflex (x, y, z, w) order. The sim's
    shape-matching warm-start quats (w, x, y, z) ARE the current cluster
    rotations (sim.py _extract_rotation updates them in place each step)."""
    q = np.asarray(_require_sim().rigid_quats, np.float32).reshape(-1, 4)
    return np.roll(q, -1, axis=1).reshape(-1)


def get_rigidTranslations() -> np.ndarray:
    return _require_sim().get_rigid_translations().reshape(-1)


def add_rigid_body(positions, velocities, num: int, lower) -> None:
    """Despite the name, the reference APPENDS free particles at
    lower+positions with the given velocities and a fluid/self-collide
    phase — its rigid-constraint construction is commented out
    (pyflex.cpp:471-530). We reproduce the observable behavior."""
    sim = _require_sim()
    num = int(num)
    pos = np.asarray(positions, np.float32).reshape(-1, 4)[:num]
    vel = np.asarray(velocities, np.float32).reshape(-1, 3)[:num]
    xyz = pos[:, :3] + np.asarray(lower, np.float32).reshape(1, 3)
    phases = sim.get_phases()  # materialize defaults before appending
    new = np.concatenate([xyz, pos[:, 3:4]], 1)
    sim.positions = np.concatenate([sim.positions, new])
    sim.rest_positions = np.concatenate([sim.rest_positions, xyz])
    sim.velocities = np.concatenate([sim.velocities, vel])
    # NvFlexMakePhase(5, eNvFlexPhaseSelfCollide | eNvFlexPhaseFluid)
    sim.phases = np.concatenate([
        phases, np.full(num, make_phase(5, True, False, True), np.int32)])
    sim.valence = np.concatenate([sim.valence, np.ones(num, np.float32)])
    sim.colors = np.concatenate([
        sim.colors, np.tile(np.array([0.3, 0.5, 0.9], np.float32), (num, 1))])
