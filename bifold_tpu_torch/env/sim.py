"""Particle cloth simulator: XPBD solver + z-buffer software renderer.

The port's copy of bifold_tpu/env/sim.py (the whole file: the legacy cloth
step, the numpy and native renderers and the extended XPBD step). It stands
in for the reference's vendored NVIDIA FleX stack (prebuilt CUDA solver +
OpenGL renderer). The evaluation metric is *consistency* — model rollout vs
oracle rollout in the SAME simulator (success = mean particle error <
2*radius) — so the solver prioritizes determinism and stable cloth
behavior: position-based dynamics with structural/shear/bend distance
constraints, ground friction, and kinematic sphere colliders (the pickers).
It is host code: numpy and C++, nothing of it on the card.

Backends: the vectorized numpy implementation here, and the C++ core
(``bifold_tpu_torch/csrc/bifold_sim.cpp``, built at first use and loaded via
ctypes, :mod:`bifold_tpu_torch.env.native`), which implements the identical
step/render math for speed. ``ClothSim(native=None)`` (or ``True``) builds
and uses the native core and raises when the build fails;
``native=False`` runs numpy.

Cloth state mirrors the reference's pyflex buffers so SoftGym-style caches
round-trip: positions (N, 4: xyz + inv_mass), velocities (N, 3), shape states
(P, 14: pos, prev_pos, quat, prev_quat), camera params.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from bifold_tpu_torch.env.native import load_native

__all__ = ["ClothSim", "ParticleSim", "grid_cloth", "load_obj",
           "DEFAULT_CAMERA", "FAR_DEPTH", "make_phase",
           "PHASE_GROUP_MASK", "PHASE_SELF_COLLIDE",
           "PHASE_SELF_COLLIDE_FILTER", "PHASE_FLUID"]

FAR_DEPTH = _FAR_DEPTH = 2.0

# Particle phase encoding (the API contract of FleX's NvFlexMakePhase /
# pyflex get_phases/set_phases, pyflex.cpp:1159-1162): collision group in
# the low bits, behavior flags above. Semantics here: particles in
# DIFFERENT groups always collide; particles in the SAME group collide only
# when both carry SELF_COLLIDE, and the rest-distance filter (mesh
# neighbors never repel) applies when both carry SELF_COLLIDE_FILTER.
# FLUID marks particles integrated by the PBF density solver instead of
# distance constraints.
PHASE_GROUP_MASK = 0x00FFFFFF
PHASE_SELF_COLLIDE = 1 << 24
PHASE_SELF_COLLIDE_FILTER = 1 << 25
PHASE_FLUID = 1 << 26

# kinematic collider shape types (shape_types entries)
SHAPE_SPHERE, SHAPE_BOX, SHAPE_CAPSULE = 0, 1, 2


def make_phase(group: int, self_collide: bool = True,
               self_collide_filter: bool = True, fluid: bool = False) -> int:
    """NvFlexMakePhase equivalent: pack a collision group + behavior flags."""
    p = group & PHASE_GROUP_MASK
    if self_collide:
        p |= PHASE_SELF_COLLIDE
    if self_collide_filter:
        p |= PHASE_SELF_COLLIDE_FILTER
    if fluid:
        p |= PHASE_FLUID
    return p


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors v (.., 3) by quaternion q = (w, x, y, z)."""
    return v @ _quat_to_mat(np.asarray(q, np.float64)).T


def _extract_rotation(a: np.ndarray, q: np.ndarray,
                      max_iter: int = 20) -> np.ndarray:
    """Rotational part of a 3x3 deformation matrix by warm-started
    quaternion iteration (Mueller et al. 2016, "A robust method to extract
    the rotational part of deformations") — the same update is implemented
    operation-for-operation in csrc/bifold_sim.cpp so the two backends
    agree. q = (w, x, y, z) warm start, updated in place; returns R."""
    for _ in range(max_iter):
        r = _quat_to_mat(q)
        # omega = (sum_k cross(R[:,k], A[:,k])) / (|sum_k dot(R[:,k], A[:,k])| + eps)
        num = (np.cross(r[:, 0], a[:, 0]) + np.cross(r[:, 1], a[:, 1])
               + np.cross(r[:, 2], a[:, 2]))
        den = abs(float(r[:, 0] @ a[:, 0] + r[:, 1] @ a[:, 1]
                        + r[:, 2] @ a[:, 2])) + 1e-9
        omega = num / den
        ang = float(np.sqrt(omega @ omega))
        if ang < 1e-9:
            break
        axis = omega / ang
        half = 0.5 * ang
        dq = np.array([np.cos(half), *(np.sin(half) * axis)])
        q[:] = _quat_mul(dq, q)
        q /= np.sqrt(q @ q)
    return _quat_to_mat(q)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _poly6(r2, h: float):
    """SPH poly6 kernel W(r) on squared distances (PBF density)."""
    h2 = h * h
    c = 315.0 / (64.0 * np.pi * h ** 9)
    d = np.maximum(h2 - r2, 0.0)
    return c * d * d * d


def _spiky_grad_coeff(r, h: float):
    """|gradW_spiky|(r)/r so grad = coeff * (pi - pj); guarded near r=0."""
    c = -45.0 / (np.pi * h ** 6)
    d = np.maximum(h - r, 0.0)
    return c * d * d / np.maximum(r, 1e-9)

DEFAULT_CAMERA = {
    "pos": np.array([0.0, 0.65, 0.0]),
    "angle": np.array([0.0, -np.pi / 2.0, 0.0]),
    "width": 720,
    "height": 720,
}


def grid_cloth(dimx: int, dimy: int, spacing: float,
               center=(0.0, 0.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Flat grid cloth in the XZ plane: vertices (N, 3), faces (F, 3).

    Particle index layout matches the reference's square cloth
    (softgym_cloth_env.py:392-414): row-major, index 0 at (-x, -z)."""
    xs = (np.arange(dimx) - (dimx - 1) / 2.0) * spacing
    zs = (np.arange(dimy) - (dimy - 1) / 2.0) * spacing
    xx, zz = np.meshgrid(xs, zs)  # (dimy, dimx)
    verts = np.stack([xx + center[0],
                      np.full_like(xx, center[1]),
                      zz + center[2]], axis=-1).reshape(-1, 3)
    faces = []
    for j in range(dimy - 1):
        for i in range(dimx - 1):
            a = j * dimx + i
            b = a + 1
            c = a + dimx
            d = c + 1
            faces.append([a, b, c])
            faces.append([b, d, c])
    return verts.astype(np.float32), np.asarray(faces, np.int64)


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ loader (v + f, polygons fan-triangulated, 1-based)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def _dedup_vertices(verts: np.ndarray, faces: np.ndarray, tol: float = 1e-6):
    """Merge coincident vertices (FleX-style dedup the reference's scenes do,
    softgym_cloth3d.h:90-130) so seams simulate as one piece of cloth.
    Returns (unique_verts, remapped_faces, orig->unique index map)."""
    key = np.round(verts / tol).astype(np.int64)
    _, first_idx, inverse = np.unique(key, axis=0, return_index=True,
                                      return_inverse=True)
    return verts[first_idx], inverse[faces], inverse


def _edges_from_faces(faces: np.ndarray) -> np.ndarray:
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def _bend_pairs(faces: np.ndarray) -> np.ndarray:
    """Opposite-vertex pairs across shared edges (cross-edge bend springs)."""
    from collections import defaultdict
    edge_faces = defaultdict(list)
    for fi, (a, b, c) in enumerate(faces):
        for u, v, w in ((a, b, c), (b, c, a), (c, a, b)):
            edge_faces[(min(u, v), max(u, v))].append(w)
    pairs = set()
    for opp in edge_faces.values():
        for i in range(len(opp)):
            for j in range(i + 1, len(opp)):
                if opp[i] != opp[j]:
                    pairs.add((min(opp[i], opp[j]), max(opp[i], opp[j])))
    if not pairs:
        return np.zeros((0, 2), np.int64)
    return np.asarray(sorted(pairs), np.int64)


class ClothSim:
    """One cloth + kinematic picker spheres + pinhole camera renderer."""

    def __init__(self, particle_radius: float = 0.00625,
                 substeps: int = 4, iterations: int = 12,
                 dt: float = 1.0 / 100.0, damping: float = 0.995,
                 ground_friction: float = 0.3,
                 self_collision: bool = True,
                 native: Optional[bool] = None):
        self.particle_radius = particle_radius
        self.substeps = substeps
        self.iterations = iterations
        self.dt = dt
        self.damping = damping
        self.ground_friction = ground_friction
        # FleX self-collides cloth particles by construction
        # (softgym_cloth3d.h:360 eNvFlexPhaseSelfCollide|SelfCollideFilter,
        # :380 radius): particles separate to the collision distance unless
        # their REST distance is already below it (mesh neighbors)
        self.self_collision = self_collision
        self.self_collision_dist = 2.0 * particle_radius
        self.camera_params: Dict = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                                    for k, v in DEFAULT_CAMERA.items()}
        # scene lighting / shading (render): smooth per-vertex Lambert
        # approximates the reference's OpenGL smooth-shaded cloth
        # (pyflex.cpp:871 render path); "flat" keeps the per-face shade.
        self.shading = "smooth"
        _light = np.array([0.3, 0.9, 0.2], np.float32)
        self.light_dir = (_light / np.float32(np.linalg.norm(_light)))
        self.ambient = 0.55
        self.diffuse = 0.45
        self.uvs: Optional[np.ndarray] = None       # (N, 2) in [0, 1]
        self.texture: Optional[np.ndarray] = None   # (TH, TW, 3) float 0..1
        self._native = load_native() if native in (None, True) else None
        self._clear()

    # ------------------------------------------------------------------
    # Scene setup
    # ------------------------------------------------------------------

    def _clear(self):
        self.rest_positions = np.zeros((0, 3), np.float32)
        self.positions = np.zeros((0, 4), np.float32)
        self.velocities = np.zeros((0, 3), np.float32)
        self.faces = np.zeros((0, 3), np.int64)
        self.edges = np.zeros((0, 2), np.int64)
        self.rest_lengths = np.zeros((0,), np.float32)
        self.stretch_stiffness = np.zeros((0,), np.float32)
        self.shape_states = np.zeros((0, 14), np.float32)
        self.shape_radii = np.zeros((0,), np.float32)
        self.colors = np.zeros((0, 3), np.float32)
        self.valence = np.zeros((0,), np.float32)
        # pyflex-parity particle/shape state beyond cloth (scenes.py):
        # phases (collision groups + flags), typed kinematic colliders,
        # shape-matching rigid bodies, PBF fluid parameters, scene bounds
        self.phases = np.zeros((0,), np.int32)
        self.shape_types = np.zeros((0,), np.int32)     # SHAPE_* per collider
        self.shape_params = np.zeros((0, 3), np.float32)
        self.shape_colors = np.zeros((0, 3), np.float32)
        self.rigid_offsets = np.zeros((1,), np.int64)
        self.rigid_indices = np.zeros((0,), np.int64)
        self.rigid_locals = np.zeros((0, 3), np.float32)
        self.rigid_stiffness = np.zeros((0,), np.float32)
        self.rigid_quats = np.zeros((0, 4), np.float64)   # warm starts (w,x,y,z)
        self.rigid_rotations = np.zeros((0, 3, 3), np.float32)
        self.rigid_translations = np.zeros((0, 3), np.float32)
        self.fluid_rest_density = 0.0
        self.fluid_h = 0.0         # smoothing radius; 0 = no fluid solve
        self.fluid_scorr_k = 0.0   # PBF artificial-pressure strength (off:
        # anti-clustering comes from the rest-distance separation pass; the
        # s_corr term is dimensionally unstable at these particle scales)
        self.bounds_lo: Optional[np.ndarray] = None
        self.bounds_hi: Optional[np.ndarray] = None

    def set_cloth(self, vertices: np.ndarray, faces: np.ndarray, *,
                  mass: float = 0.5, stretch: float = 0.9,
                  bend: float = 0.3, dedup: bool = True,
                  color=(0.85, 0.35, 0.25)):
        """Install a cloth mesh; constraints from face edges + bend pairs."""
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        if dedup:
            vertices, faces, _ = _dedup_vertices(vertices, faces)
        n = len(vertices)
        # rest geometry drives the self-collision filter: pairs already closer
        # than the collision distance at rest (mesh neighbors) never repel
        self.rest_positions = vertices.copy()
        inv_mass = np.full((n,), n / max(mass, 1e-9), np.float32)
        self.positions = np.concatenate(
            [vertices, inv_mass[:, None]], axis=1).astype(np.float32)
        self.velocities = np.zeros((n, 3), np.float32)
        self.faces = faces
        stretch_edges = _edges_from_faces(faces)
        bend_edges = _bend_pairs(faces)
        self.edges = np.concatenate([stretch_edges, bend_edges])
        p = vertices
        self.rest_lengths = np.linalg.norm(
            p[self.edges[:, 0]] - p[self.edges[:, 1]], axis=1).astype(np.float32)
        self.stretch_stiffness = np.concatenate([
            np.full(len(stretch_edges), stretch, np.float32),
            np.full(len(bend_edges), bend, np.float32)])
        # per-vertex constraint valence: Jacobi corrections are averaged (not
        # summed) per vertex, otherwise dense constraint stencils diverge
        valence = np.zeros(n, np.int64)
        np.add.at(valence, self.edges.reshape(-1), 1)
        self.valence = np.maximum(valence, 1).astype(np.float32)
        self.colors = np.tile(np.asarray(color, np.float32), (n, 1))

    def clear(self):
        """Reset every particle/constraint/shape buffer (pyflex ``clean``)."""
        self._clear()

    def set_particles(self, positions, inv_mass, *, edges=None,
                      rest_lengths=None, stiffness=None, faces=None,
                      rest_positions=None, phases=None, colors=None,
                      color=(0.55, 0.6, 0.9)):
        """Install an arbitrary particle system (the generic core behind the
        rope/softbody/torus/rigid/fluid scenes in env/scenes.py — the
        counterpart of the reference's non-cloth FleX demo scenes,
        softgym_scenes/*.h). ``edges`` are distance constraints; rigid
        bodies and fluids are configured afterwards with add_rigid_body /
        set_fluid_params + FLUID phases."""
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        n = len(positions)
        inv_mass = np.broadcast_to(
            np.asarray(inv_mass, np.float32), (n,)).astype(np.float32)
        self.rest_positions = (positions.copy() if rest_positions is None
                               else np.asarray(rest_positions, np.float32))
        self.positions = np.concatenate(
            [positions, inv_mass[:, None]], axis=1).astype(np.float32)
        self.velocities = np.zeros((n, 3), np.float32)
        self.faces = (np.zeros((0, 3), np.int64) if faces is None
                      else np.asarray(faces, np.int64))
        self.edges = (np.zeros((0, 2), np.int64) if edges is None
                      else np.asarray(edges, np.int64).reshape(-1, 2))
        if rest_lengths is None:
            d = positions[self.edges[:, 0]] - positions[self.edges[:, 1]]
            rest_lengths = np.linalg.norm(d, axis=1)
        self.rest_lengths = np.asarray(rest_lengths, np.float32)
        if stiffness is None:
            stiffness = np.ones(len(self.edges), np.float32)
        self.stretch_stiffness = np.broadcast_to(
            np.asarray(stiffness, np.float32),
            (len(self.edges),)).astype(np.float32)
        valence = np.zeros(n, np.int64)
        np.add.at(valence, self.edges.reshape(-1), 1)
        self.valence = np.maximum(valence, 1).astype(np.float32)
        self.phases = (np.zeros((0,), np.int32) if phases is None
                       else np.broadcast_to(np.asarray(phases, np.int32),
                                            (n,)).astype(np.int32))
        if colors is None:
            colors = np.tile(np.asarray(color, np.float32), (n, 1))
        self.colors = np.asarray(colors, np.float32).reshape(n, 3)
        self.rigid_offsets = np.zeros((1,), np.int64)
        self.rigid_indices = np.zeros((0,), np.int64)
        self.rigid_locals = np.zeros((0, 3), np.float32)
        self.rigid_stiffness = np.zeros((0,), np.float32)
        self.rigid_quats = np.zeros((0, 4), np.float64)
        self.rigid_rotations = np.zeros((0, 3, 3), np.float32)
        self.rigid_translations = np.zeros((0, 3), np.float32)
        self.fluid_h = 0.0

    def _add_shape(self, shape_type: int, params, pos, quat,
                   color=(0.6, 0.6, 0.6)):
        state = np.zeros((1, 14), np.float32)
        state[0, :3] = pos
        state[0, 3:6] = pos
        state[0, 6:10] = quat
        state[0, 10:14] = quat
        self.shape_states = np.concatenate([self.shape_states, state])
        p = np.zeros((1, 3), np.float32)
        p[0, :len(params)] = params
        self.shape_params = np.concatenate([self.shape_params, p])
        self.shape_types = np.concatenate(
            [self.shape_types, np.asarray([shape_type], np.int32)])
        # shape_radii stays the sphere-compat view (legacy C ABI + pickers)
        self.shape_radii = np.concatenate(
            [self.shape_radii, np.asarray([params[0]], np.float32)])
        self.shape_colors = np.concatenate(
            [self.shape_colors,
             np.asarray(color, np.float32).reshape(1, 3)])

    def add_sphere(self, radius: float, pos, quat=(1.0, 0.0, 0.0, 0.0)):
        self._add_shape(SHAPE_SPHERE, [radius], pos, quat)

    def add_box(self, half_extents, pos, quat=(1.0, 0.0, 0.0, 0.0),
                trigger: int = 0):
        """Kinematic box collider (pyflex add_box, pyflex.cpp:1143-1148).
        ``trigger`` boxes are ignored by the solver (FleX trigger shapes
        report overlap only; we keep the argument for API parity)."""
        self._add_shape(SHAPE_BOX if not trigger else -1,
                        list(half_extents), pos, quat)

    def add_capsule(self, radius: float, half_length: float, pos,
                    quat=(1.0, 0.0, 0.0, 0.0)):
        """Kinematic capsule collider along its local x axis (pyflex
        add_capsule)."""
        self._add_shape(SHAPE_CAPSULE, [radius, half_length], pos, quat)

    def pop_box(self, num: int = 1):
        """Remove the last ``num`` shapes (pyflex pop_box)."""
        keep = max(len(self.shape_types) - num, 0)
        self.shape_states = self.shape_states[:keep]
        self.shape_types = self.shape_types[:keep]
        self.shape_params = self.shape_params[:keep]
        self.shape_radii = self.shape_radii[:keep]
        self.shape_colors = self.shape_colors[:keep]

    def clear_shapes(self):
        self.pop_box(len(self.shape_types))

    def set_shape_color(self, color, index: int = -1):
        """Display color of a collider shape (pyflex set_shape_color)."""
        if len(self.shape_colors):
            self.shape_colors[index] = np.asarray(color, np.float32)

    # -- rigid bodies (FleX shape-matching clusters; pyflex get_rigid*) ----

    def add_rigid_body(self, indices, stiffness: float = 1.0):
        """Register particles [indices] as one shape-matching rigid cluster
        (pyflex add_rigid_body / the rigidOffsets//rigidLocalPositions
        buffers). Local coords are taken about the CURRENT center of mass."""
        indices = np.asarray(indices, np.int64).reshape(-1)
        pos = self.positions[indices, :3].astype(np.float64)
        inv_m = self.positions[indices, 3].astype(np.float64)
        w = np.where(inv_m > 0, 1.0 / np.maximum(inv_m, 1e-12), 0.0)
        if w.sum() <= 0:
            w = np.ones_like(w)
        com = (pos * w[:, None]).sum(0) / w.sum()
        self.rigid_offsets = np.concatenate(
            [self.rigid_offsets,
             [self.rigid_offsets[-1] + len(indices)]]).astype(np.int64)
        self.rigid_indices = np.concatenate([self.rigid_indices, indices])
        self.rigid_locals = np.concatenate(
            [self.rigid_locals, (pos - com).astype(np.float32)])
        self.rigid_stiffness = np.concatenate(
            [self.rigid_stiffness, np.asarray([stiffness], np.float32)])
        self.rigid_quats = np.concatenate(
            [self.rigid_quats, np.array([[1.0, 0.0, 0.0, 0.0]])])
        self.rigid_rotations = np.concatenate(
            [self.rigid_rotations, np.eye(3, dtype=np.float32)[None]])
        self.rigid_translations = np.concatenate(
            [self.rigid_translations, com.astype(np.float32)[None]])

    def get_n_rigids(self) -> int:
        return len(self.rigid_offsets) - 1

    def get_n_rigid_positions(self) -> int:
        return len(self.rigid_indices)

    def get_rigid_offsets(self) -> np.ndarray:
        return self.rigid_offsets.copy()

    def get_rigid_indices(self) -> np.ndarray:
        return self.rigid_indices.copy()

    def get_rigid_local_positions(self) -> np.ndarray:
        return self.rigid_locals.copy()

    def get_rigid_global_positions(self) -> np.ndarray:
        return self.positions[self.rigid_indices, :3].copy()

    def get_rigid_rotations(self) -> np.ndarray:
        return self.rigid_rotations.copy()

    def get_rigid_translations(self) -> np.ndarray:
        return self.rigid_translations.copy()

    # -- fluids (PBF density solver over FLUID-phase particles) ------------

    def set_fluid_params(self, smoothing_h: float,
                         rest_density: Optional[float] = None,
                         scorr_k: float = 0.0,
                         rest_spacing: Optional[float] = None):
        """Enable the position-based-fluids solve for FLUID-phase particles.
        ``rest_density`` defaults to the density of a cubic lattice at
        ``rest_spacing`` (default h/2), computed with the same poly6 kernel
        the solver uses — scenes emitting at a different spacing pass it
        here so neutral-pressure density is derived in ONE place (a scene-
        side copy of this lattice sum drifted once; see scenes.fluid_scene).
        ``scorr_k`` (PBF artificial pressure)
        defaults OFF: anti-clustering is handled by separating fluid pairs
        at the fluid rest distance instead (FleX's own
        fluidRestDistance-as-collision-distance approach) — the s_corr term
        blows up at near-contact at these particle scales (measured: one
        close pair ejects particles hundreds of meters)."""
        self.fluid_h = float(smoothing_h)
        self.fluid_scorr_k = float(scorr_k)
        if rest_density is None:
            spacing = (smoothing_h / 2.0 if rest_spacing is None
                       else float(rest_spacing))
            grid = np.mgrid[-2:3, -2:3, -2:3].reshape(3, -1).T * spacing
            r2 = (grid * grid).sum(1)
            rest_density = float(_poly6(r2, smoothing_h).sum())
        self.fluid_rest_density = float(rest_density)

    def fluid_rest_distance_target(self) -> float:
        """Fluid-fluid separation distance: the emission lattice spacing
        (h/2) when the PBF solve is enabled, else 0 (no effect on the
        non-fluid separation distance)."""
        return 0.5 * self.fluid_h if self.fluid_h > 0 else 0.0

    def set_scene_bounds(self, lo, hi):
        """Axis-aligned container walls (pyflex get_scene_lower/upper)."""
        self.bounds_lo = np.asarray(lo, np.float32)
        self.bounds_hi = np.asarray(hi, np.float32)

    def get_scene_lower(self) -> Optional[np.ndarray]:
        return None if self.bounds_lo is None else self.bounds_lo.copy()

    def get_scene_upper(self) -> Optional[np.ndarray]:
        return None if self.bounds_hi is None else self.bounds_hi.copy()

    # ------------------------------------------------------------------
    # pyflex-style state I/O (softgym caches round-trip through these)
    # ------------------------------------------------------------------

    def get_n_particles(self) -> int:
        return len(self.positions)

    def get_n_shapes(self) -> int:
        return len(self.shape_states)

    def get_rest_positions(self) -> np.ndarray:
        return self.rest_positions.copy()

    def get_phases(self) -> np.ndarray:
        """Per-particle phases; the empty buffer means every particle holds
        the cloth default (group 0, self-collide + filter)."""
        if len(self.phases) == len(self.positions):
            return self.phases.copy()
        return np.full(len(self.positions),
                       make_phase(0, True, True), np.int32)

    def set_phases(self, phases) -> None:
        self.phases = np.asarray(phases, np.int32).reshape(-1).copy()

    def get_groups(self) -> np.ndarray:
        return (self.get_phases() & PHASE_GROUP_MASK).astype(np.int32)

    def set_groups(self, groups) -> None:
        ph = self.get_phases()
        ph = (ph & ~PHASE_GROUP_MASK) | (np.asarray(groups, np.int32)
                                         & PHASE_GROUP_MASK)
        self.phases = ph.astype(np.int32)

    def get_positions(self) -> np.ndarray:
        return self.positions.copy()

    def set_positions(self, pos) -> None:
        self.positions = np.asarray(pos, np.float32).reshape(-1, 4).copy()

    def get_velocities(self) -> np.ndarray:
        return self.velocities.copy()

    def set_velocities(self, vel) -> None:
        self.velocities = np.asarray(vel, np.float32).reshape(-1, 3).copy()

    def get_shape_states(self) -> np.ndarray:
        return self.shape_states.copy()

    def set_shape_states(self, states) -> None:
        self.shape_states = np.asarray(states, np.float32).reshape(-1, 14).copy()

    def set_camera_params(self, params: Dict) -> None:
        self.camera_params = {k: (np.asarray(v).copy() if isinstance(v, (list, np.ndarray))
                                  else v) for k, v in params.items()}

    # ------------------------------------------------------------------
    # Dynamics
    # ------------------------------------------------------------------

    def _uses_extended_features(self) -> bool:
        """Scenes beyond plain cloth: explicit phases, rigid bodies, fluids,
        non-sphere colliders, or container bounds. The legacy cloth path is
        kept byte-for-byte so existing trajectories never change."""
        return (len(self.phases) == len(self.positions) != 0
                or self.get_n_rigids() > 0
                or self.fluid_h > 0
                or bool((self.shape_types != SHAPE_SPHERE).any())
                or self.bounds_lo is not None)

    def step(self) -> None:
        if self._uses_extended_features():
            # extended scenes run on the vectorized numpy path only; the
            # native core (csrc) accelerates the legacy cloth step below
            self._step_numpy_ext()
            return
        if self._native is not None and self._native.step(self):
            return
        self._step_numpy()

    def _step_numpy_ext(self) -> None:
        """Extended XPBD step: distance constraints + phase-aware particle
        separation + PBF fluid density constraints (Macklin & Mueller 2013,
        the algorithm class behind FleX's fluid solver) + shape-matching
        rigid clusters (Mueller et al. shape matching — FleX's rigid/
        softbody mechanism) + typed kinematic colliders + container walls.
        Numpy-only (fully vectorized): the native core in csrc accelerates
        the legacy cloth step, not this path."""
        n = len(self.positions)
        if n == 0:
            return
        h = self.dt / self.substeps
        pos = self.positions[:, :3].astype(np.float64)
        inv_m = self.positions[:, 3].astype(np.float64)
        vel = self.velocities.astype(np.float64)
        free = inv_m > 0

        i0 = self.edges[:, 0]
        i1 = self.edges[:, 1]
        w0 = inv_m[i0]
        w1 = inv_m[i1]
        wsum = w0 + w1
        k = self.stretch_stiffness.astype(np.float64)
        rest = self.rest_lengths.astype(np.float64)
        active = wsum > 0
        valence = getattr(self, "valence", np.ones(n, np.float32)).astype(np.float64)

        phases = self.get_phases().astype(np.int64)
        groups = phases & PHASE_GROUP_MASK
        selfc = (phases & PHASE_SELF_COLLIDE) != 0
        filt = (phases & PHASE_SELF_COLLIDE_FILTER) != 0
        is_fluid = (phases & PHASE_FLUID) != 0

        d0 = float(self.self_collision_dist)
        use_sep = self.self_collision
        rest_pos = (self.rest_positions.astype(np.float64)
                    if len(self.rest_positions) == n else None)

        fh = float(self.fluid_h)
        use_fluid = fh > 0 and bool(is_fluid.any())
        if use_fluid:
            rho0 = float(self.fluid_rest_density)
            w_dq = float(_poly6(np.asarray((0.3 * fh) ** 2), fh))
            scorr_k = float(self.fluid_scorr_k)
            fluid_idx = np.where(is_fluid)[0]

        n_rig = self.get_n_rigids()
        rig_stiff = self.rigid_stiffness.astype(np.float64)
        rig_locals = self.rigid_locals.astype(np.float64)

        from scipy.spatial import cKDTree

        for _ in range(self.substeps):
            vel[free, 1] -= 9.8 * h
            vel *= self.damping
            prev = pos.copy()
            pos = pos + vel * h

            # --- separation candidates (phase-aware), sorted (i, j) so the
            # f64 accumulation order matches the C++ twin exactly
            ci = cj = cw0 = cw1 = cws = csep = None
            if use_sep:
                # fluid-fluid pairs separate at the fluid rest distance
                # (FleX's fluidRestDistance-as-collision-distance), giving
                # anti-clustering without PBF artificial pressure
                sep_max = max(d0, self.fluid_rest_distance_target())
                pairs = cKDTree(pos).query_pairs(
                    1.5 * sep_max, output_type="ndarray")
                if len(pairs):
                    a, b = pairs[:, 0], pairs[:, 1]
                    same = groups[a] == groups[b]
                    keep = ~same | (selfc[a] & selfc[b])
                    if rest_pos is not None:
                        rd = np.linalg.norm(rest_pos[a] - rest_pos[b], axis=1)
                        keep &= ~(same & filt[a] & filt[b] & (rd < d0 * 0.999))
                    pairs = pairs[keep]
                if len(pairs):
                    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
                    pairs = pairs[order]
                    ci, cj = pairs[:, 0], pairs[:, 1]
                    cw0 = inv_m[ci]
                    cw1 = inv_m[cj]
                    cws = np.maximum(cw0 + cw1, 1e-12)
                    csep = np.where(is_fluid[ci] & is_fluid[cj],
                                    self.fluid_rest_distance_target(), d0)

            # --- fluid neighbor pairs (fluid-fluid, within h), sorted
            fi = fj = None
            if use_fluid and len(fluid_idx) > 1:
                fp = cKDTree(pos[fluid_idx]).query_pairs(
                    fh, output_type="ndarray")
                if len(fp):
                    order = np.lexsort((fp[:, 1], fp[:, 0]))
                    fp = fp[order]
                    fi = fluid_idx[fp[:, 0]]
                    fj = fluid_idx[fp[:, 1]]

            for _ in range(self.iterations):
                if len(self.edges):
                    d = pos[i0] - pos[i1]
                    dist = np.sqrt((d * d).sum(axis=1)) + 1e-12
                    corr = (dist - rest) / dist / np.maximum(wsum, 1e-12) * k
                    corr = np.where(active, corr, 0.0)
                    dp = d * corr[:, None]
                    delta = np.zeros_like(pos)
                    np.add.at(delta, i0, -dp * w0[:, None])
                    np.add.at(delta, i1, dp * w1[:, None])
                    pos += 1.5 * delta / valence[:, None]

                if ci is not None:
                    d = pos[ci] - pos[cj]
                    dist = np.sqrt((d * d).sum(axis=1)) + 1e-12
                    pen = dist < csep
                    if pen.any():
                        corr = np.where(pen, (dist - csep) / dist / cws, 0.0)
                        dp = d * corr[:, None]
                        cdelta = np.zeros_like(pos)
                        np.add.at(cdelta, ci, -dp * cw0[:, None])
                        np.add.at(cdelta, cj, dp * cw1[:, None])
                        ccount = np.zeros(n, np.float64)
                        np.add.at(ccount, ci, pen.astype(np.float64))
                        np.add.at(ccount, cj, pen.astype(np.float64))
                        pos += cdelta / np.maximum(ccount, 1.0)[:, None]

                # --- PBF density constraint (fluid particles)
                if use_fluid:
                    rho = np.zeros(n, np.float64)
                    rho[fluid_idx] = _poly6(np.asarray(0.0), fh)  # self term
                    grad_sum = np.zeros((n, 3), np.float64)
                    grad_sq = np.zeros(n, np.float64)
                    if fi is not None:
                        d = pos[fi] - pos[fj]
                        r2 = (d * d).sum(axis=1)
                        r = np.sqrt(r2)
                        wij = _poly6(r2, fh)
                        np.add.at(rho, fi, wij)
                        np.add.at(rho, fj, wij)
                        g = d * (_spiky_grad_coeff(r, fh) / rho0)[:, None]
                        np.add.at(grad_sum, fi, g)
                        np.add.at(grad_sum, fj, -g)
                        gsq = (g * g).sum(axis=1)
                        np.add.at(grad_sq, fi, gsq)
                        np.add.at(grad_sq, fj, gsq)
                    # repulsion-only: act when over-dense (c_i > 0, lam < 0);
                    # under-dense surface particles get no cohesive pull —
                    # cohesion + s_corr is the classic PBF ejection failure
                    c_i = rho / rho0 - 1.0
                    denom = (grad_sum * grad_sum).sum(axis=1) + grad_sq + 1e-6
                    lam = np.where(is_fluid, np.minimum(-c_i / denom, 0.0), 0.0)
                    if fi is not None:
                        scorr = -scorr_k * (wij / max(w_dq, 1e-12)) ** 4
                        coef = (lam[fi] + lam[fj] + scorr) / rho0
                        dpf = d * (coef * _spiky_grad_coeff(r, fh))[:, None]
                        fdelta = np.zeros_like(pos)
                        np.add.at(fdelta, fi, dpf)
                        np.add.at(fdelta, fj, -dpf)
                        pos[fluid_idx] += fdelta[fluid_idx]

                # --- rigid shape matching
                for ri in range(n_rig):
                    lo_, hi_ = self.rigid_offsets[ri], self.rigid_offsets[ri + 1]
                    idx = self.rigid_indices[lo_:hi_]
                    q_local = rig_locals[lo_:hi_]
                    p = pos[idx]
                    com = p.mean(axis=0)
                    a = (p - com).T @ q_local  # 3x3 covariance
                    r_mat = _extract_rotation(a, self.rigid_quats[ri])
                    target = com + q_local @ r_mat.T
                    s = rig_stiff[ri]
                    mov = free[idx]
                    p[mov] += s * (target[mov] - p[mov])
                    pos[idx] = p
                    self.rigid_rotations[ri] = r_mat.astype(np.float32)
                    self.rigid_translations[ri] = com.astype(np.float32)

                # --- ground plane + friction
                floor = self.particle_radius * 0.5
                below = pos[:, 1] < floor
                if below.any():
                    tangent = pos[below][:, [0, 2]] - prev[below][:, [0, 2]]
                    pos[below, 0] -= tangent[:, 0] * self.ground_friction
                    pos[below, 2] -= tangent[:, 1] * self.ground_friction
                    pos[below, 1] = floor

                # --- typed kinematic colliders
                margin = self.particle_radius * 0.5
                for s in range(len(self.shape_states)):
                    st = int(self.shape_types[s]) if s < len(self.shape_types) \
                        else SHAPE_SPHERE
                    if st < 0:
                        continue  # trigger shapes don't collide
                    sp = self.shape_states[s, :3].astype(np.float64)
                    quat = self.shape_states[s, 6:10].astype(np.float64)
                    prm = self.shape_params[s].astype(np.float64) \
                        if s < len(self.shape_params) else \
                        np.array([self.shape_radii[s], 0, 0], np.float64)
                    if st == SHAPE_SPHERE:
                        rr = prm[0] + margin
                        dvec = pos - sp
                        ddist = np.sqrt((dvec * dvec).sum(axis=1)) + 1e-12
                        pen = ddist < rr
                        if pen.any():
                            pos[pen] = sp + dvec[pen] / ddist[pen, None] * rr
                    elif st == SHAPE_BOX:
                        # quat order is (w, x, y, z) throughout this sim
                        rot = _quat_to_mat(quat)
                        local = (pos - sp) @ rot  # = rot.T applied row-wise
                        he = prm + margin
                        inside = np.all(np.abs(local) < he, axis=1)
                        if inside.any():
                            li = local[inside]
                            # push out along the axis of least penetration
                            pen_ax = he - np.abs(li)
                            ax = np.argmin(pen_ax, axis=1)
                            rows = np.arange(len(li))
                            sign = np.where(li[rows, ax] >= 0, 1.0, -1.0)
                            li[rows, ax] = sign * he[ax]
                            local[inside] = li
                            pos[inside] = local[inside] @ rot.T + sp
                    elif st == SHAPE_CAPSULE:
                        rot = _quat_to_mat(quat)
                        axis = rot[:, 0]  # local x
                        t = np.clip((pos - sp) @ axis, -prm[1], prm[1])
                        closest = sp + t[:, None] * axis[None]
                        rr = prm[0] + margin
                        dvec = pos - closest
                        ddist = np.sqrt((dvec * dvec).sum(axis=1)) + 1e-12
                        pen = ddist < rr
                        if pen.any():
                            pos[pen] = (closest[pen]
                                        + dvec[pen] / ddist[pen, None] * rr)

                # --- container walls
                if self.bounds_lo is not None:
                    lo_b = self.bounds_lo.astype(np.float64) + margin
                    hi_b = self.bounds_hi.astype(np.float64) - margin
                    pos = np.clip(pos, lo_b, hi_b)

            vel = (pos - prev) / h
            vel[~free] = 0.0

        self.positions[:, :3] = pos.astype(np.float32)
        self.velocities = vel.astype(np.float32)

    def _step_numpy(self) -> None:
        n = len(self.positions)
        if n == 0:
            return
        h = self.dt / self.substeps
        pos = self.positions[:, :3].astype(np.float64)
        inv_m = self.positions[:, 3].astype(np.float64)
        vel = self.velocities.astype(np.float64)
        free = inv_m > 0

        i0 = self.edges[:, 0]
        i1 = self.edges[:, 1]
        w0 = inv_m[i0]
        w1 = inv_m[i1]
        wsum = w0 + w1
        k = self.stretch_stiffness.astype(np.float64)
        rest = self.rest_lengths.astype(np.float64)
        active = wsum > 0

        valence = getattr(self, "valence", np.ones(n, np.float32)).astype(np.float64)
        sph_pos = self.shape_states[:, :3].astype(np.float64)
        sph_r = self.shape_radii.astype(np.float64) if len(self.shape_radii) else None

        d0 = float(self.self_collision_dist)
        use_self = self.self_collision and len(self.rest_positions) == n
        rest_pos = self.rest_positions.astype(np.float64) if use_self else None
        ci = cj = cw0 = cw1 = cws = None

        for _ in range(self.substeps):
            vel[free, 1] -= 9.8 * h
            vel *= self.damping
            prev = pos.copy()
            pos = pos + vel * h

            if use_self:
                # neighbor pairs once per substep (FleX builds its neighbor
                # grid once per step); 1.5x margin catches pairs that close
                # in during the iteration loop
                from scipy.spatial import cKDTree
                pairs = cKDTree(pos).query_pairs(1.5 * d0, output_type="ndarray")
                if len(pairs):
                    rd = np.linalg.norm(rest_pos[pairs[:, 0]]
                                        - rest_pos[pairs[:, 1]], axis=1)
                    pairs = pairs[rd >= d0 * 0.999]
                ci, cj = (pairs[:, 0], pairs[:, 1]) if len(pairs) else (None, None)
                if ci is not None:
                    cw0 = inv_m[ci]
                    cw1 = inv_m[cj]
                    cws = np.maximum(cw0 + cw1, 1e-12)

            for _ in range(self.iterations):
                d = pos[i0] - pos[i1]
                dist = np.sqrt((d * d).sum(axis=1)) + 1e-12
                corr = (dist - rest) / dist / np.maximum(wsum, 1e-12) * k
                corr = np.where(active, corr, 0.0)
                dp = d * corr[:, None]
                # Jacobi accumulation with under-relaxation
                delta = np.zeros_like(pos)
                np.add.at(delta, i0, -dp * w0[:, None])
                np.add.at(delta, i1, dp * w1[:, None])
                pos += 1.5 * delta / valence[:, None]

                # particle-particle self-collision: separate penetrating
                # pairs to d0, Jacobi-averaged by per-particle contact count
                if ci is not None:
                    d = pos[ci] - pos[cj]
                    dist = np.sqrt((d * d).sum(axis=1)) + 1e-12
                    pen = dist < d0
                    if pen.any():
                        corr = np.where(pen, (dist - d0) / dist / cws, 0.0)
                        dp = d * corr[:, None]
                        cdelta = np.zeros_like(pos)
                        np.add.at(cdelta, ci, -dp * cw0[:, None])
                        np.add.at(cdelta, cj, dp * cw1[:, None])
                        ccount = np.zeros(n, np.float64)
                        np.add.at(ccount, ci, pen.astype(np.float64))
                        np.add.at(ccount, cj, pen.astype(np.float64))
                        pos += cdelta / np.maximum(ccount, 1.0)[:, None]

                # ground plane y >= 0 (particle radius offset)
                floor = self.particle_radius * 0.5
                below = pos[:, 1] < floor
                if below.any():
                    # simple Coulomb-ish friction: damp tangential motion of
                    # particles resting on the floor
                    tangent = pos[below][:, [0, 2]] - prev[below][:, [0, 2]]
                    pos[below, 0] -= tangent[:, 0] * self.ground_friction
                    pos[below, 2] -= tangent[:, 1] * self.ground_friction
                    pos[below, 1] = floor

                # sphere colliders (pickers)
                if sph_r is not None and len(sph_pos):
                    for s in range(len(sph_pos)):
                        rr = sph_r[s] + self.particle_radius * 0.5
                        dvec = pos - sph_pos[s]
                        ddist = np.sqrt((dvec * dvec).sum(axis=1)) + 1e-12
                        pen = ddist < rr
                        if pen.any():
                            pos[pen] = (sph_pos[s]
                                        + dvec[pen] / ddist[pen, None] * rr)

            vel = (pos - prev) / h
            vel[~free] = 0.0

        self.positions[:, :3] = pos.astype(np.float32)
        self.velocities = vel.astype(np.float32)

    # ------------------------------------------------------------------
    # Rendering
    # ------------------------------------------------------------------

    def _camera_matrix(self) -> np.ndarray:
        from bifold_tpu_torch.ops.geometry import matrix_world_to_camera
        return matrix_world_to_camera(self.camera_params["pos"],
                                      self.camera_params["angle"])

    def render(self, width: Optional[int] = None,
               height: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """(rgba uint8 (H, W, 4), depth float32 (H, W)).

        Depth = camera-space z (what get_world_coord_from_pixel unprojects,
        softgym_cloth_env.py:61-82); empty pixels get the far-plane depth 2.0
        (> the 0.996 mask threshold, like FleX's far background) so
        get_mask_from_depth sees background and bilinear resize at cloth
        borders blends upward, not toward zero. Row 0 = image TOP
        (the reference flips the GL buffer; we rasterize top-down directly).
        """
        width = width or int(self.camera_params["width"])
        height = height or int(self.camera_params["height"])
        if self._native is not None:
            out = self._native.render(self, width, height)
            if out is not None:
                return out
        return self._render_numpy(width, height)

    def _render_numpy(self, width: int, height: int):
        """Z-buffer rasterizer (smooth/flat Lambert + optional texture).

        Every float op is float32 in the SAME order as bifold_render_ex
        (csrc/bifold_sim.cpp) — elementwise IEEE ops are deterministic, so
        the two backends produce bit-identical frames (test_sim render
        parity). Smooth shading interpolates per-vertex normals + colors
        barycentrically like GL's smooth-shaded cloth."""
        from bifold_tpu_torch.ops.geometry import intrinsic_from_fov
        m = np.asarray(self._camera_matrix(), np.float32)
        k = intrinsic_from_fov(height, width, fov=45)
        fx, fy, u0, v0 = (np.float32(k[0, 0]), np.float32(k[1, 1]),
                          np.float32(k[0, 2]), np.float32(k[1, 2]))

        depth = np.full((height, width), _FAR_DEPTH, np.float32)
        color = np.full((height, width, 3), 255, np.uint8)

        if len(self.positions) == 0 or len(self.faces) == 0:
            rgba = np.concatenate(
                [color, np.full((height, width, 1), 255, np.uint8)], axis=-1)
            return rgba, depth

        pts = self.positions[:, :3].astype(np.float32)
        x, y, zw = pts[:, 0], pts[:, 1], pts[:, 2]
        cam = [((m[r, 0] * x + m[r, 1] * y) + m[r, 2] * zw) + m[r, 3]
               for r in range(3)]
        z = cam[2]
        zz = np.maximum(z, np.float32(1e-9))
        u = cam[0] * fx / zz + u0
        v = cam[1] * fy / zz + v0

        smooth = getattr(self, "shading", "flat") == "smooth"
        light = np.asarray(self.light_dir, np.float32)
        ambient = np.float32(self.ambient)
        diffuse = np.float32(self.diffuse)
        textured = self.uvs is not None and self.texture is not None
        if textured:
            uvs = np.asarray(self.uvs, np.float32)
            tex = np.asarray(self.texture, np.float32)
            th, tw = tex.shape[:2]

        tri = self.faces
        p3 = pts[tri]
        e1 = p3[:, 1] - p3[:, 0]
        e2 = p3[:, 2] - p3[:, 0]
        fn = np.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                       e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                       e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], axis=1)
        if smooth:
            vn = np.zeros((len(pts), 3), np.float32)
            for corner in range(3):  # corner-major == the C++ accumulation
                np.add.at(vn, tri[:, corner], fn)
            nl_v = np.sqrt((vn[:, 0] * vn[:, 0] + vn[:, 1] * vn[:, 1])
                           + vn[:, 2] * vn[:, 2]) + np.float32(1e-12)
            vn = vn / nl_v[:, None]

        tz = ((z[tri[:, 0]] + z[tri[:, 1]]) + z[tri[:, 2]]) / np.float32(3)
        nl_f = np.sqrt((fn[:, 0] * fn[:, 0] + fn[:, 1] * fn[:, 1])
                       + fn[:, 2] * fn[:, 2]) + np.float32(1e-12)
        lam_f = ambient + diffuse * np.abs(
            ((fn[:, 0] * light[0] + fn[:, 1] * light[1])
             + fn[:, 2] * light[2]) / nl_f)
        colors32 = self.colors.astype(np.float32)

        # init at the far depth like the native backend: anything at or
        # beyond 2.0 loses the z test identically in both
        zbuf = np.full((height, width), _FAR_DEPTH, np.float32)
        half = np.float32(0.5)

        # face order, not depth-sorted: on an exact z tie (shared coplanar
        # edges) the FIRST-drawn face wins, and the native backend iterates
        # in face order — same order keeps the frames bit-identical
        for t in range(len(tri)):
            if tz[t] <= 1e-6:
                continue
            ia, ib, ic = tri[t]
            xs = np.array([u[ia], u[ib], u[ic]], np.float32)
            ys = np.array([v[ia], v[ib], v[ic]], np.float32)
            zs = np.array([z[ia], z[ib], z[ic]], np.float32)
            x_min = max(int(np.floor(xs.min())), 0)
            x_max = min(int(np.ceil(xs.max())) + 1, width)
            y_min = max(int(np.floor(ys.min())), 0)
            y_max = min(int(np.ceil(ys.max())) + 1, height)
            if x_min >= x_max or y_min >= y_max:
                continue
            gx, gy = np.meshgrid(
                np.arange(x_min, x_max, dtype=np.float32) + half,
                np.arange(y_min, y_max, dtype=np.float32) + half)
            d = ((ys[1] - ys[2]) * (xs[0] - xs[2])
                 + (xs[2] - xs[1]) * (ys[0] - ys[2]))
            if abs(d) < 1e-12:
                continue
            w0 = ((ys[1] - ys[2]) * (gx - xs[2]) + (xs[2] - xs[1]) * (gy - ys[2])) / d
            w1 = ((ys[2] - ys[0]) * (gx - xs[2]) + (xs[0] - xs[2]) * (gy - ys[2])) / d
            w2 = np.float32(1.0) - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if not inside.any():
                continue
            zi = w0 * zs[0] + w1 * zs[1] + w2 * zs[2]
            sub_z = zbuf[y_min:y_max, x_min:x_max]
            closer = inside & (zi < sub_z)
            sub_z[closer] = zi[closer]
            sub_c = color[y_min:y_max, x_min:x_max]
            if smooth:
                na, nb, nc = vn[ia], vn[ib], vn[ic]
                nx = (w0 * na[0] + w1 * nb[0]) + w2 * nc[0]
                ny = (w0 * na[1] + w1 * nb[1]) + w2 * nc[1]
                nz = (w0 * na[2] + w1 * nb[2]) + w2 * nc[2]
                pnl = np.sqrt((nx * nx + ny * ny) + nz * nz) + np.float32(1e-12)
                dl = (nx * light[0] + ny * light[1]) + nz * light[2]
                lam = ambient + diffuse * np.abs(dl / pnl)
                if textured:
                    uu = (w0 * uvs[ia, 0] + w1 * uvs[ib, 0]) + w2 * uvs[ic, 0]
                    vv = (w0 * uvs[ia, 1] + w1 * uvs[ib, 1]) + w2 * uvs[ic, 1]
                    ix = np.clip((uu * np.float32(tw)).astype(np.int32),
                                 0, tw - 1)
                    iy = np.clip((vv * np.float32(th)).astype(np.int32),
                                 0, th - 1)
                    base = tex[iy, ix]
                else:
                    ca, cb, cc = colors32[ia], colors32[ib], colors32[ic]
                    base = ((w0[..., None] * ca + w1[..., None] * cb)
                            + w2[..., None] * cc)
                shade_px = np.clip(base * lam[..., None] * np.float32(255.0),
                                   0, 255).astype(np.uint8)
                sub_c[closer] = shade_px[closer]
            else:
                if textured:
                    base_f = tex[
                        min(max(int(uvs[ia, 1] * np.float32(th)), 0), th - 1),
                        min(max(int(uvs[ia, 0] * np.float32(tw)), 0), tw - 1)]
                else:
                    base_f = colors32[ia]
                shade = np.clip(base_f * lam_f[t] * np.float32(255.0),
                                0, 255).astype(np.uint8)
                sub_c[closer] = shade
            zbuf[y_min:y_max, x_min:x_max] = sub_z
            color[y_min:y_max, x_min:x_max] = sub_c

        depth = zbuf
        rgba = np.concatenate(
            [color, np.full((height, width, 1), 255, np.uint8)], axis=-1)
        return rgba, depth


# The sim outgrew cloth (rope/rigid/softbody/fluid scenes live in
# env/scenes.py); ParticleSim is the honest name, ClothSim the original.
ParticleSim = ClothSim
