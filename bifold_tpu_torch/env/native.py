"""Build and bind the simulator's C++ core (``csrc/bifold_sim.cpp``).

The port's copy of bifold_tpu/env/native.py, with its own copy of the
source. The library is compiled by ``g++`` with the flags of the JAX
package's ``csrc/Makefile`` (so that both packages' native steps agree
bitwise) at first use, never at import, into the git-ignored
``bifold_tpu_torch/_build/``, named by a hash of the source and the flags,
and loaded with ``ctypes``: a C ABI (step and render over raw float
buffers).

How the port differs: JAX's ``load_native`` returns ``None`` when no
prebuilt library is found, and its simulator then quietly runs the numpy
backend. Here :func:`load_native` builds the library when it is missing and
raises when the build fails; ``ClothSim(native=False)`` asks for the numpy
backend explicitly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["SOURCE", "CXXFLAGS", "build", "load_native", "NativeSim"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "bifold_sim.cpp"
# csrc/Makefile's CXXFLAGS, then its -shared
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lock = threading.Lock()
_native = None


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXXFLAGS).encode())
    return _BUILD_DIR / f"libbifold_sim-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile :data:`SOURCE` into ``_build/`` (skipped when a library built
    from the same bytes and flags is there) and return its path; raise when
    the compiler is missing or fails."""
    out = _library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the simulator's native core is built "
                           "from bifold_tpu_torch/csrc/bifold_sim.cpp at first use "
                           "(ClothSim(native=False) runs the numpy backend)")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} {SOURCE.name} failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    tmp.replace(out)
    return out


class NativeSim:
    """Thin dispatcher: hands the sim's numpy buffers to the C core."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.bifold_step.restype = ctypes.c_int
        lib.bifold_step.argtypes = [
            f32p, f32p, ctypes.c_int64,               # positions(N,4), velocities(N,3), N
            i64p, f32p, f32p, ctypes.c_int64,         # edges(E,2), rest(E), stiff(E), E
            f32p, f32p, ctypes.c_int64,               # sphere pos(S,14), radii(S), S
            ctypes.c_float, ctypes.c_float, ctypes.c_float,  # dt, damping, friction
            ctypes.c_int, ctypes.c_int, ctypes.c_float,      # substeps, iters, radius
            f32p, ctypes.c_float,                     # rest_positions(N,3), self_coll_dist
        ]
        lib.bifold_render_ex.restype = ctypes.c_int
        lib.bifold_render_ex.argtypes = [
            f32p, ctypes.c_int64,                     # positions(N,4), N
            i64p, ctypes.c_int64,                     # faces(F,3), F
            f32p,                                     # colors(N,3)
            f32p,                                     # world->camera 4x4 row major
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,  # fx fy u0 v0
            ctypes.c_int, ctypes.c_int,               # width height
            f32p,                                     # light_dir(3,) normalized
            ctypes.c_float, ctypes.c_float,           # ambient, diffuse
            ctypes.c_int,                             # smooth (0 flat, 1 smooth)
            f32p, f32p,                               # uvs(N,2) / texture(TH,TW,3), NULL ok
            ctypes.c_int, ctypes.c_int,               # tex_h, tex_w
            ctypes.POINTER(ctypes.c_uint8), f32p,     # out rgba, out depth
        ]

    @staticmethod
    def _ptr(arr, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(ctype))

    def step(self, sim) -> bool:
        pos = np.ascontiguousarray(sim.positions, np.float32)
        vel = np.ascontiguousarray(sim.velocities, np.float32)
        edges = np.ascontiguousarray(sim.edges, np.int64)
        rest = np.ascontiguousarray(sim.rest_lengths, np.float32)
        stiff = np.ascontiguousarray(sim.stretch_stiffness, np.float32)
        sph = np.ascontiguousarray(sim.shape_states, np.float32)
        radii = np.ascontiguousarray(sim.shape_radii, np.float32)
        rest_pos = np.ascontiguousarray(sim.rest_positions, np.float32)
        use_self = (getattr(sim, "self_collision", False)
                    and len(rest_pos) == len(pos))
        ok = self.lib.bifold_step(
            self._ptr(pos, ctypes.c_float), self._ptr(vel, ctypes.c_float),
            len(pos),
            self._ptr(edges, ctypes.c_int64), self._ptr(rest, ctypes.c_float),
            self._ptr(stiff, ctypes.c_float), len(edges),
            self._ptr(sph, ctypes.c_float), self._ptr(radii, ctypes.c_float),
            len(radii),
            sim.dt, sim.damping, sim.ground_friction,
            sim.substeps, sim.iterations, sim.particle_radius,
            self._ptr(rest_pos, ctypes.c_float),
            sim.self_collision_dist if use_self else 0.0)
        if ok != 0:
            return False
        sim.positions = pos
        sim.velocities = vel
        return True

    def render(self, sim, width: int, height: int):
        from bifold_tpu_torch.ops.geometry import intrinsic_from_fov
        if len(sim.faces) == 0:
            return None
        pos = np.ascontiguousarray(sim.positions, np.float32)
        faces = np.ascontiguousarray(sim.faces, np.int64)
        colors = np.ascontiguousarray(sim.colors, np.float32)
        m = np.ascontiguousarray(sim._camera_matrix(), np.float32)
        k = intrinsic_from_fov(height, width, fov=45)
        light = np.ascontiguousarray(sim.light_dir, np.float32)
        smooth = int(getattr(sim, "shading", "flat") == "smooth")
        uvs = tex = None
        th = tw = 0
        if sim.uvs is not None and sim.texture is not None:
            uvs = np.ascontiguousarray(sim.uvs, np.float32)
            tex = np.ascontiguousarray(sim.texture, np.float32)
            th, tw = tex.shape[:2]
        null_f32 = ctypes.POINTER(ctypes.c_float)()
        rgba = np.empty((height, width, 4), np.uint8)
        depth = np.empty((height, width), np.float32)
        ok = self.lib.bifold_render_ex(
            self._ptr(pos, ctypes.c_float), len(pos),
            self._ptr(faces, ctypes.c_int64), len(faces),
            self._ptr(colors, ctypes.c_float),
            self._ptr(m, ctypes.c_float),
            k[0, 0], k[1, 1], k[0, 2], k[1, 2],
            width, height,
            self._ptr(light, ctypes.c_float),
            float(sim.ambient), float(sim.diffuse), smooth,
            self._ptr(uvs, ctypes.c_float) if uvs is not None else null_f32,
            self._ptr(tex, ctypes.c_float) if tex is not None else null_f32,
            th, tw,
            rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._ptr(depth, ctypes.c_float))
        if ok != 0:
            return None
        return rgba, depth


def load_native() -> NativeSim:
    """The native core, built at its first use (once per process)."""
    global _native
    with _lock:
        if _native is None:
            _native = NativeSim(ctypes.CDLL(str(build())))
        return _native
