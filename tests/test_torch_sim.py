"""The port's cloth simulator against the JAX package's, per backend.

The numpy backend: the port's ``ClothSim`` and JAX's, from the same cloth,
over 24 steps of a folded square and of a procedural T-shirt with a picker
dragging a particle, bitwise equal (positions, velocities). The native
backend: the port's own build of ``bifold_tpu_torch/csrc/bifold_sim.cpp``
against the JAX package's library (``csrc/build``'s when it was built, else
``csrc/bifold_sim.cpp`` compiled here with ``csrc/Makefile``'s flags),
bitwise. The port's numpy and native renders are bitwise equal, and equal
to JAX's.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from bifold_tpu.env import sim as jax_sim
from bifold_tpu.env.garments import tshirt_mesh as jax_tshirt
from bifold_tpu_torch.env import native as port_native
from bifold_tpu_torch.env import sim as port_sim
from bifold_tpu_torch.env.garments import tshirt_mesh

ROOT = Path(__file__).resolve().parent.parent
RADIUS = 0.00625
STEPS = 24


@pytest.fixture(scope="session")
def jax_native_lib(tmp_path_factory):
    """The JAX package's native library: csrc/build's, or csrc built with
    the Makefile's flags."""
    built = ROOT / "csrc" / "build" / "libbifold_sim.so"
    if built.exists():
        return built
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build csrc/bifold_sim.cpp")
    out = tmp_path_factory.mktemp("jax_sim") / "libbifold_sim.so"
    subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared",
                    "-o", str(out), str(ROOT / "csrc" / "bifold_sim.cpp")], check=True)
    return out


def _square(mod, native):
    sim = mod.ClothSim(particle_radius=RADIUS, substeps=2, iterations=8, native=native)
    verts, faces = mod.grid_cloth(16, 16, RADIUS, center=(0.0, 0.02, 0.0))
    sim.set_cloth(verts, faces)
    pos = sim.get_positions()
    top = pos[:, 2] > 1e-6
    pos[top, 2] = -pos[top, 2]
    pos[top, 1] += 3.0 * RADIUS
    sim.set_positions(pos)
    sim.set_velocities(np.zeros((len(pos), 3), np.float32))
    return sim


def _garment(mod, native, mesh):
    sim = mod.ClothSim(particle_radius=RADIUS, substeps=2, iterations=8, native=native)
    verts, faces, _ = mesh(scale=0.22)
    sim.set_cloth(verts, faces, mass=0.5)
    pos = sim.get_positions()
    pos[:, 1] += 0.02
    sim.set_positions(pos)
    return sim


def _drive(sim):
    """A picker sphere lifting particle 0 for STEPS steps."""
    sim.add_sphere(0.01, sim.get_positions()[0, :3])
    out = []
    for i in range(STEPS):
        pos = sim.get_positions()
        shapes = sim.get_shape_states()
        shapes[:, 3:6] = shapes[:, :3]
        shapes[0, :3] += np.array([0.0, 0.004, 0.002], np.float32)
        pos[0, :3] = shapes[0, :3]
        pos[0, 3] = 0.0
        sim.set_shape_states(shapes)
        sim.set_positions(pos)
        sim.step()
        out.append((sim.get_positions().copy(), sim.get_velocities().copy()))
    return out


def _equal(a, b):
    assert len(a) == len(b) == STEPS
    for (pa, va), (pb, vb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(va, vb)


def test_source_is_a_copy():
    assert (port_native.SOURCE.read_bytes()
            == (ROOT / "csrc" / "bifold_sim.cpp").read_bytes())


@pytest.mark.parametrize("scene", ["square", "tshirt"])
def test_numpy_backend_bitwise(scene):
    if scene == "square":
        a, b = _square(jax_sim, False), _square(port_sim, False)
    else:
        a, b = _garment(jax_sim, False, jax_tshirt), _garment(port_sim, False, tshirt_mesh)
    assert a._native is None and b._native is None
    _equal(_drive(a), _drive(b))


@pytest.mark.parametrize("scene", ["square", "tshirt"])
def test_native_backend_bitwise(scene, jax_native_lib, monkeypatch):
    monkeypatch.setenv("BIFOLD_SIM_LIB", str(jax_native_lib))
    if scene == "square":
        a, b = _square(jax_sim, True), _square(port_sim, None)
    else:
        a, b = _garment(jax_sim, True, jax_tshirt), _garment(port_sim, None, tshirt_mesh)
    assert a._native is not None and b._native is not None
    _equal(_drive(a), _drive(b))


def test_native_is_built_in_the_port(monkeypatch):
    """native=None builds the port's own library (never csrc/build's) and
    native=False runs numpy."""
    monkeypatch.setenv("BIFOLD_SIM_LIB", "/nonexistent")
    sim = port_sim.ClothSim(native=None)
    path = Path(sim._native.lib._name)
    assert path.parent == ROOT / "bifold_tpu_torch" / "_build"
    assert path.name.startswith("libbifold_sim-")
    assert port_sim.ClothSim(native=False)._native is None


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(port_native, "SOURCE", bad)
    monkeypatch.setattr(port_native, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        port_native.build()


@pytest.mark.parametrize("shading", ["smooth", "flat"])
def test_renders_bitwise(shading, jax_native_lib, monkeypatch):
    monkeypatch.setenv("BIFOLD_SIM_LIB", str(jax_native_lib))
    sims = [_garment(port_sim, False, tshirt_mesh), _garment(port_sim, None, tshirt_mesh),
            _garment(jax_sim, True, jax_tshirt)]
    frames = []
    for sim in sims:
        sim.shading = shading
        for _ in range(3):
            sim.step()
        frames.append(sim.render(96, 80))
    for rgba, depth in frames[1:]:
        np.testing.assert_array_equal(rgba, frames[0][0])
        np.testing.assert_array_equal(depth, frames[0][1])
    assert (frames[0][1] < port_sim.FAR_DEPTH).any()
