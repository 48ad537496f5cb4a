"""The port's non-cloth scenes, pyflex-shaped module API, XMLModel and
``__version__`` against the JAX package's.

Every scenario of tests/test_scenes.py and tests/test_pyflex_compat.py runs
at its sizes through both packages; the positions, velocities, shape
states, rigid queries and renders each one reads are held bitwise equal
(the extended scenes run the simulator's numpy step in both packages; the
cloth scenes run the C++ core, which both packages build from the same
source with the same flags), and the port's own results satisfy the JAX
tests' assertions. The port's ``pyflex_compat.init()`` builds the C++ core
(it never falls back to numpy).
"""

import types

import numpy as np
import pytest

import bifold_tpu
import bifold_tpu_torch

PACKAGES = ("bifold_tpu", "bifold_tpu_torch")


def _modules(package):
    import importlib

    return types.SimpleNamespace(
        scenes=importlib.import_module(f"{package}.env.scenes"),
        sim=importlib.import_module(f"{package}.env.sim"),
        pyflex=importlib.import_module(f"{package}.env.pyflex_compat"),
        xml=importlib.import_module(f"{package}.env.xml_model"))


def _sim(m, **kw):
    kw.setdefault("native", None)
    kw.setdefault("iterations", 8)
    return m.sim.ClothSim(**kw)


def _state(sim):
    return {"positions": sim.get_positions().copy(),
            "velocities": sim.get_velocities().copy(),
            "shape_states": sim.get_shape_states().copy()}


# ---------------------------------------------------------------------------
# tests/test_scenes.py's scenarios: each returns what it read, after the JAX
# test's own assertions on it

def rope_hangs_from_pin(m):
    sim = _sim(m)
    m.scenes.rope_scene(sim, segments=30, spacing=0.01, start=(0.0, 0.5, 0.0),
                        direction=(1.0, 0.0, 0.0), pin_first=True)
    p0 = sim.get_positions()
    for _ in range(120):
        sim.step()
    p = sim.get_positions()
    assert np.all(np.isfinite(p))
    np.testing.assert_allclose(p[0, :3], p0[0, :3], atol=1e-6)
    assert p[-1, 1] < 0.35
    seg = np.linalg.norm(np.diff(p[:, :3], axis=0), axis=1)
    assert abs(seg.sum() - 30 * 0.01) / (30 * 0.01) < 0.15
    return _state(sim)


def fluid_settles_in_container(m):
    from scipy.spatial import cKDTree

    sim = _sim(m, iterations=6)
    m.scenes.fluid_scene(sim, dim=(6, 8, 6), lower=(-0.06, 0.15, -0.06), radius=0.04,
                         bounds_lo=(-0.12, 0.0, -0.12), bounds_hi=(0.12, 10.0, 0.12))
    assert (sim.get_phases() & m.sim.PHASE_FLUID).all()
    top0 = sim.get_positions()[:, 1].max()
    for _ in range(60):
        sim.step()
    p = sim.get_positions()
    assert np.all(np.isfinite(p))
    assert p[:, 1].max() < top0
    assert p[:, 0].min() >= -0.12 - 1e-5 and p[:, 0].max() <= 0.12 + 1e-5
    assert p[:, 2].min() >= -0.12 - 1e-5 and p[:, 2].max() <= 0.12 + 1e-5
    assert p[:, 1].min() >= -1e-5
    dmin = cKDTree(p[:, :3]).query(p[:, :3], k=2)[0][:, 1]
    assert np.median(dmin) > 0.25 * 0.04
    return {**_state(sim), "phases": sim.get_phases()}


def rigid_torus_keeps_shape(m):
    sim = _sim(m)
    m.scenes.torus_scene(sim, n_tori=1, big_r=0.05, small_r=0.02, radius=0.02, height=0.15)
    n = sim.get_n_particles()
    assert sim.get_n_rigids() == 1
    assert sim.get_n_rigid_positions() == n
    p0 = sim.get_positions()[:, :3]
    d0 = np.linalg.norm(p0[0] - p0[n // 2])
    for _ in range(80):
        sim.step()
    p = sim.get_positions()[:, :3]
    assert np.all(np.isfinite(p))
    t = sim.get_rigid_translations()[0]
    assert t[1] < 0.15
    assert p[:, 1].min() > -1e-4
    d = np.linalg.norm(p[0] - p[n // 2])
    assert abs(d - d0) / d0 < 0.05
    r = sim.get_rigid_rotations()[0]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-4)
    return {**_state(sim), "translations": sim.get_rigid_translations(),
            "rotations": sim.get_rigid_rotations(),
            "local": sim.get_rigid_local_positions(),
            "global": sim.get_rigid_global_positions()}


def rigid_cloth_plates_separate_groups(m):
    sim = _sim(m)
    m.scenes.rigid_cloth_scene(sim, plates=2, dims=(6, 1, 4), radius=0.02)
    assert sim.get_n_rigids() == 2
    groups = sim.get_groups()
    assert set(groups.tolist()) == {1, 2}
    for _ in range(40):
        sim.step()
    p = sim.get_positions()[:, :3]
    assert np.all(np.isfinite(p))
    assert p[:, 1].min() > -1e-4
    return {**_state(sim), "groups": groups, "offsets": sim.get_rigid_offsets(),
            "indices": sim.get_rigid_indices(), "rotations": sim.get_rigid_rotations()}


def softbody_block_holds_together(m):
    sim = _sim(m)
    m.scenes.softbody_scene(sim, dims=(5, 5, 5), spacing=0.02, lower=(0.0, 0.2, 0.0),
                            stiffness=0.4)
    ext0 = np.ptp(sim.get_positions()[:, :3], axis=0)
    for _ in range(100):
        sim.step()
    p = sim.get_positions()[:, :3]
    assert np.all(np.isfinite(p))
    assert p[:, 1].min() < 0.05
    ext = np.ptp(p, axis=0)
    assert np.all(ext < 3.0 * np.maximum(ext0, 0.02))
    assert np.all(ext > 0.25 * ext0)
    return _state(sim)


def box_collider_supports_particles(m):
    sim = _sim(m)
    m.scenes.softbody_scene(sim, dims=(3, 3, 3), spacing=0.02, lower=(-0.02, 0.2, -0.02),
                            stiffness=0.5)
    sim.add_box((0.1, 0.05, 0.1), pos=(0.0, 0.05, 0.0))
    for _ in range(100):
        sim.step()
    p = sim.get_positions()[:, :3]
    assert p[:, 1].min() > 0.09
    return _state(sim)


def capsule_collider_deflects(m):
    sim = _sim(m)
    m.scenes.rope_scene(sim, segments=20, spacing=0.01, start=(-0.05, 0.2, 0.0),
                        pin_first=False)
    sim.add_capsule(0.04, 0.1, pos=(0.0, 0.1, 0.0))
    for _ in range(80):
        sim.step()
    p = sim.get_positions()[:, :3]
    assert np.all(np.isfinite(p))
    t = np.clip(p[:, 0], -0.1, 0.1)
    closest = np.stack([t, np.full(len(p), 0.1), np.zeros(len(p))], axis=1)
    assert np.linalg.norm(p - closest, axis=1).min() > 0.035
    return _state(sim)


def phase_groups_gate_collision(m):
    out = {}
    for groups, expect_separated in (((1, 1), False), ((1, 2), True)):
        sim = _sim(m, self_collision=True, particle_radius=0.01)
        pos = np.array([[0.0, 0.05, 0.0], [0.004, 0.05, 0.0]])
        ph = np.array([m.sim.make_phase(g, False, False) for g in groups], np.int32)
        sim.set_particles(pos, 0.0, phases=ph)
        sim.positions[:, 3] = 1.0
        sim.step()
        d = np.linalg.norm(np.diff(sim.get_positions()[:, :3], axis=0))
        assert (d > 0.006) if expect_separated else (d <= 0.006)
        out.update({f"{k} {groups}": v for k, v in _state(sim).items()})
    return out


def pyflex_api_surface(m):
    sim = _sim(m)
    m.scenes.square_cloth_scene(sim, dimx=8, dimy=8)
    assert sim.get_n_particles() == 64
    sim.add_sphere(0.05, (0, 0.1, 0))
    sim.add_box((0.1, 0.1, 0.1), (0.3, 0.1, 0))
    sim.add_capsule(0.03, 0.08, (0.6, 0.1, 0))
    assert sim.get_n_shapes() == 3
    sim.set_shape_color((1.0, 0.0, 0.0))
    assert np.allclose(sim.shape_colors[-1], (1, 0, 0))
    shapes = sim.get_shape_states().copy()
    sim.pop_box(1)
    assert sim.get_n_shapes() == 2
    sim.clear_shapes()
    assert sim.get_n_shapes() == 0
    ph = sim.get_phases()
    assert len(ph) == 64
    sim.set_groups(np.arange(64) % 3)
    assert set((sim.get_groups()).tolist()) == {0, 1, 2}
    assert (sim.get_phases() & m.sim.PHASE_GROUP_MASK == sim.get_groups()).all()
    assert sim.get_rest_positions().shape == (64, 3)
    with pytest.raises(ValueError):
        m.scenes.set_scene(sim, 6)
    sim.set_scene_bounds((-1, 0, -1), (1, 2, 1))
    assert np.allclose(sim.get_scene_lower(), (-1, 0, -1))
    assert np.allclose(sim.get_scene_upper(), (1, 2, 1))
    return {**_state(sim), "shapes": shapes, "phases": sim.get_phases(),
            "rest": sim.get_rest_positions(), "lower": sim.get_scene_lower(),
            "upper": sim.get_scene_upper()}


def legacy_cloth_path_unchanged(m):
    sim = _sim(m)
    m.scenes.square_cloth_scene(sim, dimx=8, dimy=8)
    assert not sim._uses_extended_features()
    sim.add_sphere(0.05, (0, 0.1, 0))
    assert not sim._uses_extended_features()
    sim.add_box((0.1, 0.1, 0.1), (0.3, 0.1, 0))
    assert sim._uses_extended_features()
    assert sim._native is not None
    for _ in range(5):
        sim.step()
    return _state(sim)


SCENE_CASES = [rope_hangs_from_pin, fluid_settles_in_container, rigid_torus_keeps_shape,
               rigid_cloth_plates_separate_groups, softbody_block_holds_together,
               box_collider_supports_particles, capsule_collider_deflects,
               phase_groups_gate_collision, pyflex_api_surface, legacy_cloth_path_unchanged]


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("case", SCENE_CASES, ids=[c.__name__ for c in SCENE_CASES])
def test_scene_matches_jax(case):
    _same(case(_modules("bifold_tpu_torch")), case(_modules("bifold_tpu")))


# ---------------------------------------------------------------------------
# tests/test_pyflex_compat.py's scenarios, through each package's module

def _cloth_params(dimx=12, dimz=10, mass=0.5):
    p = np.zeros(19, np.float32)
    p[0:3] = [0.1, 0.05, -0.2]
    p[3], p[4] = dimx, dimz
    p[5:8] = [0.9, 0.3, 0.9]
    p[8] = 2
    p[9:12] = [0.0, 0.8, 0.0]
    p[12:15] = [0.0, -np.pi / 2, 0.0]
    p[15:17] = [64, 64]
    p[17] = mass
    return p


def _flat(pyflex):
    return {"positions": pyflex.get_positions(), "velocities": pyflex.get_velocities(),
            "shape_states": pyflex.get_shape_states(), "phases": pyflex.get_phases()}


def cloth_scene_packed_params_and_step(pyflex):
    pyflex.set_scene(0, _cloth_params())
    assert pyflex._sim._native is not None
    n = pyflex.get_n_particles()
    assert n == 12 * 10
    pos = pyflex.get_positions().reshape(n, 4)
    assert pos[:, 0].min() == pytest.approx(0.1, abs=1e-5)
    assert pos[:, 2].min() == pytest.approx(-0.2, abs=1e-5)
    assert pos[0, 3] == pytest.approx(n / 0.5, rel=1e-5)
    cam = pyflex.get_camera_params()
    assert cam[1] == pytest.approx(0.8)
    assert int(cam[6]) == 64
    before = pos[:, 1].mean()
    for _ in range(20):
        pyflex.step()
    after = pyflex.get_positions().reshape(n, 4)[:, 1].mean()
    assert after < before
    return {**_flat(pyflex), "camera": cam}


def positions_velocities_flat_roundtrip(pyflex):
    pyflex.set_scene(0, _cloth_params(dimx=6, dimz=6))
    n = pyflex.get_n_particles()
    pos = pyflex.get_positions()
    assert pos.shape == (n * 4,) and pos.dtype == np.float32
    pos[1::4] += 0.25
    pyflex.set_positions(pos)
    assert np.allclose(pyflex.get_positions(), pos)
    vel = pyflex.get_velocities()
    assert vel.shape == (n * 3,)
    vel[:] = 0.1
    pyflex.set_velocities(vel)
    assert np.allclose(pyflex.get_velocities(), 0.1)
    rest = pyflex.get_restPositions()
    assert rest.shape == (n * 4,)
    pyflex.step()
    return {**_flat(pyflex), "rest": rest}


def shapes_xyzw_quat_convention(pyflex):
    pyflex.add_box([0.1, 0.2, 0.3], [0.0, 0.5, 0.0], [0.0, 0.0, 0.0, 1.0], 0)
    pyflex.add_sphere(0.05, [0.3, 0.1, 0.0], [0.0, 0.0, 0.0, 1.0])
    pyflex.add_capsule([0.04, 0.1], [0.0, 0.2, 0.3], [0.0, 0.0, 0.0, 1.0])
    assert pyflex.get_n_shapes() == 3
    states = pyflex.get_shape_states().reshape(3, 14)
    assert np.allclose(states[:, 6:10], [0, 0, 0, 1])
    assert np.allclose(pyflex._sim.shape_states[:, 6:10], [[1, 0, 0, 0]] * 3)
    out = {"states": states.copy()}
    states[0, 0:3] = [1.0, 2.0, 3.0]
    states[1, 6:10] = [0.0, np.sin(0.3), 0.0, np.cos(0.3)]
    pyflex.set_shape_states(states)
    assert np.allclose(pyflex._sim.shape_states[0, :3], [1, 2, 3])
    out["internal"] = pyflex._sim.shape_states.copy()
    pyflex.set_shape_color([0.2, 0.4, 0.6])
    out["colors"] = pyflex._sim.shape_colors.copy()
    pyflex.pop_box(1)
    assert pyflex.get_n_shapes() == 2
    out["popped"] = pyflex.get_shape_states()
    pyflex.clear_shapes()
    assert pyflex.get_n_shapes() == 0
    return out


def rigid_scene_queries(pyflex):
    p = np.zeros(14, np.float32)
    p[0:3] = [6, 1, 4]
    p[3] = 2
    p[4], p[5] = 2.0, 1.0
    p[6:9] = [0.0, 0.8, 0.0]
    p[9:12] = [0.0, -np.pi / 2, 0.0]
    p[12:14] = [64, 64]
    pyflex.set_scene(4, p)
    assert pyflex.get_n_rigids() == 2
    assert pyflex.get_n_rigidPositions() == pyflex.get_n_particles() == 48
    offs = pyflex.get_rigidOffsets()
    assert list(offs) == [0, 24, 48]
    assert pyflex.get_rigidIndices().shape == (48,)
    assert pyflex.get_rigidLocalPositions().shape == (48 * 3,)
    assert np.allclose(pyflex.get_positions().reshape(-1, 4)[:, 3], 2.0)
    for _ in range(5):
        pyflex.step()
    quats = pyflex.get_rigidRotations().reshape(2, 4)
    assert np.all(np.abs(quats[:, 3]) > 0.9)
    assert pyflex.get_rigidTranslations().shape == (6,)
    assert pyflex.get_rigidGlobalPositions().shape == (48 * 3,)
    return {**_flat(pyflex), "offsets": offs, "indices": pyflex.get_rigidIndices(),
            "local": pyflex.get_rigidLocalPositions(), "quats": quats,
            "translations": pyflex.get_rigidTranslations(),
            "global": pyflex.get_rigidGlobalPositions(), "groups": pyflex.get_groups()}


def fluid_rope_tshirt_softbody_scenes(pyflex):
    out = {}
    p = np.zeros(23, np.float32)
    p[0], p[1] = 0.05, 0.55
    p[8:11] = [0.0, 0.1, 0.0]
    p[11:14] = [4, 6, 4]
    p[14:17] = [0.0, 0.8, 0.0]
    p[20:22] = [64, 64]
    pyflex.set_scene(1, p)
    assert pyflex.get_n_particles() == 4 * 6 * 4
    pyflex.step()
    out.update({f"fluid {k}": v for k, v in _flat(pyflex).items()})
    out["fluid lower"], out["fluid upper"] = pyflex.get_scene_lower(), pyflex.get_scene_upper()

    p = np.zeros(17, np.float32)
    p[0:3] = [0.0, 0.5, 0.0]
    p[3], p[4] = 1.0, 0.5
    p[5], p[6] = 0.02, 20
    p[7], p[8] = 0.2, 1.0
    p[15:17] = [64, 64]
    pyflex.set_scene(2, p)
    assert pyflex.get_n_particles() == 21
    pyflex.step()
    out.update({f"rope {k}": v for k, v in _flat(pyflex).items()})

    p = np.zeros(21, np.float32)
    p[0:3] = [0.0, 0.3, 0.0]
    p[3], p[4] = 0.3, 0.5
    p[8], p[9], p[10] = 0.9, 0.5, 0.00625
    p[17:19] = [64, 64]
    pyflex.set_scene(3, p)
    assert pyflex.get_n_particles() > 100
    assert pyflex._sim._native is not None
    pyflex.step()
    out.update({f"tshirt {k}": v for k, v in _flat(pyflex).items()})

    p = np.zeros(8, np.float32)
    p[0] = 1
    p[1], p[2], p[3] = 1.8, 0.0, 0.4
    pyflex.set_scene(7, p)
    assert pyflex.get_n_particles() > 0
    pyflex.step()
    out.update({f"softbody {k}": v for k, v in _flat(pyflex).items()})
    return out


def cloth3d_scene_procedural_fallback(pyflex):
    p = np.zeros(22, np.float32)
    p[0:3] = [0.0, 0.2, 0.0]
    p[3], p[4] = 0.3, 0.0
    p[8], p[9], p[10] = 0.9, 0.5, 0.00625
    p[17:19] = [64, 64]
    p[20], p[21] = 1, 7
    with pytest.warns(UserWarning, match="procedural"):
        pyflex.set_scene(6, p)
    assert pyflex.get_n_particles() > 100
    pyflex.step()
    return _flat(pyflex)


def add_rigid_body_appends_particles(pyflex):
    pyflex.set_scene(0, _cloth_params(dimx=4, dimz=4))
    n0 = pyflex.get_n_particles()
    pos = np.zeros((5, 4), np.float32)
    pos[:, 1] = np.arange(5) * 0.02
    pos[:, 3] = 1.0
    vel = np.zeros((5, 3), np.float32)
    pyflex.add_rigid_body(pos.reshape(-1), vel.reshape(-1), 5,
                          np.array([0.0, 0.5, 0.0], np.float32))
    assert pyflex.get_n_particles() == n0 + 5
    phases = pyflex.get_phases()
    assert phases.shape == (n0 + 5,)
    assert len(set(phases[n0:].tolist())) == 1
    assert phases[n0] != phases[0]
    pyflex.step()
    return _flat(pyflex)


def render_returns_flat_buffers(pyflex):
    pyflex.set_scene(0, _cloth_params(dimx=8, dimz=8))
    img, depth = pyflex.render()
    assert img.dtype == np.uint8 and img.shape == (64 * 64 * 4,)
    assert depth.dtype == np.float32 and depth.shape == (64 * 64,)
    pyflex.add_box([0.05, 0.05, 0.05], [0.0, 0.1, 0.0], [0.0, 0.0, 0.0, 1.0], 0)
    img2, depth2 = pyflex.render_cloth()
    assert img2.shape == img.shape
    assert pyflex.get_n_shapes() == 1
    with pytest.raises(NotImplementedError, match="render_gif"):
        pyflex.step(capture=1)
    with pytest.raises(NotImplementedError, match="capture"):
        pyflex.render(capture=1)
    return {"img": img, "depth": depth, "cloth_img": img2, "cloth_depth": depth2}


def camera_params_roundtrip_and_guards(pyflex):
    cam = pyflex.get_camera_params()
    cam[0:3] = [0.1, 0.9, 0.2]
    pyflex.set_camera_params(cam)
    assert np.allclose(pyflex.get_camera_params()[0:3], [0.1, 0.9, 0.2])
    with pytest.raises(ValueError, match="unknown scene"):
        pyflex.set_scene(42, np.zeros(4, np.float32))
    out = {"camera": pyflex.get_camera_params()}
    pyflex.clean()
    with pytest.raises(RuntimeError, match="init"):
        pyflex.get_n_particles()
    pyflex.init()
    return out


PYFLEX_CASES = [cloth_scene_packed_params_and_step, positions_velocities_flat_roundtrip,
                shapes_xyzw_quat_convention, rigid_scene_queries,
                fluid_rope_tshirt_softbody_scenes, cloth3d_scene_procedural_fallback,
                add_rigid_body_appends_particles, render_returns_flat_buffers,
                camera_params_roundtrip_and_guards]


def _through(package, case):
    pyflex = _modules(package).pyflex
    pyflex.init(headless=True, render=False, camera_width=64, camera_height=64)
    try:
        return case(pyflex)
    finally:
        pyflex.clean()


@pytest.mark.parametrize("case", PYFLEX_CASES, ids=[c.__name__ for c in PYFLEX_CASES])
def test_pyflex_compat_matches_jax(case, monkeypatch):
    monkeypatch.delenv("CLOTH3D_PATH", raising=False)
    _same(_through("bifold_tpu_torch", case), _through("bifold_tpu", case))


def test_pyflex_init_builds_the_native_core(monkeypatch):
    """``init()`` builds the C++ core or raises: with the build refused it
    raises, and never runs numpy quietly."""
    from bifold_tpu_torch.env import pyflex_compat as pyflex
    from bifold_tpu_torch.env import sim

    pyflex.init()
    try:
        assert pyflex._sim._native is not None
    finally:
        pyflex.clean()

    def refuse():
        raise RuntimeError("build refused")

    monkeypatch.setattr(sim, "load_native", refuse)
    with pytest.raises(RuntimeError):
        pyflex.init()
    assert pyflex._sim is None


FLEXCOMP = """<mujoco model="cloth">
  <asset>
    <texture name="grid" type="2d" builtin="checker" width="8" height="8"/>
    <texture name="cloth_texture" type="2d" file="cloth.png"/>
  </asset>
  <worldbody>
    <flexcomp name="cloth" type="grid" count="9 7 1" spacing="0.05 0.05 0.05" mass="1">
      <edge equality="true" damping="0.01"/>
      <plugin plugin="mujoco.elasticity.shell">
        <config key="poisson" value="0"/>
        <config key="thickness" value="8e-3"/>
        <config key="young" value="3e5"/>
      </plugin>
    </flexcomp>
  </worldbody>
</mujoco>
"""


@pytest.mark.parametrize("edit", ["params", "texture"])
def test_xml_model_writes_jax_bytes(tmp_path, edit):
    files = {}
    for package in PACKAGES:
        path = tmp_path / f"{package}.xml"
        path.write_text(FLEXCOMP)
        model = _modules(package).xml.XMLModel(str(path))
        assert model.get_cloth_size() == (9, 7)
        if edit == "params":
            model.modify_params({"mass": 2.5, "edge_damping": 0.02,
                                 "plugin_config_thickness_value": "1e-2",
                                 "plugin_config_young_value": 1e6})
            with pytest.raises(AssertionError):
                model.modify_params({"plugin_config_value": 1})
        else:
            model.change_texture("other.png")
            model.save_changes_to_file(str(tmp_path / f"{package}.out.xml"))
            model.tree.getroot().find("asset").clear()
            with pytest.raises(ValueError):
                model.change_texture("x.png")
        files[package] = {p.name.split(".", 1)[1]: p.read_bytes()
                          for p in sorted(tmp_path.glob(f"{package}.*"))}
    assert files["bifold_tpu_torch"] == files["bifold_tpu"]
    assert (b'damping="0.02"' in files["bifold_tpu_torch"]["xml"]) == (edit == "params")


def test_version_matches_jax():
    from bifold_tpu_torch.version import __version__

    assert bifold_tpu_torch.__version__ == __version__ == bifold_tpu.__version__ == "0.1.0"
