"""``ClothEnv.render_gif``: the port's own GIF writer (numpy and stdlib)
against the JAX package's, which writes through imageio.

Both packages' ``ClothEnv(dump_visualizations=True, render_dim=64)`` (the
cheap env of tests/test_parallel_eval.py, native core) run one dual
pick-and-place from the same Tshirt state of the port's ``build_cache``;
their frames are held bitwise equal. Both ``render_gif`` files are decoded
with imageio and hold the same frame count, size, per-frame delay and loop
(imageio's writer merges a frame that decodes equal to the one before it,
summing their durations, and writes no loop block; the port's does the
same). Each decoded frame of the port's file is within 1.25 x the JAX
file's mean absolute error + 0.5 levels of its source frame, and a frame of
at most 256 colours decodes bitwise. The same holds for frames of many
colours (the episode's frames blended with seeded noise). ``chip_smoke.py``
reads the frame count back from the graphic-control blocks; its reader is
held here against imageio on both files.
"""

import pickle
import sys
from pathlib import Path

import imageio.v2 as imageio
import imageio.v3 as iio
import numpy as np
import pytest

from bifold_tpu.env import cloth_env as jax_env
from bifold_tpu_torch.env import cloth_env as port_env
from bifold_tpu_torch.env.cache_builder import build_cache
from bifold_tpu_torch.utils.visualization import write_gif

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

RES = 64
FPS = 30


@pytest.fixture(scope="module")
def episode(tmp_path_factory):
    root = tmp_path_factory.mktemp("gif")
    with open(build_cache("Tshirt", root / "cache", n_configs=1, settle_steps=10), "rb") as f:
        data = pickle.load(f)
    kp = data["keypoints"][0]
    envs = []
    for mod in (jax_env, port_env):
        env = mod.ClothEnv(render_dim=RES, substeps=2, iterations=6, dump_visualizations=True)
        env.reset(data["configs"][0], state=data["states"][0], cloth3d=True)
        pos = env.sim.get_positions()[:, :3]
        env.pick_and_place_dual(pos[kp[2]], pos[kp[6]], pos[kp[5]], pos[kp[7]])
        envs.append(env)
    return root, envs


def _decode(path):
    frames = [f[..., :3] for f in imageio.mimread(path, memtest=False)]
    metas = [iio.immeta(path, index=i) for i in range(len(frames))]
    return frames, [m.get("duration") for m in metas], metas[0].get("loop")


def _sources(covered, frames):
    """The source frame of each GIF frame: the first of its run."""
    starts = np.concatenate([[0], np.cumsum(covered)[:-1]]).astype(int)
    return [frames[i] for i in starts]


def _both_gifs(root, envs, name):
    paths = [root / f"{name}_jax.gif", root / f"{name}_port.gif"]
    assert envs[0].render_gif(str(paths[0]), fps=FPS) is None
    covered = envs[1].render_gif(str(paths[1]), fps=FPS)
    return paths, covered


def _held(paths, covered, frames):
    (want, want_ms, want_loop), (got, got_ms, got_loop) = map(_decode, paths)
    assert len(got) == len(want) == len(covered) and sum(covered) == len(frames)
    assert got[0].shape == want[0].shape == frames[0].shape
    assert got_ms == want_ms and got_loop == want_loop is None
    for source, a, b in zip(_sources(covered, frames), got, want):
        port_err = np.abs(a.astype(np.int16) - source).mean()
        jax_err = np.abs(b.astype(np.int16) - source).mean()
        assert port_err <= 1.25 * jax_err + 0.5, (port_err, jax_err)
        if len(np.unique(source.reshape(-1, 3), axis=0)) <= 256:
            np.testing.assert_array_equal(a, source)
    for path in paths:
        delays = chip_smoke.gif_delays(Path(path).read_bytes())
        assert len(delays) == len(got)
        assert [chip_smoke.frames_covered(d, FPS) for d in delays] == covered
    return got


def test_episode_frames_bitwise(episode):
    _, (a, b) = episode
    assert len(a.frames) == len(b.frames) > 20
    for x, y in zip(a.frames, b.frames):
        assert y.shape == (RES, RES, 3) and y.dtype == np.uint8
        np.testing.assert_array_equal(x, y)


def test_render_gif_decodes_as_jax(episode):
    root, envs = episode
    paths, covered = _both_gifs(root, envs, "episode")
    got = _held(paths, covered, envs[1].frames)
    assert len(got) < len(envs[1].frames)      # the settled frames merged


def test_render_gif_many_colours(episode):
    """Frames of more than 256 colours: the palette is a median cut."""
    root, envs = episode
    rng = np.random.default_rng(0)
    noisy = [np.clip(f.astype(np.int16) + rng.integers(-24, 25, f.shape), 0, 255)
             .astype(np.uint8) for f in envs[1].frames[::8]]
    noisy.insert(1, noisy[0].copy())               # a repeated frame merges
    kept = [env.frames for env in envs]            # the fixture's, restored
    try:
        for env in envs:
            env.frames = list(noisy)
        paths, covered = _both_gifs(root, envs, "noisy")
    finally:
        for env, frames in zip(envs, kept):
            env.frames = frames
    assert covered[0] == 2 and all(len(np.unique(f.reshape(-1, 3), axis=0)) > 256
                                   for f in noisy)
    _held(paths, covered, noisy)


def test_write_gif_delays_and_shapes(tmp_path):
    """One frame's delay per frame and the frames' size, read back by
    imageio as Pillow's writer's; no loop block, as that writer writes
    none; frames that are not (H, W, 3) raise."""
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (16, 24, 3), dtype=np.uint8) for _ in range(3)]
    assert write_gif(str(tmp_path / "port.gif"), frames, fps=20) == [1, 1, 1]
    with imageio.get_writer(tmp_path / "pillow.gif", mode="I", duration=1000 / 20) as writer:
        for f in frames:
            writer.append_data(f)
    (got, got_ms, got_loop), (want, want_ms, want_loop) = (
        _decode(tmp_path / "port.gif"), _decode(tmp_path / "pillow.gif"))
    assert got_loop == want_loop is None and got_ms == want_ms == [50, 50, 50]
    assert [g.shape for g in got] == [w.shape for w in want] == [(16, 24, 3)] * 3
    with pytest.raises(ValueError):
        write_gif(str(tmp_path / "bad.gif"), [frames[0][..., 0]])
