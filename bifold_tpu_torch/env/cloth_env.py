"""Cloth manipulation environment: pickers + motion primitives over ClothSim.

The port's copy of bifold_tpu/env/cloth_env.py, a counterpart of the
reference's softgym_cloth_env.py (SoftgymClothEnv + Picker/PickerPickPlace):
2 sphere pickers, grasping implemented by zeroing the nearest particle's
inverse mass and co-moving it, the movep servo loop, and the pick-and-place
/ pick-and-drop / pick-and-fling primitives with the same speeds, overshoot
and lift semantics the demonstrators rely on. Scene construction is
procedural (grid cloth / OBJ meshes) instead of FleX scene headers.

How the port differs: the JAX package downsizes the 720 x 720 render with
``cv2.resize(..., INTER_LINEAR)``; the port does it in numpy
(:func:`resize_linear`, the same arithmetic) and imports no cv2.
``render_gif`` writes with the port's own GIF writer
(:func:`bifold_tpu_torch.utils.visualization.write_gif`), not imageio.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Dict, List, Optional

import numpy as np

from bifold_tpu_torch.env.sim import ClothSim, DEFAULT_CAMERA, grid_cloth, load_obj
from bifold_tpu_torch.ops.geometry import intrinsic_from_fov, matrix_world_to_camera

__all__ = ["ClothEnv", "square_cloth_config", "rotate_particles", "move_to_pos",
           "resize_linear"]


def _taps(src: int, dst: int):
    """cv2's INTER_LINEAR source taps and weights along one axis: sample
    position (d + 0.5) * src / dst - 0.5 in double, clamped to the edge
    pixels; the weights are rounded to float32."""
    pos = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo
    left, right = lo < 0, lo >= src - 1
    frac[left | right] = 0.0
    lo[left] = 0
    lo[right] = src - 1
    return lo, np.minimum(lo + 1, src - 1), 1.0 - frac, frac


def resize_linear(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of a square (H, W) float32 or (H, W, C) uint8 image
    to (size, size), with the arithmetic of ``cv2.resize(img, (size, size),
    interpolation=cv2.INTER_LINEAR)`` (no antialiasing). float32: each pass
    is ``fma(w1, s1 - s0, s0)`` with the float32 weight w1 of the far tap,
    the fused multiply-add emulated in float64 (the product is exact there;
    only the sum can round twice). uint8: fixed point, weights round(w *
    2048), the horizontal pass in int32, the vertical one as cv2's vector
    path does it ((r >> 4) * w >> 16 per tap, then (sum + 2) >> 2,
    saturated)."""
    h, w = img.shape[:2]
    x0, x1, ax0, ax1 = _taps(w, size)
    y0, y1, by0, by1 = _taps(h, size)
    if img.dtype == np.uint8:
        def fixed(v):
            return np.rint(v.astype(np.float32) * np.float32(2048)).astype(np.int32)

        ax0, ax1, by0, by1 = fixed(ax0), fixed(ax1), fixed(by0), fixed(by1)
        # the horizontal pass on the source rows the vertical one reads
        used, inverse = np.unique(np.concatenate([y0, y1]), return_inverse=True)
        src = img[used]
        extra = (None,) * (img.ndim - 2)
        rows = src[:, x0].astype(np.int32)
        rows *= ax0[(slice(None), *extra)]
        rows += src[:, x1].astype(np.int32) * ax1[(slice(None), *extra)]
        rows >>= 4
        top = rows[inverse[:size]] * by0[(slice(None), None, *extra)]
        top >>= 16
        bottom = rows[inverse[size:]] * by1[(slice(None), None, *extra)]
        bottom >>= 16
        top += bottom
        top += 2
        top >>= 2
        return np.clip(top, 0, 255).astype(np.uint8)
    if img.dtype != np.float32 or img.ndim != 2:
        raise TypeError(f"resize_linear takes (H, W) float32 or uint8 images, got "
                        f"{img.dtype} {img.shape}")
    def lerp(s0, s1, w1):
        return (w1.astype(np.float32).astype(np.float64) * (s1 - s0) + s0).astype(np.float32)

    rows = lerp(img[:, x0], img[:, x1], ax1)
    return lerp(rows[y0], rows[y1], by1[:, None])


def square_cloth_config(dimx: int = 40, dimy: int = 40,
                        particle_radius: float = 0.00625,
                        mass: float = 0.5,
                        camera_params: Optional[Dict] = None) -> Dict:
    """Procedural square/rect cloth scene config (reference set_square_scene
    consumes ClothPos/ClothSize/ClothStiff params, softgym_cloth_env.py:760-788)."""
    return {
        "ClothSize": [dimx, dimy],
        "mass": mass,
        "particle_radius": particle_radius,
        "cloth_type": "Square" if dimx == dimy else "Rectangular",
        "camera_params": camera_params or {"default_camera": deepcopy(DEFAULT_CAMERA)},
        "camera_name": "default_camera",
    }


def rotate_particles(env: "ClothEnv", angle_zyx_deg) -> None:
    """Rotate the cloth about its center (reference softgym_cloth_env.py:790-801)."""
    from scipy.spatial.transform import Rotation as R
    r = R.from_euler("zyx", angle_zyx_deg, degrees=True)
    pos = env.sim.get_positions()
    center = pos.mean(axis=0)
    pos -= center
    pos[:, :3] = r.apply(pos[:, :3])
    pos += center
    env.sim.set_positions(pos)


def move_to_pos(env: "ClothEnv", new_pos) -> None:
    pos = env.sim.get_positions()
    center = pos[:, :3].mean(axis=0)
    pos[:, :3] += np.asarray(new_pos) - center
    env.sim.set_positions(pos)


class ClothEnv:
    """2-picker cloth env; the evaluators' device-facing surface."""

    def __init__(self, render_dim: int = 224, particle_radius: float = 0.00625,
                 picker_radius: float = 0.01, picker_threshold: float = 0.005,
                 picker_low=(-10.0, 0.0, -10.0), picker_high=(10.0, 10.0, 10.0),
                 dump_visualizations: bool = False, substeps: int = 4,
                 iterations: int = 12, native: Optional[bool] = None):
        self.particle_radius = particle_radius
        self.image_dim = render_dim
        self.picker_radius = picker_radius
        self.picker_threshold = picker_threshold
        # workspace bounds; picker targets clamp inside (reference
        # Picker._apply_picker_boundary, softgym_cloth_env.py:488-497)
        self.picker_low = np.asarray(picker_low, np.float64)
        self.picker_high = np.asarray(picker_high, np.float64)
        self.num_picker = 2
        self.dump_visualizations = dump_visualizations
        self.frames: List[np.ndarray] = []

        self.sim = ClothSim(particle_radius=particle_radius, substeps=substeps,
                            iterations=iterations, native=native)
        self.grasp_states = [False, False]
        self.picked_particles: List[Optional[int]] = [None, None]
        self.particle_inv_mass: Optional[np.ndarray] = None

        self.grasp_height = picker_radius
        self.default_speed = 1e-2
        self.reset_pos = [[0.5, 0.2, 0.5], [-0.5, 0.2, 0.5]]
        self.default_pos = [-0.5, 0.2, 0.5]
        self.fling_speed = 5e-2
        # servo parameters (the reference integrates hundreds of tiny sim
        # steps per primitive; delta caps per step keep cloth stable)
        self.delta_move = 0.01

        self.pick_speed = 5e-3
        self.move_speed = 5e-3
        self.place_speed = 5e-3
        self.lift_height = 0.1

    def close(self) -> None:
        pass

    def render_gif(self, path: str, fps: int = 30) -> List[int]:
        """Write the frames that ``dump_visualizations`` collected as a GIF
        (reference softgym_cloth_env.py:151-155; the JAX package's
        cloth_env.py:104-110 writes them through imageio). Returns the number
        of frames each GIF frame covers (repeated frames merge, as
        imageio's writer merges them)."""
        from bifold_tpu_torch.utils.visualization import write_gif
        return write_gif(path, self.frames, fps=fps)

    # ------------------------------------------------------------------
    # Scene / state
    # ------------------------------------------------------------------

    def _setup_pickers(self, center) -> None:
        self.sim.shape_states = np.zeros((0, 14), np.float32)
        self.sim.shape_radii = np.zeros((0,), np.float32)
        r = np.sqrt(self.num_picker - 1) * self.picker_radius * 2.0
        for i in range(self.num_picker):
            x = center[0] + np.sin(2 * np.pi * i / self.num_picker) * r
            z = center[2] + np.cos(2 * np.pi * i / self.num_picker) * r
            self.sim.add_sphere(self.picker_radius, [x, center[1], z])
        self.picked_particles = [None] * self.num_picker
        self.particle_inv_mass = self.sim.get_positions()[:, 3].copy()

    def reset(self, config: Dict, state: Optional[Dict] = None,
              cloth3d: bool = False, pick_speed: float = 5e-3,
              move_speed: float = 5e-3, place_speed: float = 5e-3,
              lift_height: float = 0.1, settle_steps: int = 30) -> None:
        """Build the scene from config, optionally restore a cached state
        (reference reset + set_cloth3d/square_scene, :103-132, 738-788)."""
        self.current_config = deepcopy(config)
        radius = config.get("particle_radius", self.particle_radius)
        if cloth3d or "mesh_path" in config or "vertices" in config:
            if "vertices" in config:
                verts = np.asarray(config["vertices"], np.float32)
                faces = np.asarray(config["faces"], np.int64)
            else:
                mesh_path = config.get("mesh_path")
                if mesh_path is None and "cloth_index" in config:
                    # reference-format CLOTH3D configs address meshes by
                    # index under $CLOTH3D_PATH/<type-prefix>/%04d.obj
                    # (softgym_cloth3d.h:315-340); resolve them here so the
                    # reference's softgym cache pickles load unchanged
                    import os
                    prefix = {0: "Tshirt", 1: "Trousers", 2: "Bimanual"}.get(
                        int(config.get("cloth_type", 2)), "Bimanual")
                    mesh_path = os.path.join(
                        os.environ.get("CLOTH3D_PATH", "."), prefix,
                        f"{int(config['cloth_index']):04d}.obj")
                verts, faces = load_obj(mesh_path)
            scale = config.get("scale", 1.0)
            verts = verts * scale
            self.sim.set_cloth(verts, faces, mass=config.get("mass", 0.5))
            from scipy.spatial.transform import Rotation as R
            rot = config.get("rot", 0.0)
            if "vertices" in config:
                # procedural garments are authored flat in the XZ plane; only
                # the yaw applies
                euler = [0, rot * 180 / np.pi, 0]
            else:
                # CLOTH3D meshes are canonically upright: flip them flat
                # (reference set_cloth3d_scene, softgym_cloth_env.py:755-757)
                euler = [180, rot * 180 / np.pi, 90]
            pos = self.sim.get_positions()
            center = pos[:, :3].mean(axis=0)
            pos[:, :3] = R.from_euler("zyx", euler, degrees=True).apply(
                pos[:, :3] - center) + center
            self.sim.set_positions(pos)
            move_to_pos(self, [0, 0.05, 0])
        else:
            dimx, dimy = config["ClothSize"]
            verts, faces = grid_cloth(dimx, dimy, radius)
            verts[:, 1] = radius  # drop from just above the floor
            self.sim.set_cloth(verts, faces, mass=config.get("mass", 0.5))

        cam = config.get("camera_params", {"default_camera": deepcopy(DEFAULT_CAMERA)})
        self.camera_params = deepcopy(cam)
        cam_p = cam[config.get("camera_name", "default_camera")]
        self.sim.set_camera_params(cam_p)
        self.camera_matrix = matrix_world_to_camera(cam_p["pos"], cam_p["angle"])

        self._setup_pickers(self.reset_pos[0])

        if state is not None:
            self.set_state(state)
        else:
            for _ in range(settle_steps):
                self.sim.step()

        self.set_grasp(False)
        self.frames = []
        self.pick_speed = pick_speed
        self.move_speed = move_speed
        self.place_speed = place_speed
        self.lift_height = lift_height
        self.max_area = (state or {}).get("max_area")

    def get_state(self) -> Dict:
        return {
            "particle_pos": self.sim.get_positions(),
            "particle_vel": self.sim.get_velocities(),
            "shape_pos": self.sim.get_shape_states(),
            "camera_params": deepcopy(self.camera_params),
            "max_area": getattr(self, "max_area", None),
        }

    def set_state(self, state: Dict) -> None:
        self.sim.set_positions(state["particle_pos"])
        self.sim.set_velocities(state["particle_vel"])
        if state.get("shape_pos") is not None and len(state["shape_pos"]):
            self.sim.set_shape_states(state["shape_pos"])
        if "camera_params" in state:
            self.camera_params = deepcopy(state["camera_params"])
            cam_p = self.camera_params["default_camera"]
            self.sim.set_camera_params(cam_p)
            self.camera_matrix = matrix_world_to_camera(cam_p["pos"], cam_p["angle"])
        self.particle_inv_mass = self.sim.get_positions()[:, 3].copy()

    # ------------------------------------------------------------------
    # Camera
    # ------------------------------------------------------------------

    @staticmethod
    def intrinsic_from_fov(height: int, width: int, fov: float = 90):
        return intrinsic_from_fov(height, width, fov)

    def get_world_coord_from_pixel(self, pixel, depth):
        """Unproject a [x, y] pixel through the rendered depth
        (reference softgym_cloth_env.py:61-82, including its (u, v) index
        order quirk: depth indexed [round(x), round(y)])."""
        assert np.all(np.asarray(pixel) >= 0)
        matrix_camera_to_world = np.linalg.inv(self.camera_matrix)
        height, width = depth.shape
        k = self.intrinsic_from_fov(height, width, 45)
        u, v = pixel[0], pixel[1]
        z = depth[int(np.rint(u)), int(np.rint(v))]
        x = (u - k[0, 2]) * z / k[0, 0]
        y = (v - k[1, 2]) * z / k[1, 1]
        cam = np.array([x, y, z, 1.0])
        return (matrix_camera_to_world @ cam)[:3]

    def render_image(self):
        rgba, depth = self.sim.render(720, 720)
        return (resize_linear(rgba[:, :, :3], self.image_dim),
                resize_linear(depth, self.image_dim))

    # ------------------------------------------------------------------
    # Picker mechanics (reference Picker.step, :558-662)
    # ------------------------------------------------------------------

    def set_grasp(self, grasp) -> None:
        if isinstance(grasp, (list, tuple)):
            self.grasp_states = list(grasp)
        else:
            self.grasp_states = [grasp] * self.num_picker

    def _picker_step(self, targets, grasps) -> None:
        """Move pickers toward targets (unclamped single step) applying
        pick/unpick transitions and dragging grasped particles."""
        pos = self.sim.get_positions()
        shapes = self.sim.get_shape_states()
        picker_pos = shapes[:, :3].copy()

        for i in range(self.num_picker):
            if not grasps[i] and self.picked_particles[i] is not None:
                pos[self.picked_particles[i], 3] = \
                    self.particle_inv_mass[self.picked_particles[i]]
                self.picked_particles[i] = None

        new_picker_pos = np.asarray(targets, np.float64).reshape(self.num_picker, 3)
        new_picker_pos = np.clip(new_picker_pos,
                                 self.picker_low + self.picker_radius,
                                 self.picker_high - self.picker_radius)
        for i in range(self.num_picker):
            if grasps[i] and self.picked_particles[i] is None:
                d = np.linalg.norm(pos[:, :3] - picker_pos[i], axis=1)
                candidates = np.argsort(d)
                thresh = (self.picker_threshold + self.picker_radius
                          + self.particle_radius)
                for c in candidates:
                    if d[c] > thresh:
                        break
                    if c not in self.picked_particles:
                        self.picked_particles[i] = int(c)
                        break
            if grasps[i] and self.picked_particles[i] is not None:
                p = self.picked_particles[i]
                pos[p, :3] += new_picker_pos[i] - picker_pos[i]
                pos[p, 3] = 0.0

        shapes[:, 3:6] = shapes[:, :3]
        shapes[:, :3] = new_picker_pos
        self.sim.set_shape_states(shapes)
        self.sim.set_positions(pos)

    def movep(self, pos, speed=None, limit: int = 1000,
              min_steps: Optional[int] = None, eps: float = 1e-4) -> None:
        """Servo both pickers toward targets, stepping the sim each tick
        (reference movep, :157-180)."""
        if speed is None:
            speed = 0.1
        target_pos = np.asarray(pos, np.float64)
        for step in range(limit):
            curr = self.sim.get_shape_states()[:, :3]
            deltas = target_pos - curr
            dists = np.linalg.norm(deltas, axis=1)
            if np.all(dists < eps) and (min_steps is None or step > min_steps):
                return
            next_pos = []
            for targ, cur, delta, dist in zip(target_pos, curr, deltas, dists):
                if dist < speed:
                    next_pos.append(targ)
                else:
                    next_pos.append(cur + delta / dist * speed)
            self._picker_step(np.asarray(next_pos), self.grasp_states)
            self.sim.step()
            if self.dump_visualizations:
                self.frames.append(self.render_image()[0])

    # ------------------------------------------------------------------
    # Primitives (reference :183-390)
    # ------------------------------------------------------------------

    def pick_and_place_single(self, pick_pos, place_pos) -> None:
        pick_pos = np.asarray(pick_pos, np.float64).copy()
        place_pos = np.asarray(place_pos, np.float64).copy()
        pick_pos[1] = self.grasp_height
        place_pos[1] = self.grasp_height
        prepick = pick_pos.copy()
        prepick[1] = self.lift_height
        preplace = place_pos.copy()
        preplace[1] = self.lift_height

        self.movep([prepick, self.default_pos], speed=0.5)
        self.movep([pick_pos, self.default_pos], speed=0.005)
        self.set_grasp(True)
        self.movep([prepick, self.default_pos], speed=self.pick_speed)
        self.movep([preplace, self.default_pos], speed=self.move_speed)
        self.movep([place_pos, self.default_pos], speed=self.place_speed)
        self.set_grasp(False)
        self.movep([preplace, self.default_pos], speed=0.5)
        self.movep(self.reset_pos, speed=0.5)

    def pick_and_drop(self, pick_pos) -> None:
        pick_pos = np.asarray(pick_pos, np.float64).copy()
        pick_pos[1] = self.grasp_height
        prepick = pick_pos.copy()
        prepick[1] = self.lift_height
        self.movep([prepick, self.default_pos], speed=0.5)
        self.movep([pick_pos, self.default_pos], speed=0.005)
        self.set_grasp(True)
        self.movep([prepick, self.default_pos], speed=self.pick_speed)
        self.set_grasp(False)
        self.movep(self.reset_pos, speed=0.5)

    def pick_and_place_dual(self, pick_left, place_left, pick_right, place_right) -> None:
        pl, ll = np.asarray(pick_left, np.float64).copy(), np.asarray(place_left, np.float64).copy()
        pr, lr = np.asarray(pick_right, np.float64).copy(), np.asarray(place_right, np.float64).copy()
        for p in (pl, ll, pr, lr):
            p[1] = self.grasp_height
        prepick_l, prepick_r = pl.copy(), pr.copy()
        preplace_l, preplace_r = ll.copy(), lr.copy()
        for p in (prepick_l, prepick_r, preplace_l, preplace_r):
            p[1] = self.lift_height

        self.movep([prepick_l, prepick_r], speed=0.5)
        self.movep([pl, pr], speed=0.005)
        self.set_grasp(True)
        self.movep([prepick_l, prepick_r], speed=self.pick_speed)
        self.movep([preplace_l, preplace_r], speed=self.move_speed)
        self.movep([ll, lr], speed=self.place_speed)
        self.set_grasp(False)
        self.movep([preplace_l, preplace_r], speed=0.5)
        self.movep(self.reset_pos, speed=0.5)

    def pick_and_fling(self, pick_left, pick_right) -> bool:
        pl = np.asarray(pick_left, np.float64).copy()
        pr = np.asarray(pick_right, np.float64).copy()
        pl[1] = self.grasp_height
        pr[1] = self.grasp_height
        prepick_l, prepick_r = pl.copy(), pr.copy()
        prepick_l[1] = self.lift_height
        prepick_r[1] = self.lift_height
        dist = float(np.linalg.norm(prepick_l - prepick_r))

        self.movep([prepick_l, prepick_r])
        self.movep([pl, pr])
        self.set_grasp(True)
        self.movep([[-dist / 2, 0.3, -0.3], [dist / 2, 0.3, -0.3]], speed=5e-3)
        if not self.is_cloth_grasped():
            return False
        dist = self.stretch_cloth(grasp_dist=dist, max_grasp_dist=0.4,
                                  fling_height=0.5)
        fling_height = self.lift_cloth(grasp_dist=dist, fling_height=0.5)
        self.fling(dist=dist, fling_height=fling_height,
                   fling_speed=self.fling_speed)
        self.movep(self.reset_pos, speed=0.5)
        return True

    def fling(self, dist, fling_height, fling_speed) -> None:
        self.movep([[-dist / 2, fling_height, -0.2],
                    [dist / 2, fling_height, -0.2]], speed=fling_speed)
        self.movep([[-dist / 2, fling_height, 0.2],
                    [dist / 2, fling_height, 0.2]], speed=fling_speed)
        self.movep([[-dist / 2, fling_height, 0.2],
                    [dist / 2, fling_height, 0.2]], speed=1e-2, min_steps=4)
        self.movep([[-dist / 2, self.grasp_height * 2, 0.2],
                    [dist / 2, self.grasp_height * 2, 0.2]], speed=fling_speed)
        self.movep([[-dist / 2, self.grasp_height, 0],
                    [dist / 2, self.grasp_height, 0]], speed=fling_speed)
        self.movep([[-dist / 2, self.grasp_height, -0.2],
                    [dist / 2, self.grasp_height, -0.2]], speed=5e-3)
        self.set_grasp(False)

    def stretch_cloth(self, grasp_dist, fling_height=0.7, max_grasp_dist=0.7,
                      increment_step=0.02) -> float:
        left, right = self.sim.get_shape_states()[:, :3]
        left = left.copy()
        right = right.copy()
        left[1] = fling_height
        right[1] = fling_height
        midpoint = (left + right) / 2
        direction = left - right
        direction = direction / (np.linalg.norm(direction) + 1e-12)
        self.movep([left, right], speed=5e-4, min_steps=20)
        stable_steps = 0
        cloth_midpoint = np.full(3, 1e2)
        while True:
            positions = self.sim.get_positions()[:, :3]
            high = positions[positions[:, 1] > fling_height - 0.1]
            if len(high) == 0 or (high[:, 0] < 0).all() or (high[:, 0] > 0).all():
                return grasp_dist
            order = np.argsort(np.linalg.norm(
                positions[:, [0, 2]] - midpoint[[0, 2]], axis=1))
            new_mid = positions[order[0]]
            if np.linalg.norm(new_mid - cloth_midpoint) < 1.5e-2:
                stable_steps += 1
            else:
                stable_steps = 0
            if stable_steps > 2:
                return grasp_dist
            cloth_midpoint = new_mid
            grasp_dist += increment_step
            left = midpoint + direction * grasp_dist / 2
            right = midpoint - direction * grasp_dist / 2
            self.movep([left, right], speed=5e-4)
            if grasp_dist > max_grasp_dist:
                return max_grasp_dist

    def lift_cloth(self, grasp_dist, fling_height: float = 0.7,
                   increment_step: float = 0.05, max_height=0.7) -> float:
        while True:
            heights = self.sim.get_positions()[:, 1]
            if heights.min() > 0.02:
                return fling_height
            fling_height += increment_step
            self.movep([[-grasp_dist / 2, fling_height, -0.3],
                        [grasp_dist / 2, fling_height, -0.3]], speed=1e-3)
            if fling_height >= max_height:
                return fling_height

    # ------------------------------------------------------------------
    # Keypoints / queries (reference :392-428)
    # ------------------------------------------------------------------

    def get_square_keypoints_idx(self) -> List[int]:
        """3x3 keypoint grid over the row-major cloth indices:
        0 1 2 / 3 4 5 / 6 7 8 (corners, edge midpoints, center)."""
        dimx, dimy = self.current_config["ClothSize"]
        mid_x = int((dimx - 1) / 2)
        mid_y = int((dimy - 1) / 2)
        return [0, mid_x, dimx - 1,
                mid_y * dimx, mid_y * dimx + mid_x, mid_y * dimx + dimx - 1,
                dimx * (dimy - 1), dimx * (dimy - 1) + mid_x, dimx * dimy - 1]

    def get_keypoints(self, keypoints_index=None) -> np.ndarray:
        pos = self.sim.get_positions()[:, :3]
        if keypoints_index is None:
            return pos
        return pos[keypoints_index]

    def is_cloth_grasped(self) -> bool:
        return bool(self.sim.get_positions()[:, 1].max() > 0.2)
