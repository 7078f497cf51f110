"""Novel-view render paths (counterpart of mvsnerf_tpu/eval/paths.py,
reference utils.py:479-676 and renderer_video.ipynb cell 4), numpy and
scipy only."""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

from ..data.common import create_spheric_poses, create_spiral_poses


def gen_render_path(c2ws, n_views: int = 30):
    """Euler-angle interpolation through the given poses, closing the loop
    (utils.py:479-508): (len(c2ws) * (n_views // 3), 4, 4)."""
    n = len(c2ws)
    per_seg = n_views // 3
    weight = np.linspace(1.0, 0.0, per_seg, endpoint=False).reshape(-1, 1)
    eulers, positions = [], []
    for i in range(n):
        e = Rotation.from_matrix(c2ws[i, :3, :3]).as_euler(
            "xyz", degrees=True).reshape(1, 3)
        if i:
            e = e + (np.abs(e - eulers[0]) > 180) * 360.0
        eulers.append(e)
        positions.append(c2ws[i, :3, 3:].reshape(1, 3))

    e_interp, p_interp = [], []
    for i in range(n):
        j = (i + 1) % n  # the last segment closes the loop
        e_interp.append(weight * eulers[i] + (1 - weight) * eulers[j])
        p_interp.append(weight * positions[i] + (1 - weight) * positions[j])

    out = []
    for e, p in zip(np.concatenate(e_interp), np.concatenate(p_interp)):
        c2w = np.eye(4)
        c2w[:3, :3] = Rotation.from_euler("xyz", e, degrees=True).as_matrix()
        c2w[:3, 3] = p
        out.append(c2w)
    return np.stack(out)


def pose_spherical_nerf(euler, radius: float = 4.0):
    """One spherical pose from euler angles (utils.py:634-638)."""
    c2w = np.eye(4)
    c2w[:3, :3] = Rotation.from_euler("xyz", euler, degrees=True).as_matrix()
    c2w[:3, 3] = c2w[:3, :3] @ np.array([0.0, 0.0, -radius])
    return c2w


def pose_spherical_dtu(radii, focus_depth, n_poses: int = 120,
                       world_center=np.zeros(3)):
    """DTU spiral path with the y/z flip (utils.py:644-676)."""
    poses = create_spiral_poses(radii, focus_depth, n_poses).copy()
    poses[..., 3] += world_center
    return poses @ np.diag([1.0, -1.0, -1.0, 1.0])


def nerf_video_path(n_frames: int = 60, radius: float = 4.0,
                    phi: float = -30.0):
    """360-degree orbit for NeRF-synthetic scenes (renderer_video.ipynb
    cell 4)."""
    return np.stack([
        pose_spherical_nerf(np.array([phi, th, 0.0]), radius)
        for th in np.linspace(-180, 180, n_frames + 1)[:-1]])


def gen_render_path_pixelnerf(c2w_ref, n_views: int = 30):
    """The quaternion-spline path of pixelNeRF-style comparisons
    (mvsnerf_tpu/eval/paths.py:72, reference utils.py:541-573, which
    shadows its own Rotation import and cannot run as written; this is
    JAX's working equivalent): 5 keyframe quaternions and a 450 scale
    through periodic cubic splines, (n_views // 5 * 6, 4, 4) poses
    relative to `c2w_ref`."""
    from scipy.interpolate import CubicSpline

    t_in = np.array([0, 2, 3, 5, 6], np.float32)
    pose_quat = np.array([
        [0.9698, 0.2121, 0.1203, -0.0039],
        [0.7020, 0.1578, 0.4525, 0.5268],
        [0.6766, 0.3176, 0.5179, 0.4161],
        [0.9085, 0.4020, 0.1139, -0.0025],
        [0.9698, 0.2121, 0.1203, -0.0039],
    ])
    scales = np.full(5, 450.0, np.float32)
    n_inter = max(n_views // 5, 1)
    t_out = np.linspace(t_in[0], t_in[-1],
                        n_inter * int(t_in[-1])).astype(np.float32)
    s_new = CubicSpline(t_in, scales, bc_type="periodic")(t_out)
    q_new = CubicSpline(t_in, pose_quat, bc_type="periodic")(t_out)
    q_new = q_new / np.linalg.norm(q_new, 2, 1)[:, None]

    out = []
    for q, scale in zip(q_new, s_new):
        rot = Rotation.from_quat(q).as_matrix()
        pose = np.eye(4)
        pose[:3, :3] = rot
        pose[:3, 3] = rot[:, 2] * scale
        out.append(c2w_ref @ pose)
    return np.stack(out)


__all__ = ["gen_render_path", "pose_spherical_nerf", "pose_spherical_dtu",
           "nerf_video_path", "create_spiral_poses", "create_spheric_poses",
           "gen_render_path_pixelnerf"]
