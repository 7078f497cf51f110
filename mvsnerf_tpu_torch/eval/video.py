"""Free-viewpoint video (counterpart of mvsnerf_tpu/eval/video.py,
reference renderer_video.ipynb): a pose path rendered frame by frame
through a system's `render_image`, and written when a path is given
(`write_frames`, which alone imports imageio or PIL)."""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from ..data.dtu_ft import rays_for_pose
from ..utils.profiling import trace_context
from ..utils.vis import panel, to8b, visualize_depth
from .paths import (create_spheric_poses, create_spiral_poses,
                    gen_render_path, nerf_video_path, pose_spherical_dtu)

FPS = 20  # frame rate of the written video, the root render_video.py's


def make_path(kind: str, dataset=None, n_frames: int = 60, **kw):
    """Pose path by kind (renderer_video.ipynb cell 4): 'spiral',
    'spheric', 'nerf', 'dtu', or 'interp' through the dataset's poses."""
    if kind == "spiral":
        return create_spiral_poses(kw.get("radii", np.array([0.5, 0.5, 0.5])),
                                   kw.get("focus_depth", 3.5), n_frames)
    if kind == "spheric":
        return create_spheric_poses(kw.get("radius", 4.0), n_frames)
    if kind == "nerf":
        return nerf_video_path(n_frames, kw.get("radius", 4.0),
                               kw.get("phi", -30.0))
    if kind == "dtu":
        return pose_spherical_dtu(kw.get("radii", np.array([0.8, 0.4, 0.4])),
                                  kw.get("focus_depth", 3.0), n_frames,
                                  kw.get("world_center", np.zeros(3)))
    if kind == "interp":
        if dataset is None:
            raise ValueError("the 'interp' path needs a dataset")
        poses = np.asarray(dataset.load_poses_all())
        # gen_render_path emits len(poses) * (n_frames // 3) frames: 4
        # evenly spaced key poses keep a many-view scan near n_frames
        if len(poses) > 4:
            poses = poses[np.linspace(0, len(poses) - 1, 4).astype(int)]
        return gen_render_path(poses, n_frames)
    raise ValueError(f"unknown path kind {kind}")


def write_frames(out_path: str, frames) -> str:
    """Write uint8 frames as a video at `FPS` with imageio where it has a
    video backend (imageio-ffmpeg or PyAV), else as a GIF with PIL (the
    card's machine has PIL, not imageio); returns the path written."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    if importlib.util.find_spec("imageio") and any(
            importlib.util.find_spec(m) for m in ("imageio_ffmpeg", "av")):
        import imageio.v2 as imageio
        imageio.mimwrite(out_path, frames, fps=FPS, quality=8)
        return out_path
    from PIL import Image
    out_path = os.path.splitext(out_path)[0] + ".gif"
    first, *rest = (Image.fromarray(np.asarray(f)) for f in frames)
    first.save(out_path, save_all=True, append_images=rest,
               duration=1000.0 / FPS, loop=0)
    return out_path


def render_video(system, poses, h: int, w: int, focal, near_far,
                 out_path: str | None = None, chunk: int = 8192,
                 with_depth_panel: bool = False):
    """Render each pose with `system.render_image(rays, chunk)`
    (renderer_video.ipynb cells 6/8/10) and return the uint8 frames; with
    `out_path`, also write them (`render_video.last_path` says where).
    Without it nothing touches the disk."""
    center = [w / 2, h / 2]
    focal = focal if isinstance(focal, (list, tuple)) else [focal, focal]
    frames = []
    for c2w in poses:
        with trace_context("video.frame"):
            with trace_context("video.rays"):
                c2w4 = np.eye(4, dtype=np.float32)
                c2w4[:3] = np.asarray(c2w)[:3]
                rays = rays_for_pose(h, w, focal, center, c2w4, near_far[0],
                                     near_far[1])
            out = system.render_image(rays, chunk=chunk)
            with trace_context("video.to_host"):
                rgb = out["rgb"].cpu().numpy()
                depth = out["depth"].cpu().numpy() if with_depth_panel \
                    else None
            with trace_context("video.panel"):
                rgb = np.clip(rgb.reshape(h, w, 3), 0, 1)
                if with_depth_panel:
                    dvis, _ = visualize_depth(depth.reshape(h, w), near_far)
                    rgb = panel([rgb, dvis])
            with trace_context("video.to8b"):
                frames.append(to8b(rgb))
    if out_path is not None:
        render_video.last_path = write_frames(out_path, frames)
    return frames


render_video.last_path = None
