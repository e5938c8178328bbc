"""Video file / synthetic sources and sinks.

Replaces cv::VideoCapture input with per-file frame offsets
(360_stitcher/timed.cpp:499-507, defs.h:44) and the MJPG VideoWriter output
(timed.cpp:273-278). Also provides .npz clip sources for tests/bench and a
synthetic ring-rig source for hardware-free runs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _cv2(what: str):
    """OpenCV, which reads and writes video files; imported at use, so the
    rest of the I/O plane runs where it is not installed."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} reads and writes video through OpenCV "
                          f"(cv2), which is not installed here") from e
    return cv2


class VideoFileSource:
    """N video files read in lockstep, with start offsets + skip_frames."""

    def __init__(self, paths: Sequence[str], offsets: Sequence[int] = (),
                 skip_frames: int = 0):
        cv2 = _cv2("VideoFileSource")
        self.caps = []
        for i, p in enumerate(paths):
            cap = cv2.VideoCapture(p)
            if not cap.isOpened():
                raise FileNotFoundError(f"cannot open video {p}")
            # offsets may legitimately be shorter than paths (config
            # validates it against num_images, never against the file
            # list): missing entries mean no per-file offset
            off = skip_frames + (offsets[i] if i < len(offsets) else 0)
            cap.set(cv2.CAP_PROP_POS_FRAMES, off)
            self.caps.append(cap)

    def get_frames(self) -> Optional[np.ndarray]:
        frames = []
        for cap in self.caps:
            ok, frame = cap.read()
            if not ok:
                return None
            frames.append(frame[..., ::-1])       # BGR -> RGB
        return np.stack(frames)

    def release(self) -> None:
        for c in self.caps:
            c.release()


class NpzClipSource:
    """Clip stored as {'frames': u8 [T, N, H, W, 3]} (test fixture format)."""

    def __init__(self, path: str, loop: bool = True):
        self.frames = np.load(path)["frames"]
        self.loop = loop
        self.t = 0

    def get_frames(self) -> Optional[np.ndarray]:
        if self.t >= len(self.frames):
            if not self.loop:
                return None
            self.t = 0
        out = self.frames[self.t]
        self.t += 1
        return out

    def release(self) -> None:
        pass


class SyntheticRigSource:
    """Renders a drifting synthetic scene through the rig geometry — lets the
    full live pipeline run with zero external inputs. The scene texture rolls
    horizontally by drift_px per frame (simulated rig rotation)."""

    def __init__(self, cfg, geom, seed: int = 0, drift_px: float = 1.0):
        from video_stitcher_tpu_torch.geometry.camera import fixed_rig_cameras
        from video_stitcher_tpu_torch.geometry.cylindrical import cylindrical_forward
        rng = np.random.default_rng(seed)
        lay = geom.layout
        noise = rng.random((3, lay.pano_h, lay.pano_w)).astype(np.float32)
        for _ in range(6):
            noise = (np.roll(noise, 1, 2) + noise + np.roll(noise, -1, 2)) / 3
            noise = (np.roll(noise, 1, 1) + noise + np.roll(noise, -1, 1)) / 3
        lo, hi = noise.min(), noise.max()
        self.scene = ((noise - lo) / (hi - lo) * 235 + 10).astype(np.float32)
        self.drift = drift_px
        self.t = 0
        self.cfg = cfg
        self.geom = geom
        cams = fixed_rig_cameras(cfg.num_images, cfg.input_width,
                                 cfg.input_height, 1.0, cfg.fov_deg, cfg.yaws)
        self._uv = []
        xs, ys = np.meshgrid(np.arange(cfg.input_width, dtype=np.float64),
                             np.arange(cfg.input_height, dtype=np.float64))
        for cam in cams:
            u, v = cylindrical_forward(cam, lay.scale, xs, ys)
            ui = np.mod(np.round(u).astype(np.int64), lay.pano_w)
            vi = np.clip(np.round(v - lay.v0).astype(np.int64), 0,
                         lay.pano_h - 1)
            self._uv.append((ui, vi))

    def get_frames(self) -> np.ndarray:
        scene = np.roll(self.scene, int(self.t * self.drift), axis=2)
        self.t += 1
        frames = []
        for ui, vi in self._uv:
            img = scene[:, vi, ui]
            frames.append(np.moveaxis(img, 0, -1).astype(np.uint8))
        return np.stack(frames)

    def release(self) -> None:
        pass


class VideoFileSink:
    """MJPG .avi writer at 30 fps (timed.cpp:274)."""

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0):
        cv2 = _cv2("VideoFileSink")
        self.writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (width, height))
        if not self.writer.isOpened():
            raise RuntimeError(f"cannot open video writer {path}")

    def write(self, frame_rgb: np.ndarray) -> None:
        self.writer.write(np.ascontiguousarray(frame_rgb[..., ::-1]))

    def release(self) -> None:
        self.writer.release()
