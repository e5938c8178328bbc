"""Synthetic rig fixture: render N camera views from a known cylinder
texture, so a stitch can be scored against the scene it came from. An own
copy of the JAX package's ``utils/synth.py``, so the port's smoke run and
tests render the rig without that package."""

from __future__ import annotations

import numpy as np

from video_stitcher_tpu_torch.geometry.camera import fixed_rig_cameras
from video_stitcher_tpu_torch.geometry.cylindrical import cylindrical_forward


def make_scene(pano_w, pano_h, rng, smooth=9, detail_frac=0.0015):
    """Smooth random RGB texture, periodic in x.

    The texture is band-limited *relative to the panorama size*
    (detail_frac ~ feature size / pano width) so the fidelity measurement
    reflects stitching error (misalignment, seams, blending) rather than
    the unavoidable interpolation loss of resampling pixel-scale noise —
    the BASELINE target is PSNR against a reference stitcher's output,
    which shares the same resampling chain.
    """
    # pick a power-of-two upsample factor that divides both dims exactly
    # (keeps the texture periodic in x)
    up = 1
    want = max(1, int(round(detail_frac * pano_w / 0.75)))
    while up * 2 <= want and pano_w % (up * 2) == 0 and pano_h % (up * 2) == 0:
        up *= 2

    def octave(factor):
        n = rng.random((3, pano_h // factor, pano_w // factor)).astype(np.float32)
        return np.repeat(np.repeat(n, factor, axis=1), factor, axis=2)

    # coarse octave carries the energy (keeps the fidelity measurement
    # about alignment, not interpolation loss); the fine octave provides
    # unique, matchable corners for the feature pipeline
    noise = 0.75 * octave(up) + 0.25 * octave(max(1, up // 4))
    smooth = max(smooth, up)             # remove the staircase
    # separable box blur for smoothness, periodic in x
    for _ in range(smooth):
        noise = (np.roll(noise, 1, axis=2) + noise + np.roll(noise, -1, axis=2)) / 3
        noise = (np.concatenate([noise[:, :1], noise[:, :-1]], axis=1)
                 + noise
                 + np.concatenate([noise[:, 1:], noise[:, -1:]], axis=1)) / 3
    lo, hi = noise.min(), noise.max()
    return ((noise - lo) / (hi - lo) * 235 + 10).astype(np.float32)   # [3,H,W]


def sample_scene(scene, u, v, pano_w):
    """Bilinear sample, periodic in u."""
    c, h, w = scene.shape
    u = np.mod(u, pano_w)
    x0 = np.floor(u).astype(np.int64)
    y0 = np.clip(np.floor(v), 0, h - 2).astype(np.int64)
    fx = (u - x0).astype(np.float32)
    fy = (v - y0).astype(np.float32)
    x1 = (x0 + 1) % w
    y1 = y0 + 1
    out = (scene[:, y0, x0] * (1 - fx) * (1 - fy) + scene[:, y0, x1] * fx * (1 - fy)
           + scene[:, y1, x0] * (1 - fx) * fy + scene[:, y1, x1] * fx * fy)
    return out


def render_views(cfg, geom, scene, gains=None):
    """Render full-res camera frames by forward-projecting each pixel."""
    lay = geom.layout
    cams_full = fixed_rig_cameras(cfg.num_images, cfg.input_width,
                                  cfg.input_height, 1.0, cfg.fov_deg, cfg.yaws)
    frames = np.zeros((cfg.num_images, cfg.input_height, cfg.input_width, 3),
                      np.uint8)
    xs, ys = np.meshgrid(np.arange(cfg.input_width, dtype=np.float64),
                         np.arange(cfg.input_height, dtype=np.float64))
    for i, cam in enumerate(cams_full):
        u, v = cylindrical_forward(cam, lay.scale, xs, ys)
        img = sample_scene(scene, u, v - lay.v0, lay.pano_w)
        if gains is not None:
            img = img * gains[i]
        frames[i] = np.clip(np.moveaxis(img, 0, -1), 0, 255).astype(np.uint8)
    return frames


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse) if mse > 0 else np.inf
