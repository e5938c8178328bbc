"""The benchmark's scene: a textured cylinder around a ring of cameras,
rendered into each camera's frames on the device from the seed.

The rig is the upstream's fixed ring (360_stitcher/calibration.cpp:28-68):
camera i looks along yaw 2*pi*i/N, focal f = (W/2) / tan(fov/2), principal
point at (W/2, H/2), and a world point (X, Y, Z) = Ry(yaw) K^-1 (x, y, 1)
lies on the cylinder at theta = atan2(X, Z), h = Y / hypot(X, Z). Each
camera's image is further displaced by a known smooth field (a lens or
mounting error the global calibration cannot see), so that the CPW mesh
has a real misalignment to remove, and darkened by a known gain. Frame
set k of the ring sees the scene turned by k * pan_px texels.

Nothing here imports the program: ``truth_theta_h`` is what the
comparison uses to hold a mesh against the scene.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import torch


@dataclass
class Rig:
    n: int
    w: int
    h: int
    focal: float
    yaws: List[float]
    #: displacement coefficients [n, 4] and phases [n, 4], in pixels
    disp_amp: torch.Tensor
    disp_phase: torch.Tensor
    gains: torch.Tensor                    # f64 [n], in (0, 1]

    @property
    def ppx(self) -> float:
        return self.w / 2.0

    @property
    def ppy(self) -> float:
        return self.h / 2.0


def seed_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_rig(cfg: dict, traffic: dict, seed: int) -> Rig:
    """The rig of a configuration, with the displacement and gains drawn
    from the seed (on the host: a few numbers)."""
    n, w, h = cfg["num_images"], cfg["input_width"], cfg["input_height"]
    focal = (w / 2.0) / math.tan(math.radians(cfg["fov_deg"]) / 2.0)
    g = seed_generator(seed, "cpu")
    # each term's amplitude is the same for every seed (in pixels at 1920
    # wide, scaled with the frame width); the seed draws its sign
    amp = traffic["displace_px"] * w / 1920.0
    sign = torch.randint(0, 2, (n, 4), generator=g).to(torch.float64) * 2 - 1
    disp_amp = sign * amp
    disp_phase = torch.rand(n, 4, generator=g, dtype=torch.float64) * 2 * math.pi
    # the same gains for every seed (evenly spaced over the spread), in
    # an order drawn from the seed
    steps = torch.linspace(0.0, 1.0, n, dtype=torch.float64)
    gains = 1.0 - traffic["gain_spread"] * steps[torch.randperm(n,
                                                                generator=g)]
    yaws = [2.0 * math.pi * i / n for i in range(n)]
    return Rig(n, w, h, focal, yaws, disp_amp, disp_phase, gains)


def displacement(rig: Rig, cam: int, x: torch.Tensor, y: torch.Tensor):
    """The planted displacement (dx, dy) of camera `cam` at source pixel
    (x, y): pixel (x, y) shows what an ideal camera shows at (x + dx,
    y + dy). Smooth: one half-period across the frame on each axis."""
    a = rig.disp_amp[cam].tolist()
    p = rig.disp_phase[cam].tolist()
    u = math.pi * x / rig.w
    v = math.pi * y / rig.h
    dx = a[0] * torch.sin(u + p[0]) + a[1] * torch.sin(v + p[1])
    dy = a[2] * torch.sin(u + p[2]) + a[3] * torch.cos(v + p[3])
    return dx, dy


def truth_theta_h(rig: Rig, cam: int, x: torch.Tensor, y: torch.Tensor,
                  pan: float = 0.0):
    """Source pixel (x, y) of camera `cam` (f64 tensors) -> the cylinder
    point (theta, h) it shows, displacement included."""
    dx, dy = displacement(rig, cam, x, y)
    xl = (x + dx - rig.ppx) / rig.focal
    yl = (y + dy - rig.ppy) / rig.focal
    theta = rig.yaws[cam] + pan + torch.atan2(xl, torch.ones_like(xl))
    hh = yl / torch.hypot(xl, torch.ones_like(xl))
    return theta, hh


def make_texture(rig: Rig, seed: int, device) -> torch.Tensor:
    """Smooth random RGB texture f32 [3, th, tw] in [10, 245], periodic in
    theta: tw texels span 2*pi at about the cameras' own resolution. A
    coarse octave carries the energy, a fine one gives matchable corners
    (as the port's own synthetic rig does)."""
    tw = int(round(2 * math.pi * rig.focal / 8.0)) * 8
    hmax = (rig.ppy + 16.0) / rig.focal
    th = (int(math.ceil(hmax * rig.focal)) + 8) * 2
    th = (th + 7) // 8 * 8
    g = seed_generator(seed + 1, device)

    def octave(f):
        n = torch.rand(3, th // f, tw // f, generator=g, device=device)
        return n.repeat_interleave(f, 1).repeat_interleave(f, 2)

    tex = 0.75 * octave(8) + 0.25 * octave(2)
    for _ in range(9):
        tex = (torch.roll(tex, 1, 2) + tex + torch.roll(tex, -1, 2)) / 3
        up = torch.cat([tex[:, :1], tex[:, :-1]], 1)
        dn = torch.cat([tex[:, 1:], tex[:, -1:]], 1)
        tex = (up + tex + dn) / 3
    lo, hi = tex.amin(), tex.amax()
    return ((tex - lo) / (hi - lo) * 235 + 10).contiguous()


def _sample(tex: torch.Tensor, theta: torch.Tensor, hh: torch.Tensor,
            texels_per_rad: float) -> torch.Tensor:
    """Bilinear sample of the texture at (theta, h), periodic in theta:
    f32 [3, *theta.shape]."""
    c, th, tw = tex.shape
    u = torch.remainder(theta * (tw / (2 * math.pi)), tw)
    v = (hh * texels_per_rad + th / 2.0).clamp(0, th - 1.001)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0).float()
    fy = (v - y0).float()
    x0 = x0.long() % tw
    x1 = (x0 + 1) % tw
    y0 = y0.long()
    y1 = y0 + 1
    flat = tex.reshape(c, -1)

    def tap(yy, xx):
        return flat[:, (yy * tw + xx).reshape(-1)].reshape(
            (c,) + tuple(theta.shape))
    return (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x1) * fx * (1 - fy)
            + tap(y1, x0) * (1 - fx) * fy + tap(y1, x1) * fx * fy)


def render_set(rig: Rig, tex: torch.Tensor, pan: float) -> torch.Tensor:
    """One frame set: u8 RGB [n, h, w, 3] on the texture's device, the
    scene turned by `pan` radians."""
    dev = tex.device
    y, x = torch.meshgrid(torch.arange(rig.h, device=dev, dtype=torch.float64),
                          torch.arange(rig.w, device=dev, dtype=torch.float64),
                          indexing="ij")
    tw = tex.shape[2]
    out = torch.empty((rig.n, rig.h, rig.w, 3), dtype=torch.uint8, device=dev)
    for i in range(rig.n):
        theta, hh = truth_theta_h(rig, i, x, y, pan)
        img = _sample(tex, theta, hh, tw / (2 * math.pi)) * float(rig.gains[i])
        out[i] = torch.round(img.clamp(0, 255)).to(torch.uint8).permute(1, 2, 0)
    return out


def rgb_to_nv12(rgb: torch.Tensor) -> torch.Tensor:
    """u8 RGB [n, h, w, 3] -> NV12 u8 [n, h*3/2, w] (a capture board's
    format, 360_stitcher/defs.h:10-17): BT.601 video range, each 2x2
    block's chroma from its mean colour."""
    x = rgb.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 16.0 + 0.256788 * r + 0.504129 * g + 0.097906 * b
    n, h, w = r.shape

    def pool(c):
        return c.reshape(n, h // 2, 2, w // 2, 2).mean((2, 4))
    rp, gp, bp = pool(r), pool(g), pool(b)
    u = 128.0 - 0.148223 * rp - 0.290993 * gp + 0.439216 * bp
    v = 128.0 + 0.439216 * rp - 0.367788 * gp - 0.071427 * bp
    uv = torch.stack([u, v], -1).reshape(n, h // 2, w)
    out = torch.cat([y, uv], 1)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def make_ring(cfg: dict, traffic: dict, seed: int, device):
    """(rig, ring): `traffic["ring_sets"]` frame sets in the
    configuration's frame format, stacked on `device`: u8 [R, n, h, w, 3]
    (rgb) or [R, n, h*3/2, w] (nv12)."""
    rig = make_rig(cfg, traffic, seed)
    tex = make_texture(rig, seed, device)
    pan = traffic["pan_texels"] * 2 * math.pi / tex.shape[2]
    sets = []
    for k in range(traffic["ring_sets"]):
        rgb = render_set(rig, tex, k * pan)
        sets.append(rgb_to_nv12(rgb) if cfg["frame_format"] == "nv12"
                    else rgb)
    del tex
    return rig, torch.stack(sets)
