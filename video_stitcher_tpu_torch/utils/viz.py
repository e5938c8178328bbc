"""Debug visualizers.

Covers the reference's debug surface: `showMat` helpers (360_stitcher/
debug.{h,cpp}), match visualization (meshwarper.cpp:159-171,
VISUALIZE_MATCHES / VISUALIZE_TEMPORAL, defs.h:62-64) and mesh drawing
(meshwarper.cpp:788-807, drawMesh). Everything returns plain RGB uint8
arrays so it works headless; `show`/`save` are thin cv2/matplotlib-gated
sinks.
"""

from __future__ import annotations

import numpy as np


def _as_u8_rgb(img) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype != np.uint8:
        if np.issubdtype(a.dtype, np.floating) and a.size \
                and float(np.nanmax(a)) <= 1.5:
            # [0,1]-normalized float input (matplotlib convention):
            # clipping to [0,255] and casting rendered it {0,1} — an
            # all-black debug image with no error
            a = a * 255.0
        a = np.clip(a, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    elif a.ndim == 3 and a.shape[0] in (1, 3) and a.shape[-1] not in (1, 3):
        a = np.moveaxis(a, 0, -1)           # planar -> HWC
        if a.shape[-1] == 1:
            a = np.repeat(a, 3, axis=-1)
    return np.ascontiguousarray(a)


def _line(img: np.ndarray, p0, p1, color) -> None:
    """Integer Bresenham line, in-place (no cv2 dependency)."""
    x0, y0 = int(round(p0[0])), int(round(p0[1]))
    x1, y1 = int(round(p1[0])), int(round(p1[1]))
    h, w = img.shape[:2]
    n = max(abs(x1 - x0), abs(y1 - y0), 1)
    xs = np.linspace(x0, x1, n + 1).round().astype(int)
    ys = np.linspace(y0, y1, n + 1).round().astype(int)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _dot(img: np.ndarray, p, color, r: int = 2) -> None:
    x, y = int(round(p[0])), int(round(p[1]))
    h, w = img.shape[:2]
    y0, y1 = max(0, y - r), min(h, y + r + 1)
    x0, x1 = max(0, x - r), min(w, x + r + 1)
    img[y0:y1, x0:x1] = color


def draw_keypoints(img, xy, valid=None, color=(0, 255, 0)) -> np.ndarray:
    """Keypoint overlay: img [H,W(,3)], xy [K,2]."""
    out = _as_u8_rgb(img).copy()
    xy = np.asarray(xy)
    v = np.ones(len(xy), bool) if valid is None else np.asarray(valid)
    for p, ok in zip(xy, v):
        if ok:
            _dot(out, p, color)
    return out


def draw_matches(img1, xy1, img2, xy2, pairs, mask=None) -> np.ndarray:
    """Side-by-side match visualization (the reference's drawMatches view,
    meshwarper.cpp:159-171). pairs: [K, 2] (idx1, idx2)."""
    a = _as_u8_rgb(img1)
    b = _as_u8_rgb(img2)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[:a.shape[0], :a.shape[1]] = a
    canvas[:b.shape[0], a.shape[1]:] = b
    xy1 = np.asarray(xy1)
    xy2 = np.asarray(xy2)
    pairs = np.asarray(pairs)
    m = np.ones(len(pairs), bool) if mask is None else np.asarray(mask)
    rng = np.random.default_rng(7)
    for (i, j), ok in zip(pairs, m):
        if not ok:
            continue
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        p1 = xy1[i]
        p2 = xy2[j] + np.array([a.shape[1], 0.0])
        _line(canvas, p1, p2, color)
        _dot(canvas, p1, color)
        _dot(canvas, p2, color)
    return canvas


def draw_mesh(img, verts, color=(255, 64, 64)) -> np.ndarray:
    """Overlay a solved CPW vertex grid (drawMesh, meshwarper.cpp:788-807).
    verts: [N, M, 2] (x, y) band coords."""
    out = _as_u8_rgb(img).copy()
    v = np.asarray(verts)
    n, m = v.shape[:2]
    for i in range(n):
        for j in range(m):
            if j + 1 < m:
                _line(out, v[i, j], v[i, j + 1], color)
            if i + 1 < n:
                _line(out, v[i, j], v[i + 1, j], color)
            _dot(out, v[i, j], color, r=1)
    return out


def side_by_side(*imgs) -> np.ndarray:
    """Horizontal concat with height padding (showMats grid equivalent)."""
    rgb = [_as_u8_rgb(i) for i in imgs]
    h = max(i.shape[0] for i in rgb)
    cols = []
    for i in rgb:
        pad = np.zeros((h - i.shape[0], i.shape[1], 3), np.uint8)
        cols.append(np.concatenate([i, pad], axis=0))
    return np.concatenate(cols, axis=1)


def save(path: str, img) -> None:
    """Write an RGB array to disk (PNG/JPG by extension)."""
    rgb = _as_u8_rgb(img)
    try:
        import cv2
        # imwrite reports failure (unwritable dir, disk full) by
        # RETURNING False, not raising — treat it as one so the pillow
        # fallback runs and a real failure surfaces
        if not cv2.imwrite(path, rgb[..., ::-1]):
            raise IOError(f"cv2.imwrite failed for {path}")
    except Exception:
        from PIL import Image                 # pillow fallback
        Image.fromarray(rgb).save(path)


def show(img, title: str = "debug", wait_ms: int = 0) -> None:
    """Interactive imshow when a GUI backend exists (st/debug.cpp showMat);
    silently no-ops headless."""
    try:
        import cv2
        cv2.imshow(title, _as_u8_rgb(img)[..., ::-1])
        cv2.waitKey(wait_ms)
    except Exception:
        pass
