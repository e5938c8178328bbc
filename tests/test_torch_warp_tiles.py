"""The tile plan of the warp kernels K1 and K2 (``ops/warp_tiles.py``).

The plan is plain torch, so it is held here on the CPU: a tile is active
exactly when a tap of one of its pixels lies in the source (derived here
tap by tap), the order lists the active tiles first, map-major, and a
plain emulation of the kernels' walk of the plan (zeros for the empty
tiles, read from nothing; each active tile from its own maps) equals
``remap_strips_plain`` and ``pass_v_plain`` bit for bit, on random maps,
edited maps and the calibrated 6x320x180 rig. The Stitcher installs the
plan of its maps with every state. The build hashes the headers a kernel
includes."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu_torch import Stitcher, StitcherConfig, _build
from video_stitcher_tpu_torch.calib.calibration import plan_geometry
from video_stitcher_tpu_torch.experiments import remap_separable as sep
from video_stitcher_tpu_torch.ops import warp_tiles as wt
from video_stitcher_tpu_torch.ops.remap_strips import (
    plan_remap, remap_strips, remap_strips_plain,
)
from video_stitcher_tpu_torch.utils.synth import make_scene, render_views

RING = dict(num_images=6, input_width=320, input_height=180,
            enable_local=False)


@pytest.fixture(scope="module")
def rig():
    cfg = StitcherConfig(**RING)
    st = Stitcher(cfg, device="cpu")
    geom, _ = plan_geometry(cfg)
    rng = np.random.default_rng(7)
    scene = make_scene(geom.layout.pano_w, geom.layout.pano_h, rng)
    frames = render_views(cfg, geom, scene)
    st.calibrate(frames)
    return dict(cfg=cfg, st=st, frames=frames)


def _random_maps(rng, n, bh, bw, h, w):
    """Smooth maps that wander across and past the source, with a -1
    region and coordinates in (-1, 0) and just past the far edges."""
    gy, gx = np.mgrid[0:bh, 0:bw].astype(np.float64)
    maps = np.empty((n, 2, bh, bw), np.float32)
    for i in range(n):
        a, b = rng.uniform(0.5, 1.6, 2)
        maps[i, 0] = (rng.uniform(-40, 20) + a * gx
                      + 6 * np.sin(gy / 7 + i))
        maps[i, 1] = (rng.uniform(-30, 10) + b * gy
                      + 5 * np.cos(gx / 11 + i))
    maps[:, :, 3:9, 5:30] = -1.0
    maps[:, 0, 12:14, :40] = np.linspace(-0.999, -0.001, 40)
    maps[:, 1, 14:16, 40:80] = np.linspace(h - 1.5, h + 0.5, 40)
    maps[:, 0, 16:18, 40:80] = np.linspace(w - 1.5, w + 0.5, 40)
    return torch.from_numpy(maps)


def _edited(maps, h, w):
    """Calibrated maps with the cases K1 must get right written in (as
    chip_smoke.py's edited and stretched maps): a -1 region, (-1, 0)
    coordinates, coordinates past the right and bottom edges, and a
    stretched region whose tiles span much of the source."""
    m = maps.clone()
    bh, bw = m.shape[2], m.shape[3]
    m[:, :, bh // 4:bh // 4 + 8, bw // 3:bw // 3 + 20] = -1.0
    m[:, 0, bh // 2:bh // 2 + 4, :48] = torch.linspace(-0.999, -0.001, 48)
    m[:, 1, bh // 8:bh // 8 + 4, bw // 2:bw // 2 + 48] = torch.linspace(
        h - 1.5, h + 0.5, 48)
    rows = slice(bh // 2 + 16, bh // 2 + 48)
    m[:, 0, rows, 64:192] = torch.linspace(0, w - 1, 128)
    m[:, 1, rows, 64:192] = torch.linspace(0, h - 1, 32)[:, None]
    return m.contiguous()


def _maps_case(name, rig):
    h, w = RING["input_height"], RING["input_width"]
    if name == "random":
        return _random_maps(np.random.default_rng(11), 3, 96, 200, h, w)
    fused = rig["st"].state.fused_maps
    return fused if name == "calibrated" else _edited(fused, h, w)


def _origins(kind, maps, h, w):
    """The tap origins the kernel computes, derived here on their own."""
    if kind == "K1":
        mx = torch.clamp(maps[:, 0], -2.0, w + 1.0)
        my = torch.clamp(maps[:, 1], -2.0, h + 1.0)
        return torch.floor(mx).long(), torch.floor(my).long()
    bw = maps.shape[3]
    base = ((torch.arange(bw) // sep.CHUNK_W) * sep.CHUNK_W
            - sep.XPAD).float()
    lx = torch.clamp(maps[:, 0], -2.0 - sep.XPAD, w + 1.0 - sep.XPAD) - base
    ly = torch.clamp(maps[:, 1], -2.0, h + 1.0)
    return ((torch.floor(lx) + base + sep.XPAD).long(),
            torch.floor(ly).long())


def _live_tiles(x0, y0, h, w):
    """bool [n, tiles_y, tiles_x]: some pixel of the tile has a tap in
    the source, tap by tap."""
    live = torch.zeros_like(x0, dtype=torch.bool)
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = x0 + dx, y0 + dy
            live |= (x >= 0) & (x < w) & (y >= 0) & (y < h)
    n, bh, bw = live.shape
    ty, tx = -(-bh // wt.TILE_H), -(-bw // wt.TILE_W)
    live = torch.nn.functional.pad(live, (0, tx * wt.TILE_W - bw,
                                          0, ty * wt.TILE_H - bh))
    return live.reshape(n, ty, wt.TILE_H, tx, wt.TILE_W).any(4).any(2)


def _tiles_of(plan, out):
    """out [N, C, bh, bw] -> the same, cut into the plan's tiles:
    [N, C, tiles_y, TILE_H, tiles_x, TILE_W] (zero-padded)."""
    _, ty, tx = plan.tiles
    n, c, bh, bw = out.shape
    out = torch.nn.functional.pad(out, (0, tx * wt.TILE_W - bw,
                                        0, ty * wt.TILE_H - bh))
    return out.reshape(n, c, ty, wt.TILE_H, tx, wt.TILE_W)


def _walk(plan, want):
    """The kernels' walk of the plan, given what the plain version
    computes for each active tile: the empty tiles' zeros, written
    without reading anything, and the active tiles' pixels. The k-th tile
    of the order is active when k < count[0], the count the kernels read
    from the plan's tensor. Camera n walks the tiles of map n % n_maps."""
    n_maps = plan.tiles[0]
    n_active = int(plan.count[0])
    empty = torch.ones(plan.order.numel(), dtype=torch.bool)
    empty[plan.order[:n_active].long()] = False
    empty = empty.reshape(plan.tiles)
    got = _tiles_of(plan, want).clone()
    for n in range(want.shape[0]):
        got[n].permute(1, 3, 0, 2, 4)[empty[n % n_maps]] = 0.0
    bh, bw = want.shape[2:]
    return got.reshape(got.shape[:2] + (got.shape[2] * wt.TILE_H,
                                        got.shape[4] * wt.TILE_W)
                       )[..., :bh, :bw]


K1_CASES = ["random", "edited", "calibrated"]
K2_CASES = ["random", "stretched", "calibrated"]


@pytest.mark.parametrize("name", K1_CASES)
def test_k1_active_tiles_are_those_with_an_in_source_tap(name, rig):
    h, w = RING["input_height"], RING["input_width"]
    maps = _maps_case(name, rig)
    plan = plan_remap(maps, h, w)
    assert torch.equal(plan.active, _live_tiles(*_origins("K1", maps, h, w),
                                                h, w))
    assert plan.tiles == (maps.shape[0], -(-maps.shape[2] // wt.TILE_H),
                          -(-maps.shape[3] // wt.TILE_W))
    assert 0 < plan.n_active < plan.order.numel()


@pytest.mark.parametrize("name", K2_CASES)
def test_k2_active_tiles_are_those_with_an_in_source_tap(name, rig):
    i1, vmaps = _vmaps_case(name, rig)
    hp, wp = i1.shape[2:]
    plan = sep.plan_pass_v(vmaps, hp, wp)
    assert torch.equal(plan.active,
                       _live_tiles(*_origins("K2", vmaps, hp, wp), hp, wp))
    assert 0 < plan.n_active < plan.order.numel()


@pytest.mark.parametrize("mx,my,active", [
    (-0.5, 5.0, True),          # x taps -1 (out) and 0 (in)
    (-1.0, 5.0, True),          # x0 = -1, its x1 = 0 tap has weight 0
    (-1.5, 5.0, False),         # x taps -2 and -1
    (5.0, -0.5, True),
    (5.0, -1.5, False),
    (319.5, 5.0, True),         # x taps 319 (in) and 320 (out)
    (320.0, 5.0, False),
    (5.0, 179.5, True),
    (5.0, 180.0, False),
])
def test_a_tile_is_active_when_any_tap_reaches_the_source(mx, my, active):
    """One tile whose every pixel samples one point, the rest of the
    band far outside: the tile's activity follows its edge taps, and the
    kernels' walk of the plan still equals the plain version."""
    h, w = RING["input_height"], RING["input_width"]
    maps = torch.full((1, 2, 32, 128), -50.0)
    maps[0, 0, 16:, 64:] = mx
    maps[0, 1, 16:, 64:] = my
    plan = plan_remap(maps, h, w)
    want_active = torch.zeros(1, 2, 2, dtype=torch.bool)
    want_active[0, 1, 1] = active
    assert torch.equal(plan.active, want_active)
    src = torch.arange(3 * h * w, dtype=torch.float32).reshape(1, 3, h, w)
    want = remap_strips_plain(src % 251 + 1, maps, torch.ones(1))
    assert torch.equal(_walk(plan, want), want)


@pytest.mark.parametrize("name", K1_CASES)
def test_order_lists_active_tiles_map_major_then_empty(name, rig):
    h, w = RING["input_height"], RING["input_width"]
    plan = plan_remap(_maps_case(name, rig), h, w)
    flat_active = plan.active.reshape(-1)
    head, tail = plan.order[:plan.n_active], plan.order[plan.n_active:]
    assert plan.order.dtype == torch.int32
    assert torch.equal(torch.sort(plan.order).values,
                       torch.arange(plan.order.numel(), dtype=torch.int32))
    assert int(flat_active.sum()) == plan.n_active
    assert bool(flat_active[head.long()].all())
    assert not bool(flat_active[tail.long()].any())
    assert bool((head[1:] > head[:-1]).all())
    assert bool((tail[1:] > tail[:-1]).all())
    assert plan.counts() == {"empty": tail.numel(), "active": head.numel()}


@pytest.mark.parametrize("name", K1_CASES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_tile_walk_equals_the_plain_k1(name, dtype, rig):
    h, w = RING["input_height"], RING["input_width"]
    maps = _maps_case(name, rig)
    rng = np.random.default_rng(5)
    n = 2 * maps.shape[0]                        # a batched frame set
    src = torch.from_numpy(rng.integers(1, 256, (n, 3, h, w)).astype(
        np.uint8))
    if dtype == torch.float32:
        src = src.float() * 0.75 + 0.125
    gains = torch.from_numpy(rng.uniform(0.8, 1.25, n).astype(np.float32))
    plan = plan_remap(maps, h, w)
    want = remap_strips_plain(src, maps, gains)
    assert torch.equal(_walk(plan, want), want)
    # each active tile computed from its own maps alone
    _, ty, tx = plan.tiles
    for n_ in (0, n - 1):
        m = n_ % maps.shape[0]
        for t in plan.order[:plan.n_active].tolist():
            if t // (ty * tx) != m:
                continue
            r, c = divmod(t % (ty * tx), tx)
            rs = slice(r * wt.TILE_H, (r + 1) * wt.TILE_H)
            cs = slice(c * wt.TILE_W, (c + 1) * wt.TILE_W)
            tile = remap_strips_plain(src[n_:n_ + 1],
                                      maps[m:m + 1, :, rs, cs].contiguous(),
                                      gains[n_:n_ + 1])
            assert torch.equal(tile[0], want[n_, :, rs, cs])
    # the wrapper takes the plain path on the CPU, plan or none
    assert torch.equal(remap_strips(src, maps, gains, plan), want)


def _vmaps_case(name, rig):
    """Pass-V maps and I1 (bf16, the zero halo) for K2."""
    rng = np.random.default_rng(9)
    if name == "calibrated":
        fused = rig["st"].state.fused_maps.numpy()
        maps_p, gmx = sep.pad_maps(fused, sep.global_x_map(fused))
        maps_p[0, :, :12, :20] = -1.0
        vmaps = sep.plan_separable(maps_p, gmx, RING["input_height"],
                                   RING["input_width"]).vmaps
        hp = sep._round_up(RING["input_height"], sep.ROW_ALIGN)
    else:
        n, bh, bw, hp = 2, 48, 256, 64
        gy, gx = np.mgrid[0:bh, 0:bw].astype(np.float64)
        vmaps = np.empty((n, 2, bh, bw), np.float32)
        for i in range(n):
            vmaps[i, 0] = np.clip(gx + 2.0 * np.sin(gy / 5.0 + i)
                                  * np.cos(gx / 17.0), 0, bw - 1)
            vmaps[i, 1] = -4 + gy * 1.4 + 1.5 * np.sin(gx / 23.0 + i)
        vmaps[0, :, :6, :40] = -2.0
        vmaps[1, :, 32:, 192:] = -2.0
        if name == "stretched":
            vmaps[1, 1, 16:32, 64:128] = np.linspace(0, hp - 1, 16)[:, None]
    bw = vmaps.shape[3]
    n = vmaps.shape[0]
    i1 = torch.zeros((n, 3, hp, bw + sep.XPAD + sep.LANE_PAD_R),
                     dtype=torch.bfloat16)
    i1[..., sep.XPAD:sep.XPAD + bw] = torch.from_numpy(
        rng.uniform(1, 255, (n, 3, hp, bw)).astype(np.float32)
    ).to(torch.bfloat16)
    return i1, torch.from_numpy(np.ascontiguousarray(vmaps))


@pytest.mark.parametrize("name", K2_CASES)
def test_tile_walk_equals_the_plain_k2(name, rig):
    i1, vmaps = _vmaps_case(name, rig)
    plan = sep.plan_pass_v(vmaps, *i1.shape[2:])
    want = sep.pass_v_plain(i1, vmaps)
    assert torch.equal(_walk(plan, want), want)
    assert torch.equal(sep.pass_v(i1, vmaps, plan), want)


def _assert_plan_of(st):
    state, geom, plan = st._snapshot()
    want = plan_remap(state.fused_maps, geom.src_h, geom.src_w)
    assert torch.equal(plan.order, want.order)
    assert plan.n_active == want.n_active
    plan.check(state.fused_maps.shape[0], *state.fused_maps.shape[2:],
               geom.src_h, geom.src_w, state.fused_maps.device)


def test_stitcher_installs_the_plan_of_each_state(rig, tmp_path):
    st = rig["st"]
    _assert_plan_of(st)                                   # calibrate
    path = str(tmp_path / "calib.npz")
    st.save_calibration(path)
    with np.load(path) as z:
        assert not [k for k in z.files if "plan" in k or "order" in k]
    loaded = Stitcher(rig["cfg"], device="cpu")
    loaded.load_calibration(path)
    _assert_plan_of(loaded)                               # load
    state = st.state
    m = state.fused_maps.clone()
    m[:, :, :, : m.shape[3] // 2] = -3.0       # no tap in the source
    loaded.swap_state(state._replace(fused_maps=m))
    _assert_plan_of(loaded)                               # swap
    assert loaded.plan.n_active < st.plan.n_active


def test_a_plan_for_other_maps_is_refused(rig):
    h, w = RING["input_height"], RING["input_width"]
    plan = plan_remap(_maps_case("random", rig), h, w)
    with pytest.raises(ValueError, match="does not fit"):
        plan.check(6, 288, 352, h, w, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not fit"):
        plan.check(3, 96, 200, h, w + 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="tile plan on"):
        plan.check(3, 96, 200, h, w, torch.device("meta"))
    with pytest.raises(ValueError, match="count"):
        plan._replace(count=plan.count.long()).check(
            3, 96, 200, h, w, torch.device("cpu"))


def test_walk_follows_the_plan_copied_into_a_plans_tensors(rig):
    """A plan's tensors written over with another plan of the same maps'
    shape walk as that plan (what a captured K1 launch reads after a
    swap): the active count comes from the tensor."""
    h, w = RING["input_height"], RING["input_width"]
    fused = rig["st"].state.fused_maps
    edited = _edited(fused, h, w)
    a, b = plan_remap(fused, h, w), plan_remap(edited, h, w)
    assert a.n_active != b.n_active
    held = a._replace(order=a.order.clone(), count=a.count.clone())
    held.order.copy_(b.order)
    held.count.copy_(b.count)
    rng = np.random.default_rng(13)
    src = torch.from_numpy(rng.integers(1, 256, (6, 3, h, w)).astype(
        np.uint8))
    gains = torch.from_numpy(rng.uniform(0.8, 1.25, 6).astype(np.float32))
    want = remap_strips_plain(src, edited, gains)
    assert held.n_active == b.n_active
    assert torch.equal(_walk(held, want), want)
    assert not torch.equal(_walk(a, want), want)


@pytest.mark.parametrize("case", ["contiguous", "aligned", "channels",
                                  "width"])
def test_launch_checks(case):
    maps = torch.zeros(64)
    ok = dict(maps=maps, tensors={"src": torch.zeros(8, 8)}, channels=3,
              bw=128)
    bad = {"contiguous": dict(ok, tensors={"src": torch.zeros(8, 8).t()}),
           "aligned": dict(ok, maps=maps[1:]),
           "channels": dict(ok, channels=4),
           "width": dict(ok, bw=130)}[case]
    wt.check_launchable("K1", **ok)
    with pytest.raises(ValueError):
        wt.check_launchable("K1", **bad)


def test_library_hash_follows_the_included_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert sorted(p.name for p in _build.sources("k")) == [
        "a.cuh", "b.cuh", "k.cu"]
    before = _build.library_path("k")
    (tmp_path / "other.cuh").write_text("// changed\n")
    assert _build.library_path("k") == before
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build.library_path("k") != before
    assert "-Xptxas" in _build.NVCC_FLAGS


def test_every_kernel_source_includes_the_tile_header():
    """Every warp kernel walks the tile plan of warp_tiles.cuh (the
    blend's kernels, csrc/blend_levels.cu, have no plan)."""
    warps = [name for name in _build.KERNELS if name != "blend_levels"]
    assert warps == ["remap_gain", "remap_separable"]
    for name in warps:
        names = [p.name for p in _build.sources(name)]
        assert "warp_tiles.cuh" in names, name
