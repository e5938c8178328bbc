"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU.
Its contract, not only its names, is the JAX package's: every function,
class and method the port has by a JAX name takes every parameter the
JAX one takes (TPU-only parameters allowlisted, each with its reason),
every `device` parameter is required or defaults to the card, and every
config field is read by the port unless neither package reads it or it
is not ported by design."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from video_stitcher_tpu_torch import Stitcher, StitcherConfig
from video_stitcher_tpu_torch.experiments.remap_separable import pass_v
from video_stitcher_tpu_torch.ops.remap_strips import (
    remap_strips, remap_strips_plain,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "video_stitcher_tpu_torch"


def _forbidden(mod: str) -> bool:
    return (mod == "jax" or mod.startswith("jax.")
            or mod == "video_stitcher_tpu"
            or mod.startswith("video_stitcher_tpu."))


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import video_stitcher_tpu_torch as p\n"
        "from video_stitcher_tpu_torch.pipeline import stitcher\n"
        "from video_stitcher_tpu_torch import interop, _build\n"
        "from video_stitcher_tpu_torch.utils import synth\n"
        "from video_stitcher_tpu_torch.experiments import remap_separable\n"
        "from video_stitcher_tpu_torch.mesh import pipeline, cpw, mesh2map\n"
        "from video_stitcher_tpu_torch.features import orb, match, ransac\n"
        "from video_stitcher_tpu_torch.pipeline import runner\n"
        "from video_stitcher_tpu_torch.io_plane import (\n"
        "    egress, hevc_intra, hevc_lavc, hevc_pcm, ingest, native, queues,\n"
        "    video)\n"
        "from video_stitcher_tpu_torch.utils import (\n"
        "    devsync, log, timing, trace, viz)\n"
        "from video_stitcher_tpu_torch.parallel import dryrun, shard\n"
        "from video_stitcher_tpu_torch.ops import filters, pyramid_int\n"
        "from video_stitcher_tpu_torch.ops import *\n"
        "from video_stitcher_tpu_torch.geometry import *\n"
        "from video_stitcher_tpu_torch.utils import device\n"
        "assert native.load() is not None\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'video_stitcher_tpu' or m.startswith('video_stitcher_tpu.')]"
        "\nassert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_package_import_stays_light():
    """`import video_stitcher_tpu_torch` loads the config alone: no
    torch, no stitcher, no kernel build."""
    code = ("import sys\n"
            "import video_stitcher_tpu_torch as p\n"
            "assert p.__version__\n"
            "heavy = [m for m in sys.modules if m == 'torch' or m in (\n"
            "    'video_stitcher_tpu_torch.pipeline.stitcher',\n"
            "    'video_stitcher_tpu_torch._build')]\n"
            "assert not heavy, heavy\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _module_constant(path: pathlib.Path, name: str):
    """The literal value a module assigns to `name`, read from its source
    (the JAX package is not imported)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} assigns no {name}")


JAX_PKG = ROOT / "video_stitcher_tpu"


@pytest.mark.parametrize("sub", ["", "ops", "geometry"])
def test_init_exports_what_the_jax_package_exports(sub):
    import importlib
    port = importlib.import_module(
        "video_stitcher_tpu_torch" + (f".{sub}" if sub else ""))
    want = _module_constant(JAX_PKG / sub / "__init__.py", "__all__")
    assert port.__all__ == want
    for name in want:
        assert getattr(port, name) is not None, name
    if not sub:
        assert port.__version__ == _module_constant(
            JAX_PKG / "__init__.py", "__version__")


def _public_names(path: pathlib.Path):
    """Top-level public functions, classes and assignments of a module,
    and an __init__'s imported names."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif (isinstance(node, (ast.Import, ast.ImportFrom))
              and path.name == "__init__.py"):
            names |= {a.asname or a.name.split(".")[0] for a in node.names}
    return {n for n in names
            if not n.startswith("_") or n in ("__all__", "__version__")}


#: ROADMAP's "Not ported, by design": TPU scheduling with no meaning on
#: Hopper (the strip planner, layout repack, VMEM budget and their
#: constants; the bf16 row-aligned source prep; the XLA compile cache and
#: the CPU-backend commit; shard_map's camera padding).
NOT_PORTED = {
    "ops/remap_strips.py": {
        "CHUNK_W", "ChunkStats", "GROUP", "PX", "ROT_KWS", "ROW_ALIGN",
        "ROW_BLOCK", "SLAB_ROT", "SLAB_ROT64", "SLAB_W", "StripPlan",
        "WIN_W", "chunk_stats_device", "device_vmem_bytes",
        "groups_from_packed", "pad_maps", "pad_maps_device", "plan_strips",
        "plan_strips_from_stats", "prep_source", "prep_source_nv12",
        "repack_maps_lane", "resident_src_budget"},
    "parallel/shard.py": {"pad_cameras"},
    "utils/hostdev.py": {"commit", "host_eager"},
    "utils/xla_cache.py": {"build_programs", "cache_dir", "enable",
                           "prime"},
}


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    """Each public name of each module of the JAX package has one of the
    same name in the port's file of the same path, or is listed as not
    ported by design."""
    missing = {}
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        twin = PKG / rel
        have = _public_names(twin) if twin.exists() else set()
        gap = _public_names(path) - have - NOT_PORTED.get(rel, set())
        if gap:
            missing[rel] = sorted(gap)
    assert not missing, missing
    for rel, names in NOT_PORTED.items():       # no stale entry
        assert names <= _public_names(JAX_PKG / rel), rel
        twin = PKG / rel
        assert not twin.exists() or not names & _public_names(twin), rel


def _params(fn):
    """The parameter names of a def, self and cls left out."""
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    names += [f"*{v.arg}" for v in (a.vararg,) if v is not None]
    names += [f"**{v.arg}" for v in (a.kwarg,) if v is not None]
    return [n for n in names if n not in ("self", "cls")]


def _signatures(path: pathlib.Path):
    """{qualified name: parameter names} of a module's public top-level
    functions, and of its public classes' constructors (`__init__`, or
    the fields of a dataclass or NamedTuple) and public methods."""
    sigs = {}
    for node in ast.parse(path.read_text()).body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            sigs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            sigs[f"{node.name}.__init__"] = [
                b.target.id for b in node.body
                if isinstance(b, ast.AnnAssign)
                and isinstance(b.target, ast.Name)]
            for b in node.body:
                if (isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and (b.name == "__init__"
                             or not b.name.startswith("_"))):
                    sigs[f"{node.name}.{b.name}"] = _params(b)
    return sigs


_STRIP = "the TPU strip plan's statics; K1 walks the tile plan (`plan`)"
#: (file, name, JAX parameter) -> why the port's counterpart lacks it
SIGNATURE_ALLOW = {
    **{("calib/state.py", "CalibState.__init__", f): (
        "TPU strip-plan field; the tile plan is built from the maps with "
        "each state installed, never checkpointed")
       for f in ("warp_strip_off", "warp_chunk_packed", "warp_maps_lane",
                 "warp_groups")},
    ("mesh/pipeline.py", "prewarm_mesh_programs", "strip_warp"):
        "chose between the TPU strip kernel and XLA's gather for the "
        "estimation warp; the port's is always K1 over the global plan",
    ("features/ransac.py", "ransac_homography", "key"):
        "a JAX PRNG key; the port draws from a torch.Generator (`generator`)",
    ("ops/remap_strips.py", "remap_strips", "src_planar"):
        "renamed `src`: K1 reads the u8 or f32 planar source as it is",
    ("ops/remap_strips.py", "remap_strips", "maps_lane"):
        "the TPU's lane-repacked maps; K1 reads `maps` [N, 2, bh, bw]",
    **{("ops/remap_strips.py", "remap_strips", f): _STRIP
       for f in ("strip_off", "chunk_packed", "groups", "sh", "whc",
                 "slab_w")},
    ("ops/remap_strips.py", "remap_strips", "interpret"):
        "Pallas interpret mode; a CPU tensor takes K1's plain version",
    **{("ops/resize.py", f"apply_interp_{a}", "tiles_or_m"): (
        "renamed `m`: the dense matrix only, the TPU's band tiles are not "
        "ported") for a in "wh"},
    **{("parallel/shard.py", n, f): (
        "shard_map's mesh and axis; the port takes a list of `devices`")
       for n in ("shard_state", "build_sharded_step")
       for f in ("mesh", "axis")},
    ("parallel/shard.py", "build_sharded_step", "total_cams"):
        "shard_map's padded camera count; the port's shards need no padding",
    ("parallel/shard.py", "build_sharded_step", "warp_static"): _STRIP,
    **{("pipeline/stitcher.py", n, "warp_static"): _STRIP
       for n in ("warp_bands", "stitch_pano", "stitch_pano_int16")},
}


def _signature_gaps(allow):
    """(JAX parameters the port lacks, not allowlisted; allowlist entries
    that no longer name such a gap)."""
    gaps, used = [], set()
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        twin = PKG / rel
        if not twin.exists():
            continue
        port = _signatures(twin)
        for name, params in _signatures(path).items():
            for p in params:
                if name in port and p not in port[name]:
                    key = (rel, name, p)
                    (used.add if key in allow else gaps.append)(key)
    return gaps, sorted(set(allow) - used)


def test_every_counterpart_takes_the_jax_parameters():
    assert _signature_gaps(SIGNATURE_ALLOW) == ([], [])


@pytest.mark.parametrize("entry", sorted(SIGNATURE_ALLOW))
def test_signature_guard_needs_each_allowlist_entry(entry):
    allow = {k: v for k, v in SIGNATURE_ALLOW.items() if k != entry}
    assert _signature_gaps(allow) == ([entry], [])


def test_signature_guard_catches_a_stale_entry():
    stale = ("pipeline/stitcher.py", "Stitcher.load_calibration",
             "frames_shape")
    assert _signature_gaps({**SIGNATURE_ALLOW, stale: "x"}) == ([], [stale])


def _device_defaults(path: pathlib.Path):
    """(qualified name, default source or None if required) of every def
    in a module with a `device` parameter."""
    out = []

    def walk(body, prefix):
        for node in body:
            if isinstance(node, ast.ClassDef):
                walk(node.body, f"{prefix}{node.name}.")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = node.args
                pos = a.posonlyargs + a.args
                pairs = list(zip(pos, [None] * (len(pos) - len(a.defaults))
                                 + a.defaults))
                pairs += list(zip(a.kwonlyargs, a.kw_defaults))
                for prm, d in pairs:
                    if prm.arg == "device":
                        out.append((prefix + node.name,
                                    None if d is None else ast.unparse(d)))
                walk(node.body, f"{prefix}{node.name}.")
    walk(ast.parse(path.read_text()).body, "")
    return out


def test_every_device_parameter_is_required_or_defaults_to_the_card():
    """A `device` parameter is required or None (resolve_device: the card).
    The one other default allowed is the JAX package's own `device=False`
    flag of `stitch*` (return the tensor on the device), where the JAX
    counterpart has the same default."""
    bad, flags = [], 0
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG).as_posix()
        jax_twin = JAX_PKG / rel
        jax_defaults = (dict(_device_defaults(jax_twin))
                        if jax_twin.exists() else {})
        for name, default in _device_defaults(path):
            if default in (None, "None"):
                continue
            if default == "False" and jax_defaults.get(name) == "False":
                flags += 1
                continue
            bad.append((rel, name, default))
    assert not bad, bad
    assert flags == 5        # stitch, stitch_nv12, stitch_batch, stitch_out,
                             # stitch_int16


def _cfg_fields(path: pathlib.Path):
    cls = next(n for n in ast.parse(path.read_text()).body
               if isinstance(n, ast.ClassDef) and n.name == "StitcherConfig")
    return {b.target.id for b in cls.body if isinstance(b, ast.AnnAssign)}


def _attribute_reads(pkg: pathlib.Path):
    """Every attribute name a package loads outside its config module,
    as `x.name` or `getattr(x, "name", ...)`."""
    names = set()
    for path in pkg.rglob("*.py"):
        if path == pkg / "config.py":
            continue
        for n in ast.walk(ast.parse(path.read_text())):
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
                names.add(n.attr)
            elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                  and n.func.id == "getattr" and len(n.args) >= 2
                  and isinstance(n.args[1], ast.Constant)):
                names.add(n.args[1].value)
    return names


#: config fields the JAX package reads and the port does not, by design
CONFIG_NOT_READ = {
    "use_pallas_remap": "chose between the TPU strip kernel and XLA's "
                        "gather, two TPU lowerings of what K1 computes",
}


def _config_gaps(by_design):
    """(fields the JAX package reads and the port does not, unlisted;
    listed fields the port reads or the JAX package does not)."""
    fields = _cfg_fields(PKG / "config.py")
    assert fields == _cfg_fields(JAX_PKG / "config.py")
    port, jax_reads = _attribute_reads(PKG), _attribute_reads(JAX_PKG)
    gaps = sorted(f for f in fields - port
                  if f in jax_reads and f not in by_design)
    stale = sorted(f for f in by_design
                   if f in port or f not in jax_reads or f not in fields)
    return gaps, stale


def test_every_config_field_is_read_or_listed():
    assert _config_gaps(CONFIG_NOT_READ) == ([], [])
    fields = _cfg_fields(PKG / "config.py")
    unread = fields - _attribute_reads(PKG) - set(CONFIG_NOT_READ)
    assert unread == {"work_megapix", "seam_megapix", "compose_megapix"}
    assert not unread & _attribute_reads(JAX_PKG)   # the scales' inputs


def test_config_guard_needs_its_entry_and_catches_a_stale_one():
    assert _config_gaps({}) == (["use_pallas_remap"], [])
    assert _config_gaps({**CONFIG_NOT_READ, "camera_shards": "x"}) == (
        [], ["camera_shards"])


SOURCES = sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))


def test_source_scan_reaches_every_subpackage():
    dirs = {pathlib.Path(p).parent.name for p in SOURCES}
    assert {"features", "mesh", "calib", "ops", "pipeline", "io_plane",
            "utils", "parallel"} <= dirs
    for path in ("mesh/cpw.py", "pipeline/runner.py", "io_plane/native.py",
                 "io_plane/ingest.py", "utils/devsync.py",
                 "parallel/shard.py", "parallel/dryrun.py",
                 "ops/pyramid_int.py", "ops/filters.py"):
        assert f"video_stitcher_tpu_torch/{path}" in SOURCES


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_smoke_script_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert not [n for n in names if _forbidden(n)], node.lineno


def test_stitcher_defaults_to_the_card():
    cfg = StitcherConfig(num_images=2, input_width=64, input_height=36,
                         enable_local=False)
    if torch.cuda.is_available():
        assert Stitcher(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Stitcher(cfg)
    assert Stitcher(cfg, device="cpu").device.type == "cpu"


def test_compose_fused_maps_defaults_to_the_card():
    from video_stitcher_tpu_torch.calib.calibration import (
        compose_fused_maps, plan_geometry,
    )
    from video_stitcher_tpu_torch.geometry.cylindrical import (
        band_backward_maps,
    )
    cfg = StitcherConfig(num_images=2, input_width=64, input_height=36,
                         enable_local=False)
    geom, cams = plan_geometry(cfg)
    maps = band_backward_maps(geom.layout, cams)
    if torch.cuda.is_available():
        assert compose_fused_maps(geom, maps).shape == maps.shape
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            compose_fused_maps(geom, maps)
    assert compose_fused_maps(geom, maps, device="cpu").shape == maps.shape


def _entry_calls(tmp_path):
    """Each entry that takes a device, as a call with `device` given: the
    inputs are tiny and on the host."""
    from video_stitcher_tpu_torch import interop
    from video_stitcher_tpu_torch.calib import calibration, state
    from video_stitcher_tpu_torch.mesh.mesh2map import mesh_to_backward_maps
    cfg = StitcherConfig(num_images=2, input_width=64, input_height=36,
                         enable_local=False)
    frames = np.random.default_rng(0).integers(
        0, 255, (2, 36, 64, 3)).astype(np.uint8)
    geom = calibration.plan_geometry(cfg)[0]
    ckpt = str(tmp_path / "c.npz")
    state.save_state(ckpt, calibration.calibrate(frames, cfg,
                                                 device="cpu")[1])
    verts = np.stack(np.meshgrid(np.linspace(0, 15, 3), np.linspace(0, 7, 3)),
                     -1)[None].astype(np.float32)
    z = np.zeros(3)
    return {
        "calibrate": (lambda d: calibration.calibrate(frames, cfg,
                                                      device=d)[1].gains),
        "rebuild_aux": (lambda d: calibration.rebuild_aux(
            cfg, geom, device=d)["band_maps"]),
        "load_state": lambda d: state.load_state(ckpt, device=d).gains,
        "mesh_to_backward_maps": (lambda d: mesh_to_backward_maps(
            verts, 8, 16, device=d)),
        "state_from_numpy": (lambda d: interop.state_from_numpy(
            np.zeros((1, 2, 4, 4)), np.ones(1), [np.ones((1, 1, 4, 4))],
            np.ones((4, 4)), device=d).gains),
        "keypoints_from_numpy": (lambda d: interop.keypoints_from_numpy(
            np.zeros((3, 2)), z, z, z > 0, np.zeros((3, 8), np.uint32),
            device=d).xy),
        "matches_from_numpy": (lambda d: interop.matches_from_numpy(
            z, z, z, z > 0, device=d).query),
    }


ENTRIES = ("calibrate", "rebuild_aux", "load_state", "mesh_to_backward_maps",
           "state_from_numpy", "keypoints_from_numpy", "matches_from_numpy")


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_defaults_to_the_card(entry, tmp_path):
    """With no device the entry's tensors land on the card, and on a host
    without CUDA it raises; device="cpu" keeps them on the host."""
    call = _entry_calls(tmp_path)[entry]
    if torch.cuda.is_available():
        assert call(None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            call(None)
    assert call("cpu").device.type == "cpu"


def test_camera_shards_calibrate_and_shard_on_the_cpu():
    """Every path of the JAX package is ported, camera sharding too: with
    camera_shards=2 on the CPU the stitcher calibrates (with the CPW
    mesh on) and shards its state over [cpu] * 2."""
    frames = np.random.default_rng(0).integers(
        0, 255, (2, 36, 64, 3)).astype(np.uint8)
    cfg = StitcherConfig(num_images=2, input_width=64, input_height=36,
                         camera_shards=2)
    assert cfg.enable_local
    st = Stitcher(cfg, device="cpu")
    st.calibrate(frames)
    shards = st._sharded.shards
    assert [(s.device.type, s.lo, s.hi) for s in shards] == [
        ("cpu", 0, 1), ("cpu", 1, 2)]
    assert st.stitch(frames).shape == (st.geom.pano_h, st.geom.pano_w, 3)


def test_native_library_name_follows_source_headers_and_flags(tmp_path,
                                                              monkeypatch):
    """A native library is rebuilt exactly when its source, a header it
    includes or its flags change: all three are in its name."""
    from video_stitcher_tpu_torch.io_plane import native
    for name in ("hevc_pcm.cpp", "cabac_tables.h"):
        (tmp_path / name).write_bytes((native.NATIVE_DIR / name)
                                      .read_bytes())
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    before = native.library_path("libhevcpcm.so")
    assert before.name.startswith("libhevcpcm-")
    assert native.library_path("libhevcpcm.so") == before
    (tmp_path / "cabac_tables.h").write_text(
        (tmp_path / "cabac_tables.h").read_text() + "\n// changed\n")
    after_header = native.library_path("libhevcpcm.so")
    assert after_header != before
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ("-g",))
    assert native.library_path("libhevcpcm.so") != after_header
    assert before.parent == native._build.BUILD_DIR


def test_no_binary_is_tracked_under_the_port():
    """The native sources and kernels ship as sources: a library exists
    only where it is built, in the git-ignored _build/."""
    binary = (".so", ".o", ".a")
    if (ROOT / ".git").exists():
        out = subprocess.run(["git", "ls-files", "video_stitcher_tpu_torch"],
                             cwd=str(ROOT), capture_output=True, text=True,
                             timeout=60)
        assert out.returncode == 0, out.stderr
        tracked = out.stdout.split()
        assert "video_stitcher_tpu_torch/native/stitchio.cpp" in tracked
        assert not [p for p in tracked if p.endswith(binary)]
    else:                                  # an export of the tree
        assert not [p for p in PKG.rglob("*") if p.suffix in binary
                    and "_build" not in p.relative_to(PKG).parts]


def test_remap_strips_checks_its_inputs():
    src = torch.zeros((4, 3, 8, 8), dtype=torch.uint8)
    maps = torch.zeros((2, 2, 4, 4))
    gains = torch.ones(4)
    assert remap_strips(src, maps, gains).shape == (4, 3, 4, 4)
    with pytest.raises(ValueError, match="tile"):
        remap_strips(src[:3], maps, gains[:3])
    with pytest.raises(ValueError, match="gains"):
        remap_strips(src, maps, gains[:2])
    with pytest.raises(TypeError, match="u8 or f32"):
        remap_strips(src.to(torch.int32), maps, gains)
    with pytest.raises(TypeError, match="float32"):
        remap_strips_plain(src, maps.double(), gains)
    with pytest.raises(ValueError, match="no K1 kernel"):
        remap_strips(src.to("meta"), maps.to("meta"), gains.to("meta"))


def test_cpu_calls_are_not_counted_as_launches():
    before = remap_strips.launches
    remap_strips(torch.zeros((1, 3, 4, 4)), torch.zeros((1, 2, 4, 4)),
                 torch.ones(1))
    assert remap_strips.launches == before
    before = pass_v.launches
    pass_v(torch.zeros((1, 3, 8, 256), dtype=torch.bfloat16),
           torch.zeros((1, 2, 8, 128)))
    assert pass_v.launches == before
