"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU."""

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
#: the CPU-backend commit; shard_map's camera padding; the mesh
#: programs' compile prewarm).
NOT_PORTED = {
    "ops/remap_strips.py": {
        "CHUNK_W", "ChunkStats", "GROUP", "PX", "ROT_KWS", "ROW_ALIGN",
        "ROW_BLOCK", "SLAB_ROT", "SLAB_ROT64", "SLAB_W", "StripPlan",
        "WIN_W", "chunk_stats_device", "device_vmem_bytes",
        "groups_from_packed", "pad_maps", "pad_maps_device", "plan_strips",
        "plan_strips_from_stats", "prep_source", "prep_source_nv12",
        "repack_maps_lane", "resident_src_budget"},
    "mesh/pipeline.py": {"prewarm_mesh_programs"},
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
