"""Runtime configuration surface of the PyTorch port.

An own copy of the JAX package's ``StitcherConfig`` (the port imports
nothing of that package): the same fields, defaults, validation and JSON
format, so one config file drives either package. The reference's
compile-time constant block is 360_stitcher/defs.h:8-76.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


@dataclass
class StitcherConfig:
    # --- rig / inputs (defs.h:37, defs.h:15-17) ---
    num_images: int = 6
    input_width: int = 1920
    input_height: int = 1080
    #: Optional explicit camera yaws (radians). Default: ring, 2*pi*i/N.
    yaws: Optional[Tuple[float, ...]] = None
    #: Horizontal field of view in degrees.
    fov_deg: float = 90.0

    # --- stitching behavior (defs.h:25-27) ---
    wrap_around: bool = True
    recalibrate: bool = True
    enable_local: bool = True

    # --- scales (defs.h:51-53) ---
    work_megapix: float = 0.6
    seam_megapix: float = 0.01
    compose_megapix: float = 1.4

    # --- blending (defs.h:55) ---
    blend_strength: float = 5.0
    #: "multiband" | "feather" | "none"
    blend_type: str = "multiband"

    # --- features / matching (defs.h:60-61) ---
    max_features_per_image: int = 100
    orb_num_features: int = 512
    orb_scale_factor: float = 1.2
    orb_num_levels: int = 4
    lowe_ratio: float = 0.7

    # --- CPW mesh (defs.h:65-71) ---
    mesh_width: int = 10
    mesh_height: int = 10
    #: [local, global, smoothness, temporal] cost weights (defs.h:69).
    alphas: Tuple[float, float, float, float] = (1.0, 0.01, 0.00005, 0.0)
    global_dist: int = 30
    mesh_shrink_px: float = 0.75

    # --- recalibration (defs.h:48-50) ---
    recalib_del_ms: int = 1000
    recalib_thresh_px: int = 15
    recalib_interp: bool = False
    recalib_chunked: bool = True
    update_masks: bool = False
    visualize_matches: bool = False
    visualize_mesh: bool = False
    viz_dir: str = "viz"

    # --- output / consumer (defs.h:39-40,35-36,28-33,41) ---
    output_width: int = 4096
    output_height: int = 2048
    keep_aspect_ratio: bool = True
    add_black_bars: bool = False
    save_video: bool = False
    show_out: bool = False
    send_results: bool = False
    send_height_info: bool = True
    pipeline_mode: str = "auto"
    results_max_size: int = 4
    clear_buffers: bool = False
    trace_dir: str = ""
    trace_frames: int = 20

    # --- live capture plane (defs.h:8,10-20,38) ---
    use_stream: bool = False
    capture_tcp_port: int = 6666
    capture_img_width: int = 1920
    capture_img_height: int = 1620        # NV12: H*1.5 rows of bytes
    player_address: str = "localhost"
    player_tcp_port: int = 55555
    client_addr_start: int = 41
    capture_framing: bool = False
    capture_debug_order: bool = True

    # --- file input (defs.h:22-24,44,74) ---
    video_files: Tuple[str, ...] = ()
    skip_frames: int = 0
    offsets: Tuple[int, ...] = ()

    # --- device knobs (no reference equivalent) ---
    #: Blend pyramid storage: "bfloat16" stores the pyramid tensors in
    #: bf16 with f32 per-level accumulation; "float32" is the exact chain.
    blend_dtype: str = "bfloat16"
    #: Fuse compose-resize + global warp (+ mesh) into one backward map.
    #: False forces the reference's resize -> remap chain (prewarp).
    fuse_maps: bool = True
    #: Backward-map coordinate convention: "exact" evaluates the maps with
    #: source-resolution intrinsics; "reference" reproduces the
    #: reference's compose-intrinsics + back-conversion chain
    #: (calibration.cpp:171-213, timed.cpp:75-90).
    map_convention: str = "exact"
    #: Read by the JAX package's TPU strip kernel only; kept so that one
    #: config file serves both packages.
    use_pallas_remap: bool = True
    #: devices along the camera axis (1 = single device)
    camera_shards: int = 1
    sync_timeout_ms: float = 10000.0

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.yaws is not None and len(self.yaws) != self.num_images:
            raise ValueError("yaws must have num_images entries")
        if self.offsets and len(self.offsets) != self.num_images:
            raise ValueError("offsets must have num_images entries")
        if self.blend_type not in ("multiband", "feather", "none"):
            raise ValueError(f"unknown blend_type {self.blend_type!r}")
        if self.blend_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown blend_dtype {self.blend_dtype!r}")
        if self.map_convention not in ("exact", "reference"):
            raise ValueError(
                f"unknown map_convention {self.map_convention!r}")
        if len(self.alphas) != 4:
            raise ValueError(f"alphas needs 4 entries, got "
                             f"{len(self.alphas)}")
        if self.pipeline_mode not in ("auto", "inline", "threaded"):
            raise ValueError(
                f"unknown pipeline_mode {self.pipeline_mode!r}")

    # --- scale math (360_stitcher/calibration.cpp:269-281,147-153) ---
    @property
    def full_area(self) -> int:
        return self.input_width * self.input_height

    @property
    def work_scale(self) -> float:
        if self.work_megapix < 0:
            return 1.0
        return min(1.0, (self.work_megapix * 1e6 / self.full_area) ** 0.5)

    @property
    def seam_scale(self) -> float:
        if self.seam_megapix < 0:
            return 1.0
        return min(1.0, (self.seam_megapix * 1e6 / self.full_area) ** 0.5)

    @property
    def compose_scale(self) -> float:
        if self.compose_megapix < 0:
            return 1.0
        return min(1.0, (self.compose_megapix * 1e6 / self.full_area) ** 0.5)

    @property
    def seam_work_aspect(self) -> float:
        return self.seam_scale / self.work_scale

    @property
    def compose_work_aspect(self) -> float:
        return self.compose_scale / self.work_scale

    def camera_yaws(self) -> List[float]:
        import math
        if self.yaws is not None:
            return list(self.yaws)
        return [2.0 * math.pi * i / self.num_images
                for i in range(self.num_images)]

    # --- serialization ---
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "StitcherConfig":
        data = json.loads(text)
        for k in ("yaws", "video_files", "offsets", "alphas"):
            if k in data and data[k] is not None:
                data[k] = tuple(data[k])
        return cls(**data)

    @classmethod
    def from_file(cls, path: str) -> "StitcherConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None
                  ) -> "StitcherConfig":
        """CLI over the config surface: --config file.json plus per-field
        overrides."""
        parser = argparse.ArgumentParser(description="360 video stitcher")
        parser.add_argument("--config", type=str, default=None)
        for f in dataclasses.fields(cls):
            name = "--" + f.name.replace("_", "-")
            if f.type in ("bool", bool):
                parser.add_argument(
                    name, type=lambda s: s.lower() in ("1", "true", "yes"),
                    default=None)
            elif f.type in ("int", int):
                parser.add_argument(name, type=int, default=None)
            elif f.type in ("float", float):
                parser.add_argument(name, type=float, default=None)
            elif f.name in ("video_files",):
                parser.add_argument(name, type=str, nargs="*", default=None)
            elif f.name in ("offsets", "yaws", "alphas"):
                parser.add_argument(name, type=float, nargs="*",
                                    default=None)
            else:
                parser.add_argument(name, type=str, default=None)
        ns = parser.parse_args(argv)
        cfg = cls.from_file(ns.config) if ns.config else cls()
        overrides = {}
        for f in dataclasses.fields(cls):
            v = getattr(ns, f.name, None)
            if v is not None:
                if f.name in ("offsets",):
                    v = tuple(int(x) for x in v)
                elif f.name in ("yaws", "alphas"):
                    v = tuple(float(x) for x in v)
                elif f.name == "video_files":
                    v = tuple(v)
                overrides[f.name] = v
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return cfg
