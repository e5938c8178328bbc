"""Build the port's native I/O libraries with g++ and load them through
ctypes.

The sources are the port's own copies in ``native/``: ``stitchio.cpp``
(frame queue, TCP capture server, host colour conversions),
``hevc_pcm.cpp`` and ``hevc_intra.cpp`` (both with ``cabac_tables.h``) and
``hevc_lavc.cpp`` (x265 through the system libavcodec). Each builds at
first use, with the flags of the JAX package's ``native/Makefile``, into
the git-ignored ``_build/`` under a name that carries a hash of the
source, the headers it includes and the flags (``_build.hashed_name``),
so a library is rebuilt exactly when one of them changes. Every build is
bounded by a timeout. A library that does not build (no compiler, or no
libavcodec headers for ``libhevclavc``) loads as None, and its callers
take their pure-Python path or the next encoder of the egress chain.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

from video_stitcher_tpu_torch import _build

NATIVE_DIR = _build._PKG / "native"
CXX = "g++"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-pthread")
BUILD_TIMEOUT_S = 180.0
#: library -> (source, extra compile flags); native/Makefile's targets
LIBS = {
    "libstitchio.so": ("stitchio.cpp", ()),
    "libhevcpcm.so": ("hevc_pcm.cpp", ()),
    "libhevcintra.so": ("hevc_intra.cpp", ("-O3",)),
    "libhevclavc.so": ("hevc_lavc.cpp", ()),
}

_lock = threading.Lock()
_cache: Dict[str, Optional[ctypes.CDLL]] = {}


class Built(NamedTuple):
    """One library's build: the seconds it took (0.0 when reused) and the
    compiler's error, None when it built."""
    seconds: float
    error: Optional[str]


def _pkg_config(args: Sequence[str]) -> Optional[Tuple[str, ...]]:
    if shutil.which("pkg-config") is None:
        return None
    try:
        out = subprocess.run(["pkg-config", *args, "libavcodec",
                              "libavutil"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return tuple(out.stdout.split()) if out.returncode == 0 else None


def _flags(lib_name: str) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(compile flags, link flags) of a library, as the Makefile has
    them; libhevclavc's come from pkg-config."""
    extra = LIBS[lib_name][1]
    if lib_name != "libhevclavc.so":
        return CXXFLAGS + extra, LDFLAGS
    cflags = _pkg_config(["--cflags"]) or ()
    libs = _pkg_config(["--libs"]) or ("-lavcodec", "-lavutil")
    return CXXFLAGS + extra + cflags, LDFLAGS + libs


def library_path(lib_name: str) -> Path:
    """Where `lib_name` lives for its source, headers and flags."""
    cflags, ldflags = _flags(lib_name)
    src = NATIVE_DIR / LIBS[lib_name][0]
    return _build.BUILD_DIR / _build.hashed_name(
        Path(lib_name).stem, _build.include_closure(src),
        (CXX,) + cflags + ldflags)


def build(names: Sequence[str] = tuple(LIBS),
          timeout_s: float = BUILD_TIMEOUT_S) -> Dict[str, Built]:
    """Compile every named library that is missing, one g++ each, all
    started together and each bounded by timeout_s. A failed build is
    reported, not raised."""
    _build.BUILD_DIR.mkdir(exist_ok=True)
    out = {}
    jobs = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            lib = library_path(name)
            if lib.exists():
                out[name] = Built(0.0, None)
                continue
            if shutil.which(CXX) is None:
                out[name] = Built(0.0, f"{CXX} not found")
                continue
            cflags, ldflags = _flags(name)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [CXX, *cflags, str(NATIVE_DIR / LIBS[name][0]), "-o",
                   str(tmp), *ldflags]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, lib)
        for name, (proc, tmp, lib) in jobs.items():
            left = max(1.0, timeout_s - (time.perf_counter() - t0))
            try:
                log, _ = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                out[name] = Built(time.perf_counter() - t0,
                                  f"build exceeded {timeout_s:.0f} s")
                continue
            if proc.returncode != 0:
                out[name] = Built(time.perf_counter() - t0, log)
                continue
            os.replace(tmp, lib)
            out[name] = Built(time.perf_counter() - t0, None)
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return out


def load_or_build(lib_name: str,
                  configure: Callable[[ctypes.CDLL], None]
                  ) -> Optional[ctypes.CDLL]:
    """Load a native library, building it first if it is missing, or None
    when it does not build or load. Cached for the process."""
    with _lock:
        if lib_name in _cache:
            return _cache[lib_name]
        lib: Optional[ctypes.CDLL] = None
        if build((lib_name,))[lib_name].error is None:
            try:
                lib = ctypes.CDLL(str(library_path(lib_name)))
                configure(lib)
            except (OSError, AttributeError):
                lib = None
        _cache[lib_name] = lib
        return lib


def _configure_stitchio(lib: ctypes.CDLL) -> None:
    lib.stitchio_start_server.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_long, ctypes.c_int]
    lib.stitchio_start_server.restype = ctypes.c_int
    lib.stitchio_stats.argtypes = [ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_long)]
    lib.stitchio_stats.restype = ctypes.c_int
    lib.stitchio_pop_frame.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.stitchio_pop_frame.restype = ctypes.c_int
    lib.stitchio_queue_size.argtypes = [ctypes.c_int]
    lib.stitchio_queue_size.restype = ctypes.c_int
    lib.stitchio_clients.restype = ctypes.c_int
    lib.stitchio_port.argtypes = []
    lib.stitchio_port.restype = ctypes.c_int
    lib.stitchio_stop_server.restype = None
    lib.stitchio_nv12_to_rgb.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.stitchio_rgb_to_i420.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]


def load() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) libstitchio, or None."""
    return load_or_build("libstitchio.so", _configure_stitchio)
