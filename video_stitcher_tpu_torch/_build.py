"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` holds a plain C interface (no torch headers), so
one ``nvcc`` call per source takes seconds. The shared library goes into
``_build/`` (git-ignored) under a name that carries a hash of the source,
of every ``csrc`` header it includes and of the flags: it is rebuilt only
when one of them changes, and reused otherwise. All stale sources compile
in parallel, one ``nvcc`` each. Beside each library lies the ptxas report
of its build (``ptxas_report``: registers, shared memory and spills of
each kernel).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("remap_gain", "remap_separable", "blend_levels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "host with the CUDA toolkit (set CUDA_HOME)")


def include_closure(root: Path) -> List[Path]:
    """`root` and every header it includes by a quoted path, at any
    depth."""
    found, todo = [], [root]
    while todo:
        path = todo.pop()
        if path not in found:
            found.append(path)
            todo += [path.parent / inc
                     for inc in _INCLUDE.findall(path.read_text())
                     if (path.parent / inc).is_file()]
    return found


def hashed_name(stem: str, paths: Sequence[Path],
                flags: Sequence[str]) -> str:
    """`stem` and a hash of the files' names and contents and of the
    flags: the name of the library they build."""
    digest = hashlib.sha256()
    for path in paths:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(flags).encode())
    return f"{stem}-{digest.hexdigest()[:16]}.so"


def sources(name: str) -> List[Path]:
    """csrc/<name>.cu and every header it includes."""
    return include_closure(CSRC / f"{name}.cu")


def library_path(name: str) -> Path:
    """Where the shared library of csrc/<name>.cu lives for this source,
    its headers and the flags."""
    return BUILD_DIR / hashed_name(f"lib{name}", sources(name), NVCC_FLAGS)


def ptxas_report(name: str) -> str:
    """The ptxas lines of the build of csrc/<name>.cu's library: each
    kernel's entry, registers, shared memory and spills."""
    log = library_path(name).with_suffix(".ptxas.txt").read_text()
    keep = ("Compiling entry", "registers", "spill")
    return "\n".join(line.strip() for line in log.splitlines()
                     if any(k in line for k in keep))


def build(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing or stale, one
    nvcc per source, all started together. Returns the seconds each build
    took (0.0 for a reused library). Raises if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    seconds = {name: 0.0 for name in names}
    jobs = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            lib = library_path(name)
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, lib)
        for name, (proc, tmp, lib) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            lib.with_suffix(".ptxas.txt").write_text(log)
            os.replace(tmp, lib)
            seconds[name] = time.perf_counter() - t0
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, building it first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
