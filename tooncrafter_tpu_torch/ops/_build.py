"""Build the port's CUDA C++ kernels at first use and load them with ctypes.

Each library is compiled from ``tooncrafter_tpu_torch/csrc/`` by ``nvcc``
for ``sm_90a`` into ``build/kernels/`` at the root of the checkout, named by
a hash of its sources and of the shared headers (``csrc/*.cuh``), so an
edited source or header rebuilds and an unchanged one loads at once. The
sources have a plain C interface (no PyTorch headers), which keeps a build
to seconds. ``build`` starts one ``nvcc`` per library, all at once. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LOADED: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    path = shutil.which("nvcc")
    if path is None:
        raise FileNotFoundError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH); "
            "the port's CUDA kernels are built from source at first use")
    return path


def lib_path(name: str, sources: Sequence[str], csrc: Path = CSRC,
             build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256()
    for p in [csrc / s for s in sources] + sorted(csrc.glob("*.cuh")):
        digest.update(p.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return build_dir / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(libs: Mapping[str, Sequence[str]], csrc: Path = CSRC,
          build_dir: Path = BUILD_DIR) -> Dict[str, Path]:
    """Compile every library of ``libs`` (name -> sources) that is not built
    yet, one nvcc each, all started together; raise if any fails. The
    ptxas report (registers, spills) lands beside each library as .log."""
    out, procs = {}, {}
    for name, sources in libs.items():
        path = lib_path(name, sources, csrc, build_dir)
        out[name] = path
        if path.exists():
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               *(str(csrc / s) for s in sources)]
        procs[name] = (cmd, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (cmd, tmp, t0, proc) in procs.items():
        stdout, stderr = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        log = out[name].with_suffix(".log")
        log.write_text(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {name} (see {log}):\n"
                          + stderr[-4000:])
        else:
            os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load_library(name: str, sources: Sequence[str],
                 csrc: Optional[Path] = None) -> ctypes.CDLL:
    """Compile (once per source content) and load ``lib<name>``. With
    ``csrc`` (another source directory) the library is built beside those
    sources and not cached under ``name``."""
    if csrc is not None:
        path = build({name: sources}, csrc, csrc / "build")[name]
        return ctypes.CDLL(str(path))
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build({name: sources})[name]))
    return _LOADED[name]
