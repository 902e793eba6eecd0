"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each kernel source `csrc/<name>.cu` is compiled for sm_90a into a shared
library with a plain C interface, under `build/cadnip_tpu_torch/` of the
checkout, named by a hash of the source, every header in `csrc/` and the
flags: an edit to any of them builds anew, an unchanged tree reuses the
library. `build(names)` starts one nvcc per missing library, all at once,
and waits for them together; `load(name)` builds if needed and returns the
`ctypes.CDLL`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cadnip_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built; set CUDA_HOME")
    return found


def library_path(name: str) -> Path:
    """Where the library of csrc/<name>.cu for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile every named source whose library is missing, in parallel;
    raises with nvcc's messages if any build fails."""
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        src = CSRC / f"{name}.cu"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, so, tmp, proc))
    errors = []
    for name, so, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed to build {name}.cu:\n{err}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if missing."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
