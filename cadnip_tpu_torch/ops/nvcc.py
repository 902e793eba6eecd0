"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each kernel source `csrc/<name>.cu` is compiled for sm_90a into a shared
library with a plain C interface, under `build/cadnip_tpu_torch/` of the
checkout, named by a hash of the source, every header in `csrc/` and the
flags: an edit to any of them builds anew, an unchanged tree reuses the
library. `build(names)` starts one nvcc per missing library, all at once,
and waits for them together; `load(name)` builds if needed and returns the
`ctypes.CDLL`. K2 has one library more for each set of Verilog-A models
that a circuit brings: built with their generated header (`header=`,
va/cuda.py) and keyed by its text as well.
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

#: the generated header of a Verilog-A library (included by devices.cuh)
VA_HEADER = "va_models.cuh"

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


def library_path(name: str, header: str = None) -> Path:
    """Where the library of csrc/<name>.cu for the current sources lives;
    with `header`, the text of a generated `va_models.cuh` (va/cuda.py),
    the library built with it, keyed by its text too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    if header is not None:
        h.update(VA_HEADER.encode())
        h.update(header.encode())
        name += "_va"
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(names, header: str = None) -> None:
    """Compile every named source whose library is missing, in parallel;
    raises with nvcc's messages if any build fails. With `header`, each
    is built with it as `va_models.cuh` (in a directory of its own beside
    the library) under the define CADNIP_VA_MODELS."""
    jobs = []
    for name in names:
        so = library_path(name, header)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        extra = []
        if header is not None:
            inc = so.with_suffix(".include")
            inc.mkdir(exist_ok=True)
            fd, tmp_h = tempfile.mkstemp(suffix=".cuh", dir=inc)
            with os.fdopen(fd, "w") as fh:
                fh.write(header)
            os.replace(tmp_h, inc / VA_HEADER)
            extra = ["-I", str(inc), "-DCADNIP_VA_MODELS"]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        src = CSRC / f"{name}.cu"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), *extra, "-o", tmp,
             str(src)],
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


def load(name: str, header: str = None) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (with `header`: built with
    it), built first if missing."""
    so = library_path(name, header)
    if so not in _loaded:
        build([name], header)
        _loaded[so] = ctypes.CDLL(str(so))
    return _loaded[so]
