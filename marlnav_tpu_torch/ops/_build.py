"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each library is compiled on first use with ``nvcc`` for Hopper
(``sm_90a``) into a plain-C-interface ``.so`` under
``marlnav_tpu_torch/ops/build/`` (listed in ``.gitignore``), named by a
hash of its sources and flags so an edited source is rebuilt.  Nothing
here runs at import: this module imports on machines with no CUDA.

``-fmad=false`` keeps every multiply and add separately rounded, as
PyTorch's elementwise operations are, so a kernel agrees with its plain
PyTorch version operation for operation (see ops/csrc/step_math.cuh).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

# name -> (loaded library, build record); one build per process.
_LOADED: Dict[str, Tuple[ctypes.CDLL, dict]] = {}


def find_nvcc() -> str:
    """The ``nvcc`` on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels are built from source on first use")


def _library_path(name: str) -> str:
    sources = sorted(f for f in os.listdir(CSRC)
                     if f.endswith((".cu", ".cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(f.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def load_libraries(names) -> Dict[str, Tuple[ctypes.CDLL, dict]]:
    """Build (where needed) and load ``csrc/<name>.cu`` for each name, one
    ``nvcc`` per source, all started together.  Returns, per name, the
    library and a record ``{"path", "seconds", "log"}``: the build time (0
    when an up-to-date library was found) and the compiler's output, which
    includes ``ptxas -v``'s register and spill report.
    ``load_libraries.nvcc_runs`` counts the ``nvcc`` processes started."""
    builds = {}
    for name in names:
        if name in _LOADED or name in builds:
            continue
        path = _library_path(name)
        record = {"path": path, "seconds": 0.0, "log": ""}
        proc = None
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            proc = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    cmd, tmp, time.perf_counter())
            load_libraries.nvcc_runs += 1
        builds[name] = (record, proc)
    for record, proc in builds.values():  # wait for every build first
        if proc is not None:
            record["log"] = proc[0].communicate()[0]
            record["seconds"] = time.perf_counter() - proc[3]
    for name, (record, proc) in builds.items():
        if proc is not None:
            popen, cmd, tmp, _ = proc
            if popen.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                                   f"{record['log']}")
            # atomic: a concurrent build loses nothing
            os.replace(tmp, record["path"])
        _LOADED[name] = (ctypes.CDLL(record["path"]), record)
    return {name: _LOADED[name] for name in names}


load_libraries.nvcc_runs = 0


def load_library(name: str) -> Tuple[ctypes.CDLL, dict]:
    """``load_libraries([name])[name]``."""
    return load_libraries([name])[name]
