"""Build the port's CUDA kernels from the package's ``csrc/`` sources.

Every ``csrc/<name>.cu`` has a plain C interface and is compiled by
nvcc for sm_90a into its own shared library in the package's ``build/``
directory (listed in .gitignore), named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so a changed source or
header rebuilds and an unchanged one is reused.
Libraries are loaded with ctypes.  Nothing here runs at import: a
kernel is built at its wrapper's first launch, or ahead of time by
``build_all`` (chip_smoke.py builds every source in parallel).
``LOGS[name]`` keeps what ``-Xptxas -v`` said of a verbose build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
# -fmad=false: every product rounds once, as in the plain versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

LOGS: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       f"{CSRC} with the CUDA toolkit")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    tag = hashlib.sha256(h.digest()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def build_all(names, verbose: bool = False) -> dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` not built yet, one nvcc process
    per source, all started together; returns {name: library path}.
    With `verbose`, prints what ``-Xptxas -v`` reports."""
    out, procs = {}, {}
    for name in names:
        src, lib = _target(name)
        out[name] = lib
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        if verbose:
            LOGS[name] = log
            print(f"[{name}]\n{log}")
        os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]))
    return _LIBS[name]
