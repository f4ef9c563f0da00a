"""Build the port's CUDA kernels from the package's ``csrc/`` sources.

Every library source ``csrc/<name>.cu`` has a plain C interface and is
compiled by nvcc for sm_90a into its own shared library in the
package's ``build/`` directory (listed in .gitignore), named by a hash of
the sources, the shared headers (``csrc/*.cuh``) and the flags, so a
changed source or header rebuilds and an unchanged one is reused.
Libraries are loaded with ctypes.  Nothing here runs at import: a
kernel is built at its wrapper's first launch, or ahead of time by
``build_all`` (chip_smoke.py builds every library in parallel).

A target is a source's name, or (name, defines, unit): ``defines``
(-D name=value) build a compile-time variant of the source (K5's
f(r_g) build, scripts/probe_k5.py's variants); ``unit`` = (unit name,
flag) links in ``csrc/<unit>.cu`` built with `flag` in place of
-fmad=false, both compiled as relocatable device code and device-linked
(one shell process runs the four nvcc steps).  ``LOGS[log_key(name,
defines)]`` keeps what ``-Xptxas -v`` said of a verbose build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
# -fmad=false: every product rounds once, as in the plain versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")
# the sources built as libraries (the others are units linked into one)
LIBRARIES = ("finish", "helix_step", "mega_step", "psd_hist", "rebin")

LOGS: dict[str, str] = {}

_LIBS: dict[Path, ctypes.CDLL] = {}


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


def log_key(name: str, defines=None) -> str:
    """LOGS's key of a build, and build_all's: the source's name, then
    its -D flags."""
    return " ".join([name, *_flags(defines)[len(NVCC_FLAGS):]])


def _flags(defines) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{k}={v}" for k, v in
                           sorted((defines or {}).items()))]


def _target(name: str, defines=None, unit=None) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for extra in sorted(CSRC.glob("*.cuh")) + (
            [CSRC / f"{unit[0]}.cu"] if unit else []):
        h.update(extra.name.encode() + extra.read_bytes())
    tag = hashlib.sha256(h.digest() + " ".join(
        _flags(defines) + list(unit or ())).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def _command(src: Path, out: str, defines, unit, verbose: bool) -> list:
    """The nvcc command (or the shell line of nvcc steps) that builds
    `src`, with `unit` linked in where given, into the library `out`."""
    flags = _flags(defines)
    ptxas = ["-Xptxas", "-v"] if verbose else []
    if unit is None:
        return [nvcc(), *flags, *ptxas, "-o", out, str(src)]
    dev = [f for f in flags if f != "-shared"]
    objs = [f"{out}.{k}.o" for k in ("main", "unit", "link")]
    steps = [
        [nvcc(), *dev, *ptxas, "-dc", "-o", objs[0], str(src)],
        [nvcc(), *(unit[1] if f == "-fmad=false" else f for f in dev),
         "-dc", "-o", objs[1], str(CSRC / f"{unit[0]}.cu")],
        [nvcc(), *dev, "-dlink", "-o", objs[2], objs[0], objs[1]],
        [nvcc(), *flags, "-o", out, *objs]]
    line = " && ".join(shlex.join(c) for c in steps)
    return ["sh", "-c", f"{line}; rc=$?; rm -f {shlex.join(objs)}; "
                        f"exit $rc"]


def build_all(targets, verbose: bool = False) -> dict[str, Path]:
    """Compile each target not built yet, one process per target, all
    started together; returns {log_key: library path}.  With `verbose`,
    prints what ``-Xptxas -v`` reports."""
    out, procs = {}, {}
    for t in targets:
        name, defines, unit = (t, None, None) if isinstance(t, str) else t
        key = log_key(name, defines)
        src, lib = _target(name, defines, unit)
        out[key] = lib
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = _command(src, tmp, defines, unit, verbose)
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp)
    failed = []
    for key, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{key}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        if verbose:
            LOGS[key] = log
            print(f"[{key}]\n{log}")
        os.replace(tmp, out[key])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str, defines=None, unit=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with `defines` and
    `unit`, built at first use."""
    path = build_all([(name, defines, unit)])[log_key(name, defines)]
    if path not in _LIBS:
        _LIBS[path] = ctypes.CDLL(str(path))
    return _LIBS[path]
