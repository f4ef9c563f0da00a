"""Micro-benchmark of K1 (csrc/mega_step.cu) on a CUDA card: the
flagship window and full drains of one checkout of the port.

Run by path, so that ``--root`` decides which checkout is imported:

    python montecarloscattering_jl_tpu_torch/scripts/probe_k1.py [--root DIR]

``--root`` is the root of a checkout of this repository (default: the
one this file lies in); an older commit unpacked with ``git archive``
serves as the parent in a comparison.  The populations and timers come
from this file's own scripts/workloads.py, loaded by path, and run on
the package of ``--root``.

Measured, each through the wrappers every commit of the port has
(``mega.launch``, ``mega.drain``, ``mega.LAUNCHES``):

* the flagship's 64-step window at 65,536 lanes: mean ms of 10
  ``mega.launch`` calls by CUDA events (validation and one host wait a
  launch included), twice;
* the same population's full drain at the default helix cap through
  ``mega.drain``: wall ms with a final synchronize, K1 launches, pushes
  and pushes/s, three times;
* the science protons of ``flag_population`` drained at the science
  helix cap, three times.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

WINDOW = 64
N_DRAINS = 3


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import montecarloscattering_jl_tpu_torch as pkg
    from montecarloscattering_jl_tpu_torch.ops import mega

    if not os.path.samefile(os.path.dirname(os.path.dirname(pkg.__file__)),
                            root):
        raise RuntimeError(f"the package was imported from {pkg.__file__}, "
                           f"not from {root}")
    spec = importlib.util.spec_from_file_location(
        "workloads", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "workloads.py"))
    wl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wl)

    dev = torch.device("cuda:0")
    out = {"card": wl.card_line(), "root": root}
    print(f"card: {out['card']}; root: {root}")
    flagship = wl.flagship_case(dev)
    science = wl.flag_case(wl.FLAG_CASES[0], dev)
    tabs = flagship["tabs"]

    def window(s, t):
        mega.launch(s, tabs, t, WINDOW, 10_000)

    prep = lambda n: [(wl.clone_state(flagship["st0"]),
                       flagship["fresh_tal"]()) for _ in range(n)]
    out["window_ms"] = [wl.time_launches(window, prep(11)) for _ in range(2)]
    out["drain"] = [wl.timed_drain(flagship, mega.MAX_HELIX_STEPS)
                    for _ in range(N_DRAINS)]
    out["science_drain"] = [wl.timed_drain(science, wl.SCIENCE_CAP)
                            for _ in range(N_DRAINS)]
    print(json.dumps(out))
    return out


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    args = ap.parse_args()
    if "montecarloscattering_jl_tpu_torch" in sys.modules:
        ap.error("run this file by path, not with -m: --root decides which "
                 "checkout is imported")
    import torch
    if not torch.cuda.is_available():
        print("probe_k1: no CUDA device", file=sys.stderr)
        return 1
    measure(os.path.abspath(args.root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
