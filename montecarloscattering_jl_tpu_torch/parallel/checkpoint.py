"""Checkpoint / resume of a run's nonlinear state.

Counterpart of the JAX package's parallel/checkpoint.py.  Two
granularities:

* **Iteration-boundary** (save_checkpoint / load_checkpoint): the
  fixed-point state (profile, adiabatic-index grid, q_esc and escape
  histories, iteration index, base seed) in one compressed NPZ with the
  JAX package's exact keys and dtypes, so a checkpoint written by either
  package loads in the other.

* **Segment-boundary** (save_mid_checkpoint, MidCheckpointer): what an
  in-flight species needs (the split population with its per-lane keys
  and step counts, the pcut segment index, the species' tallies, the
  iteration tallies and the completed species' reductions), so a run
  whose long pole is one species' pcut ladder can resume inside it.
  The JAX package pickles this payload; here it is an NPZ: every array
  and tensor (fetched to NumPy) is one key, and one JSON manifest key
  describes the nesting.  Files are read with ``allow_pickle=False``.
  The two packages' lane states have different layouts, so neither
  package resumes the other's mid checkpoint.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import time

import numpy as np
import torch

from ..models.profile import ShockProfile
from .shard import barrier

MANIFEST = "__manifest__"
_PACKAGE = __name__.split(".")[0]


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def save_checkpoint(path: str, *, i_iter: int, profile: ShockProfile,
                    gamma_grid: np.ndarray, q_px_hist: np.ndarray,
                    q_en_hist: np.ndarray, px_esc_hist: np.ndarray,
                    en_esc_hist: np.ndarray, gamma_dw_hist: np.ndarray,
                    prof_weight_fac: float, random_seed: int,
                    meta: dict | None = None) -> None:
    """Write the iteration-boundary state; ``.npz`` is appended to a
    name that lacks it (np.savez_compressed)."""
    np.savez_compressed(
        path,
        i_iter=np.asarray(i_iter),
        ux_sk=profile.ux_sk, uz_sk=profile.uz_sk, utot=profile.utot,
        gamma_sf=profile.gamma_sf, beta_ef=profile.beta_ef,
        gamma_ef=profile.gamma_ef, btot=profile.btot,
        theta=profile.theta, eps_b=profile.eps_b,
        bmag2=np.asarray(profile.bmag2),
        gamma_grid=gamma_grid,
        q_px_hist=q_px_hist, q_en_hist=q_en_hist,
        px_esc_hist=px_esc_hist, en_esc_hist=en_esc_hist,
        gamma_dw_hist=gamma_dw_hist,
        prof_weight_fac=np.asarray(prof_weight_fac),
        random_seed=np.asarray(random_seed),
        meta=_json_bytes(meta or {}),
    )


def load_checkpoint(path: str) -> dict:
    """Load an iteration-boundary checkpoint; returns a dict with a
    reconstructed ShockProfile under 'profile'."""
    with np.load(path, allow_pickle=False) as z:
        prof = ShockProfile(
            ux_sk=z["ux_sk"], uz_sk=z["uz_sk"], utot=z["utot"],
            gamma_sf=z["gamma_sf"], beta_ef=z["beta_ef"],
            gamma_ef=z["gamma_ef"], btot=z["btot"], theta=z["theta"],
            eps_b=z["eps_b"], bmag2=float(z["bmag2"]))
        return {
            "i_iter": int(z["i_iter"]), "profile": prof,
            "gamma_grid": z["gamma_grid"],
            "q_px_hist": z["q_px_hist"], "q_en_hist": z["q_en_hist"],
            "px_esc_hist": z["px_esc_hist"],
            "en_esc_hist": z["en_esc_hist"],
            "gamma_dw_hist": z["gamma_dw_hist"],
            "prof_weight_fac": float(z["prof_weight_fac"]),
            "random_seed": int(z["random_seed"]),
            "meta": json.loads(bytes(z["meta"]).decode() or "{}"),
        }


# ---- segment-boundary checkpoints -----------------------------------------


def _flatten(obj, arrays: dict):
    """The manifest node of `obj`; its arrays go into `arrays` under
    keys a0, a1, ...  Containers: dict (string keys), list, tuple and
    the package's dataclasses; leaves: torch tensors, NumPy arrays and
    scalars, and JSON scalars."""
    if isinstance(obj, torch.Tensor):
        key = f"a{len(arrays)}"
        arrays[key] = obj.detach().cpu().numpy()
        return {"t": "torch", "k": key}
    if isinstance(obj, np.ndarray):
        key = f"a{len(arrays)}"
        arrays[key] = obj
        return {"t": "nd", "k": key}
    if isinstance(obj, np.generic):
        key = f"a{len(arrays)}"
        arrays[key] = np.asarray(obj)
        return {"t": "np", "k": key}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "py", "v": obj}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("mid checkpoint dict keys must be strings")
        return {"t": "dict", "v": {k: _flatten(v, arrays)
                                   for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"t": type(obj).__name__,
                "v": [_flatten(v, arrays) for v in obj]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        if not cls.__module__.startswith(_PACKAGE + "."):
            raise TypeError(f"mid checkpoint cannot hold {cls!r}")
        return {"t": "dc", "cls": f"{cls.__module__}:{cls.__qualname__}",
                "v": {f.name: _flatten(getattr(obj, f.name), arrays)
                      for f in dataclasses.fields(obj)}}
    raise TypeError(f"mid checkpoint cannot hold {type(obj)!r}")


def _unflatten(node, z, device):
    t = node["t"]
    if t == "py":
        return node["v"]
    if t == "torch":
        return torch.from_numpy(np.array(z[node["k"]])).to(device)
    if t == "nd":
        return np.array(z[node["k"]])
    if t == "np":
        return z[node["k"]][()]
    if t == "dict":
        return {k: _unflatten(v, z, device) for k, v in node["v"].items()}
    if t in ("list", "tuple"):
        vals = [_unflatten(v, z, device) for v in node["v"]]
        return vals if t == "list" else tuple(vals)
    if t == "dc":
        mod, name = node["cls"].split(":")
        if not mod.startswith(_PACKAGE + "."):
            raise ValueError(f"mid checkpoint names a foreign class {mod}")
        cls = getattr(importlib.import_module(mod), name)
        if not dataclasses.is_dataclass(cls):
            raise ValueError(f"mid checkpoint class {name} is no dataclass")
        return cls(**{k: _unflatten(v, z, device)
                      for k, v in node["v"].items()})
    raise ValueError(f"mid checkpoint manifest node of unknown type {t!r}")


def save_mid_checkpoint(path: str, payload: dict) -> None:
    """Persist a segment-boundary payload (see MidCheckpointer).  Device
    tensors are fetched.  The file is written to ``path + '.tmp'``
    through an open handle (np.savez given a name would append .npz)
    and then renamed, so a kill during the save leaves the previous
    checkpoint intact."""
    arrays = {}
    manifest = _flatten(payload, arrays)
    arrays[MANIFEST] = _json_bytes(manifest)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _is_jax_pickle(head: bytes) -> bool:
    return head[:1] == b"\x80"


def load_mid_checkpoint(path: str, device="cpu") -> dict:
    """Read a segment-boundary payload; its tensors come back on
    `device`.  A pickle written by the JAX package's mid checkpointer is
    refused."""
    with open(path, "rb") as f:
        head = f.read(2)
    if _is_jax_pickle(head):
        raise ValueError(
            f"{path} is a mid checkpoint of the JAX package (a pickle): "
            "its lane state has another layout and its modes 'host' and "
            "'hybrid' have no counterpart in this package; resume from "
            "an iteration checkpoint (NPZ) instead")
    with np.load(path, allow_pickle=False) as z:
        if MANIFEST not in z.files:
            raise ValueError(f"{path} is not a mid checkpoint")
        manifest = json.loads(bytes(z[MANIFEST]).decode())
        return _unflatten(manifest, z, torch.device(device))


def is_mid_checkpoint(path: str) -> bool:
    """Mid checkpoints carry the manifest key; iteration checkpoints are
    NPZ files without it.  A JAX mid checkpoint (a pickle) counts as
    mid, so that loading it gives load_mid_checkpoint's refusal."""
    with open(path, "rb") as f:
        head = f.read(2)
    if _is_jax_pickle(head):
        return True
    if head != b"PK":
        return False
    with np.load(path, allow_pickle=False) as z:
        return MANIFEST in z.files


class MidCheckpointStop(Exception):
    """Raised by MidCheckpointer(stop_after_save=True) right after a
    save: the kill-and-resume test hook."""


class MidCheckpointer:
    """Segment-cadence mid-iteration checkpoint writer.

    The engine calls ``maybe(segments_done, payload_fn)`` at every
    segment boundary; the payload (a device fetch) is only built when
    the cadence hits.  ``context_fn`` is installed by the driver before
    each species and supplies the driver-level half of the payload
    (profile, histories, completed species' IonFinals).  ``seconds``
    sums the time spent saving.  Under a `mesh` (parallel/shard.Mesh)
    every rank builds the payload, whose sums are collectives, and rank
    0 alone writes it while the others wait."""

    def __init__(self, path: str, every: int = 8,
                 stop_after_save: bool = False, mesh=None):
        self.path = path
        self.every = max(int(every), 1)
        self.stop_after_save = stop_after_save
        self.mesh = mesh
        self.context_fn = None
        self.n_saved = 0
        self.seconds = 0.0
        self._bucket = 0

    def reset(self, seg_done: int = 0) -> None:
        """Start a new species ladder (optionally resumed at
        ``seg_done`` segments already complete)."""
        self._bucket = seg_done // self.every

    def due(self, seg_done: int) -> bool:
        """``maybe(seg_done, ...)`` would save (the engine's fused ladder
        makes such a segment a sync point)."""
        return seg_done // self.every > self._bucket

    def maybe(self, seg_done: int, payload_fn) -> None:
        """Save when ``seg_done`` first reaches or passes a cadence
        multiple (bucket advance, so unaligned capture points fire)."""
        if not self.due(seg_done):
            return
        self._bucket = seg_done // self.every
        t0 = time.perf_counter()
        payload = dict(payload_fn())
        if self.context_fn is not None:
            payload["driver"] = self.context_fn()
        if self.mesh is None or self.mesh.rank == 0:
            save_mid_checkpoint(self.path, payload)
        if self.mesh is not None:
            barrier(self.mesh)
        self.seconds += time.perf_counter() - t0
        self.n_saved += 1
        if self.stop_after_save:
            raise MidCheckpointStop(self.path)
