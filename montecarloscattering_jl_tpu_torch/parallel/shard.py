"""Data parallelism over the particle batch: one process a rank.

Counterpart of the JAX package's parallel/shard.py.  Lanes are
independent between tallies, so the only parallelism the physics admits
is over them: the batch is split into equal contiguous shards, rank r
holds lanes [r * b / W, (r + 1) * b / W) and drains them with its own
engine (K1 or the XLA engine), and the ranks meet only where the JAX
package's mesh programs psum:

* once a species, ``reduce_ion_accumulators`` sums every tally, escape
  and exit-reason accumulator over the ranks.  The accumulators are
  carried across the species' segments, so a sum per segment would add
  the earlier segments W times over (shard.py:144-163);
* on the host-split ladder, ``gather_state`` brings every rank's lanes
  to the host of every rank after a segment, and every rank runs the
  same split on the whole batch;
* on the mesh hybrid ladder, each rank splits its own lanes to its share
  of the target (``shard_target``) and writes the split's small
  counters into a row on its device; only at the ladder's sync points
  and at its end do the rows cross ranks: ``gather_splits`` gathers
  every rank's saved and new lanes, helix steps and saved and new
  weight of several segments in one all_gather, from which each
  segment's global new lanes and steps are summed.

Lane keys come from GLOBAL lane indices (every rank builds the full
population and keeps its shard, parallel/multihost.global_state; the
hybrid's split offsets its keys by r * b / W), so on the host-split
paths every lane is the same bits on any mesh, and the hybrid ladder is
the same statistically.

The JAX package's VMEM workarounds (``_tally_geom``, ``check_oob``, the
tally band, the megakernel block alignment) have no counterpart: K1's
shard needs no block multiple.

Collectives run on CUDA tensors under NCCL and on host copies under gloo
(which serves the CPU and ranks that share a card).  Every collective is
counted in ``Mesh.collectives`` and its wall seconds in
``Mesh.collective_s``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, fields

import numpy as np
import torch
import torch.distributed as dist

from ..ops.state import ParticleState

DP_AXIS = "dp"


@dataclass
class Mesh:
    """A 1-D mesh of `size` ranks, one process each (the default
    process group): this process's rank, the device it runs on and the
    group's backend (None for a world of one)."""

    size: int
    rank: int
    device: torch.device
    backend: str | None = None
    collectives: int = 0
    collective_s: float = 0.0

    def shard(self, n: int) -> slice:
        """This rank's lanes of a batch of `n` (a multiple of `size`)."""
        if n % self.size:
            raise ValueError(f"a batch of {n} lanes does not split into "
                             f"{self.size} equal shards")
        w = n // self.size
        return slice(self.rank * w, (self.rank + 1) * w)

    def summary(self) -> dict:
        return dict(size=self.size, rank=self.rank, device=str(self.device),
                    backend=self.backend, collectives=self.collectives,
                    collective_s=self.collective_s)


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The mesh of this process: the world of the initialized process
    group (parallel/multihost.init_distributed), or a world of one.

    With ``n_devices`` set, a world of another size is an error: a mesh
    silently cut to the ranks that exist would "validate" a multi-rank
    run on fewer ranks (shard.py:37-55).  On ``cuda`` rank r takes the
    card of its local rank (``LOCAL_RANK``, else r modulo the cards) and
    makes it current.  More ranks on a host than cards is an error under
    NCCL, which takes one card a rank; under gloo the ranks share the
    cards, and ``shared_cards`` says so."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() == 0:
        raise RuntimeError(
            f"requested a mesh on {dev} but no CUDA device is visible")
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = str(dist.get_backend())
    else:
        world, rank, backend = 1, 0, None
    if n_devices is not None and n_devices != world:
        how = (f"a process group of {world} ranks" if backend else
               "no process group (launch the ranks with "
               "parallel.multihost.spawn, the CLI's --devices N or "
               "torchrun, or join one with init_distributed)")
        raise RuntimeError(f"requested a {n_devices}-rank mesh but this "
                           f"process has {how}")
    if dev.type == "cuda" and backend is not None:
        n_cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", rank % n_cards))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        if backend == "nccl" and max(local, local_world - 1) >= n_cards:
            raise RuntimeError(
                f"{max(local + 1, local_world)} ranks on this host but "
                f"{n_cards} CUDA card(s) visible: NCCL takes one card a "
                f"rank; join ranks that share a card with the gloo backend")
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    return Mesh(size=world, rank=rank, device=dev, backend=backend)


def shared_cards(mesh: Mesh) -> bool:
    """Whether this host runs more ranks than it has cards."""
    if mesh.device.type != "cuda" or mesh.size == 1:
        return False
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", mesh.size))
    return local_world > torch.cuda.device_count()


def pad_to_devices(n: int, n_devices: int, multiple: int = 128) -> int:
    """Batch size divisible by both the lane multiple and the mesh."""
    m = multiple * n_devices
    return ((n + m - 1) // m) * m


def shard_target(n_target: int, size: int, rank: int) -> int:
    """Rank `rank`'s share of a split target: the remainder spread over
    the low ranks, so the shares sum to `n_target` (shard.py:245-247)."""
    return n_target // size + (rank < n_target % size)


def shard_state(state: ParticleState, mesh: Mesh) -> ParticleState:
    """This rank's lanes of a full-batch state, as tensors of its own."""
    sl = mesh.shard(state.weight.shape[0])
    return ParticleState(**{f.name: getattr(state, f.name)[sl].clone()
                            for f in fields(state)})


def _timed(mesh: Mesh, op, t: torch.Tensor) -> None:
    t0 = time.perf_counter()
    op()
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    mesh.collective_s += time.perf_counter() - t0
    mesh.collectives += 1


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """`t` where the backend can carry it: gloo takes host tensors."""
    return t.cpu() if mesh.backend == "gloo" else t


def all_reduce_sum(mesh: Mesh, tensors) -> None:
    """Sum each tensor over the ranks, in place: one all_reduce a
    tensor.  Every rank ends with the same bits."""
    if mesh.size == 1:
        return
    for t in tensors:
        x = _wire(mesh, t)
        _timed(mesh, lambda: dist.all_reduce(x), x)
        if x is not t:
            t.copy_(x)


def barrier(mesh: Mesh) -> None:
    if mesh.size == 1:
        return
    kw = ({"device_ids": [mesh.device.index]} if mesh.backend == "nccl"
          else {})
    t0 = time.perf_counter()
    dist.barrier(**kw)
    mesh.collective_s += time.perf_counter() - t0
    mesh.collectives += 1


SPLIT_FIELDS = ("n_saved", "target", "n_new", "nsteps", "w_saved",
                "w_new")


def gather_splits(mesh: Mesh, rows: torch.Tensor) -> dict:
    """The mesh hybrid's splits of k segments, every rank's: this rank's
    rows ``rows`` ([k, len(SPLIT_FIELDS)] float64 on its device: saved
    lanes, its share of the target, new lanes, helix steps, and the
    saved and new lanes' weight, the counts exact below 2^53) gathered
    over the ranks in one all_gather; {field: [k, world] array}, the
    counts as int64."""
    x = _wire(mesh, rows.contiguous())
    parts = [x]
    if mesh.size > 1:
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        _timed(mesh, lambda: dist.all_gather(parts, x), x)
    got = torch.stack(parts, dim=1).cpu().numpy()
    return {k: (got[:, :, i] if k.startswith("w_")
                else got[:, :, i].astype(np.int64))
            for i, k in enumerate(SPLIT_FIELDS)}


def gather_state(state: ParticleState, mesh: Mesh) -> ParticleState:
    """Every rank's lanes in rank order, as one full-batch state on the
    host of every rank: one all_gather of each rank's fields packed into
    bytes."""
    cols = [getattr(state, f.name).contiguous() for f in fields(state)]
    if mesh.size == 1:
        return ParticleState(*[c.cpu() for c in cols])
    flat = _wire(mesh, torch.cat([c.view(torch.uint8) for c in cols]))
    parts = [torch.empty_like(flat) for _ in range(mesh.size)]
    _timed(mesh, lambda: dist.all_gather(parts, flat),
           flat)
    parts = [p.cpu() for p in parts]
    out, off = [], 0
    for c in cols:
        nbytes = c.numel() * c.element_size()
        out.append(torch.cat([p[off:off + nbytes] for p in parts])
                   .view(c.dtype))
        off += nbytes
    return ParticleState(*out)


def _tensors(obj) -> list:
    return [getattr(obj, f.name) for f in fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)]


def reduce_ion_accumulators(mesh: Mesh, tal, esc, reasons) -> None:
    """Sum a species' per-rank accumulators over the ranks, in place:
    one all_reduce of every field of the tallies (stt.Tallies), the
    escape tallies (EscapeTallies) and the exit-reason counts.  Call
    once a species, after its last segment."""
    all_reduce_sum(mesh, _tensors(tal) + _tensors(esc) + [reasons])
