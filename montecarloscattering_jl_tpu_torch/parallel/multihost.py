"""Multi-process scale-out: torch.distributed over the particle batch.

Counterpart of the JAX package's parallel/multihost.py.  A JAX process
drives every local device of a host; here every rank is a process of its
own (one card each under NCCL; ranks may share a card, or run on the
CPU, under gloo), so this module also starts them:

* ``init_distributed`` joins the process group: with an explicit
  coordinator address, world size and rank over TCP, or with none from
  torchrun's environment (``env://``), the counterpart of
  ``jax.distributed.initialize()``'s auto-detection on pods.
  parallel/shard.make_mesh then builds the mesh of the group.
* ``global_state`` keeps this rank's lanes of the full population that
  every rank built alike from the same seeds: lane keys derive from
  GLOBAL lane indices (ops/state.init_state), so a lane is the same lane
  on any mesh.
* ``spawn`` runs a function on N local ranks, one process each, started
  with ``spawn`` (CUDA cannot fork), and returns their results.  A rank
  that raises, or a run past its time limit, ends every rank and raises
  in the caller; a rank never goes on alone.
"""

from __future__ import annotations

import datetime
import os
import socket
import time

import torch
import torch.distributed as dist

from .shard import Mesh, make_mesh, shard_state

# a rank waits this long in a collective for the others (a rank that
# died must not leave the others waiting for ever)
TIMEOUT = datetime.timedelta(minutes=15)


def default_backend(device) -> str:
    """NCCL between cards, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, device="cuda",
                     timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join the process group (nothing if this process has joined one).

    With ``coordinator_address`` ("host:port", rank 0's), the world size
    and this process's rank are the arguments; without it they come from
    torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    The backend is NCCL for ``cuda`` and gloo for ``cpu`` unless
    `backend` names one."""
    if dist.is_initialized():
        return
    backend = backend or default_backend(device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs the number of "
                             "processes and this process's id")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)


def global_state(state, mesh: Mesh):
    """This rank's lanes of the full population that every rank built
    alike (engine/run.py takes its shard of every population through
    it: the injected one, a resumed one and each host split's)."""
    return shard_state(state, mesh)


def local_ranks(n: int, device="cuda", backend: str | None = None) -> int:
    """The ranks a ``--devices n`` run starts on this host: `n`, or with
    0 every visible card on ``cuda`` (one on the CPU).  More ranks than
    cards is an error under NCCL (one card a rank); gloo's ranks share
    the cards."""
    cuda = torch.device(device).type == "cuda"
    cards = torch.cuda.device_count() if cuda else 0
    if cuda and cards == 0:
        raise RuntimeError("no CUDA device is available")
    n = n or max(cards, 1)
    if cuda and n > cards and (backend or default_backend(device)) == "nccl":
        raise RuntimeError(
            f"{n} ranks but {cards} CUDA card(s) visible: NCCL takes one "
            f"card a rank (ranks that share a card need the gloo backend)")
    return n


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, n, port, backend, device, args, results,
               timeout):
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(n)
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores, or the threads a process is
        # given (OMP_NUM_THREADS), whichever are fewer
        cores = min(os.cpu_count() or 1, torch.get_num_threads())
        torch.set_num_threads(max(1, cores // n))
    init_distributed(f"localhost:{port}", n, rank, backend, device,
                     timeout)
    out = fn(make_mesh(n, device), *args)
    results.put((rank, out))
    # only on success: a rank that raises leaves its group to its exit,
    # after its error is written, so that no peer's failure comes first
    dist.destroy_process_group()


def _rank_errors(ctx) -> list:
    """(rank, traceback) of every rank that raised: what torch's spawn
    wrapper wrote to its error file."""
    import pickle

    out = []
    for r, path in enumerate(ctx.error_files):
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as fh:
                out.append((r, pickle.load(fh)))
    return out


def spawn(fn, n: int, args=(), backend: str | None = None, device="cuda",
          timeout: float | None = None) -> list:
    """``fn(mesh, *args)`` on `n` ranks on this host, each a process
    started with ``spawn`` and joined over TCP on localhost; returns
    their results in rank order.  `fn` and `args` must pickle (`fn` a
    module-level function).  Rank r runs on card r under NCCL (the
    default for ``cuda``); under gloo ranks may share cards.  If a rank
    raises or the ranks outlive `timeout` seconds, every rank is ended
    and the caller gets the error."""
    import torch.multiprocessing as tmp
    from torch.multiprocessing.spawn import ProcessException

    backend = backend or default_backend(device)
    coll = datetime.timedelta(seconds=timeout) if timeout else TIMEOUT
    results = tmp.get_context("spawn").SimpleQueue()
    ctx = tmp.start_processes(
        _rank_main, args=(fn, n, free_port(), backend, str(device), args,
                          results, coll),
        nprocs=n, join=False, start_method="spawn")
    got = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            # read while the ranks run: a rank blocks in put() until its
            # result is read
            while not results.empty():
                rank, out = results.get()
                got[rank] = out
            try:
                if ctx.join(timeout=0.2):
                    break
            except ProcessException as e:
                # every rank that raised (the first one seen may be a
                # rank whose collective lost the failing one)
                raise RuntimeError(
                    f"rank {e.error_index} of {n} failed:\n{e}"
                    + "".join(f"\nrank {r}: {tb}" for r, tb in
                              _rank_errors(ctx) if r != e.error_index)
                    ) from None
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    while not results.empty():
        rank, out = results.get()
        got[rank] = out
    missing = [r for r in range(n) if r not in got]
    if missing:
        raise RuntimeError(f"ranks {missing} of {n} returned nothing")
    return [got[r] for r in range(n)]
