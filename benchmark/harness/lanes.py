"""The transport, drain by drain: one pcut segment of each run, drawn
from the seed, pushed again whole by the plain step
(harness/plain_steps.py) from the state the program handed its kernel,
and compared lane by lane and tally by tally with what the kernel left;
one split of the run, drawn alike, made again by a plain split; and the
pushes and exits of every drain, counted from the lanes.

``Capture`` wraps the entries that the port's pcut ladder calls, for the
life of the process: the two drains, ``ops.step.run_segment`` (K5 on a
card) and ``ops.mega.drain`` (K1), and the split,
``engine.run.split_on_device``.  Around every drain it counts, on the
device and with no host wait, the drain's pushes (the lanes' steps) and
its exits by reason.  ``Capture.KEEP`` drains and splits of each run
are kept as they come (reservoir sampling from the seed and the run's
index, so every drain and every split of the run is as likely): for a
kept drain it copies every lane of the batch and the species' tallies
before and after, and the segment's tables; for a kept split its state
in and out.  The check judges the first kept drain with an ACTIVE lane
and the first kept split with a SAVED one, in an order drawn from the
seed.

``repush`` steps every lane of the drawn drain to its end, as many steps
as it takes (the helix cap ends a lane, as in the kernels), depositing
the plain step's tallies: on a card a block of ``BLOCK`` steps is
captured once as a CUDA graph and replayed.  ``drain_readings`` gives
the share of the lanes that were ACTIVE at the drain's start whose end
state differs (another status, reason, step count, tcut slot or flags,
or a momentum, position, acceleration time, return plane or phase off by
more than ``TOL`` of its scale), and the gaps of the drain's deposits:
the PSD and each flux channel finalized over the grid's boundaries, as
the share of their sum (L1), and the escape sums and retro entries each
over its own size.
"""

from __future__ import annotations

import math
import random
import types

import torch

from . import plain_steps as ps

BLOCK = 16          # steps a captured block of the plain step
CHECK_EVERY = 8     # replays between two looks for an ACTIVE lane
TOL = {torch.float64: 1.0e-12, torch.float32: 1.0e-4}
EXACT = ("status", "reason", "nsteps", "tcut", "flags")
CLOSE = ("pb", "pperp", "x", "acctime", "prp_x", "phi")
TALLIES = ("psd_diff", "flux_diff", "esc", "counts")
C_RETRO = 0         # the retro entries' slot of the program's counts
N_REASONS = 8


def freeze(tb):
    """The segment's tables as they stand: the ladder may load the next
    segment's values into the same tensors."""
    out = {}
    for n, v in vars(tb).items():
        if torch.is_tensor(v):
            v = v.clone()
        elif isinstance(v, dict):
            v = {a: b.clone() if torch.is_tensor(b) else b
                 for a, b in v.items()}
        out[n] = v
    return types.SimpleNamespace(**out)


class Capture:
    """`KEEP` drains and `KEEP` splits of each run are kept, drawn by
    reservoir sampling; the check takes the first of them, in an order
    drawn from the seed, that has lanes to judge (a drain with an ACTIVE
    lane, a split with a SAVED one).  Their lanes and tallies are
    copied to pinned host memory behind the drain in the stream, so the
    device holds nothing more for the check."""

    KEEP = 4

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._undo = []
        self._bufs = {}
        self.start_run(-1)

    def start_run(self, k: int) -> None:
        """Forget the last run's draws and counts; `k` is the run's
        index in the window (-1 for the warm-up)."""
        self.rng = random.Random(f"{self.seed}/{k}")
        self.n_drains = self.n_splits = 0
        self.drains, self.splits = {}, {}
        self.pushes, self.exits = [], []

    def _slot(self, n: int):
        """Reservoir sampling of `KEEP` from a stream: the slot the n-th
        item takes, or None."""
        if n <= self.KEEP:
            return n - 1
        j = self.rng.randrange(n)
        return j if j < self.KEEP else None

    def _copy(self, key, t):
        """`t` as it stands at this point of the stream, on the host."""
        if t.device.type != "cuda":
            return t.clone()
        buf = self._bufs.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._bufs[key] = torch.empty(t.shape, dtype=t.dtype,
                                                pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf

    def _state(self, key, st) -> dict:
        return {f: self._copy(key + (f,), getattr(st, f)) for f in ps.FIELDS}

    def _tallies(self, key, tl) -> dict:
        return {n: self._copy(key + (n,), getattr(tl, n)) for n in TALLIES}

    def _drain(self, kind, fn, st, tb, tl, *a, **kw):
        self.n_drains += 1
        slot = self._slot(self.n_drains)
        if slot is not None:
            key = ("drain", slot)
            d = dict(kind=kind, tb=freeze(tb), device=st.weight.device,
                     before=self._state(key + ("before",), st),
                     tl0=self._tallies(key + ("tl0",), tl))
        s0 = st.nsteps.sum(dtype=torch.int64)
        out = fn(st, tb, tl, *a, **kw)
        self.pushes.append(st.nsteps.sum(dtype=torch.int64) - s0)
        why = torch.where(st.status == ps.FINISHED, st.reason, 0).long()
        self.exits.append(torch.zeros(N_REASONS, dtype=torch.int64,
                                      device=why.device).index_add_(
            0, why, torch.ones_like(why)))
        if slot is not None:
            d.update(after=self._state(key + ("after",), st),
                     tl1=self._tallies(key + ("tl1",), tl))
            self.drains[slot] = d
        return out

    def _split(self, fn, state, n_target, key, *a, **kw):
        self.n_splits += 1
        slot = self._slot(self.n_splits)
        if slot is not None:
            before = self._state(("split", slot, "before"), state)
        new, n_new = fn(state, n_target, key, *a, **kw)
        if slot is not None:
            offset = kw.get("lane_offset", a[0] if a else 0)
            self.splits[slot] = dict(
                before=before, n_target=int(n_target),
                key=(int(key[0]), int(key[1])), offset=int(offset),
                device=state.weight.device,
                after=self._state(("split", slot, "after"), new),
                n_new=self._copy(("split", slot, "n_new"), n_new))
        return new, n_new

    def _pick(self, kept: dict, live, salt: int):
        order = sorted(kept)
        random.Random(f"{self.seed}/{salt}").shuffle(order)
        for j in order:
            if bool(live(kept[j])):
                return kept[j]
        return None

    @property
    def drain(self):
        """The drawn drain: its kind, tables, device, lanes before and
        after, tallies before and after; None where no kept drain had an
        ACTIVE lane."""
        return self._pick(self.drains, lambda d: (
            d["before"]["status"] == ps.ACTIVE).any(), 1)

    @property
    def split(self):
        """The drawn split (state in and out, target, key, lane offset,
        new lanes); None where no kept split had a SAVED lane."""
        return self._pick(self.splits, lambda s: (
            s["before"]["status"] == ps.SAVED).any(), 2)

    def install(self) -> None:
        import importlib

        from montecarloscattering_jl_tpu_torch.ops import mega
        from montecarloscattering_jl_tpu_torch.ops import step

        # the module: the package's `engine.run` is the driver's entry
        erun = importlib.import_module(
            "montecarloscattering_jl_tpu_torch.engine.run")
        seg, drain, split = step.run_segment, mega.drain, \
            erun.split_on_device

        def run_segment(st, tl, tb, *a, **kw):
            return self._drain(
                "helix", lambda s, b, t, *x, **y: seg(s, t, b, *x, **y),
                st, tb, tl, *a, **kw)

        def mega_drain(st, tb, tl, *a, **kw):
            return self._drain("mega", drain, st, tb, tl, *a, **kw)

        def split_on_device(state, n_target, key, *a, **kw):
            return self._split(split, state, n_target, key, *a, **kw)

        step.run_segment, mega.drain = run_segment, mega_drain
        erun.split_on_device = split_on_device
        self._undo = [(step, "run_segment", seg), (mega, "drain", drain),
                      (erun, "split_on_device", split)]

    def remove(self) -> None:
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        self._undo = []


# ---------------------------------------------------------------------------
# the drawn drain
# ---------------------------------------------------------------------------

def _low(tb, kind: str, dtype):
    """The segment's tables with the momentum-precision parts in
    `dtype` (the control)."""
    view = types.SimpleNamespace(**vars(tb))
    if kind == "mega":
        view.sf, view.zf, view.et = (tb.sf.to(dtype), tb.zf.to(dtype),
                                     tb.et.to(dtype))
        return view
    pdt = tb.ux.dtype
    for f in ("ux", "gamma_sf", "gamma_ef", "btot", "eps_target"):
        setattr(view, f, getattr(tb, f).to(dtype))
    view.k = {n: (v.to(dtype) if v.dtype == pdt else v)
              for n, v in tb.k.items()}
    return view


def _nb(kind: str, tb) -> int:
    return tb.ss.nb if kind == "helix" else tb.nb


def repush(d: dict, max_helix: int, dtype=None) -> tuple:
    """(end state, float64 tallies) of every lane of the drawn drain `d`
    pushed by the plain step from the state it entered with, until none
    is ACTIVE; with `dtype` the momenta and the momentum-precision
    tables in that dtype (the control)."""
    kind, tb, dev = d["kind"], d["tb"], d["device"]
    st = {f: v.to(dev, copy=True) for f, v in d["before"].items()}
    if dtype is not None:
        tb = _low(tb, kind, dtype)
        for f in ("pb", "pperp", "phi", "ux_prev", "xn_per", "t_step"):
            st[f] = st[f].to(dtype)
    if kind == "mega":
        tb = types.SimpleNamespace(**vars(tb))
        tb.reflect = (float(tb.sf[ps.SF_INJ_FRAC]) < 1.0
                      or bool(tb.flags & ps.FLAG_DONT_DSA))
    tl = ps.tallies(d["tl0"]["psd_diff"].shape[0], _nb(kind, tb), dev)

    def block():
        cur = dict(st)
        if kind == "helix":
            ps.helix_block(cur, tb, tb.k, BLOCK, max_helix, tl)
        else:
            ps.mega_block(cur, tb, BLOCK, max_helix, tl)
        for f, v in cur.items():
            if v is not st[f]:
                st[f].copy_(v)

    step = block
    if dev.type == "cuda":
        block()                 # eagerly once: real steps, and warm-up
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            block()
        step = graph.replay
    for i in range(max_helix // BLOCK + 2):
        if i % CHECK_EVERY == 0 and not bool(
                (st["status"] == ps.ACTIVE).any()):
            break
        step()
    return st, tl


def gaps(got: dict, want: dict) -> dict:
    """{field: [n] gap} of two sets of lanes' end states: 0 or 1 for the
    fields that must agree exactly (a lane that has ended may differ in
    its FL_JRET bit alone), and for the others the difference
    over the quantity's own scale: momenta over the lane's |p|, the
    position and the return plane over the larger of the two, the phase
    as a share of a turn (around the circle), the acceleration time over
    itself."""
    out = {f: (got[f].to(torch.int64)
               != want[f].to(torch.int64)).to(torch.float64)
           for f in EXACT}
    # a lane's FL_JRET bit after it has ended: K5's drain leaves it, and
    # every no-op step of a block clears it; the split drops it
    ended = want["status"] != ps.ACTIVE
    jret = ((got["flags"].to(torch.int64) ^ want["flags"].to(torch.int64))
            == ps.FL_JRET)
    out["flags"] = torch.where(ended & jret, 0.0, out["flags"])
    g = {f: got[f].to(torch.float64) for f in CLOSE}
    w = {f: want[f].to(torch.float64) for f in CLOSE}
    p = torch.clamp(torch.hypot(w["pb"], w["pperp"]), min=1e-300)
    xs = torch.clamp(torch.maximum(w["x"].abs(), w["prp_x"].abs()), min=1.0)
    turn = 2.0 * math.pi
    dphi = torch.remainder((g["phi"] - w["phi"]).abs(), turn)
    out.update(
        pb=(g["pb"] - w["pb"]).abs() / p,
        pperp=(g["pperp"] - w["pperp"]).abs() / p,
        x=(g["x"] - w["x"]).abs() / xs,
        prp_x=(g["prp_x"] - w["prp_x"]).abs() / xs,
        phi=torch.minimum(dphi, turn - dphi) / turn,
        acctime=(g["acctime"] - w["acctime"]).abs()
        / torch.clamp(w["acctime"].abs(), min=1e-300))
    return out


def diverged(got: dict, want: dict, tol: float) -> tuple:
    """([n] bool: the lanes whose end states differ, {field: lanes off
    in it}): an exact field that differs, or a gap over `tol`."""
    bad = torch.zeros_like(want["status"], dtype=torch.bool)
    by = {}
    for f, gap in gaps(got, want).items():
        off = ~(gap <= (0.0 if f in EXACT else tol))
        by[f] = int(off.sum())
        bad |= off
    return bad, by


def _l1(got, want) -> float:
    """sum |got - want| over sum |want|; 0 where both are 0, 1 where
    only `want` is."""
    den = float(want.abs().sum())
    num = float((got - want).abs().sum())
    if not math.isfinite(num):
        return math.inf
    return num / den if den > 0 else (0.0 if num == 0 else 1.0)


def _finalized(diff, rows: int, nz: int):
    """A tally in difference form over the boundaries, per boundary."""
    return torch.cumsum(diff.reshape(rows, nz), dim=-1)[:, :-1]


def tally_gaps(prog: dict, ref: dict, nb: int) -> dict:
    """{"psd_gap", "flux_gap", "esc_gap"} of the program's deposits
    `prog` (its tallies' change over the drain: psd_diff [cells, nz],
    flux_diff [4, nz], esc [4], counts) against the plain step's
    (``plain_steps.tallies``)."""
    nz = nb + 1
    cells = ref["psd"].numel() // nz
    psd = _l1(_finalized(prog["psd_diff"], cells, nz),
              _finalized(ref["psd"], cells, nz))
    fp = _finalized(prog["flux_diff"], 4, nz)
    fr = _finalized(ref["flux"], 4, nz)
    flux = max(_l1(fp[c], fr[c]) for c in range(4))
    esc = max([_l1(prog["esc"][j], ref["esc"][j]) for j in range(4)]
              + [_l1(prog["counts"][C_RETRO], ref["retro"][0])])
    return {"psd_gap": psd, "flux_gap": flux, "esc_gap": esc}


def program_deposits(d: dict) -> dict:
    """The drawn drain's change of the species' tallies, in float64."""
    dev = d["device"]
    return {n: d["tl1"][n].to(dev, torch.float64)
            - d["tl0"][n].to(dev, torch.float64) for n in TALLIES}


def drain_readings(d: dict | None, max_helix: int, dtype=None) -> dict:
    """The numbers of the drawn drain `d`: ``lanes_diverged`` (the share
    of the lanes ACTIVE at its start whose end state differs, 1 where
    none was) and ``tally_gaps``; with `dtype` the plain step in that
    precision is judged in the kernel's place (the control).  Also
    ``lanes`` (lanes judged), ``off`` (lanes off by field) and
    ``steps`` (the drain's longest lane)."""
    if d is None:
        return {"lanes_diverged": 1.0, "psd_gap": math.inf,
                "flux_gap": math.inf, "esc_gap": math.inf, "lanes": 0}
    want, ref = repush(d, max_helix)
    if dtype is None:
        got = {f: v.to(d["device"]) for f, v in d["after"].items()}
        prog = program_deposits(d)
    else:
        got, low = repush(d, max_helix, dtype)
        prog = {"psd_diff": low["psd"], "flux_diff": low["flux"],
                "esc": low["esc"], "counts": low["retro"]}
    live = d["before"]["status"].to(d["device"]) == ps.ACTIVE
    n = int(live.sum())
    sel = lambda s: {f: v[live] for f, v in s.items()}
    bad, off = diverged(sel(got), sel(want), TOL[d["before"]["pb"].dtype])
    out = {"lanes_diverged": int(bad.sum()) / n if n else 1.0, "lanes": n,
           "off": off, "steps": int((d["after"]["nsteps"]
                                     - d["before"]["nsteps"]).max())}
    out.update(tally_gaps(prog, ref, _nb(d["kind"], d["tb"])))
    return out


# ---------------------------------------------------------------------------
# the drawn split
# ---------------------------------------------------------------------------

def fold_in_lanes(key: tuple, n: int, offset: int, device):
    """Lane keys fold_in(key, offset + j), j < n, as int32 planes."""
    data = (torch.arange(n, dtype=torch.int64, device=device)
            + offset) & ps.MASK32
    y = ps.threefry2x32(key[0], key[1], torch.zeros_like(data), data)
    return [torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)
            for w in y]


def split_plain(before: dict, n_target: int, key: tuple,
                offset: int = 0, dtype=None) -> tuple:
    """(state, n_new) of the pcut split (cuts.jl): the SAVED lanes, in
    their order, each copied i_mult = max(n_target // n_saved, 1) times
    with its weight over i_mult, ACTIVE, with fresh keys, no steps, no
    exit, and only the downstream and injected flags; the other slots
    FINISHED with no weight.  With `dtype` the weights are divided in
    that dtype (the control)."""
    b = before["weight"].shape[0]
    dev = before["weight"].device
    saved = before["status"] == ps.SAVED
    n_saved = int(saved.sum())
    order = torch.cat([saved.nonzero().flatten(),
                       (~saved).nonzero().flatten()])
    i_mult = max(n_target // max(n_saved, 1), 1)
    j = torch.arange(b, device=dev)
    src = order[torch.clamp(j // i_mult, max=b - 1)]
    valid = j < n_saved * i_mult
    w = before["weight"][src]
    wd = w.dtype if dtype is None else dtype
    div = torch.full((), i_mult, dtype=wd, device=dev)
    out = {f: before[f][src] for f in ps.FIELDS}
    key0, key1 = fold_in_lanes(key, b, offset, dev)
    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    out.update(
        weight=torch.where(valid, w.to(wd) / div, 0.0).to(w.dtype),
        status=torch.where(valid, ps.ACTIVE, ps.FINISHED).to(torch.int32),
        reason=zero, nsteps=zero.clone(),
        flags=before["flags"][src] & (ps.FL_DW | ps.FL_INJ),
        key0=key0, key1=key1,
        t_step=torch.zeros_like(before["t_step"]))
    return out, n_saved * i_mult


def split_reading(s: dict | None, dtype=None) -> float:
    """``split_off``: the share of the drawn split's lanes on which any
    field differs from the plain split's, 1 where its count of new lanes
    differs or no split was drawn.  With `dtype` the plain split at that
    precision is judged in the program's place (the control)."""
    if s is None:
        return 1.0
    before = {f: v.to(s["device"]) for f, v in s["before"].items()}
    want, n_new = split_plain(before, s["n_target"], s["key"], s["offset"])
    got = {f: v.to(s["device"]) for f, v in s["after"].items()}
    got_n = int(s["n_new"])
    if dtype is not None:
        got, got_n = split_plain(before, s["n_target"], s["key"],
                                 s["offset"], dtype)
    if got_n != n_new:
        return 1.0
    bad = torch.zeros(want["weight"].shape[0], dtype=torch.bool,
                      device=want["weight"].device)
    for f in ps.FIELDS:
        bad |= got[f].to(want[f].dtype) != want[f]
    return float(bad.sum()) / bad.shape[0]


def count_readings(capture: Capture, result) -> dict:
    """``pushes_gap``: the run's pushes as the program counts them
    (RunResult.n_pushes) against the lanes' steps over every drain;
    ``exits_gap``: the exits by reason (1-4) that the program counted
    over every iteration and species against those read off the lanes
    after every drain.  Both are counts: the sum of the differences."""
    pushes = int(torch.stack(capture.pushes).sum()) if capture.pushes \
        else 0
    lanes = (torch.stack(capture.exits).sum(0).cpu() if capture.exits
             else torch.zeros(N_REASONS, dtype=torch.int64))
    counted = torch.zeros(N_REASONS, dtype=torch.int64)
    for itr in result.iterations:
        for fi in itr.ion_finals:
            rc = torch.as_tensor(fi.reason_counts, dtype=torch.int64)
            counted[:rc.shape[0]] += rc
    return {"pushes_gap": abs(pushes - int(result.n_pushes)),
            "exits_gap": int((lanes[1:5] - counted[1:5]).abs().sum())}
