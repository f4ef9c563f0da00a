"""K5's wrapper (montecarloscattering_jl_tpu_torch/ops/helix.py) on the
CPU, where there is no nvcc and no card: the packing of every StepTables
the engine builds, the name lists against the enums of
csrc/helix_step.cu, the instance each configuration selects, and the
drain's choice of path (ops/step.py run_segment): on the CPU the plain
block, bit for bit as before, and on a CUDA device K5 or an error, never
the plain block in its place.  K5 itself runs only on the card
(tests/test_torch_cuda.py, ``-m cuda``); the plain step it follows is
held to the JAX package's ``helix_step`` by test_torch_step.py,
test_torch_step_flags.py, test_torch_xla_slice.py and
test_torch_compaction.py.
"""

import dataclasses
import math
import os
import re
import types

import pytest
import torch

from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
from montecarloscattering_jl_tpu_torch.ops import helix, rng
from montecarloscattering_jl_tpu_torch.ops import state as stt
from montecarloscattering_jl_tpu_torch.ops import step
from montecarloscattering_jl_tpu_torch.scripts import workloads as wl
from montecarloscattering_jl_tpu_torch.utils import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "montecarloscattering_jl_tpu_torch", "csrc",
                   "helix_step.cu")
CONFIGS = ("configs/baseline.toml", "tests/data/dsa_nonrel.toml",
           "examples/01_test_particle.toml",
           "examples/02_nonlinear_smoothed.toml",
           "examples/03_electron_synch_ic.toml",
           "examples/04_hadronic_sed.toml")
# float64 as configured; float32 with two x_spec detectors (the XLA
# engine's float32 configurations)
DTYPES = {"f64": torch.float64, "f32-xspec": torch.float32}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # the plain step is ~300 small ops a step: one torch thread, as the
    # other step tests run it (many threads a worker crowd the cores)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _enum(name: str) -> list:
    """The entries of `enum name { ... }` in the source, before N_*."""
    text = open(SRC).read()
    body = re.search(r"enum %s \{(.*?)\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [w.strip() for w in body.split(",") if w.strip()]
    return [w for w in names if not w.startswith("N_")]


def _unpack(p) -> dict:
    """The packed vectors by name (KV_NAMES and KI_NAMES)."""
    return dict(zip(helix.KV_NAMES, p.kv.tolist()),
                **dict(zip(helix.KI_NAMES, p.ki.tolist())))


def _tables(path: str, pdt):
    """Every StepTables the engine builds for the config: each species
    at each pcut, on the CPU, with momenta in `pdt` (float32: with two
    x_spec detectors)."""
    cfg = load_config(os.path.join(ROOT, path))
    if pdt == torch.float32:
        cfg.x_spec = [-0.5 * cfg.rg0, 0.5 * cfg.rg0]
    setup = build_setup(cfg)
    eng = TransportEngine(setup, device="cpu", p_dtype=pdt)
    grids = eng.segment_grids(setup.profile)
    for i_ion in range(cfg.n_ions):
        ss = eng.step_static(i_ion)
        for i_pcut in range(len(cfg.pcuts)):
            sc = eng.segment_scalars(i_ion, i_pcut, setup.profile.bmag2)
            yield step.step_tables(grids, sc, ss, "cpu")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("path", CONFIGS)
def test_pack_round_trips(path, dtype):
    pdt = DTYPES[dtype]
    n = 0
    for tb in _tables(path, pdt):
        p = helix.pack(tb)
        got = _unpack(p)
        assert set(helix.K_NAMES) == set(tb.k)
        for name in helix.K_NAMES:
            assert got[name] == float(tb.k[name]), name
        scal = helix.python_scalars(tb.ss, pdt)
        for name in helix.S_NAMES:
            assert got[name] == scal[name], name
        ss = tb.ss
        assert (got["nb"], got["i_grid_feb"], got["i_shock"], got["n_mom"],
                got["n_theta"], got["bpd_mom"], got["bpd_theta"],
                got["n_xspec"], got["nx"], got["n_slots"]) == (
            ss.nb, ss.i_grid_feb, ss.i_shock, ss.n_mom, ss.n_theta,
            ss.bins_per_dec_mom, ss.bins_per_dec_theta, ss.n_xspec,
            max(ss.n_xspec, 1), tb.tcuts.shape[0])
        assert got["flags"] == p.word == helix.flag_word(tb)
        assert p.kv.dtype == torch.float64 and p.ki.dtype == torch.int32
        assert p.p_dtype == pdt
        n += 1
    assert n > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("path", CONFIGS)
def test_instance_exists(path, dtype):
    f64 = DTYPES[dtype] == torch.float64
    for tb in _tables(path, DTYPES[dtype]):
        p = helix.pack(tb)
        f, word = helix.INSTANCES[p.instance]
        assert f == f64
        assert word in (p.word, helix.CT_RUNTIME)


@pytest.mark.parametrize("enum,names", [
    ("KV", helix.KV_NAMES), ("KI", helix.KI_NAMES),
    ("PTR", helix.PTR_NAMES)])
def test_names_match_the_source_enums(enum, names):
    prefix = enum + "_"
    got = _enum(enum)
    assert all(w.startswith(prefix) for w in got)
    assert [w[len(prefix):].lower() for w in got] == list(names)


def test_flags_and_instances_match_the_source():
    text = open(SRC).read()
    flags = dict(re.findall(r"FLAG_(\w+) = (\d+)", text))
    for name, value in flags.items():
        assert getattr(helix, "FLAG_" + name) == int(value), name
    assert len(flags) == 13
    body = re.search(r"kInstances\[\] = \{(.*?)\};", text, re.S).group(1)
    pairs = re.findall(r"\{(\d), (\w+)\}", body)
    word = lambda w: (helix.CT_RUNTIME if w == "CT_RUNTIME"
                      else getattr(helix, w))
    assert tuple((f == "1", word(w)) for f, w in pairs) == helix.INSTANCES


@pytest.mark.parametrize("case", wl.FLAG_CASES, ids=[c[0] for c in
                                                    wl.FLAG_CASES])
def test_flag_case_words(case):
    """Each flag case of chip_smoke.py's phase k5 packs the flags its
    StepStatic carries, and the run-time instance of its dtype runs it."""
    c = wl.helix_flag_case(case, "cpu", lanes=64)
    tb = c["tb"]
    p = helix.pack(tb)
    for name in case[3]:
        bit = dict(helix._SS_FLAGS)[name]
        assert p.word & bit, name
    assert bool(p.word & helix.FLAG_CUSTOM_FRG) == (case[4] is not None)
    assert bool(p.word & helix.FLAG_ELECTRON) == (case[1] == 1)
    assert helix.INSTANCES[p.instance] == (True, helix.CT_RUNTIME)


@pytest.mark.parametrize("case", wl.FLAG_CASES, ids=[c[0] for c in
                                                    wl.FLAG_CASES])
def test_frg_words_run_the_frg_build(case):
    """A word with the custom f(r_g) law runs K5's f(r_g) build (its pow
    linked from csrc/helix_pow.cu, built as torch builds its kernels);
    every other word the default build, which refuses the law's words."""
    p = helix.pack(wl.helix_flag_case(case, "cpu", lanes=64)["tb"])
    assert p.frg == (case[4] is not None) == bool(
        p.word & helix.FLAG_CUSTOM_FRG)
    (name, defines, unit), (name_f, defines_f, unit_f) = helix.targets()
    assert name == name_f == "helix_step" and unit is None
    assert defines_f == dict(defines or {}, K5_FRG=1)
    assert unit_f == ("helix_pow", "-fmad=true")
    text = open(SRC).read()
    assert "(K5_FRG || (word & FLAG_CUSTOM_FRG) == 0)" in text
    assert "k.frg_on = K5_FRG && (fl & FLAG_CUSTOM_FRG) != 0;" in text


def test_flagship_runs_its_own_instance():
    """The float64 flagship with detectors (chip_smoke.py phase f64's
    config) runs the instance compiled for its word; at float32 the
    same word runs the float32 run-time instance."""
    for pdt, want in ((torch.float64, (True, helix.FLAG_XSPEC)),
                      (torch.float32, (False, helix.CT_RUNTIME))):
        _, tb, _ = _segment(lanes=64, pdt=pdt)
        p = helix.pack(tb)
        assert p.word == helix.FLAG_XSPEC
        assert helix.INSTANCES[p.instance] == want


def test_pack_refuses_the_oblique_step():
    tb = next(_tables("tests/data/dsa_nonrel.toml", torch.float64))
    obl = dataclasses.replace(tb, ss=dataclasses.replace(tb.ss,
                                                         parallel=False))
    with pytest.raises(NotImplementedError):
        helix.pack(obl)


def _segment(lanes=256, pdt=torch.float64, x_spec=True):
    cfg = load_config(wl.CFG)
    if x_spec:
        cfg.x_spec = [-0.5 * cfg.rg0, 0.5 * cfg.rg0]
    setup = build_setup(cfg)
    eng = TransportEngine(setup, device="cpu", p_dtype=pdt)
    ss = eng.step_static(0)
    tb = step.step_tables(eng.segment_grids(setup.profile),
                          eng.segment_scalars(0, 0, setup.profile.bmag2),
                          ss, "cpu")
    st = wl.flagship_population(setup, cfg, "cpu", lanes=lanes, p_dtype=pdt)
    b = setup.bins
    fresh = lambda: stt.make_tallies(setup.nb, b.n_mom, b.n_theta, "cpu",
                                     n_xspec=ss.n_xspec)
    return st, tb, fresh


@pytest.mark.parametrize("pdt", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cpu_run_segment_is_the_plain_block(pdt):
    """On the CPU run_segment launches no K5 and runs the plain block,
    bit for bit: the same lanes and tallies as _block repeated until no
    lane is ACTIVE, and helix.block is the same plain block."""
    st0, tb, fresh = _segment(pdt=pdt)
    cap = 192
    before = (helix.LAUNCHES, helix.DEPOSIT_STEPS, helix.PLAIN_CALLS)
    a, ta = stt.clone(st0), fresh()
    taken = step.run_segment(a, ta, tb, max_helix=cap)
    b, tbl = stt.clone(st0), fresh()
    n = 0
    while int((b.status == stt.ACTIVE).sum()) > 0:
        step._block(b, tbl, tb, step.SYNC_EVERY, cap)
        n += step.SYNC_EVERY
    c, tc = stt.clone(st0), fresh()
    for _ in range(n // step.SYNC_EVERY):
        helix.block(c, tc, tb, step.SYNC_EVERY, cap)
    assert taken == n
    assert (helix.LAUNCHES, helix.DEPOSIT_STEPS, helix.PLAIN_CALLS) == before
    for other, t_other in ((b, tbl), (c, tc)):
        for f in dataclasses.fields(st0):
            assert torch.equal(getattr(a, f.name), getattr(other, f.name)), \
                f.name
        for f in dataclasses.fields(ta):
            v = getattr(ta, f.name)
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, getattr(t_other, f.name)), f.name


class _CudaTensor:
    """A CPU tensor that reports a CUDA device (run_segment's choice of
    path reads st.weight.device alone)."""

    def __init__(self, t):
        self.t = t
        self.device = types.SimpleNamespace(type="cuda")
        self.shape = t.shape


def _as_cuda(st):
    return dataclasses.replace(st, weight=_CudaTensor(st.weight))


class _Refused:
    def __init__(self, *a, **k):
        raise RuntimeError("K5 launch failed: CUDA error 209")


@pytest.mark.parametrize("levels", [0, 1])
def test_cuda_run_segment_never_runs_the_plain_block(monkeypatch, levels):
    """With the lanes on a CUDA device and K5's launch failing (its
    drain, and its windows under ``blocks=True``), run_segment raises;
    it never runs the plain block in K5's place."""
    st0, tb, fresh = _segment(lanes=1024)
    plain = []
    monkeypatch.setattr(step, "_block", lambda *a, **k: plain.append(a))
    monkeypatch.setattr(helix, "HelixDrain", _Refused)
    monkeypatch.setattr(helix, "HelixLaunch", _Refused)
    for blocks in (False, True):
        with pytest.raises(RuntimeError, match="K5 launch failed"):
            step.run_segment(_as_cuda(st0), fresh(), tb,
                             compact_levels=levels, graphs=step.GraphCache(),
                             blocks=blocks)
    assert plain == []


@pytest.mark.parametrize("levels", [0, 5])
def test_cuda_run_segment_is_one_drain(monkeypatch, levels):
    """On a CUDA device a segment of the parallel-field step is one K5
    drain (recorded here in place of the card), whatever the compaction
    depth: no plain block, no K5 window, no graph capture and no host
    read inside the segment; run_segment returns the drain's steps."""
    st0, tb, fresh = _segment(lanes=1024)
    drained, plain = [], []
    monkeypatch.setattr(step, "_block", lambda *a, **k: plain.append(a))
    monkeypatch.setattr(helix, "HelixLaunch", _Refused)

    class Recorded:
        def __init__(self, st, tl, p):
            assert p.tb is tb
            assert helix.INSTANCES[p.instance] == (True, helix.FLAG_XSPEC)
            self.st = st

        def enqueue(self, max_helix, sync_every):
            drained.append((self.st.status.shape[0], max_helix, sync_every))

        def finish(self):
            return 3 * step.SYNC_EVERY

    monkeypatch.setattr(helix, "HelixDrain", Recorded)
    reads = helix.HOST_READS
    g = step.GraphCache()
    taken = step.run_segment(_as_cuda(st0), fresh(), tb, max_helix=640,
                             compact_levels=levels, graphs=g)
    assert drained == [(1024, 640, step.SYNC_EVERY)]
    assert taken == 3 * step.SYNC_EVERY
    assert plain == [] and g.captures == 0 and helix.HOST_READS == reads


def test_cuda_block_loop_launches_k5_every_block(monkeypatch):
    """``run_segment(..., blocks=True)``, the comparisons' block loop: on
    a CUDA device every block is one K5 launch of SYNC_EVERY steps on
    the block's window (recorded here in place of the card), with no
    drain, no plain block and no graph capture, and a host read before
    each block and after the last."""
    st0, tb, fresh = _segment(lanes=1024)
    launched, plain = [], []
    monkeypatch.setattr(step, "_block", lambda *a, **k: plain.append(a))
    monkeypatch.setattr(helix, "HelixDrain", _Refused)

    class Recorded:
        def __init__(self, st, tl, p):
            assert p.tb is tb
            assert helix.INSTANCES[p.instance] == (True, helix.FLAG_XSPEC)
            self.st = st

        def enqueue(self, n, max_helix):
            launched.append((self.st.status.shape[0], n, max_helix))
            self.st.status.fill_(stt.FINISHED)     # the block ends them

    monkeypatch.setattr(helix, "HelixLaunch", Recorded)
    reads = helix.HOST_READS
    g = step.GraphCache()
    taken = step.run_segment(_as_cuda(st0), fresh(), tb, max_helix=640,
                             graphs=g, blocks=True)
    assert launched == [(1024, step.SYNC_EVERY, 640)]
    assert taken == step.SYNC_EVERY
    assert plain == [] and g.captures == 0
    assert helix.HOST_READS == reads + 2


@pytest.mark.parametrize("max_steps,cap,want", [
    (0, 10_000, 0), (1, 10_000, 64), (64, 10_000, 64), (65, 10_000, 128),
    (384, 10_000, 384), (299, 10_000, 320), (10_000, 10_000, 10_048),
    (10_001, 10_000, 10_048), (1, 0, 64), (500, 100, 192)])
def test_block_loop_steps(max_steps, cap, want):
    """The block loop's steps from its longest lane's: whole blocks, at
    most max_helix // sync_every + 2 of them (ops/step.py run_segment's
    loop), as csrc/helix_step.cu's drain computes them (held on the card
    by tests/test_torch_cuda.py and chip_smoke.py's hold_drain)."""
    assert helix.block_loop_steps(max_steps, cap, 64) == want


def _same_lanes(a, b) -> None:
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _same_tallies(a, b) -> None:
    for f in dataclasses.fields(a):
        v = getattr(a, f.name)
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(b, f.name)), f.name


@pytest.mark.parametrize("pdt", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cpu_drain_is_the_block_loop(pdt):
    """K5's drain on the CPU (its plain version, helix.drain_plain: only
    the ACTIVE lanes step, one step at a time, then the FL_JRET rule)
    leaves every lane and tally as run_segment's block loop does and
    returns the loop's steps; K5 is not launched."""
    st0, tb, fresh = _segment(pdt=pdt)
    cap = 192
    before = (helix.LAUNCHES, helix.DEPOSIT_STEPS, helix.PLAIN_CALLS)
    a, ta = stt.clone(st0), fresh()
    taken = helix.drain(a, ta, tb, cap, step.SYNC_EVERY)
    b, tbl = stt.clone(st0), fresh()
    want = step.run_segment(b, tbl, tb, max_helix=cap)
    assert taken == want > 0
    assert (helix.LAUNCHES, helix.DEPOSIT_STEPS, helix.PLAIN_CALLS) == before
    _same_lanes(a, b)
    _same_tallies(ta, tbl)


@pytest.fixture(scope="module")
def jret_case():
    """The flagship population (256 lanes, float64) and the steps at
    which lanes return from their PRP (FL_JRET set on a lane still
    ACTIVE), stepping every lane without a cap for 400 steps."""
    st0, tb, fresh = _segment()
    assert int(st0.nsteps.max()) == int(st0.nsteps.min()) == 0
    st, tl = stt.clone(st0), fresh()
    events = {}
    for s in range(400):
        step.helix_step(st, tl, tb, rng.lane_uniforms_xla(
            st.key0, st.key1, st.nsteps), 10 ** 6)
        back = (st.flags & stt.FL_JRET != 0) & (st.status == stt.ACTIVE)
        if bool(back.any()):
            events[s + 1] = back
    return st0, tb, fresh, events


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["longest-on-64", "longest-off-64"])
def test_drain_jret_rule(jret_case, aligned):
    """The block loop clears FL_JRET on a lane that is not ACTIVE at every
    step it runs, so a lane keeps the bit only if it stepped to the
    loop's last step.  With the helix cap at a step where lanes return
    from their PRP, those lanes end capped with the bit set, and the
    segment's longest lane ends there: on a multiple of 64 the block loop
    keeps their bit, off it the loop runs on to the block's end and
    clears it.  Lanes that were not ACTIVE with the bit set lose it.
    K5's drain (its plain version) gives the loop's lanes and steps."""
    st0, tb, fresh, events = jret_case
    at = [s for s in sorted(events) if (s % step.SYNC_EVERY == 0) == aligned]
    assert at, events
    cap = at[-1]
    back = events[cap]
    st0 = stt.clone(st0)
    skipped = torch.tensor([i for i in range(0, 256, 37) if not back[i]])
    st0.status[skipped] = stt.FINISHED
    st0.flags[skipped] |= stt.FL_JRET
    a, ta = stt.clone(st0), fresh()
    taken = helix.drain(a, ta, tb, cap, step.SYNC_EVERY)
    b, tbl = stt.clone(st0), fresh()
    want = step.run_segment(b, tbl, tb, max_helix=cap)
    assert taken == want == -(-cap // step.SYNC_EVERY) * step.SYNC_EVERY
    _same_lanes(a, b)
    _same_tallies(ta, tbl)
    jret = (b.flags & stt.FL_JRET) != 0
    capped = (b.nsteps == cap) & (b.status == stt.FINISHED)
    assert bool(capped[back].all())
    assert not bool(jret[skipped].any())
    assert torch.equal(jret, back if aligned else torch.zeros_like(back))


def _refuses(kernel) -> None:
    st0, tb, fresh = _segment(lanes=64)
    p = helix.pack(tb)
    with pytest.raises(ValueError, match="no helix kernel"):
        kernel(st0, fresh(), p)
    bad = dataclasses.replace(st0, pb=st0.pb.float())
    with pytest.raises(ValueError, match="state.pb"):
        kernel(bad, fresh(), p)
    tl = fresh()
    tl.psd_diff = tl.psd_diff.double()
    with pytest.raises(ValueError, match="psd_diff"):
        kernel(st0, tl, p)


def test_wrappers_refuse_cpu_launches_and_bad_tensors():
    _refuses(helix.HelixLaunch)


def test_drain_refuses_cpu_launches_and_bad_tensors():
    _refuses(helix.HelixDrain)


@pytest.mark.parametrize("ctr", [0, 1, 63, 2 ** 31 - 1])
def test_cpu_uniforms_are_the_xla_stream(ctr):
    k0, k1 = rng.fold_in_lanes(rng.key(3), 257, "cpu")
    ns = torch.full((257,), ctr, dtype=torch.int32)
    u = helix.uniforms(k0, k1, ns)
    assert u.shape == (8, 257) and u.dtype == torch.float32
    assert torch.equal(u, rng.lane_uniforms_xla(k0, k1, ns))
    assert bool(((u > 0) & (u < 1)).all())


def test_python_scalars():
    tb = next(_tables("tests/data/dsa_nonrel.toml", torch.float64))
    s = helix.python_scalars(tb.ss, torch.float64)
    assert s["log_pmin"] == math.log10(tb.ss.psd_mom_min)
    assert s["eta3"] == tb.ss.eta_mfp / 3.0
    assert s["ftiny"] == torch.finfo(torch.float64).tiny
    assert helix.python_scalars(tb.ss, torch.float32)["ftiny"] == \
        torch.finfo(torch.float32).tiny


def test_run_result_counts_the_ladders_launches(monkeypatch):
    """RunResult.launches carries the ladders' launch counts
    (engine/run.py launch_counts) over the run: here every XLA-engine
    segment is made to count one K5 launch of SYNC_EVERY steps, which
    the run must report, and nothing else (the rebinning kernel, which
    a CUDA device launches once a species and iteration, and the finish
    kernel, once a segment there: none on the CPU)."""
    from montecarloscattering_jl_tpu_torch.engine.driver import run
    from montecarloscattering_jl_tpu_torch.engine.run import launch_counts

    segments = []
    base = step.run_segment

    def counted(*a, **kw):
        segments.append(1)
        helix.LAUNCHES += 1
        helix.DEPOSIT_STEPS += step.SYNC_EVERY
        return base(*a, **kw)

    monkeypatch.setattr(step, "run_segment", counted)
    monkeypatch.setattr(step, "MAX_HELIX_STEPS", 64)
    cfg = wl.load_variant(
        os.path.join(ROOT, "examples", "03_electron_synch_ic.toml"),
        [("N_PTS_INJ = 50", "N_PTS_INJ = 40"),
         ("N_PTS_PCUT = 100", "N_PTS_PCUT = 40"),
         ("N_PTS_PCUT_HI = 100", "N_PTS_PCUT_HI = 40"),
         ("calculate-photon-production = true",
          "calculate-photon-production = false")])
    cfg.pcuts = cfg.pcuts[:2]
    res = run(cfg, "cpu", p_dtype=torch.float64)
    assert set(res.launches) == set(launch_counts()) | {"rebin"}
    assert res.launches == dict(k1=0, k2=0, k5=len(segments),
                                k5_steps=step.SYNC_EVERY * len(segments),
                                plain_blocks=0, finish=0, rebin=0)
    assert len(segments) >= 2
