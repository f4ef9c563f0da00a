"""The port's K1 slice end to end on the CPU (kernels through their
plain versions): the flagship workload's config at test size with
float32 momenta (the CLI's --f32, which selects K1), against the JAX
package's acceptance checks and output surface."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from montecarloscattering_jl_tpu.engine import io as jio
from montecarloscattering_jl_tpu_torch.engine.driver import run
from montecarloscattering_jl_tpu_torch.ops import mega
from montecarloscattering_jl_tpu_torch.utils import constants as K
from montecarloscattering_jl_tpu_torch.utils import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "tests", "data", "dsa_nonrel.toml")


@pytest.fixture(scope="module")
def slice_run():
    """One port run of tests/data/dsa_nonrel.toml at 100 / 150 / 150
    particles (the JAX test_dsa_power_law sizes) with float32 momenta,
    written to disk."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = load_config(CFG)
    cfg.n_pts_inj = 100
    cfg.n_pts_pcut = 150
    cfg.n_pts_pcut_hi = 150
    out = tempfile.mkdtemp(prefix="mcs_torch_slice_")
    calls = mega.TWIN_CALLS
    try:
        res = run(cfg, device="cpu", out_dir=out, p_dtype=torch.float32)
    finally:
        torch.set_num_threads(n_threads)
    yield res, out, mega.TWIN_CALLS - calls
    for f in os.listdir(out):
        os.unlink(os.path.join(out, f))
    os.rmdir(out)


def test_dsa_power_law(slice_run):
    """The JAX package's acceptance run (test_transport.py:175-202) on
    the port: the downstream spectrum of a strong nonrelativistic
    test-particle shock is dN/dp ~ p^-(3r/(r-1) - 2)."""
    res, _, twin_calls = slice_run
    setup = res.setup
    assert setup.r_comp == pytest.approx(4.0, abs=0.01)
    assert res.n_pushes > 1e5
    assert twin_calls > 0            # on the CPU the twin ran the drains
    fi = res.iterations[0].ion_finals[0]
    bins = setup.bins
    p_cent = bins.mom_centers
    dndp = fi.psd[:, :, 75].sum(axis=1) / np.diff(bins.mom_edges)
    sel = ((p_cent > 0.018 * K.MP_C) & (p_cent < 0.12 * K.MP_C)
           & (dndp > 0))
    assert sel.sum() >= 6
    slope = np.polyfit(np.log10(p_cent[sel]), np.log10(dndp[sel]), 1)[0]
    expect = -(3 * setup.r_comp / (setup.r_comp - 1) - 2)
    assert slope == pytest.approx(expect, abs=0.45)


def test_fluxes_and_escapes(slice_run):
    """The rest of test_dsa_power_law's checks: Pi_xx near the shock is
    sane, and particles escaped at the upstream FEB with flux."""
    res, _, _ = slice_run
    setup = res.setup
    it = res.iterations[0].tallies
    pxx_norm = it.pxx_flux / setup.f_px_upstream
    up = slice(setup.i_shock - 4, setup.i_shock)
    assert np.all(pxx_norm[up] > 0.9)
    assert np.all(pxx_norm[up] < 30.0)
    esc = res.iterations[0].ion_finals[0].esc
    assert float(esc.esc_flux) > 0
    assert float(esc.px_esc_feb) > 0


def test_reductions_finite(slice_run):
    res, _, _ = slice_run
    fi = res.iterations[0].ion_finals[0]
    for name in ("dndp_cr", "dndp_therm", "p_psd_par", "p_psd_perp",
                 "energy_density_psd", "d2n_ef"):
        assert np.isfinite(getattr(fi, name)).all(), name
    assert fi.dndp_cr.max() > 0


def _table(path):
    """Header lines and the column count of every data row."""
    with open(path) as f:
        lines = f.read().splitlines()
    heads = [ln for ln in lines if ln.startswith("#")]
    cols = sorted({len(ln.split()) for ln in lines
                   if ln and not ln.startswith("#")
                   and ln[0] in "0123456789-"})
    return heads, cols


def test_output_files_match_jax_writer(slice_run):
    """The port's run() writes the same file names and columns as the
    JAX package's write_outputs given the same run result."""
    res, out, _ = slice_run
    with tempfile.TemporaryDirectory() as ref_dir:
        jio.write_outputs(res, ref_dir)
        want = sorted(os.listdir(ref_dir))
        assert sorted(os.listdir(out)) == want
        for name in want:
            if name.endswith(".dat"):
                assert _table(os.path.join(out, name)) == _table(
                    os.path.join(ref_dir, name)), name


def test_port_runs_without_jax():
    """Importing the port and running one twin step, one float64 step of
    the XLA engine with both detectors (its deposit through K2's plain
    version) and the histogram probe's records through K3's plain
    version loads no jax and no module of the JAX package."""
    code = (
        "import sys, torch\n"
        "from montecarloscattering_jl_tpu_torch.engine.run import "
        "TransportEngine\n"
        "from montecarloscattering_jl_tpu_torch.engine.setup import "
        "build_setup\n"
        "from montecarloscattering_jl_tpu_torch.ops import mega, rng, "
        "state as stt\n"
        "from montecarloscattering_jl_tpu_torch.utils import load_config\n"
        f"cfg = load_config({CFG!r})\n"
        "setup = build_setup(cfg)\n"
        "eng = TransportEngine(setup, device='cpu')\n"
        "prof = setup.profile\n"
        "b = 128\n"
        "st = stt.init_state([1.0] * b, [1e-16] * b, [5e-17] * b,\n"
        "                    [-1e8] * b, [60] * b, [prof.ux_sk[60]] * b,\n"
        "                    cfg.xn_per_fine, setup.x_grid_stop,\n"
        "                    rng.key(1), 'cpu')\n"
        "tl = stt.make_tallies(setup.nb, setup.bins.n_mom,\n"
        "                      setup.bins.n_theta, 'cpu')\n"
        "ss = eng.step_static(0)\n"
        "tb = mega.mega_tables(eng.segment_grids(prof),\n"
        "                      eng.segment_scalars(0, 0, prof.bmag2), ss,\n"
        "                      'cpu')\n"
        "mega.launch(st, tb, tl, n_steps=1)\n"
        "assert int(st.nsteps.sum()) == b, st.nsteps\n"
        "import numpy as np\n"
        "from montecarloscattering_jl_tpu_torch.ops import hist, step\n"
        "from montecarloscattering_jl_tpu_torch.scripts import "
        "probe_hist\n"
        "cfg.x_spec = [-0.5 * cfg.rg0, 0.5 * cfg.rg0]\n"
        "eng = TransportEngine(build_setup(cfg), device='cpu')\n"
        "ss = eng.step_static(0)\n"
        "st = stt.init_state([1.0] * b, [1e-16] * b, [5e-17] * b,\n"
        "                    [-1e8] * b, [60] * b, [prof.ux_sk[60]] * b,\n"
        "                    cfg.xn_per_fine, setup.x_grid_stop,\n"
        "                    rng.key(1), 'cpu', p_dtype=torch.float64)\n"
        "tl = stt.make_tallies(setup.nb, setup.bins.n_mom,\n"
        "                      setup.bins.n_theta, 'cpu', n_xspec=2)\n"
        "tx = step.step_tables(eng.segment_grids(prof),\n"
        "                      eng.segment_scalars(0, 0, prof.bmag2), ss,\n"
        "                      'cpu')\n"
        "calls = hist.PLAIN_CALLS\n"
        "step.helix_step(st, tl, tx, rng.lane_uniforms_xla(\n"
        "    st.key0, st.key1, st.nsteps), 10_000)\n"
        "assert hist.PLAIN_CALLS == calls + 1\n"
        "assert int(st.nsteps.sum()) == b and st.pb.dtype == torch.float64\n"
        "recs = [torch.from_numpy(a) for a in probe_hist.synth(\n"
        "    4096, np.random.default_rng(42))]\n"
        "psd = torch.zeros(probe_hist.N_CELLS, probe_hist.NZC)\n"
        "hist.psd_scatter_band(psd, *recs, 1024)\n"
        "assert float(psd.abs().sum()) > 0\n"
        "from montecarloscattering_jl_tpu_torch.models import emission\n"
        "from montecarloscattering_jl_tpu_torch.models.emission import "
        "device as edev\n"
        "from montecarloscattering_jl_tpu_torch.scripts import "
        "flagship_sed, probe_k1, workloads\n"
        "grid = torch.full((30, 4), 1e-20, dtype=torch.float64)\n"
        "e_g = torch.logspace(-18, -15, 30, dtype=torch.float64)\n"
        "ism = edev.doppler_shift_device(\n"
        "    grid, e_g, torch.full((4,), 0.5, dtype=torch.float64),\n"
        "    torch.full((4,), 1.25, dtype=torch.float64))\n"
        "assert ism.shape == grid.shape and float(ism.sum()) > 0\n"
        "assert callable(emission.photon_calcs)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'montecarloscattering_jl_tpu'"
        " or m.startswith('montecarloscattering_jl_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("argv,rc", [
    (["no_such_config.toml", "--device", "cpu"], 2),
    ([CFG, "--device", "cuda"], 1),
])
def test_cli_refuses(argv, rc):
    """The CLI: a missing config returns 2; --device cuda without a CUDA
    device raises instead of falling back to the CPU."""
    if rc == 1 and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "montecarloscattering_jl_tpu_torch", *argv],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == rc, proc.stderr
    if rc == 1:
        assert "no CUDA device" in proc.stderr
