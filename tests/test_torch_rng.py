"""The port's RNG (montecarloscattering_jl_tpu_torch/ops/rng.py) against
jax.random and the megakernel's generator: every check is bit-exact.

Inputs are drawn from a seeded numpy generator and handed to both
packages as NumPy arrays."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarloscattering_jl_tpu.ops import pallas_step as ps
from montecarloscattering_jl_tpu.ops import state as jst
from montecarloscattering_jl_tpu_torch.ops import rng
from montecarloscattering_jl_tpu_torch.ops import state as tst


def _words(seed, n=512):
    g = np.random.default_rng(seed)
    return g.integers(0, 2**32, (4, n), dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry_matches_jax_prf(seed):
    from jax._src.prng import threefry_2x32
    k0, k1, c0, c1 = _words(seed)
    want = np.asarray(threefry_2x32(
        jnp.asarray(np.stack([k0, k1])),
        jnp.asarray(np.stack([c0, c1])))).reshape(2, -1)
    got0, got1 = rng.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1))
    np.testing.assert_array_equal(got0.numpy(), want[0])
    np.testing.assert_array_equal(got1.numpy(), want[1])


@pytest.mark.parametrize("seed", [3, 4])
def test_threefry_matches_megakernel_prf(seed):
    k0, k1, c0, c1 = _words(seed)
    r0, r1 = ps._threefry2x32(*(jnp.asarray(a) for a in (k0, k1, c0, c1)))
    g0, g1 = rng.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1))
    np.testing.assert_array_equal(g0.numpy(), np.asarray(r0))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(r1))


@pytest.mark.parametrize("seed", [5, 6])
def test_uniforms_match_megakernel(seed):
    k0, k1, _, _ = _words(seed)
    nsteps = np.random.default_rng(seed).integers(0, 10_000, 512,
                                                  dtype=np.int32)
    want = ps._uniforms(jnp.asarray(k0), jnp.asarray(k1),
                        jnp.asarray(nsteps))
    got = rng.uniforms(torch.from_numpy(k0.view(np.int32)),
                       torch.from_numpy(k1.view(np.int32)),
                       torch.from_numpy(nsteps))
    assert len(got) == 8
    for j in range(8):
        assert got[j].dtype == torch.float32
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(want[j]),
                                      err_msg=f"u[{j}]")


@pytest.mark.parametrize("seed", [0, 77, 2**40 + 12345])
def test_key_and_fold_in_chain(seed):
    """key(seed) -> fold_in(i_iter) -> fold_in(i_ion) -> fold_in(seg):
    the run engine's key derivation."""
    k = jax.random.key(seed)
    assert rng.key(seed) == tuple(int(v) for v in
                                  np.asarray(jax.random.key_data(k)))
    kt = rng.key(seed)
    for d in (3, 0, 5, 2**31 + 7):
        k = jax.random.fold_in(k, d)
        kt = rng.fold_in(kt, d)
        assert kt == tuple(int(v) for v in
                           np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("offset", [0, 4096])
def test_lane_keys(offset):
    seg = jax.random.fold_in(jax.random.key(77), 9)
    n = 1000
    want = np.asarray(jax.random.key_data(jax.vmap(
        jax.random.fold_in, in_axes=(None, 0))(
            seg, jnp.arange(n, dtype=jnp.uint32) + jnp.uint32(offset))))
    k0, k1 = rng.fold_in_lanes(
        tuple(int(v) for v in np.asarray(jax.random.key_data(seg))), n,
        "cpu", offset=offset)
    np.testing.assert_array_equal(k0.numpy().view(np.uint32), want[:, 0])
    np.testing.assert_array_equal(k1.numpy().view(np.uint32), want[:, 1])


@pytest.mark.parametrize("p_dtype", ["float32", "float64"])
def test_init_state_matches(p_dtype):
    """init_state, including the initial gyro phase drawn as a float64
    jax.random.uniform of fold_in(lane_key, 0): every field equal, but
    pperp = sqrt(ptot^2 - pb^2), which XLA on the CPU contracts into a
    fused multiply-add: there pperp^2 agrees to 4 eps * ptot^2."""
    g = np.random.default_rng(11)
    b = 300
    w = np.where(np.arange(b) < 260, g.uniform(0.1, 1.0, b), 0.0)
    ptot = g.uniform(1e-16, 1e-14, b)        # thermal to 0.2 m_p c
    pb = ptot * g.uniform(-1, 1, b)
    x = g.uniform(-1e12, 1e10, b)
    ig = g.integers(0, 90, b).astype(np.int32)
    ux = g.uniform(1e7, 3e8, b)
    seg = jax.random.fold_in(jax.random.key(77), 4)
    jdt = getattr(jnp, p_dtype)
    ref = jst.init_state(w, ptot, pb, x, ig, ux, 50.0, 1e15, seg,
                         p_dtype=jdt)
    got = tst.init_state(
        w, ptot, pb, x, ig, ux, 50.0, 1e15,
        tuple(int(v) for v in np.asarray(jax.random.key_data(seg))),
        "cpu", p_dtype=getattr(torch, p_dtype)).to_numpy()
    for name in ref._fields:
        want = (np.asarray(jax.random.key_data(ref.key)) if name == "key"
                else np.asarray(getattr(ref, name)))
        if name == "pperp":
            pt = np.asarray(ref.pb, np.float64) ** 2 + want.astype(
                np.float64) ** 2
            eps = np.finfo(want.dtype).eps
            np.testing.assert_array_less(
                np.abs(got[name].astype(np.float64) ** 2
                       - want.astype(np.float64) ** 2), 4 * eps * pt + 1e-300)
            continue
        np.testing.assert_array_equal(got[name], want, err_msg=name)


@pytest.mark.parametrize("seed", [7, 8])
def test_lane_uniforms_xla_match_xla_engine(seed):
    """The XLA engine's stream (ops/step.py _lane_uniforms: fold_in of
    the step count, then jax.random.bits): bit-exact, including a block
    of steps drawn at once."""
    from montecarloscattering_jl_tpu.ops import step as stp
    g = np.random.default_rng(seed)
    b = 400
    st = jst.init_state(np.ones(b), np.full(b, 1e-16), np.full(b, 5e-17),
                        np.zeros(b), np.zeros(b, np.int32), np.zeros(b),
                        50.0, 1e15, jax.random.fold_in(jax.random.key(9),
                                                       seed))
    nsteps = g.integers(0, 2**31 - 8, b).astype(np.int32)
    kd = np.asarray(jax.random.key_data(st.key))
    k0 = torch.from_numpy(kd[:, 0].copy().view(np.int32))
    k1 = torch.from_numpy(kd[:, 1].copy().view(np.int32))
    blk = torch.from_numpy(nsteps)[None] + torch.arange(
        3, dtype=torch.int32)[:, None]
    got = rng.lane_uniforms_xla(k0, k1, blk)
    assert got.dtype == torch.float32 and got.shape == (8, 3, b)
    for s in range(3):
        want = np.asarray(stp._lane_uniforms(
            st._replace(nsteps=jnp.asarray(nsteps + s))))
        np.testing.assert_array_equal(got[:, s].numpy().T, want)
