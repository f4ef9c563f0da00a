"""Structure-of-arrays particle state, tallies and segment records.

Counterpart of the JAX package's ops/state.py (ParticleState, Tallies,
init_state, make_tallies, finalize_tallies) and of the segment records
of its ops/step.py (SegmentGrids, SegmentScalars, StepStatic), as plain
dataclasses of torch tensors.

Layout follows the megakernel's packed state (pallas_step.py:1372-1421):
the four per-lane booleans ride one int32 ``flags`` plane and the
per-lane key is two int32 planes (``key0``, ``key1``).  Positions, PRP
and acceleration time are float64 by contract; momenta are float32 on
K1's path and float64 on the XLA engine's (ops/step.py) by default.
The XLA engine's record buffer (``rec``, ``step_phase``) has no
counterpart: both engines deposit every crossing straight into the full
difference arrays, and the pool and tcut tallies likewise.

``from_jax_numpy`` / ``to_numpy`` carry state, tallies, grids and
scalars across from the JAX package (given as NumPy arrays, the key as
``jax.random.key_data``), so tests feed both packages the same inputs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields

import numpy as np
import torch

from . import rng

# status codes
ACTIVE = 0
SAVED = 1      # hit the pcut splitting momentum
FINISHED = 2   # left the system; `reason` holds the exit reason

# reason codes (particle_finish.jl:80-105)
R_DOWNSTREAM = 1
R_UPSTREAM_PMAX = 2
R_AGE = 3
R_RADIATED = 4

# flag bits of the `flags` plane (pallas_step.py:107)
FL_DW, FL_INJ, FL_RETRO, FL_JRET = 1, 2, 4, 8

# slots of Tallies.counts, the port's own diagnostics
C_RETRO, C_RECV, C_RAD = 0, 1, 2
N_COUNTS = 3
_FLAG_FIELDS = (("downstream", FL_DW), ("inj", FL_INJ),
                ("retro", FL_RETRO), ("just_returned", FL_JRET))

X_DTYPE = torch.float64


def _tensor_fields(obj):
    return {f.name: getattr(obj, f.name) for f in fields(obj)}


@dataclass
class ParticleState:
    """Per-lane particle state ([B] tensors)."""

    weight: torch.Tensor     # fraction of far-upstream density
    pb: torch.Tensor         # plasma-frame p parallel to B [g cm/s]
    pperp: torch.Tensor      # plasma-frame p perpendicular to B
    phi: torch.Tensor        # gyro phase [rad]
    x: torch.Tensor          # position [cm], float64
    igrid: torch.Tensor      # boundary index, int32
    ux_prev: torch.Tensor    # zone flow speed seen last step [cm/s]
    xn_per: torch.Tensor     # steps per gyroperiod
    prp_x: torch.Tensor      # probability-of-return plane [cm], float64
    acctime: torch.Tensor    # acceleration time [s], float64
    tcut: torch.Tensor       # next tcut slot, int32
    status: torch.Tensor     # ACTIVE / SAVED / FINISHED, int32
    reason: torch.Tensor     # exit reason when FINISHED, int32
    nsteps: torch.Tensor     # per-lane helix step count, int32
    flags: torch.Tensor      # FL_* bits, int32
    key0: torch.Tensor       # per-lane key word 0 (uint32 bits), int32
    key1: torch.Tensor       # per-lane key word 1
    t_step: torch.Tensor     # last movement time step [s]

    @property
    def device(self) -> torch.device:
        return self.weight.device

    @classmethod
    def from_jax_numpy(cls, f: dict, device="cpu") -> "ParticleState":
        """From the JAX ParticleState's fields as NumPy arrays (``key``
        given as ``jax.random.key_data``, [B, 2] uint32)."""
        dev = torch.device(device)
        t = lambda a, dt: torch.from_numpy(np.array(a)).to(dev, dt)
        p_dtype = torch.from_numpy(np.zeros(0, np.asarray(f["pb"]).dtype)
                                   ).dtype
        flags = np.zeros(np.asarray(f["status"]).shape, np.int32)
        for name, bit in _FLAG_FIELDS:
            flags |= np.asarray(f[name]).astype(np.int32) * bit
        kd = np.asarray(f["key"]).astype(np.uint32)
        return cls(
            weight=t(f["weight"], p_dtype), pb=t(f["pb"], p_dtype),
            pperp=t(f["pperp"], p_dtype), phi=t(f["phi"], p_dtype),
            x=t(f["x"], X_DTYPE), igrid=t(f["igrid"], torch.int32),
            ux_prev=t(f["ux_prev"], p_dtype),
            xn_per=t(f["xn_per"], p_dtype),
            prp_x=t(f["prp_x"], X_DTYPE),
            acctime=t(f["acctime"], X_DTYPE),
            tcut=t(f["tcut"], torch.int32),
            status=t(f["status"], torch.int32),
            reason=t(f["reason"], torch.int32),
            nsteps=t(f["nsteps"], torch.int32),
            flags=t(flags, torch.int32),
            key0=t(kd[:, 0].view(np.int32), torch.int32),
            key1=t(kd[:, 1].view(np.int32), torch.int32),
            t_step=t(f["t_step"], p_dtype))

    def to_numpy(self) -> dict:
        """The JAX ParticleState's fields as NumPy arrays (``key`` as
        [B, 2] uint32 key data)."""
        out = {k: v.detach().cpu().numpy() for k, v in
               _tensor_fields(self).items()
               if k not in ("flags", "key0", "key1")}
        flags = self.flags.cpu().numpy()
        for name, bit in _FLAG_FIELDS:
            out[name] = (flags & bit) != 0
        out["key"] = np.stack([self.key0.cpu().numpy().view(np.uint32),
                               self.key1.cpu().numpy().view(np.uint32)],
                              axis=1)
        return out


def clone(obj):
    """A copy of a ParticleState or Tallies with every tensor cloned."""
    return dataclasses.replace(obj, **{
        k: v.clone() for k, v in _tensor_fields(obj).items()
        if isinstance(v, torch.Tensor)})


def copy_into(dst, src):
    """Copy every tensor of `src` (a ParticleState or Tallies) into the
    same field of `dst`, in place; returns `dst`."""
    for k, v in _tensor_fields(dst).items():
        if isinstance(v, torch.Tensor):
            v.copy_(getattr(src, k))
    return dst


def upload(arrays: list, device) -> list:
    """Host arrays on `device` through one host-to-device copy, where a
    copy each would make the host wait once each: the arrays are laid
    out in one byte buffer (each at an 8-byte boundary), copied, and
    handed back as views of their dtypes and shapes."""
    arrays = [np.asarray(a, order="C") for a in arrays]
    offsets, end = [], 0
    for a in arrays:
        end = -(-end // 8) * 8
        offsets.append(end)
        end += a.nbytes
    buf = np.zeros(-(-end // 8) * 8, np.uint8)
    for a, o in zip(arrays, offsets):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev_buf = torch.from_numpy(buf).to(device)
    dtype = lambda a: torch.from_numpy(np.zeros(0, a.dtype)).dtype
    return [dev_buf[o:o + a.nbytes].view(dtype(a)).view(a.shape)
            for a, o in zip(arrays, offsets)]


def init_state(weight, ptot_pf, pb_pf, x_cm, igrid, ux_of_igrid,
               xn_per_fine: float, prp_x0, seg_key: tuple[int, int],
               device, phi=None, downstream=None, inj=None,
               acctime=None, tcut=None, xn_per=None,
               p_dtype=torch.float32) -> ParticleState:
    """Build a [B] state from an injected population (host arrays).

    Mirrors the JAX init_state (assign_particle_properties_to_population!,
    ion_init.jl:29-53): fresh particles start not-downstream,
    not-injected, with the fine time step, PRP at ``prp_x0`` and the
    random phase of ``rng.initial_phase``.  Zero-weight lanes are
    padding and start FINISHED."""
    dev = torch.device(device)
    b = len(weight)
    t = lambda a, dt: torch.from_numpy(np.array(a)).to(dev, dt)
    weight = t(weight, p_dtype)
    ptot = t(ptot_pf, p_dtype)
    pb = t(pb_pf, p_dtype)
    pperp = torch.sqrt(torch.clamp(ptot * ptot - pb * pb, min=0.0))
    key0, key1 = rng.fold_in_lanes(seg_key, b, dev)
    if phi is None:
        phi = rng.initial_phase(key0, key1)
    flags = torch.zeros(b, dtype=torch.int32, device=dev)
    if downstream is not None:
        flags |= t(downstream, torch.int32) * FL_DW
    if inj is not None:
        flags |= t(inj, torch.int32) * FL_INJ
    zeros_i = lambda: torch.zeros(b, dtype=torch.int32, device=dev)
    return ParticleState(
        weight=weight, pb=pb, pperp=pperp,
        phi=torch.as_tensor(phi).to(dev, p_dtype),
        x=t(x_cm, X_DTYPE), igrid=t(igrid, torch.int32),
        ux_prev=t(ux_of_igrid, p_dtype),
        xn_per=(torch.full((b,), xn_per_fine, dtype=p_dtype, device=dev)
                if xn_per is None else t(xn_per, p_dtype)),
        prp_x=torch.full((b,), float(prp_x0), dtype=X_DTYPE, device=dev),
        acctime=(torch.zeros(b, dtype=X_DTYPE, device=dev)
                 if acctime is None else t(acctime, X_DTYPE)),
        tcut=zeros_i() if tcut is None else t(tcut, torch.int32),
        status=torch.where(weight <= 0.0, FINISHED, ACTIVE).to(torch.int32),
        reason=zeros_i(), nsteps=zeros_i(), flags=flags,
        key0=key0, key1=key1,
        t_step=torch.zeros(b, dtype=p_dtype, device=dev))


@dataclass
class Tallies:
    """Per-species accumulators in difference form over the boundary
    axis (length nb + 1); ``finalize_tallies`` prefix-sums them.

    * flux_diff [4, nb+1] f64: (pxx, pxz, energy, n_crossings);
    * psd_diff [(n_mom+1)*2*(n_theta+1), nb+1]: the CR (kind 0) and
      thermal (kind 1) histograms on one (ip, kind, jt) cell axis;
    * esc [4] f64: px_esc_up, en_esc_up, sum_p_dw, sum_ke_dw;
    * spectra_sf, spectra_pf [n_mom+1, max(n_xspec, 1)] f64: the x_spec
      detector spectra in the shock and plasma frames;
    * pool_diff [nb+1] f64: the ions' donated energy [erg] in difference
      form (do_energy_transfer);
    * weight_coupled [n_tcut_slots] and spectra_coupled [n_mom+1,
      n_tcut_slots] f64: the weight crossing each tcut, and its
      plasma-frame momentum spectrum (do_tcuts);
    * counts [N_COUNTS] f64, the port's own: entries into the retro walk
      (C_RETRO), the energy [erg, weighted] electrons received from the
      pool (C_RECV) and the energy they radiated (C_RAD), each lane's
      change of gamma in its momentum dtype times m c^2 and its weight."""

    flux_diff: torch.Tensor
    psd_diff: torch.Tensor
    esc: torch.Tensor
    n_mom: int
    spectra_sf: torch.Tensor
    spectra_pf: torch.Tensor
    pool_diff: torch.Tensor
    weight_coupled: torch.Tensor
    spectra_coupled: torch.Tensor
    counts: torch.Tensor

    ESC_FIELDS = ("px_esc_up", "en_esc_up", "sum_p_dw", "sum_ke_dw")

    @classmethod
    def from_jax_numpy(cls, f: dict, device="cpu") -> "Tallies":
        dev = torch.device(device)
        f64 = lambda a: torch.from_numpy(np.array(a, np.float64)).to(dev)
        return cls(
            flux_diff=torch.from_numpy(np.array(f["flux_diff"],
                                                np.float64)).to(dev),
            psd_diff=torch.from_numpy(np.array(f["psd_diff"])).to(dev),
            esc=torch.tensor([float(f[k]) for k in cls.ESC_FIELDS],
                             dtype=torch.float64, device=dev),
            n_mom=int(np.asarray(f["spectra_sf"]).shape[0]) - 1,
            spectra_sf=f64(f["spectra_sf"]), spectra_pf=f64(f["spectra_pf"]),
            pool_diff=f64(f["pool_diff"]),
            weight_coupled=f64(f["weight_coupled"]),
            spectra_coupled=f64(f["spectra_coupled"]),
            counts=torch.zeros(N_COUNTS, dtype=torch.float64, device=dev))

    def to_numpy(self) -> dict:
        out = {k: getattr(self, k).cpu().numpy()
               for k in ("flux_diff", "psd_diff", "spectra_sf", "spectra_pf",
                         "pool_diff", "weight_coupled", "spectra_coupled")}
        esc = self.esc.cpu().numpy()
        for i, k in enumerate(self.ESC_FIELDS):
            out[k] = esc[i]
        return out


def make_tallies(nb: int, n_mom: int, n_theta: int, device,
                 n_xspec: int = 0, n_tcut_slots: int = 1) -> Tallies:
    dev = torch.device(device)
    f64 = lambda *s: torch.zeros(s, dtype=torch.float64, device=dev)
    return Tallies(
        flux_diff=f64(4, nb + 1),
        psd_diff=torch.zeros((n_mom + 1) * 2 * (n_theta + 1), nb + 1,
                             dtype=torch.float32, device=dev),
        esc=f64(4), n_mom=n_mom,
        spectra_sf=f64(n_mom + 1, max(n_xspec, 1)),
        spectra_pf=f64(n_mom + 1, max(n_xspec, 1)),
        pool_diff=f64(nb + 1),
        weight_coupled=f64(max(n_tcut_slots, 1)),
        spectra_coupled=f64(n_mom + 1, max(n_tcut_slots, 1)),
        counts=f64(N_COUNTS))


@dataclass
class FinalTallies:
    """Prefix-summed (per-boundary) tallies."""

    pxx_flux: torch.Tensor     # [nb]
    pxz_flux: torch.Tensor
    energy_flux: torch.Tensor
    num_crossings: torch.Tensor
    psd: torch.Tensor          # [n_mom+1, n_theta+1, nb]
    therm_psd: torch.Tensor
    px_esc_up: torch.Tensor
    en_esc_up: torch.Tensor
    sum_p_dw: torch.Tensor
    sum_ke_dw: torch.Tensor
    spectra_sf: torch.Tensor     # [n_mom+1, max(n_xspec, 1)]
    spectra_pf: torch.Tensor
    weight_coupled: torch.Tensor     # [n_tcut_slots]
    spectra_coupled: torch.Tensor    # [n_mom+1, n_tcut_slots]
    energy_pool: torch.Tensor        # [nb]
    retro_entries: torch.Tensor      # 0-dim
    energy_received: torch.Tensor    # 0-dim
    energy_radiated: torch.Tensor    # 0-dim


def finalize_tallies(t: Tallies) -> FinalTallies:
    """Prefix-sum the difference-form accumulators into per-boundary
    totals (all_flux.jl:219-257)."""
    flux = torch.cumsum(t.flux_diff, dim=-1)[:, :-1]
    nmp1 = t.n_mom + 1
    ntp1 = t.psd_diff.shape[0] // (2 * nmp1)
    psd4 = t.psd_diff.reshape(nmp1, 2, ntp1, -1).permute(1, 0, 2, 3)
    psd = torch.cumsum(psd4, dim=-1)[..., :-1]
    return FinalTallies(
        pxx_flux=flux[0], pxz_flux=flux[1], energy_flux=flux[2],
        num_crossings=flux[3], psd=psd[0], therm_psd=psd[1],
        px_esc_up=t.esc[0], en_esc_up=t.esc[1],
        sum_p_dw=t.esc[2], sum_ke_dw=t.esc[3],
        spectra_sf=t.spectra_sf, spectra_pf=t.spectra_pf,
        weight_coupled=t.weight_coupled, spectra_coupled=t.spectra_coupled,
        energy_pool=torch.cumsum(t.pool_diff, dim=0)[:-1],
        retro_entries=t.counts[C_RETRO], energy_received=t.counts[C_RECV],
        energy_radiated=t.counts[C_RAD])


@dataclass
class SegmentGrids:
    """Per-boundary arrays (length nb) on the device: positions f64,
    fields in the momentum dtype; ``x_spec`` holds the detector
    positions [max(n_xspec, 1)] in f64, ``tcuts`` the tcut times
    [n_tcut_slots] in f64 (padded with +inf), ``eps_target`` the
    electron heating target [nb] in the momentum dtype and
    ``recv_prefix`` the prefix sum of the received-energy pool [nb+1]
    in f64 (ops/step.py:92-96 of the JAX package)."""

    x_grid: torch.Tensor
    ux: torch.Tensor
    uz: torch.Tensor
    utot: torch.Tensor
    gamma_sf: torch.Tensor
    gamma_ef: torch.Tensor
    btot: torch.Tensor
    b_cos: torch.Tensor
    b_sin: torch.Tensor
    x_spec: torch.Tensor
    tcuts: torch.Tensor
    eps_target: torch.Tensor
    recv_prefix: torch.Tensor

    _F64 = ("x_grid", "x_spec", "tcuts", "recv_prefix")

    @classmethod
    def from_jax_numpy(cls, f: dict, device="cpu",
                       p_dtype=torch.float32) -> "SegmentGrids":
        dev = torch.device(device)
        kw = {}
        for fl in fields(cls):
            dt = X_DTYPE if fl.name in cls._F64 else p_dtype
            kw[fl.name] = torch.from_numpy(np.array(f[fl.name])).to(dev, dt)
        return cls(**kw)

    def to_numpy(self) -> dict:
        return {k: v.cpu().numpy() for k, v in _tensor_fields(self).items()}


@dataclass(frozen=True)
class SegmentScalars:
    """Scalars that change between segments (species / pcut), as host
    floats.  The kernel reads the momentum-domain ones in float32 and
    the position/time ones in float64."""

    aa: float
    abs_charge: float
    m: float
    pcut: float
    pcut_prev: float
    pmax_cutoff: float
    u2: float
    bmag2: float
    b_cmbz: float
    gamma0_u0: float
    feb_up: float
    feb_dw: float
    x_grid_stop: float
    age_max: float
    pe_crit: float
    gamma_e_crit: float
    inj_frac: float

    @classmethod
    def from_jax_numpy(cls, f: dict) -> "SegmentScalars":
        return cls(**{fl.name: float(np.asarray(f[fl.name]))
                      for fl in fields(cls)})

    def to_numpy(self) -> dict:
        return {fl.name: np.float64(getattr(self, fl.name))
                for fl in fields(self)}


@dataclass(frozen=True)
class StepStatic:
    """Static configuration of the transport kernel (the JAX
    StepStatic, ops/step.py:122-171, without the TPU tally-band
    fields)."""

    eta_mfp: float
    xn_per_coarse: float
    xn_per_fine: float
    dont_scatter: bool
    dont_dsa: bool
    do_rad_losses: bool
    do_retro: bool
    do_tcuts: bool
    use_custom_eps_b: bool
    is_electron: bool
    do_energy_transfer: bool
    electron_weight_fac: float
    n_xspec: int
    i_grid_feb: int
    i_shock: int
    nb: int
    psd_mom_min: float
    bins_per_dec_mom: int
    n_mom: int
    cos_fine: float
    dcos: float
    theta_min: float
    bins_per_dec_theta: int
    n_theta: int
    parallel: bool = True
    frg_alpha: float = 1.0
    frg_rg0_cm: float = 0.0

    @classmethod
    def from_jax(cls, ss) -> "StepStatic":
        """From the JAX StepStatic (a frozen dataclass of host values)."""
        return cls(**{fl.name: getattr(ss, fl.name) for fl in fields(cls)})

