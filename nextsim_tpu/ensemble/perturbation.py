"""Ensemble forcing perturbations (EnKF module).

JAX equivalent of the reference's EnKF perturbation generator
(reference: modules/enkf/perturbation/src/mod_random_forcing.F90:1-813 and
mod_pseudo.F90 pseudo2D — Evensen (1994) spectral pseudo-random fields),
which is hooked into forcing loading under #ifdef ENSEMBLE (reference:
model/externaldata.cpp:244-278: perturb the loaded planes, broadcast).

Here the spatially-correlated fields are generated with `jnp.fft` directly
on device (one seed stream per ensemble member via `statevector.
ensemble_member`), evolved as an AR(1) red process in time with
alpha = exp(-dt/tcorr) (mod_random_forcing.F90:316-326:
autocorr=exp(-1), alpha=autocorr**(1/nsteps)), and applied to wind, air
temperature, SLP, precipitation and humidity with the namelist variances
(modules/enkf/perturbation/nml/pseudo2D.nml). Wind perturbations follow
prsflg=2: geostrophic winds from the SLP perturbation scaled to the target
wind variance (mod_random_forcing.F90:356-370).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from nextsim_tpu.core import constants as phys
from nextsim_tpu.ops import stencil


@dataclasses.dataclass(frozen=True)
class PerturbationParams:
    """Defaults from modules/enkf/perturbation/nml/pseudo2D.nml."""

    scorr_km: float = 1000.0  # horizontal decorrelation length [km] (scorr)
    tcorr_days: float = 2.0  # temporal decorrelation [days] (tcorr)
    vslp: float = 10.0  # SLP variance [hPa^2]
    vwndspd: float = 0.64  # wind speed variance [(m/s)^2]
    vairtmp: float = 9.0  # air temperature variance [K^2]
    vprecip: float = 1.0  # relative precip variance
    vrelhum: float = 1.0  # humidity variance (applied to dew point, K^2)
    prsflg: int = 2


def spectral_noise(key, shape, rh_cells: float):
    """One unit-variance random field with Gaussian spatial correlation of
    decorrelation length ``rh_cells`` grid cells (the jnp.fft equivalent of
    pseudo2D, mod_pseudo.F90:14-240)."""
    ny, nx = shape
    ky = jnp.fft.fftfreq(ny)[:, None]  # cycles per cell
    kx = jnp.fft.rfftfreq(nx)[None, :]
    # Gaussian spectrum: exp(-k^2 rh^2 * c); c chosen so that the spatial
    # autocorrelation at distance rh is exp(-1):
    # corr(r) = exp(-r^2/rh^2) has spectrum exp(-pi^2 k^2 rh^2) (k in cycles)
    sig2 = (math.pi * rh_cells) ** 2 / 2.0
    log_amp = -(kx**2 + ky**2) * sig2
    # normalise in log space: with rh larger than the domain every raw
    # amplitude underflows in float32, so shift by the largest non-DC mode
    log_amp = log_amp.at[0, 0].set(-jnp.inf)  # zero-mean field: no DC
    amp = jnp.exp(log_amp - jnp.max(log_amp))
    kr, kp = jax.random.split(key)
    phase = jax.random.uniform(kp, amp.shape, minval=0.0, maxval=2.0 * jnp.pi)
    # real-arithmetic inverse FFT as full-precision matmuls (ops/realfft.py)
    from nextsim_tpu.ops import realfft

    field = realfft.irfft2(amp * jnp.cos(phase), amp * jnp.sin(phase), (ny, nx))
    std = jnp.std(field) + 1e-30
    return field / std


class EnsembleForcing:
    """Wraps a forcing provider, adding per-member perturbations."""

    FIELDS = ("slp", "airtmp", "precip", "relhum")

    def __init__(self, provider, grid, cfg, params: Optional[PerturbationParams] = None, seed: int = 11):
        self.provider = provider
        self.grid = grid
        self.p = params or PerturbationParams()
        self.member = cfg["statevector.ensemble_member"]
        self.dt_days = cfg["simul.timestep"] / 86400.0
        # seed stream per member (reference: set_random_seed2 + member id)
        self.key = jax.random.PRNGKey(seed * 1000003 + self.member)
        self.rh_cells = self.p.scorr_km * 1e3 / grid.dx
        self.alpha = math.exp(-self.dt_days / self.p.tcorr_days)
        self._ran: Optional[Dict[str, jnp.ndarray]] = None

    def _draw_stack(self, key):
        """Fresh unit fields for all perturbed quantities, stacked (4,ny,nx)."""
        subs = jax.random.split(key, len(self.FIELDS))
        return jnp.stack(
            [spectral_noise(subs[i], self.grid.shape, self.rh_cells)
             for i in range(len(self.FIELDS))]
        )

    @staticmethod
    def _fit(arr, target_shape):
        """Zero-pad `arr` at the end of the trailing dims to `target_shape`
        (node forcing leaves are end-padded to shard-divisible shapes on a
        device mesh — parallel/sharding.py; an additive perturbation of 0 in
        the pad region preserves the pad semantics)."""
        if arr.shape == tuple(target_shape):
            return arr
        pads = [(0, t - s) for s, t in zip(arr.shape, target_shape)]
        return jnp.pad(arr, pads)

    def _step(self, key, ran, f):
        """One fused device program: draw fresh noise, advance the AR(1) red
        process (mod_random_forcing.F90 ran_update_ran1) and apply all
        perturbations. Keeping this a single jitted call matters: the eager
        per-field version cost ~40 dispatches/step, which through a
        high-latency accelerator link dominated the whole model step.
        Pure (key, ran, forcing) -> (key, ran, forcing): also traced inside
        the fused k-step chunk program (Simulator._build_chunk_fn), where it
        removes ALL per-step host dispatches from perturbed runs."""
        p = self.p
        key, sub = jax.random.split(key)
        fresh = self._draw_stack(sub)
        a = self.alpha
        b = math.sqrt(max(0.0, 1.0 - a * a))
        ran = a * ran + b * fresh

        idx = {n: i for i, n in enumerate(self.FIELDS)}
        slp_pert_pa = 100.0 * math.sqrt(p.vslp) * ran[idx["slp"]]  # hPa->Pa
        updates = dict(
            mslp=f.mslp + slp_pert_pa,
            tair=f.tair + math.sqrt(p.vairtmp) * ran[idx["airtmp"]],
            precip=jnp.maximum(
                0.0, f.precip * (1.0 + math.sqrt(p.vprecip) * ran[idx["precip"]])
            ),
        )
        if f.dair is not None:
            updates["dair"] = f.dair + math.sqrt(p.vrelhum) * ran[idx["relhum"]]

        if p.prsflg == 2:
            # geostrophic wind from the SLP perturbation, scaled so the wind
            # perturbation magnitude matches sqrt(vwndspd)/3
            # (mod_random_forcing.F90:356-370)
            fcor = 2.0 * math.sin(math.radians(40.0)) * 2.0 * math.pi / 86400.0
            wprsfac = 100.0 * math.sqrt(p.vslp) / (self.rh_cells * self.grid.dx)
            wprsfac = wprsfac / fcor
            wprsfac = math.sqrt(p.vwndspd) / (3.0 * wprsfac)
            dx = self.grid.dx
            dpdx = (slp_pert_pa - jnp.roll(slp_pert_pa, 1, axis=1)) / dx * wprsfac
            dpdy = (slp_pert_pa - jnp.roll(slp_pert_pa, 1, axis=0)) / dx * wprsfac
            du = -dpdy / (fcor * phys.rhoa)
            dv = dpdx / (fcor * phys.rhoa)
            # cell -> node (wind lives on nodes)
            ones = jnp.ones_like(du)
            du_n = stencil.node_mean_of_cells(du, ones)
            dv_n = stencil.node_mean_of_cells(dv, ones)
            updates["wind_u"] = f.wind_u + self._fit(du_n, f.wind_u.shape)
            updates["wind_v"] = f.wind_v + self._fit(dv_n, f.wind_v.shape)

        return key, ran, f.replace(**updates)

    # -- pure API for device-resident use inside a fused chunk program ------
    def init_state(self):
        """Initial (key, ran) perturbation carry (host call, once)."""
        key, sub = jax.random.split(self.key)
        ran = jax.jit(self._draw_stack)(sub)
        return (key, ran)

    def apply(self, pert_state, forcing):
        """Pure: advance the AR(1) carry one model step and perturb
        `forcing`. Traceable — used inside the chunk scan."""
        key, ran = pert_state
        key, ran, out = self._step(key, ran, forcing)
        return (key, ran), out

    def __call__(self, t_days: float, time_init_days: float):
        f = self.provider(t_days, time_init_days)
        if self.member <= 0:
            return f  # member 0 = unperturbed control
        if self._ran is None:
            self.key, self._ran = self.init_state()
            self._jit_step = jax.jit(self._step)
        self.key, self._ran, out = self._jit_step(self.key, self._ran, f)
        return out
