"""Floe size distribution (FSD).

Equivalent of the reference's FSD physics (reference: initFsd
fe.cpp:7399-7585; redistributeFSD fe.cpp:4268-4460; updateFSD; weldingRoach
fe.cpp:4720-4850; FSD-damage coupling): an N-bin area-based distribution
per cell, with

* wave-induced breakup redistribution (none/uniform_size/zhang/dumont,
  reference enums.hpp:110-116) driven by the coupled wave field `wlbk`
  (breaking wavelength),
* Roach et al. (2018) welding (coagulation) during freezing,
* shape-conserving rescaling to the total concentration after any process
  that changes conc (updateFSD),
* optional damage feedback (wave_coupling.fsd_damage_type).

The per-bin loops are unrolled in Python (N is 10-30, static), so under jit
everything fuses into elementwise work over (nbins, ny, nx) arrays.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np

from nextsim_tpu.core import constants as phys


@dataclasses.dataclass(frozen=True)
class FSDParams:
    num_bins: int = 0
    fsd_type: str = "constant_size"  # constant_size | constant_area
    bin_cst_width: float = 10.0  # [m]
    min_floe_size: float = 10.0  # [m]
    floe_shape: float = 0.66  # (fe.cpp:7415)
    breakup_type: str = "uniform_size"  # none|uniform_size|zhang|dumont
    breakup_prob_type: int = 0
    breakup_timescale_tuning: float = 1.0
    breakup_thick_min: float = 0.0
    breakup_cell_average_thickness: bool = False
    breakup_coef1: float = 0.5
    breakup_coef2: float = 1.0
    breakup_coef3: float = 1.0
    breakup_prob_cutoff: float = 0.0015
    welding_type: str = "none"  # none | roach
    welding_kappa: float = 0.01
    welding_use_scaled_area: bool = False
    floes_flex_young: float = 5.49e9
    distinguish_mech_fsd: bool = True
    damage_type: int = 0
    damage_max: float = 0.99
    unbroken_floe_size: float = 1000.0

    @staticmethod
    def from_config(cfg) -> "FSDParams":
        return FSDParams(
            num_bins=cfg["wave_coupling.num_fsd_bins"],
            fsd_type=cfg["wave_coupling.fsd_type"],
            bin_cst_width=cfg["wave_coupling.fsd_bin_cst_width"],
            min_floe_size=cfg["wave_coupling.fsd_min_floe_size"],
            breakup_type=cfg["wave_coupling.breakup_type"],
            breakup_prob_type=cfg["wave_coupling.breakup_prob_type"],
            breakup_timescale_tuning=cfg["wave_coupling.breakup_timescale_tuning"],
            breakup_thick_min=cfg["wave_coupling.breakup_thick_min"],
            breakup_cell_average_thickness=cfg["wave_coupling.breakup_cell_average_thickness"],
            breakup_coef1=cfg["wave_coupling.breakup_coef1"],
            breakup_coef2=cfg["wave_coupling.breakup_coef2"],
            breakup_coef3=cfg["wave_coupling.breakup_coef3"],
            breakup_prob_cutoff=cfg["wave_coupling.breakup_prob_cutoff"],
            welding_type=cfg["wave_coupling.welding_type"],
            welding_kappa=cfg["wave_coupling.welding_kappa"],
            welding_use_scaled_area=cfg["wave_coupling.fsd_welding_use_scaled_area"],
            floes_flex_young=cfg["wave_coupling.floes_flex_young"],
            distinguish_mech_fsd=cfg["wave_coupling.distinguish_mech_fsd"],
            damage_type=cfg["wave_coupling.fsd_damage_type"],
            damage_max=cfg["wave_coupling.fsd_damage_max"],
            unbroken_floe_size=cfg["wave_coupling.fsd_unbroken_floe_size"],
        )


@dataclasses.dataclass(frozen=True)
class FSDBins:
    """Static bin geometry (reference: initFsd, fe.cpp:7428-7533)."""

    low: np.ndarray  # (N,) bin lower floe-size limits [m]
    up: np.ndarray
    width: np.ndarray
    centre: np.ndarray
    area_low: np.ndarray  # floe areas [m^2]
    area_up: np.ndarray
    area_centre: np.ndarray
    area_binwidth: np.ndarray
    scaled_low: np.ndarray  # scaled areas used by welding
    scaled_up: np.ndarray
    scaled_centre: np.ndarray
    scaled_binwidth: np.ndarray
    alpha_merge: np.ndarray  # (N, N) int merge matrix (fe.cpp:7520-7533)


def make_bins(p: FSDParams) -> FSDBins:
    n = p.num_bins
    s = p.floe_shape
    if p.fsd_type == "constant_size":
        low = p.min_floe_size + p.bin_cst_width * np.arange(n)
        up = low + p.bin_cst_width
        area_low = s * low**2
        area_up = s * up**2
    else:  # constant_area (fe.cpp:7459-7483)
        binw = s * (p.bin_cst_width**2 + 2 * p.min_floe_size * p.bin_cst_width)
        area_low = s * p.min_floe_size**2 + binw * np.arange(n)
        area_up = area_low + binw
        low = np.sqrt(area_low / s)
        up = np.sqrt(area_up / s)
    width = up - low
    centre = 0.5 * (low + up)
    area_centre = s * centre**2
    area_binwidth = area_up - area_low

    lims = np.concatenate([area_low, [area_up[-1]]])
    if p.welding_use_scaled_area:
        lims_scaled = (lims - lims[0]) / area_binwidth.max()
    else:
        lims_scaled = lims - lims[0]
    scaled_low = lims_scaled[:-1]
    scaled_up = lims_scaled[1:]
    scaled_centre = 0.5 * (scaled_low + scaled_up)
    scaled_binwidth = scaled_up - scaled_low

    alpha = np.full((n, n), -999, dtype=np.int32)
    for m in range(n):
        for k in range(n):
            test = scaled_up[m] - scaled_centre[k]
            for q in range(n):
                if scaled_low[q] <= test < scaled_up[q]:
                    alpha[m, k] = q + 1
    return FSDBins(
        low=low, up=up, width=width, centre=centre,
        area_low=area_low, area_up=area_up, area_centre=area_centre,
        area_binwidth=area_binwidth,
        scaled_low=scaled_low, scaled_up=scaled_up,
        scaled_centre=scaled_centre, scaled_binwidth=scaled_binwidth,
        alpha_merge=alpha,
    )


def init_fsd(p: FSDParams, conc_total) -> jnp.ndarray:
    """All ice starts unbroken: total concentration in the last bin
    (reference: initFsd then updateFSD's empty-FSD branch)."""
    n = p.num_bins
    zeros = jnp.zeros((n,) + conc_total.shape, conc_total.dtype)
    return zeros.at[n - 1].set(conc_total)


def update_fsd(conc_fsd, ctot) -> jnp.ndarray:
    """Rescale the FSD to the (changed) total concentration, conserving its
    shape (reference: updateFSD, fe.cpp)."""
    ctot2 = conc_fsd.sum(axis=0)
    scale = ctot / jnp.maximum(ctot2, 1e-30)
    rescaled = conc_fsd * scale[None]
    # empty FSD but ice present: put everything in the unbroken bin
    empty = (ctot2 <= 0.0) & (ctot > 0.0)
    n = conc_fsd.shape[0]
    unbroken = jnp.zeros_like(conc_fsd).at[n - 1].set(ctot)
    out = jnp.where(empty[None], unbroken, rescaled)
    # keep zero where there's no ice at all
    return jnp.where((ctot > 0.0)[None], out, jnp.zeros_like(conc_fsd))


def wave_breakup(
    conc_fsd,
    thick, conc, h_young, conc_young,
    wlbk,  # breaking wavelength from the wave model [m] (>=499 -> no waves)
    dt_cpl: float,
    p: FSDParams,
    bins: FSDBins,
):
    """Wave-induced breakup redistribution (reference: redistributeFSD,
    fe.cpp:4268-4460). Returns (conc_fsd, broke) where `broke` flags cells
    where breakup occurred this step."""
    poisson = 0.3
    ctot = conc + conc_young
    p_inf = jnp.where(wlbk < 499.0, 1.0, 0.0)
    active = (ctot > 0.0) & (p_inf > p.breakup_prob_cutoff)

    if p.breakup_cell_average_thickness:
        h = thick
    else:
        h = (thick + h_young) / jnp.maximum(ctot, 1e-30)
    h = jnp.maximum(p.breakup_thick_min, h)

    # flexural-failure floe size limit (Mellor 1984 / Boutin 2018)
    d_flex = 0.5 * (
        (math.pi**4)
        * p.floes_flex_young
        * h**3
        / (48.0 * phys.rhow * phys.g * (1.0 - poisson**2))
    ) ** 0.25
    lam = wlbk
    tau_w = p.breakup_timescale_tuning

    n = p.num_bins
    out = [conc_fsd[j] for j in range(n)]
    for j in range(n):
        pj = p_inf * (1.0 - jnp.exp(-p_inf * dt_cpl / tau_w))
        lim_lambda = jnp.maximum(
            0.0, jnp.tanh((bins.centre[j] - p.breakup_coef1 * lam) / (p.breakup_coef2 * jnp.maximum(lam, 1e-3)))
        )
        lim_dflex = jnp.maximum(
            0.0, jnp.tanh((bins.centre[j] - d_flex) / (p.breakup_coef3 * jnp.maximum(d_flex, 1e-3)))
        )
        if p.breakup_type == "none":
            continue
        if p.breakup_type in ("uniform_size", "zhang"):
            pj = pj * lim_dflex * lim_lambda
            broken = jnp.where(active & (pj > 0.0), out[j] * pj, 0.0)
            out[j] = out[j] - broken
            for k in range(j + 1):
                if p.breakup_type == "zhang":
                    beta = bins.width[k] / (bins.up[j] - bins.low[0])
                else:
                    beta = (bins.up[k] ** 3 - bins.low[k] ** 3) / (
                        bins.up[j] ** 3 - bins.low[0] ** 3
                    )
                out[k] = out[k] + broken * beta
        elif p.breakup_type == "dumont":
            fragility = lim_dflex * lim_lambda
            broken = jnp.where(active & (fragility > 0.0), out[j] * pj * fragility, 0.0)
            out[j] = out[j] - broken
            frag_safe = jnp.maximum(fragility, 1e-10)
            exponent = jnp.maximum(2.0 - (2.0 + jnp.log(frag_safe) / math.log(2.0)), 1e-6)
            for k in range(j + 1):
                beta = (bins.up[k] ** exponent - bins.low[k] ** exponent) / (
                    bins.up[j] ** exponent - bins.low[0] ** exponent
                )
                out[k] = out[k] + broken * beta
        else:
            raise ValueError(p.breakup_type)
    return jnp.stack(out), active


def welding_roach(conc_fsd, dt: float, p: FSDParams, bins: FSDBins, freezing):
    """Roach et al. (2018) coagulation during freezing (reference:
    weldingRoach, fe.cpp:4720-4850). Vectorised over cells with the
    reference's per-cell sub-time stepping expressed as a fixed number of
    masked substeps."""
    n = p.num_bins
    ctot = conc_fsd.sum(axis=0)
    c_broken = conc_fsd[:-1].sum(axis=0)
    active = freezing & (c_broken > 0.01) & (ctot > 0.1)

    # stability limit -> per-cell substep count (fe.cpp:4754-4757). The
    # reference's count can reach O(1e4) with unscaled areas; we cap the
    # loop (lax.fori_loop, traced once) — the coagulation equilibrates long
    # before the cap at these rates.
    stability = dt * p.welding_kappa * ctot * bins.scaled_up[-1]
    ndt = jnp.ceil(stability + 0.5)
    ndt_max = 256
    ndt = jnp.clip(ndt, 1.0, float(ndt_max))
    subdt = dt / ndt

    from jax import lax

    def substep(t, c):
        live = active & (t < ndt)
        coag = []
        for kx in range(n):
            acc = jnp.zeros_like(ctot)
            for ky in range(kx + 1):
                a = int(bins.alpha_merge[kx, ky])
                if a < 1:
                    continue
                sum_mergers = jnp.zeros_like(ctot)
                if a < n:
                    sum_mergers = c[a:].sum(axis=0)
                part = (c[a - 1] / max(bins.scaled_binwidth[a - 1], 1e-30)) * (
                    bins.scaled_up[a - 1] - bins.scaled_up[kx] + bins.scaled_centre[ky]
                )
                acc = acc + bins.scaled_centre[ky] * c[ky] * ctot * (sum_mergers + part)
            coag.append(acc)
        coag = jnp.stack(coag)
        # bin m loses coag[m], gains coag[m-1] (fe.cpp:4796-4803)
        gain = jnp.concatenate([jnp.zeros_like(coag[:1]), coag[:-1]])
        upd = c - subdt[None] * p.welding_kappa * (coag - gain)
        return jnp.where(live[None], jnp.maximum(upd, 0.0), c)

    return lax.fori_loop(0, ndt_max, substep, conc_fsd)


def fsd_damage(conc_fsd, damage, p: FSDParams, broke):
    """Optional damage feedback from breakup (wave_coupling.fsd_damage_type:
    1 = from the broken-area fraction; 2 = binary on breakup)."""
    if p.damage_type == 0:
        return damage
    ctot = conc_fsd.sum(axis=0)
    broken_frac = jnp.where(
        ctot > 0.0, conc_fsd[:-1].sum(axis=0) / jnp.maximum(ctot, 1e-30), 0.0
    )
    if p.damage_type == 1:
        target = p.damage_max * broken_frac
    else:
        target = p.damage_max
    return jnp.where(broke, jnp.maximum(damage, target), damage)


def dmax_dmean(conc_fsd, p: FSDParams, bins: FSDBins, threshold: float = 0.1):
    """Diagnostics: max floe size (9th decile by default) and mean floe size
    (reference: Dmax/Dmean gridoutput variables)."""
    ctot = conc_fsd.sum(axis=0)
    frac = conc_fsd / jnp.maximum(ctot, 1e-30)[None]
    cum = jnp.cumsum(frac, axis=0)
    # dmax: first bin where cumulative fraction exceeds (1 - threshold)
    over = cum >= (1.0 - threshold)
    idx = jnp.argmax(over, axis=0)
    centre = jnp.asarray(bins.centre, conc_fsd.dtype)
    dmax = centre[idx]
    dmean = (frac * centre[:, None, None]).sum(axis=0)
    has = ctot > 0.0
    return jnp.where(has, dmax, 0.0), jnp.where(has, dmean, 0.0)


def lateral_melt_type3(
    conc_fsd, conc, conc_young, h_young, hi, hs, qow, tw_new, tfrw,
    del_hi, dt: float, PhiM: float, h_young_min: float, p: FSDParams,
    bins: FSDBins,
):
    """FSD-dependent lateral melt — thermo melt_type=3 (reference:
    fe.cpp:5596-5649, Roach et al. 2018 / Horvat & Tziperman 2015).

    Returns (del_c, del_c_young, qow, lat_melt_rate):
    * unbroken cells (all area in the last bin) follow the melt_type=2
      Mellor & Kantha form;
    * broken cells melt laterally at W = -2*m1*(Tw-Tf)^m2 weighted by the
      perimeter density of each floe-size bin.
    """
    qi = phys.Lf * phys.rhoi
    qs = phys.Lf * phys.rhos
    m1, m2 = 3.0e-6, 1.36  # MIZEX 84 fit (fe.cpp:5607-5610)

    ctot = conc + conc_young
    melting = (del_hi < 0.0) & (tw_new > tfrw) & (hi > 0.0) & (ctot > 1e-11)

    h0 = jnp.where(
        conc_young > 0.0,
        h_young_min + 2.0 * (h_young - h_young_min * conc_young)
        / jnp.maximum(conc_young, 1e-30),
        0.0,
    )

    unbroken = jnp.abs(conc_fsd[-1] - ctot) < 1e-7

    # --- unbroken: melt_type 2 behaviour (fe.cpp:5617-5626) ---------------
    del_c2 = PhiM * (1.0 - ctot) * jnp.minimum(0.0, qow) * dt / jnp.maximum(
        hi * qi + hs * qs, 1e-30
    )
    del_c2 = jnp.maximum(del_c2, -ctot)
    qow_unbroken = qow * (1.0 - PhiM)

    # --- broken: perimeter-weighted lateral melt (fe.cpp:5628-5641) -------
    dT = jnp.maximum(tw_new - tfrw, 0.0)
    lat_melt_rate = -2.0 * m1 * _fast_pow_arr(dT, m2)  # <0 [m/s]
    cat0 = lat_melt_rate * conc_fsd[0] / bins.width[0] * dt
    del_c3 = cat0
    for j in range(p.num_bins - 1):
        del_c3 = del_c3 + lat_melt_rate * (conc_fsd[j] * 2.0 / bins.centre[j]) * dt
    qow_broken = qow - del_c3 * (hi * qi * conc + h0 * qi * conc_young) / (
        dt * jnp.maximum(ctot, 1e-30)
    )

    del_c_melt = jnp.where(melting, jnp.where(unbroken, del_c2, del_c3), 0.0)
    qow = jnp.where(melting, jnp.where(unbroken, qow_unbroken, qow_broken), qow)
    lat_melt_rate = jnp.where(melting & (~unbroken), lat_melt_rate, 0.0)

    del_c = (conc / jnp.maximum(ctot, 1e-30)) * del_c_melt
    del_c_young = (conc_young / jnp.maximum(ctot, 1e-30)) * del_c_melt
    return del_c, del_c_young, qow, lat_melt_rate


def _fast_pow_arr(x, e: float):
    """x**e for x>=0 via exp/log with the x==0 lane fixed to 0."""
    safe = jnp.maximum(x, 1e-30)
    return jnp.where(x > 0.0, jnp.exp(e * jnp.log(safe)), 0.0)


def redistribute_thermo_fsd(conc_fsd, lat_melt_rate, dt: float, p: FSDParams, bins: FSDBins):
    """FSD evolution under lateral melt/growth (reference:
    redistributeThermoFSD, fe.cpp:4460-4560; Horvat & Tziperman 2015):
    advection of the distribution in floe-size space plus the perimeter
    area-loss term."""
    n = p.num_bins
    active = jnp.abs(lat_melt_rate) > 0.0

    # number-density gradient d(c/width)/dr with no transfer from unbroken
    fsd_dr = [jnp.zeros_like(conc_fsd[0])]
    for m in range(1, n - 1):
        fsd_dr.append(conc_fsd[m] / bins.width[m])
    fsd_dr.append(jnp.zeros_like(conc_fsd[0]))
    fsd_dr.append(jnp.zeros_like(conc_fsd[0]))  # index n

    out = [conc_fsd[m] for m in range(n)]
    for m in range(n - 1):
        dfsd = fsd_dr[m + 1] - fsd_dr[m]
        delta = dt * lat_melt_rate * (-dfsd + conc_fsd[m] * 2.0 / bins.centre[m])
        out[m] = jnp.where(active, out[m] + delta, out[m])
    # smallest bin loses area out of the distribution when melting
    cat0 = lat_melt_rate * conc_fsd[0] / bins.width[0] * dt
    out[0] = jnp.where(active & (lat_melt_rate < 0.0), out[0] + cat0, out[0])
    # growth: flux into the unbroken bin
    grow = bins.width[n - 1]
    out[n - 1] = jnp.where(
        active & (lat_melt_rate > 0.0),
        out[n - 1] + conc_fsd[n - 1] / grow * dt * lat_melt_rate,
        out[n - 1],
    )
    return jnp.stack([jnp.maximum(o, 0.0) for o in out])
