"""Thermodynamics: bulk fluxes, ice growth/melt, slab ocean, tracers.

Vectorised (whole-grid elementwise) transcription of the reference's
per-element thermo pipeline (reference: FiniteElement::thermo,
model/finiteelement.cpp:5170-6148):

* specific humidity schemes           (fe.cpp:4965-5020)
* open-water bulk fluxes              (OWBulkFluxes, fe.cpp:5032-5170)
* ice-atmosphere bulk fluxes with Monin-Obukhov stability (Grachev
  constants) and albedo schemes       (IABulkFluxes, fe.cpp:6148-6359;
  albedo, fe.cpp:6454-6538)
* zero-layer Semtner ice slab         (thermoIce0, fe.cpp:6860-6962)
* Winton 3-layer ice slab             (thermoWinton, fe.cpp:6633-6855)
* melt ponds                          (meltPonds, fe.cpp:6538-6633)
* the slab driver: new-ice formation, lateral melt, young-ice category,
  slab-ocean SST/SSS update, MYI/age tracers, D_* diagnostics
  (fe.cpp:5283-6148)

Everything is branch-free jnp (`where` in place of if/else), so the whole
step fuses into a handful of elementwise kernels under jit. All formulas cite the
reference line they transcribe; deliberate oddities of the reference (e.g.
the del_hs_mlt accumulation across bottom+surface melt in thermoWinton) are
kept for parity.
"""

from __future__ import annotations

import math
from typing import Dict

import jax.numpy as jnp

from nextsim_tpu.core import constants as phys
from nextsim_tpu.model.params_thermo import ThermoParams
from nextsim_tpu.ops import stencil

# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------


def freezing_point(p: ThermoParams, sss):
    """(reference: fe.cpp freezingPoint)"""
    if p.freezingpoint_type == "unesco":
        return (-0.0575 + 1.710523e-3 * jnp.sqrt(jnp.maximum(sss, 1e-12)) - 2.154996e-4 * sss) * sss
    return -p.freezingpoint_mu * sss


def specific_humidity_air(p: ThermoParams, forcing):
    """Atmosphere specific humidity (reference: fe.cpp:4979-5007,
    scheme ATMOSPHERE): priority sphuma > mixrat > dew point."""
    if forcing.sphuma is not None:
        return jnp.maximum(0.0, forcing.sphuma)
    if forcing.mixrat is not None:
        return forcing.mixrat / (1.0 + forcing.mixrat)
    A, B, C = 7.2e-4, 3.20e-6, 5.9e-10
    a, b, c, d = 6.1121e2, 18.729, 257.87, 227.3
    alpha, beta = 0.62197, 0.37803
    temp = forcing.dair
    f = 1.0 + A + forcing.mslp * 1e-2 * (B + C * temp * temp)
    est = a * jnp.exp((b - temp / d) * temp / (temp + c))
    return alpha * f * est / (forcing.mslp - beta * f * est)


def specific_humidity_water(sst):
    """Saturation humidity at the ocean surface (reference: fe.cpp:4992-4995)."""
    return 640380.0 / phys.rhoa * jnp.exp(-5107.4 / (sst + phys.tfrwK))


def specific_humidity_ice(mslp, tsurf):
    """(sphum, dsphum/dT) at the ice surface (reference: fe.cpp:4996-5020)."""
    A, B, C = 2.2e-4, 3.83e-6, 6.4e-10
    a, b, c, d = 6.1115e2, 23.036, 279.82, 333.7
    alpha, beta = 0.62197, 0.37803
    temp = tsurf
    f = 1.0 + A + mslp * 1e-2 * (B + C * temp * temp)
    est = a * jnp.exp((b - temp / d) * temp / (temp + c))
    sphum = alpha * f * est / (mslp - beta * f * est)
    dfdT = 2.0 * C * B * temp
    destdT = (b * c * d - temp * (2.0 * c + temp)) / (d * (c + temp) ** 2) * est
    dsphumdT = alpha * mslp * (f * destdT + est * dfdT) / (mslp - beta * est * f) ** 2
    return sphum, dsphumdT


def incoming_longwave(p: ThermoParams, forcing, tice0):
    """(reference: incomingLongwave, fe.cpp:6374-6394): measured QLW_IN or
    the Idso & Jackson (1969) cloud parameterisation."""
    if forcing.qlw_in is not None:
        return forcing.qlw_in
    taa = forcing.tair + phys.tfrwK
    return (
        phys.sigma_sb
        * taa**4
        * (1.0 - 0.261 * jnp.exp(-7.77e-4 * (taa - phys.tfrwK) ** 2))
        * (1.0 + 0.275 * forcing.tcc)
    )


def wind_speed_cells(forcing):
    """Element wind speed = mean of node |wind| (reference:
    windSpeedElement, fe.cpp:6361-6373)."""
    u, v = forcing.wind_u, forcing.wind_v
    return stencil.cell_mean_of_nodes(jnp.sqrt(u * u + v * v + 1e-20))


def air_density(mslp, tair, sphuma):
    """(reference: fe.cpp:5113, 6228)"""
    return (
        mslp
        / (phys.Ra_dry * (tair + phys.tfrwK))
        * (1.0 - sphuma * (1.0 - phys.Ra_vap / phys.Ra_dry))
    )


# ---------------------------------------------------------------------------
# Open-water bulk fluxes (reference: OWBulkFluxes, fe.cpp:5032-5170)
# ---------------------------------------------------------------------------


def ow_bulk_fluxes(p: ThermoParams, state, forcing, wspeed, sphuma):
    sst = state.sst
    sphumw = specific_humidity_water(sst)
    rhoair = air_density(forcing.mslp, forcing.tair, sphuma)

    qsh = (
        p.drag_ocean_t
        * rhoair
        * (phys.cpa + sphuma * phys.cpv)
        * wspeed
        * (sst - forcing.tair)
    )
    lv = phys.Lv0 - 2.36418e3 * sst + 1.58927 * sst**2 - 6.14342e-2 * sst**3
    # condensation capped at 0 (frost-flower trick, fe.cpp:5128-5131)
    qlh = jnp.maximum(p.drag_ocean_q * phys.rhoa * lv * wspeed * (sphumw - sphuma), 0.0)
    evap = qlh / lv
    # Gill (1982)/Smith (1980) momentum drag (fe.cpp:5141-5143)
    drag_ocean_m = 1e-3 * jnp.clip(0.61 + 0.063 * wspeed, 1.0, 2.0)
    tau_ow = rhoair * drag_ocean_m

    qsw = -forcing.qsw_in * (1.0 - p.ocean_albedo)
    qlw_out = phys.eps * phys.sigma_sb * (sst + phys.tfrwK) ** 4
    qlw = qlw_out - incoming_longwave(p, forcing, state.tice[0])
    qow = qlw + qsh + qlh + _qsw_into_slab(forcing, qsw)
    return dict(qow=qow, qlw=qlw, qsw=qsw, qlh=qlh, qsh=qsh, evap=evap, tau_ow=tau_ow)


def _qsw_into_slab(forcing, qsw):
    """Shortwave entering the slab-ocean heat budget. Coupled runs receive
    the fraction absorbed in the mixed layer from the ocean model and the
    slab only sees that share — the `qsw` diagnostic stays the TOTAL flux
    delivered to the ocean (reference: Qow[i] += Qsw[i]*M_qsrml[i],
    fe.cpp:5148-5156; received as I_FrcQsr, fe.cpp:7781)."""
    if forcing.qsrml is None:
        return qsw
    return qsw * forcing.qsrml


# ---------------------------------------------------------------------------
# Albedo (reference: albedo, fe.cpp:6454-6538)
# ---------------------------------------------------------------------------


def albedo(p: ThermoParams, tsurf, hs, frac_pnd):
    scheme = p.alb_scheme
    if scheme in (1, 2):
        snow = hs > 0.0
        if scheme == 2:
            alb_s = jnp.minimum(p.alb_sn, p.alb_ice + (p.alb_sn - p.alb_ice) * hs / 0.2)
        else:
            alb_s = jnp.full_like(hs, p.alb_sn)
        alb = jnp.where(snow, alb_s, p.alb_ice)
        pen_sw = jnp.where(snow, 0.0, p.I_0)
        return alb, pen_sw
    if scheme == 3:
        warm = tsurf > -1.0
        albi = jnp.where(warm, p.alb_ice - 0.075 * (tsurf + 1.0), p.alb_ice)
        albs = jnp.where(warm, p.alb_sn - 0.124 * (tsurf + 1.0), p.alb_sn)
        frac_sn = hs / (hs + 0.02)
        alb = frac_sn * albs + frac_pnd * p.alb_ponds + (1.0 - frac_sn - frac_pnd) * albi
        pen_sw = (1.0 - frac_sn - frac_pnd) * p.I_0
        return alb, pen_sw
    if scheme == 4:
        warm = tsurf > -1.0
        albs = jnp.where(warm, p.alb_sn - 0.124 * (tsurf + 1.0), p.alb_sn)
        frac_sn = hs / (hs + 0.02)
        alb = frac_sn * albs + frac_pnd * p.alb_ponds + (1.0 - frac_sn - frac_pnd) * p.alb_ice
        pen_sw = (1.0 - frac_sn - frac_pnd) * p.I_0
        return alb, pen_sw
    raise ValueError(f"alb_scheme {scheme}")


# ---------------------------------------------------------------------------
# Ice-atmosphere bulk fluxes (reference: IABulkFluxes, fe.cpp:6148-6359)
# ---------------------------------------------------------------------------


def ia_bulk_fluxes(
    p: ThermoParams,
    forcing,
    tsurf,
    snow_thick,
    conc,
    drag_ui,
    drag_ti,
    pond_fraction,
    lid_volume,
    wspeed,
    sphuma,
    bulk_for_young: bool,
):
    """Returns dict of fluxes + updated drag coefficients."""
    # outgoing longwave + derivative (fe.cpp:6208-6211)
    tsurfK = tsurf + phys.tfrwK
    qlw_out = phys.eps * phys.sigma_sb * tsurfK**4
    dqlwdT = 4.0 * phys.eps * phys.sigma_sb * tsurfK**3

    sphumi, dsphumidT = specific_humidity_ice(forcing.mslp, tsurf)

    tairK = forcing.tair + phys.tfrwK
    rhoair = air_density(forcing.mslp, forcing.tair, sphuma)
    tpot = tairK + phys.Gamma_d * p.zref_temp

    if not p.force_neutral_atmosphere:
        # --- Monin-Obukhov stability (fe.cpp:6238-6305) -------------------
        retv = 0.6078
        am = 5.0
        bm = am / 6.5
        Bm = ((1 - bm) / bm) ** (1.0 / 3.0)
        ah, bh, ch = 5.0, 5.0, 3.0
        Bh = math.sqrt(5.0)
        C1 = -3.0 * am / bm
        C2 = 0.5 * am * Bm / bm
        C3 = 1.0 / (1.0 + Bm)
        Bm2 = Bm * Bm
        C4 = 1.0 / (1.0 - Bm + Bm2)
        sqrt3 = math.sqrt(3.0)
        C5 = 2.0 * sqrt3
        C6 = 1.0 / (sqrt3 * Bm)
        C7 = math.atan((2.0 - Bm) * C6)
        D1 = -0.5 * bh
        D2 = -ah / Bh + 0.5 * bh * ch / Bh
        D3 = ch - Bh
        D4 = ch + Bh
        D5 = math.log(D3 / D4)
        z0 = p.zref_wind * math.exp(-phys.vonKarman / math.sqrt(p.quad_drag_coef_air))
        lambda_u = math.log(p.zref_wind / z0)
        lambda_h = math.log(p.zref_wind / z0)
        linv_range = 1.0 / p.limiting_lengthscale

        ustar = jnp.sqrt(jnp.maximum(drag_ui, 1e-12)) * wspeed
        tvirt = tpot * (1.0 + retv * sphuma)
        mixrat = sphuma / (1.0 - sphuma)
        wtpot = drag_ti * wspeed * (tsurfK - tpot)
        wr = drag_ti * wspeed * (sphumi - sphuma) / ((1.0 - sphumi) * (1.0 - sphuma))
        wtvirt = wtpot * (1.0 + retv * mixrat) + retv * tpot * wr
        linv = jnp.clip(
            -phys.vonKarman * phys.g * wtvirt / jnp.maximum(ustar**3 * tvirt, 1e-15),
            -linv_range,
            linv_range,
        )
        zetam = p.zref_wind * linv
        zetah = p.zref_temp * linv

        # stable branch (fe.cpp:6278-6289)
        x_s = jnp.cbrt(1.0 + jnp.maximum(zetam, 0.0))
        psim_s = C1 * (x_s - 1.0) + C2 * (
            2.0 * jnp.log((x_s + Bm) * C3)
            - jnp.log((x_s * x_s - x_s * Bm + Bm2) * C4)
            + C5 * (jnp.arctan((2.0 * x_s - Bm) * C6) - C7)
        )
        zetah_s = jnp.maximum(zetah, 0.0)
        psih_s = D1 * jnp.log(1.0 + ch * zetah_s + zetah_s * zetah_s) + D2 * (
            jnp.log((2.0 * zetah_s + D3) / (2.0 * zetah_s + D4)) - D5
        )
        # unstable branch (fe.cpp:6290-6299)
        x_u = jnp.sqrt(jnp.sqrt(1.0 - 16.0 * jnp.minimum(zetam, 0.0)))
        psim_u = (
            2.0 * jnp.log(0.5 * (1.0 + x_u))
            + jnp.log(0.5 * (1.0 + x_u * x_u))
            - 2.0 * jnp.arctan(x_u)
            + 0.5 * jnp.pi
        )
        xh_u = jnp.sqrt(jnp.sqrt(1.0 - 16.0 * jnp.minimum(zetah, 0.0)))
        psih_u = 2.0 * jnp.log(0.5 * (1.0 + xh_u * xh_u))

        stable = linv >= 0.0
        psim = jnp.where(stable, psim_s, psim_u)
        psih = jnp.where(stable, psih_s, psih_u)

        drag_ui = (phys.vonKarman / (lambda_u - psim)) ** 2
        drag_ti = (phys.vonKarman / (lambda_h - psih)) ** 2

    # --- heat fluxes (fe.cpp:6307-6325) -----------------------------------
    qsh = drag_ti * rhoair * phys.cpa * wspeed * (tsurfK - tpot)
    dqshdT = drag_ti * rhoair * phys.cpa * wspeed
    lsub = phys.Lf + phys.Lv0 - 240.0 - 290.0 * tsurf - 4.0 * tsurf * tsurf
    qlh = drag_ti * rhoair * lsub * wspeed * (sphumi - sphuma)
    dqlhdT = drag_ti * lsub * rhoair * wspeed * dsphumidT
    dqiadT = dqlwdT + dqshdT + dqlhdT
    subl = jnp.maximum(0.0, qlh / lsub)  # deposition removed (fe.cpp:6328-6330)

    hs = jnp.where(conc > 0.0, snow_thick / jnp.maximum(conc, 1e-15), 0.0)

    # pond fraction only counts with a thin (<5 cm water-equivalent) lid
    # (fe.cpp:6340-6349); none on young ice
    frac_pnd = jnp.where(
        (pond_fraction > 0.0)
        & (lid_volume <= 0.05 * jnp.maximum(pond_fraction, 1e-30)),
        pond_fraction,
        0.0,
    )
    if bulk_for_young:
        frac_pnd = jnp.zeros_like(frac_pnd)

    alb, pen_sw = albedo(p, tsurf, hs, frac_pnd)
    qsw = -forcing.qsw_in * (1.0 - alb) * (1.0 - pen_sw)
    I = forcing.qsw_in * (1.0 - alb) * pen_sw

    qlw = qlw_out - incoming_longwave(p, forcing, tsurf)
    qia = qsw + qlw + qsh + qlh
    return dict(
        qia=qia, qlw=qlw, qsw=qsw, qlh=qlh, qsh=qsh, I=I, subl=subl,
        dqiadT=dqiadT, albedo=alb, drag_ui=drag_ui, drag_ti=drag_ti,
    )


# ---------------------------------------------------------------------------
# Zero-layer Semtner slab (reference: thermoIce0, fe.cpp:6860-6962)
# ---------------------------------------------------------------------------


def thermo_ice0(p: ThermoParams, dt, conc, voli, vols, snowfall, qia, dqiadT, I, subl, tbot, qio, tsurf_in):
    """Returns dict(qio, hi, hs, hi_old, del_hi, del_hs_mlt, mlt_hi_top,
    mlt_hi_bot, del_hi_s2i, tsurf)."""
    qi = phys.Lf * phys.rhoi
    qs = phys.Lf * phys.rhos
    tfr_ice = -p.freezingpoint_mu * phys.si
    beta = 0.4  # Semtner (1967) fudge factors (fe.cpp:6875-6877)
    gamma = 1.065
    ks = p.snow_cond

    no_ice = (conc <= 0.0) | (voli <= 0.0)
    safe_conc = jnp.where(no_ice, 1.0, conc)

    hi = jnp.where(no_ice, 0.0, voli / safe_conc)
    hi_old = hi
    hs = jnp.where(no_ice, 0.0, vols / safe_conc)
    tsurf = tsurf_in

    qia_mod = qia + (1.0 - beta) * I

    # conductive flux + surface temperature update (fe.cpp:6899-6910)
    denom = hs + ks * hi / phys.ki
    denom = jnp.maximum(denom, 1e-10)
    qic = ks * (tbot - tsurf) / denom * gamma
    tsurf = tsurf + (qic - qia_mod) / (ks / denom + dqiadT)
    tsurf = jnp.where(hs > 0.0, jnp.minimum(0.0, tsurf), jnp.minimum(tfr_ice, tsurf))

    # --- melt & growth (fe.cpp:6912-6937) ---------------------------------
    del_hs_mlt = jnp.minimum(qia_mod - qic, 0.0) * dt / qs
    hs = hs + del_hs_mlt - subl * dt / phys.rhos
    del_ht = jnp.minimum(hs, 0.0) * qs / qi  # leftover energy melts ice
    hs = jnp.maximum(0.0, hs)
    hs = hs + snowfall / phys.rhos * dt

    del_hb = (qic - qio) * dt / qi
    del_hi = del_ht + del_hb
    hi = hi + del_hi
    mlt_hi_top = jnp.minimum(del_ht, 0.0)
    mlt_hi_bot = jnp.minimum(del_hb, 0.0)

    # snow-to-ice by flooding (fe.cpp:6939-6948)
    draft = (hi * phys.rhoi + hs * phys.rhos) / phys.rhow
    flood = (draft > hi) if p.flooding else jnp.zeros_like(draft, bool)
    del_hi_s2i = jnp.where(flood, draft - hi, 0.0)
    hs = jnp.where(flood, hs - (draft - hi) * phys.rhoi / phys.rhos, hs)
    hi = jnp.where(flood, draft, hi)

    # --- too-thin cleanup (fe.cpp:6950-6969) -------------------------------
    thin = hi < phys.hmin
    melt_scale = jnp.where(
        (del_hi < 0.0), -hi_old / jnp.minimum(del_hi, -1e-15), 0.0
    )
    mlt_hi_top = jnp.where(thin, mlt_hi_top * melt_scale, mlt_hi_top)
    mlt_hi_bot = jnp.where(thin, mlt_hi_bot * melt_scale, mlt_hi_bot)
    del_hi_s2i = jnp.where(thin, 0.0, del_hi_s2i)
    qio = jnp.where(thin, qio + hi * qi / dt + hs * qs / dt, qio)
    del_hi = jnp.where(thin, -hi_old, del_hi)
    hi = jnp.where(thin, 0.0, hi)
    hs = jnp.where(thin, 0.0, hs)
    tsurf = jnp.where(thin, tfr_ice, tsurf)

    # no-ice lanes produce the reference's no-op outputs (fe.cpp:6883-6890)
    hi = jnp.where(no_ice, 0.0, hi)
    hi_old = jnp.where(no_ice, 0.0, hi_old)
    hs = jnp.where(no_ice, 0.0, hs)
    tsurf = jnp.where(no_ice, tfr_ice, tsurf)
    del_hi = jnp.where(no_ice, 0.0, del_hi)
    del_hs_mlt = jnp.where(no_ice, 0.0, del_hs_mlt)
    mlt_hi_top = jnp.where(no_ice, 0.0, mlt_hi_top)
    mlt_hi_bot = jnp.where(no_ice, 0.0, mlt_hi_bot)
    del_hi_s2i = jnp.where(no_ice, 0.0, del_hi_s2i)

    return dict(
        qio=qio, hi=hi, hs=hs, hi_old=hi_old, del_hi=del_hi,
        del_hs_mlt=del_hs_mlt, mlt_hi_top=mlt_hi_top, mlt_hi_bot=mlt_hi_bot,
        del_hi_s2i=del_hi_s2i, tsurf=tsurf,
    )


# ---------------------------------------------------------------------------
# Winton (2000) 3-layer slab (reference: thermoWinton, fe.cpp:6633-6855)
# ---------------------------------------------------------------------------


def thermo_winton(p: ThermoParams, dt, conc, voli, vols, snowfall, qia, dqiadT, I, subl, tbot, qio, tsurf_in, t1_in, t2_in):
    """Returns dict(qio, hi, hs, hi_old, del_hi, del_hs_mlt, mlt_hi_top,
    mlt_hi_bot, del_hi_s2i, tsurf, t1, t2). Branch-free transcription;
    equation numbers refer to Winton (2000) as cited in the reference."""
    qi = phys.Lf * phys.rhoi
    qs = phys.Lf * phys.rhos
    crho = phys.C * phys.rhoi
    tfr_ice = -p.freezingpoint_mu * phys.si
    ks = p.snow_cond

    no_ice = (conc <= 0.0) | (voli <= 0.0)
    safe_conc = jnp.where(no_ice, 1.0, conc)
    hi = jnp.where(no_ice, 1.0, voli / safe_conc)  # safe placeholder 1 m
    hi_old = hi
    hs = jnp.where(no_ice, 0.0, vols / safe_conc)
    tsurf = jnp.where(no_ice, tfr_ice, tsurf_in)
    t1 = jnp.minimum(jnp.where(no_ice, tfr_ice, t1_in), -1e-6)  # T1<0 for sqrt/div
    t2 = jnp.where(no_ice, tfr_ice, t2_in)

    tfr_surf = jnp.where(hs > 0.0, 0.0, tfr_ice)

    # --- internal temperatures (eqs 5-22; fe.cpp:6668-6705) ---------------
    k12 = 4.0 * phys.ki * ks / (ks * hi + 4.0 * phys.ki * hs)
    A = qia - tsurf * dqiadT
    B = dqiadT
    k32 = 2.0 * phys.ki / hi

    a1 = hi * crho / (2.0 * dt) + k32 * (4.0 * dt * k32 + hi * crho) / (
        6.0 * dt * k32 + hi * crho
    ) + k12 * B / (k12 + B)
    b1 = (
        -hi / (2.0 * dt) * (crho * t1 + qi * tfr_ice / t1)
        - I
        - k32 * (4.0 * dt * k32 * tbot + hi * crho * t2) / (6.0 * dt * k32 + hi * crho)
        + A * k12 / (k12 + B)
    )
    c1 = hi * qi * tfr_ice / (2.0 * dt)

    t1_new = -(b1 + jnp.sqrt(jnp.maximum(b1 * b1 - 4.0 * a1 * c1, 1e-20))) / (2.0 * a1)
    tsurf_new = (k12 * t1_new - A) / (k12 + B)

    # surface-melt recalculation (eqs 19-22; fe.cpp:6684-6698)
    melting = tsurf_new > tfr_surf
    a1m = a1 + k12 - k12 * B / (k12 + B)
    b1m = b1 - k12 * tfr_surf - A * k12 / (k12 + B)
    t1_melt = -(b1m + jnp.sqrt(jnp.maximum(b1m * b1m - 4.0 * a1m * c1, 1e-20))) / (2.0 * a1m)
    msurf = jnp.maximum(
        k12 * (t1_melt - tfr_surf) - (A + B * tfr_surf), 0.0
    )
    t1 = jnp.minimum(jnp.where(melting, t1_melt, t1_new), -1e-6)
    tsurf = jnp.where(melting, tfr_surf, tsurf_new)
    msurf = jnp.where(melting, msurf, 0.0)

    # T2 (eq 15; fe.cpp:6701)
    t2 = (2.0 * dt * k32 * (t1 + 2.0 * tbot) + hi * crho * t2) / (6.0 * dt * k32 + hi * crho)

    # --- thickness changes (fe.cpp:6707-6790) -----------------------------
    h1 = hi / 2.0
    h2 = hi / 2.0
    e1 = crho * (t1 - tfr_ice) - qi * (1.0 - tfr_ice / t1)  # (1) x rhoi
    e2 = crho * (t2 - tfr_ice) - qi  # (25) x rhoi

    hs = hs + snowfall / phys.rhos * dt

    # sublimation cascade (fe.cpp:6716-6741)
    s = subl * dt
    c1_ = s <= hs * phys.rhos
    c2_ = (~c1_) & (s - hs * phys.rhos <= h1 * phys.rhoi)
    c3_ = (~c1_) & (~c2_) & (s - h1 * phys.rhoi - hs * phys.rhos <= h2 * phys.rhoi)
    c4_ = (~c1_) & (~c2_) & (~c3_)
    h2 = jnp.where(c3_, h2 - (s - h1 * phys.rhoi - hs * phys.rhos) / phys.rhoi, h2)
    h1 = jnp.where(c2_, h1 - (s - hs * phys.rhos) / phys.rhoi, jnp.where(c3_ | c4_, 0.0, h1))
    hs = jnp.where(c1_, hs - s / phys.rhos, 0.0)
    h2 = jnp.where(c4_, 0.0, h2)
    mlt_hi_top = jnp.maximum(0.0, h1 + h2 - hi_old)  # (fe.cpp:6742-6743)

    # bottom melt/growth (eqs 23-26, 31-34; fe.cpp:6745-6775)
    mbot = qio - 4.0 * phys.ki * (tbot - t2) / hi
    growth = mbot <= 0.0
    ebot = crho * (tbot - tfr_ice) - qi
    delh2_g = mbot * dt / ebot
    t2_g = (delh2_g * tbot + h2 * t2) / jnp.maximum(delh2_g + h2, 1e-12)
    # melt branch
    delh2_m = -jnp.minimum(-mbot * dt / e2, h2)
    delh1_m = -jnp.minimum(jnp.maximum(-(mbot * dt + e2 * h2) / e1, 0.0), h1)
    del_hs_mlt_b = -jnp.minimum(
        jnp.maximum((mbot * dt + e2 * h2 + e1 * h1) / qs, 0.0), hs
    )
    all_melts_b = (h2 + h1 + hs - delh2_m - delh1_m - del_hs_mlt_b) <= 0.0
    qio_refund_b = jnp.maximum(mbot * dt - qs * hs + e1 * h1 + e2 * h2, 0.0) / dt
    qio = jnp.where((~growth) & all_melts_b, qio - qio_refund_b, qio)

    t2 = jnp.where(growth, t2_g, t2)
    h2 = jnp.where(growth, h2 + delh2_g, h2 + delh2_m)
    h1 = jnp.where(growth, h1, h1 + delh1_m)
    del_hs_mlt = jnp.where(growth, 0.0, del_hs_mlt_b)
    hs = jnp.where(growth, hs, hs + del_hs_mlt_b)
    mlt_hi_bot = jnp.where(growth, 0.0, delh1_m + delh2_m)

    # surface melt (eqs 27-30; fe.cpp:6777-6790). NB the reference adds the
    # accumulated del_hs_mlt (bottom+surface) to hs here — kept for parity.
    dhs_s = -jnp.minimum(msurf * dt / qs, hs)
    delh1_s = -jnp.minimum(jnp.maximum(-(msurf * dt - qs * hs) / e1, 0.0), h1)
    delh2_s = -jnp.minimum(
        jnp.maximum(-(msurf * dt - qs * hs + e1 * h1) / e2, 0.0), h2
    )
    del_hs_mlt = del_hs_mlt + dhs_s
    all_melts_s = (h2 + h1 + hs - delh2_s - delh1_s - del_hs_mlt) <= 0.0
    qio_refund_s = jnp.maximum(msurf * dt - qs * hs + e1 * h1 + e2 * h2, 0.0) / dt
    qio = jnp.where(all_melts_s, qio - qio_refund_s, qio)
    hs = hs + del_hs_mlt
    h1 = h1 + delh1_s
    h2 = h2 + delh2_s
    mlt_hi_top = mlt_hi_top + delh1_s + delh2_s

    # snow-to-ice (eqs 35-39; fe.cpp:6792-6808) — freeboard uses the
    # pre-melt hi, as the reference does
    del_hi_s2i = jnp.zeros_like(hi)
    if p.flooding:
        freeboard = (hi * (phys.rhow - phys.rhoi) - hs * phys.rhos) / phys.rhow
        flood = freeboard < 0.0
        hs = jnp.where(flood, hs + jnp.minimum(freeboard * phys.rhoi / phys.rhos, 0.0), hs)
        delh1_f = jnp.where(flood, jnp.maximum(-freeboard, 0.0), 0.0)
        f1 = 1.0 - delh1_f / jnp.maximum(delh1_f + h1, 1e-12)
        tbar = f1 * (t1 + qi * tfr_ice / (crho * t1)) + (1.0 - f1) * tfr_ice
        t1_f = (tbar - jnp.sqrt(jnp.maximum(tbar * tbar - 4.0 * tfr_ice * qi / crho, 1e-20))) / 2.0
        t1 = jnp.minimum(jnp.where(flood, t1_f, t1), -1e-6)
        h1 = h1 + delh1_f
        del_hi_s2i = delh1_f

    hi = h1 + h2

    # even out the two layers (eqs 38-40; fe.cpp:6810-6838)
    lower_bigger = h2 > h1
    f1a = h1 / jnp.maximum(hi, 1e-12) * 2.0
    tbar_a = f1a * (t1 + qi * tfr_ice / (crho * t1)) + (1.0 - f1a) * t2
    t1_a = (tbar_a - jnp.sqrt(jnp.maximum(tbar_a * tbar_a - 4.0 * tfr_ice * qi / crho, 1e-20))) / 2.0
    f1b = (2.0 * h1 - hi) / jnp.maximum(hi, 1e-12)
    t2_b = f1b * (t1 + qi * tfr_ice / (crho * t1)) + (1.0 - f1b) * t2
    has_hi = hi > 0.0
    t1 = jnp.minimum(jnp.where(lower_bigger, t1_a, t1), -1e-6)
    t2 = jnp.where((~lower_bigger) & has_hi, t2_b, t2)
    # melt from both if T2 drifted above freezing (fe.cpp:6824-6837).
    # The denominator crosses zero near T1 ~ Tfr/2; in float32 that window is
    # wide enough to hit, so clamp its magnitude — the resulting huge melt
    # term drives hi below hmin and the cleanup below zeroes the cell, which
    # is the physically-intended outcome (all ice melts).
    hot2 = (~lower_bigger) & has_hi & (t2 > tfr_ice)
    mlt_den = qi * t1 + (crho * t1 - qi) * (tfr_ice - t1)
    mlt_den = jnp.where(
        jnp.abs(mlt_den) < 1e3, jnp.where(mlt_den >= 0.0, 1e3, -1e3), mlt_den
    )
    mlt_term = hi / 4.0 * crho * (t2 - tfr_ice) * t1 / mlt_den
    mlt_hi_top = jnp.where(hot2, mlt_hi_top - mlt_term, mlt_hi_top)
    mlt_hi_bot = jnp.where(hot2, mlt_hi_bot - mlt_term, mlt_hi_bot)
    hi = jnp.where(hot2, hi - 2.0 * mlt_term, hi)
    t2 = jnp.where(hot2, tfr_ice, t2)

    del_hi = hi - hi_old

    # too-thin cleanup (fe.cpp:6842-6862). Non-finite lanes (pathological
    # float32 corner states) are routed through the cleanup as fully melted
    # rather than being allowed to propagate NaN (NaN < hmin is False).
    bad = ~(jnp.isfinite(hi) & jnp.isfinite(hs) & jnp.isfinite(t1) & jnp.isfinite(t2))
    hi = jnp.where(bad, 0.0, hi)
    hs = jnp.where(bad, 0.0, hs)
    del_hi = jnp.where(bad, -hi_old, del_hi)
    thin = (hi < phys.hmin) | bad
    qio = jnp.where(thin, qio - (-qs * hs + (e1 + e2) * hi / 2.0) / dt, qio)
    melt_scale = jnp.where(del_hi < 0.0, -hi_old / jnp.minimum(del_hi, -1e-15), 0.0)
    mlt_hi_top = jnp.where(thin, mlt_hi_top * melt_scale, mlt_hi_top)
    mlt_hi_bot = jnp.where(thin, mlt_hi_bot * melt_scale, mlt_hi_bot)
    del_hi_s2i = jnp.where(thin, 0.0, del_hi_s2i)
    del_hi = jnp.where(thin, -hi_old, del_hi)
    hi = jnp.where(thin, 0.0, hi)
    hs = jnp.where(thin, 0.0, hs)
    tsurf = jnp.where(thin, tfr_ice, tsurf)
    t1 = jnp.where(thin, tfr_ice, t1)
    t2 = jnp.where(thin, tfr_ice, t2)

    # no-ice lanes (fe.cpp:6652-6661)
    zero = jnp.zeros_like(hi)
    hi = jnp.where(no_ice, 0.0, hi)
    hs = jnp.where(no_ice, 0.0, hs)
    hi_old = jnp.where(no_ice, 0.0, hi_old)
    del_hi = jnp.where(no_ice, 0.0, del_hi)
    del_hs_mlt = jnp.where(no_ice, 0.0, del_hs_mlt)
    mlt_hi_top = jnp.where(no_ice, 0.0, mlt_hi_top)
    mlt_hi_bot = jnp.where(no_ice, 0.0, mlt_hi_bot)
    del_hi_s2i = jnp.where(no_ice, 0.0, del_hi_s2i)
    tsurf = jnp.where(no_ice, tfr_ice, tsurf)
    t1 = jnp.where(no_ice, tfr_ice, t1)
    t2 = jnp.where(no_ice, tfr_ice, t2)

    return dict(
        qio=qio, hi=hi, hs=hs, hi_old=hi_old, del_hi=del_hi,
        del_hs_mlt=del_hs_mlt, mlt_hi_top=mlt_hi_top, mlt_hi_bot=mlt_hi_bot,
        del_hi_s2i=del_hi_s2i, tsurf=tsurf, t1=t1, t2=t2,
    )


# ---------------------------------------------------------------------------
# Melt ponds (reference: meltPonds, fe.cpp:6538-6633)
# ---------------------------------------------------------------------------


def melt_ponds(p: ThermoParams, dt, conc, thick, tice0, hi, hs, mlt_hi_top, del_hs_mlt, qia, rain_on_ice, pond_volume, lid_volume):
    """Returns (pond_volume, lid_volume, pond_fraction)."""
    h_ice_min = 0.1
    conc_min = 0.1
    max_lid = 0.3
    min_lid = 1e-3
    i2w = phys.rhoi / phys.rhow
    s2w = phys.rhos / phys.rhow
    w2i = phys.rhow / phys.rhoi
    tfr_ice = -p.freezingpoint_mu * phys.si

    available = -mlt_hi_top * i2w - del_hs_mlt * s2w + rain_on_ice / phys.rhow * dt
    pond_volume = pond_volume + (1.0 - p.meltponds_roff) * available * conc

    flush = (
        (pond_volume <= 0.0)
        | (conc <= conc_min)
        | (jnp.where(conc > 0.0, thick / jnp.maximum(conc, 1e-15), 0.0) <= h_ice_min)
    )

    pond_fraction = jnp.sqrt(jnp.maximum(pond_volume, 1e-20) / p.meltponds_dep2frac)
    pond_fraction = jnp.minimum(pond_fraction, 1.0 - hs / (hs + 0.2))
    pond_depth = jnp.minimum(p.meltponds_dep2frac * pond_fraction, 0.9 * hi)
    pond_volume = pond_depth * pond_fraction
    pond_depth = jnp.maximum(0.05, pond_depth)
    pond_fraction = jnp.minimum(
        pond_fraction, (lid_volume + pond_volume) / jnp.maximum(pond_depth, 1e-15)
    )

    # lid growth/melt (fe.cpp:6596-6616)
    has_lid = (lid_volume > 0.0) & (pond_fraction > 1e-11)
    tpond = tfr_ice
    lid_thickness = jnp.clip(
        lid_volume * w2i / jnp.maximum(pond_fraction, 1e-15), min_lid, max_lid
    )
    qic = (tpond - tice0) / lid_thickness * phys.ki
    del_lid_thick = (jnp.minimum(qia - qic, 0.0) + qic) * dt / (phys.rhoi * phys.Lf)
    del_lid_haslid = jnp.maximum(del_lid_thick * i2w * pond_fraction, -lid_volume)
    del_lid_forms = dt * jnp.maximum(qia, 0.0) / (phys.rhoi * phys.Lf) * i2w
    del_lid = jnp.where(has_lid, del_lid_haslid, jnp.where(qia > 0.0, del_lid_forms, 0.0))

    lid_volume = lid_volume + del_lid
    pond_volume = pond_volume - del_lid

    # remove lid if pond frozen solid or lid too thick (fe.cpp:6620-6629)
    kill = (pond_volume <= 0.0) | (
        lid_volume * w2i / jnp.maximum(pond_fraction, 1e-15) >= max_lid
    )
    dead = flush | kill
    pond_volume = jnp.where(dead, 0.0, pond_volume)
    lid_volume = jnp.where(dead, 0.0, lid_volume)
    pond_fraction = jnp.where(dead, 0.0, pond_fraction)
    return pond_volume, lid_volume, pond_fraction


# ---------------------------------------------------------------------------
# Ice-ocean heat flux (reference: iceOceanHeatflux, fe.cpp:6396-6432)
# ---------------------------------------------------------------------------


def ice_ocean_heatflux(p: ThermoParams, state, forcing, mld, dt):
    tbot = freezing_point(p, state.sss)
    if p.qio_type == "basic":
        return (state.sst - tbot) * phys.rhow * phys.cpw * mld / dt
    # exchange: element-mean |v_ice - v_ocean| (fe.cpp:6416-6426)
    rel_u = state.vt_u - forcing.ocean_u
    rel_v = state.vt_v - forcing.ocean_v
    rel = jnp.sqrt(rel_u * rel_u + rel_v * rel_v + 1e-20)
    norm = stencil.cell_mean_of_nodes(rel)
    return (state.sst - tbot) * norm * p.Csens_io * phys.rhow * phys.cpw


# ---------------------------------------------------------------------------
# The thermo step driver (reference: FiniteElement::thermo, fe.cpp:5170-6148)
# ---------------------------------------------------------------------------


def thermo_step(state, forcing, grid_arrays, dt: float, cfg_params: ThermoParams, tinfo: Dict | None = None, fsd_params=None, fsd_bins=None):
    """One full thermodynamics step. Returns (state, diag_dict).

    ``tinfo`` carries per-step scalar time flags (traced): is_day_start,
    is_day_end, is_0915, is_0801, is_myi_reset_date — computed on host by
    the Simulator.
    """
    p = cfg_params
    mask = grid_arrays["mask"]
    if tinfo is None:
        zero = jnp.zeros((), state.conc.dtype)
        tinfo = dict(is_day_start=zero, is_day_end=zero, is_0915=zero, is_0801=zero, is_myi_reset_date=zero)

    ddt = dt
    qi = phys.Lf * phys.rhoi
    qs = phys.Lf * phys.rhos
    rh0 = 1.0 / p.hnull
    rPhiF = 1.0 / p.PhiF
    tfr_ice = -p.freezingpoint_mu * phys.si

    diag: Dict = {}

    # =====================================================================
    # 2) atmospheric fluxes
    # =====================================================================
    wspeed = wind_speed_cells(forcing)
    sphuma = specific_humidity_air(p, forcing)

    obf = getattr(p, "ocean_bulk_formula", "nextsim")
    if obf != "nextsim":
        ow = ow_bulk_fluxes_aerobulk(p, state, forcing, wspeed, sphuma, scheme=obf)
    else:
        ow = ow_bulk_fluxes(p, state, forcing, wspeed, sphuma)
    qow = ow["qow"]
    diag["tau_ow"] = ow["tau_ow"]

    # previous-step pond fraction for the albedo (reference keeps
    # D_pond_fraction from the last step; recomputed below)
    pond_fraction_prev = jnp.where(
        state.pond_volume > 0.0,
        jnp.sqrt(jnp.maximum(state.pond_volume, 1e-20) / p.meltponds_dep2frac),
        0.0,
    )

    ia = ia_bulk_fluxes(
        p, forcing, state.tice[0], state.snow_thick, state.conc,
        state.drag_ui, state.drag_ti, pond_fraction_prev, state.lid_volume,
        wspeed, sphuma, bulk_for_young=False,
    )
    qia, dqiadT, subl, I = ia["qia"], ia["dqiadT"], ia["subl"], ia["I"]

    if p.use_young_ice:
        ia_y = ia_bulk_fluxes(
            p, forcing, state.tsurf_young, state.hs_young, state.conc_young,
            state.drag_ui_young, state.drag_ti_young, pond_fraction_prev,
            state.lid_volume, wspeed, sphuma, bulk_for_young=True,
        )
    else:
        z = jnp.zeros_like(qia)
        ia_y = dict(qia=z, qlw=z, qsw=z, qlh=z, qsh=z, I=z, subl=z, dqiadT=z,
                    albedo=z, drag_ui=state.drag_ui_young, drag_ti=state.drag_ti_young)

    # =====================================================================
    # 3) slab: save old volumes and concentrations (fe.cpp:5302-5322)
    # =====================================================================
    old_vol = state.thick
    old_snow_vol = state.snow_thick
    old_conc = state.conc
    old_h_young = state.h_young if p.use_young_ice else jnp.zeros_like(old_conc)
    old_conc_young = state.conc_young if p.use_young_ice else jnp.zeros_like(old_conc)
    old_conc_tot = old_conc + old_conc_young
    old_ow_fraction = 1.0 - old_conc_tot

    # snowfall (fe.cpp:5325-5338)
    if forcing.snowfr is not None:
        snowfall = forcing.precip * forcing.snowfr
    elif forcing.snowfall is not None:
        snowfall = forcing.snowfall
    else:
        snowfall = jnp.where(forcing.tair < 0.0, forcing.precip, 0.0)
    snowfall = jnp.maximum(0.0, snowfall)

    mld = forcing.mld if forcing.mld is not None else jnp.full_like(old_conc, p.constant_mld)

    # =====================================================================
    # 4) nudging fluxes (fe.cpp:5345-5367)
    # =====================================================================
    if p.ocean_type == "constant":
        qdw = forcing.qdw if forcing.qdw is not None else jnp.full_like(old_conc, p.Qdw_const)
        fdw = forcing.fdw if forcing.fdw is not None else jnp.full_like(old_conc, p.Fdw_const)
        sst_in, sss_in = state.sst, state.sss
    elif p.ocean_type == "coupled":
        qdw = jnp.zeros_like(old_conc)
        fdw = jnp.zeros_like(old_conc)
        sst_in = forcing.ocean_temp
        sss_in = forcing.ocean_salt
        state = state.replace(sst=sst_in, sss=sss_in)
    else:
        qdw = -(state.sst - forcing.ocean_temp) * mld * phys.rhow * phys.cpw / p.ocean_nudge_timeT
        dels_nudge = state.sss - forcing.ocean_salt
        fdw = dels_nudge * mld * phys.rhow / (
            p.ocean_nudge_timeS * state.sss - ddt * dels_nudge
        )
        sst_in, sss_in = state.sst, state.sss

    # =====================================================================
    # 5) vertical ice thermo (fe.cpp:5369-5417)
    # =====================================================================
    qio = ice_ocean_heatflux(p, state, forcing, mld, ddt)
    qio_young = qio
    tfrw = freezing_point(p, state.sss)

    if p.thermo_type == "winton":
        slab = thermo_winton(
            p, ddt, state.conc, state.thick, state.snow_thick, snowfall,
            qia, dqiadT, I, subl, tfrw, qio,
            state.tice[0], state.tice[1], state.tice[2],
        )
        t1_new, t2_new = slab["t1"], slab["t2"]
    else:
        slab = thermo_ice0(
            p, ddt, state.conc, state.thick, state.snow_thick, snowfall,
            qia, dqiadT, I, subl, tfrw, qio, state.tice[0],
        )
        t1_new, t2_new = state.tice[1], state.tice[2]
    qio = slab["qio"]
    hi, hs = slab["hi"], slab["hs"]
    hi_old = slab["hi_old"]
    del_hi = slab["del_hi"]
    del_hs_mlt = slab["del_hs_mlt"]
    mlt_hi_top, mlt_hi_bot = slab["mlt_hi_top"], slab["mlt_hi_bot"]
    del_hi_s2i = slab["del_hi_s2i"]
    tice0_new = slab["tsurf"]

    # young-ice slab (always zero-layer; fe.cpp:5419-5431)
    if p.use_young_ice:
        slab_y = thermo_ice0(
            p, ddt, state.conc_young, state.h_young, state.hs_young, snowfall,
            ia_y["qia"], ia_y["dqiadT"], ia_y["I"], ia_y["subl"], tfrw,
            qio_young, state.tsurf_young,
        )
        qio_young = slab_y["qio"]
        hi_young, hs_young_slab = slab_y["hi"], slab_y["hs"]
        hi_young_old = slab_y["hi_old"]
        del_hi_young = slab_y["del_hi"]
        tsurf_young_new = slab_y["tsurf"]
        h_young = hi_young * old_conc_young
        hs_young = hs_young_slab * old_conc_young
        del_hs_young_mlt = slab_y["del_hs_mlt"]
        mlt_hi_top_y, mlt_hi_bot_y = slab_y["mlt_hi_top"], slab_y["mlt_hi_bot"]
        del_hi_s2i_y = slab_y["del_hi_s2i"]
    else:
        z = jnp.zeros_like(old_conc)
        hi_young = hi_young_old = del_hi_young = z
        h_young = hs_young = z
        tsurf_young_new = state.tsurf_young
        del_hs_young_mlt = mlt_hi_top_y = mlt_hi_bot_y = del_hi_s2i_y = z

    # assimilation-compensating flux (fe.cpp:5433-5447)
    conc_pre_assim = old_conc + old_conc_young - state.conc_upd
    if p.use_assim_flux:
        qassm = jnp.where(
            (conc_pre_assim > 0.0) & (state.conc_upd < 0.0),
            (qow * old_ow_fraction + qio * old_conc + qio_young * old_conc_young)
            * ((state.conc_upd / conc_pre_assim + 1.0) ** p.assim_flux_exponent - 1.0),
            0.0,
        )
    else:
        qassm = jnp.zeros_like(old_conc)

    # =====================================================================
    # 6) open-water freezing and lateral melt (fe.cpp:5452-5649)
    # =====================================================================
    tw_new = state.sst - ddt * (qow + qassm) / (mld * phys.rhow * phys.cpw)
    supercooled = tw_new < tfrw
    newice = jnp.where(
        supercooled,
        old_ow_fraction * (tfrw - tw_new) * mld * phys.rhow * phys.cpw / qi,
        0.0,
    )
    qow = jnp.where(
        supercooled, -(tfrw - state.sst) * mld * phys.rhow * phys.cpw / ddt, qow
    )
    newice_stored = newice

    del_vi = newice + del_hi * old_conc
    mlt_vi_top = mlt_hi_top * old_conc
    mlt_vi_bot = mlt_hi_bot * old_conc
    del_vs_mlt = del_hs_mlt * old_conc
    snow2ice = del_hi_s2i * old_conc
    del_vi_young = jnp.zeros_like(old_conc)
    if p.use_young_ice:
        del_vi_young = del_hi_young * old_conc_young
        del_vi = del_vi + del_hi_young * old_conc_young
        mlt_vi_top = mlt_vi_top + mlt_hi_top_y * old_conc_young
        mlt_vi_bot = mlt_vi_bot + mlt_hi_bot_y * old_conc_young
        snow2ice = snow2ice + del_hi_s2i_y * old_conc_young
        del_vs_mlt = del_vs_mlt + del_hs_young_mlt * old_conc_young

    conc = state.conc
    conc_young = state.conc_young
    del_c = jnp.zeros_like(conc)
    newsnow = jnp.zeros_like(conc)
    thick_dump = jnp.zeros_like(conc)  # young ice dumped into thick (type 4)

    # --- freezing: new-ice distribution by newice_type (fe.cpp:5476-5556)
    if p.newice_type == 1:
        del_c = newice * rh0
    elif p.newice_type == 2:
        del_c = jnp.where(
            hi_old > 0.0,
            newice * p.PhiF / jnp.maximum(hi_old, 1e-15),
            jnp.where(newice > 0.0, 1.0, 0.0),
        )
    elif p.newice_type == 3:
        h0 = (1.0 + 0.1 * wspeed) / 15.0
        del_c = newice / jnp.maximum(rPhiF * hi_old, h0)
    elif p.newice_type == 4:
        # young-ice category (fe.cpp:5505-5551)
        h_young = h_young + newice
        conc_young = jnp.minimum(
            1.0 - conc, conc_young + newice / p.h_young_min
        )
        newice = jnp.zeros_like(newice)
        newsnow = jnp.zeros_like(newsnow)

        has_young = conc_young > 0.0
        # young ice thinner than h_young_min: shrink its area
        thin_y = has_young & (h_young < p.h_young_min * conc_young)
        conc_young = jnp.where(thin_y, h_young / p.h_young_min, conc_young)
        # young ice thicker than the sharp max: promote to old ice
        hi_y = h_young / jnp.maximum(conc_young, 1e-15)
        thick_y = has_young & (~thin_y) & (hi_y > p.h_young_max_sharp)
        hs_y = jnp.maximum(0.0, hs_young / jnp.maximum(conc_young, 1e-15))
        tmp_c = conc_young * (p.h_young_max_sharp - p.h_young_min) / jnp.maximum(
            hi_y - p.h_young_min, 1e-15
        )
        del_c = jnp.where(thick_y, jnp.maximum(0.0, conc_young - tmp_c), 0.0)
        conc_young2 = jnp.where(thick_y, tmp_c, conc_young)
        tmp_v = conc_young2 * p.h_young_max_sharp
        newice = jnp.where(thick_y, jnp.maximum(0.0, h_young - tmp_v), 0.0)
        h_young = jnp.where(thick_y, tmp_v, h_young)
        tmp_s = conc_young2 * hs_y
        newsnow = jnp.where(thick_y, jnp.maximum(0.0, hs_young - tmp_s), 0.0)
        hs_young = jnp.where(thick_y, tmp_s, hs_young)
        conc_young = conc_young2
        # no room for young ice at all: dump it into old ice (fe.cpp:5543-5551)
        no_young = ~has_young
        newice = jnp.where(no_young, h_young, newice)
        newsnow = jnp.where(no_young, hs_young, newsnow)
        # the reference also adds h_young to M_thick here, which only matters
        # for the Winton new-ice mixing fraction below (M_thick is rebuilt
        # from hi*conc afterwards)
        thick_dump = jnp.where(no_young, h_young, 0.0)
        h_young = jnp.where(no_young, 0.0, h_young)
        hs_young = jnp.where(no_young, 0.0, hs_young)
    else:
        raise ValueError(f"newice_type {p.newice_type}")

    del_c = jnp.minimum(1.0 - conc, del_c)

    # --- melting: lateral melt by melt_type (fe.cpp:5560-5649)
    melting = del_hi < 0.0
    lat_melt_rate = jnp.zeros_like(conc)
    if p.melt_type == 1:
        del_c_melt = jnp.where(
            conc < 1.0, del_hi * conc * p.PhiM / jnp.maximum(hi_old, 1e-15), 0.0
        )
        del_c = del_c + jnp.where(melting, del_c_melt, 0.0)
    elif p.melt_type == 2:
        has_hi = hi > 0.0
        lat_melt = (
            p.PhiM * (1.0 - conc) * jnp.minimum(0.0, qow) * ddt
            / jnp.maximum(hi * qi + hs * qs, 1e-15)
        )
        del_c = del_c + jnp.where(melting & has_hi, lat_melt, 0.0)
        qow = jnp.where(melting & has_hi, qow * (1.0 - p.PhiM), qow)
        del_c = jnp.where(melting & (~has_hi), -conc, del_c)
    elif p.melt_type == 3:
        # FSD-dependent lateral melt (fe.cpp:5596-5649; Roach et al. 2018)
        if state.conc_fsd is None or fsd_params is None:
            raise ValueError("melt_type=3 requires wave_coupling.num_fsd_bins > 0")
        from nextsim_tpu.ops import fsd as fsd_ops

        dcf, dcy, qow, lat_melt_rate = fsd_ops.lateral_melt_type3(
            state.conc_fsd, conc, conc_young, h_young, hi, hs, qow,
            tw_new, tfrw, del_hi, ddt, p.PhiM, p.h_young_min,
            fsd_params, fsd_bins,
        )
        del_c = del_c + dcf
        conc_young = jnp.clip(conc_young + dcy, 0.0, 1.0)
    else:
        raise ValueError(f"melt_type {p.melt_type}")

    # =====================================================================
    # freeze-day / summer trackers (fe.cpp:5652-5697)
    # =====================================================================
    del_vi_tend = jnp.where(
        tinfo["is_day_start"] > 0.5, jnp.zeros_like(state.del_vi_tend), state.del_vi_tend
    ) + del_vi * ddt
    day_end = tinfo["is_day_end"] > 0.5
    freezing_day = day_end & (del_vi_tend > 0.0)
    melting_day = day_end & (del_vi_tend < 0.0)
    freeze_days = jnp.where(
        freezing_day, state.freeze_days + 1.0,
        jnp.where(melting_day, 0.0, state.freeze_days),
    )
    conc_summer_cand = conc + jnp.minimum(0.0, del_c)
    thick_summer_cand = state.thick + jnp.minimum(0.0, del_vi)
    if p.use_young_ice and p.include_young_ice and not p.reset_by_date:
        pass  # use_young_ice_in_myi_reset forced False when not reset_by_date
    use_young_in_reset = p.include_young_ice and p.reset_by_date
    if p.use_young_ice and use_young_in_reset:
        conc_summer_cand = conc_summer_cand + conc_young
        thick_summer_cand = thick_summer_cand + h_young
    conc_summer = jnp.where(melting_day, jnp.clip(conc_summer_cand, 0.0, 1.0), state.conc_summer)
    thick_summer = jnp.where(melting_day, jnp.maximum(0.0, thick_summer_cand), state.thick_summer)

    # =====================================================================
    # new concentration & volume/energy conservation (fe.cpp:5699-5733)
    # =====================================================================
    conc = conc + del_c
    ok = conc >= phys.cmin
    hi_cons = (hi * old_conc + newice) / jnp.maximum(conc, phys.cmin)
    hi = jnp.where(ok, hi_cons, hi)
    shrunk = del_c < 0.0
    qow = jnp.where(ok & shrunk, qow - del_c * hs * qs / ddt, qow)
    hs_cons = (hs * old_conc + newsnow) / jnp.maximum(conc, phys.cmin)
    hs = jnp.where(ok & (~shrunk), hs_cons, hs)

    if p.thermo_type == "winton":
        # mix new ice into both layers (fe.cpp:5725-5732; Winton eqs 38-39)
        thick_before = state.thick + thick_dump
        f1 = thick_before / jnp.maximum(thick_before + newice, 1e-15)
        mu_si_lf_c = p.freezingpoint_mu * phys.si * phys.Lf / phys.C
        t1_safe = jnp.minimum(t1_new, -1e-6)
        tbar = f1 * (t1_safe - mu_si_lf_c / t1_safe) + (1.0 - f1) * tfrw
        t1_mixed = (tbar - jnp.sqrt(tbar * tbar + 4.0 * mu_si_lf_c + 1e-20)) / 2.0
        t2_mixed = f1 * t2_new + (1.0 - f1) * tfrw
        mix = ok & (newice > 0.0)
        t1_new = jnp.where(mix, t1_mixed, t1_new)
        t2_new = jnp.where(mix, t2_mixed, t2_new)

    # limits: melt residual ice away (fe.cpp:5736-5760)
    gone = (conc < phys.cmin) | (hi < phys.hmin)
    qow = jnp.where(gone, qow + conc * hi * qi / ddt + conc * hs * qs / ddt, qow)
    conc = jnp.where(gone, 0.0, conc)
    tice0_new = jnp.where(gone, tfr_ice, tice0_new)
    t1_new = jnp.where(gone, tfr_ice, t1_new)
    t2_new = jnp.where(gone, tfr_ice, t2_new)
    hi = jnp.where(gone, 0.0, hi)
    hs = jnp.where(gone, 0.0, hs)
    ridge_ratio = jnp.where(gone, 0.0, state.ridge_ratio)

    # FSD reshaping under lateral melt (fe.cpp:5770-5775 ->
    # redistributeThermoFSD); shape closure happens in the step-level
    # update_fsd rescale
    conc_fsd_new = state.conc_fsd
    if p.melt_type == 3 and state.conc_fsd is not None:
        from nextsim_tpu.ops import fsd as fsd_ops

        conc_fsd_new = fsd_ops.redistribute_thermo_fsd(
            state.conc_fsd, lat_melt_rate, ddt, fsd_params, fsd_bins
        )

    # 7) effective thickness (fe.cpp:5798-5800)
    thick = hi * conc
    snow_thick = hs * conc

    # =====================================================================
    # 8) slab ocean (fe.cpp:5803-5847)
    # =====================================================================
    rain_on_ice = jnp.maximum(0.0, forcing.precip - snowfall)
    rain = old_ow_fraction * forcing.precip + old_conc_tot * rain_on_ice
    emp = ow["evap"] * old_ow_fraction - rain

    pond_volume, lid_volume = state.pond_volume, state.lid_volume
    pond_fraction = jnp.zeros_like(conc)
    if p.use_meltponds:
        pond_volume, lid_volume, pond_fraction = melt_ponds(
            p, ddt, conc, thick, tice0_new, hi, hs, mlt_hi_top, del_hs_mlt,
            qia, rain_on_ice, pond_volume, lid_volume,
        )

    qio_mean = qio * old_conc + qio_young * old_conc_young
    qow_mean = qow * old_ow_fraction

    sst = state.sst
    sss = state.sss
    if p.ocean_type != "coupled":
        sst = sst - ddt * (qio_mean + qow_mean - qdw + qassm) / (phys.rhow * phys.cpw * mld)

    denom = mld * phys.rhow - del_vi * phys.rhoi - (
        del_vs_mlt * phys.rhos + (emp - fdw) * ddt
    )
    denom = jnp.maximum(denom, phys.rhow)
    si_eff = jnp.minimum(sss, phys.si)
    delsss = (
        (sss - si_eff) * phys.rhoi * del_vi
        + sss * (del_vs_mlt * phys.rhos + (emp - fdw) * ddt)
    ) / denom
    if p.ocean_type != "coupled":
        sss = sss + delsss

    # ridge ratio conservation on growth (fe.cpp:5849-5852)
    ridge_ratio = jnp.where(
        thick > old_vol, ridge_ratio * old_vol / jnp.maximum(thick, 1e-15), ridge_ratio
    )

    # =====================================================================
    # 9) temperature-dependent healing (fe.cpp:5857-5886)
    # =====================================================================
    time_relaxation_damage = state.time_relaxation_damage
    if p.temp_dep_healing:
        tbot_h = freezing_point(p, sss)
        if p.thermo_type == "zero-layer":
            Ch = phys.ki * snow_thick / (p.snow_cond * jnp.maximum(thick, 1e-15))
            deltaT = jnp.maximum(1e-36, tbot_h - tice0_new) / (1.0 + Ch)
        else:
            Ch = phys.ki * snow_thick / (p.snow_cond * jnp.maximum(thick, 1e-15) / 4.0)
            deltaT = jnp.maximum(1e-36, tbot_h + Ch * (tbot_h - t1_new) - tice0_new) / (1.0 + Ch)
        trd = jnp.maximum(
            p.time_relaxation_damage * p.deltaT_relaxation_damage / deltaT, ddt
        )
        time_relaxation_damage = jnp.where(thick > 0.0, trd, 1e36)

    # =====================================================================
    # 10) flux diagnostics (fe.cpp:5891-5970)
    # =====================================================================
    diag["qa"] = qia * old_conc + ia_y["qia"] * old_conc_young + qow * old_ow_fraction
    diag["qsw"] = ia["qsw"] * old_conc + ia_y["qsw"] * old_conc_young + ow["qsw"] * old_ow_fraction
    diag["qlw"] = ia["qlw"] * old_conc + ia_y["qlw"] * old_conc_young + ow["qlw"] * old_ow_fraction
    diag["qsh"] = ia["qsh"] * old_conc + ia_y["qsh"] * old_conc_young + ow["qsh"] * old_ow_fraction
    diag["qlh"] = ia["qlh"] * old_conc + ia_y["qlh"] * old_conc_young + ow["qlh"] * old_ow_fraction
    diag["qo"] = qio_mean + qow_mean
    diag["qnosun"] = qio_mean + old_ow_fraction * (ow["qlw"] + ow["qlh"] + ow["qsh"])
    diag["qsw_ocean"] = old_ow_fraction * ow["qsw"]
    diag["qassim"] = qassm
    diag["dels"] = delsss * phys.rhow * mld * phys.days_in_sec / dt
    diag["fwflux_ice"] = -1.0 / ddt * (
        (1.0 - 1e-3 * si_eff) * phys.rhoi * del_vi + phys.rhos * del_vs_mlt
    )
    diag["fwflux"] = diag["fwflux_ice"] - emp
    diag["brine"] = -1e-3 * si_eff * phys.rhoi * del_vi / ddt
    diag["evap"] = ow["evap"] * old_ow_fraction
    diag["rain"] = rain
    diag["vice_melt"] = del_vi * phys.days_in_sec / ddt
    diag["del_vi_young"] = del_vi_young * phys.days_in_sec / ddt
    diag["del_hi"] = del_hi * phys.days_in_sec / ddt
    diag["del_hi_young"] = del_hi_young * phys.days_in_sec / ddt
    diag["newice"] = newice_stored * phys.days_in_sec / ddt
    diag["mlt_top"] = mlt_vi_top * phys.days_in_sec / ddt
    diag["mlt_bot"] = mlt_vi_bot * phys.days_in_sec / ddt
    diag["snow2ice"] = snow2ice * phys.days_in_sec / ddt
    sialb = old_conc * ia["albedo"]
    if p.use_young_ice:
        sialb = sialb + old_conc_young * ia_y["albedo"]
    diag["albedo"] = sialb + jnp.maximum(0.0, old_ow_fraction) * p.ocean_albedo
    diag["sialb"] = jnp.where(old_conc_tot > 0.0, sialb / jnp.maximum(old_conc_tot, 1e-15), 0.0)
    diag["pond_fraction"] = pond_fraction

    # =====================================================================
    # 10b) ice age & multiyear-ice tracers (fe.cpp:5973-6130)
    # =====================================================================
    no_ice_tr = (conc < phys.cmin) | (thick < conc * phys.hmin)

    fyi = state.fyi_fraction
    fyi = jnp.where(tinfo["is_0915"] > 0.5, jnp.zeros_like(fyi), jnp.clip(fyi + del_c, 0.0, 1.0))

    w_age = jnp.where(old_conc <= 0.0, 0.0, jnp.minimum(old_conc / jnp.maximum(conc, 1e-15), 1.0))
    age_det = w_age * (state.age_det + dt) + jnp.maximum((1.0 - w_age) * dt, 0.0)
    w_agev = jnp.where(old_vol <= 0.0, 0.0, jnp.minimum(old_vol / jnp.maximum(thick, 1e-15), 1.0))
    age = w_agev * (state.age + dt) + jnp.maximum((1.0 - w_agev) * dt, 0.0)

    # MYI reset logic (fe.cpp:6040-6106)
    conc_myi, thick_myi = state.conc_myi, state.thick_myi
    freeze_onset = state.freeze_onset
    if p.reset_by_date:
        reset_myi = tinfo["is_myi_reset_date"] > 0.5
    else:
        reset_myi = (freeze_days >= p.reset_freeze_days) & (freeze_onset <= 0.5)
        freeze_onset = jnp.where(reset_myi, 1.0, freeze_onset)

    # Aug 1: reset onset + summer trackers (fe.cpp:6059-6080)
    aug1 = tinfo["is_0801"] > 0.5
    ctot_aug = conc + (conc_young if p.use_young_ice else 0.0)
    freeze_onset = jnp.where(aug1, jnp.where(ctot_aug == 0.0, 1.0, 0.0), freeze_onset)
    conc_summer_aug = conc + (conc_young if (p.use_young_ice and use_young_in_reset) else 0.0)
    thick_summer_aug = thick + (h_young if (p.use_young_ice and use_young_in_reset) else 0.0)
    conc_summer = jnp.where(aug1, jnp.clip(conc_summer_aug, 0.0, 1.0), conc_summer)
    thick_summer = jnp.where(aug1, jnp.maximum(0.0, thick_summer_aug), thick_summer)
    freeze_onset = jnp.round(freeze_onset)

    c_myi_max = conc + (conc_young if (p.use_young_ice and use_young_in_reset) else 0.0)
    v_myi_max = thick + (h_young if (p.use_young_ice and use_young_in_reset) else 0.0)

    old_conc_myi, old_thick_myi = conc_myi, thick_myi
    if p.reset_by_date:
        conc_myi_reset = jnp.clip(c_myi_max, 0.0, 1.0)
        thick_myi_reset = jnp.maximum(0.0, v_myi_max)
    else:
        conc_myi_reset = jnp.clip(
            jnp.minimum(c_myi_max, jnp.maximum(conc_summer, conc_myi)), 0.0, 1.0
        )
        thick_myi_reset = jnp.maximum(
            0.0, jnp.minimum(v_myi_max, jnp.maximum(thick_summer, thick_myi))
        )

    # melt-only myi decay on non-reset days (fe.cpp:6090-6118)
    some_melt = (thick < old_vol) & (old_conc > 0.0) & (old_vol > 0.0)
    if p.equal_melting:
        del_c_ratio = jnp.minimum(conc / jnp.maximum(old_conc, 1e-15), 1.0)
        del_v_ratio = jnp.minimum(thick / jnp.maximum(old_vol, 1e-15), 1.0)
        dci = jnp.minimum(0.0, conc_myi * (del_c_ratio - 1.0))
        dvi = jnp.minimum(0.0, thick_myi * (del_v_ratio - 1.0))
    else:
        dci = jnp.zeros_like(conc)
        dvi = jnp.zeros_like(conc)
    conc_myi_melt = jnp.clip(conc_myi + jnp.where(some_melt, dci, 0.0), 0.0, None)
    conc_myi_melt = jnp.minimum(conc_myi_melt, jnp.where(some_melt, c_myi_max, jnp.inf))
    thick_myi_melt = jnp.clip(thick_myi + jnp.where(some_melt, dvi, 0.0), 0.0, None)
    thick_myi_melt = jnp.minimum(thick_myi_melt, jnp.where(some_melt, v_myi_max, jnp.inf))

    conc_myi = jnp.where(reset_myi, conc_myi_reset, conc_myi_melt)
    thick_myi = jnp.where(reset_myi, thick_myi_reset, thick_myi_melt)

    del_ci_rplnt = jnp.where(reset_myi, conc_myi - old_conc_myi, 0.0)
    del_vi_rplnt = jnp.where(reset_myi, thick_myi - old_thick_myi, 0.0)
    del_ci_mlt = jnp.where(~reset_myi, conc_myi - old_conc_myi, 0.0)
    del_vi_mlt = jnp.where(~reset_myi, thick_myi - old_thick_myi, 0.0)

    # no-ice tracer reset (fe.cpp:5985-5995)
    fyi = jnp.where(no_ice_tr, 0.0, fyi)
    age_det = jnp.where(no_ice_tr, 0.0, age_det)
    age = jnp.where(no_ice_tr, 0.0, age)
    conc_myi = jnp.where(no_ice_tr, 0.0, conc_myi)
    thick_myi = jnp.where(no_ice_tr, 0.0, thick_myi)
    freeze_days = jnp.where(no_ice_tr, 0.0, freeze_days)
    freeze_onset = jnp.where(no_ice_tr, 1.0, freeze_onset)

    diag["del_ci_mlt_myi"] = del_ci_mlt * phys.days_in_sec / ddt
    diag["del_vi_mlt_myi"] = del_vi_mlt * phys.days_in_sec / ddt
    diag["del_ci_rplnt_myi"] = del_ci_rplnt * phys.days_in_sec / ddt
    diag["del_vi_rplnt_myi"] = del_vi_rplnt * phys.days_in_sec / ddt

    # =====================================================================
    # write back (masked to ocean cells)
    # =====================================================================
    if p.use_young_ice:
        young_updates = dict(
            h_young=h_young * mask,
            hs_young=hs_young * mask,
            conc_young=jnp.clip(conc_young, 0.0, 1.0) * mask,
            tsurf_young=tsurf_young_new,
            drag_ui_young=ia_y["drag_ui"],
            drag_ti_young=ia_y["drag_ti"],
        )
    else:
        young_updates = {}

    state = state.replace(
        conc_fsd=conc_fsd_new,
        conc=jnp.clip(conc, 0.0, 1.0) * mask,
        thick=jnp.maximum(thick, 0.0) * mask,
        snow_thick=jnp.maximum(snow_thick, 0.0) * mask,
        tice=jnp.stack([tice0_new, t1_new, t2_new]),
        sst=sst,
        sss=jnp.maximum(sss, 0.0),
        ridge_ratio=ridge_ratio,
        fyi_fraction=fyi,
        age_det=age_det,
        age=age,
        conc_myi=conc_myi,
        thick_myi=thick_myi,
        conc_summer=conc_summer,
        thick_summer=thick_summer,
        freeze_days=freeze_days,
        freeze_onset=freeze_onset,
        del_vi_tend=del_vi_tend,
        pond_volume=pond_volume,
        lid_volume=lid_volume,
        drag_ui=ia["drag_ui"],
        drag_ti=ia["drag_ti"],
        time_relaxation_damage=time_relaxation_damage,
        **young_updates,
    )
    return state, diag


# ---------------------------------------------------------------------------
# AeroBulk-family ocean bulk fluxes (reference: #ifdef AEROBULK path of
# OWBulkFluxes, fe.cpp:5041-5100, dispatching thermo.ocean_bulk_formula over
# the str2oblk map fe.cpp:1254-1263). The turbulent-scale algorithms live in
# ops/aerobulk.py; this wrapper assembles the radiative terms exactly as the
# nextsim formula does.
# ---------------------------------------------------------------------------


def ow_bulk_fluxes_aerobulk(
    p: ThermoParams, state, forcing, wspeed, sphuma, scheme: str = "coare3.0"
):
    """Open-water fluxes through one of the five named AeroBulk algorithms
    (coare3.0 / coare3.6 / ncar / ecmwf / andreas). Fixed-point
    Monin-Obukhov iteration, branch-free for jit."""
    from nextsim_tpu.ops import aerobulk

    sst = state.sst
    sstK = sst + phys.tfrwK
    sphumw = 0.98 * specific_humidity_water(sst)  # salinity reduction factor
    rhoair = air_density(forcing.mslp, forcing.tair, sphuma)
    u = jnp.maximum(wspeed, 0.1)

    scales = aerobulk.turbulent_scales(
        scheme, u, sst, forcing.tair, sphuma, sphumw,
        zu=p.zref_wind, zt=p.zref_temp,
    )
    ustar, tstar, qstar = scales["ustar"], scales["tstar"], scales["qstar"]

    qsh = -rhoair * phys.cpa * ustar * tstar
    lv = phys.Lv0 - 2.36418e3 * sst + 1.58927 * sst**2 - 6.14342e-2 * sst**3
    qlh = jnp.maximum(-rhoair * lv * ustar * qstar, 0.0)
    evap = qlh / lv
    tau_ow = rhoair * (ustar / u) ** 2  # rho * Cd

    qsw = -forcing.qsw_in * (1.0 - p.ocean_albedo)
    qlw_out = phys.eps * phys.sigma_sb * sstK**4
    qlw = qlw_out - incoming_longwave(p, forcing, state.tice[0])
    qow = qlw + qsh + qlh + _qsw_into_slab(forcing, qsw)
    return dict(qow=qow, qlw=qlw, qsw=qsw, qlh=qlh, qsh=qsh, evap=evap, tau_ow=tau_ow)
