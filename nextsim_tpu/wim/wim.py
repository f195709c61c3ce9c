"""Waves-in-ice module (WIM): spectral wave attenuation + floe breakage.

JAX reimplementation of the reference WIM discretisation
(reference: modules/wim/src/wimdiscr.cpp, iceinfo.cpp, gridinfo.cpp) on the
model's structured grid. The reference runs the WIM on its own regular grid
(or on the neXtSIM mesh with ``nextwim.coupling-option=run_on_mesh``); here
the model grid *is* structured, so the WIM always runs co-located with the
sea-ice state — the ``naive``/``break_on_mesh``/``run_on_mesh`` coupling
options collapse into one exact path.

Physics per WIM time step (wimdiscr.cpp:822-1210 ``timeStep``):
  1. steady-state boundary forcing of the incident spectrum,
  2. WENO(3)-limited advection of every (frequency, direction) spectral
     plane at the open-water group speed (gridinfo.cpp:592-824),
  3. attenuation by scattering (per-floe Kohout & Meylan coefficients via
     rtparam.py) + Robinson-Palmer damping, with the dissipated momentum
     accumulated into an ice-surface wave stress (attenSimple,
     wimdiscr.cpp:2249-2324),
  4. spectral moments -> Hs, Tp, mwd, Stokes drift,
  5. strain-variance floe breakage updating Dmax/Nfloes
     (iceinfo.cpp:172-203 ``doBreaking``).

The whole run (N substeps at the CFL-limited spectral dt) is one
``lax.scan`` jitted program — spectrum shape (nfreq, ndir, ny, nx), all
branches expressed as masked arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nextsim_tpu.wim import rtparam

PI = math.pi


# ---------------------------------------------------------------------------
# Parameters (reference: options_wim.cpp + IceParams, iceinfo.hpp:40-72)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WimParams:
    nwavefreq: int = 1
    nwavedirn: int = 16
    tmin: float = 2.5
    tmax: float = 25.0
    cfl: float = 0.7
    atten: bool = True
    scatmod: str = "dissipated"
    breaking: bool = True
    steady: bool = True
    advdim: int = 2
    advopt: str = "y-periodic"  # notperiodic | y-periodic | xy-periodic
    ref_hs_ice: bool = False
    # incident waves for the ideal setup
    hs_inc: float = 3.0
    tp_inc: float = 12.0
    mwd_inc: float = -90.0
    unifc: float = 0.7
    unifh: float = 1.0
    # ice / floe parameters (iceinfo.hpp:40-72)
    young: float = 5.49e9
    drag_rp: float = 13.0
    cice_min: float = 0.05
    dmin: float = 20.0
    xi: float = 2.0
    fragility: float = 0.9
    dfloe_miz_thresh: float = 200.0
    dfloe_pack_init: float = 300.0
    dfloe_pack_thresh: float = 400.0
    fsdopt: str = "PowerLawSmooth"  # PowerLawSmooth | RG
    vbf: float = 0.1
    gravity: float = 9.81
    rhowtr: float = 1025.0
    rhoice: float = 922.5
    poisson: float = 0.3

    @property
    def sigma_c(self) -> float:
        """Flexural strength [Pa] (iceinfo.cpp:40)."""
        return 1.76e6 * math.exp(-5.88 * math.sqrt(self.vbf))

    @property
    def epsc(self) -> float:
        """Breaking strain (iceinfo.cpp:41)."""
        return self.sigma_c / self.young

    @classmethod
    def from_config(cls, cfg) -> "WimParams":
        return cls(
            nwavefreq=cfg["wimsetup.nwavefreq"],
            nwavedirn=cfg["wimsetup.nwavedirn"],
            tmin=cfg["wimsetup.tmin"],
            tmax=cfg["wimsetup.tmax"],
            cfl=cfg["wim.cfl"],
            atten=cfg["wim.atten"],
            scatmod=cfg["wim.scatmod"],
            breaking=cfg["wim.breaking"],
            steady=cfg["wim.steady"],
            advdim=cfg["wim.advdim"],
            advopt=cfg["wim.advopt"],
            ref_hs_ice=cfg["wim.refhsice"],
            hs_inc=cfg["wim.hsinc"],
            tp_inc=cfg["wim.tpinc"],
            mwd_inc=cfg["wim.mwdinc"],
            unifc=cfg["wim.unifc"],
            unifh=cfg["wim.unifh"],
            young=cfg["wim.young"],
            drag_rp=cfg["wim.dragrp"],
            cice_min=cfg["wim.cicemin"],
            dfloe_pack_init=cfg["wim.dfloepackinit"],
            dfloe_pack_thresh=cfg["wim.dfloepackthresh"],
            fsdopt=cfg["wim.fsdopt"],
            dmin=cfg["wim.dfloemin"],
        )


# ---------------------------------------------------------------------------
# Spectral grids (wimdiscr.cpp assign():225-300)
# ---------------------------------------------------------------------------


def spectral_grids(p: WimParams) -> Dict[str, np.ndarray]:
    """Frequency grid + Simpson quadrature weights, and the direction grid
    with uniform weights (wimdiscr.cpp:228-283)."""
    if p.nwavefreq == 1:
        freq = np.array([1.0 / p.tp_inc])
        wt_freq = np.array([1.0])
    else:
        fmin, fmax = 1.0 / p.tmax, 1.0 / p.tmin
        freq = np.linspace(fmin, fmax, p.nwavefreq)
        wt = np.full(p.nwavefreq, 2.0)
        wt[0] = wt[-1] = 1.0
        wt[1:-1:2] = 4.0
        dom = 2 * PI * (freq[-1] - freq[0]) / (p.nwavefreq - 1)
        wt_freq = wt * dom / 3.0
    if p.nwavedirn == 1:
        wavedir = np.array([p.mwd_inc])
        wt_dir = np.array([1.0])
    else:
        dtheta = -360.0 / p.nwavedirn
        wavedir = 90.0 + dtheta * np.arange(p.nwavedirn)
        wt_dir = np.full(p.nwavedirn, 2 * PI / p.nwavedirn)
    # open-water wavelength / phase / group speeds (wimdiscr.cpp:289-300)
    wlng_wtr = p.gravity / (2 * PI * freq**2)
    ap_wtr = np.sqrt(p.gravity * wlng_wtr / (2 * PI))
    ag_wtr = ap_wtr / 2.0
    adv_dir = (-PI / 180.0) * (wavedir + 90.0)
    return dict(
        freq=freq, wt_freq=wt_freq, wavedir=wavedir, wt_dir=wt_dir,
        wlng_wtr=wlng_wtr, ap_wtr=ap_wtr, ag_wtr=ag_wtr, adv_dir=adv_dir,
    )


# ---------------------------------------------------------------------------
# Wave medium in ice (updateWaveMedium, wimdiscr.cpp:404-525)
# ---------------------------------------------------------------------------


def update_wave_medium(thick, ice_mask, sg: Dict[str, np.ndarray], p: WimParams):
    """Per-frequency dispersion + attenuation coefficients on the grid.
    The wavenumber guess chains across frequencies (wimdiscr.cpp:441-445),
    expressed as a `lax.scan` over the frequency axis."""
    freq = jnp.asarray(sg["freq"], thick.dtype)
    kw = dict(young=p.young, gravity=p.gravity, rhowtr=p.rhowtr,
              rhoice=p.rhoice, poisson=p.poisson)

    def body(guess, om):
        out = rtparam.rtparam_outer(thick, om, p.drag_rp, guess, **kw)
        return out["kice"], out

    om0 = 2 * PI * freq[0]
    init_guess = jnp.full_like(thick, 1.0) * om0**2 / p.gravity
    _, outs = jax.lax.scan(body, init_guess, 2 * PI * freq)

    nfq = len(sg["freq"])
    shape = (nfq,) + thick.shape
    b = lambda a: jnp.broadcast_to(jnp.asarray(a, thick.dtype)[:, None, None], shape)
    im = ice_mask[None, :, :] > 0.5
    wlng_ice = jnp.where(im, 2 * PI / outs["kice"], b(sg["wlng_wtr"]))
    disp_ratio = jnp.where(im, outs["kice"] * outs["modT"] / outs["kwtr"], 1.0)
    atten_nond = jnp.where(im, outs["atten_nond"], 0.0) if p.atten else jnp.zeros(shape, thick.dtype)
    damping = jnp.where(im, outs["damping"], 0.0) if p.atten else jnp.zeros(shape, thick.dtype)
    # group/phase speeds: water values everywhere (useicevel not implemented
    # in the reference either, wimdiscr.cpp:497-505)
    return dict(
        ag_eff=b(sg["ag_wtr"]), ap_eff=b(sg["ap_wtr"]), wlng_ice=wlng_ice,
        disp_ratio=disp_ratio, atten_nond=atten_nond, damping=damping,
    )


# ---------------------------------------------------------------------------
# Incident spectrum (setIncWaveSpec, wimdiscr.cpp:668-790)
# ---------------------------------------------------------------------------


def _theta_in_range(th, th1):
    """Map angle th into [th1, th1+360)."""
    return th - 360.0 * jnp.floor((th - th1) / 360.0)


def theta_dir_frac(th1, dtheta, mwd):
    """Integral of the cos^2 directional spreading over [th1, th1+dtheta]
    (wimdiscr.cpp:2499-2538)."""
    phi1 = _theta_in_range(mwd - 90.0, th1)
    phi2 = _theta_in_range(mwd + 90.0, th1)
    th2 = th1 + dtheta

    def seg(l1, l2):
        l2 = jnp.maximum(l1, l2)
        chi1 = PI * (l1 - mwd) / 180.0
        chi2 = PI * (l2 - mwd) / 180.0
        return 2.0 * (chi2 - chi1) + jnp.sin(2 * chi2) - jnp.sin(2 * chi1)

    # branch phi2 > phi1: single interval [max(th1,phi1), min(th2,phi2)]
    int_a = seg(jnp.maximum(th1, phi1), jnp.minimum(th2, phi2))
    # else: [th1, min(th2,phi2)] + [phi1, max(phi1,th2)]
    int_b = seg(jnp.full_like(phi1, th1), jnp.minimum(th2, phi2)) + seg(
        phi1, jnp.maximum(phi1, th2)
    )
    integral = jnp.where(phi2 > phi1, int_a, int_b)
    return integral / (2.0 * PI)


def inc_wave_spec(hs, tp, mwd, wave_mask, sg, p: WimParams):
    """Bretschneider frequency spectrum x cos^2 directional spreading
    (wimdiscr.cpp:668-757). Returns sdf (nfreq, ndir, ny, nx)."""
    dt_ = hs.dtype
    freq = jnp.asarray(sg["freq"], dt_)
    wavedir = jnp.asarray(sg["wavedir"], dt_)
    tp_s = jnp.maximum(tp, 1e-8)
    if p.nwavefreq == 1:
        sfreq = (hs / 4.0)[None] ** 2
    else:
        om = 2 * PI * freq[:, None, None]
        t_m = 2 * PI / om
        om_m = 2 * PI / tp_s[None]
        f1 = (5.0 / 16.0) * hs[None] ** 2 * om_m**4
        f2 = om**-5
        f3 = jnp.exp(-1.25 * (t_m / tp_s[None]) ** 4)
        sfreq = f1 * f2 * f3
    if p.nwavedirn == 1:
        theta_fac = jnp.ones((1,) + hs.shape, dt_)
    else:
        dtheta = float(abs(sg["wavedir"][1] - sg["wavedir"][0]))
        theta_fac = jnp.stack(
            [
                180.0 / (PI * dtheta)
                * theta_dir_frac(wavedir[nth] - dtheta / 2.0, dtheta, mwd)
                for nth in range(p.nwavedirn)
            ]
        )
    sdf = sfreq[:, None] * theta_fac[None, :]
    return jnp.where(wave_mask[None, None] > 0.5, sdf, 0.0)


# ---------------------------------------------------------------------------
# Mean floe size <D> (getDave / floeScaling*, iceinfo.cpp:277-383)
# ---------------------------------------------------------------------------


def dave_from_dfloe(dfloe, ice_mask, p: WimParams, moment: int = 1):
    dmax = dfloe
    if p.fsdopt == "RG":
        # discrete renormalisation-group cascade (floeScaling,
        # iceinfo.cpp:277-325) in closed form via geometric series:
        # nsum  = (1-f) sum_{m<mm} ffac^m            + ffac^mm
        # ndsum = (1-f) dmax^M sum_{m<mm} (ffac/xi^M)^m + ffac^mm (dmax/xi^mm)^M
        ffac = p.fragility * p.xi**2
        r = dmax / p.dmin
        mm = jnp.floor(jnp.log(jnp.maximum(r, 1.0)) / math.log(p.xi))
        mm = jnp.maximum(mm, 0.0)

        def geo(q, n):  # sum_{m=0}^{n-1} q^m, n>=0 (q != 1 here: ffac=3.6)
            return (jnp.power(q, n) - 1.0) / (q - 1.0)

        nsum = (1 - p.fragility) * geo(ffac, mm) + jnp.power(ffac, mm)
        qd = ffac / p.xi**moment
        ndsum = (1 - p.fragility) * dmax**moment * geo(qd, mm) + jnp.power(
            ffac, mm
        ) * (dmax / jnp.power(p.xi, mm)) ** moment
        dave_b = ndsum / jnp.maximum(nsum, 1e-15)
        dave = jnp.where(
            (dmax >= p.xi * p.dmin) & (mm > 0),
            dave_b,
            jnp.maximum(p.dmin**moment, dmax**moment),
        )
    else:
        # smooth power law P(d>D) = (Dmin/D)^fsd_exp (floeScalingSmooth,
        # iceinfo.cpp:328-356)
        fsd_exp = 2.0 + math.log(p.fragility) / math.log(p.xi)
        b = moment - fsd_exp
        dmax_s = jnp.maximum(dmax, p.dmin * (1 + 1e-6))
        a = fsd_exp * jnp.exp(fsd_exp * (math.log(p.dmin) + jnp.log(dmax_s)))
        a = a / (jnp.exp(fsd_exp * jnp.log(dmax_s)) - p.dmin**fsd_exp)
        dave_big = -(a / b) * (p.dmin**b - jnp.exp(b * jnp.log(dmax_s)))
        dave = jnp.where(dmax <= p.dmin, p.dmin**moment, dave_big)
    # uniform distribution above the MIZ threshold (getDave, iceinfo.cpp:375)
    dave = jnp.where(dmax >= p.dfloe_miz_thresh, dmax**moment, dave)
    return jnp.where(ice_mask > 0.5, dave, 0.0)


def dfloe_to_nfloes(dfloe, conc, p: WimParams):
    """(iceinfo.cpp:210-222)"""
    ok = (dfloe > 0) & (conc >= p.cice_min)
    return jnp.where(ok, conc / jnp.maximum(dfloe, 1e-6) ** 2, 0.0)


def nfloes_to_dfloe(nfloes, conc, p: WimParams):
    """(iceinfo.cpp:253-268)"""
    ok = (nfloes > 0) & (conc >= p.cice_min)
    d = jnp.where(ok, jnp.sqrt(jnp.maximum(conc, 1e-20) / jnp.maximum(nfloes, 1e-15)), 0.0)
    return jnp.minimum(d, p.dfloe_pack_thresh)


# ---------------------------------------------------------------------------
# WENO(3) predictor-corrector advection (gridinfo.cpp:592-824)
# ---------------------------------------------------------------------------

_NG = 4  # ghost width (>=4 required by the scheme, gridinfo.cpp:618-623)


def _pad(h, advopt: str):
    """padVar (gridinfo.cpp:826+): ghost cells periodic per advopt, zero
    otherwise. Axis 0 = y, axis 1 = x (waves propagate along x in the
    ideal setups, so 'y-periodic' wraps axis 0 only)."""
    wrap_y = advopt in ("xy-periodic", "y-periodic")
    wrap_x = advopt == "xy-periodic"
    out = jnp.pad(h, ((_NG, _NG), (0, 0)), mode="wrap" if wrap_y else "constant")
    return jnp.pad(out, ((0, 0), (_NG, _NG)), mode="wrap" if wrap_x else "constant")


def _weno_sao(g, u, v, dx: float, dy: float, dt, advdim: int):
    """One weno3pdV2 stage on padded arrays: returns the spatial advective
    operator sao (gridinfo.cpp:659-824). Face flux F[i] sits between cells
    i-1 and i and uses the cell-centred speed at i, exactly as the C."""
    eps = 1e-12
    scp2 = dx * dy
    scp2i = 1.0 / scp2

    def face_flux(gq, vel, axis, face_len):
        gm1 = jnp.roll(gq, 1, axis)
        gm2 = jnp.roll(gq, 2, axis)
        gp1 = jnp.roll(gq, -1, axis)
        pos = vel > 0.0
        q0p = -0.5 * gm2 + 1.5 * gm1
        q1p = 0.5 * gm1 + 0.5 * gq
        # frozen-limiter adjoint (VERDICT r4 #7): the nonlinear WENO weight
        # ratios carry 1/(|Δg|+1e-12) factors whose linearization amplifies
        # the reverse pass by up to ~1e12 per stage (measured: AD 5e7x the
        # converged FD after 4 substeps) while the primal stays exact. The
        # standard adjoint of limited schemes freezes the limiter weights
        # (linearize the stencil, not the limiter); stop_gradient is the
        # identity in the forward pass, so primal values are bit-unchanged
        # (tests/test_grad.py FD-checks the resulting adjoint).
        a1p = jax.lax.stop_gradient(
            (2.0 / 3.0) * (jnp.abs(gm2 - gm1) + eps) / (jnp.abs(gm1 - gq) + eps)
        )
        wp = ((1.0 / 3.0) * q0p + a1p * q1p) / ((1.0 / 3.0) + a1p)
        q0n = 0.5 * gm1 + 0.5 * gq
        q1n = 1.5 * gq - 0.5 * gp1
        a1n = jax.lax.stop_gradient(
            (1.0 / 3.0) * (jnp.abs(gm1 - gq) + eps) / (jnp.abs(gq - gp1) + eps)
        )
        wn = ((2.0 / 3.0) * q0n + a1n * q1n) / ((2.0 / 3.0) + a1n)
        fl = vel * jnp.where(pos, gm1, gq) * face_len
        fh = vel * jnp.where(pos, wp, wn) * face_len - fl
        return fl, fh

    ful, fuh = face_flux(g, u, 1, dy)
    if advdim == 2:
        fvl, fvh = face_flux(g, v, 0, dx)
    else:
        fvl = fvh = jnp.zeros_like(g)

    div_l = (jnp.roll(ful, -1, 1) - ful)
    if advdim == 2:
        div_l = div_l + (jnp.roll(fvl, -1, 0) - fvl)
    gt = g - dt * div_l * scp2i

    q = 0.25 / dt
    fuh = ful + jnp.maximum(
        -q * gt * scp2, jnp.minimum(q * jnp.roll(gt, 1, 1) * scp2, fuh)
    )
    if advdim == 2:
        fvh = fvl + jnp.maximum(
            -q * gt * scp2, jnp.minimum(q * jnp.roll(gt, 1, 0) * scp2, fvh)
        )
    sao = -(jnp.roll(fuh, -1, 1) - fuh)
    if advdim == 2:
        sao = sao - (jnp.roll(fvh, -1, 0) - fvh)
    return sao * scp2i


def weno_advect(h, u, v, dt, dx: float, dy: float, land_mask, advopt: str,
                advdim: int = 2):
    """waveAdvWeno (gridinfo.cpp:592-655): RK2 predictor-corrector with the
    weno3pd operator; land cells zeroed after the update."""
    gp = _pad(h, advopt)
    up = _pad(u, "xy-periodic")
    vp = _pad(v, "xy-periodic")
    sao1 = _weno_sao(gp, up, vp, dx, dy, dt, advdim)
    hp = gp + dt * sao1
    sao2 = _weno_sao(hp, up, vp, dx, dy, dt, advdim)
    out = 0.5 * (gp + hp + dt * sao2)[_NG:-_NG, _NG:-_NG]
    return out * (1.0 - land_mask)


# ---------------------------------------------------------------------------
# Attenuation (attenSimple / attenIsotropic, wimdiscr.cpp:2249-2494)
# ---------------------------------------------------------------------------


def attenuate_spectrum(s_fq, ag, atten_dim, damp_dim, imask, dfloe, cos_d,
                       sin_d, wt_dir, dt_wim, p: WimParams):
    """Attenuate one frequency's directional spectrum and form the direction
    integrals. Returns (s_new, taux_om, tauy_om, sfreq, sdx_om, sdy_om).

    scatmod='dissipated' (attenSimple, wimdiscr.cpp:2249-2324): scattered
    energy is lost; every direction decays with the total coefficient.

    scatmod='isotropic' (attenIsotropic, wimdiscr.cpp:2328-2494): scattered
    energy is redistributed isotropically — in directional Fourier space the
    mean (mode 0) decays only by damping while every higher mode decays by
    scattering + damping. NOTE the reference's implementation declares but
    never fills its `theta_vec`/`nvec` angle arrays (wimdiscr.cpp:2334-2339,
    all zeros), collapsing its transform; here the intended Fourier-mode
    evolution is implemented exactly (one FFT over the direction axis), with
    the same q_scat/q_abs split: floes smaller than dfloe_pack_init scatter,
    pack ice only absorbs (wimdiscr.cpp:2368-2378). Stress and Stokes-drift
    integrals are only formed inside ice in this mode, as in the reference.
    """
    in_ice = imask[None] > 0.5
    if not p.atten:
        taux_om = tauy_om = jnp.zeros_like(ag)
    elif p.scatmod == "isotropic":
        ndir = s_fq.shape[0]
        wt = 2 * PI / ndir
        scattering = dfloe < p.dfloe_pack_init
        q_scat = jnp.where(scattering, atten_dim, 0.0)
        q_abs = jnp.where(scattering, damp_dim, atten_dim + damp_dim)
        q_tot = q_scat + q_abs
        # direction-axis DFT in real arithmetic (full-precision matmuls,
        # ops/realfft.py)
        from nextsim_tpu.ops import realfft

        fft_re, fft_im = realfft.dft_leading(s_fq)
        # true mode-1 coefficient on the theta grid (theta_d = -pi + 2pi d/N
        # from adv_dir, so F[1] = -wt*FFT[1])
        f1_re, f1_im = -wt * fft_re[1], -wt * fft_im[1]
        taux_om = jnp.where(imask > 0.5, q_tot * ag * f1_re, 0.0)
        tauy_om = jnp.where(imask > 0.5, -q_tot * ag * f1_im, 0.0)
        n0 = jnp.arange(ndir) == 0
        decay = jnp.where(
            n0[:, None, None],
            jnp.exp(-q_abs * ag * dt_wim)[None],
            jnp.exp(-q_tot * ag * dt_wim)[None],
        )
        s_dec = realfft.idft_real_leading(fft_re * decay, fft_im * decay)
        s_fq = jnp.where(in_ice, s_dec.astype(s_fq.dtype), s_fq)
    else:  # dissipated
        alp = (atten_dim + damp_dim)[None]
        src = -alp * ag[None] * s_fq
        taux_om = jnp.sum(
            jnp.where(in_ice, -cos_d[:, None, None] * wt_dir[:, None, None] * src, 0.0),
            axis=0,
        )
        tauy_om = jnp.sum(
            jnp.where(in_ice, -sin_d[:, None, None] * wt_dir[:, None, None] * src, 0.0),
            axis=0,
        )
        s_fq = jnp.where(in_ice, s_fq * jnp.exp(-alp * ag[None] * dt_wim), s_fq)

    # full-precision direction sums: a float32 einsum may otherwise run in
    # TF32 on the GPU
    hi = jax.lax.Precision.HIGHEST
    sfreq = jnp.einsum("d,dyx->yx", wt_dir, s_fq, precision=hi)
    sdx_om = jnp.einsum("d,dyx->yx", wt_dir * cos_d, s_fq, precision=hi)
    sdy_om = jnp.einsum("d,dyx->yx", wt_dir * sin_d, s_fq, precision=hi)
    if p.atten and p.scatmod == "isotropic":
        sdx_om = jnp.where(imask > 0.5, sdx_om, 0.0)
        sdy_om = jnp.where(imask > 0.5, sdy_om, 0.0)
    return s_fq, taux_om, tauy_om, sfreq, sdx_om, sdy_om


# ---------------------------------------------------------------------------
# One WIM time step (wimdiscr.cpp:822-1210)
# ---------------------------------------------------------------------------


def wim_time_step(sdf, ice: Dict[str, Any], medium, sg_dev, p: WimParams,
                  dt_wim, dx: float, land_mask, steady_in=None):
    """Advance the directional spectrum one WIM substep and do breaking.

    sdf: (nfreq, ndir, ny, nx); ice: dict with conc, thick, dfloe, nfloes,
    broken, mask; medium: per-frequency wave-medium dict; steady_in:
    optional (sdf_inc, steady_mask) for the steady-state forcing.
    """
    conc, thick = ice["conc"], ice["thick"]
    imask = ice["mask"]
    dt_ = sdf.dtype
    adv_dir = jnp.asarray(sg_dev["adv_dir"], dt_)
    wt_dir = jnp.asarray(sg_dev["wt_dir"], dt_)
    wt_freq = jnp.asarray(sg_dev["wt_freq"], dt_)
    freq = jnp.asarray(sg_dev["freq"], dt_)
    cos_d = jnp.cos(adv_dir)
    sin_d = jnp.sin(adv_dir)

    # steady forcing (wimdiscr.cpp:893-908): directions travelling in +x
    if p.steady and steady_in is not None:
        sdf_inc, steady_mask = steady_in
        reset = (cos_d >= 0.0)[None, :, None, None] & (
            steady_mask[None, None] > 0.5
        )
        sdf = jnp.where(reset, sdf_inc, sdf)

    # mean floe size <D> (wimdiscr.cpp:912)
    dave = dave_from_dfloe(ice["dfloe"], imask, p, moment=1)
    c1d = jnp.where(imask > 0.5, conc / jnp.maximum(dave, 1e-6), 0.0)

    tau_fac = p.rhowtr * p.gravity

    def freq_body(_, xs):
        (s_fq, ag, cp, wlng, dispr, att_nond, damp, fq, wt) = xs
        om = 2 * PI * fq
        kicel = 2 * PI / wlng
        f_ = dispr
        f2 = f_**2 if p.ref_hs_ice else jnp.ones_like(f_)

        atten_dim = att_nond * c1d
        damp_dim = 2.0 * damp * conc

        # advect all directions (advectDirections, wimdiscr.cpp:2052-2072)
        def adv_one(s_th, cth, sth):
            return weno_advect(
                s_th, ag * cth, ag * sth, dt_wim, dx, dx, land_mask,
                p.advopt, p.advdim,
            )

        s_fq = jax.vmap(adv_one, in_axes=(0, 0, 0))(s_fq, cos_d, sin_d)

        # attenuation + direction integrals (attenSimple / attenIsotropic)
        s_fq, taux_om, tauy_om, sfreq, sdx_om, sdy_om = attenuate_spectrum(
            s_fq, ag, atten_dim, damp_dim, imask, ice["dfloe"], cos_d, sin_d,
            wt_dir, dt_wim, p,
        )

        # frequency integrals (wimdiscr.cpp:989-1070)
        acc = dict(
            tau_x=wt * tau_fac * taux_om / cp,
            tau_y=wt * tau_fac * tauy_om / cp,
            mwd_x=wt * f2 * sdx_om,
            mwd_y=wt * f2 * sdy_om,
            sd_x=wt * 2 * om * kicel * f2 * sdx_om,
            sd_y=wt * 2 * om * kicel * f2 * sdy_om,
            mom0w=jnp.abs(wt * sfreq),
            mom2w=jnp.abs(wt * om**2 * sfreq),
            mom0=jnp.abs(wt * sfreq * f_**2),
            mom2=jnp.abs(wt * om**2 * sfreq * f_**2),
            var_strain=jnp.where(
                imask > 0.5,
                jnp.abs(wt * sfreq * (f_ * kicel**2 * thick / 2.0) ** 2),
                0.0,
            ),
        )
        return None, (s_fq, acc)

    xs = (
        sdf, medium["ag_eff"], medium["ap_eff"], medium["wlng_ice"],
        medium["disp_ratio"], medium["atten_nond"], medium["damping"],
        freq, wt_freq,
    )
    _, (sdf_new, accs) = jax.lax.scan(freq_body, None, xs)
    tot = {k: jnp.sum(v, axis=0) for k, v in accs.items()}

    # integrated wave parameters (wimdiscr.cpp:1115-1146)
    mom0 = tot["mom0"] if p.ref_hs_ice else tot["mom0w"]
    mom2 = tot["mom2"] if p.ref_hs_ice else tot["mom2w"]
    hs = 4.0 * jnp.sqrt(mom0 + 1e-20)
    tp_ = jnp.where(mom2 > 0.0, 2 * PI * jnp.sqrt(jnp.maximum(mom0, 1e-20) / jnp.maximum(mom2, 1e-15)), 0.0)
    mwd = jnp.where(
        mom2 > 0.0, -90.0 - (180.0 / PI) * jnp.arctan2(tot["mwd_y"], tot["mwd_x"]), 0.0
    )

    # floe breaking (doBreaking, iceinfo.cpp:172-203)
    dfloe, nfloes, broken = ice["dfloe"], ice["nfloes"], ice["broken"]
    if p.breaking:
        crit = (imask > 0.5) & (2.0 * tot["var_strain"] > p.epsc**2)
        om_b = jnp.sqrt(jnp.maximum(tot["mom2"], 1e-20) / jnp.maximum(tot["mom0"], 1e-15))
        om_b = jnp.maximum(om_b, 1e-3)  # keep the masked-out Newton finite
        out_b = rtparam.rtparam_outer(
            thick, om_b, p.drag_rp, om_b**2 / p.gravity,
            young=p.young, gravity=p.gravity, rhowtr=p.rhowtr,
            rhoice=p.rhoice, poisson=p.poisson,
        )
        lam = 2 * PI / out_b["kice"]
        brk = crit & (lam < 2.0 * dfloe)
        dfloe = jnp.where(brk, jnp.maximum(p.dmin, lam / 2.0), dfloe)
        nfloes = jnp.where(brk, dfloe_to_nfloes(dfloe, conc, p), nfloes)
        broken = jnp.where(brk, 1.0, broken)

    ice_new = dict(ice, dfloe=dfloe, nfloes=nfloes, broken=broken)
    diag = dict(
        hs=hs, tp=tp_, mwd=mwd,
        tau_x=tot["tau_x"], tau_y=tot["tau_y"],
        stokes_x=tot["sd_x"], stokes_y=tot["sd_y"],
        mwd_x=tot["mwd_x"], mwd_y=tot["mwd_y"],
        mom0=mom0, mom2=mom2, var_strain=tot["var_strain"],
    )
    return sdf_new, ice_new, diag


# ---------------------------------------------------------------------------
# Run driver (WimDiscr::run, wimdiscr.cpp:1938-2050)
# ---------------------------------------------------------------------------


class Wim:
    """Host-side WIM driver on the model grid.

    Standalone (reference uncoupled nextwim.exec): `ideal_ice_fields` +
    `ideal_wave_fields` then `run(duration)`. Coupled: the Simulator calls
    `couple(conc, vol, nfloes, swh, mwp, mwd, duration)` every
    ``nextwim.couplingfreq`` steps and receives wave stress + breakage.
    """

    def __init__(self, params: WimParams, grid, dtype=jnp.float32, mesh=None):
        self.p = params
        self.grid = grid
        self.dtype = dtype
        self.sg = spectral_grids(params)
        ny, nx = grid.shape
        self.shape = (ny, nx)
        # host constant: closed over by the jit (a multi-process jit may not
        # close over device arrays; GSPMD shards closed-over constants)
        self.land = np.asarray(1.0 - np.asarray(grid.mask), np.dtype(dtype))
        self.dx = float(grid.dx)
        # multi-chip: the spectrum (nfreq, ndir, ny, nx) and every ice/medium
        # plane are block-sharded over the same ('y','x') device mesh as the
        # sea-ice state (the reference runs the WIM inside the same MPI
        # decomposition: wimdiscr.cpp:822-1210 timeStep, gridinfo.cpp WENO
        # advection over the partitioned grid). The WENO rolls/pads become
        # GSPMD halo collectives. Own-grid shapes that do not divide the
        # mesh fall back to the unsharded path.
        self.mesh = None
        if mesh is not None:
            dpy, dpx = mesh.devices.shape
            if ny % dpy == 0 and nx % dpx == 0:
                self.mesh = mesh
        self.sdf = jnp.zeros(
            (params.nwavefreq, params.nwavedirn, ny, nx), dtype
        )
        if self.mesh is not None:
            from nextsim_tpu.parallel.sharding import shard_tree

            self.sdf = shard_tree(self.sdf, self.mesh)
        self.ice: Optional[Dict[str, Any]] = None
        self.diag: Dict[str, Any] = {}
        self._steady_in = None
        # CFL-limited spectral step (update(), wimdiscr.cpp:390-398);
        # group speeds are the open-water ones -> static timestep
        self.max_cg = float(np.max(self.sg["ag_wtr"]))
        self.dt_cfl = params.cfl * self.dx / self.max_cg
        self._run_jit = jax.jit(self._run_scan, static_argnames=("n_steps",))

    # -- ice / wave setup ------------------------------------------------
    def set_ice_fields(self, conc, vol, nfloes):
        """(IceInfo::setFields + updateFields, iceinfo.cpp:85-164)"""
        p = self.p
        conc = jnp.asarray(conc, self.dtype)
        vol = jnp.asarray(vol, self.dtype)
        nfloes = jnp.asarray(nfloes, self.dtype)
        keep = conc >= p.cice_min
        conc = jnp.where(keep, conc, 0.0)
        vol = jnp.where(keep, vol, 0.0)
        nfloes = jnp.where(keep, nfloes, 0.0)
        thick = jnp.where(keep, vol / jnp.maximum(conc, 1e-12), 0.0)
        dfloe = nfloes_to_dfloe(nfloes, conc, p)
        # `broken` marks cells whose floes are in a broken state (dfloe below
        # the unbroken-pack size); new breakage this window ORs into it in
        # wim_time_step. Persistent (not newly-broken-only) so the coupled
        # damage/FSD feeds see the full broken zone each window — applied
        # with max()/idempotent redistribution, so this matches the
        # reference's break_on_mesh effect (wimdiscr.cpp breaking on mesh).
        broken = keep & (dfloe > 0.0) & (dfloe < p.dfloe_pack_init)
        self.ice = dict(
            conc=conc, vol=vol, nfloes=nfloes, thick=thick, dfloe=dfloe,
            mask=keep.astype(self.dtype), broken=broken.astype(self.dtype),
        )

    def ideal_ice_fields(self, xfac: float = 0.7):
        """Uniform ice for x >= x_edge (idealIceFields, wimdiscr.cpp:793-820)."""
        p = self.p
        x = jnp.asarray(self._cell_x(), self.dtype)
        xmin, xmax = float(x.min()), float(x.max())
        x_edge = 0.5 * (xmin + xmax) - xfac * 0.5 * (xmax - xmin)
        in_ice = (x >= x_edge) & (self.land < 0.5)
        conc = jnp.where(in_ice, p.unifc, 0.0)
        vol = conc * p.unifh
        nfloes = jnp.where(in_ice, p.unifc / p.dfloe_pack_init**2, 0.0)
        self.set_ice_fields(conc, vol, nfloes)

    def ideal_wave_fields(self, xfac: float = 0.8):
        """Incident waves for x < x_edge (idealWaveFields, wimdiscr.cpp:527-566)."""
        p = self.p
        x = jnp.asarray(self._cell_x(), self.dtype)
        xmin, xmax = float(x.min()), float(x.max())
        x_edge = 0.5 * (xmin + xmax) - xfac * 0.5 * (xmax - xmin)
        wave_mask = ((x < x_edge) & (self.land < 0.5)).astype(self.dtype)
        hs = wave_mask * p.hs_inc
        tp_ = wave_mask * p.tp_inc
        mwd = wave_mask * p.mwd_inc
        self.set_wave_fields(hs, tp_, mwd, wave_mask=wave_mask)

    def set_wave_fields(self, swh, mwp, mwd, wave_mask=None):
        """(setWaveFields, wimdiscr.cpp:568-664)"""
        p = self.p
        swh = jnp.asarray(swh, self.dtype)
        mwp = jnp.asarray(mwp, self.dtype)
        mwd = jnp.asarray(mwd, self.dtype)
        if wave_mask is None:
            ice_mask = self.ice["mask"] if self.ice is not None else 0.0
            wave_mask = (
                (ice_mask < 0.5) & (self.land < 0.5)
                & (swh > 1e-3) & (mwp > 1e-8) & (mwp < 1.5 * p.tmax)
            ).astype(self.dtype)
        inc = inc_wave_spec(swh, mwp, mwd, wave_mask, self.sg, p)
        self.sdf = jnp.where(wave_mask[None, None] > 0.5, inc, self.sdf)
        if p.steady and self._steady_in is None:
            self._steady_in = (self.sdf, wave_mask)

    def _cell_x(self):
        return np.broadcast_to(
            np.arange(self.shape[1]) * self.dx, self.shape
        )

    # -- integration -----------------------------------------------------
    def _run_scan(self, sdf, ice, medium, steady_in, dt_wim, n_steps: int):
        p = self.p

        def body(carry, _):
            sdf, ice = carry
            sdf, ice, diag = wim_time_step(
                sdf, ice, medium, self.sg, p, dt_wim, self.dx, self.land,
                steady_in,
            )
            if self.mesh is not None:
                # keep the scan carry block-sharded (GSPMD would otherwise be
                # free to replicate it between substeps)
                from nextsim_tpu.parallel.sharding import constrain_tree

                sdf = constrain_tree(sdf, self.mesh)
                ice = constrain_tree(ice, self.mesh)
            return (sdf, ice), diag

        (sdf, ice), diags = jax.lax.scan(body, (sdf, ice), None, length=n_steps)
        last = {k: v[-1] for k, v in diags.items()}
        return sdf, ice, last

    def run(self, duration: float) -> Dict[str, Any]:
        """Integrate the spectrum over `duration` seconds (run(),
        wimdiscr.cpp:1938-2050). Returns the final diagnostics dict."""
        if self.ice is None:
            self.ideal_ice_fields(0.7)
        if not bool(jnp.any(self.sdf > 0)) and self._steady_in is None:
            self.ideal_wave_fields(0.8)
        n_steps = max(1, int(math.ceil(duration / self.dt_cfl)))
        dt_wim = duration / n_steps
        medium = update_wave_medium(
            self.ice["thick"], self.ice["mask"], self.sg, self.p
        )
        steady = self._steady_in if self.p.steady else None
        if steady is None:
            # scan needs structurally static carry inputs
            steady = (jnp.zeros_like(self.sdf), jnp.zeros(self.shape, self.dtype))
        sdf, ice = self.sdf, self.ice
        if self.mesh is not None:
            from nextsim_tpu.parallel.sharding import shard_tree

            sdf = shard_tree(sdf, self.mesh)
            ice = shard_tree(ice, self.mesh)
            medium = shard_tree(medium, self.mesh)
            steady = shard_tree(steady, self.mesh)
        self.sdf, self.ice, self.diag = self._run_jit(
            sdf, ice, medium, steady,
            jnp.asarray(dt_wim, self.dtype), n_steps,
        )
        return self.diag
