"""Wave–ice scattering/attenuation parameters (RTparam), pure JAX.

JAX reimplementation of the reference WIM's RTparam stack
(reference: modules/wim/src/RTparam_outer.c, RTparam_fast.c,
RTparam_hardcoded.c) — the per-floe scattering model of Kohout & Meylan
(2008) as used by Williams et al. (2013a,b):

* Newton solves of the open-water and ice-covered (thin-elastic-plate)
  dispersion relations in non-dimensional form (RTparam_outer.c:118-225),
  vectorised over cells with a fixed-iteration `lax.fori_loop` instead of
  the reference's per-cell `while |dk|>eps` (Newton is quadratically
  convergent; extra iterations at the root are no-ops).
* 2-D Chebyshev interpolation of the pre-computed attenuation /
  reflection-transmission tables over the (alp_nd, h_nd) plane
  (RTparam_fast.c:16-584). The ten coefficient tables are physical data,
  extracted verbatim from the reference by tools/extract_rtparam_tables.py
  into rtparam_tables.npz; here they are evaluated as one batched
  Chebyshev tensor contraction with a per-cell one-hot regime select —
  branch-free.

Outputs match RTparam_outer's `outputs[8]`:
  damping, kice, kwtr, int_adm, atten_nond (ac), modT, argR, argT.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

_H_ND = 4.0  # infinite-depth proxy used in the scattering model (RTparam_outer.c:23)

# regime tables (RTparam_fast.c:24-31)
_ALP_LIMS_BASE = (1.0e-6, 0.005, 0.3, 1.5)  # lims[0..3]; [4],[5] are h-dependent
_MC_ALPLIN = (-3.323529252398524, 3.119943407349375)
_Y0_LL, _DY_LL, _N_LL, _H1_LL = 40.0, 120.0, 3, 0.4
_HND_LIMS = (1.0e-2, 0.2, 0.4)
_LOG_A = (1, 1, 1, 0, 1)  # log-interp in alp_nd per OPT
_INTERP_MODE = (1, 1, 3, 2, 1)  # per OPT (RTparam_fast.c:145)
_PREC = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=1)
def _load_tables():
    path = os.path.join(os.path.dirname(__file__), "rtparam_tables.npz")
    with np.load(path) as f:
        # cache as numpy; converted per-call (a jnp array created inside a
        # trace would leak a tracer out of the cache)
        return np.asarray(f["tables"]), np.asarray(f["ncx"]), np.asarray(f["ncy"])


# ---------------------------------------------------------------------------
# Dispersion-relation Newton solvers
# ---------------------------------------------------------------------------

def _nr_corr_term(k, delta, H, fac):
    """Newton correction dk = f/f' for the (non-dimensional) dispersion
    function f = Lam*k*sinh(kH) - cosh(kH), Lam = fac*k^4 + delta
    (reference: RTparam_outer.c:197-222). fac=1 → ice plate, fac=0 → water."""
    k4 = k * k * k * k
    lam = fac * k4 + delta
    lampr = 5.0 * fac * k4 + delta
    kh = k * H
    small = jnp.abs(kh) <= 7.5
    khc = jnp.clip(kh, -7.5, 7.5)  # keep the unselected sinh branch finite
    f_s = lam * k * jnp.sinh(khc) - jnp.cosh(khc)
    df_s = lam * khc * jnp.cosh(khc) + (lampr - H) * jnp.sinh(khc)
    f_t = lam * k * jnp.tanh(kh) - 1.0
    df_t = lam * kh + (lampr - H) * jnp.tanh(kh)
    f = jnp.where(small, f_s, f_t)
    df = jnp.where(small, df_s, df_t)
    return f / df, lam, lampr


def _gen_root(guess, delta, H, fac, iters: int = 60):
    """Find the dispersion root nearest `guess` (gen_root_{ice,wtr},
    RTparam_outer.c:118-196). Returns (k, BG, avc)."""

    def body(_, k):
        dk, _, _ = _nr_corr_term(k, delta, H, fac)
        return k - dk

    k = jax.lax.fori_loop(0, iters, body, guess)
    k = jnp.abs(k)  # may converge to the negative root
    _, lam, lampr = _nr_corr_term(k, delta, H, fac)
    denom = H * (lam * lam * k * k - 1.0) + lampr
    res = -k / denom
    bg = lam * lam * res
    avc = k / denom
    return k, bg, avc


# ---------------------------------------------------------------------------
# Chebyshev table interpolation (RTparam_fast)
# ---------------------------------------------------------------------------

def _cheb_basis(t, order: int = 10):
    """T_0..T_order at t, shape (..., order+1), by the three-term recurrence."""
    ts = [jnp.ones_like(t), t]
    for _ in range(order - 1):
        ts.append(2.0 * t * ts[-1] - ts[-2])
    return jnp.stack(ts, axis=-1)


def _cheb_interp(t_a, t_h, tidx, tables):
    """z[..., q] = sum_mn T_m(t_a) tables[tidx, m, n, q] T_n(t_h): the 2-D
    Chebyshev sums of every table, then a one-hot pick of each cell's
    table. Both products run at full precision: a float32 einsum may
    otherwise run in TF32."""
    tx = _cheb_basis(t_a)  # (..., 11) in alp
    ty = _cheb_basis(t_h)  # (..., 11) in h
    z_all = jnp.einsum("...m,tmnq,...n->...tq", tx, tables, ty,
                       precision=_PREC)
    onehot = jax.nn.one_hot(tidx, tables.shape[0], dtype=t_a.dtype)
    return jnp.einsum("...tq,...t->...q", z_all, onehot, precision=_PREC)


def _rtparam_fast(alp_nd, hnd, int_adm):
    """Interpolated attenuation coefficient + |T|, arg R, arg T
    (reference: RTparam_fast.c:16-128 regime selection, 130-445 dispatch,
    589-638 interpretation). Fully vectorised / branch-free."""
    tables_np, _, _ = _load_tables()
    tables = jnp.asarray(tables_np, alp_nd.dtype)

    # h-dependent regime limits (computed from the raw hnd, as in the C)
    hnd_safe = jnp.clip(hnd, _HND_LIMS[0], _H1_LL)
    alp_lin3 = _MC_ALPLIN[1] + _MC_ALPLIN[0] * jnp.log(hnd_safe)
    dtmp = jnp.maximum(jnp.cos(hnd_safe / _H1_LL * jnp.pi / 2.0), 1e-30)
    alp_lin4 = _Y0_LL + _DY_LL * dtmp ** _N_LL

    # thickness regime
    hnd_c = jnp.clip(hnd, _HND_LIMS[0], _HND_LIMS[2])
    low = hnd_c < _HND_LIMS[1]
    h0 = jnp.where(low, _HND_LIMS[0], _HND_LIMS[1])
    h1 = jnp.where(low, _HND_LIMS[1], _HND_LIMS[2])
    t_h_log = -1.0 + 2.0 * (jnp.log(hnd_c) - jnp.log(h0)) / (jnp.log(h1) - jnp.log(h0))
    t_h_lin = -1.0 + 2.0 * (hnd_c - h0) / (h1 - h0)
    t_h = jnp.where(low, t_h_log, t_h_lin)

    # frequency regime: lims[0..5]; OPT = index of the bracketing interval
    lims = jnp.stack(
        [jnp.full_like(alp_nd, l) for l in _ALP_LIMS_BASE] + [alp_lin3, alp_lin4],
        axis=-1,
    )
    alp_c = jnp.clip(alp_nd, lims[..., 0], lims[..., 5])
    # opt in {0..4}: number of lims[1..4] strictly below alp_c
    opt = jnp.sum(alp_c[..., None] >= lims[..., 1:5], axis=-1)
    opt = jnp.clip(opt, 0, 4)
    a0 = jnp.take_along_axis(lims, opt[..., None], axis=-1)[..., 0]
    a1 = jnp.take_along_axis(lims, opt[..., None] + 1, axis=-1)[..., 0]
    log_a = jnp.asarray(_LOG_A, alp_nd.dtype)[opt]
    t_a_log = -1.0 + 2.0 * (jnp.log(alp_c) - jnp.log(a0)) / (jnp.log(a1) - jnp.log(a0))
    t_a_lin = -1.0 + 2.0 * (alp_c - a0) / (a1 - a0)
    t_a = jnp.where(log_a > 0.5, t_a_log, t_a_lin)

    # table index = LOW*5 + OPT (tables zero-padded to (10,11,11,4))
    tidx = jnp.where(low, 5, 0) + opt
    z = _cheb_interp(t_a, t_h, tidx, tables)

    im = jnp.asarray(_INTERP_MODE)[opt]  # 1, 2 or 3
    # modes 1/2: z = (log-)ac, argR, argT
    ac_12 = jnp.where(im == 1, jnp.exp(z[..., 0]), z[..., 0])
    arg_r_12 = z[..., 1]
    arg_t_12 = z[..., 2]
    mod_t_12 = jnp.sqrt(jnp.exp(-ac_12 / 2.0) / int_adm)
    # mode 3: z = Re R, Im R, Re T, Im T
    rr, ri, tr, ti = z[..., 0], z[..., 1], z[..., 2], z[..., 3]
    arg_r_3 = jnp.arctan2(ri, rr)
    arg_t_3 = jnp.arctan2(ti, tr)
    mod_r2 = rr * rr + ri * ri
    mod_t_3 = jnp.sqrt(tr * tr + ti * ti)
    ac_3 = -2.0 * jnp.log(jnp.maximum(1.0 - mod_r2, 1e-30))

    is3 = im == 3
    ac = jnp.where(is3, ac_3, ac_12)
    mod_t = jnp.where(is3, mod_t_3, mod_t_12)
    arg_r = jnp.where(is3, arg_r_3, arg_r_12)
    arg_t = jnp.where(is3, arg_t_3, arg_t_12)
    return ac, mod_t, arg_r, arg_t


# ---------------------------------------------------------------------------
# Outer driver
# ---------------------------------------------------------------------------

def rtparam_outer(h, om, visc_rp, guess, *, young=5.49e9, gravity=9.81,
                  rhowtr=1025.0, rhoice=922.5, poisson=0.3):
    """Vectorised RTparam_outer (reference: RTparam_outer.c:16-112).

    Args are broadcastable arrays: ice thickness h [m], radian frequency om,
    Robinson-Palmer drag visc_rp [Pa s/m], and an initial wavenumber guess
    [1/m] for the ice dispersion root.

    Returns a dict: damping [1/m], kice [1/m], kwtr [1/m], int_adm,
    atten_nond (ac, per-floe non-dimensional attenuation), modT, argR, argT.
    """
    h = jnp.asarray(h)
    hs = jnp.maximum(h, 1e-6)  # guard h=0 lanes (masked out by callers)
    rho = rhoice / rhowtr
    flex = young * hs ** 3 / 12.0 / (1.0 - poisson ** 2)
    L = jnp.exp(0.2 * jnp.log(flex / rhowtr / (om * om)))
    alp_nd = om * om / gravity * L
    h_nd = hs / L
    zeta_nd = rho * h_nd

    # ice wavenumber
    varpi_i = 1.0 / alp_nd - zeta_nd
    ki, bg2, avc = _gen_root(guess * L, varpi_i, _H_ND, 1.0)
    kice = ki / L

    # water wavenumber
    varpi_w = 1.0 / alp_nd
    hw_nd = _H_ND + zeta_nd
    kw, bg1, _ = _gen_root(alp_nd, varpi_w, hw_nd, 0.0)
    kwtr = kw / L

    int_adm = bg1 / bg2

    visc_rp_nd = visc_rp / rhowtr / om / L
    damping = avc * visc_rp_nd / L

    ac, mod_t, arg_r, arg_t = _rtparam_fast(alp_nd, h_nd, int_adm)
    return {
        "damping": damping,
        "kice": kice,
        "kwtr": kwtr,
        "int_adm": int_adm,
        "atten_nond": ac,
        "modT": mod_t,
        "argR": arg_r,
        "argT": arg_t,
    }
