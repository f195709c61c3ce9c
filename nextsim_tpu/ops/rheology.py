"""Sea-ice rheology: pointwise stress/damage updates.

Three rheologies, exactly mirroring the reference formulas:

* **BBM** (Brittle Bingham-Maxwell, the default) — stress relaxation with
  damage and plasticity (reference: FiniteElement::updateSigmaDamage,
  model/finiteelement.cpp:4137-4260; Olason et al. 2024).
* **EVP / mEVP** — elastic-visco-plastic toward the Hibler ellipse
  (reference: updateSigmaVP/EVP/MEVP, model/finiteelement.cpp:10649-10726).

All functions are pure elementwise maps over cell arrays — they fuse into the
surrounding momentum kernel under jit (no cross-cell dependence beyond the
strain rates computed by the caller).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax.numpy as jnp

from nextsim_tpu.core import constants as phys


def _fast_pow(x, e: float):
    """x**e with small-integer / half-integer exponents strength-reduced to
    multiplies and sqrts (generic pow is an exp-log pair and sits on the
    substep critical path)."""
    if e == int(e) and 0 <= int(e) <= 8:
        n = int(e)
        out = None
        acc = x
        while n:
            if n & 1:
                out = acc if out is None else out * acc
            acc = acc * acc
            n >>= 1
        return out if out is not None else jnp.ones_like(x)
    if (2.0 * e) == int(2.0 * e) and 0 < e < 8:  # half-integer, e.g. 1.5
        # +1e-20 keeps sqrt's reverse derivative finite at x=0 (thickness^1.5
        # on bare-ocean cells); invisible in float32 for any real thickness
        return _fast_pow(x, e - 0.5) * jnp.sqrt(x + 1e-20)
    return x**e


@dataclasses.dataclass(frozen=True)
class BBMParams:
    """BBM constants (reference: initOptAndParam, finiteelement.cpp:1047-1491)."""

    young: float = 5.9605e8  # undamaged Young modulus [Pa] (dynamics.young)
    nu0: float = 1.0 / 3.0  # Poisson ratio (dynamics.nu0)
    compaction_param: float = -20.0  # ridging exponent C (dynamics.compaction_param)
    compr_strength: float = 1e10  # scaled by scale_coef at init! [Pa]
    tan_phi: float = 0.7  # internal friction (dynamics.tan_phi)
    compression_factor: float = 10e3  # P in Pmax (dynamics.compression_factor)
    exponent_compression_factor: float = 1.5  # h exponent (dynamics.exponent_compression_factor)
    undamaged_time_relaxation_sigma: float = 1e7  # lambda0 [s]
    exponent_relaxation_sigma: float = 5.0  # alpha
    min_c_rheology: float = 0.1  # concentration floor (hard-coded, fe.cpp:4146)

    @property
    def dunit(self) -> Tuple[float, ...]:
        """Plane-stress stiffness entries (reference: initFETensors,
        finiteelement.cpp:1491-1507): D/(1-nu^2) with rows (xx, yy, xy)."""
        f = 1.0 / (1.0 - self.nu0**2)
        return (f, f * self.nu0, f * (1.0 - self.nu0) / 2.0)


def bbm_update(
    sigma,  # (3, ny, nx) sxx, syy, sxy
    damage,  # (ny, nx)
    conc,
    thick,
    cohesion,  # (ny, nx) C_fix + C_alea*random  [Pa]
    time_relaxation_damage,  # (ny, nx) healing time [s]
    eps11,
    eps22,
    eps12,
    delta_x,  # scalar or (ny,nx): local mesh length scale [m]
    dt: float,
    p: BBMParams,
    expC=None,  # optional precomputed exp(C*(1-conc)) — loop-invariant
    Pmax=None,  # optional precomputed P*h^1.5*expC — loop-invariant
    heal_rate=None,  # optional precomputed dt/t_heal*expC — loop-invariant
    rtd_coef=None,  # optional precomputed sqrt(E0*expC)/(dx*c_d) — loop-invariant
):
    """One BBM sub-step (reference: updateSigmaDamage, finiteelement.cpp:
    4137-4260). Returns (sigma, damage).

    ``conc`` and ``thick`` are frozen during the substep loop, so callers can
    hoist ``expC`` and ``Pmax`` out of the loop (the exp/pow transcendentals
    otherwise sit on the substep critical path)."""
    sxx, syy, sxy, damage = bbm_update_planes(
        sigma[0], sigma[1], sigma[2], damage, conc, thick, cohesion,
        time_relaxation_damage, eps11, eps22, eps12, delta_x, dt, p,
        expC=expC, Pmax=Pmax, heal_rate=heal_rate, rtd_coef=rtd_coef,
    )
    return jnp.stack([sxx, syy, sxy]), damage


def bbm_update_planes(
    sxx, syy, sxy,
    damage,
    conc,
    thick,
    cohesion,
    time_relaxation_damage,
    eps11,
    eps22,
    eps12,
    delta_x,
    dt: float,
    p: BBMParams,
    expC=None,
    Pmax=None,
    heal_rate=None,
    rtd_coef=None,
):
    """`bbm_update` on separate stress planes (avoids the per-substep
    stack/unstack of the (3, ny, nx) carry in the momentum loop). Returns
    (sxx, syy, sxy, damage)."""

    # no-ice cells: sigma=0, damage=0 (fe.cpp:4150-4159)
    has_ice = conc > p.min_c_rheology

    # --- stress update (fe.cpp:4183-4210) ---------------------------------
    sigma_n = 0.5 * (sxx + syy)
    if expC is None:
        expC = jnp.exp(p.compaction_param * (1.0 - conc))
    dmg_el = (1.0 - damage) * expC
    # Floor the relaxation-time base: dmg_el^(alpha-1) underflows float32 for
    # heavily damaged low-concentration ice (e.g. (1-d)*expC ~ 3e-10 -> ^4 ~
    # 1e-38 -> flushed to 0), and with tildeP capped at exactly 1 the
    # multiplicator below becomes 0/0 = NaN. The floor keeps time_viscous
    # positive-but-negligible, reproducing the reference's float64 behaviour
    # (multiplicator -> 1-1e-12 in the fully plastic-capped branch, ~0
    # otherwise).
    time_viscous = p.undamaged_time_relaxation_sigma * _fast_pow(
        jnp.maximum(dmg_el, 1e-8), p.exponent_relaxation_sigma - 1.0
    )

    # plastic failure tildeP folded into the multiplicator (fe.cpp:4189-4210).
    # Reference form: tildeP = min(1, Pmax/s) for s = -sigma_n > 0 (else 0),
    # multiplicator = min(1-1e-12, tv / (tv + dt*(1-tildeP))). Scaling
    # numerator and denominator by s turns the two divisions into one:
    # s*(1-tildeP) = max(s - Pmax, 0) in compression, s otherwise. The
    # numerator floor keeps the fully-plastic-capped limit (0/0 -> 1-1e-12)
    # when tv*s underflows float32.
    if Pmax is None:
        Pmax = _fast_pow(thick, p.exponent_compression_factor) * p.compression_factor * expC
    compressing = sigma_n < 0.0
    # floors at 1e-15 (not 1e-30): their squares must stay float32-normal so
    # the division's reverse derivative is finite (x/(y*y) with y^2
    # underflowed to 0 gives inf and 0*inf = NaN on masked lanes)
    s_mag = jnp.maximum(-sigma_n, 1e-15)
    s_unyielded = jnp.where(compressing, jnp.maximum(s_mag - Pmax, 0.0), s_mag)
    tv_s = jnp.maximum(time_viscous * s_mag, 1e-15)
    multiplicator = jnp.minimum(1.0 - 1e-12, tv_s / (tv_s + dt * s_unyielded))

    elasticity = p.young * dmg_el
    d0, d1, d2 = p.dunit
    # sigma += dt*E*(Dunit @ eps); Dunit = [[d0,d1,0],[d1,d0,0],[0,0,d2]]
    sxx = (sxx + dt * elasticity * (d0 * eps11 + d1 * eps22)) * multiplicator
    syy = (syy + dt * elasticity * (d1 * eps11 + d0 * eps22)) * multiplicator
    sxy = (sxy + dt * elasticity * (d2 * eps12)) * multiplicator

    # --- damage criterion (fe.cpp:4216-4243) ------------------------------
    half_diff = 0.5 * (sxx - syy)
    # +1e-20 (≈1e-10 Pa at exactly zero stress, invisible in float32
    # otherwise) keeps the norm's reverse-mode derivative finite under AD
    sigma_s = jnp.sqrt(half_diff * half_diff + sxy * sxy + 1e-20)
    sigma_n = 0.5 * (sxx + syy)

    # Mohr-Coulomb + compressive failure (Plante & Tremblay form). Both
    # branches are ratios — select numerator/denominator per lane and divide
    # once (a division costs several multiplies and this is the substep
    # critical path).
    compressive = sigma_n < -p.compr_strength
    dcrit_num = jnp.where(compressive, -p.compr_strength, cohesion)
    dcrit_den = jnp.where(
        compressive,
        jnp.minimum(sigma_n, -1e-15),
        jnp.maximum(sigma_s + p.tan_phi * sigma_n, 1e-15),
    )
    dcrit = dcrit_num / dcrit_den

    failing = (dcrit > 0.0) & (dcrit < 1.0)
    # characteristic damage time t_d = dx*sqrt(2*(1+nu)*rhoi)/sqrt(E)
    # (fe.cpp:4230); 1/t_d = rtd_coef*sqrt(1-damage) with the loop-invariant
    # factor sqrt(E0*expC)/(dx*c_d) hoistable by the caller.
    if rtd_coef is None:
        sqrt_nu_rhoi = math.sqrt(2.0 * (1.0 + p.nu0) * phys.rhoi)
        rtd_coef = jnp.sqrt(p.young * expC) / (delta_x * sqrt_nu_rhoi)
    rtd = rtd_coef * jnp.sqrt(jnp.maximum(1.0 - damage, 0.0) + 1e-20)
    relax = (1.0 - dcrit) * dt * rtd
    relax = jnp.where(failing, relax, 0.0)

    damage_new = damage + (1.0 - damage) * relax
    # elastic stress relaxation on failure (fe.cpp:4241-4242)
    sxx = sxx * (1.0 - relax)
    syy = syy * (1.0 - relax)
    sxy = sxy * (1.0 - relax)

    # --- healing (fe.cpp:4254-4257) ---------------------------------------
    if heal_rate is None:
        heal_rate = dt / time_relaxation_damage * expC
    damage_new = jnp.maximum(0.0, damage_new - heal_rate)

    sxx = jnp.where(has_ice, sxx, 0.0)
    syy = jnp.where(has_ice, syy, 0.0)
    sxy = jnp.where(has_ice, sxy, 0.0)
    damage_new = jnp.where(has_ice, damage_new, 0.0)

    return sxx, syy, sxy, damage_new


@dataclasses.dataclass(frozen=True)
class EVPParams:
    e: float = 2.0  # ellipse ratio (dynamics.evp.e)
    Pstar: float = 27.5e3  # [Pa] (dynamics.evp.Pstar)
    C: float = 20.0  # compaction parameter (dynamics.evp.C)
    delta_min: float = 1e-9  # (dynamics.evp.dmin)


def vp_update(
    sigma, conc, thick, eps11, eps22, eps12, ralpha1: float, ralpha2,
    p: EVPParams,
):
    """Shared (m)EVP stress update (reference: updateSigmaVP,
    finiteelement.cpp:10649-10699 — 'Sylvain's eqs 43-45')."""
    return jnp.stack(vp_update_planes(
        sigma[0], sigma[1], sigma[2], conc, thick, eps11, eps22, eps12,
        ralpha1, ralpha2, p,
    ))


def vp_update_planes(
    sxx, syy, sxy, conc, thick, eps11, eps22, eps12, ralpha1: float, ralpha2,
    p: EVPParams,
    P=None,  # optional precomputed Pstar*exp(-C*(1-conc)) — loop-invariant
):
    """`vp_update` on separate stress planes; returns (sxx, syy, sxy)."""
    re2 = 1.0 / (p.e * p.e)

    eps1 = eps11 + eps22
    eps2 = eps11 - eps22
    delta = jnp.sqrt(eps1 * eps1 + (eps2 * eps2 + 4.0 * eps12 * eps12) * re2)
    if P is None:
        P = p.Pstar * jnp.exp(-p.C * (1.0 - conc))
    zeta = P / (delta + p.delta_min)

    sigma1 = sxx + syy
    sigma2 = sxx - syy
    sigma1 = sigma1 + ralpha1 * (zeta * (eps1 - delta) - sigma1)
    sigma2 = sigma2 + ralpha2 * (zeta * eps2 * re2 - sigma2)
    sxy = sxy + ralpha2 * (zeta * eps12 * re2 - sxy)

    sxx = 0.5 * (sigma1 + sigma2)
    syy = 0.5 * (sigma1 - sigma2)

    # ice-free elements carry zero stress (fe.cpp:10656-10662)
    has_ice = thick > 0.0
    sxx = jnp.where(has_ice, sxx, 0.0)
    syy = jnp.where(has_ice, syy, 0.0)
    sxy = jnp.where(has_ice, sxy, 0.0)
    return sxx, syy, sxy


def evp_update(sigma, conc, thick, eps11, eps22, eps12, dte: float, dt_step: float, p: EVPParams):
    """EVP: T = dt/3 damping (reference: updateSigmaEVP, fe.cpp:10704-10715)."""
    T = dt_step / 3.0
    ralpha1 = 0.5 * dte / T
    ralpha2 = 0.5 * dte / T * p.e * p.e
    return vp_update(sigma, conc, thick, eps11, eps22, eps12, ralpha1, ralpha2, p)


def mevp_update(sigma, conc, thick, eps11, eps22, eps12, alpha: float, p: EVPParams):
    """mEVP: r = 1/alpha (reference: updateSigmaMEVP, fe.cpp:10721-10726)."""
    return vp_update(sigma, conc, thick, eps11, eps22, eps12, 1.0 / alpha, 1.0 / alpha, p)
