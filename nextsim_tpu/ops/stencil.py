"""B-grid stencil operators.

These are the structured-grid equivalents of the reference's P1 finite-element
operators on triangles:

* ``strain_rates``      <- B0T * v per element (reference:
  model/finiteelement.cpp:4167-4176 and shapeCoeff)
* ``node_force``        <- the gradient-of-sigma assembly, i.e. the discrete
  adjoint of the strain operator (reference: finiteelement.cpp:10446-10467,
  sign per Danilov et al. 2015)
* ``cells_to_node_sum`` / ``node_max_of_cells`` <- lumped-mass and grounding
  accumulations over adjacent elements (reference: finiteelement.cpp:10311-10320)
* ``neighbor_mean_nodes`` <- the open-water velocity smoother's neighbour
  average (reference: finiteelement.cpp:10580-10611)

On a quad cell with bilinear (Q1) velocity, the strain rate evaluated at the
cell center uses the edge-mean differences; the corresponding shape-function
gradients are +-1/(2 dx).  Everything is expressed as pad-and-slice shifts:
XLA fuses these into single elementwise passes and GSPMD inserts halo exchanges for
the shifted reads automatically when the arrays are sharded.

Array layout: cells (ny, nx); nodes (ny+1, nx+1); index [j, i] = [y, x];
cell (j, i) has corner nodes SW=(j,i), SE=(j,i+1), NW=(j+1,i), NE=(j+1,i+1).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def cell_corners(nodal):
    """Return the 4 corner-node views (SW, SE, NW, NE), each of cell shape."""
    return (
        nodal[:-1, :-1],
        nodal[:-1, 1:],
        nodal[1:, :-1],
        nodal[1:, 1:],
    )


def strain_rates(u, v, dx: float) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Cell-centered strain rates (eps11, eps22, 2*eps12 is NOT returned —
    eps12 itself is) from corner velocities."""
    u_sw, u_se, u_nw, u_ne = cell_corners(u)
    v_sw, v_se, v_nw, v_ne = cell_corners(v)
    r = 1.0 / (2.0 * dx)
    # factored diagonal differences: dx+dy = 2(ne-sw), dx-dy = 2(se-nw)
    ua = u_ne - u_sw
    ub = u_se - u_nw
    va = v_ne - v_sw
    vb = v_se - v_nw
    dudx = (ua + ub) * r
    dudy = (ua - ub) * r
    dvdx = (va + vb) * r
    dvdy = (va - vb) * r
    eps11 = dudx
    eps22 = dvdy
    eps12 = 0.5 * (dudy + dvdx)
    return eps11, eps22, eps12


def cells_to_node_sum(cell_field) -> jnp.ndarray:
    """Scatter-add a cell field to its 4 corner nodes (adjoint of corner
    gather); node (j,i) accumulates cells (j-1..j, i-1..i)."""
    p = jnp.pad(cell_field, 1)
    # contributions: cell as NE corner p[j-1,i-1]; NW p[j-1,i]; SE p[j,i-1]; SW p[j,i]
    return p[:-1, :-1] + p[:-1, 1:] + p[1:, :-1] + p[1:, 1:]


def node_max_of_cells(cell_field) -> jnp.ndarray:
    """Max over the (up to) 4 cells adjacent to each node."""
    p = jnp.pad(cell_field, 1)
    return jnp.maximum(
        jnp.maximum(p[:-1, :-1], p[:-1, 1:]), jnp.maximum(p[1:, :-1], p[1:, 1:])
    )


def node_force(fx_cell, fy_cell, dx: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Assemble nodal force from cell 'flux' fields.

    For a cell quantity G (e.g. volume*sigma_xx), the x-gradient part of the
    nodal force is  F[node] = -sum_cells G_c * dxN_{c,node}  with
    dxN = +-1/(2dx): '+' when the node is on the cell's east side.
    Returns (sum_c G_c*dxN, sum_c G_c*dyN) WITHOUT the minus sign — callers
    apply their own sign convention.
    """
    r = 1.0 / (2.0 * dx)
    px = jnp.pad(fx_cell, 1)
    py = jnp.pad(fy_cell, 1)
    # node (j,i): cell roles NE=(j-1,i-1): dxN=+1, dyN=+1;  NW=(j-1,i): -1,+1
    #             SE=(j,i-1): +1,-1;  SW=(j,i): -1,-1
    gx = (px[:-1, :-1] - px[:-1, 1:] + px[1:, :-1] - px[1:, 1:]) * r
    gy = (py[:-1, :-1] + py[:-1, 1:] - py[1:, :-1] - py[1:, 1:]) * r
    return gx, gy


def stress_divergence(sxx, syy, sxy, volume, dx: float):
    """Nodal gradient terms of the momentum RHS:

    grad_u[node] -= volume*( sxx*dxN + sxy*dyN )
    grad_v[node] -= volume*( sxy*dxN + syy*dyN )

    (reference: finiteelement.cpp:10460-10466; counter-intuitive sign per
    Danilov et al. 2015). Returns (grad_u, grad_v) with the minus applied.

    Factored form: with Dx/Dy the corner-scatter difference stencils and
    F1,F2 the cell flux pair, Dx(F1)+Dy(F2) = S[--] - D[-+] + D[+-] - S[++]
    for S=F1+F2, D=F1-F2 — two fewer adds per component on the substep
    critical path than evaluating Dx and Dy separately.
    """
    r = 1.0 / (2.0 * dx)
    vsxy = volume * sxy

    def dxy_pair(f1, f2):
        ps = jnp.pad(f1 + f2, 1)
        pd = jnp.pad(f1 - f2, 1)
        return (
            ps[:-1, :-1] - pd[:-1, 1:] + pd[1:, :-1] - ps[1:, 1:]
        ) * r

    grad_u = dxy_pair(volume * sxx, vsxy)
    grad_v = dxy_pair(vsxy, volume * syy)
    return -grad_u, -grad_v


def node_grad_scalar(cell_coef, node_scalar, dx: float):
    """Nodal 'gradient of m*g*ssh' term (reference: finiteelement.cpp:
    10320-10340): for each cell, with node scalar s (e.g. SSH),
    grad_u[node_i] -= dxN_i * (m g A/3) * mean-free combination sum_j dxN_j s_j.
    On the quad grid this reduces to: cell-centered gradient of s times the
    cell coefficient, scattered to the 4 corner nodes with weight 1/4 * ... .

    We mirror the FEM form exactly: for cell c, gs_x(c) = sum_j dxN_j s_j
    (the cell-centered gradient), then
    grad_u[n] -= coef_c * gs_x(c) for each corner n — matching
    sum_j dxN[j]*s[j] contracted against the P0 test function of coef.
    """
    s_sw, s_se, s_nw, s_ne = cell_corners(node_scalar)
    r = 1.0 / (2.0 * dx)
    gs_x = (s_se + s_ne - s_sw - s_nw) * r
    gs_y = (s_nw + s_ne - s_sw - s_se) * r
    return -cells_to_node_sum_weighted(cell_coef * gs_x), -cells_to_node_sum_weighted(
        cell_coef * gs_y
    )


def cells_to_node_sum_weighted(cell_field) -> jnp.ndarray:
    """Alias of cells_to_node_sum (each adjacent cell contributes once)."""
    return cells_to_node_sum(cell_field)


def neighbor_mean_nodes(u, node_ok) -> jnp.ndarray:
    """Mean of the 4 von-Neumann node neighbours, restricted to valid nodes.

    Used by the open-water velocity smoother (reference: finiteelement.cpp:
    10580-10611 averages over the mesh's nodal connectivity).
    ``node_ok`` is 1.0 where a neighbour may contribute (node_mask).
    """
    up = jnp.pad(u * node_ok, 1)
    wp = jnp.pad(node_ok, 1)
    num = up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
    den = wp[:-2, 1:-1] + wp[2:, 1:-1] + wp[1:-1, :-2] + wp[1:-1, 2:]
    return num / jnp.maximum(den, 1.0)


def cell_mean_of_nodes(nodal) -> jnp.ndarray:
    """Average of the 4 corner nodes (e.g. element-mean SSH or wind speed,
    reference: finiteelement.cpp:10274-10277, windSpeedElement)."""
    a, b, c, d = cell_corners(nodal)
    return 0.25 * (a + b + c + d)


def node_mean_of_cells(cell_field, cell_weight) -> jnp.ndarray:
    """Weight-averaged cell->node interpolation (e.g. area-weighted drag,
    reference: finiteelement.cpp:10373-10390)."""
    num = cells_to_node_sum(cell_field * cell_weight)
    den = cells_to_node_sum(cell_weight)
    return num / jnp.maximum(den, 1e-30)


def laplacian_cells(field, mask, dx: float) -> jnp.ndarray:
    """5-point masked Laplacian on cells (for SST/SSS diffusion, reference:
    diffuse(), finiteelement.cpp:2760-2815 — explicit neighbour smoothing).
    No-flux across masked (land) faces."""
    fp = jnp.pad(field, 1)
    mp = jnp.pad(mask, 1)
    c = fp[1:-1, 1:-1]
    out = (
        mp[:-2, 1:-1] * (fp[:-2, 1:-1] - c)
        + mp[2:, 1:-1] * (fp[2:, 1:-1] - c)
        + mp[1:-1, :-2] * (fp[1:-1, :-2] - c)
        + mp[1:-1, 2:] * (fp[1:-1, 2:] - c)
    )
    return mask * out / (dx * dx)
