"""nextsim_tpu — a JAX sea-ice modeling framework.

A brand-new JAX/XLA implementation of the capabilities of neXtSIM
(nansencenter/nextsim): BBM / (m)EVP / free-drift sea-ice dynamics, zero-layer
and Winton thermodynamics with a young-ice category, meltponds and ice-age
tracers, Eulerian incremental-remapping advection, NetCDF forcing ingest,
gridded "moorings" output, Lagrangian drifters, restart/resume, nesting,
ensemble perturbations and a coupling exchange surface — rebuilt for XLA on
a fixed quad structured polar-stereographic grid with 2-D domain decomposition
over `jax.sharding.Mesh`.

This is not a port: the reference is a Lagrangian finite-element C++/MPI code
(see SURVEY.md); here the dynamical core is fused stencil kernels over a
structured grid, compiled by XLA and sharded by GSPMD/shard_map.
"""

__version__ = "0.1.0"

from nextsim_tpu.config.schema import Config  # noqa: F401
from nextsim_tpu.grid.grid import Grid  # noqa: F401
from nextsim_tpu.core.state import State  # noqa: F401
