"""Waves-in-ice module (WIM) package.

Spectral wave attenuation + floe breakage on the model grid
(reference: modules/wim/include/wimdiscr.hpp:55 ``WimDiscr<T>`` and
modules/wim/src/wimdiscr.cpp). ``Wim`` is the host-side driver (standalone
or coupled through the Simulator); ``WimParams`` the option set
(options_wim.cpp). ``python -m nextsim_tpu.wim`` runs the standalone ideal
MIZ case (the reference's uncoupled WIM executable).
"""

from nextsim_tpu.wim.wim import (
    Wim,
    WimParams,
    dfloe_to_nfloes,
    inc_wave_spec,
    nfloes_to_dfloe,
    spectral_grids,
    update_wave_medium,
    wim_time_step,
)

__all__ = [
    "Wim",
    "WimParams",
    "dfloe_to_nfloes",
    "inc_wave_spec",
    "nfloes_to_dfloe",
    "spectral_grids",
    "update_wave_medium",
    "wim_time_step",
]
