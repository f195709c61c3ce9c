"""Configuration schema.

Mirrors the reference's boost::program_options schema (reference:
model/options.cpp:21-559 — 248 options in 18 INI sections) so that reference
``.cfg`` files (e.g. config-files/nextsim.toy.cfg) parse directly. Options are
flat ``section.key`` names; INI files use ``[section]`` headers; repeated keys
accumulate into lists (e.g. ``moorings.variables``).

Options with no reference counterpart live in new sections:

* ``grid.*``   — the structured quad grid that replaces the reference's
  unstructured triangle mesh (``mesh.*`` is still parsed and a mesh filename
  maps onto a named grid preset).
* ``tpu.*``    — dtype, device-mesh layout, step fusion.

String→enum validation follows the reference's getOptionFromMap
(model/finiteelement.cpp:1517-1546): unknown values raise with the allowed
list in the message.

Accepted-but-inert options (parsed so reference configs load; no effect):

* BAMG/Lagrangian-mesh era — the Eulerian grid has no remesh cycle:
  ``debugging.{bamg,gmsh}_verbose``, ``numerics.regrid[_angle]``,
  ``mesh.*`` (a mesh filename maps onto a grid preset),
  ``restart.write_restart_{before,after}_regrid``,
  ``output.export_{before,after}_regrid``.
* inert in the REFERENCE itself (declared in options.cpp, read nowhere):
  ``dynamics.Lemieux_basal_u_crit``, ``thermo.{Qdw,Fdw}`` (the code reads
  ``ideal_simul.constant_{Qdw,Fdw}``).
* single-process / derived-from-data here: ``debugging.test_proc_number``
  (no MPI ranks), ``forecast.ecmwf_nrt_time_res_hours`` (time index comes
  from the files), ``nesting.inner_mesh`` (outer-run output naming; this
  build consumes nesting files, reference-format names accepted as-is).
* coupling-stub scope (BASELINE.md, deployment 4): ``coupler.
  {component_name,exchange_grid_file,BGC_active,rcv_first_layer_depth}``,
  ``wave_coupling.{receive_wave_stress,floes_flex_strength,
  dmax_c_threshold,debug_fsd}`` — wave stress/breakup arrive via the
  wave_cpl forcing fields directly.
* WIM: ``wim.useicevel`` (documented not-implemented, wim/wim.py),
  ``wimsetup.{initialtime,duration}`` (the standalone CLI takes
  ``--duration``), ``nextwim.exportresults`` (diagnostics always returned).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

# ---------------------------------------------------------------------------
# Option table: name -> (type, default).  type is one of
# str, int, float, bool, [str] (repeatable/multitoken list of strings).
# Defaults transcribed from reference model/options.cpp.
# ---------------------------------------------------------------------------

_LIST = ("list",)

OPTIONS: Dict[str, Tuple[Any, Any]] = {
    # --- simul (options.cpp:38-44)
    "simul.time_init": (str, ""),
    "simul.duration": (float, -1.0),
    "simul.timestep": (int, 200),
    "simul.spinup_duration": (float, 1.0),
    # --- debugging (options.cpp:46-70)
    "debugging.bamg_verbose": (int, 0),
    "debugging.gmsh_verbose": (int, 0),
    "debugging.log-level": (str, "info"),
    "debugging.log-all": (bool, False),
    "debugging.ptime_percent": (int, 5),
    # new: write a jax.profiler trace of the main loop to this directory
    # ("" = off) — the xprof/tensorboard analog of the reference's
    # gperftools hook (model/run.sh:64-78)
    "debugging.profile_dir": (str, ""),
    "debugging.maxiteration": (int, -1),
    "debugging.check_fields": (bool, False),
    "debugging.test_proc_number": (int, -1),
    "debugging.test_element_number": (int, -1),
    "debugging.check_velocity_fields": (bool, False),
    "debugging.check_fields_fast": (bool, True),
    # --- numerics (options.cpp:72-86)
    "numerics.regrid": (str, "bamg"),
    "numerics.regrid_angle": (float, 10.0),
    "numerics.nit_ow": (int, 50),
    # new: Eulerian advection scheme of the structured-grid build
    "numerics.advection_scheme": (str, "upwind2"),  # upwind | upwind2 (van-Leer limited)
    # --- setup (options.cpp:93-107)
    "setup.atmosphere-type": (str, "asr"),
    "setup.ocean-type": (str, "constant"),
    "setup.ice-type": (str, "constant"),
    "setup.bathymetry-type": (str, "etopo"),
    "setup.bathymetry-file": (str, "ETOPO_Arctic_2arcmin.nc"),
    "setup.atmospheric_forcing_input_path": (str, ""),
    "setup.oceanic_forcing_input_path": (str, ""),
    "setup.basal_stress-type": (str, "lemieux"),
    "setup.use_assimilation": (bool, False),
    "setup.dynamics-type": (str, "bbm"),
    "setup.thermo-type": (str, "winton"),
    # --- mesh (options.cpp:109-122) — parsed for compat; maps onto grid presets
    "mesh.filename": (str, "medium_Arctic_10km.msh"),
    "mesh.mppfile": (str, "NpsNextsim.mpp"),
    "mesh.partitioner": (str, "metis"),
    "mesh.partitioner-fileformat": (str, "binary"),
    "mesh.partitioner-space": (str, "memory"),
    "mesh.type": (str, "from_unref"),
    "mesh.ordering": (str, "gmsh"),
    # --- grid (structured grid; replaces the triangle mesh)
    "grid.preset": (str, ""),  # '' (derive from mesh.filename), 'square', 'arctic'
    "grid.nx": (int, 128),
    "grid.ny": (int, 128),
    "grid.resolution": (float, 10e3),  # cell size [m]
    "grid.x0": (float, 0.0),  # lower-left corner in projection coords [m]
    "grid.y0": (float, 0.0),
    "grid.boundary": (str, "closed"),  # closed | open (all four sides)
    # --- moorings (options.cpp:124-150)
    "moorings.use_moorings": (bool, False),
    "moorings.grid_type": (str, "regular"),
    "moorings.use_conservative_remapping": (bool, False),
    "moorings.snapshot": (bool, False),
    "moorings.file_length": (str, "inf"),
    "moorings.spacing": (float, 10.0),
    "moorings.output_timestep": (float, 1.0),
    "moorings.output_time_step_units": (str, "days"),
    "moorings.variables": (
        _LIST,
        ["conc", "thick", "snow", "conc_young", "h_young", "hs_young", "velocity"],
    ),
    "moorings.grid_file": (str, ""),
    "moorings.grid_latitude": (str, "latitude"),
    "moorings.grid_longitude": (str, "longitude"),
    "moorings.grid_transpose": (bool, False),
    "moorings.false_easting": (bool, True),
    "moorings.parallel_output": (bool, False),
    # --- drifters (options.cpp:152-196)
    "drifters.concentration_limit": (float, 0.15),
    "drifters.use_iabp_drifters": (bool, False),
    "drifters.iabp_drifters_output_time_step": (float, 0.5),
    "drifters.iabp_ignore_restart": (bool, False),
    "drifters.use_osisaf_drifters": (bool, False),
    "drifters.osisaf_drifters_output_time_step": (float, 2.0),
    "drifters.use_refined_osisaf_grid": (bool, False),
    "drifters.use_equally_spaced_drifters": (bool, False),
    "drifters.equally_spaced_drifters_output_time_step": (float, 0.5),
    "drifters.spacing": (float, 10.0),
    "drifters.equally_spaced_ignore_restart": (bool, False),
    "drifters.use_rgps_drifters": (bool, False),
    "drifters.rgps_drifters_output_time_step": (float, 0.5),
    "drifters.RGPS_time_init": (str, "2007-12-01"),
    "drifters.use_sidfex_drifters": (bool, False),
    "drifters.sidfex_drifters_output_time_step": (float, 0.5),
    "drifters.sidfex_filename": (str, ""),
    "drifters.sidfex_time_init": (str, ""),
    "drifters.sidfex_ignore_restart": (bool, False),
    # --- restart (options.cpp:198-231)
    "restart.start_from_restart": (bool, False),
    "restart.check_restart": (bool, False),
    "restart.input_path": (str, ""),
    "restart.basename": (str, ""),
    "restart.type": (str, "extend"),
    "restart.write_final_restart": (bool, False),
    "restart.write_interval_restart": (bool, False),
    "restart.write_initial_restart": (bool, False),
    "restart.output_interval": (float, 15.0),
    "restart.datetime_in_filename": (bool, True),
    "restart.output_interval_units": (str, "days"),
    "restart.restart_at_rest": (bool, False),
    "restart.write_restart_before_regrid": (bool, False),
    "restart.write_restart_after_regrid": (bool, False),
    # --- output (options.cpp:233-264)
    "output.output_per_day": (int, 0),
    "output.save_forcing_fields": (bool, False),
    "output.save_diagnostics": (bool, False),
    "output.export_before_regrid": (bool, False),
    "output.export_after_regrid": (bool, False),
    "output.datetime_in_filename": (bool, True),
    "output.exporter_path": (str, "nextsim_outputs"),
    "output.exporter_precision": (str, "float"),
    # snapshot container: npz+json manifest (native) or the reference's
    # binary .bin/.dat Exporter format (core/src/exporter.cpp)
    "output.format": (str, "npz"),
    "output.variables": (
        _LIST,
        [
            "Damage",
            "Concentration",
            "Thickness",
            "Snow",
            "Concentration_young_ice",
            "Thickness_young_ice",
            "Snow_young_ice",
            "M_VT",
        ],
    ),
    "output.export_fields": (bool, True),
    # extension (no reference analog — the reference's rank-0
    # Exporter writes stall the whole MPI job): when true, snapshot/restart
    # compression + disk IO ride an ordered background worker thread
    # (utils/async_writer.py) so the step loop never waits on the filesystem
    "output.async_io": (bool, False),
    # --- ideal_simul (options.cpp:271-305)
    "ideal_simul.constant_bathymetry": (float, 200.0),
    "ideal_simul.init_thickness": (float, 1.0),
    "ideal_simul.init_concentration": (float, 1.0),
    "ideal_simul.init_young_conc": (float, 0.0),
    "ideal_simul.init_snow_thickness": (float, 0.0),
    "ideal_simul.init_SST_limit": (float, 2.0),
    "ideal_simul.constant_tair": (float, -25.0),
    "ideal_simul.constant_dair": (float, -1.0),
    "ideal_simul.constant_mixrat": (float, 0.001),
    "ideal_simul.constant_mslp": (float, 1013e2),
    "ideal_simul.constant_Qsw_in": (float, 50.0),
    "ideal_simul.constant_Qlw_in": (float, 250.0),
    "ideal_simul.constant_precip": (float, 1e-5),
    "ideal_simul.constant_snowfr": (float, 0.9),
    "ideal_simul.constant_Qdw": (float, 0.0),
    "ideal_simul.constant_Fdw": (float, 0.0),
    "ideal_simul.constant_mld": (float, 9.0),
    "ideal_simul.constant_wind_u": (float, 0.0),
    "ideal_simul.constant_wind_v": (float, 0.0),
    "ideal_simul.constant_ocean_u": (float, 0.0),
    "ideal_simul.constant_ocean_v": (float, 0.0),
    "ideal_simul.constant_ssh": (float, 0.0),
    # --- dynamics (options.cpp:313-379)
    "dynamics.alea_factor": (float, 0.0),
    "dynamics.young": (float, 5.9605e8),
    "dynamics.C_lab": (float, 2.0e6),
    "dynamics.nu0": (float, 1.0 / 3.0),
    "dynamics.tan_phi": (float, 0.7),
    "dynamics.compr_strength": (float, 1e10),
    "dynamics.compaction_param": (float, -20.0),
    "dynamics.min_h": (float, 0.05),
    "dynamics.min_c": (float, 0.01),
    "dynamics.use_temperature_dependent_healing": (bool, False),
    "dynamics.time_relaxation_damage": (float, 25.0),  # days
    "dynamics.deltaT_relaxation_damage": (float, 20.0),  # K
    "dynamics.undamaged_time_relaxation_sigma": (float, 1e7),  # s
    "dynamics.exponent_relaxation_sigma": (float, 5.0),
    "dynamics.ERA5_quad_drag_coef_air": (float, 0.0020),
    "dynamics.ECMWF_quad_drag_coef_air": (float, 0.0020),
    "dynamics.ASR_quad_drag_coef_air": (float, 0.0049),
    "dynamics.CFSR_quad_drag_coef_air": (float, 0.0023),
    "dynamics.lin_drag_coef_air": (float, 0.0),
    "dynamics.quad_drag_coef_water": (float, 0.0055),
    "dynamics.lin_drag_coef_water": (float, 0.0),
    "dynamics.use_coriolis": (bool, True),
    "dynamics.oceanic_turning_angle": (float, 25.0),
    "dynamics.Lemieux_basal_k1": (float, 10.0),
    "dynamics.Lemieux_basal_k2": (float, 15.0),
    "dynamics.Lemieux_basal_Cb": (float, 20.0),
    "dynamics.Lemieux_basal_u_0": (float, 5e-5),
    "dynamics.Lemieux_basal_u_crit": (float, 5e-4),
    "dynamics.exponent_compression_factor": (float, 1.5),
    "dynamics.compression_factor": (float, 10e3),
    "dynamics.substeps": (int, 120),
    "dynamics.evp.e": (float, 2.0),
    "dynamics.evp.Pstar": (float, 27.5e3),
    "dynamics.evp.C": (float, 20.0),
    "dynamics.evp.dmin": (float, 1e-9),
    "dynamics.mevp.alpha": (float, 500.0),
    "dynamics.mevp.beta": (float, 500.0),
    # --- thermo (options.cpp:384-460)
    "thermo.use_thermo_forcing": (bool, True),
    "thermo.Qio-type": (str, "basic"),
    "thermo.freezingpoint-type": (str, "linear"),
    "thermo.freezingpoint_mu": (float, 0.055),
    "thermo.albedoW": (float, 0.07),
    "thermo.alb_scheme": (int, 3),
    "thermo.flooding": (bool, True),
    "thermo.alb_ice": (float, 0.538),
    "thermo.alb_sn": (float, 0.8256),
    "thermo.alb_ponds": (float, 0.30),
    "thermo.I_0": (float, 0.30),
    "thermo.Qdw": (float, 0.5),
    "thermo.Fdw": (float, 0.0),
    "thermo.newice_type": (int, 4),
    "thermo.melt_type": (int, 2),
    "thermo.hnull": (float, 0.25),
    "thermo.PhiF": (float, 4.0),
    "thermo.PhiM": (float, 0.5),
    "thermo.h_young_max": (float, 0.5),
    "thermo.h_young_min": (float, 0.05),
    "thermo.snow_cond": (float, 0.3096),
    "thermo.drag_ice_t": (float, 1.3e-3),
    "thermo.drag_ocean_u": (float, 1.1e-3),
    "thermo.drag_ocean_t": (float, 0.83e-3),
    "thermo.drag_ocean_q": (float, 1.5e-3),
    "thermo.Csens_io": (float, 1.0e-3),
    "thermo.diffusivity_sss": (float, 0.0),
    "thermo.diffusivity_sst": (float, 0.0),
    "thermo.ocean_nudge_timeT_days": (float, 30.0),
    "thermo.ocean_nudge_timeS_days": (float, 30.0),
    "thermo.use_parameterised_long_wave_radiation": (bool, False),
    "thermo.use_assim_flux": (bool, False),
    "thermo.assim_flux_exponent": (float, 1.0),
    "thermo.zref_wind": (float, 10.0),
    "thermo.zref_temp": (float, 2.0),
    "thermo.force_neutral_atmosphere": (bool, False),
    "thermo.limiting_lengthscale": (float, 1.0),
    "thermo.ocean_bulk_formula": (str, "nextsim"),
    "thermo.use_meltponds": (bool, False),
    "thermo.meltpond_runoff_fraction": (float, 0.2),
    "thermo.meltpond_depth_to_fraction": (float, 0.8),
    # --- nesting (options.cpp:462-473)
    "nesting.use_nesting": (bool, False),
    "nesting.use_ocean_nesting": (bool, False),
    "nesting.outer_mesh": (str, ""),
    "nesting.inner_mesh": (str, ""),
    "nesting.method": (str, "nudging"),
    "nesting.nudge_timescale": (float, 0.5),
    "nesting.nudge_function": (str, "exponential"),
    "nesting.nudge_lengthscale": (float, 10.0),
    "nesting.nest_dynamic_vars": (bool, False),
    # --- forecast (options.cpp:479-482)
    "forecast.air_temperature_correction": (float, 0.0),
    "forecast.ecmwf_nrt_time_res_hours": (float, 6.0),
    # --- coupler (options.cpp:490-499; OASIS-gated in reference, always parsed here)
    "coupler.component_name": (str, "nxtsim"),
    "coupler.timestep": (int, 3600),
    "coupler.exchange_grid_file": (str, "coupler/NEMO.nc"),
    "coupler.with_waves": (bool, False),
    "coupler.BGC_active": (bool, False),
    "coupler.rcv_first_layer_depth": (bool, False),
    # --- wave_coupling (options.cpp:504-535)
    "wave_coupling.receive_wave_stress": (bool, True),
    "wave_coupling.num_fsd_bins": (int, 0),
    "wave_coupling.fsd_type": (str, "constant_size"),
    "wave_coupling.fsd_bin_cst_width": (float, 10.0),
    "wave_coupling.fsd_min_floe_size": (float, 10.0),
    "wave_coupling.floes_flex_strength": (float, 0.27e6),
    "wave_coupling.floes_flex_young": (float, 5.49e9),
    "wave_coupling.welding_type": (str, "none"),
    "wave_coupling.welding_kappa": (float, 0.01),
    "wave_coupling.fsd_welding_use_scaled_area": (bool, False),
    "wave_coupling.dmax_c_threshold": (float, 0.1),
    "wave_coupling.fsd_unbroken_floe_size": (float, 1000.0),
    "wave_coupling.fsd_damage_type": (int, 0),
    "wave_coupling.fsd_damage_max": (float, 0.99),
    "wave_coupling.breakup_thick_min": (float, 0.0),
    "wave_coupling.breakup_prob_type": (int, 0),
    "wave_coupling.breakup_cell_average_thickness": (bool, False),
    "wave_coupling.breakup_timescale_tuning": (float, 1.0),
    "wave_coupling.breakup_type": (str, "uniform_size"),
    "wave_coupling.breakup_coef1": (float, 0.5),
    "wave_coupling.breakup_coef2": (float, 1.0),
    "wave_coupling.breakup_coef3": (float, 1.0),
    "wave_coupling.breakup_prob_cutoff": (float, 0.0015),
    "wave_coupling.distinguish_mech_fsd": (bool, True),
    "wave_coupling.debug_fsd": (bool, False),
    # --- statevector (options.cpp:538-540)
    "statevector.ensemble_member": (int, 0),
    # --- age (options.cpp:545-556)
    "age.reset_date": (str, "0915"),
    "age.reset_by_date": (bool, False),
    "age.include_young_ice": (bool, True),
    "age.reset_freeze_days": (float, 3.0),
    "age.equal_ridging": (bool, False),
    "age.equal_melting": (bool, True),
    # --- wimsetup / wim / nextwim (reference: modules/wim/src/options_wim.cpp;
    # the standalone+coupled waves-in-ice module)
    "wimsetup.initialtime": (str, "2015-01-01 00:00:00"),
    "wimsetup.duration": (float, 43200.0),
    "wimsetup.tmin": (float, 2.5),
    "wimsetup.tmax": (float, 25.0),
    "wimsetup.nwavefreq": (int, 1),
    "wimsetup.nwavedirn": (int, 16),
    "wimsetup.wave-type": (str, "set_in_wim"),
    # --- WIM's own grid (reference: wimgrid.* in modules/wim options,
    # gridinfo.cpp:26-124). nx=0 derives the grid from the model extent at
    # wimgrid.dx resolution; used when nextwim.coupling-option=naive.
    # Cells are square (dx only; the reference's dy collapses onto dx).
    "wimgrid.nx": (int, 0),
    "wimgrid.ny": (int, 0),
    "wimgrid.dx": (float, 4e3),
    "wimgrid.xmin": (float, 0.0),
    "wimgrid.ymin": (float, 0.0),
    "wim.atten": (bool, True),
    "wim.scatmod": (str, "dissipated"),
    "wim.young": (float, 5.49e9),
    "wim.dragrp": (float, 13.0),
    "wim.advopt": (str, "y-periodic"),
    "wim.advdim": (int, 2),
    "wim.steady": (bool, True),
    "wim.cfl": (float, 0.7),
    "wim.breaking": (bool, True),
    "wim.fsdopt": (str, "PowerLawSmooth"),
    "wim.dfloemin": (float, 20.0),
    "wim.cicemin": (float, 0.05),
    "wim.dfloepackthresh": (float, 400.0),
    "wim.dfloepackinit": (float, 300.0),
    "wim.refhsice": (bool, False),
    "wim.useicevel": (bool, False),
    "wim.hsinc": (float, 3.0),
    "wim.tpinc": (float, 12.0),
    "wim.mwdinc": (float, -90.0),
    "wim.unifc": (float, 0.7),
    "wim.unifh": (float, 1.0),
    "nextwim.use_wim": (bool, False),
    "nextwim.couplingfreq": (int, 20),
    "nextwim.coupling-option": (str, "break_on_mesh"),
    "nextwim.wim_damage_mesh": (bool, True),
    "nextwim.wim_damage_value": (float, 0.999),
    "nextwim.applywavestress": (bool, True),
    "nextwim.exportresults": (bool, True),
    # --- tpu (no reference counterpart)
    "tpu.dtype": (str, "float32"),
    "tpu.mesh_shape": (str, "1x1"),  # dp_y x dp_x device mesh
    # momentum substep fori_loop unroll factor: 4 was fastest of 1/2/4 at
    # 464^2, 608^2 and 1216^2 on the H100 (tools/unroll_sweep.py; PERF.md)
    "tpu.substep_unroll": (int, 4),
    "tpu.donate_state": (bool, True),
    # fetch the checkFieldsFast verdict every N steps (device work still runs
    # every step; raising this only batches the host readback, which is a
    # pipeline sync)
    "tpu.check_interval": (int, 1),
    # fuse N model steps into one device program (lax.scan): removes
    # per-step dispatch latency. Forcing, the thermo
    # date flags, nesting outer fields and coupler means are threaded
    # per-step through the scan, so chunked runs are exact; N is clamped to
    # divide the coupler window and the finest drifter cadence
    "tpu.steps_per_call": (int, 1),
    # checkpoint format: npz (single compressed file, gathered + written by
    # process 0 — the reference's rank-0 writeRestart analog) or orbax
    # (sharded TensorStore checkpoint: every process writes its own shards
    # in parallel, no global gather; restores under any topology)
    "restart.format": (str, "npz"),
    # multi-chip schedule for the momentum substep loop: gspmd (XLA inserts
    # the halo collectives) or shard_map (hand-scheduled seam blocks with one
    # explicit ppermute ring exchange per substep, parallel/seam.py — the
    # analog of the reference's per-substep updateGhosts, fe.cpp:10534)
    "tpu.partition_mode": (str, "gspmd"),
    # shard_map only: substeps per ring exchange (= ring width H). H>1 is
    # communication-avoiding: one exchange refreshes H layers, then H
    # substeps run with zero communication at ~2H/block redundant compute.
    # Must divide dynamics.substeps and stay under the per-device block.
    "tpu.halo_depth": (int, 1),
}

# Allowed values for enum-like string options (reference: getOptionFromMap /
# getAllowedOption, model/finiteelement.cpp:1517-1573).
ENUMS: Dict[str, List[str]] = {
    "setup.dynamics-type": ["bbm", "no_motion", "evp", "mevp", "free_drift"],
    "setup.thermo-type": ["zero-layer", "winton"],
    "setup.ocean-type": [
        "constant", "topaz4", "topaz4-atrest", "topaz4-nrt", "topaz5-nrt",
        "glorys12", "coupled",
        # reference str2ocean spellings (fe.cpp:1314-1322)
        "topaz4_rean", "topaz4_rean_atrest", "topaz4_rean-altimeter",
        "topaz4_nrt", "topaz5_nrt",
    ],
    "setup.atmosphere-type": [
        "constant", "generic_ps", "asr", "era5", "ecmwf_nrt", "ecmwf_nrt_arome",
        "ecmwf_nrt_arome_ensemble", "cfsr", "cfsr_hi",
    ],
    "setup.bathymetry-type": ["constant", "etopo"],
    "setup.basal_stress-type": ["none", "lemieux"],
    "thermo.Qio-type": ["basic", "exchange"],
    "thermo.freezingpoint-type": ["linear", "unesco"],
    "grid.boundary": ["closed", "open"],
    "numerics.advection_scheme": ["upwind", "upwind2"],
    "output.exporter_precision": ["float", "double"],
    "output.format": ["npz", "reference"],
    "moorings.file_length": ["inf", "daily", "weekly", "monthly", "yearly"],
    "tpu.dtype": ["float32", "bfloat16", "float64"],
    "restart.format": ["npz", "orbax"],
    "tpu.partition_mode": ["gspmd", "shard_map"],
    "wim.scatmod": ["dissipated", "isotropic"],
    "wim.advopt": ["notperiodic", "y-periodic", "xy-periodic"],
    "wim.fsdopt": ["PowerLawSmooth", "RG"],
    "nextwim.coupling-option": ["naive", "break_on_mesh", "run_on_mesh"],
    # reference str2oblk map, fe.cpp:1254-1263 (AeroBulk algorithm family)
    "thermo.ocean_bulk_formula": [
        "nextsim", "coare3.0", "coare3.6", "ncar", "ecmwf", "andreas",
    ],
}

_TRUE = {"true", "1", "yes", "on"}
_FALSE = {"false", "0", "no", "off"}


def _coerce(name: str, typ: Any, raw: Any) -> Any:
    if typ is _LIST:
        if isinstance(raw, list):
            return [str(v) for v in raw]
        return [str(raw)]
    if isinstance(raw, str):
        raw = raw.strip()
    if typ is bool:
        if isinstance(raw, bool):
            return raw
        low = str(raw).lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError(f"option {name}: cannot parse bool from {raw!r}")
    if typ is int:
        return int(float(raw))
    if typ is float:
        return float(raw)
    return str(raw)


class Config:
    """Flat option store with INI-file loading and strict validation."""

    def __init__(self, overrides: Dict[str, Any] | None = None):
        self._values: Dict[str, Any] = {k: (list(v[1]) if v[0] is _LIST else v[1]) for k, v in OPTIONS.items()}
        if overrides:
            for k, v in overrides.items():
                self.set(k, v)

    # -- access -------------------------------------------------------------
    def __getitem__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise KeyError(f"unknown option {name!r}") from None

    def get(self, name: str, default: Any = None) -> Any:
        return self._values.get(name, default)

    def set(self, name: str, value: Any) -> None:
        if name not in OPTIONS:
            raise KeyError(f"unknown option {name!r}")
        typ = OPTIONS[name][0]
        coerced = _coerce(name, typ, value)
        if name in ENUMS and coerced not in ENUMS[name]:
            raise ValueError(
                f"option {name}: invalid value {coerced!r}; allowed: {ENUMS[name]}"
            )
        self._values[name] = coerced

    def _append(self, name: str, value: str) -> None:
        """Repeated key in an INI file: accumulate (multitoken composing)."""
        if OPTIONS[name][0] is _LIST:
            cur = self._values[name]
            if not getattr(self, "_touched_lists", None):
                self._touched_lists = set()
            if name not in self._touched_lists:
                cur = []
                self._touched_lists.add(name)
            cur.append(value.strip())
            self._values[name] = cur
        else:
            self.set(name, value)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    # -- loading ------------------------------------------------------------
    @classmethod
    def from_files(cls, *paths: str, overrides: Dict[str, Any] | None = None) -> "Config":
        """Load one or more INI config files; later files and overrides win."""
        cfg = cls()
        for path in paths:
            cfg.load_ini(path)
        if overrides:
            for k, v in overrides.items():
                cfg.set(k, v)
        return cfg

    def load_ini(self, path: str) -> None:
        """Parse a reference-style INI file.

        Handles ``[section]`` headers, ``key=value`` lines, ``#`` comments
        (including trailing ``#comment`` with no space, as in the reference
        configs), and repeated keys accumulating into lists.
        """
        self._touched_lists = set()
        section = ""
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith(("#", ";")):
                    continue
                m = re.match(r"^\[([^\]]+)\]$", line)
                if m:
                    section = m.group(1).strip()
                    continue
                if "=" not in line:
                    raise ValueError(f"{path}:{lineno}: cannot parse line {line!r}")
                key, _, value = line.partition("=")
                # strip trailing comments: "false#true" -> "false"
                value = re.split(r"[#;]", value, 1)[0].strip()
                key = key.strip()
                name = f"{section}.{key}" if section else key
                if name not in OPTIONS:
                    if section == "tpu":
                        # this build's own section: an unknown key there is
                        # a mistake or a retired option, never a module
                        # compiled out
                        raise KeyError(f"unknown option {name!r}")
                    # Tolerate unknown options (reference tolerates extra
                    # sections when modules are compiled out) but record them.
                    self._unknown = getattr(self, "_unknown", {})
                    self._unknown[name] = value
                    continue
                self._append(name, value)

    @property
    def unknown_options(self) -> Dict[str, str]:
        return dict(getattr(self, "_unknown", {}))

    @staticmethod
    def describe_options() -> str:
        """Human-readable listing of every option with type, default and
        allowed enum values (the analog of the reference executable's
        ``--help``, which prints all program_options descriptions;
        model/main.cpp:27-33)."""
        by_section: Dict[str, List[str]] = {}
        for name, (typ, default) in sorted(OPTIONS.items()):
            section, _, key = name.partition(".")
            tname = "list[str]" if typ is _LIST else typ.__name__
            line = f"  {key:42s} {tname:9s} default={default!r}"
            if name in ENUMS:
                line += f"  one of {ENUMS[name]}"
            by_section.setdefault(section, []).append(line)
        out = []
        for section, lines in by_section.items():
            out.append(f"[{section}]")
            out.extend(lines)
            out.append("")
        return "\n".join(out)

    def dump(self) -> str:
        """Render the full config as INI text (for the run log file,
        reference: writeLogFile, model/finiteelement.cpp:14371-14487)."""
        by_section: Dict[str, List[str]] = {}
        for name, value in sorted(self._values.items()):
            section, _, key = name.partition(".")
            if isinstance(value, list):
                lines = [f"{key}={v}" for v in value]
            else:
                lines = [f"{key}={value}"]
            by_section.setdefault(section, []).extend(lines)
        out = []
        for section, lines in by_section.items():
            out.append(f"[{section}]")
            out.extend(lines)
            out.append("")
        return "\n".join(out)
