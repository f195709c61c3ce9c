"""Standalone WIM run: ``python -m nextsim_tpu.wim``.

The analog of the reference's uncoupled WIM executable
(modules/wim/src/main.cpp: construct ``WimDiscr``, ``run()`` the ideal MIZ
case — incident waves on the left, uniform ice on the right, spectrum
attenuates into the pack and breaks floes). Writes the final diagnostic
fields (Hs, Tp, Dmax, wave stress) to an ``.npz``.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m nextsim_tpu.wim",
        description="Standalone waves-in-ice run (ideal MIZ case)",
    )
    ap.add_argument("--nx", type=int, default=150)
    ap.add_argument("--ny", type=int, default=10)
    ap.add_argument("--dx", type=float, default=4e3, help="grid spacing [m]")
    ap.add_argument("--duration", type=float, default=6 * 3600.0,
                    help="integration time [s] (reference duration option)")
    ap.add_argument("--nwavefreq", type=int, default=1)
    ap.add_argument("--nwavedirn", type=int, default=16)
    ap.add_argument("--hs", type=float, default=3.0, help="incident Hs [m]")
    ap.add_argument("--tp", type=float, default=12.0, help="incident Tp [s]")
    ap.add_argument("--mwd", type=float, default=-90.0,
                    help="incident mean wave direction [deg]")
    ap.add_argument("--scatmod", choices=["dissipated", "isotropic"],
                    default="dissipated")
    ap.add_argument("--out", default="wim_out.npz")
    args = ap.parse_args(argv)

    import numpy as np

    from nextsim_tpu.grid.grid import Grid
    from nextsim_tpu.wim import Wim, WimParams

    grid = Grid.square(nx=args.nx, ny=args.ny, dx=args.dx, boundary="closed")
    params = WimParams(
        nwavefreq=args.nwavefreq,
        nwavedirn=args.nwavedirn,
        hs_inc=args.hs,
        tp_inc=args.tp,
        mwd_inc=args.mwd,
        scatmod=args.scatmod,
    )
    wim = Wim(params, grid)
    wim.ideal_ice_fields()
    wim.ideal_wave_fields()
    diag = wim.run(args.duration)

    fields = {k: np.asarray(v) for k, v in diag.items()}
    fields.update({f"ice_{k}": np.asarray(v) for k, v in wim.ice.items()})
    np.savez_compressed(args.out, **fields)

    hs = fields.get("hs")
    dmax = fields.get("dfloe", fields.get("ice_dfloe"))
    summary = {
        "out": args.out,
        "n_spectral_steps": int(np.ceil(args.duration / wim.dt_cfl)),
        "dt_cfl_s": round(wim.dt_cfl, 2),
        "hs_max": float(np.max(hs)) if hs is not None else None,
        "dmax_min_in_ice": (
            float(np.min(np.where(fields["ice_mask"] > 0.5, dmax, np.inf)))
            if dmax is not None else None
        ),
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
