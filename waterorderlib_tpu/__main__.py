"""Command-line interface.

Replaces the reference's inline `if switch:` driver blocks
(/root/reference/structureLibs/orderParam_lib.py:1944-2173 and
other/orderParam_lib_dmso.py:1561-1824), which parsed `sys.argv[1:3]` and
ran hand-edited analysis sequences. Every analysis is a subcommand:

    python -m waterorderlib_tpu generate --waters 216 --frames 50 --out sys
    python -m waterorderlib_tpu tet sys.json sys.npz --output-dir out/
    python -m waterorderlib_tpu rdf sys.json sys.npz
    python -m waterorderlib_tpu boundwrap sys.json sys.npz --cache bw.npz
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_common(p):
    p.add_argument("top", help="topology: .json, .npz (embedded), or AMBER .prmtop/.parm7/.top")
    p.add_argument("traj", help="trajectory: .npz, .dcd, AMBER NetCDF .nc, or AMBER ASCII .mdcrd/.crd")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--wat-res", default="WAT")
    p.add_argument("--output-dir", default=".")
    p.add_argument("--chunk-frames", type=int, default=0,
                   help="stream the trajectory in chunks of this many frames "
                        "(larger-than-memory support; 0 = load whole)")
    p.add_argument("--mesh", default="",
                   help="shard over a device mesh, e.g. 4x2 = 4 frame shards "
                        "x 2 atom shards "
                        "(tet/3body/lsi/psi/rdf/hb/chempot/msd/voronoi)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="waterorderlib_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="write a synthetic water box system")
    g.add_argument("--waters", type=int, default=216)
    g.add_argument("--frames", type=int, default=10)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--solute", default="", help="comma-separated solute elements, e.g. C,C,O")
    g.add_argument("--diffusion", type=float, default=0.0,
                   help="water self-diffusion in A^2/ps, frames 1 ps apart "
                        "(0 = waters stay on their lattice sites; liquid water ~0.23)")
    g.add_argument("--out", default="system", help="basename for .json/.npz outputs")

    for name, extra in [
        ("tet", [("--high-cut", float, 10.0)]),
        ("3body", [("--high-cut", float, 3.413), ("--max-neighbors", int, 16)]),
        ("lsi", [("--high-cut", float, 3.7)]),
        ("psi", [("--high-cut", float, 7.0)]),
        ("rdf", [("--binwidth", float, 0.1), ("--totbins", int, 150)]),
        ("hb", [("--dist-cut", float, 3.5), ("--ang-cut", float, 120.0)]),
        ("chempot", [("--probe-radius", float, 3.3), ("--insertions", int, 10000)]),
        ("voronoi", [("--engine", str, "auto")]),
        ("contactarea", [("--cutoff", float, 4.0), ("--engine", str, "auto")]),
        ("boundwrap", [("--cutoff", float, 4.0), ("--cache", str, "")]),
        ("msd", [("--dt", float, 1.0)]),
    ]:
        p = sub.add_parser(name)
        _add_common(p)
        for flag, typ, dflt in extra:
            p.add_argument(flag, type=typ, default=dflt)

    args = ap.parse_args(argv)

    if args.cmd == "generate":
        from waterorderlib_tpu.io.synthetic import make_water_box

        sol = [s for s in args.solute.split(",") if s]
        top, traj = make_water_box(
            args.waters, n_frames=args.frames, seed=args.seed,
            solute_elements=sol or None, diffusion=args.diffusion,
        )
        top.to_json(args.out + ".json")
        traj.save(args.out + ".npz", topology=top)
        print(f"wrote {args.out}.json and {args.out}.npz "
              f"({traj.n_frames} frames, {traj.n_atoms} atoms)")
        return 0

    from waterorderlib_tpu.utils import compile_cache

    compile_cache.enable()
    common = dict(stride=args.stride, output_dir=args.output_dir, wat_res=args.wat_res)
    chunk = {"chunk_frames": args.chunk_frames} if args.chunk_frames else {}
    if getattr(args, "mesh", ""):
        from waterorderlib_tpu.parallel.mesh import make_mesh

        df, da = (int(x) for x in args.mesh.lower().split("x"))
        chunk["mesh"] = make_mesh(df, da)

    if args.cmd == "tet":
        from waterorderlib_tpu.drivers.orderparams import tet_order_calc

        avg_q, var_q = tet_order_calc(
            args.top, args.traj, high_cut=args.high_cut, **common, **chunk
        )
        print(json.dumps({"avgQ": avg_q[0].tolist(), "avgQ_CI": avg_q[1].tolist(),
                          "varQ": var_q[0].tolist()}))
    elif args.cmd == "3body":
        from waterorderlib_tpu.drivers.orderparams import three_body_calc

        p_tet, avg_cos, var_cos, entropy, n_wats = three_body_calc(
            args.top, args.traj, high_cut=args.high_cut,
            max_neighbors=args.max_neighbors, **common, **chunk,
        )
        print(json.dumps({"pTet": p_tet[0].tolist(), "entropy": entropy[0].tolist()}))
    elif args.cmd == "lsi":
        from waterorderlib_tpu.drivers.orderparams import lsi_calc

        avg_lsi, var_lsi = lsi_calc(
            args.top, args.traj, high_cut=args.high_cut, **common, **chunk
        )
        print(json.dumps({"avgLSI": avg_lsi[0].tolist(), "varLSI": var_lsi[0].tolist()}))
    elif args.cmd == "psi":
        from waterorderlib_tpu.drivers.orderparams import hex_order_calc

        common.pop("wat_res")
        avg_psi, var_psi = hex_order_calc(
            args.top, args.traj, end_res=args.wat_res, high_cut=args.high_cut,
            **common, **chunk,
        )
        print(json.dumps({"avgPsi": avg_psi[0].tolist()}))
    elif args.cmd == "rdf":
        from waterorderlib_tpu.drivers.rdf import rdf_calc

        res = rdf_calc(args.top, args.traj, binwidth=args.binwidth,
                       totbins=args.totbins, **common, **chunk)
        print(json.dumps({"result": [list(map(float, r)) for r in res]}))
    elif args.cmd == "hb":
        from waterorderlib_tpu.drivers.hbonds_driver import hb_calc

        common.pop("stride")
        avg_wat, avg_sol = hb_calc(args.top, args.traj, stride=args.stride,
                                   dist_cut=args.dist_cut, ang_cut=args.ang_cut,
                                   **common, **chunk)
        print(json.dumps({"avgWatHBs": avg_wat, "avgSolHBs": avg_sol}))
    elif args.cmd == "chempot":
        from waterorderlib_tpu.drivers.chempot import chem_pot_calc

        mu, avg_n, avg_n2 = chem_pot_calc(
            args.top, args.traj, probe_radius=args.probe_radius,
            n_insertions=args.insertions, **common, **chunk,
        )
        print(json.dumps({"muHS": mu, "avgN": avg_n, "avgN2": avg_n2}))
    elif args.cmd == "voronoi":
        from waterorderlib_tpu.drivers.voronoi_driver import voronoi_calc

        mesh_kw = {"mesh": chunk["mesh"]} if "mesh" in chunk else {}
        if args.chunk_frames:
            mesh_kw["chunk_frames"] = args.chunk_frames
        avg_v, var_v, avg_a, var_a, avg_e, var_e = voronoi_calc(
            args.top, args.traj, engine=args.engine, **common, **mesh_kw)
        print(json.dumps({"avgVol": avg_v[0].tolist(), "avgArea": avg_a[0].tolist(),
                          "avgEta": avg_e[0].tolist()}))
    elif args.cmd == "contactarea":
        from waterorderlib_tpu.drivers.voronoi_driver import contact_area_calc

        common.pop("output_dir")
        tot, tot_ci, frac, frac_ci = contact_area_calc(
            args.top, args.traj, cutoff=args.cutoff, engine=args.engine,
            **common
        )
        print(json.dumps({"totArea": tot, "fracArea": frac}))
    elif args.cmd == "boundwrap":
        from waterorderlib_tpu.drivers.hbonds_driver import get_bound_wrap

        common.pop("output_dir")
        common.pop("stride")
        res = get_bound_wrap(args.top, args.traj, cutoff=args.cutoff, **common)
        sizes = [[len(x) for x in frame] for frame in res]
        if args.cache:
            np.savez_compressed(
                args.cache,
                **{f"frame{t}_{k}": np.asarray(v) for t, frame in enumerate(res)
                   for k, v in zip(("bound", "wrap", "shell", "nonshell"), frame)},
            )
        print(json.dumps({"sizes_per_frame": sizes}))
    elif args.cmd == "msd":
        from waterorderlib_tpu.drivers.msd import msd_calc

        mesh_kw = {"mesh": chunk["mesh"]} if "mesh" in chunk else {}
        msd, diff = msd_calc(args.top, args.traj, dt=args.dt, **common, **mesh_kw)
        print(json.dumps({"D": diff, "msd_final": float(msd[-1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
