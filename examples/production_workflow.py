"""End-to-end production workflow example.

Mirrors how the reference library is driven (orderParam_lib.py's inline
driver: load an AMBER topology + trajectory, run the *Calc drivers, collect
the *.txt histogram artifacts) on this package, composing the
round-2 production features:

- real-format front door (.prmtop / .nc / .mdcrd / .dcd route through
  `load_system`; the C++ decoders in native/ accelerate DCD and ASCII),
- larger-than-memory streaming (`chunk_frames=` — double-buffered host
  prefetch + chunk checkpoint/resume),
- device-mesh scale-out (`mesh=` — frames data-parallel x atom rows
  tensor-parallel, psum-reduced statistics).

Run from the repo root:  python examples/production_workflow.py
(uses a small synthetic system so it finishes in ~2 min on one chip; point
`TOP`/`TRAJ` at real files to run your own system).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from waterorderlib_tpu.drivers.hbonds_driver import get_bound_wrap, hb_calc
from waterorderlib_tpu.drivers.orderparams import (
    lsi_calc,
    tet_order_calc,
    three_body_calc,
)
from waterorderlib_tpu.drivers.rdf import rdf_calc
from waterorderlib_tpu.io import mdcrd
from waterorderlib_tpu.io.synthetic import make_water_box

OUT = "example_out"
TOP = os.path.join(OUT, "system.json")
TRAJ = os.path.join(OUT, "production.mdcrd")


def main():
    os.makedirs(OUT, exist_ok=True)

    # --- stand-in for your AMBER files (swap for e.g. x.prmtop + y.nc) ---
    top, traj = make_water_box(512, n_frames=24, seed=7, solute_elements=["C", "C", "O"])
    top.to_json(TOP)
    mdcrd.write_mdcrd(TRAJ, traj)  # classic 10F8.3 ASCII, read back natively

    # --- hydration-shell decomposition (bound/wrap/shell populations) ---
    bound, wrap, shell, non_shell = get_bound_wrap(TOP, TRAJ, frame_index=0, cutoff=4.0)
    print(f"frame 0: {len(bound)} bound, {len(wrap)} wrap, "
          f"{len(shell)} shell waters")

    # --- order parameters, streamed in 8-frame chunks ---
    avg_q, _ = tet_order_calc(TOP, TRAJ, output_dir=OUT, chunk_frames=8)
    p_tet, *_ = three_body_calc(TOP, TRAJ, output_dir=OUT, chunk_frames=8)
    avg_lsi, _ = lsi_calc(TOP, TRAJ, output_dir=OUT, chunk_frames=8)
    print(f"avg q = {float(avg_q[0][0]):.3f}   pTet = {float(p_tet[0][0]):.3f}   "
          f"avg LSI = {float(avg_lsi[0][0]):.4f}")

    # --- pair statistics + H-bond populations ---
    rdf_calc(TOP, TRAJ, output_dir=OUT)
    hb_wat, hb_sol = hb_calc(TOP, TRAJ, output_dir=OUT)
    print(f"avg H-bonds/water = {hb_wat:.2f}")

    # To shard any of the above over several devices, pass a mesh:
    #   from waterorderlib_tpu.parallel.mesh import make_mesh
    #   tet_order_calc(TOP, TRAJ, mesh=make_mesh(4, 2), ...)
    # (same code on one GPU, four GPUs, or a spoofed 8-device CPU mesh.)

    print("artifacts:", sorted(f for f in os.listdir(OUT) if f.endswith(".txt")))


if __name__ == "__main__":
    main()
