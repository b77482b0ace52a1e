#!/usr/bin/env python
"""On-card smoke test: run the analysis drivers on one NVIDIA GPU and check
them against the repository's references.

    python chip_smoke.py               # phases 0-4 on one card
    python chip_smoke.py --four-cards  # phase 5 only, on four cards

Phases:
  0. device check: the card (nvidia-smi), JAX's version and devices; stops
     unless JAX's platform is "gpu";
  1. the `gpu`-marked tests, in a pytest subprocess started before this
     process touches the card (one JAX process per card);
  2. the main path at full width: `generate` + `tet` through the CLI at
     32,768 waters x 64 frames and 4,096 waters x 1,024 frames of diffusing
     water; per-frame q against XLA on the card, the histogram, and the
     numpy reference;
  3. the other drivers at 4,096 waters x 32 frames with a solute, each
     against its numpy reference (or the Qhull oracle) on frame 0, plus
     `hb_calc` at 32,768 waters;
  4. timings: `tet_order_calc` end to end with the GPU kernel and with XLA,
     the q computation alone, and the Voronoi engines, compile time apart;
  5. (--four-cards) tet/rdf/3-body on 4x1 and 2x2 meshes against one card.

Every phase prints what it compared and with which tolerance. The last line
of standard output is one JSON object, printed only when every phase passed:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "smoke_out", "data")
Q_ATOL = 1e-5  # float32 q from the kernel path vs XLA on the same card
# two float32 searches may pick different 4th neighbours when the 4th and
# 5th lie within rounding of each other: such a row is a tie, and both q
# values are right to float32 precision
TIE_REL = 1e-6  # (d5 - d4) / d4 in float64: ~8 float32 ulps
MAX_TIE_FRAC = 1e-5


def log(*args):
    print(*args, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, what):
    log(("  ok   " if cond else "  FAIL ") + what)
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- phase 0


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()[:300]}")
    return out.stdout.strip()


def phase0() -> str:
    log("== phase 0: device check")
    if not os.path.isdir(os.path.join(ROOT, "waterorderlib_tpu")):
        raise SmokeFailure("the waterorderlib_tpu package is not beside chip_smoke.py")
    try:
        card = card_identity()
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"no NVIDIA GPU: nvidia-smi unavailable ({e})") from e
    log("card:", card.replace("\n", " | "))
    probe = subprocess.run(
        [sys.executable, "-c",
         "import json, jax; d = jax.devices(); print(json.dumps({'jax': "
         "jax.__version__, 'platform': d[0].platform, 'devices': [str(x) for x in d]}))"],
        capture_output=True, text=True, timeout=300,
    )
    if probe.returncode != 0:
        raise SmokeFailure(f"JAX could not start: {probe.stderr.strip()[-500:]}")
    info = json.loads(probe.stdout.strip().splitlines()[-1])
    log(f"jax {info['jax']}, devices {info['devices']}")
    check(info["platform"] == "gpu", f"JAX platform is gpu (got {info['platform']})")
    return card


# ---------------------------------------------------------------- phase 1


def phase1():
    log("== phase 1: gpu-marked tests")
    env = dict(os.environ, WOL_TEST_GPU="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-p", "no:cacheprovider",
         "tests/"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    tail = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    log(f"  pytest -m gpu: rc={out.returncode} '{tail}' ({time.perf_counter() - t0:.1f} s)")
    if out.returncode != 0:
        log(out.stdout[-3000:], out.stderr[-2000:])
    check(out.returncode == 0 and " passed" in tail and "skipped" not in tail,
          "every gpu-marked test passed on the card")


# ---------------------------------------------------------------- helpers


def generate(n_waters, n_frames, seed, solute="", diffusion=0.0):
    from waterorderlib_tpu.__main__ import main

    base = os.path.join(DATA, f"w{n_waters}_f{n_frames}{'_sol' if solute else ''}")
    args = ["generate", "--waters", str(n_waters), "--frames", str(n_frames),
            "--seed", str(seed), "--out", base, "--diffusion", str(diffusion)]
    if solute:
        args += ["--solute", solute]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        main(args)
    log(f"  generated {n_waters} waters x {n_frames} frames in {time.perf_counter() - t0:.1f} s")
    return base + ".json", base + ".npz"


def water_arrays(top, traj):
    import jax.numpy as jnp

    wi = top.get_wat_inds()[0]
    return jnp.asarray(traj.positions[:, wi], jnp.float32), jnp.asarray(traj.boxes, jnp.float32)


def first_frame(traj):
    from waterorderlib_tpu.io.trajectory import Trajectory

    return Trajectory(traj.positions[:1], traj.boxes[:1])


def q_tie_rows(q_a, q_b, pos, boxes, atol):
    """(rows whose q differs by more than atol, how many of them are float32
    ties: 4th and 5th nearest neighbours within TIE_REL in float64)."""
    import numpy as np

    bad = np.argwhere(np.abs(q_a - q_b) > atol)
    ties = 0
    for f, i in bad:
        p = np.asarray(pos[f], np.float64)
        box = np.asarray(boxes[f], np.float64)
        d = p - p[i]
        d -= box * np.round(d / box)
        r = np.sort(np.sqrt((d * d).sum(1)))[1:6]  # [0] is the row itself
        ties += int(r[4] - r[3] <= TIE_REL * r[3])
        if len(bad) <= 50 or f == bad[0][0]:
            log(f"    frame {f} row {i}: q {q_a[f, i]:.6f} vs {q_b[f, i]:.6f}, "
                f"4th/5th neighbours at {r[3]:.7f}/{r[4]:.7f} A (float64)")
    return len(bad), ties


def q_histogram_flips(q_a, q_b, atol):
    """(flips between the two 500-bin histograms, values of q_b within atol
    of a bin edge: the most that can flip when |q_a - q_b| <= atol)."""
    import numpy as np

    h_a = np.histogram(q_a, 500, (0.0, 1.0))[0]
    h_b = np.histogram(q_b, 500, (0.0, 1.0))[0]
    x = np.asarray(q_b, np.float64) * 500.0
    near = np.abs(x - np.round(x)) * (1.0 / 500.0) <= atol
    return int(np.abs(h_a - h_b).sum() // 2), int(near.sum())


# ---------------------------------------------------------------- phase 2


def phase2_size(n_waters, n_frames, seed):
    import jax
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from reference import refimpl

    import jax.numpy as jnp

    from waterorderlib_tpu.__main__ import main
    from waterorderlib_tpu.io.trajectory import load_system
    from waterorderlib_tpu.ops import histograms
    from waterorderlib_tpu.order import qtet

    # liquid water's self-diffusion, frames 1 ps apart: waters wander
    # across the box over the trajectory, as in MD
    top_f, traj_f = generate(n_waters, n_frames, seed, diffusion=0.23)
    out_dir = os.path.join(DATA, f"tet_{n_waters}")
    os.makedirs(out_dir, exist_ok=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(["tet", top_f, traj_f, "--output-dir", out_dir])
    t_cli = time.perf_counter() - t0
    check(rc == 0, f"`tet` CLI at {n_waters} x {n_frames} exited 0 ({t_cli:.1f} s incl. load + compile)")
    cli = json.loads(buf.getvalue().strip().splitlines()[-1])

    top, traj = load_system(top_f, traj_f)
    pos, boxes = water_arrays(top, traj)
    q_k, tier = qtet.order_param_q_certified(pos, boxes, 0.0, 10.0)
    q_k = np.asarray(q_k)
    check(tier.startswith("window"), f"the tet path served the GPU kernel (tier={tier})")
    q_x = np.asarray(jax.jit(qtet.order_param_q_traj)(pos, boxes, 0.0, 10.0))
    n_bad, n_ties = q_tie_rows(q_k, q_x, pos, boxes, Q_ATOL)
    dq = float(np.max(np.abs(q_k - q_x)))
    check(n_bad == n_ties and n_bad <= MAX_TIE_FRAC * q_k.size,
          f"per-frame q vs XLA on the card: {q_k.size - n_bad} rows within {Q_ATOL} (float32); "
          f"{n_bad} rows differ (max |dq| = {dq:.3g}), all 4th/5th-neighbour ties within "
          f"{TIE_REL} relative in float64, <= {MAX_TIE_FRAC} of rows")
    flips, near = q_histogram_flips(q_k, q_x, Q_ATOL)
    check(flips <= near + n_ties, f"500-bin q histogram: {flips} flips <= {near} values within {Q_ATOL} "
          f"of a bin edge + {n_ties} tie rows")
    # the driver bins in float32 (histograms.masked_histogram): compare the
    # file with the same binning of the kernel path's q; %.3e text
    file_hist = np.loadtxt(os.path.join(out_dir, "qDistribution_0.txt"))[:, 1]
    h_k = np.asarray(jax.jit(lambda q: histograms.masked_histogram(
        q.reshape(-1), jnp.ones(q.size, bool), 500, 0.0, 1.0))(jnp.asarray(q_k)))
    rel = float(np.max(np.abs(file_hist - h_k) / np.maximum(h_k, 1.0)))
    check(rel <= 5e-4, f"CLI qDistribution_0.txt vs the histogram of the kernel path's q: max rel {rel:.2g} <= 5e-4 (%.3e text)")
    mean_x = float(np.mean(np.mean(q_x, axis=1)))
    check(abs(cli["avgQ"][0] - mean_x) <= Q_ATOL,
          f"CLI avgQ {cli['avgQ'][0]:.7f} vs XLA {mean_x:.7f} (<= {Q_ATOL})")
    rs = np.random.RandomState(seed)
    centres = np.sort(rs.choice(n_waters, 256, replace=False))
    p0 = np.asarray(pos[0], np.float64)
    q_ref = refimpl.order_param_q(p0[centres], p0, np.asarray(boxes[0], np.float64))
    d_ref = float(np.max(np.abs(q_k[0, centres] - q_ref)))
    check(d_ref <= 1e-4, f"q of 256 frame-0 centres vs refimpl (f64): max |dq| = {d_ref:.3g} <= 1e-4 (float32 positions)")
    return top_f, traj_f


def phase2():
    log("== phase 2: main path at full width (generate + tet through the CLI)")
    return {nw: phase2_size(nw, nf, seed) for nw, nf, seed in ((32768, 64, 1), (4096, 1024, 2))}


# ---------------------------------------------------------------- phase 3


def numpy_sasa(pos, radii, box, points, rows):
    """Shrake-Rupley exposed area of `rows` (numpy, float64): a point is
    occluded when strictly inside another atom's sphere (minimum image)."""
    import numpy as np

    areas = []
    for i in rows:
        pts = pos[i] + radii[i] * points
        d = pos - pos[i]
        d -= box * np.round(d / box)
        occ_centres = pos[i] + d
        d2 = ((pts[:, None, :] - occ_centres[None, :, :]) ** 2).sum(-1)
        occ = d2 < radii[None, :] ** 2
        occ[:, i] = False
        areas.append(4.0 * np.pi * radii[i] ** 2 * (~occ.any(1)).sum() / len(points))
    return np.asarray(areas)


def numpy_willard(pos, pts, box, sigma=2.4):
    import numpy as np

    sig2 = sigma * sigma
    shift = np.exp(-4.5) / (2.0 * np.pi * sig2) ** 1.5
    d = pts[:, None, :] - pos[None, :, :]
    d -= box * np.round(d / box)
    rsq = (d * d).sum(-1)
    g = np.exp(-rsq / (2.0 * sig2)) / (2.0 * np.pi * sig2) ** 1.5
    return np.where(rsq < 9.0 * sig2, g - shift, 0.0).sum(1)


def phase3(big_system, n_waters=4096, n_frames=32):
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from reference import refimpl

    from waterorderlib_tpu.core.geometry import sphere_points
    from waterorderlib_tpu.density import fields
    from waterorderlib_tpu.drivers import orderparams as op
    from waterorderlib_tpu.drivers.hbonds_driver import hb_calc
    from waterorderlib_tpu.drivers.rdf import rdf_calc
    from waterorderlib_tpu.drivers.voronoi_driver import voronoi_calc
    from waterorderlib_tpu.io.trajectory import load_system
    from waterorderlib_tpu.ops import pairs
    from waterorderlib_tpu.surface import grids, sasa
    from waterorderlib_tpu.surface.voronoi import voronoi_volumes
    from waterorderlib_tpu.surface.voronoi_device import voronoi_volumes_hybrid_frames

    log(f"== phase 3: other drivers at {n_waters} waters x {n_frames} frames with a solute")
    top, traj = load_system(*generate(n_waters, n_frames, 3, solute="C,C,O,N,C"))
    one = first_frame(traj)
    out = os.path.join(DATA, "drivers")
    os.makedirs(out, exist_ok=True)
    wat = top.get_wat_inds()[0]
    p0 = np.asarray(traj.positions[0], np.float64)
    box0 = np.asarray(traj.boxes[0], np.float64)
    w0 = p0[wat]

    def run(name, fn):
        t0 = time.perf_counter()
        res = fn(traj)
        log(f"  {name}: {n_frames} frames in {time.perf_counter() - t0:.1f} s (incl. compile)")
        return res, fn(one)

    res, r0 = run("three_body_calc", lambda t: op.three_body_calc(top, t, output_dir=out))
    check(all(np.all(np.isfinite(x[0])) for x in res), "three_body_calc: finite")
    angs, _ = refimpl.get_cos_angs(w0, w0, box0)
    _, _, frac, avg, _, _ = refimpl.tetrahedral_metrics(angs)
    check(abs(r0[0][0][0] - frac) <= 2e-3 and abs(r0[1][0][0] - avg) <= 2e-3,
          f"three_body_calc frame 0 vs refimpl: pTet {r0[0][0][0]:.5f}/{frac:.5f}, avgCos "
          f"{r0[1][0][0]:.5f}/{avg:.5f} (abs 2e-3: float32 flips at the 3.413 A and 100/120 deg edges)")

    res, r0 = run("lsi_calc", lambda t: op.lsi_calc(top, t, output_dir=out))
    check(np.all(np.isfinite(res[0][0])), "lsi_calc: finite")
    vals, _, _ = refimpl.lsi(w0, w0, box0)
    check(abs(r0[0][0][0] - vals.mean()) <= 0.01 * vals.mean(),
          f"lsi_calc frame 0 vs refimpl: {r0[0][0][0]:.6f}/{vals.mean():.6f} (rel 1%: a float32 flip at the 3.7 A shell edge moves one atom's LSI by O(itself))")

    t0 = time.perf_counter()
    res = op.hex_order_calc(top, traj, output_dir=out)
    log(f"  hex_order_calc: {n_frames} frames in {time.perf_counter() - t0:.1f} s (incl. compile)")
    check(np.all(np.isfinite(res[0][0])), "hex_order_calc: finite")
    # the driver keeps the 24 nearest chain ends of each 7 A shell; the
    # reference takes the whole shell. Here the ends are every other water,
    # ~24 per shell, so the cap truncates many shells: compare the default
    # with the reference under the same cap, and a 64-wide candidate list
    # (which holds every shell) with the uncapped reference.
    ends = w0[1::2]
    in_shell = refimpl.all_near_neighbors(ends, box0, 0.0, 7.0).sum(1)
    psi_cap = refimpl.order_param_psi(ends, ends, box0, 0.0, 7.0, max_neighbors=24)
    psi = refimpl.order_param_psi(ends, ends, box0, 0.0, 7.0)
    r0 = op.hex_order_calc(top, one, output_dir=out)
    check(abs(r0[0][0][0] - psi_cap.mean()) <= 1e-3,
          f"hex_order_calc (K=24) frame 0 vs refimpl capped at 24: {r0[0][0][0]:.6f}/{psi_cap.mean():.6f} "
          f"(abs 1e-3: float32 flips at the shell edge and the 24th neighbour); the cap truncated "
          f"{int((in_shell > 24).sum())}/{len(ends)} shells, moving the mean by {psi_cap.mean() - psi.mean():+.2g}")
    r0 = op.hex_order_calc(top, one, output_dir=out, max_neighbors=64)
    check(abs(r0[0][0][0] - psi.mean()) <= 1e-3,
          f"hex_order_calc (K=64) frame 0 vs refimpl, whole shell: {r0[0][0][0]:.6f}/{psi.mean():.6f} (abs 1e-3, float32 shell-edge flips)")

    t0 = time.perf_counter()
    rdf = rdf_calc(top, traj, output_dir=out)
    log(f"  rdf_calc: {n_frames} frames in {time.perf_counter() - t0:.1f} s (incl. compile)")
    check(all(np.all(np.isfinite(np.asarray(x, float))) for x in rdf), "rdf_calc: finite")
    import jax.numpy as jnp

    c_dev = np.asarray(pairs.distance_histogram(
        jnp.asarray(w0, jnp.float32), jnp.asarray(w0, jnp.float32),
        jnp.asarray(box0, jnp.float32), 0.1, 150, same=True))
    # refimpl.radial_dist_counts' ceiling binning, vectorised
    dsq = refimpl.dist_sq_matrix(w0, w0, box0)[np.triu_indices(len(w0), k=1)]
    nbin = np.ceil(np.sqrt(dsq) / 0.1).astype(int)
    nbin = nbin[(nbin >= 1) & (nbin <= 150)]
    c_ref = np.bincount(nbin - 1, minlength=150).astype(float)
    flips = float(np.abs(c_dev - c_ref).sum() / 2)
    n_pairs = len(w0) * (len(w0) - 1) / 2
    check(flips <= 5e-5 * n_pairs,
          f"rdf_calc's O-O pair histogram, frame 0 vs refimpl: {flips:.0f} bin flips <= 5e-5 of {n_pairs:.0f} pairs (float32 distances, ~1e-6 A off, against 0.1 A bins)")

    t0 = time.perf_counter()
    wat_hb, _ = hb_calc(top, traj, output_dir=out)
    log(f"  hb_calc: {n_frames} frames in {time.perf_counter() - t0:.1f} s (incl. compile)")
    hb0, _ = hb_calc(top, one, output_dir=out)
    ref = float(refimpl.hbonds_per_water(top, p0, box0).mean())
    check(np.isfinite(wat_hb) and abs(hb0 - ref) <= 4.0 / len(wat),
          f"hb_calc frame 0 vs refimpl: {hb0:.5f}/{ref:.5f} H-bonds per water (abs 4/Nw: two float32 flips at the 3.5 A / 120 deg cutoffs)")
    big_top, big_traj = load_system(*big_system)
    t0 = time.perf_counter()
    big_hb, _ = hb_calc(big_top, big_traj, output_dir=out)
    log(f"  hb_calc at {big_top.get_wat_inds()[0].size} waters x {big_traj.n_frames} frames: "
        f"{time.perf_counter() - t0:.1f} s")
    check(np.isfinite(big_hb) and big_hb > 0, f"hb_calc completes at 32,768 waters ({big_hb:.4f} per water)")

    heavy = np.concatenate([wat, top.get_sol_inds()[0]])
    radii = np.full(len(heavy), 1.5 + 1.4)
    pts = sphere_points(240)
    t0 = time.perf_counter()
    areas, _ = sasa.sasa_per_atom(p0[heavy].astype(np.float32), radii - 1.4, box0, n_points=240)
    log(f"  sasa_per_atom: {len(heavy)} atoms in {time.perf_counter() - t0:.1f} s")
    rows = np.arange(len(heavy) - 64, len(heavy))  # the solute and the last waters
    a_ref = numpy_sasa(p0[heavy], radii, box0, pts, rows)
    da = float(np.max(np.abs(np.asarray(areas)[rows] - a_ref)))
    quantum = float(4 * np.pi * radii[0] ** 2 / len(pts))
    check(da <= quantum + 1e-3,
          f"SASA of 64 atoms vs numpy Shrake-Rupley: max |dA| = {da:.4f} <= one sphere point ({quantum:.4f} A^2)")

    t0 = time.perf_counter()
    verts, faces = grids.density_grid(p0[top.get_sol_inds()[0]], w0, box0)
    # a small solute's cavity is smoothed away at 2.4 A in a full box, so
    # the isosurface may well be empty; the field itself is checked below
    log(f"  density_grid (Willard, 81^3): {time.perf_counter() - t0:.1f} s, {len(faces)} faces")
    rs = np.random.RandomState(5)
    probe = rs.uniform(0, box0[0], (256, 3))
    d_dev = np.asarray(fields.willard_density_points(
        jnp.asarray(w0, jnp.float32), jnp.asarray(probe, jnp.float32),
        jnp.asarray(box0, jnp.float32), 2.4)[0])
    d_ref = numpy_willard(w0, probe, box0)
    err = float(np.max(np.abs(d_dev - d_ref)) / np.max(np.abs(d_ref)))
    check(err <= 1e-4, f"Willard density at 256 points vs numpy: max err {err:.2g} of peak <= 1e-4 (float32 exp sums)")

    t0 = time.perf_counter()
    vres = voronoi_calc(top, traj, output_dir=out, engine="device")
    log(f"  voronoi_calc(engine='device'): {n_frames} frames in {time.perf_counter() - t0:.1f} s (incl. compile)")
    check(all(np.all(np.isfinite(x[0])) for x in vres), "voronoi_calc device engine: finite")
    # the same batch shape as voronoi_calc's 16-frame chunks, so the device
    # program compiled above serves this check too
    nf = min(n_frames, 16)
    pts = np.mod(np.asarray(traj.positions[:nf], np.float64)[:, heavy], box0[0])
    vol_d, _, n_cert = voronoi_volumes_hybrid_frames(pts, np.full(nf, box0[0]), len(wat))
    vol_h, _ = voronoi_volumes(pts[0], float(box0[0]), len(wat))
    rel = float(np.max(np.abs(vol_d[0] - vol_h) / vol_h))
    check(rel <= 2e-3, f"device Voronoi volumes, frame 0 vs host Qhull (f64): max rel {rel:.2g} <= 2e-3 "
          f"(certified float32 cells), {n_cert}/{nf * len(wat)} certified on device")
    return top, traj


# ---------------------------------------------------------------- phase 4


def time_call(fn, reps=3):
    """(first call seconds, median of `reps` later calls)."""
    import numpy as np

    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts))


def compile_seconds(jitted, *args, **kwargs):
    """Seconds to trace, lower and compile `jitted` for these arguments from
    nothing: in-memory caches cleared, the persistent cache off."""
    import jax

    saved = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    jax.clear_caches()
    try:
        t0 = time.perf_counter()
        jitted.lower(*args, **kwargs).compile()
        return time.perf_counter() - t0
    finally:
        jax.config.update("jax_enable_compilation_cache", saved)


def phase4(card, systems, phase3_system):
    from unittest import mock

    import jax

    from waterorderlib_tpu.drivers import orderparams as op
    from waterorderlib_tpu.drivers.voronoi_driver import voronoi_calc
    from waterorderlib_tpu.io.trajectory import Trajectory, load_system
    from waterorderlib_tpu.ops import backend, slab
    from waterorderlib_tpu.order import qtet

    log(f"== phase 4: timings on {card}")
    tmp = os.path.join(DATA, "timing")
    os.makedirs(tmp, exist_ok=True)
    report = {}
    for nw, (top_f, traj_f) in systems.items():
        top, traj = load_system(top_f, traj_f)
        F = traj.n_frames

        def e2e():
            op.tet_order_calc(top, traj, output_dir=tmp)

        first_k, t_k = time_call(e2e)
        with mock.patch.object(backend, "is_gpu", lambda: False):
            first_x, t_x = time_call(e2e)
        pos, boxes = water_arrays(top, traj)
        bz = float(boxes[0, 2])
        w = slab.suggest_window(nw, bz, qtet.MARGIN, qtet.ROW_TILE)
        pad = slab.suggest_pad(nw, bz, qtet.MARGIN)
        q_fns = {  # name: (jitted, args, kwargs)
            "kernel": (qtet.order_param_q_windowed, (pos, boxes, 0.0, 10.0, qtet.MARGIN),
                       dict(row_tile=qtet.ROW_TILE, window=w, pad=pad)),
            "xla": (qtet.order_param_q_traj, (pos, boxes, 0.0, 10.0), {}),
        }
        row = {"frames": F, "e2e_fps_kernel": F / t_k, "e2e_fps_xla": F / t_x,
               "e2e_first_call_s_kernel": first_k, "e2e_first_call_s_xla": first_x}
        for name, (fn, a, kw) in q_fns.items():
            row[f"q_fps_{name}"] = F / time_call(lambda: jax.block_until_ready(fn(*a, **kw)))[1]
        for name, (fn, a, kw) in q_fns.items():
            row[f"q_compile_s_{name}"] = compile_seconds(fn, *a, **kw)
        report[f"tet_{nw}w"] = row
        log(f"  tet_order_calc {nw} waters x {F} frames: e2e {row['e2e_fps_kernel']:.1f} frames/s "
            f"with the kernel vs {row['e2e_fps_xla']:.1f} with XLA (first calls in this process "
            f"{first_k:.2f} s / {first_x:.2f} s)")
        log(f"    q alone: kernel {row['q_fps_kernel']:.1f}, XLA all-pairs {row['q_fps_xla']:.1f} "
            f"frames/s; cold compile {row['q_compile_s_kernel']:.2f} / {row['q_compile_s_xla']:.2f} s")

    top, traj = phase3_system
    nf = min(traj.n_frames, 16)  # one device chunk: the shape phase 3 compiled
    sub = Trajectory(traj.positions[:nf], traj.boxes[:nf])
    n_heavy = len(top.get_wat_inds()[0]) + len(top.get_sol_inds()[0])
    for engine in ("host", "device"):
        first, t = time_call(lambda: voronoi_calc(top, sub, output_dir=tmp, engine=engine), reps=1)
        report[f"voronoi_{engine}"] = {"points": n_heavy, "frames": nf, "s_per_frame": t / nf,
                                       "first_call_s": first}
        log(f"  voronoi_calc engine={engine}: {n_heavy} points, {nf} frames, {t / nf * 1e3:.1f} "
            f"ms/frame (first call {first:.1f} s)")
    return report


# ---------------------------------------------------------------- phase 5


def phase5(n_waters=32768, n_frames=64):
    import jax
    import numpy as np

    from waterorderlib_tpu.drivers import orderparams as op
    from waterorderlib_tpu.drivers.rdf import rdf_calc
    from waterorderlib_tpu.io.trajectory import load_system
    from waterorderlib_tpu.parallel.mesh import make_mesh

    n_dev = len(jax.devices())
    log(f"== phase 5: meshes over {n_dev} cards, {n_waters} waters x {n_frames} frames")
    check(n_dev == 4, f"four devices visible (got {n_dev})")
    top, traj = load_system(*generate(n_waters, n_frames, 4))
    out = os.path.join(DATA, "mesh")
    os.makedirs(out, exist_ok=True)
    drivers = {
        "tet_order_calc": lambda m: op.tet_order_calc(top, traj, output_dir=out, mesh=m),
        "rdf_calc": lambda m: rdf_calc(top, traj, output_dir=out, mesh=m),
        "three_body_calc": lambda m: op.three_body_calc(top, traj, output_dir=out, mesh=m),
    }
    report = {}
    for name, fn in drivers.items():
        fn(None)  # compile
        t0 = time.perf_counter()
        ref = fn(None)
        report[f"{name}_1card_s"] = time.perf_counter() - t0
        ref_flat = np.concatenate([np.ravel(np.asarray(r[0] if isinstance(r, list) else r, float)) for r in ref])
        for shape in ((4, 1), (2, 2)):
            m = make_mesh(*shape)
            fn(m)  # compile
            t0 = time.perf_counter()
            res = fn(m)
            wall = time.perf_counter() - t0
            flat = np.concatenate([np.ravel(np.asarray(r[0] if isinstance(r, list) else r, float)) for r in res])
            dev = float(np.max(np.abs(flat - ref_flat) / np.maximum(np.abs(ref_flat), 1e-6)))
            report[f"{name}_{shape[0]}x{shape[1]}"] = {"wall_s": wall, "max_rel_dev": dev}
            check(dev <= 1e-4, f"{name} on a {shape[0]}x{shape[1]} mesh vs one card: max rel dev {dev:.2g} <= 1e-4 "
                  f"(wall {wall:.2f} s vs {report[f'{name}_1card_s']:.2f} s on one card, both compiled)")
    return report


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase (needs four GPUs)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    try:
        card = phase0()
        if not args.four_cards:
            phase1()
        sys.path.insert(0, ROOT)
        import jax

        from waterorderlib_tpu.utils import compile_cache

        log("compile cache:", compile_cache.enable())
        dev = jax.devices()[0]
        check(dev.platform == "gpu", f"this process sees a GPU ({dev.device_kind})")
        os.makedirs(DATA, exist_ok=True)
        if args.four_cards:
            report = {"four_cards": phase5()}
        else:
            systems = phase2()
            p3 = phase3(systems[32768])
            report = {"timings": phase4(card, systems, p3)}
    except SmokeFailure as e:
        log(f"chip_smoke FAILED: {e}")
        return 1
    finally:
        shutil.rmtree(DATA, ignore_errors=True)
    report.update(card=card, wall_s=time.perf_counter() - t_start)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                           "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
