#!/usr/bin/env python
"""Benchmark on one NVIDIA GPU: q_tet throughput on a 4k-water box
(frames/s), plus a per-analysis breakdown (3-body, LSI, psi6, H-bonds, RDF,
Willard, SASA, spherical harmonics, Voronoi).

The headline runs `tet_order_calc`'s own path (`order.qtet
.order_param_q_certified`: the windowed GPU neighbour kernel with its
certificates) on F=1024 frames held on the device. The baseline is the
single-core C++ implementation of the same algorithm
(native/baseline_qtet.cc, built at first use); if it cannot be built the
recorded constant is used.

Without a GPU the benchmark prints one JSON error line and exits non-zero:
a number from another backend is never reported.

Prints ONE JSON line:
  {"metric": "qtet_frames_per_sec", "value": N, "unit": "...",
   "vs_baseline": N, "spread_pct": N, "device": {...}, "breakdown": {...}}

`python bench.py --voronoi-engines` instead times `voronoi_calc` and
`contact_area_calc` end to end with each engine, compile included: every
run in a fresh process with the persistent compile cache off, as a user's
first run pays it. One JSON line per run, then a summary line.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# single core, g++ -O3, 4096 waters: ./native/baseline_qtet 4096 3
BASELINE_FPS = 9.073

N_WATERS = 4096
N_FRAMES = 1024
HIGH_CUT = 10.0
METRIC = "qtet_frames_per_sec"
UNIT = f"frames/s (4096 waters, q_tet + histogram, F={N_FRAMES} batch)"


def measure_baseline() -> float:
    from waterorderlib_tpu.utils import native

    exe = native.build("baseline_qtet")
    if exe is not None:
        out = subprocess.run(
            [exe, str(N_WATERS), "3"], capture_output=True, text=True, timeout=300
        ).stdout
        for line in out.splitlines():
            if line.startswith("frames_per_sec"):
                return float(line.split()[1])
    return BASELINE_FPS


def _make_traj(n_waters, n_frames, seed=0):
    """Oxygens of a box of water diffusing at 0.23 A^2/ps, frames 1 ps apart."""
    from waterorderlib_tpu.io.synthetic import make_water_box

    top, traj = make_water_box(n_waters, n_frames, seed=seed, diffusion=0.23)
    pos = np.mod(traj.positions[:, top.get_wat_inds()[0]], traj.boxes[:, None, :])
    return pos.astype(np.float32), traj.boxes.astype(np.float32), float(traj.boxes[0, 0])


def _time_batch(fn, args, n_frames, iters=5):
    """Median seconds per frame over `iters` calls after one warm-up call
    (compilation), each ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    spread = float(np.max(times) - np.min(times)) / med if med else 0.0
    return med / n_frames, spread


def headline():
    import jax
    import jax.numpy as jnp

    from waterorderlib_tpu.ops import histograms
    from waterorderlib_tpu.order import qtet

    pos, boxes, _ = _make_traj(N_WATERS, N_FRAMES)
    pos_d, boxes_d = jax.device_put(pos), jax.device_put(boxes)

    tiers = []

    def q_fn(p, b):
        q, tier = qtet.order_param_q_certified(p, b, 0.0, HIGH_CUT)
        tiers.append(tier)
        return q, histograms.masked_histogram(q, jnp.ones_like(q, bool), 500, 0.0, 1.0)

    sec_per_frame, spread = _time_batch(q_fn, (pos_d, boxes_d), N_FRAMES)
    return 1.0 / sec_per_frame, spread, tiers[-1]


def breakdown():
    """Per-analysis ms/frame on a 4k box (F=32), plus Voronoi at 12k."""
    import jax
    import jax.numpy as jnp

    from waterorderlib_tpu.hbonds import bonds
    from waterorderlib_tpu.ops import pairs
    from waterorderlib_tpu.order import angles as angles_mod
    from waterorderlib_tpu.order import lsi as lsi_mod
    from waterorderlib_tpu.order import psi6 as psi6_mod

    F = 32
    pos, boxes, box_len = _make_traj(N_WATERS, F, seed=1)
    args = (jax.device_put(pos), jax.device_put(boxes))
    out = {}

    def scan_fn(per_frame):
        @jax.jit
        def run(p, b):
            def one(carry, frame):
                return carry, per_frame(frame[0], frame[1])

            return jax.lax.scan(one, 0.0, (p, b))[1]

        return run

    def entry(sec, n_atoms, frames, **extra):
        return {"ms_per_frame": sec * 1e3, "n_atoms": n_atoms, "frames": frames, **extra}

    cases = {
        "three_body": scan_fn(
            lambda p, b: angles_mod.angle_histogram(
                angles_mod.neighbor_angles(p, p, b, 0.0, 3.413, k=16, row_block=512)
            )
        ),
        "lsi": scan_fn(lambda p, b: lsi_mod.lsi(p, p, b, 0.0, 3.7, k=24, row_block=512).lsi),
        "psi6": scan_fn(
            lambda p, b: psi6_mod.order_param_psi(p, p, b, 0.0, 7.0, k=24, row_block=512)
        ),
        "hbonds": scan_fn(
            lambda p, b: bonds.hbond_counts(p, p, p + jnp.float32(0.5), b, 3.5, 120.0)[0]
        ),
        "rdf": scan_fn(
            lambda p, b: pairs.distance_histogram(p, p, b, 0.1, 150, same=True, row_block=512)
        ),
    }
    for name, fn in cases.items():
        sec, _ = _time_batch(fn, args, F, iters=3)
        out[name] = entry(sec, N_WATERS, F)

    from waterorderlib_tpu.density import fields

    g = jnp.linspace(0.0, box_len, 81).astype(jnp.float32)
    willard = scan_fn(
        lambda p, b: jnp.sum(fields.willard_density_field(p, g, g, g, b, 2.4, nx=81, ny=81, nz=81)[0])
    )
    sec, _ = _time_batch(willard, (args[0][:8], args[1][:8]), 8, iters=3)
    out["willard"] = entry(sec, N_WATERS, 8, grid="81^3")

    from waterorderlib_tpu.core.geometry import sphere_points
    from waterorderlib_tpu.surface import sasa

    pts = jnp.asarray(sphere_points(1000), jnp.float32)
    radii = jnp.full((N_WATERS,), 2.9, jnp.float32)  # vdW 1.5 + probe 1.4
    sasa_fn = scan_fn(lambda p, b: jnp.sum(sasa.sphere_surface_areas_topk(p, radii, pts, b)[0]))
    sec, _ = _time_batch(sasa_fn, (args[0][:4], args[1][:4]), 4, iters=3)
    out["sasa"] = entry(sec, N_WATERS, 4, n_sphere_points=1000)

    from waterorderlib_tpu.order import sphharm

    box_arr = jnp.array([box_len] * 3, jnp.float32)
    sph = scan_fn(lambda p, b: sphharm._coeff_sums_mpos(p, p, box_arr, 0.0, 3.413, 12, 16, 512)[0])
    sec, _ = _time_batch(sph, (args[0][:4], args[1][:4]), 4, iters=3)
    out["sphharm_l12"] = entry(sec, N_WATERS, 4, max_degree=12)

    from waterorderlib_tpu.surface.voronoi_device import voronoi_volumes_hybrid_frames

    nv, fv = 12288, 8
    posv, _, boxv = _make_traj(nv, fv, seed=6)
    bls = np.full((fv,), boxv, np.float32)
    voronoi_volumes_hybrid_frames(posv, bls, nv)  # compile
    t0 = time.perf_counter()
    _, _, n_cert = voronoi_volumes_hybrid_frames(posv, bls, nv)
    out["voronoi_frames_e2e"] = entry(
        (time.perf_counter() - t0) / fv, nv, fv, certified_frac=n_cert / (nv * fv)
    )
    return out


VORONOI_RUNS = [  # (driver, waters, frames): waters + a 5-atom solute
    ("voronoi_calc", 2048, 32), ("voronoi_calc", 4096, 32),
    ("contact_area_calc", 4096, 8),
]


def voronoi_child(driver, n_waters, n_frames, engine):
    """One cold run: [first call seconds, second call seconds]; the host
    engine compiles nothing, so it runs once."""
    import jax

    jax.config.update("jax_enable_compilation_cache", False)
    from waterorderlib_tpu.drivers import voronoi_driver
    from waterorderlib_tpu.io.synthetic import make_water_box

    top, traj = make_water_box(n_waters, n_frames, seed=5, diffusion=0.23,
                               solute_elements=["C", "C", "O", "N", "C"])
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "smoke_out", "bench")
    os.makedirs(out, exist_ok=True)
    kw = {"output_dir": out} if driver == "voronoi_calc" else {}
    fn = getattr(voronoi_driver, driver)
    times = []
    for _ in range(2 if engine == "device" else 1):
        t0 = time.perf_counter()
        fn(top, traj, engine=engine, **kw)
        times.append(time.perf_counter() - t0)
    return times


def voronoi_engines():
    rows = []
    for driver, nw, nf in VORONOI_RUNS:
        for engine in ("host", "device"):
            cmd = [sys.executable, os.path.abspath(__file__), "--voronoi-child",
                   driver, str(nw), str(nf), engine]
            t0 = time.perf_counter()
            try:
                out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
                times = json.loads(out.stdout.strip().splitlines()[-1])
                row = {"first_s": times[0], "second_s": times[-1]}
            except (subprocess.TimeoutExpired, ValueError, IndexError) as e:
                row = {"error": f"{type(e).__name__}: {str(e)[-300:]}"}
            row.update(driver=driver, points=nw + 5, frames=nf, engine=engine,
                       process_s=time.perf_counter() - t0)
            print(json.dumps(row), flush=True)
            rows.append(row)
    ok = all("error" not in r for r in rows)
    print(json.dumps({"voronoi_engines": "ok" if ok else "failed"}))
    return 0 if ok else 1


def main():
    from waterorderlib_tpu.utils import compile_cache

    if sys.argv[1:2] == ["--voronoi-child"]:
        driver, nw, nf, engine = sys.argv[2:6]
        print(json.dumps(voronoi_child(driver, int(nw), int(nf), engine)))
        return 0

    try:
        import jax

        dev = jax.devices()[0]
    except Exception as e:  # no usable backend at all
        dev, detail = None, f"{type(e).__name__}: {e}"
    if dev is None or dev.platform != "gpu":
        if dev is not None:
            detail = f"backend is {dev.platform}, not gpu"
        print(json.dumps({"metric": METRIC, "value": None, "unit": UNIT,
                          "error": "no_gpu_backend", "detail": detail[:500]}))
        return 1
    if sys.argv[1:2] == ["--voronoi-engines"]:
        return voronoi_engines()
    compile_cache.enable()
    fps, spread, impl = headline()
    result = {
        "metric": METRIC,
        "value": fps,
        "unit": UNIT,
        "vs_baseline": fps / measure_baseline(),
        "spread_pct": 100 * spread,
        "impl": impl,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if os.environ.get("BENCH_BREAKDOWN", "1") != "0":
        result["breakdown"] = breakdown()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
