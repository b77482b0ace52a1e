"""Hard-sphere insertion chemical potential driver.

JAX replacement for `chemPotCalc`
(/root/reference/structureLibs/orderParam_lib.py:1666-1791): random probe
insertions per frame, count heavy atoms overlapping each probe within
`probeRadius`, histogram the overlap counts N, and report
mu = -ln P(N=0), <N>, <N^2>.

Two insertion modes, as in the reference:
- bulk (`keyword=False`): uniform insertions in the box (10,000/frame);
- shell (`keyword=True`): insertions uniform in a sphere of radius 4.2 A
  around a randomly chosen solute heavy atom (100,000/frame).

The reference's rejection-sampling `while` loop (ref :1720-1732) becomes a
fixed-shape oversample-and-rank: we draw ~2x the requested insertions
uniformly in the bounding cube and keep the FIRST `n_ins` that land inside
the sphere (a running accepted-count carried across sample blocks), which
reproduces both the uniform-in-sphere density AND the reference's exact
per-frame insertion count — shell-mode histogram totals equal
n_ins * n_frames, matching the published artifact semantics. (The chance of
fewer than n_ins acceptances in 2x oversampling is < 1e-80 at the default
n_ins = 1e5; sphere/cube acceptance is pi/6 = 0.524.) RNG is jax PRNG
(deterministic given `seed`) inside the same jitted scan as the overlap
counting, so nothing round-trips to host.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from waterorderlib_tpu.drivers.orderparams import _resolve_system
from waterorderlib_tpu.ops import pairs


def chem_pot_calc(
    top_file,
    traj_file,
    wat_res: str = "WAT",
    probe_radius: float = 3.3,
    keyword: bool = False,
    stride: int = 1,
    n_insertions: int | None = None,
    shell_cutoff: float = 4.2,
    max_overlap: int = 100,
    seed: int = 0,
    output_dir: str = ".",
    chunk_frames: int | None = None,
    mesh=None,
):
    """Returns (muHS, avgN, avgN2); writes HS-solute_overlap_hist[_Shell].txt.
    With `chunk_frames` the trajectory streams in chunks (io/streaming.py);
    per-frame PRNG keys are indexed by global frame, so chunked results
    bit-match the single-shot run. With `mesh` (parallel.mesh.make_mesh)
    frames shard over the whole device mesh as data parallelism (SURVEY
    §2c DP row) — insertions are frame-local, so the overlap histogram is a
    psum of per-shard histograms; padded frames carry weight 0 and the
    global-frame key indexing keeps sharded results bit-matching the
    single-device run."""
    if chunk_frames is not None:
        from waterorderlib_tpu.io.topology import Topology
        from waterorderlib_tpu.io.trajectory import load_topology

        top = top_file if isinstance(top_file, Topology) else load_topology(top_file)
        traj = None
    else:
        top, traj = _resolve_system(top_file, traj_file, stride)
    heavy_inds = top.get_heavy_inds()
    sol_inds, *_ = top.get_sol_inds(wat_res)
    if keyword and len(sol_inds) == 0:
        raise ValueError("shell-mode insertion requires a solute")
    n_ins = n_insertions if n_insertions is not None else (100000 if keyword else 10000)

    key = jax.random.PRNGKey(seed)

    ins_block = 2048  # insertions processed per device step

    @jax.jit
    def run(heavy_pos, boxes, frame_keys, sol_pos=None, frame_w=None):
        def one_frame(carry, frame):
            if sol_pos is None:
                hp, box, k, w = frame
                sp = None
            else:
                hp, box, k, w, sp = frame

            def one_block(carry2, kb):
                hist_acc, n_acc = carry2
                if keyword:
                    # uniform in the cube around a random solute heavy atom;
                    # keep the first n_ins samples inside the sphere
                    # (rejection resampling with fixed shapes)
                    k1, k2 = jax.random.split(kb)
                    delta = jax.random.uniform(
                        k1, (ins_block, 3), minval=-shell_cutoff, maxval=shell_cutoff
                    )
                    inside = jnp.sum(delta * delta, axis=1) <= shell_cutoff**2
                    rank = n_acc + jnp.cumsum(inside.astype(jnp.int32))
                    keep = inside & (rank <= n_ins)
                    which = jax.random.randint(k2, (ins_block,), 0, sp.shape[0])
                    probes = sp[which] + delta
                else:
                    probes = jax.random.uniform(kb, (ins_block, 3)) * box[None, :]
                    # cap the final partial block so exactly n_ins count
                    rank = n_acc + 1 + jnp.arange(ins_block, dtype=jnp.int32)
                    keep = rank <= n_ins
                n_over = pairs.neighbor_counts(
                    probes, hp, box, 0.0, probe_radius, row_block=ins_block
                )
                n_over = jnp.clip(n_over, 0, max_overlap - 1)
                hist = jnp.zeros(max_overlap, jnp.float32).at[n_over].add(
                    keep.astype(jnp.float32)
                )
                n_acc = n_acc + jnp.sum(keep.astype(jnp.int32))
                return (hist_acc + hist, n_acc), None

            # shell mode oversamples 2x so >= n_ins acceptances are
            # (overwhelmingly) available; bulk mode needs exactly n_ins draws
            n_target = 2 * n_ins if keyword else n_ins
            n_blocks = -(-n_target // ins_block)
            keys = jax.random.split(k, n_blocks)
            (hist, _), _ = jax.lax.scan(
                one_block, (jnp.zeros(max_overlap, jnp.float32), jnp.int32(0)), keys
            )
            return carry + w * hist, None

        w_all = frame_w if frame_w is not None else jnp.ones(
            heavy_pos.shape[0], jnp.float32
        )
        xs = (heavy_pos, boxes, frame_keys, w_all) if sol_pos is None else (
            heavy_pos, boxes, frame_keys, w_all, sol_pos
        )
        return jax.lax.scan(one_frame, jnp.zeros(max_overlap, jnp.float32), xs)[0]

    if mesh is not None:
        from functools import partial as _partial

        from jax import shard_map
        from jax.sharding import PartitionSpec as _P

        run_local = run

        @jax.jit
        def run_sharded(heavy_pos, boxes, frame_keys, frame_w, sol_pos=None):
            def local(hp, bx, fk, w, *sp):
                hist = run_local(hp, bx, fk, sp[0] if sp else None, w)
                return jax.lax.psum(hist, ("frames", "atoms"))

            fspec = _P(("frames", "atoms"))
            in_specs = [
                _P(("frames", "atoms"), None, None),
                _P(("frames", "atoms"), None),
                fspec, fspec,
            ]
            args = [heavy_pos, boxes, frame_keys, frame_w]
            if sol_pos is not None:
                in_specs.append(_P(("frames", "atoms"), None, None))
                args.append(sol_pos)
            return shard_map(
                local, mesh=mesh, in_specs=tuple(in_specs), out_specs=_P(),
                check_vma=False,
            )(*args)

        def run(heavy_pos, boxes, frame_keys, sol_pos=None, frame_w=None):  # noqa: F811
            f = heavy_pos.shape[0]
            n_dev = mesh.devices.size
            pad_f = (-f) % n_dev
            w = jnp.ones(f, jnp.float32) if frame_w is None else frame_w
            if pad_f:
                rep = lambda x: jnp.concatenate(
                    [x, jnp.repeat(x[-1:], pad_f, axis=0)], axis=0
                )
                heavy_pos, boxes, frame_keys = rep(heavy_pos), rep(boxes), rep(frame_keys)
                if sol_pos is not None:
                    sol_pos = rep(sol_pos)
                w = jnp.concatenate([w, jnp.zeros(pad_f, jnp.float32)])
            return run_sharded(heavy_pos, boxes, frame_keys, w, sol_pos)

    if chunk_frames is not None:
        from waterorderlib_tpu.io.streaming import iter_chunks

        counts = np.zeros(max_overlap, np.float64)
        frame0 = 0
        for pos_c, boxes_c in iter_chunks(traj_file, chunk_frames, stride, n_atoms=top.n_atoms):
            fc = pos_c.shape[0]
            # keys indexed by GLOBAL frame position for chunked bit-parity
            keys_c = jax.vmap(
                lambda i: jax.random.fold_in(key, i)
            )(jnp.arange(frame0, frame0 + fc))
            hp = jnp.asarray(pos_c[:, heavy_inds, :])
            bx = jnp.asarray(boxes_c)
            sp = jnp.asarray(pos_c[:, sol_inds, :]) if keyword else None
            counts += np.asarray(
                run(hp, bx, keys_c, sp) if keyword else run(hp, bx, keys_c)
            ).astype(np.float64)
            frame0 += fc
    else:
        heavy_pos = jnp.asarray(traj.positions[:, heavy_inds, :])
        boxes = jnp.asarray(traj.boxes)
        sol_pos = jnp.asarray(traj.positions[:, sol_inds, :]) if len(sol_inds) else None
        frame_keys = jax.vmap(
            lambda i: jax.random.fold_in(key, i)
        )(jnp.arange(traj.n_frames))
        counts = np.asarray(
            run(heavy_pos, boxes, frame_keys, sol_pos) if keyword
            else run(heavy_pos, boxes, frame_keys)
        ).astype(np.float64)

    num = np.arange(max_overlap, dtype=np.float64)
    total = counts.sum()
    mu_hs = -np.log(counts[0] / total) if counts[0] > 0 else np.inf
    avg_n = float(np.dot(num, counts) / total)
    avg_n2 = float(np.dot(num**2, counts) / total)

    fname = "HS-solute_overlap_hist_Shell.txt" if keyword else "HS-solute_overlap_hist.txt"
    np.savetxt(
        os.path.join(output_dir, fname),
        np.vstack((num, counts)).T,
        header="Number of non-solute atoms overlapping           Histogram count",
    )
    return float(mu_hs), avg_n, avg_n2
