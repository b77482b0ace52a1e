"""Trajectory-level order-parameter drivers.

JAX replacements for the reference workflow drivers
`tetOrderCalc` (/root/reference/structureLibs/orderParam_lib.py:1426-1503),
`threeBodyCalc` (:1269-1424), `lsiCalc` (:1586-1663) and `hexOrderCalc`
(:1505-1584).

Design change vs the reference: instead of a serial Python frame loop
calling f2py per water, the whole trajectory is moved to device once as an
(F, Nw, 3) tensor and a single jitted `lax.scan` over frames computes the
per-frame statistics and accumulates the value histograms. Sub-populations
(e.g. bound/wrap waters from getBoundWrap) are fixed-shape boolean masks
over the water axis instead of ragged index lists; the per-center order
parameters are computed once for all waters and population statistics are
masked reductions (bitwise identical to the reference's recompute-per-subset
approach, because each center's value is independent of the subset).

Every driver writes the same text artifacts as the reference
(`qDistribution_j.txt`, `3bDistribution_j.txt`, `lsiDistribution_j.txt`,
`psiDistribution_j.txt`) into `output_dir` and returns [mean, CI] pairs from
the same 20-block bootstrap.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from waterorderlib_tpu.io.trajectory import load_system, Trajectory
from waterorderlib_tpu.io.topology import Topology
from waterorderlib_tpu.ops import backend, histograms, pairs
from waterorderlib_tpu.order import angles as angles_mod
from waterorderlib_tpu.order import lsi as lsi_mod
from waterorderlib_tpu.order import psi6 as psi6_mod
from waterorderlib_tpu.order import qtet
from waterorderlib_tpu.stats import blocks
from waterorderlib_tpu.utils import logging as _logging_mod
from waterorderlib_tpu.utils.logging import get_logger


# ---------------------------------------------------------------------------
# shared machinery
# ---------------------------------------------------------------------------

# shared once-per-key seen-set (utils.logging); aliased so tests can
# clear/inspect which (driver, tier) pairs served calls this process
_logged_tiers: set = _logging_mod._LOGGED_ONCE


def _log_tier(driver: str, tier: str) -> None:
    """Record (once per driver+tier) which implementation served a driver
    call, so a change of path is visible in the logs."""
    _logging_mod.log_once((driver, tier), "%s: serving tier=%s", driver, tier)


def _resolve_system(top_file, traj_file, stride):
    """Accept either file paths or in-memory (Topology, Trajectory)."""
    if isinstance(top_file, Topology):
        top = top_file
        traj = traj_file if stride == 1 else traj_file.strided(stride)
    else:
        top, traj = load_system(top_file, traj_file, stride=stride)
    if traj is not None and traj.n_atoms != top.n_atoms:
        raise ValueError(
            f"topology has {top.n_atoms} atoms but trajectory frames have "
            f"{traj.n_atoms} — mismatched system files"
        )
    return top, traj


def pop_masks_from_subinds(
    sub_inds, n_frames: int, n_pops: int, row_of_atom: np.ndarray, n_rows: int
) -> np.ndarray:
    """Convert the reference's ragged per-frame population index lists
    ([[pop0_inds, pop1_inds, ...]_t, ...], global atom indices) into a dense
    (F, P, n_rows) boolean mask over center rows."""
    masks = np.zeros((n_frames, n_pops, n_rows), dtype=bool)
    if sub_inds is None:
        return masks
    for t in range(n_frames):
        for p in range(n_pops):
            rows = row_of_atom[np.asarray(sub_inds[t][p], dtype=int)]
            if np.any(rows < 0):
                raise ValueError("population index is not a center atom")
            masks[t, p, rows] = True
    return masks


def _row_of_atom(center_inds: np.ndarray, n_atoms: int) -> np.ndarray:
    out = np.full(n_atoms, -1, dtype=np.int64)
    out[center_inds] = np.arange(len(center_inds))
    return out


def _scan_frames(step_fn, hist_init, pos, boxes, masks):
    """jitted scan over frames: step_fn(hist, (pos_f, box_f, mask_f)) ->
    (hist', per_frame_stats). Returns (hist_total, stacked stats)."""

    @jax.jit
    def run(pos, boxes, masks):
        return jax.lax.scan(step_fn, hist_init, (pos, boxes, masks))

    return run(pos, boxes, masks)


def _save_hist(path: str, hist: np.ndarray, n_bins: int, lo: float, hi: float, header: str):
    centers = histograms.bin_centers(n_bins, lo, hi)
    np.savetxt(path, np.stack([centers, hist], axis=1), header=header, fmt="%.3e")


def _mean_ci_rows(per_frame: np.ndarray, seed):
    """per_frame: (F, P+1) -> ([mean_j], [CI_j]) as the reference returns."""
    means = np.nanmean(per_frame, axis=0)
    cis = np.array(
        [blocks.block_average(per_frame[:, j], seed=seed) for j in range(per_frame.shape[1])]
    )
    return [means, cis]


# ---------------------------------------------------------------------------
# tetOrderCalc
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("n_bins",))
def _q_pop_stats(q_all, masks, n_bins, lo, hi):
    """Masked population statistics over precomputed q values: returns
    (hist (P+1, n_bins), (means (F, P+1), vars (F, P+1))). Module-level jit
    so chunked drivers reuse the compiled stats across chunks."""

    def per_frame(q, mask):
        mean, var = histograms.masked_mean_var(q[None, :], mask)
        h = jax.vmap(lambda m: histograms.masked_histogram(q, m, n_bins, lo, hi))(mask)
        return mean, var, h

    means, vars_, hists = jax.vmap(per_frame)(q_all, masks)
    return jnp.sum(hists, axis=0), (means, vars_)


def _tet_core(wat_pos, boxes, masks, low_cut, high_cut, row_block, n_bins, lo, hi,
              mesh=None):
    """q + population statistics for one frame batch: returns
    (hist (P+1, n_bins), (means (F, P+1), vars (F, P+1)))."""
    if mesh is not None:
        # device-mesh scale-out (SURVEY §2c): frames data-parallel, atoms
        # tensor-parallel; arbitrary F/N via the NaN-padding wrapper
        from waterorderlib_tpu.parallel import mesh as pmesh

        q_all, _, _ = pmesh.sharded_q_analysis_padded(
            wat_pos, boxes, mesh, low_cut, high_cut, n_bins=n_bins
        )
        return _q_pop_stats(q_all, masks, n_bins, lo, hi)
    # q for all waters of every frame, then populations as masked
    # reductions over the same values (identical by construction — q per
    # center is subset-independent). On a GPU the windowed neighbour kernel
    # serves q; elsewhere the blocked all-pairs XLA path does.
    if backend.is_gpu():
        q_all, tier = qtet.order_param_q_certified(wat_pos, boxes, low_cut, high_cut)
    else:
        q_all = qtet.order_param_q_traj(wat_pos, boxes, low_cut, high_cut, row_block)
        tier = "xla"
    _log_tier("tet_order_calc", tier)
    return _q_pop_stats(q_all, masks, n_bins, lo, hi)


def tet_order_calc(
    top_file,
    traj_file,
    sub_inds=None,
    n_pops: int = 0,
    wat_res: str = "WAT",
    stride: int = 1,
    low_cut: float = 0.0,
    high_cut: float = 10.0,
    output_dir: str = ".",
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
    seed: int | None = 0,
    chunk_frames: int | None = None,
    checkpoint: str | None = None,
    mesh=None,
):
    """Tetrahedral order parameter driver (orderParam_lib.py:1426-1503).

    Returns (avgQ, varQ): each [means (P+1,), CIs (P+1,)] where slot 0 is the
    all-water population. Writes qDistribution_j.txt per population.

    With `chunk_frames` set, the trajectory streams through the device in
    chunks of that many frames (double-buffered host prefetch,
    io/streaming.py) — larger-than-memory trajectories match the
    single-shot results (histogram counts exactly, float statistics to
    ~1 ulp: every per-frame quantity is frame-local, but XLA may tile
    reductions differently per compile shape).
    With `mesh` (a jax.sharding Mesh from parallel.mesh.make_mesh) the q
    computation shards over the ('frames', 'atoms') device mesh; the two
    options compose (each streamed chunk is mesh-sharded).
    """
    n_bins, lo, hi = 500, 0.0, 1.0
    if chunk_frames is not None:
        hist, (avg_q, var_q) = _run_chunked(
            top_file, traj_file, sub_inds, n_pops, wat_res, stride, chunk_frames,
            lambda wp, b, m: _tet_core(
                wp, b, m, low_cut, high_cut, row_block, n_bins, lo, hi, mesh=mesh
            ),
            n_carry=1, n_stats=2, checkpoint=checkpoint,
            fp_params=("tet", low_cut, high_cut),
        )
        for j in range(n_pops + 1):
            _save_hist(
                os.path.join(output_dir, f"qDistribution_{j}.txt"),
                hist[j], n_bins, lo, hi, "qVal    frequency",
            )
        return _mean_ci_rows(avg_q, seed), _mean_ci_rows(var_q, seed)

    top, traj = _resolve_system(top_file, traj_file, stride)
    wat_inds, _, _ = top.get_wat_inds(wat_res)
    F = traj.n_frames
    nw = len(wat_inds)
    wat_pos = jnp.asarray(traj.positions[:, wat_inds, :])
    boxes = jnp.asarray(traj.boxes)
    row_map = _row_of_atom(wat_inds, top.n_atoms)
    pops = pop_masks_from_subinds(sub_inds, F, n_pops, row_map, nw)
    all_mask = np.ones((F, 1, nw), dtype=bool)
    masks = jnp.asarray(np.concatenate([all_mask, pops], axis=1))  # (F, P+1, Nw)

    hist, (avg_q, var_q) = _tet_core(
        wat_pos, boxes, masks, low_cut, high_cut, row_block, n_bins, lo, hi,
        mesh=mesh,
    )
    hist = np.asarray(hist)
    for j in range(n_pops + 1):
        _save_hist(
            os.path.join(output_dir, f"qDistribution_{j}.txt"),
            hist[j], n_bins, lo, hi, "qVal    frequency",
        )
    return _mean_ci_rows(np.asarray(avg_q), seed), _mean_ci_rows(np.asarray(var_q), seed)


# ---------------------------------------------------------------------------
# threeBodyCalc
# ---------------------------------------------------------------------------

def _three_body_core(
    wat_pos, boxes, masks, low_cut, high_cut, max_neighbors, row_block,
    n_bins, lo, hi, n2x, mesh=None,
):
    """3-body angles + metrics for one frame batch: returns
    ((hist (P+1, n_bins), hist2d (n2x*n_bins,)),
     (frac, avg, var, ent, n_wats) each (F, P+1))."""
    if mesh is not None:
        # device-mesh scale-out (SURVEY §2c): frames data-parallel, center
        # rows atom-parallel, per-frame stats psum-reduced over atoms
        from waterorderlib_tpu.parallel import mesh as pmesh

        return pmesh.sharded_three_body_analysis(
            wat_pos, boxes, masks, mesh, low_cut, high_cut, k=max_neighbors,
            n_bins=n_bins, lo=lo, hi=hi, n2x=n2x, row_block=row_block,
        )

    def per_pop_metrics(aset, center_mask):
        valid = aset.valid & center_mask[:, None, None]
        sub = angles_mod.AngleSet(aset.ang, valid, aset.count)
        m = angles_mod.tetrahedral_metrics(sub, n_bins=n_bins, lo=lo, hi=hi)
        return m.hist, m.frac_tet, m.avg_cos, m.var_cos, m.entropy

    def step(carry, frame):
        hist, hist2d = carry
        pos, box, mask = frame
        aset = angles_mod.neighbor_angles(
            pos, pos, box, low_cut, high_cut, k=max_neighbors, row_block=row_block
        )
        h, frac, avg, var, ent = jax.vmap(lambda m: per_pop_metrics(aset, m))(mask)
        n_wats = jnp.sum(mask, axis=-1).astype(jnp.float32)
        # 2-D histogram: per valid angle, x = center's neighbor count - 1
        cc = jnp.clip(aset.count - 1, 0, n2x - 1)
        cc2 = jnp.broadcast_to(cc[:, None, None], aset.ang.shape)
        flat_bin = cc2.astype(jnp.int32) * (n_bins) + jnp.clip(
            jnp.floor(aset.ang / (hi / n_bins)).astype(jnp.int32), 0, n_bins - 1
        )
        okf = aset.valid.reshape(-1)
        h2 = jnp.zeros(n2x * n_bins, jnp.float32).at[
            jnp.where(okf, flat_bin.reshape(-1), 0)
        ].add(okf.astype(jnp.float32))
        return (hist + h, hist2d + h2), (frac, avg, var, ent, n_wats)

    carry0 = (
        jnp.zeros((masks.shape[1], n_bins), jnp.float32),
        jnp.zeros(n2x * n_bins, jnp.float32),
    )
    return _scan_frames(step, carry0, wat_pos, boxes, masks)


def three_body_calc(
    top_file,
    traj_file,
    sub_inds=None,
    n_pops: int = 0,
    wat_res: str = "WAT",
    n_bins: int = 500,
    stride: int = 1,
    low_cut: float = 0.0,
    high_cut: float = 3.413,
    max_neighbors: int = 16,
    output_dir: str = ".",
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
    seed: int | None = 0,
    output_2d: bool = False,
    chunk_frames: int | None = None,
    mesh=None,
):
    """Three-body angle distribution driver (orderParam_lib.py:1269-1424).

    Returns (pTet, avgCos, varCos, entropy, nWats), each [means, CIs] over
    populations (slot 0 = all waters). Writes 3bDistribution_j.txt, and with
    output_2d also the (theta, coordination) 2-D histogram PNG + txt.
    With `chunk_frames` the trajectory streams in chunks (io/streaming.py);
    with `mesh` (parallel.mesh.make_mesh) each batch shards over the
    ('frames', 'atoms') device mesh — the two options compose.
    """
    lo, hi = 0.0, 180.0
    # 2-D (coordination, angle) histogram, xedges=arange(-1.5,13.5) (ref :1390)
    n2x = 14

    def core(wat_pos, boxes, masks):
        return _three_body_core(
            wat_pos, boxes, masks, low_cut, high_cut, max_neighbors,
            row_block, n_bins, lo, hi, n2x, mesh=mesh,
        )

    if chunk_frames is not None:
        (hist, hist2d), stats = _run_chunked(
            top_file, traj_file, sub_inds, n_pops, wat_res, stride,
            chunk_frames, core, n_carry=2, n_stats=5,
        )
        frac, avg, var, ent, n_wats = stats
    else:
        top, traj = _resolve_system(top_file, traj_file, stride)
        wat_inds, _, _ = top.get_wat_inds(wat_res)
        F = traj.n_frames
        nw = len(wat_inds)
        wat_pos = jnp.asarray(traj.positions[:, wat_inds, :])
        boxes = jnp.asarray(traj.boxes)
        row_map = _row_of_atom(wat_inds, top.n_atoms)
        pops = pop_masks_from_subinds(sub_inds, F, n_pops, row_map, nw)
        masks = jnp.asarray(
            np.concatenate([np.ones((F, 1, nw), bool), pops], axis=1)
        )
        (hist, hist2d), (frac, avg, var, ent, n_wats) = core(wat_pos, boxes, masks)
    return _three_body_outputs(
        hist, hist2d, frac, avg, var, ent, n_wats,
        n_pops, n_bins, lo, hi, n2x, output_dir, output_2d, seed,
    )


def _run_chunked(
    top_file, traj_file, sub_inds, n_pops, wat_res, stride, chunk_frames,
    core, n_carry, n_stats, checkpoint: str | None = None,
    fp_params: tuple = (), center_select=None,
):
    """Stream a trajectory through `core(wat_pos, boxes, masks)` in chunks.

    core returns (carry_tuple_or_array, stats_tuple_or_array); carried
    histograms are summed across chunks, per-frame statistics concatenated.
    Bit-matches the single-shot path (every per-frame quantity is
    frame-local). Implements SURVEY §2c's PP-analog: the next chunk decodes
    on a prefetch thread while the device computes the current one.

    With `checkpoint` set (an .npz path), partial results are written after
    every chunk and an interrupted scan resumes from the last completed
    chunk — elastic recovery for long production trajectories (SURVEY §5).
    The checkpoint is fingerprinted by (chunk_frames, stride, n_pops, nw)
    PLUS the trajectory's identity (path, size, mtime) and the caller's
    analysis parameters (`fp_params`), so a stale checkpoint from a
    different trajectory or parameter set is discarded, not resumed into
    mixed results. Removed on successful completion.

    `center_select(top) -> index array` overrides the default water-oxygen
    center selection (e.g. hexOrderCalc's every-other chain-end rule).
    """
    import hashlib

    from waterorderlib_tpu.io.streaming import iter_chunks
    from waterorderlib_tpu.io.trajectory import load_topology

    top = top_file if isinstance(top_file, Topology) else load_topology(top_file)
    if center_select is not None:
        wat_inds = np.asarray(center_select(top))
    else:
        wat_inds, _, _ = top.get_wat_inds(wat_res)
    nw = len(wat_inds)
    row_map = _row_of_atom(wat_inds, top.n_atoms)
    from time import monotonic as _monotonic

    carry_acc = None
    stats_parts = []
    frame0 = 0
    resume_from = 0
    last_ck = -1.0e18  # first chunk always checkpoints
    if isinstance(traj_file, (str, os.PathLike)):
        p = os.fspath(traj_file)
        try:
            st = os.stat(p)
            traj_id = f"{p}:{st.st_size}:{int(st.st_mtime)}"
        except OSError:
            traj_id = p
    elif isinstance(traj_file, Trajectory):
        # strided coordinate sample (not just the endpoints, which would
        # wrongly resume after a mid-trajectory edit): <= 16 frames x 8 atoms
        tp = np.asarray(traj_file.positions)
        sample = np.ascontiguousarray(
            tp[:: max(1, tp.shape[0] // 16), :: max(1, tp.shape[1] // 8)]
        )
        traj_id = (
            f"mem:{traj_file.n_frames}:{traj_file.n_atoms}:"
            f"{hashlib.sha256(sample.tobytes()).hexdigest()[:32]}"
        )
    else:
        traj_id = repr(type(traj_file))
    h = hashlib.sha256(repr((traj_id, tuple(fp_params), wat_res)).encode())
    if sub_inds is not None:  # population assignments shape the carry too
        for frame_pops in sub_inds:
            for pop in frame_pops:
                h.update(np.asarray(pop, np.int64).tobytes())
            h.update(b"|")
    sig = h.digest()[:8]
    fp = np.concatenate(
        [np.array([chunk_frames, stride, n_pops, nw], np.int64),
         np.frombuffer(sig, np.int64)]
    )
    if checkpoint and os.path.exists(checkpoint):
        with np.load(checkpoint, allow_pickle=False) as ck:
            if np.array_equal(ck["fingerprint"], fp):
                resume_from = int(ck["frames_done"])
                carry_acc = [ck[f"carry_{i}"] for i in range(int(ck["n_carry"]))]
                stats_parts = [
                    [ck[f"stats_{c}_{i}"] for i in range(n_stats)]
                    for c in range(int(ck["n_chunks"]))
                ]
    for pos_c, boxes_c in iter_chunks(traj_file, chunk_frames, stride, n_atoms=top.n_atoms):
        fc = pos_c.shape[0]
        if frame0 + fc <= resume_from:
            frame0 += fc
            continue  # chunk already in the checkpoint
        sub_c = sub_inds[frame0 : frame0 + fc] if sub_inds is not None else None
        pops = pop_masks_from_subinds(sub_c, fc, n_pops, row_map, nw)
        masks_c = jnp.asarray(
            np.concatenate([np.ones((fc, 1, nw), bool), pops], axis=1)
        )
        carry, stats = core(jnp.asarray(pos_c[:, wat_inds, :]), jnp.asarray(boxes_c), masks_c)
        carry = [np.asarray(c) for c in (carry if isinstance(carry, (tuple, list)) else (carry,))]
        stats = [np.asarray(s) for s in (stats if isinstance(stats, (tuple, list)) else (stats,))]
        carry_acc = carry if carry_acc is None else [a + c for a, c in zip(carry_acc, carry)]
        stats_parts.append(stats)
        frame0 += fc
        # each write re-serializes the full accumulated state, so per-chunk
        # writes would cost O(n_chunks^2) I/O over a long scan; throttle to
        # one write per 10 s (an interruption loses at most that much work)
        now = _monotonic()
        if checkpoint and now - last_ck > 10.0:
            last_ck = now
            payload = {
                "fingerprint": fp,
                "frames_done": np.array(frame0),
                "n_carry": np.array(len(carry_acc)),
                "n_chunks": np.array(len(stats_parts)),
            }
            payload.update({f"carry_{i}": c for i, c in enumerate(carry_acc)})
            for c, part in enumerate(stats_parts):
                payload.update({f"stats_{c}_{i}": s for i, s in enumerate(part)})
            tmp = checkpoint + ".tmp.npz"  # np.savez appends .npz itself
            np.savez(checkpoint + ".tmp", **payload)
            os.replace(tmp, checkpoint)
    if checkpoint and os.path.exists(checkpoint):
        os.remove(checkpoint)
    stats_cat = [
        np.concatenate([p[i] for p in stats_parts], axis=0) for i in range(n_stats)
    ]
    if n_carry == 1:
        return carry_acc[0], (stats_cat if n_stats > 1 else stats_cat[0])
    return tuple(carry_acc), (stats_cat if n_stats > 1 else stats_cat[0])


def _three_body_outputs(
    hist, hist2d, frac, avg, var, ent, n_wats,
    n_pops, n_bins, lo, hi, n2x, output_dir, output_2d, seed,
):
    """Shared artifact writing + statistics tail of three_body_calc."""
    hist = np.asarray(hist)
    for j in range(n_pops + 1):
        _save_hist(
            os.path.join(output_dir, f"3bDistribution_{j}.txt"),
            hist[j], n_bins, lo, hi, "3-body angle (deg)    frequency",
        )
    if output_2d:
        h2 = np.asarray(hist2d).reshape(n2x, n_bins)
        h2 = h2 / max(h2.sum(), 1.0)
        np.savetxt(
            os.path.join(output_dir, "3bDistribution_2D.txt"), h2,
            header="rows: coordination number N_c (0..13); cols: angle bins over [0,180)",
            fmt="%.3e",
        )
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(4, 4))
            ax.imshow(
                h2, interpolation="gaussian", cmap="viridis", aspect="auto",
                origin="lower", extent=(0, 180, 0, n2x),
            )
            ax.set_xlabel(r"$\theta$ [deg]")
            ax.set_ylabel(r"$N_c$")
            fig.savefig(os.path.join(output_dir, "3bDistribution_2D.png"), dpi=120)
            plt.close(fig)
        except Exception as e:  # plotting is best-effort, but never silent
            get_logger().warning("three_body_calc: 2-D PNG skipped (%r)", e)
    s = seed
    return (
        _mean_ci_rows(np.asarray(frac), s),
        _mean_ci_rows(np.asarray(avg), s),
        _mean_ci_rows(np.asarray(var), s),
        _mean_ci_rows(np.asarray(ent), s),
        _mean_ci_rows(np.asarray(n_wats), s),
    )


# ---------------------------------------------------------------------------
# lsiCalc
# ---------------------------------------------------------------------------

def _lsi_core(wat_pos, boxes, masks, low_cut, high_cut, max_neighbors, row_block,
              n_bins, lo, hi, mesh=None):
    """LSI + population statistics for one frame batch: returns
    (hist (P+1, n_bins), (means (F, P+1), vars (F, P+1)))."""
    if mesh is not None:
        from waterorderlib_tpu.parallel import mesh as pmesh

        return pmesh.sharded_lsi_analysis(
            wat_pos, boxes, masks, mesh, low_cut, high_cut, k=max_neighbors,
            n_bins=n_bins, lo=lo, hi=hi, row_block=row_block,
        )
    def step(hist, frame):
        pos, box, mask = frame
        res = lsi_mod.lsi(pos, pos, box, low_cut, high_cut, k=max_neighbors, row_block=row_block)
        pop_valid = mask & res.valid[None, :]
        mean, var = histograms.masked_mean_var(res.lsi[None, :], pop_valid)
        h = jax.vmap(lambda m: histograms.masked_histogram(res.lsi, m, n_bins, lo, hi))(pop_valid)
        return hist + h, (mean, var)

    return _scan_frames(
        step, jnp.zeros((masks.shape[1], n_bins), jnp.float32), wat_pos, boxes, masks
    )


def lsi_calc(
    top_file,
    traj_file,
    sub_inds=None,
    n_pops: int = 0,
    wat_res: str = "WAT",
    stride: int = 1,
    low_cut: float = 0.0,
    high_cut: float = 3.7,
    max_neighbors: int = 24,  # >= any realistic shell occupancy
    output_dir: str = ".",
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
    seed: int | None = 0,
    chunk_frames: int | None = None,
    mesh=None,
):
    """LSI driver (orderParam_lib.py:1586-1663). Returns (avgLSI, varLSI);
    writes lsiDistribution_j.txt per population (500 bins over [0, 0.3]).
    With `chunk_frames` the trajectory streams in chunks (io/streaming.py);
    with `mesh` each batch shards over the ('frames', 'atoms') device mesh.

    NOTE: `max_neighbors` defaults to 24 — earlier releases used 16. This
    can shift the next-shell argmin on rare edge cases where the 17th-24th
    candidates matter; pass max_neighbors=16 for bit-compatibility with old
    results."""
    n_bins, lo, hi = 500, 0.0, 0.3
    if chunk_frames is not None:
        hist, (avg_lsi, var_lsi) = _run_chunked(
            top_file, traj_file, sub_inds, n_pops, wat_res, stride, chunk_frames,
            lambda wp, b, m: _lsi_core(
                wp, b, m, low_cut, high_cut, max_neighbors, row_block, n_bins, lo, hi,
                mesh=mesh,
            ),
            n_carry=1, n_stats=2,
        )
        hist = np.asarray(hist)
        for j in range(n_pops + 1):
            _save_hist(
                os.path.join(output_dir, f"lsiDistribution_{j}.txt"),
                hist[j], n_bins, lo, hi, "lsiVal [A^2]    frequency",
            )
        return _mean_ci_rows(np.asarray(avg_lsi), seed), _mean_ci_rows(np.asarray(var_lsi), seed)

    top, traj = _resolve_system(top_file, traj_file, stride)
    wat_inds, _, _ = top.get_wat_inds(wat_res)
    F = traj.n_frames
    nw = len(wat_inds)
    wat_pos = jnp.asarray(traj.positions[:, wat_inds, :])
    boxes = jnp.asarray(traj.boxes)
    row_map = _row_of_atom(wat_inds, top.n_atoms)
    pops = pop_masks_from_subinds(sub_inds, F, n_pops, row_map, nw)
    all_mask = np.ones((F, 1, nw), dtype=bool)
    masks = jnp.asarray(np.concatenate([all_mask, pops], axis=1))

    hist, (avg_lsi, var_lsi) = _lsi_core(
        wat_pos, boxes, masks, low_cut, high_cut, max_neighbors, row_block,
        n_bins, lo, hi, mesh=mesh,
    )
    hist = np.asarray(hist)
    for j in range(n_pops + 1):
        _save_hist(
            os.path.join(output_dir, f"lsiDistribution_{j}.txt"),
            hist[j], n_bins, lo, hi, "lsiVal [A^2]    frequency",
        )
    return _mean_ci_rows(np.asarray(avg_lsi), seed), _mean_ci_rows(np.asarray(var_lsi), seed)


# ---------------------------------------------------------------------------
# hexOrderCalc
# ---------------------------------------------------------------------------

def _psi_core(end_pos, boxes, masks, low_cut, high_cut, max_neighbors, row_block,
              n_bins, lo, hi, mesh=None):
    """psi-6 + population statistics for one frame batch: returns
    (hist (P+1, n_bins), (means (F, P+1), vars (F, P+1)))."""
    if mesh is not None:
        from waterorderlib_tpu.parallel import mesh as pmesh

        return pmesh.sharded_psi6_analysis(
            end_pos, boxes, masks, mesh, low_cut, high_cut, k=max_neighbors,
            n_bins=n_bins, lo=lo, hi=hi, row_block=row_block,
        )
    def step(hist, frame):
        pos, box, mask = frame
        psi = psi6_mod.order_param_psi(
            pos, pos, box, low_cut, high_cut, k=max_neighbors, row_block=row_block
        )
        mean, var = histograms.masked_mean_var(psi[None, :], mask)
        h = jax.vmap(lambda m: histograms.masked_histogram(psi, m, n_bins, lo, hi))(mask)
        return hist + h, (mean, var)

    n_pops1 = masks.shape[1]
    return _scan_frames(
        step, jnp.zeros((n_pops1, n_bins), jnp.float32), end_pos, boxes, masks
    )


def hex_order_calc(
    top_file,
    traj_file,
    sub_inds=None,
    n_pops: int = 0,
    end_res: str = "WAT",
    stride: int = 1,
    low_cut: float = 0.0,
    high_cut: float = 7.0,
    max_neighbors: int = 24,
    output_dir: str = ".",
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
    seed: int | None = 0,
    chunk_frames: int | None = None,
    mesh=None,
):
    """psi-6 hexagonal order driver (orderParam_lib.py:1505-1584).

    Chain-end centers are every other "water" heavy index
    (endInds = watInds[1::2], ref :1527). Returns (avgPsi, varPsi); writes
    psiDistribution_j.txt per population. With `chunk_frames` the
    trajectory streams in chunks (io/streaming.py); with `mesh` the psi
    computation shards over the ('frames', 'atoms') device mesh.
    """
    n_bins, lo, hi = 500, 0.0, 1.0
    core = lambda ep, b, m: _psi_core(  # noqa: E731 — shared by both paths
        ep, b, m, low_cut, high_cut, max_neighbors, row_block,
        n_bins, lo, hi, mesh=mesh,
    )
    if chunk_frames is not None:
        hist, (avg_psi, var_psi) = _run_chunked(
            top_file, traj_file, sub_inds, n_pops, end_res, stride, chunk_frames,
            core, n_carry=1, n_stats=2,
            fp_params=("psi", low_cut, high_cut, max_neighbors),
            center_select=lambda t: np.asarray(t.get_wat_inds(end_res)[0])[1::2],
        )
    else:
        top, traj = _resolve_system(top_file, traj_file, stride)
        end_inds, _, _ = top.get_wat_inds(end_res)
        end_inds = end_inds[1::2]
        F = traj.n_frames
        ne = len(end_inds)
        end_pos = jnp.asarray(traj.positions[:, end_inds, :])
        boxes = jnp.asarray(traj.boxes)
        row_map = _row_of_atom(end_inds, top.n_atoms)
        pops = pop_masks_from_subinds(sub_inds, F, n_pops, row_map, ne)
        all_mask = np.ones((F, 1, ne), dtype=bool)
        masks = jnp.asarray(np.concatenate([all_mask, pops], axis=1))
        hist, (avg_psi, var_psi) = core(end_pos, boxes, masks)

    hist = np.asarray(hist)
    for j in range(n_pops + 1):
        _save_hist(
            os.path.join(output_dir, f"psiDistribution_{j}.txt"),
            hist[j], n_bins, lo, hi, "psiVal    frequency",
        )
    return _mean_ci_rows(np.asarray(avg_psi), seed), _mean_ci_rows(np.asarray(var_psi), seed)
