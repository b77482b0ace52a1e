"""Device-mesh sharding for trajectory analysis.

The reference is single-process/single-thread (no MPI, no threading anywhere
in its tree — SURVEY.md §2c); device meshes replace that gap:

- **frames axis = data parallelism**: each device processes a slice of the
  trajectory; per-frame statistics stay local, global histograms are
  `psum`-reduced over the mesh.
- **atoms axis = tensor parallelism within a frame**: rows of the pairwise
  distance computation are sharded; each shard `all_gather`s the column
  atoms (over NVLink between cards) and computes its row block of
  neighbors/order params.

Everything is expressed with `jax.sharding.Mesh` + `shard_map`, so the same
code runs on one GPU, four GPUs of one host, or a spoofed 8-device CPU
mesh in tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from waterorderlib_tpu.ops import histograms
from waterorderlib_tpu.order import qtet
from waterorderlib_tpu.ops import pairs


def make_mesh(n_frame_shards: int, n_atom_shards: int, devices=None) -> Mesh:
    """2-D ('frames', 'atoms') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = n_frame_shards * n_atom_shards
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(n_frame_shards, n_atom_shards)
    return Mesh(dev, ("frames", "atoms"))


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Prefer 2-way atom sharding when the device count allows it."""
    if n_devices % 2 == 0 and n_devices >= 4:
        return n_devices // 2, 2
    return n_devices, 1


@partial(jax.jit, static_argnames=("mesh", "n_bins", "row_block"))
def _sharded_q_analysis_masked(
    pos: jnp.ndarray,
    boxes: jnp.ndarray,
    mask: jnp.ndarray,
    mesh: Mesh,
    low_cut: float,
    high_cut: float,
    n_bins: int,
    row_block: int,
):
    def local_step(pos_blk, box_blk, mask_blk):
        # pos_blk: (F_loc, N_loc, 3); gather the full atom axis for columns.
        pos_full = jax.lax.all_gather(pos_blk, "atoms", axis=1, tiled=True)

        def one_frame(args):
            rows, full, box = args
            return qtet.order_param_q(
                rows, full, box, low_cut, high_cut, row_block=min(row_block, rows.shape[0])
            )

        q_loc = jax.lax.map(one_frame, (pos_blk, pos_full, box_blk))  # (F_loc, N_loc)
        # per-frame mean over the valid atoms of the full atom axis
        n_valid = jax.lax.psum(jnp.sum(mask_blk, axis=-1), "atoms")
        q_sum = jax.lax.psum(jnp.sum(jnp.where(mask_blk, q_loc, 0.0), axis=-1), "atoms")
        mean_loc = q_sum / jnp.maximum(n_valid, 1)
        hist = histograms.masked_histogram(q_loc, mask_blk, n_bins, 0.0, 1.0)
        hist = jax.lax.psum(hist, ("frames", "atoms"))
        return q_loc, mean_loc, hist

    return shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("frames", "atoms", None), P("frames", None), P("frames", "atoms")),
        out_specs=(P("frames", "atoms"), P("frames"), P()),
        check_vma=False,
    )(pos, boxes, mask)


def sharded_q_analysis(
    pos: jnp.ndarray,
    boxes: jnp.ndarray,
    mesh: Mesh,
    low_cut: float = 0.0,
    high_cut: float = 10.0,
    n_bins: int = 500,
    row_block: int = 128,
    mask: jnp.ndarray | None = None,
):
    """Full q_tet analysis step over a ('frames', 'atoms') mesh.

    pos: (F, N, 3) with F divisible by the 'frames' axis size and N by the
    'atoms' axis size; boxes: (F, 3); mask: optional (F, N) bool of atoms to
    include in the mean/histogram (all True by default). For arbitrary F/N
    use :func:`sharded_q_analysis_padded`.

    Returns (q (F, N), mean_q (F,), hist (n_bins,)): per-water q values
    (sharded like pos), per-frame means, and the global q histogram over
    [0, 1] (psum-reduced across the whole mesh).
    """
    if mask is None:
        mask = jnp.ones(pos.shape[:2], bool)
    return _sharded_q_analysis_masked(
        pos, boxes, mask, mesh, low_cut, high_cut, n_bins, row_block
    )


def sharded_q_analysis_padded(
    pos: jnp.ndarray,
    boxes: jnp.ndarray,
    mesh: Mesh,
    low_cut: float = 0.0,
    high_cut: float = 10.0,
    n_bins: int = 500,
    row_block: int = 128,
):
    """`sharded_q_analysis` for F/N not divisible by the mesh axes.

    Frames are padded by repeating the last frame; atoms are padded with NaN
    positions, which the (low, high] shell mask excludes (NaN comparisons are
    false), so padding atoms are never neighbors of real atoms. A validity
    mask removes all padding from the mean and the global histogram, so the
    returned (q (F, N), mean_q (F,), hist) match the unpadded computation.
    """
    n = pos.shape[1]
    mask3 = jnp.ones((pos.shape[0], 1, n), bool)  # (F, 1, N) for _pad_for_mesh
    pos, boxes, mask3, f = _pad_for_mesh(pos, boxes, mask3, mesh)
    q, mean_q, hist = _sharded_q_analysis_masked(
        pos, boxes, mask3[:, 0, :], mesh, low_cut, high_cut, n_bins, row_block
    )
    return q[:f, :n], mean_q[:f], hist


# ---------------------------------------------------------------------------
# generic per-center value analyses (LSI, psi6): frames DP x atoms TP with
# per-frame per-population statistics psum-reduced over the atom axis
# ---------------------------------------------------------------------------

def _pad_for_mesh(pos, boxes, masks, mesh):
    """Pad (F, N, 3) positions / (F, P+1, N) masks to mesh-divisible sizes.

    Frames repeat the last frame with all-False masks (their stats rows are
    trimmed by the caller); atoms pad with NaN positions, which every shell
    test excludes (NaN comparisons are False), so padding atoms are never
    neighbors of real atoms and never centers of any population."""
    f, n = pos.shape[:2]
    df, da = mesh.devices.shape
    pad_f = (-f) % df
    pad_n = (-n) % da
    if pad_f:
        pos = jnp.concatenate([pos, jnp.repeat(pos[-1:], pad_f, axis=0)], axis=0)
        boxes = jnp.concatenate([boxes, jnp.repeat(boxes[-1:], pad_f, axis=0)], axis=0)
        masks = jnp.concatenate(
            [masks, jnp.zeros((pad_f,) + masks.shape[1:], bool)], axis=0
        )
    if pad_n:
        pos = jnp.concatenate(
            [pos, jnp.full((pos.shape[0], pad_n, 3), jnp.nan, pos.dtype)], axis=1
        )
        masks = jnp.concatenate(
            [masks, jnp.zeros(masks.shape[:2] + (pad_n,), bool)], axis=2
        )
    return pos, boxes, masks, f


def _moment_stats(n, s, s2):
    """(mean, population variance) from psum-reduced moments; NaN when the
    population is empty, matching histograms.masked_mean_var."""
    nf = jnp.maximum(n, 1).astype(s.dtype)
    mean = s / nf
    var = jnp.maximum(s2 / nf - mean * mean, 0.0)
    nan = jnp.float32(jnp.nan)
    return jnp.where(n > 0, mean, nan), jnp.where(n > 0, var, nan)


def _sharded_center_value_stats(pos, boxes, masks, mesh, value_fn, n_bins, lo, hi):
    """Shared engine: value_fn(rows, full_atoms, box) -> (value (Nloc,),
    valid (Nloc,)) per frame; returns (hist (P+1, n_bins) global,
    (means (F, P+1), vars (F, P+1)))."""

    def local(pos_blk, box_blk, mask_blk):
        # pos_blk (F_loc, N_loc, 3); mask_blk (F_loc, P+1, N_loc)
        pos_full = jax.lax.all_gather(pos_blk, "atoms", axis=1, tiled=True)

        def one_frame(args):
            rows, full, box = args
            return value_fn(rows, full, box)

        value, valid = jax.lax.map(one_frame, (pos_blk, pos_full, box_blk))

        pv = mask_blk & valid[:, None, :]  # (F_loc, P+1, N_loc)
        vb = value[:, None, :]
        n = jax.lax.psum(jnp.sum(pv, axis=-1), "atoms")
        s = jax.lax.psum(jnp.sum(jnp.where(pv, vb, 0.0), axis=-1), "atoms")
        s2 = jax.lax.psum(jnp.sum(jnp.where(pv, vb * vb, 0.0), axis=-1), "atoms")
        mean, var = _moment_stats(n, s, s2)

        hist = jax.vmap(
            jax.vmap(
                lambda v, m: histograms.masked_histogram(v, m, n_bins, lo, hi),
                in_axes=(None, 0),
            )
        )(value, pv)  # (F_loc, P+1, n_bins)
        hist = jax.lax.psum(jnp.sum(hist, axis=0), ("frames", "atoms"))
        return hist, mean, var

    hist, mean, var = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("frames", "atoms", None), P("frames", None), P("frames", None, "atoms")),
        out_specs=(P(), P("frames"), P("frames")),
        check_vma=False,
    )(pos, boxes, masks)
    return hist, (mean, var)


@partial(jax.jit, static_argnames=("mesh", "n_bins", "k", "row_block"))
def sharded_lsi_analysis(
    pos: jnp.ndarray,
    boxes: jnp.ndarray,
    masks: jnp.ndarray,
    mesh: Mesh,
    low_cut: float = 0.0,
    high_cut: float = 3.7,
    k: int = 24,
    n_bins: int = 500,
    lo: float = 0.0,
    hi: float = 0.3,
    row_block: int = 128,
):
    """LSI analysis over a ('frames', 'atoms') mesh with population masks.

    pos (F, N, 3), boxes (F, 3), masks (F, P+1, N) bool; arbitrary F/N
    (padded internally). Returns (hist (P+1, n_bins),
    (means (F, P+1), vars (F, P+1))) matching drivers._lsi_core."""
    from waterorderlib_tpu.order import lsi as lsi_mod

    f = pos.shape[0]
    pos, boxes, masks, _ = _pad_for_mesh(pos, boxes, masks, mesh)

    def value_fn(rows, full, box):
        res = lsi_mod.lsi(
            rows, full, box, low_cut, high_cut, k=k,
            row_block=min(row_block, rows.shape[0]),
        )
        return res.lsi, res.valid

    hist, (mean, var) = _sharded_center_value_stats(
        pos, boxes, masks, mesh, value_fn, n_bins, lo, hi
    )
    return hist, (mean[:f], var[:f])


@partial(jax.jit, static_argnames=("mesh", "n_bins", "k", "row_block"))
def sharded_psi6_analysis(
    pos: jnp.ndarray,
    boxes: jnp.ndarray,
    masks: jnp.ndarray,
    mesh: Mesh,
    low_cut: float = 0.0,
    high_cut: float = 7.0,
    k: int = 24,
    n_bins: int = 500,
    lo: float = 0.0,
    hi: float = 1.0,
    row_block: int = 128,
):
    """psi-6 analysis over a ('frames', 'atoms') mesh with population masks.

    Same contract as :func:`sharded_lsi_analysis`; every center is valid
    (psi=0 below 2 neighbors, like the unsharded driver path)."""
    from waterorderlib_tpu.order import psi6 as psi6_mod

    f = pos.shape[0]
    pos, boxes, masks, _ = _pad_for_mesh(pos, boxes, masks, mesh)

    def value_fn(rows, full, box):
        psi = psi6_mod.order_param_psi(
            rows, full, box, low_cut, high_cut, k=k,
            row_block=min(row_block, rows.shape[0]),
        )
        return psi, jnp.ones(psi.shape, bool)

    hist, (mean, var) = _sharded_center_value_stats(
        pos, boxes, masks, mesh, value_fn, n_bins, lo, hi
    )
    return hist, (mean[:f], var[:f])


@partial(jax.jit, static_argnames=("mesh", "n_bins", "k", "n2x", "row_block"))
def sharded_three_body_analysis(
    pos: jnp.ndarray,
    boxes: jnp.ndarray,
    masks: jnp.ndarray,
    mesh: Mesh,
    low_cut: float = 0.0,
    high_cut: float = 3.413,
    k: int = 16,
    n_bins: int = 500,
    lo: float = 0.0,
    hi: float = 180.0,
    n2x: int = 14,
    row_block: int = 128,
):
    """Full threeBodyCalc analysis step over a ('frames', 'atoms') mesh.

    Center rows shard over 'atoms' (each shard all_gathers the column atoms
    and computes its row block of pair angles); per-frame per-population
    moments psum over the atom axis. Returns the same contract as
    drivers.orderparams._three_body_core:
    ((hist (P+1, n_bins), hist2d (n2x*n_bins,)),
     (frac, avg_cos, var_cos, entropy, n_wats) each (F, P+1))."""
    from waterorderlib_tpu.order import angles as angles_mod

    f = pos.shape[0]
    pos, boxes, masks, _ = _pad_for_mesh(pos, boxes, masks, mesh)

    def local(pos_blk, box_blk, mask_blk):
        pos_full = jax.lax.all_gather(pos_blk, "atoms", axis=1, tiled=True)

        def one_frame(args):
            rows, full, box = args
            aset = angles_mod.neighbor_angles(
                rows, full, box, low_cut, high_cut, k=k,
                row_block=min(row_block, rows.shape[0]),
            )
            return aset.ang, aset.valid, aset.count

        ang, valid, count = jax.lax.map(one_frame, (pos_blk, pos_full, box_blk))
        # ang/valid: (F_loc, N_loc, K, K); count: (F_loc, N_loc)

        def frame_partials(ang_f, valid_f, mask_f):
            cosv = jnp.cos(jnp.radians(ang_f))

            def per_pop(m):
                pv = valid_f & m[:, None, None]
                h = histograms.masked_histogram(ang_f, pv, n_bins, lo, hi)
                tw = pv & (ang_f >= 100.0) & (ang_f <= 120.0)
                return (
                    h,
                    jnp.sum(pv).astype(jnp.float32),
                    jnp.sum(tw).astype(jnp.float32),
                    jnp.sum(jnp.where(tw, cosv, 0.0)),
                    jnp.sum(jnp.where(tw, cosv * cosv, 0.0)),
                )

            return jax.vmap(per_pop)(mask_f)

        h, n_tot, n_tet, s, s2 = jax.vmap(frame_partials)(ang, valid, mask_blk)
        h = jax.lax.psum(h, "atoms")  # (F_loc, P+1, n_bins)
        n_tot = jax.lax.psum(n_tot, "atoms")
        n_tet = jax.lax.psum(n_tet, "atoms")
        s = jax.lax.psum(s, "atoms")
        s2 = jax.lax.psum(s2, "atoms")

        avg, var = _moment_stats(n_tet, s, s2)
        # the unsharded tetrahedral_metrics uses max(n,1) denominators (no
        # NaN) for avg/var — match it
        avg = jnp.nan_to_num(avg)
        var = jnp.nan_to_num(var)
        frac = n_tet / jnp.maximum(n_tot, 1.0)
        dens = h / jnp.maximum(jnp.sum(h, axis=-1, keepdims=True), 1.0)
        ent = -jnp.sum(
            jnp.where(dens > 0, dens * jnp.log(jnp.where(dens > 0, dens, 1.0)), 0.0),
            axis=-1,
        )
        n_wats = jax.lax.psum(
            jnp.sum(mask_blk, axis=-1).astype(jnp.float32), "atoms"
        )
        hist_global = jax.lax.psum(jnp.sum(h, axis=0), "frames")

        # 2-D (coordination, angle) histogram: all-population scatter-add,
        # matching the XLA step in drivers.orderparams._three_body_core
        cc = jnp.clip(count - 1, 0, n2x - 1)
        cc2 = jnp.broadcast_to(cc[:, :, None, None], ang.shape)
        flat_bin = cc2.astype(jnp.int32) * n_bins + jnp.clip(
            jnp.floor(ang / (hi / n_bins)).astype(jnp.int32), 0, n_bins - 1
        )
        # gate on the all-waters mask row so padded (repeated) frames and
        # padded atoms contribute nothing
        okf = (valid & mask_blk[:, 0, :, None, None]).reshape(-1)
        h2 = jnp.zeros(n2x * n_bins, jnp.float32).at[
            jnp.where(okf, flat_bin.reshape(-1), 0)
        ].add(okf.astype(jnp.float32))
        h2 = jax.lax.psum(h2, ("frames", "atoms"))
        return hist_global, h2, frac, avg, var, ent, n_wats

    hist, h2, frac, avg, var, ent, n_wats = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("frames", "atoms", None), P("frames", None), P("frames", None, "atoms")),
        out_specs=(P(), P(), P("frames"), P("frames"), P("frames"), P("frames"), P("frames")),
        check_vma=False,
    )(pos, boxes, masks)
    return (hist, h2), (frac[:f], avg[:f], var[:f], ent[:f], n_wats[:f])


@partial(jax.jit, static_argnames=("mesh", "n_bins", "k", "row_block"))
def sharded_three_body_hist(
    pos: jnp.ndarray,
    boxes: jnp.ndarray,
    mesh: Mesh,
    low_cut: float = 0.0,
    high_cut: float = 3.413,
    k: int = 16,
    n_bins: int = 500,
    row_block: int = 256,
):
    """Trajectory-level 3-body angle histogram, frames sharded over the full
    mesh (both axes as data parallelism), psum-reduced counts.

    pos: (F, N, 3) with F divisible by the device count; boxes (F, 3).
    Returns (n_bins,) counts over [0, 180] degrees — the 3bDistribution
    accumulation of threeBodyCalc (orderParam_lib.py:1269-1424), scaled out.
    """
    from waterorderlib_tpu.order import angles as angles_mod

    def local(p, box):
        def one_frame(args):
            pf, bf = args
            aset = angles_mod.neighbor_angles(
                pf, pf, bf, low_cut, high_cut, k=k, row_block=row_block
            )
            return angles_mod.angle_histogram(aset, n_bins=n_bins)

        h = jnp.sum(jax.lax.map(one_frame, (p, box)), axis=0)
        return jax.lax.psum(h, ("frames", "atoms"))

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(("frames", "atoms"), None, None), P(("frames", "atoms"), None)),
        out_specs=P(),
        check_vma=False,
    )(pos, boxes)


@partial(jax.jit, static_argnames=("mesh", "nbins", "same", "row_block"))
def sharded_frame_distance_histograms(
    pos1: jnp.ndarray,
    pos2: jnp.ndarray,
    boxes: jnp.ndarray,
    mesh: Mesh,
    binwidth: float,
    nbins: int,
    same: bool = False,
    row_block: int = 512,
):
    """Per-frame pair-distance histograms with frames sharded over the full
    mesh (both axes as data parallelism) — the rdfCalc building block, which
    needs per-frame g(r) curves for its chunk statistics rather than one
    psum-reduced total. Arbitrary F (frames padded by repetition, trimmed).

    pos1/pos2 (F, N, 3), boxes (F, 3) -> counts (F, nbins)."""
    f = pos1.shape[0]
    n_dev = mesh.devices.size
    pad_f = (-f) % n_dev
    if pad_f:
        pos1 = jnp.concatenate([pos1, jnp.repeat(pos1[-1:], pad_f, axis=0)], axis=0)
        pos2 = jnp.concatenate([pos2, jnp.repeat(pos2[-1:], pad_f, axis=0)], axis=0)
        boxes = jnp.concatenate([boxes, jnp.repeat(boxes[-1:], pad_f, axis=0)], axis=0)

    def local(p1, p2, box):
        def one(carry, fr):
            a, b, bx = fr
            return carry, pairs.distance_histogram(
                a, b, bx, binwidth, nbins, same=same, row_block=row_block
            )

        return jax.lax.scan(one, 0.0, (p1, p2, box))[1]

    out = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(("frames", "atoms"), None, None),) * 2
        + (P(("frames", "atoms"), None),),
        out_specs=P(("frames", "atoms")),
        check_vma=False,
    )(pos1, pos2, boxes)
    return out[:f]


@partial(jax.jit, static_argnames=("mesh", "nbins", "same"))
def sharded_distance_histogram(
    pos1: jnp.ndarray,
    pos2: jnp.ndarray,
    boxes: jnp.ndarray,
    mesh: Mesh,
    binwidth: float,
    nbins: int,
    same: bool = False,
):
    """Trajectory-level pair-distance histogram, frames sharded over the
    full mesh (both axes used as data parallelism), counts psum-reduced.

    pos1/pos2: (F, N, 3); returns summed counts (nbins,)."""

    def local(p1, p2, box):
        def one_frame(args):
            a, b, bx = args
            return pairs.distance_histogram(a, b, bx, binwidth, nbins, same=same)

        h = jnp.sum(jax.lax.map(one_frame, (p1, p2, box)), axis=0)
        return jax.lax.psum(h, ("frames", "atoms"))

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(("frames", "atoms"), None, None),) * 2 + (P(("frames", "atoms"), None),),
        out_specs=P(),
        check_vma=False,
    )(pos1, pos2, boxes)


@partial(jax.jit, static_argnames=("mesh",))
def sharded_msd(
    pos: jnp.ndarray,
    boxes: jnp.ndarray,
    mesh: Mesh,
    mask: jnp.ndarray | None = None,
):
    """MSD(t) vs frame 0 with PBC unwrapping, ATOMS sharded over the whole
    mesh.

    The frame scan is inherently serial (the unwrap carry chains through
    time, core.geometry.squared_displacement / calcSD waterlib.f90:923-951),
    so — unlike the per-frame analyses — both mesh axes shard the atom
    dimension and every device scans all frames over its atom block; the
    per-frame displacement sums and atom counts are psum-reduced.

    pos: (F, N, 3) with N divisible by the total device count; mask:
    optional (N,) bool selecting real atoms (pad with False). Returns
    msd (F,), replicated.
    """
    from waterorderlib_tpu.core import geometry

    if mask is None:
        mask = jnp.ones(pos.shape[1], bool)

    def local(pos_blk, mask_blk, box):
        ref = pos_blk[0]
        w = mask_blk.astype(pos_blk.dtype)

        def step(prev, frame):
            p, bx = frame
            sd, new = geometry.squared_displacement(p, prev, ref, bx)
            return new, jnp.sum(jnp.sum(sd, axis=-1) * w)

        _, sums = jax.lax.scan(step, ref, (pos_blk, box))
        tot = jax.lax.psum(sums, ("frames", "atoms"))
        cnt = jax.lax.psum(jnp.sum(w), ("frames", "atoms"))
        return tot / jnp.maximum(cnt, 1.0)

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, ("frames", "atoms"), None),
            P(("frames", "atoms")),
            P(None, None),
        ),
        out_specs=P(),
        check_vma=False,
    )(pos, mask, boxes)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "num", "k", "k_search", "row_block", "eps", "win",
        "topk_impl", "cell_impl", "mirror_budget", "cg",
    ),
)
def sharded_voronoi_tier1(
    pos: jnp.ndarray,
    box_ls: jnp.ndarray,
    mesh: Mesh,
    *,
    num: int,
    k: int,
    k_search: int,
    row_block: int,
    eps: float,
    win: int,
    topk_impl: str,
    cell_impl: str,
    mirror_budget: int = 0,
    cg=None,
):
    """Tier-1 device Voronoi cells for a frame batch, frames sharded over
    BOTH mesh axes (a per-frame tessellation is independent of every other
    frame — pure data parallelism; the atom axis has no role here, so it
    joins the frame partition instead of idling). No collectives are
    needed: results stay frame-sharded and the caller gathers them.

    pos: (F, P, 3) with F divisible by mesh.devices.size; box_ls: (F,)
    cubic box edges. Returns (vol (F, num), area (F, num),
    certified (F, num)) — the per-frame outputs of
    surface.voronoi_device._tier1_pure.
    """
    from waterorderlib_tpu.surface import voronoi_device as vd

    def local(pos_blk, bl_blk):
        def one(args):
            p, b = args
            return vd._tier1_pure(
                p, b, num, k, k_search, row_block, eps, win, topk_impl,
                cell_impl, mirror_budget, cg,
            )

        return jax.lax.map(one, (pos_blk, bl_blk))

    both = ("frames", "atoms")
    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(both, None, None), P(both)),
        out_specs=(P(both, None), P(both, None), P(both, None)),
        check_vma=False,
    )(pos, box_ls)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "num", "k", "k_search", "row_block", "eps", "win",
        "topk_impl", "cell_impl", "mirror_budget", "cg",
    ),
)
def sharded_voronoi_contacts_tier1(
    pos: jnp.ndarray,
    box_ls: jnp.ndarray,
    sel: jnp.ndarray,
    mesh: Mesh,
    *,
    num: int,
    k: int,
    k_search: int,
    row_block: int,
    eps: float,
    win: int,
    topk_impl: str,
    cell_impl: str,
    mirror_budget: int = 0,
    cg=None,
):
    """Contacts variant of `sharded_voronoi_tier1`: tier-1 cells WITH the
    face payload for the selected center rows of every frame, frames
    sharded over both mesh axes. `sel` (fixed-length row indices) is
    replicated. Returns the `_CONTACTS_TIER1_KEYS` tuple with a leading
    frame axis (F must divide by mesh.devices.size)."""
    from waterorderlib_tpu.surface import voronoi_device as vd

    def local(pos_blk, bl_blk, sel_rep):
        def one(args):
            p, b = args
            return vd._tier1_contacts_full(
                p, b, sel_rep, num, k, k_search, row_block, eps, win,
                topk_impl, cell_impl, mirror_budget, cg,
            )

        return jax.lax.map(one, (pos_blk, bl_blk))

    both = ("frames", "atoms")
    f2 = P(both, None)      # (F, n_sel)
    f3 = P(both, None, None)  # (F, n_sel, K)
    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(both, None, None), P(both), P(None)),
        out_specs=(f2, f2, f2, f3, f3, f3, f3, f3, f2, f2),
        check_vma=False,
    )(pos, box_ls, sel)
