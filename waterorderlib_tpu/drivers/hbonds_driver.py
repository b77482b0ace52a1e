"""Hydrogen-bond trajectory drivers.

JAX replacements for `hbCalc`
(/root/reference/structureLibs/orderParam_lib.py:729-917), `getBoundWrap`
(:419-572, trajectory-level wrapper with per-frame caching), and the cluster
statistics drivers `getHBClusterStats` (:158-237), `getIonClusterStats`
(:239-311), and `getNeighborStats` (:313-384).

The serial per-frame loop with 9 f2py H-bond matrices per frame becomes one
jitted `lax.scan` over an (F, ., 3) device tensor; the per-molecule folding
strides (ref :850-860) become reshapes.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from waterorderlib_tpu.hbonds.bonds import general_hbonds, hbond_counts
from waterorderlib_tpu.hbonds import clusters as clusters_mod
from waterorderlib_tpu.hbonds.populations import bound_wrap_masks
from waterorderlib_tpu.ops import histograms, pairs
from waterorderlib_tpu.drivers.orderparams import _resolve_system
from waterorderlib_tpu.stats import blocks


def _sol_hb_triplets(top, wat_res="WAT"):
    sol, sol_h, sol_c, sol_n, sol_o, sol_s = top.get_sol_inds(wat_res)
    hb_o, hb_n = top.get_hb_inds(sol_n, sol_o)
    return sol, hb_o, hb_n


def hb_calc(
    top_file,
    traj_file,
    wat_res: str = "WAT",
    stride: int = 1,
    dist_cut: float = 3.5,
    ang_cut: float = 120.0,
    output_dir: str = ".",
    chunk_frames: int | None = None,
    mesh=None,
):
    """Average H-bonds per water and per cosolvent molecule
    (orderParam_lib.py:729-917). Writes hbDistribution_water.txt and
    hbDistribution_cosolv.txt (histogram bins [0,1,...,10]); returns
    (avgWatHBs, avgSolHBs). With `chunk_frames` the trajectory streams
    through the device in chunks (io/streaming.py); with `mesh`
    (parallel.mesh.make_mesh) frames shard over the device mesh as data
    parallelism — the options compose."""
    if chunk_frames is not None:
        from waterorderlib_tpu.io.topology import Topology
        from waterorderlib_tpu.io.trajectory import load_topology

        top = top_file if isinstance(top_file, Topology) else load_topology(top_file)
        traj = None
    else:
        top, traj = _resolve_system(top_file, traj_file, stride)
    wat_inds, wat_h_inds, _ = top.get_wat_inds(wat_res)
    sol_inds, hb_o, hb_n = _sol_hb_triplets(top, wat_res)
    sol_acc_o, sol_don_o, sol_donh_o = hb_o
    sol_acc_n, sol_don_n, sol_donh_n = hb_n
    # water triplets: acceptors = O's, donors = O twice, donorH = its 2 H's
    wat_hb_o, _ = top.get_hb_inds(np.array([], int), wat_inds)
    wat_acc, wat_don, wat_donh = wat_hb_o

    n_sol = len(np.unique(top.res_ids[sol_inds])) if len(sol_inds) else 0
    has_sol = n_sol > 0 and (len(sol_acc_o) + len(sol_acc_n)) > 0

    nw = len(wat_inds)
    n_bins = 10

    def fold_mol(v, per_mol):
        return v.reshape(n_sol, per_mol).sum(axis=1) if per_mol else jnp.zeros(n_sol)

    def frame_counts(p, box):
        """Per-frame H-bond totals: (wat_tot (Nw,), sol_tot (n_sol,)). Every
        pair set goes through the blocked counter: the consumers need only
        per-acceptor and per-donor sums, never the (Na, Nd) matrix."""

        def hb(a, d, dh):
            return hbond_counts(a, d, dh, box, dist_cut, ang_cut)

        wat_acc_pos = p[wat_acc]
        wat_don_pos = p[wat_don]
        wat_donh_pos = p[wat_donh]
        acc_cnt, don_cnt = hb(wat_acc_pos, wat_don_pos, wat_donh_pos)
        wat_tot = acc_cnt + don_cnt.reshape(nw, 2).sum(axis=1)

        if has_sol:
            sO_acc, sO_don, sO_donh = p[sol_acc_o], p[sol_don_o], p[sol_donh_o]
            sN_acc, sN_don, sN_donh = p[sol_acc_n], p[sol_don_n], p[sol_donh_n]
            # each entry: (per-acceptor counts, per-donor counts)
            watsolO = hb(wat_acc_pos, sO_don, sO_donh)
            solwatO = hb(sO_acc, wat_don_pos, wat_donh_pos)
            watsolN = hb(wat_acc_pos, sN_don, sN_donh)
            solwatN = hb(sN_acc, wat_don_pos, wat_donh_pos)
            solOsolO = hb(sO_acc, sO_don, sO_donh)
            solOsolN = hb(sO_acc, sN_don, sN_donh)
            solNsolO = hb(sN_acc, sO_don, sO_donh)
            solNsolN = hb(sN_acc, sN_don, sN_donh)

            solO_acc_cnt = solwatO[0] + solOsolO[0] + solOsolN[0]
            solO_don_cnt = watsolO[1] + solOsolO[1] + solNsolO[1]
            solN_acc_cnt = solwatN[0] + solNsolN[0] + solNsolO[0]
            solN_don_cnt = watsolN[1] + solNsolN[1] + solOsolN[1]

            sol_tot = (
                fold_mol(solO_acc_cnt, len(sol_acc_o) // n_sol)
                + fold_mol(solO_don_cnt, len(sol_don_o) // n_sol)
                + fold_mol(solN_acc_cnt, len(sol_acc_n) // n_sol)
                + fold_mol(solN_don_cnt, len(sol_don_n) // n_sol)
            )
            wat_tot = (
                wat_tot
                + watsolO[0]
                + solwatO[1].reshape(nw, 2).sum(axis=1)
                + watsolN[0]
                + solwatN[1].reshape(nw, 2).sum(axis=1)
            )
        else:
            sol_tot = jnp.zeros(max(n_sol, 1), jnp.int32)
        return wat_tot.astype(jnp.float32), sol_tot.astype(jnp.float32)

    def step(carry, frame):
        p, box = frame
        wat_tot, sol_tot = frame_counts(p, box)
        h_wat, h_sol = carry
        h_wat = h_wat + histograms.masked_histogram(
            wat_tot, jnp.ones_like(wat_tot, bool), n_bins, 0.0, float(n_bins)
        )
        h_sol = h_sol + histograms.masked_histogram(
            sol_tot, jnp.ones_like(sol_tot, bool), n_bins, 0.0, float(n_bins)
        )
        return (h_wat, h_sol), (jnp.mean(wat_tot), jnp.mean(sol_tot))

    @jax.jit
    def run(pos, boxes):
        init = (jnp.zeros(n_bins, jnp.float32), jnp.zeros(n_bins, jnp.float32))
        return jax.lax.scan(step, init, (pos, boxes))

    if mesh is not None:
        # frames shard over the whole mesh as data parallelism; padded
        # frames carry weight 0 so histograms stay exact
        from functools import partial as _partial

        from jax import shard_map
        from jax.sharding import PartitionSpec as _P

        @_partial(jax.jit, static_argnames=())
        def run_sharded(pos, boxes, weights):
            def local(p, b, w):
                def one(carry, fr):
                    pf, bf, wf = fr
                    wat_tot, sol_tot = frame_counts(pf, bf)
                    hw = wf * histograms.masked_histogram(
                        wat_tot, jnp.ones_like(wat_tot, bool), n_bins, 0.0, float(n_bins)
                    )
                    hs = wf * histograms.masked_histogram(
                        sol_tot, jnp.ones_like(sol_tot, bool), n_bins, 0.0, float(n_bins)
                    )
                    h_wat, h_sol = carry
                    return (h_wat + hw, h_sol + hs), (jnp.mean(wat_tot), jnp.mean(sol_tot))

                init = (jnp.zeros(n_bins, jnp.float32), jnp.zeros(n_bins, jnp.float32))
                (hw, hs), (wm, sm) = jax.lax.scan(one, init, (p, b, w))
                return (
                    jax.lax.psum(hw, ("frames", "atoms")),
                    jax.lax.psum(hs, ("frames", "atoms")),
                    wm,
                    sm,
                )

            spec = _P(("frames", "atoms"))
            return shard_map(
                local,
                mesh=mesh,
                in_specs=(_P(("frames", "atoms"), None, None), _P(("frames", "atoms"), None), spec),
                out_specs=(_P(), _P(), spec, spec),
                check_vma=False,
            )(pos, boxes, weights)

        def run(pos, boxes):  # noqa: F811 — mesh-sharded override
            f = pos.shape[0]
            n_dev = mesh.devices.size
            pad_f = (-f) % n_dev
            w = jnp.ones(f, jnp.float32)
            if pad_f:
                pos = jnp.concatenate([pos, jnp.repeat(pos[-1:], pad_f, axis=0)], axis=0)
                boxes = jnp.concatenate([boxes, jnp.repeat(boxes[-1:], pad_f, axis=0)], axis=0)
                w = jnp.concatenate([w, jnp.zeros(pad_f, jnp.float32)])
            hw, hs, wm, sm = run_sharded(pos, boxes, w)
            return (hw, hs), (wm[:f], sm[:f])

    if chunk_frames is not None:
        from waterorderlib_tpu.io.streaming import iter_chunks

        h_wat = np.zeros(n_bins, np.float32)
        h_sol = np.zeros(n_bins, np.float32)
        wm_parts, sm_parts = [], []
        for pos_c, boxes_c in iter_chunks(traj_file, chunk_frames, stride, n_atoms=top.n_atoms):
            (hw, hs), (wm, sm) = run(jnp.asarray(pos_c), jnp.asarray(boxes_c))
            h_wat += np.asarray(hw)
            h_sol += np.asarray(hs)
            wm_parts.append(np.asarray(wm))
            sm_parts.append(np.asarray(sm))
        wat_means = np.concatenate(wm_parts)
        sol_means = np.concatenate(sm_parts)
    else:
        (h_wat, h_sol), (wat_means, sol_means) = run(
            jnp.asarray(traj.positions), jnp.asarray(traj.boxes)
        )
    centers = np.arange(n_bins) + 0.5
    np.savetxt(
        os.path.join(output_dir, "hbDistribution_water.txt"),
        np.stack([centers, np.asarray(h_wat)], axis=1),
        header="# hbs    frequency", fmt="%.3e",
    )
    np.savetxt(
        os.path.join(output_dir, "hbDistribution_cosolv.txt"),
        np.stack([centers, np.asarray(h_sol)], axis=1),
        header="# hbs    frequency", fmt="%.3e",
    )
    avg_wat = float(np.mean(np.asarray(wat_means)))
    avg_sol = float(np.mean(np.asarray(sol_means))) if has_sol else 0.0
    return avg_wat, avg_sol


def get_bound_wrap(
    top_file,
    traj,
    frame_index: int | None = None,
    wat_res: str = "WAT",
    cutoff: float = 4.0,
    hb_dist: float = 3.0,
    hb_ang: float = 150.0,
):
    """Bound/wrap/shell/non-shell water indices (orderParam_lib.py:419-572).

    With frame_index=None the whole trajectory is processed in one device
    pass and a list of per-frame (boundInds, wrapInds, shellInds,
    nonShellInds) tuples of *global atom indices* is returned; with a frame
    index, that single frame's tuple (the reference's per-frame API).
    """
    top, traj = _resolve_system(top_file, traj, 1)
    wat_inds, wat_h_inds, _ = top.get_wat_inds(wat_res)
    sol_inds, hb_o, _ = _sol_hb_triplets(top, wat_res)
    sol_acc_o, sol_don_o, sol_donh_o = hb_o
    wat_hb_o, _ = top.get_hb_inds(np.array([], int), wat_inds)
    _, _, wat_donh = wat_hb_o

    sel = slice(None) if frame_index is None else slice(frame_index, frame_index + 1)
    pos = jnp.asarray(traj.positions[sel])
    boxes = jnp.asarray(traj.boxes[sel])

    @jax.jit
    def run(pos, boxes):
        def one(carry, frame):
            p, box = frame
            bw = bound_wrap_masks(
                p[wat_inds], p[wat_donh], p[sol_inds],
                p[sol_acc_o], p[sol_don_o], p[sol_donh_o],
                box, cutoff, hb_dist, hb_ang,
            )
            return carry, (bw.bound, bw.wrap, bw.shell, bw.non_shell)

        return jax.lax.scan(one, None, (pos, boxes))[1]

    bound, wrap, shell, non_shell = (np.asarray(m) for m in run(pos, boxes))
    out = [
        (wat_inds[bound[t]], wat_inds[wrap[t]], wat_inds[shell[t]], wat_inds[non_shell[t]])
        for t in range(bound.shape[0])
    ]
    return out[0] if frame_index is not None else out


def get_hb_cluster_stats(
    top_file,
    traj_file,
    acceptor_inds,
    donor_inds,
    donor_h_inds,
    stride: int = 1,
    dist_cut: float = 3.0,
    ang_cut: float = 150.0,
    output_dir: str = ".",
    seed: int | None = 0,
):
    """Residue-residue H-bond cluster statistics (orderParam_lib.py:158-237).

    Builds the per-frame residue adjacency from the H-bond matrix, finds
    connected components by label propagation, and returns
    [mean cluster size, CI] over frames; also writes the cluster-size
    distribution summed over frames (clusterDistribution.txt)."""
    top, traj = _resolve_system(top_file, traj_file, stride)
    acceptor_inds = np.asarray(acceptor_inds, int)
    donor_inds = np.asarray(donor_inds, int)
    donor_h_inds = np.asarray(donor_h_inds, int)
    acc_res = jnp.asarray(top.res_ids[acceptor_inds].astype(np.int32))
    don_res = jnp.asarray(top.res_ids[donor_inds].astype(np.int32))
    res_ids = np.unique(np.concatenate([top.res_ids[acceptor_inds], top.res_ids[donor_inds]]))
    n_res = int(res_ids.max()) + 1 if len(res_ids) else 0

    pos = jnp.asarray(traj.positions)
    boxes = jnp.asarray(traj.boxes)

    @jax.jit
    def run(pos, boxes):
        def one(carry, frame):
            p, box = frame
            hb = general_hbonds(
                p[acceptor_inds], p[donor_inds], p[donor_h_inds], box, dist_cut, ang_cut
            )
            # residue-level adjacency: any atom-level bond connects residues
            adj = jnp.zeros((n_res, n_res), bool).at[
                acc_res[:, None], don_res[None, :]
            ].max(hb)
            adj = adj | adj.T
            adj = adj & ~jnp.eye(n_res, dtype=bool)
            sizes = clusters_mod.cluster_sizes(adj)
            mean_size = jnp.sum(sizes) / jnp.maximum(jnp.sum(sizes > 0), 1)
            dist = jnp.zeros(n_res + 1, jnp.int32).at[
                jnp.clip(sizes, 0, n_res)
            ].add((sizes > 0).astype(jnp.int32))
            return carry + dist[1:], mean_size

        return jax.lax.scan(one, jnp.zeros(n_res, jnp.int32), (pos, boxes))

    dist, mean_sizes = run(pos, boxes)
    np.savetxt(
        os.path.join(output_dir, "clusterDistribution.txt"),
        np.stack([np.arange(1, n_res + 1), np.asarray(dist)], axis=1),
        header="cluster size    frequency", fmt="%d",
    )
    return blocks.mean_and_ci(np.asarray(mean_sizes), seed=seed)


def get_ion_cluster_stats(
    top_file,
    traj_file,
    ion_inds,
    charges,
    stride: int = 1,
    cutoff: float = 3.5,
    output_dir: str = ".",
    seed: int | None = 0,
):
    """Ion contact-cluster statistics (orderParam_lib.py:239-311): clusters
    of ions within `cutoff`, per-cluster net charge, mean cation effective
    charge. Returns [mean cluster size, CI]; writes clusterDistribution.txt."""
    top, traj = _resolve_system(top_file, traj_file, stride)
    ion_inds = np.asarray(ion_inds, int)
    charges_j = jnp.asarray(np.asarray(charges, np.float32))
    n = len(ion_inds)
    pos = jnp.asarray(traj.positions[:, ion_inds, :])
    boxes = jnp.asarray(traj.boxes)

    @jax.jit
    def run(pos, boxes):
        def one(carry, frame):
            p, box = frame
            adj = pairs.neighbor_mask(p, p, box, 0.0, cutoff)
            labels = clusters_mod.connected_components(adj)
            sizes = jnp.zeros(n, jnp.int32).at[labels].add(1)
            mean_size = jnp.sum(sizes) / jnp.maximum(jnp.sum(sizes > 0), 1)
            net_charge = jnp.zeros(n, jnp.float32).at[labels].add(charges_j)
            # mean effective charge of clusters containing a cation
            has_cation = jnp.zeros(n, bool).at[labels].max(charges_j > 0)
            n_cat = jnp.maximum(jnp.sum(has_cation), 1)
            mean_eff = jnp.sum(jnp.where(has_cation, net_charge, 0.0)) / n_cat
            dist = jnp.zeros(n + 1, jnp.int32).at[jnp.clip(sizes, 0, n)].add(
                (sizes > 0).astype(jnp.int32)
            )
            return carry + dist[1:], (mean_size, mean_eff)

        return jax.lax.scan(one, jnp.zeros(n, jnp.int32), (pos, boxes))

    dist, (mean_sizes, mean_effs) = run(pos, boxes)
    np.savetxt(
        os.path.join(output_dir, "clusterDistribution.txt"),
        np.stack([np.arange(1, n + 1), np.asarray(dist)], axis=1),
        header="cluster size    frequency", fmt="%d",
    )
    return (
        blocks.mean_and_ci(np.asarray(mean_sizes), seed=seed),
        blocks.mean_and_ci(np.asarray(mean_effs), seed=seed),
    )


def get_neighbor_stats(
    top_file,
    traj_file,
    atom_inds,
    mol_ids,
    stride: int = 1,
    cutoff: float = 3.5,
    output_dir: str = ".",
    seed: int | None = 0,
):
    """Per-molecule coordination numbers (orderParam_lib.py:313-384):
    contacts between atoms of *different* molecules within `cutoff`
    (intra-molecular contacts zeroed, ref :352-353), folded per molecule.
    Returns [mean coordination, CI]; writes coordDistribution.txt."""
    top, traj = _resolve_system(top_file, traj_file, stride)
    atom_inds = np.asarray(atom_inds, int)
    mol = jnp.asarray(np.asarray(mol_ids, np.int32))
    n_mol = int(np.max(mol_ids)) + 1
    pos = jnp.asarray(traj.positions[:, atom_inds, :])
    boxes = jnp.asarray(traj.boxes)
    n_bins = 20

    @jax.jit
    def run(pos, boxes):
        def one(carry, frame):
            p, box = frame
            adj = pairs.neighbor_mask(p, p, box, 0.0, cutoff)
            inter = adj & (mol[:, None] != mol[None, :])
            per_atom = jnp.sum(inter, axis=1).astype(jnp.float32)
            per_mol = jnp.zeros(n_mol, jnp.float32).at[mol].add(per_atom)
            h = histograms.masked_histogram(
                per_mol, jnp.ones_like(per_mol, bool), n_bins, 0.0, float(n_bins)
            )
            return carry + h, jnp.mean(per_mol)

        return jax.lax.scan(one, jnp.zeros(n_bins, jnp.float32), (pos, boxes))

    hist, means = run(pos, boxes)
    np.savetxt(
        os.path.join(output_dir, "coordDistribution.txt"),
        np.stack([np.arange(n_bins) + 0.5, np.asarray(hist)], axis=1),
        header="coordination    frequency", fmt="%.3e",
    )
    return blocks.mean_and_ci(np.asarray(means), seed=seed)


def bound_wrap_func1(top_file, traj, frame_index: int = 0, cutoff: float = 4.6):
    """One-call wrapper matching boundWrap.func1
    (/root/reference/structureLibs/boundWrap.py:3-14): returns
    [boundInds, wrapInds, shellInds, nonShellInds] for one frame at the
    4.6 A cutoff. (The reference imports a .pyc-only dev module for this;
    the underlying computation is getBoundWrap.)"""
    bound, wrap, shell, non_shell = get_bound_wrap(
        top_file, traj, frame_index=frame_index, cutoff=cutoff
    )
    return [bound, wrap, shell, non_shell]
