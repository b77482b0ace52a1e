"""Voronoi-based trajectory drivers.

Replacements for `voronoiCalc`
(/root/reference/structureLibs/orderParam_lib.py:964-1111), `contactAreaCalc`
(:1794-1942), and a completed `hydratedVolumeCalc` (:1113-1267 — the
reference version is unfinished: it dead-ends in debug prints and a bare
`stop` at :1180-1183; here it is implemented properly as the per-frame total
Voronoi volume of the solute's heavy atoms).

The Qhull tessellation is host-only, so these drivers iterate frames on the
host; everything mask-like (bound/wrap populations) is computed on device in
one batched pass *before* the loop (drivers/hbonds_driver.get_bound_wrap).
"""

from __future__ import annotations

import os

import numpy as np

from waterorderlib_tpu.drivers.orderparams import _resolve_system, _save_hist
from waterorderlib_tpu.drivers.hbonds_driver import get_bound_wrap
from waterorderlib_tpu.ops import backend
from waterorderlib_tpu.stats import blocks
from waterorderlib_tpu.surface.voronoi import voronoi_contacts, voronoi_volumes
from waterorderlib_tpu.utils import logging as _logging_mod

# Work (points x frames) from which "auto" takes the certified device cells
# (surface/voronoi_device.py) over host Qhull on a GPU: the point where a
# cold start's compile is repaid. On an H100 (PERF.md) the per-water
# volume program compiled in 108-422 s and then ran at ~7 ms/frame, against
# ~0.25 ms per point per frame for Qhull; the solute-rows program of
# contact_area_calc / hydrated_volume_calc compiled in ~15 s and ran at
# 0.24 s/frame against 1.2 s/frame at 4,101 points. On the CPU backend the
# clip builder's large XLA intermediates lose to Qhull at every size, so
# "auto" stays on the host there (engine="device" still forces it).
_DEVICE_MIN_WORK = {"volumes": 1_000_000, "contacts": 64_000}


def _pick_engine(engine: str, n_points: int, n_frames: int, kind: str) -> str:
    if engine == "auto":
        return (
            "device"
            if backend.is_gpu() and n_points * n_frames >= _DEVICE_MIN_WORK[kind]
            else "host"
        )
    if engine not in ("host", "device"):
        raise ValueError(f"engine must be auto|host|device, got {engine!r}")
    return engine


# shared once-per-key seen-set; keys are (driver, engine)
_logged_engines = _logging_mod._LOGGED_ONCE


def _log_engine_once(driver: str, engine: str, extra: str = ""):
    _logging_mod.log_once(
        (driver, engine), "%s: voronoi engine=%s%s", driver, engine, extra
    )


def _masked_stats(vals):
    vals = vals[~np.isinf(vals)]
    if len(vals) == 0:
        return np.nan, np.nan, vals
    return float(np.mean(vals)), float(np.var(vals)), vals


def voronoi_calc(
    top_file,
    traj_file,
    sub_inds=None,
    n_pops: int = 0,
    wat_res: str = "WAT",
    stride: int = 1,
    output_dir: str = ".",
    seed: int | None = 0,
    engine: str = "auto",
    mesh=None,
    chunk_frames: int | None = None,
):
    """Per-water Voronoi volume/area/asphericity eta = A^3/(36 pi V^2)
    (orderParam_lib.py:964-1111). Returns (avgVol, varVol, avgArea, varArea,
    avgEta, varEta), each [means (P+1,), CIs (P+1,)]; writes
    {Vol,Area,Eta}Distribution_j.txt.

    engine: "host" = Qhull tessellation (f64-exact); "device" = certified
    device cells (surface/voronoi_device.py) with per-atom host fallback;
    "auto" = see `_pick_engine`.

    The device engine batches frames by default: tier-1 cells for
    `chunk_frames` frames (default: min(F, 16)) run in ONE jitted dispatch
    and the escalation ladder runs once per tier per chunk — the per-frame
    path re-traces every tier's jit and pays the dispatch round-trip per
    tier per frame; it is kept only for single-frame calls.

    mesh: optional jax.sharding.Mesh (device engine only) — the batched
    tier-1 call is shard_mapped with frames data-parallel over the mesh;
    escalation/host fallback stay per-frame on the uncertified residue."""
    top, traj = _resolve_system(top_file, traj_file, stride)
    wat_inds, _, _ = top.get_wat_inds(wat_res)
    sol_inds, *_ = top.get_sol_inds(wat_res)
    heavy = np.concatenate([wat_inds, sol_inds])
    F = traj.n_frames
    nw = len(wat_inds)
    row_of_wat = {int(w): i for i, w in enumerate(wat_inds)}
    eng = _pick_engine(engine, len(heavy), F, "volumes")
    _log_engine_once("voronoi_calc", eng)
    vol_b = area_b = None
    if eng == "device":
        from waterorderlib_tpu.surface.voronoi_device import voronoi_volumes_hybrid

        if F > 1 or mesh is not None or chunk_frames is not None:
            from waterorderlib_tpu.surface.voronoi_device import (
                voronoi_volumes_hybrid_frames,
            )

            cf = int(chunk_frames) if chunk_frames else min(F, 16)
            if mesh is not None:
                # chunks must fill the mesh; frames pad to the device count
                cf = max(cf, int(mesh.devices.size))
            vol_b = np.zeros((F, nw))
            area_b = np.zeros((F, nw))
            n_cert_tot = 0
            for c0 in range(0, F, cf):
                c1 = min(c0 + cf, F)
                pos_b = np.asarray(
                    [traj.positions[t] for t in range(c0, c1)], np.float64
                )[:, heavy, :]
                box_ls = np.asarray(
                    [traj.boxes[t][0] for t in range(c0, c1)], np.float64
                )
                vol_b[c0:c1], area_b[c0:c1], n_c = voronoi_volumes_hybrid_frames(
                    pos_b, box_ls, nw, mesh=mesh
                )
                n_cert_tot += int(n_c)
            _log_engine_once(
                "voronoi_calc.cert", "device",
                f" ({n_cert_tot}/{F * nw} cells device-certified, frames "
                f"batched in chunks of {cf}"
                + (f", sharded over {int(mesh.devices.size)} devices"
                   if mesh is not None else "")
                + ")",
            )

    stats = {k: np.zeros((F, n_pops + 1)) for k in
             ("avgV", "varV", "avgA", "varA", "avgE", "varE")}
    val_lists = {k: [[] for _ in range(n_pops + 1)] for k in ("V", "A", "E")}

    for t in range(F):
        pos = traj.positions[t].astype(np.float64)
        box_l = float(traj.boxes[t][0])
        if vol_b is not None:
            vol, area = vol_b[t], area_b[t]
        elif eng == "device":
            vol, area, n_cert = voronoi_volumes_hybrid(pos[heavy], box_l, nw)
            if t == 0:
                _log_engine_once(
                    "voronoi_calc.cert", "device",
                    f" ({n_cert}/{nw} cells device-certified on frame 0)",
                )
        else:
            vol, area = voronoi_volumes(pos[heavy], box_l, nw)
        eta = np.where(
            np.isinf(vol) | np.isinf(area), np.inf, area**3 / (36.0 * np.pi * np.maximum(vol, 1e-300) ** 2)
        )
        pops = [np.arange(nw)]
        if sub_inds is not None:
            pops += [np.array([row_of_wat[int(a)] for a in sub_inds[t][p]], int)
                     for p in range(n_pops)]
        for j, rows in enumerate(pops):
            m_v, v_v, vv = _masked_stats(vol[rows])
            m_a, v_a, aa = _masked_stats(area[rows])
            m_e, v_e, ee = _masked_stats(eta[rows])
            stats["avgV"][t, j], stats["varV"][t, j] = m_v, v_v
            stats["avgA"][t, j], stats["varA"][t, j] = m_a, v_a
            stats["avgE"][t, j], stats["varE"][t, j] = m_e, v_e
            val_lists["V"][j].append(vv)
            val_lists["A"][j].append(aa)
            val_lists["E"][j].append(ee)

    for j in range(n_pops + 1):
        for key, fname, rng, header in (
            ("V", f"VolDistribution_{j}.txt", (10.0, 60.0), "water volume (A^3)    frequency"),
            ("A", f"AreaDistribution_{j}.txt", (10.0, 100.0), "water area (A^2)    frequency"),
            ("E", f"EtaDistribution_{j}.txt", (1.0, 2.5), "asphericity    frequency"),
        ):
            vals = np.concatenate(val_lists[key][j]) if val_lists[key][j] else np.zeros(0)
            hist, _ = np.histogram(vals, bins=500, range=rng)
            _save_hist(os.path.join(output_dir, fname), hist, 500, rng[0], rng[1], header)

    def mc(key):
        arr = stats[key]
        means = np.nanmean(arr, axis=0)
        cis = np.array([blocks.block_average(arr[:, j], seed=seed) for j in range(n_pops + 1)])
        return [means, cis]

    return mc("avgV"), mc("varV"), mc("avgA"), mc("varA"), mc("avgE"), mc("varE")


def _contacts_frames_iter(eng, traj, heavy, sol_rows, mesh, chunk_frames):
    """Per-frame results iterator through the frames-batched device contacts
    path, or None when the per-frame path applies (host engine, or device
    engine with neither mesh nor chunk_frames requested). Chunks bound the
    device batch and the host-side tier-1 payload."""
    if eng != "device" or (mesh is None and chunk_frames is None):
        return None
    from waterorderlib_tpu.surface.voronoi_device import (
        voronoi_contacts_hybrid_frames,
    )

    F = traj.n_frames
    cf = int(chunk_frames) if chunk_frames else F

    def gen():
        for c0 in range(0, F, cf):
            c1 = min(c0 + cf, F)
            pos_b = np.asarray(
                [traj.positions[t] for t in range(c0, c1)], np.float64
            )[:, heavy, :]
            box_b = np.asarray(
                [traj.boxes[t][0] for t in range(c0, c1)], np.float64
            )
            yield from voronoi_contacts_hybrid_frames(
                pos_b, box_b, len(heavy), rows=sol_rows, mesh=mesh
            )

    return gen()


def contact_area_calc(
    top_file,
    traj_file,
    wat_res: str = "WAT",
    stride: int = 1,
    cutoff: float = 4.0,
    hb_dist: float = 3.0,
    hb_ang: float = 150.0,
    seed: int | None = 0,
    engine: str = "auto",
    mesh=None,
    chunk_frames: int | None = None,
):
    """Fraction of the solute's Voronoi surface in contact with
    phobic/philic/bound/wrap atoms (orderParam_lib.py:1794-1942).

    Returns (totArea, totArea_CI, fracArea, fracArea_CI) in the reference's
    ordering: totArea = [tot, phobic, philic, bound, wrap];
    fracArea = [phobic, philic, bound, wrap]. Contact areas are halved to
    undo the double-sided hull.area convention (ref getTotArea :1899-1910);
    intra-solute-residue contacts are excluded from the target sums.

    engine: "host" (Qhull) | "device" (certified device cells) | "auto".

    mesh: optional jax.sharding.Mesh (device engine only) — the solute
    rows' tier-1 cells for the whole frame batch run in one shard_mapped
    call with frames data-parallel; escalation/host fallback stay
    per-frame. chunk_frames bounds the device batch (and host payload) to
    that many frames per dispatch; implies the batched path even without
    a mesh."""
    top, traj = _resolve_system(top_file, traj_file, stride)
    heavy = top.get_heavy_inds()
    wat_inds, wat_h, len_wat = top.get_wat_inds(wat_res)
    sol_inds, *_ = top.get_sol_inds(wat_res)
    phobic = top.get_phobic_inds()
    philic = top.get_philic_inds()

    heavy_row = {int(a): i for i, a in enumerate(heavy)}
    to_rows = lambda inds: np.array([heavy_row[int(a)] for a in inds if int(a) in heavy_row], int)
    sol_rows = to_rows(sol_inds)
    phobic_rows = to_rows(phobic)
    philic_rows = to_rows(philic)
    # heavy atoms of each solute atom's own residue (excluded from targets)
    sol_res_rows = []
    for a in sol_inds:
        res = top.res_ids[a]
        members = np.where((top.res_ids == res) & (top.elements != "H"))[0]
        sol_res_rows.append(set(to_rows(members).tolist()))

    bw = get_bound_wrap(top, traj, wat_res=wat_res, cutoff=cutoff,
                        hb_dist=hb_dist, hb_ang=hb_ang)

    F = traj.n_frames
    out = {k: np.zeros(F) for k in ("tot", "phobic", "philic", "bound", "wrap")}

    def tot_area(contacts, target_rows, with_total=False):
        tot_target = 0.0
        tot = 0.0
        for i, s in enumerate(sol_rows):
            row = contacts[s, :]
            tot += row.sum() / 2.0
            mask = np.zeros(len(row), bool)
            mask[target_rows] = True
            for r in sol_res_rows[i]:
                mask[r] = False
            tot_target += row[mask].sum() / 2.0
        return (tot_target, tot) if with_total else tot_target

    eng = _pick_engine(engine, len(heavy), traj.n_frames, "contacts")
    _log_engine_once("contact_area_calc", eng)
    batched = _contacts_frames_iter(
        eng, traj, heavy, sol_rows, mesh, chunk_frames
    )
    if eng == "device" and batched is None:
        from waterorderlib_tpu.surface.voronoi_device import voronoi_contacts_hybrid

    for t in range(F):
        pos = traj.positions[t].astype(np.float64)
        box_l = float(traj.boxes[t][0])
        if batched is not None:
            contacts, _, _, _, n_cert = next(batched)
            if t == 0:
                _log_engine_once(
                    "contact_area_calc.cert", "device",
                    f" ({n_cert}/{len(sol_rows)} solute cells device-certified"
                    f" on frame 0, frames batched"
                    + (f" over {int(mesh.devices.size)} devices" if mesh is not None else "")
                    + ")",
                )
        elif eng == "device":
            # only the solute atoms' contact rows are read below — restrict
            # the cell construction to them (~25x less work on solvated
            # systems; symmetrization fills their columns)
            contacts, _, _, _, n_cert = voronoi_contacts_hybrid(
                pos[heavy], box_l, len(heavy), rows=sol_rows
            )
            if t == 0:
                _log_engine_once(
                    "contact_area_calc.cert", "device",
                    f" ({n_cert}/{len(sol_rows)} solute cells device-certified"
                    " on frame 0)",
                )
        else:
            contacts, _, _, _ = voronoi_contacts(pos[heavy], box_l, len(heavy))
        bound_rows = to_rows(bw[t][0])
        wrap_rows = to_rows(bw[t][1])
        out["phobic"][t], out["tot"][t] = tot_area(contacts, phobic_rows, with_total=True)
        out["philic"][t] = tot_area(contacts, philic_rows)
        out["bound"][t] = tot_area(contacts, bound_rows)
        out["wrap"][t] = tot_area(contacts, wrap_rows)

    tot = out["tot"]
    safe_tot = np.where(tot > 0, tot, 1.0)
    fracs = {k: out[k] / safe_tot for k in ("phobic", "philic", "bound", "wrap")}
    ba = lambda v: blocks.block_average(v, seed=seed)
    tot_area_res = [float(np.mean(tot))] + [float(np.mean(out[k])) for k in ("phobic", "philic", "bound", "wrap")]
    tot_ci = [ba(tot)] + [ba(out[k]) for k in ("phobic", "philic", "bound", "wrap")]
    frac_res = [float(np.mean(fracs[k])) for k in ("phobic", "philic", "bound", "wrap")]
    frac_ci = [ba(fracs[k]) for k in ("phobic", "philic", "bound", "wrap")]
    return tot_area_res, tot_ci, frac_res, frac_ci


def hydrated_volume_calc(
    top_file,
    traj_file,
    wat_res: str = "WAT",
    stride: int = 1,
    seed: int | None = 0,
    engine: str = "auto",
    mesh=None,
    chunk_frames: int | None = None,
):
    """Completed hydratedVolumeCalc (the reference's is WIP,
    orderParam_lib.py:1113-1267): per-frame total Voronoi cell volume and
    exposed (water-facing) area of the solute heavy atoms. Returns
    ([mean vol, CI], [mean water-exposed area, CI]).

    mesh / chunk_frames: frames-DP batching of the device tier-1 cells,
    exactly as in `contact_area_calc`."""
    top, traj = _resolve_system(top_file, traj_file, stride)
    heavy = top.get_heavy_inds()
    sol_inds, *_ = top.get_sol_inds(wat_res)
    heavy_row = {int(a): i for i, a in enumerate(heavy)}
    sol_rows = np.array([heavy_row[int(a)] for a in sol_inds], int)
    F = traj.n_frames
    vols = np.zeros(F)
    areas = np.zeros(F)
    eng = _pick_engine(engine, len(heavy), F, "contacts")
    _log_engine_once("hydrated_volume_calc", eng)
    batched = _contacts_frames_iter(
        eng, traj, heavy, sol_rows, mesh, chunk_frames
    )
    if eng == "device" and batched is None:
        from waterorderlib_tpu.surface.voronoi_device import voronoi_contacts_hybrid
    for t in range(F):
        pos = traj.positions[t].astype(np.float64)
        box_l = float(traj.boxes[t][0])
        if batched is not None:
            contacts, atom_area, wat_area, atom_vol, _ = next(batched)
        elif eng == "device":
            contacts, atom_area, wat_area, atom_vol, _ = voronoi_contacts_hybrid(
                pos[heavy], box_l, len(heavy), rows=sol_rows
            )
        else:
            contacts, atom_area, wat_area, atom_vol = voronoi_contacts(
                pos[heavy], box_l, len(heavy)
            )
        vols[t] = atom_vol[0, sol_rows].sum()
        areas[t] = wat_area[0, sol_rows].sum()
    return blocks.mean_and_ci(vols, seed=seed), blocks.mean_and_ci(areas, seed=seed)
