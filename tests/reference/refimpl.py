"""Pure-numpy reference implementations for golden tests.

Written fresh from the documented semantics of the reference library
(/root/reference/fortran/waterlib.f90 and
/root/reference/structureLibs/water_properties.py) — NOT copied — these are
straight-line float64 numpy translations of the *math*, kept deliberately
simple and loop-free where possible so they are easy to audit. They serve as
the trusted oracle that the device code is tested against.
"""

from __future__ import annotations

import numpy as np


def minimum_image(disp, box):
    box = np.asarray(box, dtype=np.float64)
    ibox = np.where(box > 0, 1.0 / np.where(box > 0, box, 1.0), 0.0)
    return disp - box * np.round(disp * ibox)


def dist_sq_matrix(sub, pos, box):
    d = minimum_image(sub[:, None, :] - pos[None, :, :], box)
    return np.sum(d * d, axis=-1)


def near_neighbors(sub, pos, box, low, high):
    """waterlib.f90:710-743 — boolean (Ns, N), (low, high] on distance."""
    dsq = dist_sq_matrix(sub, pos, box)
    return (dsq > low * low) & (dsq <= high * high)


def all_near_neighbors(pos, box, low, high):
    """waterlib.f90:830-862 — symmetric, zero diagonal."""
    m = near_neighbors(pos, pos, box, low, high)
    np.fill_diagonal(m, False)
    return m


def reimage(pos, ref, box):
    return ref + minimum_image(pos - ref, box)


def tetra_cos_ang(ref, neigh, box):
    """waterlib.f90:867-895 — symmetric (K, K) angle matrix in degrees."""
    k = len(neigh)
    rel = minimum_image(neigh - ref[None, :], box)
    out = np.zeros((k, k))
    for i in range(k):
        for j in range(i + 1, k):
            u, v = rel[i], rel[j]
            nn = np.sqrt(np.dot(u, u) * np.dot(v, v))
            if nn == 0:
                a = 0.0
            else:
                a = np.degrees(np.arccos(np.clip(np.dot(u, v) / nn, -1.0, 1.0)))
            out[i, j] = out[j, i] = a
    return out


def get_cos_angs(sub, pos, box, low=0.0, high=3.413):
    """water_properties.py:210-250 — ragged angle list + neighbor counts."""
    if sub.shape == pos.shape and np.array_equal(sub, pos):
        nn = all_near_neighbors(pos, box, low, high)
    else:
        nn = near_neighbors(sub, pos, box, low, high)
    ang_vals = []
    num_angs = np.zeros(len(sub))
    for i, apos in enumerate(sub):
        neigh = pos[nn[i]]
        if len(neigh) > 0:
            mat = tetra_cos_ang(apos, neigh, box)
            iu = np.triu_indices(len(mat), k=1)
            ang_vals.extend(mat[iu].tolist())
            num_angs[i] = mat.shape[0]
    return np.array(ang_vals), num_angs


def order_param_q(sub, pos, box, low=0.0, high=10.0):
    """water_properties.py:344-391 including the 180-degree padding rules."""
    if sub.shape == pos.shape and np.array_equal(sub, pos):
        nn = all_near_neighbors(pos, box, low, high)
    else:
        nn = near_neighbors(sub, pos, box, low, high)
    q = np.zeros(len(sub))
    for i, apos in enumerate(sub):
        c = int(np.sum(nn[i]))
        if c == 0:
            continue
        neigh = reimage(pos[nn[i]], apos, box)
        dists = np.linalg.norm(neigh - apos, axis=1)
        four = neigh[np.argsort(dists)][:4]
        mat = tetra_cos_ang(apos, four, box)
        angs = mat[np.triu_indices(len(mat), k=1)]
        if c == 1:
            angs = 180.0 * np.ones(6)
        elif c == 2:
            angs = np.concatenate([angs, 180.0 * np.ones(5)])
        elif c == 3:
            angs = np.concatenate([angs, 180.0 * np.ones(3)])
        q[i] = 1.0 - (3.0 / 8.0) * np.sum((np.cos(np.radians(angs)) + 1.0 / 3.0) ** 2)
    return q


def order_param_psi(sub, pos, box, low=0.0, high=10.0, max_neighbors=None):
    """water_properties.py:393-433. With `max_neighbors`, only that many
    nearest members of each shell count (the candidate cap of a top-K
    search)."""
    if sub.shape == pos.shape and np.array_equal(sub, pos):
        nn = all_near_neighbors(pos, box, low, high)
    else:
        nn = near_neighbors(sub, pos, box, low, high)
    psi = np.zeros(len(sub))
    for i, apos in enumerate(sub):
        if np.sum(nn[i]) > 1:
            neigh = pos[nn[i]]
            if max_neighbors is not None and len(neigh) > max_neighbors:
                d = minimum_image(neigh - apos, box)
                neigh = neigh[np.argsort(np.sum(d * d, axis=-1), kind="stable")[:max_neighbors]]
            mat = tetra_cos_ang(apos, neigh, box)
            angs = mat[np.triu_indices(len(mat), k=1)]
            z = np.mean(np.exp(6j * np.radians(angs)))
            psi[i] = np.sqrt((z * np.conjugate(z)).real)
    return psi


def lsi(sub, pos, box, low=0.0, high=3.7):
    """water_properties.py:252-311 incl. the raw-distance argmin quirk."""
    if sub.shape == pos.shape and np.array_equal(sub, pos):
        near = all_near_neighbors(pos, box, low, high)
        nxt = all_near_neighbors(pos, box, high, high + 3.7)
    else:
        near = near_neighbors(sub, pos, box, low, high)
        nxt = near_neighbors(sub, pos, box, high, high + 3.7)
    vals, valid, counts = [], np.zeros(len(sub), bool), np.zeros(len(sub), int)
    for i, apos in enumerate(sub):
        if np.sum(near[i]) <= 1 or np.sum(nxt[i]) == 0:
            continue
        next_pos = pos[nxt[i]]
        raw = np.sqrt(np.sum((next_pos - apos) ** 2, axis=1))  # no PBC (quirk)
        stacked = np.vstack([pos[near[i]], next_pos[np.argmin(raw)]])
        d = np.linalg.norm(minimum_image(stacked - apos, box), axis=1)
        d = np.sort(d)
        gaps = d[1:] - d[:-1]
        vals.append(np.var(gaps))
        valid[i] = True
        counts[i] = len(gaps)
    return np.array(vals), valid, counts


def radial_dist_counts(pos1, pos2, box, binwidth, nbins, same=False):
    """Counts with ceiling(dist/binwidth) binning (waterlib.f90:219)."""
    counts = np.zeros(nbins)
    if same:
        dsq = dist_sq_matrix(pos1, pos1, box)
        iu = np.triu_indices(len(pos1), k=1)
        dists = np.sqrt(dsq[iu])
    else:
        dists = np.sqrt(dist_sq_matrix(pos2, pos1, box)).ravel()
    nbin = np.ceil(dists / binwidth).astype(int)
    for b in nbin:
        if 1 <= b <= nbins:
            counts[b - 1] += 1
    return counts


def radial_dist(pos1, pos2, box, binwidth, nbins, bulk_dens=1.0, same=False):
    """waterlib.f90:193-231 / :316-353 normalization."""
    counts = radial_dist_counts(pos1, pos2, box, binwidth, nbins, same=same)
    n = len(pos1)
    k = np.arange(1, nbins + 1, dtype=float)
    shell = (4.0 / 3.0) * np.pi * binwidth**3 * (k**3 - (k - 1) ** 3)
    return counts / (n * bulk_dens * shell)


def general_hbonds(acc_pos, don_pos, donh_pos, box, dist_cut, ang_cut):
    """waterlib.f90:1156-1210 — boolean (Nacc, Ndon) H-bond matrix, one
    acceptor at a time (vectorised over the donors)."""
    dv2 = minimum_image(don_pos - donh_pos, box)
    dv2 = dv2 / np.linalg.norm(dv2, axis=-1, keepdims=True)
    out = np.zeros((len(acc_pos), len(don_pos)), dtype=bool)
    for i, a in enumerate(acc_pos):
        dv = minimum_image(don_pos - a, box)
        dsq = np.sum(dv * dv, axis=-1)
        av = minimum_image(a - donh_pos, box)
        with np.errstate(invalid="ignore", divide="ignore"):
            av = av / np.linalg.norm(av, axis=-1, keepdims=True)
        ang = np.degrees(np.arccos(np.clip(np.sum(av * dv2, axis=-1), -1.0, 1.0)))
        out[i] = (dsq <= dist_cut * dist_cut) & (dsq > 1.0e-2) & (ang >= ang_cut)
    return out


def hbonds_per_water(top, pos, box, dist_cut=3.5, ang_cut=120.0):
    """H-bonds of each water on one frame (float64): water-water bonds it
    accepts or donates (through either hydrogen), plus its bonds with the
    solute's O/N donors and acceptors."""
    from waterorderlib_tpu.drivers.hbonds_driver import _sol_hb_triplets

    wat = top.get_wat_inds()[0]
    nw = len(wat)

    def hb(a, d, dh):
        return general_hbonds(pos[a], pos[d], pos[dh], box, dist_cut, ang_cut)

    acc, don, donh = top.get_hb_inds(np.array([], int), wat)[0]
    ww = hb(acc, don, donh)
    tot = ww.sum(axis=1) + ww.sum(axis=0).reshape(nw, 2).sum(axis=1)
    _, hb_o, hb_n = _sol_hb_triplets(top)
    for s_acc, s_don, s_donh in (hb_o, hb_n):
        if len(s_don):
            tot = tot + hb(acc, s_don, s_donh).sum(axis=1)
        if len(s_acc):
            tot = tot + hb(s_acc, don, donh).sum(axis=0).reshape(nw, 2).sum(axis=1)
    return tot


def tetrahedral_metrics(ang_vals, n_bins=500, bin_range=(0.0, 180.0)):
    """water_properties.py:314-342."""
    hist, bins = np.histogram(ang_vals, bins=n_bins, range=bin_range, density=False)
    tet = ang_vals[(ang_vals >= 100.0) & (ang_vals <= 120.0)]
    frac = float(len(tet)) / float(len(ang_vals))
    avg = np.mean(np.cos(np.radians(tet)))
    var = np.var(np.cos(np.radians(tet)))
    dens = hist / float(np.sum(hist))
    dens = dens[dens != 0]
    entropy = -np.sum(dens * np.log(dens))
    return hist, bins, frac, avg, var, entropy
