"""Device-side Voronoi cells via fixed-shape plane-triple enumeration.

Device replacement for the host Qhull tessellation behind
`voronoi_volumes` (/root/reference/structureLibs/orderParam_lib.py:920-962)
and `voronoi_contacts` (/root/reference/structureLibs/surface_library.py:245-307),
planned in SURVEY.md §7.6. The host path (surface/voronoi.py) remains the
oracle and the fallback for uncertified atoms.

Design (no Qhull, no raggedness — everything is fixed-shape jnp):

1. The reference's mirror construction is kept verbatim: the candidate set
   is the original points plus their single-axis reflections across the
   nearer box face (orderParam_lib.py:926-950). A point's own reflection
   yields a bisector exactly on the box face, so every cell is closed.
2. For each of the first `num` points, take the K nearest candidates
   (`ops.pairs.topk_neighbors` with PBC disabled — the mirrored set lives in
   open space). The cell of a point is the intersection of the half-spaces
   x·r_k <= |r_k|^2/2 over relative candidate positions r_k.
3. Cell edges come from 1-D line clipping (the default `clip` builder):
   each of the C(K,2) plane pairs' intersection lines is clipped against
   all K half-spaces; the feasible parameter interval IS the edge and its
   endpoints ARE the cell's vertices (every vertex lies on >= 3 pair
   lines). O(C(K,2)*K) work — the previous `triple` builder (kept under
   `cell_impl="triple"`) enumerates all C(K,3) plane-triple vertices
   (closed-form Cramer) and selects each pair's extreme valid vertices:
   O(C(K,3)*K), ~K/3-fold more arithmetic and far larger intermediates.
5. Face polygons are never ordered: each face's vector area is accumulated
   from locally-oriented edge triangles (apex at the face's plane point
   r_f/2). The orientation of an edge shared with face j is fixed by
   requiring the polygon interior to lie away from plane j — a purely local
   sign test, so no sorting anywhere.
6. Per-atom exactness certificate: the cell is provably unaffected by any
   candidate beyond the K-th iff d_K >= 2*R_cell (R_cell = max vertex
   distance). Additional guards reject degenerate vertices (>= 4 coincident
   planes, e.g. perfect lattices) and non-closed surfaces (sum of face
   vector areas must vanish). Uncertified atoms fall back to a per-atom
   host half-space intersection, then to the full host tessellation.

Complexity per atom is O(C(K,2)*K) dense fused arithmetic — at K=32 about
0.3 MFLOP, so a 12k-atom frame is ~4 GFLOP of vectorizable work instead of
a serial Qhull run (the `triple` builder: ~1.4 MFLOP/atom).
"""

from __future__ import annotations

import itertools
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from waterorderlib_tpu.ops import pairs as ops_pairs

# A "box" so large that minimum-image wrapping is a no-op: the mirrored
# candidate set must be searched in open space.
_NO_PBC_BOX = 3.0e18
# Far parking distance for unused candidate slots (mirror set is always
# >= 3 points, so slots only go unused for tiny inputs).
_FAR = 1.0e6


@lru_cache(maxsize=8)
def _pair_tables(k: int):
    """Static pair-level index tables for K planes: pairs, pairs-per-face,
    and the opposing face of each pair — all the clip builder needs (the
    triple tables cost O(K^3) host work, prohibitive at the K=96/128
    rescue tiers)."""
    prs = np.array(list(itertools.combinations(range(k), 2)), np.int32)
    face_pairs = np.zeros((k, k - 1), np.int32)
    face_other = np.zeros((k, k - 1), np.int32)
    cnt = np.zeros(k, np.int64)
    for p, (i, j) in enumerate(prs):
        face_pairs[i, cnt[i]] = p
        face_other[i, cnt[i]] = j
        cnt[i] += 1
        face_pairs[j, cnt[j]] = p
        face_other[j, cnt[j]] = i
        cnt[j] += 1
    return prs, face_pairs, face_other


@lru_cache(maxsize=8)
def _tables(k: int):
    """Static index tables for K planes: triples, pairs, triples-per-pair,
    and pairs-per-face (+ the opposing face of each pair). The pair-level
    tables are shared with the clip builder via _pair_tables."""
    prs, face_pairs, face_other = _pair_tables(k)
    tri = np.array(list(itertools.combinations(range(k), 3)), np.int32)
    pair_id = {(int(i), int(j)): p for p, (i, j) in enumerate(prs)}
    pair_tri = np.zeros((len(prs), k - 2), np.int32)
    fill = np.zeros(len(prs), np.int64)
    for t, (a, b, c) in enumerate(tri):
        for ij in ((a, b), (a, c), (b, c)):
            p = pair_id[(int(ij[0]), int(ij[1]))]
            pair_tri[p, fill[p]] = t
            fill[p] += 1
    return tri, prs, pair_tri, face_pairs, face_other


@lru_cache(maxsize=8)
def _park_directions(k: int) -> np.ndarray:
    """Distinct unit directions (golden spiral) to park unused slots on, so
    parked planes are never near-parallel (which would break the det test)."""
    i = np.arange(k) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / k)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)], -1
    )


def mirror_points_device(points: jnp.ndarray, box_l) -> jnp.ndarray:
    """points followed by their nearer-face reflections per axis — the
    reference's boundary treatment (orderParam_lib.py:926-950) with no
    margin pruning (fixed shape: exactly 4P candidates)."""
    box_l = jnp.asarray(box_l, points.dtype)
    hi = points >= 0.5 * box_l
    near = jnp.where(hi, 2.0 * box_l - points, -points)
    out = [points]
    for ax in range(3):
        out.append(points.at[:, ax].set(near[:, ax]))
    return jnp.concatenate(out, axis=0)


def _suggest_win_subset(
    n_real: int, box_l: float, k_search: int, n_rows: int
) -> int:
    """Window size for an ESCALATION subset's top-K search (full 4P mirror
    set). The subset's rows are scattered over the box, so each z-sorted
    128-row search block spans ~128/n_rows of the z range; the window must
    cover that span plus the 2*1.6*d_K reach on each side. Returns 0 (full
    scan) when the window would not actually shrink the scan.

    Replaces the previous always-full-scan escalation policy, which made
    the ladder — not tier-1 — the dominant e2e cost at 12k (lax.top_k over
    all 49k candidates at k_search=96..256 for every tier)."""
    if n_real <= 0 or box_l <= 0:
        return 0
    rho = n_real / box_l**3
    d_k = (3.0 * k_search / (4.0 * np.pi * max(rho, 1e-12))) ** (1.0 / 3.0)
    span = min(1.0, 128.0 / max(n_rows, 128))
    frac = min(1.0, span + 2.0 * 1.6 * d_k / box_l)
    p4 = 4 * n_real
    slab = n_real + (2.0 / 3.0) * (p4 - n_real)
    win = int(-(-(1.07 * slab * frac) // 128) * 128)
    if win >= 0.75 * p4:
        return 0
    return win


def _quantize_win(win: int, p4: int) -> int:
    """Round an escalation-window suggestion UP to a coarse p4/16 grid
    (512-aligned) and veto it when it no longer shrinks the scan. `win`
    feeds a jit-static shape: the raw suggestion varies with every frame's
    uncertified count, and each distinct value is a fresh compile (a
    512-grid quantization still admitted dozens of values). The p4/16 grid
    bounds distinct shapes per (N, tier) at <= 12 for <= 6% overscan of the
    subset search."""
    if win <= 0:
        return 0
    step = max(512, -(-(p4 // 16) // 512) * 512)
    q = -(-win // step) * step
    if q >= 0.75 * p4:
        return 0
    return q


def _suggest_mirror_budget(n_real: int, box_l: float, k_search: int) -> int:
    """Mirror-slot budget for `mirror_points_pruned`, or 0 to keep the full
    4P set. Sized so the effective margin (depth of the shallowest EXCLUDED
    mirror) lands around 1.35x the expected k_search-th neighbor distance —
    comfortably above 2*R_cell for every liquid-like cell, so pruning costs
    certificates only on cells the escalation ladder already handles."""
    if n_real <= 0 or box_l <= 0:
        return 0
    rho = n_real / box_l**3
    d_k = (3.0 * k_search / (4.0 * np.pi * max(rho, 1e-12))) ** (1.0 / 3.0)
    frac = min(1.0, 2.0 * 1.35 * d_k / box_l)
    m = int(-(-(3.0 * n_real * frac) // 128) * 128)
    # pruning must buy a real reduction to be worth the certificate risk
    if m >= 0.7 * 3 * n_real:
        return 0
    return m


def mirror_points_pruned(points: jnp.ndarray, box_l, budget: int):
    """Pruned mirror construction: points followed by the `budget`
    shallowest of the 3P single-axis reflections (depth = the source
    point's distance from the reflecting face, which lower-bounds the
    mirror's distance from EVERY in-box point).

    Returns (ext (P+budget, 3), ext_map (P+budget,) int32 mapping each slot
    to its index in the FULL 4P `mirror_points_device` layout, margin_eff) —
    margin_eff is the depth of the deepest selected mirror, so every
    excluded mirror lies at distance >= margin_eff from every in-box point:
    a cell with 2*R_cell <= margin_eff is provably unaffected by the
    exclusions (same argument as the d_K >= 2*R_cell certificate).
    """
    box_l = jnp.asarray(box_l, points.dtype)
    p_real = points.shape[0]
    hi = points >= 0.5 * box_l
    near = jnp.where(hi, 2.0 * box_l - points, -points)
    depth = jnp.minimum(points, box_l - points)  # (P, 3) per-axis face depth
    mirrors = [points.at[:, ax].set(near[:, ax]) for ax in range(3)]
    mir = jnp.concatenate(mirrors, axis=0)  # (3P, 3) — index ax*P + i
    dep = jnp.transpose(depth).reshape(-1)  # (3P,) matching ax*P + i
    neg_top, sel = jax.lax.top_k(-dep, budget)
    margin_eff = -neg_top[-1]
    ext = jnp.concatenate([points, mir[sel]], axis=0)
    ext_map = jnp.concatenate(
        [
            jnp.arange(p_real, dtype=jnp.int32),
            (p_real + sel).astype(jnp.int32),
        ]
    )
    return ext, ext_map, margin_eff


def _cell_moments(rel_all, slot_ok, k: int, eps: float):
    """Moments of one Voronoi cell.

    rel_all: (K_search, 3) relative candidate positions (nearest first);
    slot_ok: (K_search,) False for padding slots. The cell is built from the
    first `k` bisector planes; the remaining planes are only CHECKED — if
    any of them cuts the built cell, `extra_cut` is set and the cell is not
    certifiable. Returns a dict of per-cell quantities: vol, area,
    face_area (k,), face_nverts (k,), r_cell, flags.
    """
    tri, prs, pair_tri, face_pairs, face_other = _tables(k)
    dtype = rel_all.dtype
    ks = rel_all.shape[0]
    park = jnp.asarray(_park_directions(ks), dtype) * jnp.asarray(_FAR, dtype)
    rel_all = jnp.where(slot_ok[:, None], rel_all, park)
    rel = rel_all[:k]

    s_all = 0.5 * jnp.sum(rel_all * rel_all, axis=-1)  # (K_search,)
    s = s_all[:k]
    # Tolerances must scale with the magnitudes actually entering each
    # computation, NOT with min(s): a boundary atom's nearest candidate is
    # its own mirror at ~2x the face distance, which can be arbitrarily
    # close — a min-based scale then rejects genuine near-degenerate
    # vertices at f32 and silently drops small faces (observed: a certified
    # cell 1.5% small because two 0.1-0.3 A^2 faces lost their vertices).
    # s_scale keeps only the roles where a representative CELL size is
    # wanted (area floor); per-plane slack tests use operand-scaled
    # tolerances eps * (s_j + |X| |r_j|) below.
    s_med = jnp.nanmedian(jnp.where(slot_ok, s_all, jnp.nan))
    s_scale = jnp.where(jnp.isfinite(s_med), s_med, jnp.asarray(1.0, dtype))
    tol = jnp.asarray(eps, dtype) * s_scale

    ra, rb, rc = rel[tri[:, 0]], rel[tri[:, 1]], rel[tri[:, 2]]
    sa, sb, sc = s[tri[:, 0]], s[tri[:, 1]], s[tri[:, 2]]
    cbc = jnp.cross(rb, rc)
    cca = jnp.cross(rc, ra)
    cab = jnp.cross(ra, rb)
    det = jnp.sum(ra * cbc, axis=-1)  # (C,)
    nrm = lambda v: jnp.sqrt(jnp.sum(v * v, axis=-1))
    scale3 = nrm(ra) * nrm(rb) * nrm(rc)
    ok_det = jnp.abs(det) > jnp.asarray(eps, dtype) * scale3
    num = sa[:, None] * cbc + sb[:, None] * cca + sc[:, None] * cab
    X = num / jnp.where(ok_det, det, 1.0)[:, None]  # (C, 3)

    # HIGHEST: a default-precision f32 product may run with reduced-precision
    # multiplicands (bf16/TF32), which wrecks the slack tolerances
    slack_build = s[None, :] - jnp.matmul(
        X, rel.T, precision=jax.lax.Precision.HIGHEST
    )  # (C, k); >= 0 inside
    r_len = nrm(rel)
    xnorm = nrm(X)
    # operand-scaled slack tolerance: |slack| carries fp error ~ eps * the
    # magnitudes that formed it (s_j and X . r_j), not eps * min(s)
    tol_build = jnp.asarray(eps, dtype) * (
        s[None, :] + xnorm[:, None] * r_len[None, :]
    )  # (C, k)
    inside = jnp.all(slack_build >= -tol_build, axis=-1)
    vert_ok = ok_det & inside  # (C,)

    vnorm = nrm(X)  # (C,)
    r_cell = jnp.max(jnp.where(vert_ok, vnorm, 0.0))
    # does any beyond-build plane cut the built cell?
    slack_extra = s_all[None, k:] - jnp.matmul(
        X, rel_all[k:].T, precision=jax.lax.Precision.HIGHEST
    )  # (C, K_search - k)
    tol_extra = jnp.asarray(eps, dtype) * (
        s_all[None, k:] + vnorm[:, None] * nrm(rel_all[k:])[None, :]
    )
    extra_cut = jnp.any(vert_ok[:, None] & (slack_extra < -tol_extra))

    # edges, directly in triple space: a vertex lies on pair (i, j)'s line
    # iff both planes are among its 3 defining planes — and the triples
    # containing a given pair are the STATIC pair_tri table, so each pair
    # gathers its own k-2 candidate vertices instead of testing membership
    # over a compacted slot array. (Membership via geometric incidence was
    # tried and rejected: planes passing exactly through two non-adjacent
    # vertices of a face — common in lattices — collect them as a phantom
    # chord edge and corrupt the face area; the defining-triple test
    # implicitly requires a well-conditioned defining copy, which excludes
    # those.) This also removes the vertex-compaction stage entirely: no
    # per-cell top_k over the C(K,3) triples, no (V, P) extremes sweep
    # (k-2 candidates per pair instead), and no compaction-overflow veto —
    # degenerate lattice vertices arriving as hundreds of triple copies
    # are always representable. Endpoints are the extreme valid candidates
    # along the line direction r_i x r_j.
    pt = jnp.asarray(pair_tri)  # (P, k-2) static triple ids per pair
    Xp = X[pt]  # (P, k-2, 3)
    vp = vert_ok[pt]  # (P, k-2)
    tdir = jnp.cross(rel[prs[:, 0]], rel[prs[:, 1]])  # (P, 3)
    u = jnp.einsum(
        "pjc,pc->pj", Xp, tdir, precision=jax.lax.Precision.HIGHEST
    )  # (P, k-2)
    big = jnp.asarray(3.0e37, dtype)
    j_lo = jnp.argmin(jnp.where(vp, u, big), axis=1)  # (P,)
    j_hi = jnp.argmax(jnp.where(vp, u, -big), axis=1)
    v1 = jnp.take_along_axis(Xp, j_lo[:, None, None], axis=1)[:, 0]  # (P, 3)
    v2 = jnp.take_along_axis(Xp, j_hi[:, None, None], axis=1)[:, 0]
    edge_ok = jnp.sum(vp, axis=1) >= 2  # (P,)

    return _faces_from_edges(
        rel, r_len, v1, v2, edge_ok, r_cell, extra_cut, tol, s_scale, eps,
        face_pairs, face_other, dtype,
    )


def _faces_from_edges(
    rel, r_len, v1, v2, edge_ok, r_cell, extra_cut, tol, s_scale, eps,
    face_pairs, face_other, dtype,
):
    """Face areas, closure certificates, and cell moments from one cell's
    per-pair edge segments (shared tail of the triple-space and clip-space
    cell builders). v1/v2: (P, 3) edge endpoints per plane pair; edge_ok:
    (P,) which pairs carry a real segment."""
    nrm = lambda v: jnp.sqrt(jnp.sum(v * v, axis=-1))
    # per-face vector areas from locally oriented edge triangles
    V1 = v1[face_pairs]  # (K, K-1, 3)
    V2 = v2[face_pairs]
    eok = edge_ok[face_pairs]  # (K, K-1)
    rj = rel[face_other]  # (K, K-1, 3)
    tvec = V2 - V1

    # Mirror candidates make face-plane vertices exactly degenerate (a
    # candidate and its mirror partner are equidistant from any point on the
    # box face), so several plane pairs can carry the SAME geometric edge of
    # a face. Deduplicate per face by ENDPOINT IDENTITY: duplicate copies of
    # the same geometric edge differ only by the vertex-copy fp spread
    # (~eps * conditioning), whereas distinct short edges of a
    # near-degenerate vertex cluster differ by a physical micro-edge length.
    # (A sqrt(eps)-radius signature dedup was tried first and falsely merged
    # those cluster edges — certified cells came out 0.5% small with faces
    # losing 1-2 vertices each.)
    # cell-size scale (median candidate distance ~ 2x the typical face
    # distance) — NOT the min, which a boundary atom's own mirror collapses
    len_scale = jnp.sqrt(2.0 * s_scale)
    htol = 20.0 * jnp.asarray(eps, dtype) * len_scale
    tlen = nrm(tvec)
    eok = eok & (tlen > htol)  # zero-length point-touch "edges"
    close = lambda A, B: (
        jnp.max(jnp.abs(A[:, :, None, :] - B[:, None, :, :]), axis=-1) <= htol
    )  # (K, K-1, K-1): edge j's endpoint vs edge j''s endpoint
    dup = (close(V1, V1) & close(V2, V2)) | (close(V1, V2) & close(V2, V1))
    ne = eok.shape[1]
    earlier = np.tril(np.ones((ne, ne), bool), -1)  # j' < j
    taken = dup & earlier[None, :, :] & eok[:, None, :]
    eok = eok & ~jnp.any(taken, axis=-1)

    orient = jnp.einsum(
        "fek,fek->fe", jnp.cross(rel[:, None, :], tvec), rj,
        precision=jax.lax.Precision.HIGHEST,
    )  # >0 means v1->v2 is the wrong way round for face f
    sign = jnp.where(orient > 0, -1.0, 1.0).astype(dtype)
    q = 0.5 * rel  # a point on each face's plane
    civ = 0.5 * jnp.cross(V1 - q[:, None, :], V2 - q[:, None, :])
    w = jnp.where(eok, sign, 0.0)
    vec_area = jnp.sum(civ * w[:, :, None], axis=1)  # (K, 3)
    # per-face polygon closure: the signed edge vectors of a consistent
    # closed polygon cancel almost exactly (every vertex value enters once
    # +, once -); a lost or mis-extreme endpoint breaks the sum by ~ the
    # missing edge length. This catches face errors that the cell-level
    # vector-area closure misses when two faces err in compensating
    # directions (observed: 0.5% volume errors certifying at f32).
    face_gap = nrm(jnp.sum(tvec * w[:, :, None], axis=1))  # (K,)
    nhat = rel / r_len[:, None]
    raw_area = jnp.sum(vec_area * nhat, axis=-1)  # (K,) signed
    # a real face has a closed polygon: >= 3 edges
    nedges_raw = jnp.sum(eok, axis=-1)  # (K,) edge count == vertex count
    face_real = (nedges_raw >= 3) & (raw_area > tol)
    face_area = jnp.where(face_real, raw_area, 0.0)
    face_nverts = jnp.where(face_real, nedges_raw, 0)

    area = jnp.sum(face_area)
    vol = jnp.sum(face_area * r_len) / 6.0  # sum A_f * (|r_f|/2) / 3
    closure = nrm(jnp.sum(jnp.where(face_real[:, None], vec_area, 0.0), axis=0))
    # the vector areas of a closed surface sum to zero; the tolerance scales
    # with eps because degenerate-edge endpoints carry conditioning noise.
    # The multiplier bounds the certifiable volume error: a dropped face
    # shows its whole vector area here, so closure <= 20*eps*area keeps
    # certified f32 cells within ~0.2% of exact (100*eps let 0.6% errors
    # certify — observed on a liquid box)
    closure_tol = jnp.maximum(
        jnp.asarray(20.0 * eps, dtype), jnp.asarray(1e-6, dtype)
    )
    closed = closure <= closure_tol * jnp.maximum(area, jnp.asarray(1e-6, dtype))
    # phantom "faces" (a plane touching the cell only along an edge or a
    # vertex) keep < 3 edges and carry junk signed areas; they are excluded
    # from the cell, so only >=3-edge faces can veto via negativity
    any_negative = jnp.any(
        (nedges_raw >= 3) & (raw_area < -jnp.sqrt(tol) * jnp.maximum(area, 1.0))
    )
    # dedup junctions join endpoint copies that agree to htol, so a genuine
    # polygon's gap is bounded by a few htol; anything larger is a broken
    # face (a lost vertex breaks the sum by ~ the missing edge length)
    face_open = jnp.any(face_real & (face_gap > 8.0 * htol))
    ok_shape = (
        closed & ~any_negative & (vol > 0) & ~extra_cut & ~face_open
    )
    return {
        "vol": vol,
        "area": area,
        "face_area": face_area,
        "face_nverts": face_nverts.astype(jnp.int32),
        "r_cell": r_cell,
        "ok_shape": ok_shape,
        "closure_err": closure,
        "extra_cut": extra_cut,
        "neg_face": any_negative,
    }


def _cell_moments_clip(rel_all, slot_ok, k: int, eps: float):
    """Moments of one Voronoi cell by 1-D line clipping — O(P*K) instead of
    the triple builder's O(C(K,3)*K).

    Same contract as `_cell_moments`. Instead of enumerating all C(K,3)
    plane-triple vertices and selecting each pair's extremes among them,
    each of the C(K,2) plane pairs' intersection LINES is clipped against
    all K build half-spaces in one dimension: plane j restricts the line
    parameter u to one side of b_j/a_j (a_j = t_hat . r_j,
    b_j = s_j - q . r_j, with q a point on the line and t_hat its unit
    direction). The feasible interval [u_lo, u_hi] IS the cell edge; its
    endpoints ARE the cell's vertices (every vertex lies on >= 3 pair
    lines, so the vertex set is exactly the endpoint set). Tangent planes
    through a face edge duplicate that edge across pairs — removed by the
    same endpoint-identity dedup as the triple builder (a supporting plane
    through two vertices of a convex face must contain a face EDGE, so
    phantom interior chords cannot arise). Planes k..K_search are
    check-only, exactly as in `_cell_moments`: a beyond-build plane cuts
    the built cell iff it cuts some vertex, and all vertices are feasible
    endpoints, so `extra_cut` tests every feasible endpoint against them.
    """
    prs, face_pairs, face_other = _pair_tables(k)
    dtype = rel_all.dtype
    ks = rel_all.shape[0]
    park = jnp.asarray(_park_directions(ks), dtype) * jnp.asarray(_FAR, dtype)
    rel_all = jnp.where(slot_ok[:, None], rel_all, park)
    rel = rel_all[:k]
    s_all = 0.5 * jnp.sum(rel_all * rel_all, axis=-1)
    s = s_all[:k]
    # same representative-scale logic as _cell_moments (see comment there)
    s_med = jnp.nanmedian(jnp.where(slot_ok, s_all, jnp.nan))
    s_scale = jnp.where(jnp.isfinite(s_med), s_med, jnp.asarray(1.0, dtype))
    tol = jnp.asarray(eps, dtype) * s_scale
    nrm = lambda v: jnp.sqrt(jnp.sum(v * v, axis=-1))
    r_len_all = nrm(rel_all)
    r_len = r_len_all[:k]

    ri, rj = rel[prs[:, 0]], rel[prs[:, 1]]  # (P, 3)
    si, sj = s[prs[:, 0]], s[prs[:, 1]]
    t = jnp.cross(ri, rj)
    tsq = jnp.sum(t * t, axis=-1)
    pair_ok = jnp.sqrt(tsq) > jnp.asarray(eps, dtype) * nrm(ri) * nrm(rj)
    tsq_safe = jnp.where(pair_ok, tsq, 1.0)
    # q: the point of the line in span(r_i, r_j) — q.r_i = s_i, q.r_j = s_j
    q = (
        si[:, None] * jnp.cross(rj, t) + sj[:, None] * jnp.cross(t, ri)
    ) / tsq_safe[:, None]
    that = t / jnp.sqrt(tsq_safe)[:, None]  # unit direction: u in length units

    # line-vs-plane coefficients for ALL K_search planes at once; build
    # planes clip, extra planes only check. HIGHEST: see _cell_moments.
    A = jnp.matmul(that, rel_all.T, precision=jax.lax.Precision.HIGHEST)
    B = s_all[None, :] - jnp.matmul(
        q, rel_all.T, precision=jax.lax.Precision.HIGHEST
    )  # (P, K_search)
    qn = nrm(q)
    athr = jnp.asarray(eps, dtype) * r_len_all[None, :]  # |t_hat| = 1
    tol_b = jnp.asarray(eps, dtype) * (
        s_all[None, :] + qn[:, None] * r_len_all[None, :]
    )

    big = jnp.asarray(3.0e37, dtype)
    Ab, Bb = A[:, :k], B[:, :k]
    denom_ok = jnp.abs(Ab) > athr[:, :k]
    ratio = Bb / jnp.where(denom_ok, Ab, 1.0)
    ub = jnp.where(denom_ok & (Ab > 0), ratio, big)
    lb = jnp.where(denom_ok & (Ab < 0), ratio, -big)
    # a plane (near-)parallel to the line either misses it (no constraint)
    # or excludes it entirely
    par_bad = ~denom_ok & (Bb < -tol_b[:, :k])
    u_hi = jnp.min(ub, axis=1)
    u_lo = jnp.max(lb, axis=1)
    feas = (
        pair_ok
        & ~jnp.any(par_bad, axis=1)
        & (u_hi < 0.5 * big)
        & (u_lo > -0.5 * big)
        & (u_hi >= u_lo)
    )
    v1 = q + u_lo[:, None] * that  # (P, 3)
    v2 = q + u_hi[:, None] * that
    vmax = jnp.maximum(nrm(v1), nrm(v2))
    r_cell = jnp.max(jnp.where(feas, vmax, 0.0))

    # beyond-build planes vs every feasible endpoint (== every vertex)
    s1 = B[:, k:] - u_lo[:, None] * A[:, k:]
    s2 = B[:, k:] - u_hi[:, None] * A[:, k:]
    tol_e = jnp.asarray(eps, dtype) * (
        s_all[None, k:] + vmax[:, None] * r_len_all[None, k:]
    )
    extra_cut = jnp.any(feas[:, None] & ((s1 < -tol_e) | (s2 < -tol_e)))

    return _faces_from_edges(
        rel, r_len, v1, v2, feas, r_cell, extra_cut, tol, s_scale, eps,
        face_pairs, face_other, dtype,
    )


_CELL_BUILDERS = {"triple": _cell_moments, "clip": _cell_moments_clip}
# clip is the default: same certificates, ~C(K,3)/C(K,2)-fold less work
DEFAULT_CELL_IMPL = "clip"


@partial(jax.jit, static_argnames=("k_search", "row_block", "win"))
def _windowed_topk(centers, ext, k_search, row_block, win):
    """K-nearest mirrored candidates via a z-sorted sliding window.

    Centers are processed in z-sorted blocks; each block scans one
    contiguous `win`-candidate slice of the z-sorted mirror set instead of
    all 4P candidates. Per-row coverage certificate: the window's z extent
    must reach at least d_K beyond the center on each side (or hit the
    array end — the mirror set is NOT z-periodic, so no wrap is needed).

    Returns (dist (num, K), idx (num, K) into ext, valid, covered (num,)).
    """
    p4 = ext.shape[0]
    orde = jnp.argsort(ext[:, 2])
    exts = ext[orde]
    ez = exts[:, 2]
    num = centers.shape[0]
    ordc = jnp.argsort(centers[:, 2])
    cs = centers[ordc]
    pad = (-num) % row_block
    if pad:
        cs = jnp.concatenate([cs, jnp.repeat(cs[-1:], pad, axis=0)], axis=0)

    def one_block(blk):  # (rb, 3)
        rb = blk.shape[0]
        z_mid = blk[rb // 2, 2]
        start = jnp.clip(
            jnp.searchsorted(ez, z_mid) - win // 2, 0, p4 - win
        ).astype(jnp.int32)
        cand = jax.lax.dynamic_slice(
            exts, (start, jnp.zeros((), start.dtype)), (win, 3)
        )  # (win, 3)
        d = blk[:, None, :] - cand[None, :, :]
        dsq = jnp.sum(d * d, axis=-1)  # (rb, win)
        masked = jnp.where(dsq > 0.0, dsq, jnp.inf)  # self-exclusion
        neg_top, li = jax.lax.top_k(-masked, k_search)
        top_dsq = -neg_top
        slot_ok = jnp.isfinite(top_dsq)
        dist = jnp.sqrt(jnp.where(slot_ok, top_dsq, jnp.inf))
        gidx = orde[start + jnp.where(slot_ok, li, 0)]
        d_far = dist[:, -1]
        d_far = jnp.where(jnp.isfinite(d_far), d_far, 0.0)
        covered = (
            ((blk[:, 2] - ez[start] >= d_far) | (start == 0))
            & ((ez[start + win - 1] - blk[:, 2] >= d_far) | (start + win == p4))
            # a partially-filled slot list means candidates beyond the
            # window's z extent were never seen — not coverable
            & jnp.all(slot_ok, axis=-1)
        )
        return dist, gidx.astype(jnp.int32), slot_ok, covered

    blocks = cs.reshape(-1, row_block, 3)
    dist, idx, valid, covered = jax.lax.map(one_block, blocks)
    unblk = lambda x: x.reshape((-1,) + x.shape[2:])[:num]
    # scatter back to the original center order
    inv = jnp.zeros(num, jnp.int32).at[ordc].set(jnp.arange(num, dtype=jnp.int32))
    return (
        unblk(dist)[inv], unblk(idx)[inv], unblk(valid)[inv], unblk(covered)[inv]
    )


def _suggest_win(n_real: int, p4: int, box_l: float, k_search: int) -> int:
    """Window size covering ~2.7x the expected K_search-th neighbor distance
    in z on each side (x/y mirrors of in-slab points share their z, hence
    the 3x multiplier on the in-slab count)."""
    if n_real <= 0 or box_l <= 0:
        return p4
    rho = n_real / box_l**3
    d_k = (3.0 * k_search / (4.0 * np.pi * max(rho, 1e-12))) ** (1.0 / 3.0)
    # 1.6x headroom over the mean d_K: rows whose window coverage still
    # fails are rescued by the tier ladder, so the safety factor trades a
    # few escalations for a much smaller scan
    frac = min(1.0, 2.0 * 1.6 * d_k / box_l)
    # expected candidates in a z-slab of fractional thickness `frac`:
    # originals + the x/y mirrors (which share their source's z — about
    # 2/3 of the mirror population, pruned or not), with a 7% fudge for
    # the z-face mirror pile-up; for the full 4P set this reduces to the
    # measured 3.2 * n_real coefficient
    slab_density = n_real + (2.0 / 3.0) * max(p4 - n_real, 0)
    win = int(-(-(1.07 * slab_density * frac) // 128) * 128)
    win = max(win, min(p4, 1024))
    # a window covering most of the set saves nothing and only risks
    # coverage vetoes — scan everything instead
    if win >= 0.75 * p4:
        return p4
    return win


def _suggest_cellgrid(
    n_real: int, box_l: float, k_search: int, s_factor: float = 1.12
):
    """(n_side, cap) for the 3-D cell-grid candidate search, or None when a
    grid would not beat the z-window scan it replaces.

    The grid edge is sized at ~s_factor x the expected k_search-th neighbor
    distance, so a row's 27-cell neighborhood (27*cap lanes) provably covers
    its true top-K for all but density-tail rows (which the escalation
    ladder rescues, exactly as z-window coverage misses do). Lane count is
    density-, not N-, determined: at 131k atoms the z-window needs ~65k
    lanes per row, the grid still ~1.5k. cap carries ~6 Poisson sigmas of
    occupancy headroom — an overflowing cell coverage-vetoes every row whose
    neighborhood touches it, so headroom is cheap insurance."""
    if n_real < 3072 or box_l <= 0:
        return None
    rho = n_real / box_l**3
    d_k = (3.0 * k_search / (4.0 * np.pi * max(rho, 1e-12))) ** (1.0 / 3.0)
    n_side = int(box_l / (s_factor * d_k)) + 2
    if n_side < 5:
        return None  # grid coarser than ~3 cells across: no pruning to win
    s = box_l / (n_side - 2)
    occ = rho * s**3
    cap = int(-(-(occ + 6.0 * occ**0.5 + 4.0) // 8) * 8)
    win = _suggest_win(n_real, 4 * n_real, box_l, k_search)
    if 27 * cap >= 0.7 * win:
        return None
    return n_side, cap


def _cellgrid_build(ext, box_l, n_side: int, cap: int):
    """Bucket the mirrored candidate set into a per-cell position table.

    The grid covers [-s, box_l + s] with n_side cells per axis
    (s = box_l / (n_side - 2)); candidates outside it are DROPPED — every
    dropped candidate is provably > s from every in-box center, so the
    coverage certificate in `_cellgrid_topk` caps at s whenever any drop
    happened. Built entirely with sort + searchsorted + gathers (no
    scatters): after sorting by cell id, each cell's members are one
    contiguous run of the sorted array.

    Returns (tbl (n_cells, 4*cap) — per cell the planes [x, y, z, idx]
    (idx as dtype float, exact below 2^24; empty slots park at +inf / -1),
    overflow (n_cells,) bool — cells with more than cap members,
    dropped () bool — any candidate outside the grid, s () — cell edge)."""
    dtype = ext.dtype
    n_cells = n_side**3
    p4 = ext.shape[0]
    s = jnp.asarray(box_l, dtype) / (n_side - 2)
    g = jnp.floor(ext / s).astype(jnp.int32) + 1  # grid origin is -s
    ing = jnp.all((g >= 0) & (g < n_side), axis=-1)
    cid = (g[:, 2] * n_side + g[:, 1]) * n_side + g[:, 0]
    cid = jnp.where(ing, cid, n_cells)  # sentinel: sorts to the tail
    order = jnp.argsort(cid)
    sc = cid[order]
    es = ext[order]
    cells = jnp.arange(n_cells, dtype=sc.dtype)
    start = jnp.searchsorted(sc, cells, side="left")
    count = jnp.searchsorted(sc, cells, side="right") - start
    overflow = count > cap
    src = jnp.clip(start[:, None] + jnp.arange(cap)[None, :], 0, p4 - 1)
    okslot = jnp.arange(cap)[None, :] < count[:, None]  # (n_cells, cap)
    pos_s = es[src]  # (n_cells, cap, 3)
    idx_s = order[src]
    inf = jnp.asarray(jnp.inf, dtype)
    planes = [jnp.where(okslot, pos_s[..., a], inf) for a in range(3)]
    planes.append(jnp.where(okslot, idx_s.astype(dtype), -1.0))
    tbl = jnp.stack(planes, axis=1).reshape(n_cells, 4 * cap)
    dropped = jnp.any(sc >= n_cells)
    return tbl, overflow, dropped, s


def _cellgrid_topk(centers, ext, box_l, k_search, row_block, n_side, cap):
    """K-nearest mirrored candidates via a 3-D cell grid — the algorithmic
    replacement for `_windowed_topk`'s z-slab scan (same contract).

    The bucketed table is expanded to `tbl27`: one row per cell holding its
    FULL pre-assembled 27-cell neighborhood (27 statically-shifted copies —
    27 contiguous rolls, ~0.1 ms), so each center's candidate fetch is ONE
    contiguous-row gather. The round-5 ablation measured the previous
    per-row 9-slice vmapped-dynamic_slice gather at 104 ms of the 132 ms
    total at 12k (gather-op-bound, ~3 GB/s effective); single-row takes
    stream at memory bandwidth instead.

    The K-extraction is `lax.top_k` over each row's gathered lanes. Rows
    are processed in chunks so the gathered (4, rc, Lp) planes never
    exceed ~100 MB.

    Per-row coverage certificate: the 27-neighborhood covers the full L-inf
    ball of radius `reach` around the center (reach = distance to the
    gathered region's boundary, >= s for interior rows); the K-th distance
    must beat min(reach, s-if-any-candidate-was-dropped), every slot must
    have filled, and no touched cell may have overflowed `cap`.

    Returns (dist (num, K), idx (num, K) into ext, valid, covered)."""
    dtype = centers.dtype
    n_cells = n_side**3
    tbl, overflow, dropped, s = _cellgrid_build(ext, box_l, n_side, cap)
    num = centers.shape[0]
    lanes = 27 * cap
    lp = -(-lanes // 128) * 128
    rmult = 8
    # tbl27: (4, n_cells, Lp). Roll by -o maps row c to cell c+o; a clamped
    # center cell (all coords in [1, n_side-2]) has every neighbor coord in
    # [0, n_side-1], so the flattened c+o never wraps for any row we index.
    tbl4 = tbl.reshape(n_cells, 4, cap)
    offs = [
        (dz * n_side + dy) * n_side + dx
        for dz in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
    ]
    tbl27 = jnp.concatenate(
        [jnp.roll(tbl4, -o, axis=0) for o in offs], axis=2
    )  # (n_cells, 4, 27*cap)
    if lp > lanes:
        park = jnp.asarray([jnp.inf, jnp.inf, jnp.inf, -1.0], dtype)
        tbl27 = jnp.concatenate(
            [
                tbl27,
                jnp.broadcast_to(
                    park[None, :, None], (n_cells, 4, lp - lanes)
                ),
            ],
            axis=2,
        )
    tbl27 = jnp.transpose(tbl27, (1, 0, 2))  # (4, n_cells, Lp)

    g = jnp.clip(
        jnp.floor(centers / s).astype(jnp.int32) + 1, 1, n_side - 2
    )  # (num, 3); the clamp only re-centers the neighborhood — `reach`
    # below is computed from the clamped cell, so coverage stays sound
    cid = (g[:, 2] * n_side + g[:, 1]) * n_side + g[:, 0]

    rc = 4096 if num > 4096 else -(-num // rmult) * rmult
    pad = (-num) % rc
    cs, cids = centers, cid
    if pad:
        cs = jnp.concatenate([cs, jnp.repeat(cs[-1:], pad, axis=0)])
        cids = jnp.concatenate([cids, jnp.repeat(cids[-1:], pad)])

    def one_chunk(args):
        blk, cb = args
        planes = tbl27[:, cb, :]  # (4, rc, Lp)
        dx = blk[:, 0:1] - planes[0]
        dy = blk[:, 1:2] - planes[1]
        dz = blk[:, 2:3] - planes[2]
        dsq = dx * dx + dy * dy + dz * dz
        masked = jnp.where(dsq > 0.0, dsq, jnp.inf)  # self-exclusion
        neg_top, li = jax.lax.top_k(-masked, k_search)
        top_dsq = -neg_top
        slot_ok = jnp.isfinite(top_dsq)
        dist = jnp.sqrt(jnp.where(slot_ok, top_dsq, jnp.inf))
        gi = jnp.take_along_axis(planes[3], li, axis=1)
        gidx = jnp.where(slot_ok, gi, 0.0).astype(jnp.int32)
        return dist, gidx, slot_ok

    blocks = (cs.reshape(-1, rc, 3), cids.reshape(-1, rc))
    if cs.shape[0] == rc:  # single chunk: skip the lax.map wrapper
        dist, idx, valid = one_chunk((cs, cids))
    else:
        dist, idx, valid = jax.lax.map(one_chunk, blocks)
        dist, idx, valid = (
            x.reshape((-1,) + x.shape[2:]) for x in (dist, idx, valid)
        )
    dist, idx, valid = dist[:num], idx[:num], valid[:num]

    d_far = dist[:, -1]
    d_far = jnp.where(jnp.isfinite(d_far), d_far, 0.0)
    # gathered region per axis: [(g-2)s, (g+1)s) in grid coordinates
    # (cell g spans [-s + g*s, -s + (g+1)*s))
    lo = (g.astype(dtype) - 2.0) * s
    hi = (g.astype(dtype) + 1.0) * s
    reach = jnp.minimum(
        jnp.min(centers - lo, axis=1), jnp.min(hi - centers, axis=1)
    )
    bound = jnp.where(dropped, jnp.minimum(reach, s), reach)
    off27 = jnp.asarray(offs, jnp.int32)
    cell27 = cid[:, None] + off27[None, :]  # (num, 27)
    ovf27 = jnp.any(overflow[cell27], axis=1)
    covered = (d_far < bound) & jnp.all(valid, axis=-1) & ~ovf27
    return dist, idx, valid, covered


@partial(jax.jit, static_argnames=("k", "k_search", "row_block", "eps", "win", "topk_impl", "cell_impl", "cg"))
def _cells_blocked(centers, ext, box, k, k_search, row_block, eps, win=None,
                   topk_impl="window", cell_impl=DEFAULT_CELL_IMPL, cg=None,
                   box_l=None):
    """Candidate search + cell moments for `centers` against the mirrored
    set `ext`. cell_impl: the "clip" (default) or "triple" builder.
    topk_impl="cellgrid" uses the 3-D cell-grid candidate search with static
    config cg=(n_side, cap) and the REAL box edge box_l (traced); "window"
    scans a z-sorted window of `win` candidates, or every candidate when win
    is None or covers the whole set."""
    if topk_impl == "cellgrid":
        dist, idx, valid, win_cov = _cellgrid_topk(
            centers, ext, box_l, k_search, row_block, cg[0], cg[1]
        )
        nl = ops_pairs.NeighborList(dist, idx, valid, jnp.sum(valid, axis=-1))
    elif win is not None and win < ext.shape[0]:
        dist, idx, valid, win_cov = _windowed_topk(
            centers, ext, k_search, row_block, win
        )
        nl = ops_pairs.NeighborList(dist, idx, valid, jnp.sum(valid, axis=-1))
    else:
        nl = ops_pairs.topk_neighbors(
            centers, ext, box, k=k_search, low_cut=0.0, high_cut=jnp.inf,
            row_block=row_block,
        )
        win_cov = jnp.ones(centers.shape[0], bool)
    rel_all = ext[nl.idx] - centers[:, None, :]  # (num, K_search, 3)
    cell_fn = _CELL_BUILDERS[cell_impl]

    def one_block(args):
        rel, ok = args
        return jax.vmap(lambda r, o: cell_fn(r, o, k, eps))(rel, ok)

    ns = centers.shape[0]
    pad = (-ns) % row_block
    if pad:
        rel_all = jnp.concatenate(
            [rel_all, jnp.zeros((pad, k_search, 3), rel_all.dtype)], axis=0
        )
        valid = jnp.concatenate(
            [nl.valid, jnp.zeros((pad, k_search), bool)], axis=0
        )
    else:
        valid = nl.valid
    blocks = (
        rel_all.reshape(-1, row_block, k_search, 3),
        valid.reshape(-1, row_block, k_search),
    )
    out = jax.lax.map(one_block, blocks)
    unblk = lambda x: x.reshape((-1,) + x.shape[2:])[:ns]
    out = {kk: unblk(v) for kk, v in out.items()}
    out["nbr_dist"] = nl.dist
    out["nbr_idx"] = nl.idx
    out["nbr_valid"] = nl.valid
    out["win_covered"] = win_cov
    return out


def _warn_triple_once(cell_impl: str) -> None:
    """The legacy `triple` builder's exactness certificate is measurably
    softer than the default `clip` builder's: worst certified f32 relative
    volume error 3.7e-3 across seeds vs 9.8e-4 (6 seeds x 500-atom liquid
    boxes vs an f64 Qhull oracle — PERF.md round-3 multi-seed
    re-measurement, regression-gated in
    tests/test_voronoi_device.py::test_clip_certified_error_band). Warn
    once per process so choosing it is never silent."""
    if cell_impl == "triple":
        from waterorderlib_tpu.utils.logging import log_once

        log_once(
            ("voronoi_triple_bound",),
            "cell_impl='triple' carries a ~4x looser certified f32 error "
            "bound than the default 'clip' builder (worst certified relative "
            "volume error 3.7e-3 vs 9.8e-4 across seeds); 'triple' is kept "
            "as a cross-check oracle — use the default for production "
            "accuracy",
            level="warning",
        )


def voronoi_cells_device(
    points,
    box_l: float,
    num: int,
    k: int = 32,
    k_search: int = 64,
    row_block: int = 256,
    eps: float | None = None,
    centers_idx=None,
    win: int | None = None,
    cell_impl: str = DEFAULT_CELL_IMPL,
    prune_mirrors: bool | None = None,
    cg="auto",
):
    """Per-cell Voronoi moments for the first `num` points on device.

    The cell is built from the `k` nearest candidates' bisector planes; the
    certificate draws on `k_search >= k` candidates: exactness requires that
    planes k..k_search provably do not cut the built cell AND that no point
    beyond the k_search-th could (d_{k_search} >= 2 * R_cell).

    prune_mirrors (None = auto for full-frame calls on >= 2048 points):
    search a depth-pruned mirror set (`mirror_points_pruned`) instead of
    the full 4P one — ~2x less top-K work; the certificate additionally
    requires 2*R_cell <= margin_eff, so exactness is unchanged and the few
    extra uncertified rows ride the escalation ladder.

    cg: "auto" (default) sizes a 3-D cell-grid candidate search
    (`_suggest_cellgrid` — escalation subsets get a wider grid edge since
    they are density-tail rows); an explicit (n_side, cap) forces one;
    None disables it (z-window / full-scan search). When the grid is
    active, mirror pruning is skipped — the grid drops deep mirrors for
    free, with a stronger certificate bound.

    Returns a dict of jnp arrays: vol (num,), area (num,), face_area
    (num, k), face_nverts (num, k), nbr_idx (num, k_search) indices into the
    FULL mirrored candidate set (original point = idx % P), r_cell (num,),
    and certified (num,) — True where the cell is provably exact.
    """
    _warn_triple_once(cell_impl)
    pts = jnp.asarray(points)
    if eps is None:
        eps = 1e-10 if pts.dtype == jnp.float64 else 1e-4
    if k_search < k:
        raise ValueError(f"k_search={k_search} must be >= k={k}")
    p_real = int(pts.shape[0])
    if cg == "auto":
        cg = _suggest_cellgrid(
            p_real, float(box_l), k_search,
            s_factor=1.12 if centers_idx is None else 1.4,
        )
    use_prune = (
        prune_mirrors
        if prune_mirrors is not None
        else (cg is None and centers_idx is None and p_real >= 2048)
    )
    ext_map = margin_eff = None
    budget = _suggest_mirror_budget(p_real, float(box_l), k_search)
    if use_prune and budget > 0:
        ext, ext_map, margin_eff = mirror_points_pruned(pts, box_l, budget)
    else:
        ext = mirror_points_device(pts, box_l)
    n_want = None
    if centers_idx is None:
        centers = pts[:num]
    else:
        # bucket-pad the escalation subset to a power of two so repeated
        # tier calls with drifting subset sizes hit the jit cache instead of
        # recompiling every frame
        centers_idx = np.asarray(centers_idx)
        n_want = len(centers_idx)
        bucket = max(64, 1 << int(np.ceil(np.log2(max(n_want, 1)))))
        padded_idx = np.concatenate(
            [centers_idx, np.full(bucket - n_want, centers_idx[0] if n_want else 0,
                                  centers_idx.dtype if n_want else np.int64)]
        )
        centers = pts[jnp.asarray(padded_idx)]
    box = jnp.asarray([_NO_PBC_BOX] * 3, pts.dtype)
    nc = int(centers.shape[0])
    if win is None:
        win = _suggest_win(
            int(pts.shape[0]), int(ext.shape[0]), float(box_l), k_search
        )
    elif win <= 0:
        win = int(ext.shape[0])  # force the full scan
    out = _cells_blocked(
        centers, ext, box, k, k_search, min(row_block, max(1, nc)), float(eps),
        win=win, topk_impl="window" if cg is None else "cellgrid",
        cell_impl=cell_impl, cg=cg, box_l=jnp.asarray(box_l, pts.dtype),
    )
    d_far = out["nbr_dist"][:, -1]  # +inf when fewer than K candidates exist
    cert = out["ok_shape"] & out["win_covered"] & (d_far >= 2.0 * out["r_cell"])
    if ext_map is not None:
        # excluded mirrors are all at >= margin_eff: same cut argument as d_K
        cert = cert & (2.0 * out["r_cell"] <= margin_eff)
        # restore full-4P-layout neighbor ids for every downstream consumer
        out["nbr_idx"] = ext_map[out["nbr_idx"]]
        # host-fallback consumers must cap the unseen-candidate bound at the
        # pruning margin (excluded mirrors can be nearer than d_far)
        out["prune_margin"] = jnp.full_like(out["r_cell"], margin_eff)
    out["certified"] = cert
    if n_want is not None:  # drop bucket padding
        out = {kk: v[:n_want] for kk, v in out.items()}
    return out


def _host_cell(rel: np.ndarray):
    """Host fallback for one cell: half-space intersection of the bisector
    planes of `rel` (K2, 3) relative candidates around the origin.

    Returns (vol, area, face_areas (K2,), face_nverts (K2,), r_cell).
    """
    from scipy.spatial import ConvexHull, HalfspaceIntersection

    n = rel / np.linalg.norm(rel, axis=-1, keepdims=True)
    d = 0.5 * np.linalg.norm(rel, axis=-1)
    halfspaces = np.hstack([n, -d[:, None]])  # n.x - d <= 0
    hs = HalfspaceIntersection(halfspaces, np.zeros(3))
    verts = hs.intersections
    hull = ConvexHull(verts)
    r_cell = float(np.max(np.linalg.norm(verts, axis=-1)))
    # per-face areas: group hull facets by the generating half-space
    face_area = np.zeros(len(rel))
    face_verts: list[set] = [set() for _ in range(len(rel))]
    centroids = verts[hull.simplices].mean(axis=1)
    plane_off = centroids @ n.T - d[None, :]  # (S, K2)
    owner = np.argmax(plane_off, axis=1)  # nearest plane contains the facet
    for s, simplex in enumerate(hull.simplices):
        a, b, c = verts[simplex]
        face_area[owner[s]] += 0.5 * np.linalg.norm(np.cross(b - a, c - a))
        face_verts[owner[s]].update(int(v) for v in simplex)
    nverts = np.array([len(fv) for fv in face_verts])
    return float(hull.volume), float(hull.area), face_area, nverts, r_cell


# escalation ladder: the third tier became worthwhile once the
# endpoint-identity dedup + face-gap certificates landed (it now rescues
# ~60% of the tier-2 residue at 12k — extra_cut cells that genuinely need
# more than 48 build planes; before those fixes it rescued almost nothing)
# The (96, 192)/(128, 256) rescue tiers exist because of the host
# fallback's cost: near-wall atoms (0.1-0.6 A from a box face) have
# mirror-dominated candidate sets and stay extra_cut even at k=64 (a thin
# slab cell against the box face needs many planes), and each scipy
# HalfspaceIntersection fallback costs ~77 ms on a 1-core host — 32
# residual cells at 12k cost more than the whole device tessellation.
# (128, 256) certified 32/32 of that residue at 1.1e-3 f32 accuracy; the
# clip builder's O(P*K) cost keeps even C(128,2)=8128 pairs cheap for the
# handful of cells that reach it.
DEFAULT_TIERS = ((32, 64), (48, 96), (64, 128), (96, 192), (128, 256))
# wide tier-1 alternative: (40, 96) certifies ~96% of liquid cells on the
# first pass (vs ~84% at (32, 64) — extra_cut vetoes drop 4x, d_K >= 2R
# vetoes vanish), trading ~2x tier-1 arithmetic for a 4x smaller
# escalation ladder
WIDE_TIERS = ((40, 96), (48, 96), (64, 128), (96, 192), (128, 256))


def voronoi_volumes_hybrid(
    points: np.ndarray,
    box_l: float,
    num: int,
    tiers=DEFAULT_TIERS,
    row_block: int = 256,
    fallback_k: int = 96,
    cell_impl: str = DEFAULT_CELL_IMPL,
):
    """Drop-in for `surface.voronoi.voronoi_volumes`: device cells where
    certified (escalating through (k, k_search) tiers), per-atom host
    half-space cells otherwise.

    Returns (vol (num,), area (num,), n_certified) — open cells -> inf as in
    the reference (impossible here for in-box points: the mirror set always
    closes them, matching orderParam_lib.py:920-962 semantics).
    """
    _warn_triple_once(cell_impl)
    points = np.asarray(points)
    if cell_impl == "triple":
        # the legacy triple builder is O(C(k,3)*k): the (96, 192)/(128, 256)
        # rescue tiers are clip-only
        tiers = tuple(t for t in tiers if t[0] <= 64)
    k0, ks0 = tiers[0][:2]
    out = voronoi_cells_device(
        points, box_l, num, k=k0, k_search=ks0, row_block=row_block,
        cell_impl=cell_impl,
    )
    vol = np.asarray(out["vol"], np.float64).copy()
    area = np.asarray(out["area"], np.float64).copy()
    cert = np.asarray(out["certified"]).copy()
    tier_rows = [(np.arange(num), out)]
    vol, area, cert = _escalate_and_close(
        points, box_l, num, vol, area, cert, tier_rows, tiers[1:],
        row_block, fallback_k, cell_impl,
    )
    return vol, area, int(cert.sum())


def _escalate_and_close(points, box_l, num, vol, area, cert, tier_rows,
                        tiers_rest, row_block, fallback_k, cell_impl):
    """Escalation ladder + host fallback shared by the per-frame and the
    frame-batched hybrids: re-run the uncertified cells through the
    remaining (k, k_search) tiers, then close any residue on the host.
    Mutates vol/area/cert in place and returns them."""
    is_last = lambda t: t is tiers_rest[-1]
    for tier in tiers_rest:
        k2, ks2 = tier[:2]
        bad_idx = np.where(~cert)[0]
        if not len(bad_idx):
            break
        # intermediate tiers: scatter-aware z-window (coverage-vetoed rows
        # just ride to the next tier); the LAST tier full-scans so a
        # window miss can never force a host fallback. The subset itself is
        # bucket-padded inside voronoi_cells_device; the WINDOW is the other
        # jit-static shape input — quantize it geometrically (_quantize_win)
        # so per-frame bad-row variation cannot mint fresh compiles.
        win_t = 0 if is_last(tier) else _quantize_win(
            _suggest_win_subset(len(points), float(box_l), ks2, len(bad_idx)),
            4 * len(points),
        )
        # row_block clamps to the BUCKETED subset size inside
        # voronoi_cells_device — shrinking it to the raw count here would
        # reintroduce a per-frame-varying static shape. The LAST tier must
        # full-scan (a coverage veto there would force a host fallback), so
        # it disables the cell-grid search as well as the z-window.
        out2 = voronoi_cells_device(
            points, box_l, num, k=k2, k_search=ks2,
            row_block=row_block, centers_idx=bad_idx,
            win=win_t,
            cell_impl=cell_impl,
            cg=None if is_last(tier) else "auto",
        )
        tier_rows.append((bad_idx, out2))
        c2 = np.asarray(out2["certified"])
        fixed = bad_idx[c2]
        vol[fixed] = np.asarray(out2["vol"], np.float64)[c2]
        area[fixed] = np.asarray(out2["area"], np.float64)[c2]
        cert[fixed] = True
    bad = np.where(~cert)[0]
    if len(bad):
        ext = np.asarray(mirror_points_device(jnp.asarray(points), box_l))
        for i, (rel, d_far, _sel) in zip(
            bad, _device_candidates(tier_rows, bad, ext, points)
        ):
            ok = False
            if len(rel) >= 4 and np.isfinite(d_far):
                v_i, a_i, fa, nv, r_cell, ok = _host_cell_from_device(rel, d_far)
            if not ok:  # unseen candidates could cut: full host search
                v_i, a_i, *_ = _host_cell_best(ext, points[i], fallback_k)
            vol[i], area[i] = v_i, a_i
    return vol, area, cert


def _tier1_pure(points, box_l, num: int, k: int, k_search: int,
                row_block: int, eps: float, win: int, topk_impl: str,
                cell_impl: str, mirror_budget: int = 0, cg=None):
    """Traceable tier-1 cells for ONE frame: mirror construction + top-K
    candidate search + cell moments + the exactness certificate, with no
    host control flow. mirror_budget > 0 searches the depth-pruned mirror
    set (see `mirror_points_pruned`); topk_impl="cellgrid" takes the static
    cg=(n_side, cap) grid instead (full mirror set — the grid drops deep
    mirrors itself). Returns (vol (num,), area (num,), certified (num,))."""
    pts = jnp.asarray(points)
    if mirror_budget > 0:
        ext, _, margin_eff = mirror_points_pruned(pts, box_l, mirror_budget)
    else:
        ext = mirror_points_device(pts, box_l)
    box = jnp.asarray([_NO_PBC_BOX] * 3, pts.dtype)
    out = _cells_blocked(
        pts[:num], ext, box, k, k_search, row_block, eps, win=win,
        topk_impl=topk_impl, cell_impl=cell_impl,
        cg=cg, box_l=jnp.asarray(box_l, pts.dtype),
    )
    d_far = out["nbr_dist"][:, -1]
    cert = out["ok_shape"] & out["win_covered"] & (d_far >= 2.0 * out["r_cell"])
    if mirror_budget > 0:
        cert = cert & (2.0 * out["r_cell"] <= margin_eff)
    return out["vol"], out["area"], cert


def voronoi_volumes_hybrid_frames(
    pos_batch: np.ndarray,
    box_ls: np.ndarray,
    num: int,
    tiers=DEFAULT_TIERS,
    row_block: int = 256,
    fallback_k: int = 96,
    cell_impl: str = DEFAULT_CELL_IMPL,
    mesh=None,
):
    """Frame-batched `voronoi_volumes_hybrid`: tier-1 cells for ALL frames
    in one jitted call — per-frame tessellations are independent, so frames
    are pure data parallelism (the reference loops frames serially,
    orderParam_lib.py:1028) — optionally shard_mapped over a device mesh.
    The escalation ladder then runs once per tier for the whole batch, and
    the host fallback per frame on the (few) uncertified cells.

    pos_batch: (F, P, 3); box_ls: (F,) cubic box edges (may vary, NPT);
    mesh: optional jax.sharding.Mesh — frames are sharded over BOTH mesh
    axes (the atom axis has no role in a per-frame tessellation, so it
    joins the frame partition instead of idling; F is padded to the device
    count by repeating the last frame). Returns (vol (F, num),
    area (F, num), n_certified_total).
    """
    from waterorderlib_tpu.utils.logging import log_once

    _warn_triple_once(cell_impl)
    pos_batch = np.asarray(pos_batch)
    box_ls = np.asarray(box_ls, np.float64).reshape(-1)
    F = pos_batch.shape[0]
    if cell_impl == "triple":
        tiers = tuple(t for t in tiers if t[0] <= 64)
    k0, ks0 = tiers[0][:2]
    eps, win, ti, mb, cg = _batch_static_config(pos_batch, box_ls, ks0)

    pb = jnp.asarray(pos_batch)
    bl = jnp.asarray(box_ls, pb.dtype)
    if mesh is not None:
        pad_f = (-F) % int(mesh.devices.size)
        if pad_f:
            pb = jnp.concatenate([pb, jnp.repeat(pb[-1:], pad_f, axis=0)])
            bl = jnp.concatenate([bl, jnp.repeat(bl[-1:], pad_f)])
        from waterorderlib_tpu.parallel.mesh import sharded_voronoi_tier1

        vol_j, area_j, cert_j = sharded_voronoi_tier1(
            pb, bl, mesh, num=num, k=k0, k_search=ks0,
            row_block=row_block, eps=float(eps), win=int(win),
            topk_impl=ti, cell_impl=cell_impl, mirror_budget=mb, cg=cg,
        )
    else:
        vol_j, area_j, cert_j = _tier1_frames_local(
            pb, bl, num, k0, ks0, row_block, float(eps), int(win),
            ti, cell_impl, mb, cg,
        )
    log_once(
        ("voronoi_frames", ti, cell_impl, mesh is not None),
        "voronoi tier-1 frame batch: topk=%s cells=%s sharded=%s "
        "(F=%d, n=%d)", ti, cell_impl, mesh is not None, F, num,
    )
    vol_b = np.asarray(vol_j, np.float64)[:F].copy()
    area_b = np.asarray(area_j, np.float64)[:F].copy()
    cert_b = np.asarray(cert_j, bool)[:F].copy()

    # cross-frame batched escalation: ONE dispatch per tier for the whole
    # batch, then a host close per frame from the last tier's candidates
    vol_b, area_b, cert_b, payload = _escalate_frames_batched(
        pos_batch, box_ls, vol_b, area_b, cert_b, tiers[1:], cell_impl
    )
    n_cert_total = 0
    for t in range(F):
        cert_t = cert_b[t].copy()
        vol_b[t], area_b[t], cert_t = _escalate_and_close(
            pos_batch[t], float(box_ls[t]), num, vol_b[t], area_b[t],
            cert_t, payload[t], (), row_block, fallback_k, cell_impl,
        )
        n_cert_total += int(cert_t.sum())
    return vol_b, area_b, n_cert_total


@partial(
    jax.jit,
    static_argnames=("k", "ks", "row_block", "eps", "win", "ti", "ci", "cg"),
)
def _tier_subset_frames(pb, bl, rows, k, ks, row_block, eps, win, ti, ci,
                        cg=None):
    """One escalation tier for selected rows of EVERY frame in one jitted
    call (full mirror set — escalation never prunes). rows: (F, B) center
    indices, bucket-padded per frame. Returns per-frame (vol, area, cert)
    (F, B) plus the candidate payload for the host fallback."""

    def one(args):
        p, b, r = args
        ext = mirror_points_device(p, b)
        box = jnp.asarray([_NO_PBC_BOX] * 3, p.dtype)
        out = _cells_blocked(
            p[r], ext, box, k, ks, row_block, eps, win=win,
            topk_impl=ti, cell_impl=ci,
            cg=cg, box_l=b if cg is not None else None,
        )
        d_far = out["nbr_dist"][:, -1]
        cert = (
            out["ok_shape"] & out["win_covered"]
            & (d_far >= 2.0 * out["r_cell"])
        )
        return (
            out["vol"], out["area"], cert,
            out["nbr_dist"], out["nbr_idx"], out["nbr_valid"],
            out["win_covered"],
        )

    return jax.lax.map(one, (pb, bl, rows))


def _escalate_frames_batched(pos_batch, box_ls, vol_b, area_b, cert_b,
                             tiers_rest, cell_impl):
    """Run the escalation ladder for a frame batch with one dispatch per
    tier. Mutates/returns (vol_b, area_b, cert_b, payload) where payload[t]
    is the `tier_rows` list for frame t's host fallback (the LAST tier's
    candidate payload — later tiers recompute every still-bad row, so
    earlier payloads are never consulted)."""
    F, n_pts = pos_batch.shape[0], pos_batch.shape[1]
    payload = [[] for _ in range(F)]
    last = None  # final executed tier: (bad_rows, device payload arrays)
    if not tiers_rest:
        return vol_b, area_b, cert_b, payload
    pb = jnp.asarray(pos_batch)
    bl = jnp.asarray(box_ls, pb.dtype)
    eps = 1e-10 if pb.dtype == jnp.float64 else 1e-4
    p4 = 4 * n_pts
    box_min = float(np.min(box_ls))
    tiers_rest = tuple(tiers_rest)
    for tier in tiers_rest:
        k2, ks2 = tier[:2]
        bad_rows = [np.where(~cert_b[t])[0] for t in range(F)]
        max_bad = max(len(b) for b in bad_rows)
        if max_bad == 0:
            break
        bucket = max(64, 1 << int(np.ceil(np.log2(max_bad))))
        rows_np = np.zeros((F, bucket), np.int64)
        for t, b in enumerate(bad_rows):
            if len(b):
                rows_np[t, : len(b)] = b
                rows_np[t, len(b):] = b[0]
        # size the window for the most SCATTERED frame (fewest bad rows →
        # widest per-block z span), not the bucket: a too-narrow window
        # coverage-vetoes the sparse frames' rows into the next tier
        n_rows_w = min(len(b) for b in bad_rows if len(b))
        # geometric quantization: stable static window shape across batches
        win_t = 0 if tier is tiers_rest[-1] else _quantize_win(
            _suggest_win_subset(n_pts, box_min, ks2, n_rows_w), p4
        )
        # density-tail rows escalate, so the subset grid uses a wider edge;
        # the last tier full-scans (a coverage veto there would force a host
        # fallback)
        cg2 = (
            None if tier is tiers_rest[-1]
            else _suggest_cellgrid(n_pts, box_min, ks2, s_factor=1.4)
        )
        res = _tier_subset_frames(
            pb, bl, jnp.asarray(rows_np), k2, ks2, min(256, bucket),
            float(eps), int(win_t) if win_t > 0 else None,  # None = full scan
            "window" if cg2 is None else "cellgrid", cell_impl, cg2,
        )
        # fetch only the small (F, bucket) stats per tier; the (F, bucket,
        # ks) candidate payloads stay ON DEVICE — they are consulted only
        # for rows still uncertified after the WHOLE ladder (the host
        # close), which is ~0.01% of rows
        vol2, area2, cert2 = (np.asarray(res[i]) for i in range(3))
        last = (bad_rows, res[3], res[4], res[5], res[6])
        for t, b in enumerate(bad_rows):
            nb = len(b)
            if nb == 0:
                continue
            c2 = cert2[t, :nb].astype(bool)
            fixed = b[c2]
            vol_b[t][fixed] = vol2[t, :nb][c2].astype(np.float64)
            area_b[t][fixed] = area2[t, :nb][c2].astype(np.float64)
            cert_b[t][fixed] = True
    if last is not None and any(not cert_b[t].all() for t in range(F)):
        bad_rows, ndj, nij, nvj, wcj = last
        nd, nidx, nvalid, wcov = (
            np.asarray(x) for x in (ndj, nij, nvj, wcj)
        )
        for t, b in enumerate(bad_rows):
            nb = len(b)
            if nb == 0 or cert_b[t].all():
                continue
            payload[t] = [(b, {
                "nbr_dist": nd[t, :nb], "nbr_idx": nidx[t, :nb],
                "nbr_valid": nvalid[t, :nb], "win_covered": wcov[t, :nb],
            })]
    return vol_b, area_b, cert_b, payload


@partial(
    jax.jit,
    static_argnames=(
        "num", "k", "ks", "row_block", "eps", "win", "ti", "ci", "mb", "cg",
    ),
)
def _tier1_frames_local(pb, bl, num, k, ks, row_block, eps, win, ti, ci,
                        mb=0, cg=None):
    """Unsharded frame batch: one jitted lax.map over frames (one compile,
    one host sync for the whole batch)."""

    def one(args):
        p, b = args
        return _tier1_pure(p, b, num, k, ks, row_block, eps, win, ti, ci, mb, cg)

    return jax.lax.map(one, (pb, bl))


def _batch_static_config(pos_batch, box_ls, ks0: int):
    """Static config for a frame-batched tier-1: (eps, win, topk_impl,
    mirror_budget, cg), chosen once for the whole batch as
    `voronoi_cells_device` chooses them per call. mirror_budget > 0 means
    every frame searches the depth-pruned mirror set (certificates cap at
    the margin, so exactness holds); it is 0 whenever the cell-grid search
    (cg) is available — the grid drops deep mirrors itself, and per-frame
    traced cell edges keep the certificate sound across NPT box variation
    (n_side/cap are sized at the smallest box = densest frame)."""
    n_pts = pos_batch.shape[1]
    eps = 1e-10 if jnp.asarray(pos_batch[:1, :1]).dtype == jnp.float64 else 1e-4
    box_min = float(np.min(box_ls))
    cg = _suggest_cellgrid(n_pts, box_min, ks0)
    budget = (
        _suggest_mirror_budget(n_pts, box_min, ks0)
        if (n_pts >= 2048 and cg is None)
        else 0
    )
    p4 = 4 * n_pts if budget == 0 else n_pts + budget
    win = _suggest_win(n_pts, p4, box_min, ks0)
    return eps, win, "window" if cg is None else "cellgrid", budget, cg


_CONTACTS_TIER1_KEYS = (
    "vol", "area", "certified", "face_area", "face_nverts",
    "nbr_idx", "nbr_dist", "nbr_valid", "win_covered", "prune_margin",
)


def _tier1_contacts_full(points, box_l, sel, num, k, k_search, row_block,
                         eps, win, topk_impl, cell_impl,
                         mirror_budget: int = 0, cg=None):
    """Traceable tier-1 cells WITH the face payload for ONE frame's
    selected center rows (`sel`, fixed length): the contacts analog of
    `_tier1_pure`. Returns the `_CONTACTS_TIER1_KEYS` tuple — everything
    `_scatter_contact_rows` and `_device_candidates` need, all in
    sel-row space (nbr_idx in the FULL 4P mirror layout even when the
    pruned set was searched)."""
    pts = jnp.asarray(points)
    if mirror_budget > 0:
        ext, ext_map, margin_eff = mirror_points_pruned(
            pts, box_l, mirror_budget
        )
    else:
        ext = mirror_points_device(pts, box_l)
    box = jnp.asarray([_NO_PBC_BOX] * 3, pts.dtype)
    centers = pts[sel]
    out = _cells_blocked(
        centers, ext, box, k, k_search, row_block, eps, win=win,
        topk_impl=topk_impl, cell_impl=cell_impl,
        cg=cg, box_l=jnp.asarray(box_l, pts.dtype),
    )
    d_far = out["nbr_dist"][:, -1]
    cert = out["ok_shape"] & out["win_covered"] & (d_far >= 2.0 * out["r_cell"])
    if mirror_budget > 0:
        cert = cert & (2.0 * out["r_cell"] <= margin_eff)
        out["nbr_idx"] = ext_map[out["nbr_idx"]]
        out["prune_margin"] = jnp.full_like(out["r_cell"], margin_eff)
    else:
        out["prune_margin"] = jnp.full_like(out["r_cell"], jnp.inf)
    out["certified"] = cert
    return tuple(out[kk] for kk in _CONTACTS_TIER1_KEYS)


@partial(
    jax.jit,
    static_argnames=(
        "num", "k", "ks", "row_block", "eps", "win", "ti", "ci", "mb", "cg",
    ),
)
def _tier1_contacts_frames_local(pb, bl, sel, num, k, ks, row_block, eps,
                                 win, ti, ci, mb=0, cg=None):
    """Unsharded contacts tier-1 frame batch: one jitted lax.map over
    frames (one compile, one host sync for the whole batch)."""

    def one(args):
        p, b = args
        return _tier1_contacts_full(
            p, b, sel, num, k, ks, row_block, eps, win, ti, ci, mb, cg
        )

    return jax.lax.map(one, (pb, bl))


def voronoi_contacts_hybrid_frames(
    pos_batch: np.ndarray,
    box_ls: np.ndarray,
    num: int,
    rows=None,
    tiers=DEFAULT_TIERS,
    row_block: int = 256,
    fallback_k: int = 96,
    cell_impl: str = DEFAULT_CELL_IMPL,
    mesh=None,
):
    """Frame-batched `voronoi_contacts_hybrid`: tier-1 cells (with face
    payload) for ALL frames in one jitted call, optionally shard_mapped
    over a device mesh with frames data-parallel — the same scale-out as
    `voronoi_volumes_hybrid_frames` (the reference loops frames serially,
    orderParam_lib.py:1870). The escalation ladder + host fallback +
    contact-matrix assembly then run per frame on the host.

    Generator: yields per-frame (contacts (num, num), atom_area (1, num),
    wat_area (1, num), atom_vol (1, num), n_certified), frame by frame, so
    callers never hold F contact matrices at once. `rows` restricts which
    cells are computed (see `voronoi_contacts_hybrid`); unlike the volumes
    batch, the tier-1 payload is kept (F x n_sel x K_search — affordable
    because contact callers restrict rows to the solute)."""
    from waterorderlib_tpu.utils.logging import log_once

    _warn_triple_once(cell_impl)
    pos_batch = np.asarray(pos_batch)
    box_ls = np.asarray(box_ls, np.float64).reshape(-1)
    F, n_pts = pos_batch.shape[0], pos_batch.shape[1]
    if cell_impl == "triple":
        tiers = tuple(t for t in tiers if t[0] <= 64)  # see volumes hybrid
    sel_rows = np.arange(num) if rows is None else np.asarray(rows, int)
    n_want = len(sel_rows)
    # bucket-pad the row subset (jit-cache stability, like voronoi_cells_device)
    bucket = max(64, 1 << int(np.ceil(np.log2(max(n_want, 1)))))
    padded_sel = np.concatenate(
        [sel_rows, np.full(bucket - n_want, sel_rows[0] if n_want else 0, int)]
    )
    k0, ks0 = tiers[0][:2]
    eps, win, ti, mb, cg = _batch_static_config(pos_batch, box_ls, ks0)
    rb = min(row_block, bucket)

    pb = jnp.asarray(pos_batch)
    bl = jnp.asarray(box_ls, pb.dtype)
    sel_j = jnp.asarray(padded_sel, jnp.int32)
    if mesh is not None:
        pad_f = (-F) % int(mesh.devices.size)
        if pad_f:
            pb = jnp.concatenate([pb, jnp.repeat(pb[-1:], pad_f, axis=0)])
            bl = jnp.concatenate([bl, jnp.repeat(bl[-1:], pad_f)])
        from waterorderlib_tpu.parallel.mesh import (
            sharded_voronoi_contacts_tier1,
        )

        res = sharded_voronoi_contacts_tier1(
            pb, bl, sel_j, mesh, num=num, k=k0, k_search=ks0,
            row_block=rb, eps=float(eps), win=int(win),
            topk_impl=ti, cell_impl=cell_impl, mirror_budget=mb, cg=cg,
        )
    else:
        res = _tier1_contacts_frames_local(
            pb, bl, sel_j, num, k0, ks0, rb, float(eps), int(win),
            ti, cell_impl, mb, cg,
        )
    log_once(
        ("voronoi_contacts_frames", ti, cell_impl, mesh is not None),
        "voronoi contacts tier-1 frame batch: topk=%s cells=%s "
        "sharded=%s (F=%d, rows=%d)", ti, cell_impl, mesh is not None, F,
        n_want,
    )
    batch = {
        kk: np.asarray(v)[:F, :n_want]
        for kk, v in zip(_CONTACTS_TIER1_KEYS, res)
    }

    for t in range(F):
        out_t = {kk: batch[kk][t] for kk in _CONTACTS_TIER1_KEYS}
        cert = np.asarray(out_t["certified"], bool).copy()
        vol = np.zeros(num)
        area = np.zeros(num)
        vol[sel_rows] = np.asarray(out_t["vol"], np.float64)
        area[sel_rows] = np.asarray(out_t["area"], np.float64)
        contacts = np.zeros((num, num))
        _scatter_contact_rows(contacts, out_t, sel_rows, cert, n_pts, num)
        yield _contacts_escalate_and_close(
            pos_batch[t], float(box_ls[t]), num, sel_rows, vol, area, cert,
            contacts, [(sel_rows, out_t)], tiers[1:], row_block, fallback_k,
            cell_impl,
        )


def _device_candidates(tier_rows, bad, ext, points):
    """Yield (rel, d_far) per bad row from the LATEST tier that computed it
    — the device already found each row's k_search nearest candidates, so
    the host fallback needs no 4P-point search of its own."""
    latest = {}
    for rows_idx, o in tier_rows:
        nbr_idx = np.asarray(o["nbr_idx"])
        nbr_dist = np.asarray(o["nbr_dist"])
        nbr_valid = np.asarray(o["nbr_valid"])
        wcov = np.asarray(o["win_covered"])
        pm = o.get("prune_margin")
        pm = None if pm is None else np.asarray(pm)
        for p, r in enumerate(rows_idx):
            latest[int(r)] = (
                nbr_idx[p], nbr_dist[p], nbr_valid[p], wcov[p],
                np.inf if pm is None else float(pm[p]),
            )
    for i in bad:
        entry = latest.get(int(i))
        if entry is None:
            # no tier computed this row's candidates (frame-batched tier-1
            # keeps none and the ladder was empty): full host search
            yield np.zeros((0, 3)), -np.inf, np.zeros(0, int)
            continue
        idxs, dvec, valid, covered, pmv = entry
        if not covered or not valid.any():
            # the z-window search may have missed nearer candidates: force
            # the full host search by failing the d_far certificate
            yield np.zeros((0, 3)), -np.inf, np.zeros(0, int)
            continue
        sel = idxs[valid]
        rel = ext[sel] - np.asarray(points[i], ext.dtype)[None, :]
        # under mirror pruning, unseen EXCLUDED mirrors are only known to be
        # beyond the pruning margin — the far-candidate bound caps there
        yield rel, float(min(dvec[valid][-1], pmv)), sel


def _host_cell_from_device(rel: np.ndarray, d_far: float):
    """Host cell from the device-found candidate list (no host search).

    rel: (K2, 3) relative candidates, nearest-first; d_far: distance of the
    farthest. Returns (vol, area, fa, nv, r_cell, certified) — certified
    means no unseen candidate (all beyond d_far) can cut the cell."""
    vol, area, fa, nv, r_cell = _host_cell(rel)
    return vol, area, fa, nv, r_cell, bool(d_far >= 2.0 * r_cell)


def _host_cell_best(ext: np.ndarray, center: np.ndarray, k2: int):
    """Host cell of `center` against its k2 nearest mirrored candidates,
    doubling k2 until the far-candidate certificate holds."""
    # match ext's dtype so the self-point subtracts to exactly zero — an
    # f64 center against the f32 mirror set leaves self at d ~ 1e-7, which
    # survives the self-drop below and injects a plane through the center
    center = np.asarray(center, ext.dtype)
    d = np.linalg.norm(ext - center[None, :], axis=-1)
    while True:
        kk = min(4 * k2, len(d))  # partial selection: O(n), not a full sort
        cand = np.argpartition(d, kk - 1)[:kk]
        order = cand[np.argsort(d[cand])]
        order = order[d[order] > 1e-12]  # drop self
        sel = order[: min(k2, len(order))]
        rel = ext[sel] - center[None, :]
        vol, area, fa, nv, r_cell = _host_cell(rel)
        if len(sel) >= len(d) - 1 or d[sel[-1]] >= 2 * r_cell:
            return vol, area, fa, nv, sel
        k2 *= 2


def _scatter_contact_rows(contacts, out, rows_idx, keep_mask, P, num):
    """Scatter one device tier's face areas into contact-matrix rows.

    rows_idx: original center index per device row; keep_mask: which device
    rows to scatter (certified ones)."""
    face_area = np.asarray(out["face_area"], np.float64)[keep_mask]
    face_nverts = np.asarray(out["face_nverts"])[keep_mask]
    nbr_idx = np.asarray(out["nbr_idx"])[keep_mask, : face_area.shape[1]]
    rows = rows_idx[keep_mask][:, None].repeat(face_area.shape[1], 1)
    orig = nbr_idx % P  # mirror image -> source point
    is_real = (nbr_idx < P) & (orig < num) & (face_area > 0)
    quirk = np.where(face_nverts >= 4, 2.0, 1.0)
    np.add.at(contacts, (rows[is_real], orig[is_real]), (quirk * face_area)[is_real])


def voronoi_contacts_hybrid(
    points: np.ndarray,
    box_l: float,
    num: int,
    tiers=DEFAULT_TIERS,
    row_block: int = 256,
    fallback_k: int = 96,
    rows=None,
    cell_impl: str = DEFAULT_CELL_IMPL,
):
    """Drop-in for `surface.voronoi.voronoi_contacts`: (contacts (num, num),
    atom_area (1, num), wat_area (1, num), atom_vol (1, num), n_certified).

    Reproduces the reference's doubled-area quirk: faces with >= 4 vertices
    contribute 2x their polygon area to the contact matrix, 3-vertex faces
    1x (surface_library.py:295-303).

    `rows` restricts which cells are computed (contact_area_calc only needs
    the solute atoms' rows — a ~25x saving on solvated systems); other rows
    of the returned arrays are zero. Default: all `num` rows.
    """
    _warn_triple_once(cell_impl)
    points = np.asarray(points)
    if cell_impl == "triple":
        tiers = tuple(t for t in tiers if t[0] <= 64)  # see volumes hybrid
    P = len(points)
    sel_rows = np.arange(num) if rows is None else np.asarray(rows, int)
    k0, ks0 = tiers[0][:2]
    out = voronoi_cells_device(
        points, box_l, num, k=k0, k_search=ks0, row_block=row_block,
        centers_idx=None if rows is None else sel_rows, cell_impl=cell_impl,
    )
    cert = np.asarray(out["certified"]).copy()  # in sel_rows space
    vol = np.zeros(num)
    area = np.zeros(num)
    vol[sel_rows] = np.asarray(out["vol"], np.float64)
    area[sel_rows] = np.asarray(out["area"], np.float64)
    contacts = np.zeros((num, num))
    _scatter_contact_rows(contacts, out, sel_rows, cert, P, num)
    return _contacts_escalate_and_close(
        points, box_l, num, sel_rows, vol, area, cert, contacts,
        [(sel_rows, out)], tiers[1:], row_block, fallback_k, cell_impl,
    )


def _contacts_escalate_and_close(points, box_l, num, sel_rows, vol, area,
                                 cert, contacts, tier_rows, tiers_rest,
                                 row_block, fallback_k, cell_impl):
    """Escalation ladder + host fallback + contact-matrix closure shared by
    the per-frame and frame-batched contact hybrids. `cert` is in sel_rows
    space; vol/area/contacts are mutated in place. Returns the
    `voronoi_contacts_hybrid` result tuple."""
    P = len(points)
    is_last = lambda t: t is tiers_rest[-1]
    for tier in tiers_rest:
        k2, ks2 = tier[:2]
        bad_pos = np.where(~cert)[0]
        if not len(bad_pos):
            break
        bad_idx = sel_rows[bad_pos]
        # see _escalate_and_close: windowed intermediate tiers, full-scan
        # last tier; geometric window quantization + unshrunk row_block
        # keep the tier's jit shapes stable across frames (recompile
        # pathology, r4)
        win_t = 0 if is_last(tier) else _quantize_win(
            _suggest_win_subset(len(points), float(box_l), ks2, len(bad_idx)),
            4 * len(points),
        )
        out2 = voronoi_cells_device(
            points, box_l, num, k=k2, k_search=ks2,
            row_block=row_block, centers_idx=bad_idx,
            win=win_t,
            cell_impl=cell_impl,
            cg=None if is_last(tier) else "auto",  # last tier: full scan
        )
        tier_rows.append((bad_idx, out2))
        c2 = np.asarray(out2["certified"])
        fixed = bad_idx[c2]
        vol[fixed] = np.asarray(out2["vol"], np.float64)[c2]
        area[fixed] = np.asarray(out2["area"], np.float64)[c2]
        _scatter_contact_rows(contacts, out2, bad_idx, c2, P, num)
        cert[bad_pos[c2]] = True

    bad = sel_rows[~cert]
    if len(bad):
        ext = np.asarray(mirror_points_device(jnp.asarray(points), box_l))
        for i, (rel, d_far, sel) in zip(
            bad, _device_candidates(tier_rows, bad, ext, points)
        ):
            ok = False
            if len(rel) >= 4 and np.isfinite(d_far):
                v_i, a_i, fa, nv, r_cell, ok = _host_cell_from_device(rel, d_far)
            if not ok:
                v_i, a_i, fa, nv, sel = _host_cell_best(ext, points[i], fallback_k)
            vol[i], area[i] = v_i, a_i
            o = sel % P
            keep = (sel < P) & (o < num) & (fa[: len(sel)] > 1e-12)
            np.add.at(
                contacts[i], o[keep],
                (np.where(nv[: len(sel)] >= 4, 2.0, 1.0) * fa[: len(sel)])[keep],
            )
    # symmetrize from the better-certified side (device cells agree to fp
    # tolerance; fallback rows are authoritative for their own row)
    contacts = np.maximum(contacts, contacts.T)
    atom_area = area[None, :num].copy()
    atom_vol = vol[None, :num].copy()
    wat_area = (2.0 * atom_area - contacts[:num].sum(axis=1)[None, :]).copy()
    return contacts, atom_area, wat_area, atom_vol, int(cert.sum())
