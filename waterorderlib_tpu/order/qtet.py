"""Errington-Debenedetti tetrahedral order parameter q.

JAX replacement for `getOrderParamq`
(/root/reference/structureLibs/water_properties.py:344-391). The reference
loops over waters in Python, calling f2py `reimage`/`tetracosang` per center;
here the 4-nearest-neighbor search is a blocked on-device top-k and the
6 pair angles are computed for all centers at once.

Padding semantics match the reference exactly (wp:379-384): with c neighbors
inside the (low, high] shell, the 6 angle slots are filled with the
C(min(c,4),2) real angles among the min(c,4) nearest neighbors and padded to
6 with 180-degree angles (cos = -1); centers with c = 0 get q = 0 (which is
also the value the all-180 padding yields, so one uniform rule applies).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from waterorderlib_tpu.core import pbc
from waterorderlib_tpu.ops import pairs
from waterorderlib_tpu.utils.logging import log_once

_PAIR_I, _PAIR_J = jnp.triu_indices(4, k=1)  # the 6 neighbor pairs

# the windowed GPU path: rows whose 4th neighbour lies within MARGIN are
# certified; 32-row tiles were the fastest on the H100 (PERF.md)
MARGIN = 4.5
ROW_TILE = 32


def q_from_neighbors(
    sub: jnp.ndarray, neigh: pairs.NeighborList, pos: jnp.ndarray, box: jnp.ndarray
) -> jnp.ndarray:
    """q per center given a (Ns, >=4) NeighborList (ascending distance)."""
    idx4 = neigh.idx[..., :4]
    ok4 = neigh.valid[..., :4]
    npos = pos[idx4]  # (Ns, 4, 3)
    rel = pbc.minimum_image(npos - sub[..., None, :], box)
    norm = jnp.linalg.norm(rel, axis=-1)
    unit = rel / jnp.where(norm > 0, norm, 1.0)[..., None]
    cosmat = jnp.einsum("...id,...jd->...ij", unit, unit, precision=jax.lax.Precision.HIGHEST)
    cos_pairs = cosmat[..., _PAIR_I, _PAIR_J]  # (Ns, 6)
    pair_ok = ok4[..., _PAIR_I] & ok4[..., _PAIR_J]
    cos_pairs = jnp.where(pair_ok, cos_pairs, -1.0)
    q = 1.0 - (3.0 / 8.0) * jnp.sum((cos_pairs + 1.0 / 3.0) ** 2, axis=-1)
    return jnp.where(neigh.count > 0, q, 0.0)


@partial(jax.jit, static_argnames=("row_block",))
def order_param_q(
    sub: jnp.ndarray,
    pos: jnp.ndarray,
    box: jnp.ndarray,
    low_cut: float = 0.0,
    high_cut: float = 10.0,
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
) -> jnp.ndarray:
    """q for each row of `sub` against candidate positions `pos`.

    Matches getOrderParamq(subPos, Pos, BoxDims, lowCut, highCut); returns
    (Ns,) float values in [-3, 1] (1 = perfect tetrahedron).
    """
    neigh = pairs.topk_neighbors(
        sub, pos, box, k=4, low_cut=low_cut, high_cut=high_cut, row_block=row_block
    )
    return q_from_neighbors(sub, neigh, pos, box)


@partial(jax.jit, static_argnames=("row_block",))
def order_param_q_traj(pos, boxes, low_cut=0.0, high_cut=10.0,
                       row_block=pairs.DEFAULT_ROW_BLOCK):
    """`order_param_q` of every frame of a (F, N, 3) trajectory -> (F, N)."""
    return jax.lax.map(
        lambda a: order_param_q(a[0], a[0], a[1], low_cut, high_cut, row_block),
        (pos, boxes),
    )


@partial(jax.jit, static_argnames=("row_tile", "window", "pad", "interpret"))
def order_param_q_windowed(pos, boxes, low_cut, high_cut, margin, *, row_tile,
                           window, pad, interpret=False):
    """q from the windowed GPU neighbour kernel: (q (F, N), exact (F, N),
    covered (F,)). The epilogue is `q_from_neighbors`, as on the XLA path."""
    from waterorderlib_tpu.ops.gpu import window_knn

    nb = window_knn.knn_traj(
        pos, boxes, low_cut, high_cut, margin, k=4, row_tile=row_tile,
        window=window, pad=pad, interpret=interpret,
    )
    q = jax.vmap(q_from_neighbors)(pos, nb.neigh, pos, boxes)
    return q, nb.exact, nb.covered


def order_param_q_certified(pos, boxes, low_cut=0.0, high_cut=10.0, interpret=False):
    """q (F, N) of a whole trajectory through the windowed GPU kernel, with
    certified exactness (host-level: checks certificates, not jittable).
    Returns (q, tier): which path served the call, "window", "window+patch"
    or "xla" (drivers log it).

    Rows whose certificate fails (4th neighbour beyond MARGIN, a few per
    million in condensed phases) are recomputed on the XLA path and patched
    in. A window that missed part of its slab (a sparse or strongly layered box), or
    more than 0.1% of rows uncertified, sends the whole call to the XLA
    all-pairs path `order_param_q_traj`, with a log entry.
    """
    from waterorderlib_tpu.ops import slab

    pos = jnp.asarray(pos)
    boxes = jnp.asarray(boxes)
    n = pos.shape[1]
    box_z = float(boxes[0, 2])
    window = slab.suggest_window(n, box_z, margin=MARGIN, row_tile=ROW_TILE)
    pad = slab.suggest_pad(n, box_z, MARGIN)
    reason = "window would not prune"
    if window < n and n >= 128:
        q, exact, covered = order_param_q_windowed(
            pos, boxes, low_cut, high_cut, MARGIN, row_tile=ROW_TILE,
            window=window, pad=pad, interpret=interpret,
        )
        reason = "window coverage certificate failed"
        if bool(jnp.all(covered)):
            n_bad = int(jnp.sum(~exact))
            if n_bad == 0:
                return q, "window"
            reason = f"{n_bad} rows uncertified"
            if n_bad < 1e-3 * exact.size:
                bad = np.argwhere(~np.asarray(exact))
                q = q.at[bad[:, 0], bad[:, 1]].set(
                    _q_rows(pos, boxes, bad, low_cut, high_cut)
                )
                return q, "window+patch"
    log_once(
        ("order_param_q_certified", reason),
        "order_param_q_certified: %s; serving the XLA all-pairs path", reason,
        level="warning",
    )
    return order_param_q_traj(pos, boxes, low_cut, high_cut), "xla"


def _q_rows(pos, boxes, rows, low_cut, high_cut):
    """q of selected (frame, atom) rows on the XLA path; the row count is
    padded to a power of two so straggler patches reuse one compile."""
    m = len(rows)
    size = max(8, 1 << int(np.ceil(np.log2(m))))
    rows = np.concatenate([rows, np.repeat(rows[:1], size - m, axis=0)])
    q = _q_rows_jit(pos, boxes, jnp.asarray(rows[:, 0]), jnp.asarray(rows[:, 1]),
                    low_cut, high_cut)
    return q[:m]


@jax.jit
def _q_rows_jit(pos, boxes, f, i, low_cut, high_cut):
    def one(fi):
        p, b = pos[fi[0]], boxes[fi[0]]
        return order_param_q(p[fi[1]][None], p, b, low_cut, high_cut, row_block=1)[0]

    return jax.lax.map(one, (f, i))
