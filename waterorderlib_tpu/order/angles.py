"""Three-body neighbor angles and tetrahedral metrics.

JAX replacement for `getCosAngs`
(/root/reference/structureLibs/water_properties.py:210-250) and
`tetrahedralMetrics` (wp:314-342). The reference builds a ragged, growing
numpy array of angles by calling f2py `tetracosang` once per water; here all
angles live in a fixed-shape (Ns, K, K) tensor with a validity mask, and the
angle *histogram* (what every consumer actually wants) is computed on device
without ever materializing the ragged list.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from waterorderlib_tpu.core import pbc
from waterorderlib_tpu.ops import pairs


class AngleSet(NamedTuple):
    """Fixed-shape set of 3-body angles.

    ang:   (..., Ns, K, K) angles in degrees (upper triangle meaningful).
    valid: (..., Ns, K, K) True for real neighbor pairs (i<j only).
    count: (..., Ns)       neighbors per center (numAngs of the reference,
                           which despite its docstring stores the neighbor
                           count, wp:249).
    """

    ang: jnp.ndarray
    valid: jnp.ndarray
    count: jnp.ndarray


@partial(jax.jit, static_argnames=("k", "row_block"))
def neighbor_angles(
    sub: jnp.ndarray,
    pos: jnp.ndarray,
    box: jnp.ndarray,
    low_cut: float = 0.0,
    high_cut: float = 3.413,
    k: int = 16,
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
) -> AngleSet:
    """All 3-body angles among each center's shell neighbors.

    Equivalent to getCosAngs(subPos, Pos, ...) but returning fixed shapes:
    the K nearest in-shell neighbors are kept (K should exceed the max shell
    occupancy; counts are returned so callers can check).
    """
    neigh = pairs.topk_neighbors(
        sub, pos, box, k=k, low_cut=low_cut, high_cut=high_cut, row_block=row_block
    )
    npos = pos[neigh.idx]  # (Ns, K, 3)
    rel = pbc.minimum_image(npos - sub[..., None, :], box)
    norm = jnp.linalg.norm(rel, axis=-1)
    unit = rel / jnp.where(norm > 0, norm, 1.0)[..., None]
    cosmat = jnp.einsum("...id,...jd->...ij", unit, unit, precision=jax.lax.Precision.HIGHEST)
    ang = jnp.degrees(jnp.arccos(jnp.clip(cosmat, -1.0, 1.0)))
    iu = jnp.triu(jnp.ones((k, k), bool), k=1)
    valid = neigh.valid[..., :, None] & neigh.valid[..., None, :] & iu
    return AngleSet(ang=ang, valid=valid, count=neigh.count)


def angle_histogram(
    angles: AngleSet, n_bins: int = 500, lo: float = 0.0, hi: float = 180.0
) -> jnp.ndarray:
    """Histogram of valid angles with numpy-histogram bin semantics
    ([lo,hi] split into n_bins, right-inclusive last bin), matching
    np.histogram in tetrahedralMetrics (wp:325)."""
    from waterorderlib_tpu.ops.histograms import masked_histogram

    return masked_histogram(angles.ang, angles.valid, n_bins, lo, hi)


class TetMetrics(NamedTuple):
    hist: jnp.ndarray  # (n_bins,) angle counts
    frac_tet: jnp.ndarray  # fraction of angles in [100, 120] degrees
    avg_cos: jnp.ndarray  # mean cos(angle) within the tetrahedral window
    var_cos: jnp.ndarray  # population variance of cos within the window
    entropy: jnp.ndarray  # Shannon entropy of the normalized histogram
    n_angles: jnp.ndarray  # total valid angles


def tetrahedral_metrics(
    angles: AngleSet, n_bins: int = 500, lo: float = 0.0, hi: float = 180.0
) -> TetMetrics:
    """Fused replacement for `tetrahedralMetrics` (wp:314-342).

    frac_tet integrates the [100, 120]-degree window (inclusive, wp:330);
    avg/var cos are over that window; entropy is the Shannon entropy of the
    normalized angle histogram, skipping empty bins.
    """
    hist = angle_histogram(angles, n_bins=n_bins, lo=lo, hi=hi)
    v = angles.ang
    ok = angles.valid
    n_tot = jnp.sum(ok)
    tet = ok & (v >= 100.0) & (v <= 120.0)
    n_tet = jnp.sum(tet)
    cosv = jnp.cos(jnp.radians(v))
    denom = jnp.maximum(n_tet, 1)
    avg = jnp.sum(jnp.where(tet, cosv, 0.0)) / denom
    var = jnp.sum(jnp.where(tet, (cosv - avg) ** 2, 0.0)) / denom
    dens = hist / jnp.maximum(jnp.sum(hist), 1.0)
    ent = -jnp.sum(jnp.where(dens > 0, dens * jnp.log(jnp.where(dens > 0, dens, 1.0)), 0.0))
    frac = n_tet / jnp.maximum(n_tot, 1)
    return TetMetrics(hist, frac, avg, var, ent, n_tot)


def pair_angles_from_positions(
    ref: jnp.ndarray, neigh_pos: jnp.ndarray, box: jnp.ndarray
) -> jnp.ndarray:
    """Direct analog of f2py `tetracosang(refPos, neighPos, BoxL)`
    (waterlib.f90:867-895): symmetric (K, K) degree matrix, zero diagonal."""
    rel = pbc.minimum_image(neigh_pos - ref[..., None, :], box)
    norm = jnp.linalg.norm(rel, axis=-1)
    unit = rel / jnp.where(norm > 0, norm, 1.0)[..., None]
    cosmat = jnp.einsum("...id,...jd->...ij", unit, unit, precision=jax.lax.Precision.HIGHEST)
    ang = jnp.degrees(jnp.arccos(jnp.clip(cosmat, -1.0, 1.0)))
    k = neigh_pos.shape[-2]
    return jnp.where(jnp.eye(k, dtype=bool), 0.0, ang)
