"""Local structure index (LSI) of Shiratani & Sasai.

JAX replacement for `getLSI`
(/root/reference/structureLibs/water_properties.py:252-311): per center,
take all neighbors in the (low, high] shell plus the single nearest neighbor
beyond `high` (searched in (high, high+3.7]), sort the minimum-image
distances, and return the population variance of the consecutive gaps.

One blocked top-k sweep over the (low, high+3.7] shell serves both shells
(the reference makes two separate N^2 passes): in-shell members are the
ascending-distance prefix with dist <= high, and the "next" neighbor is
selected among the remaining candidates.

Reference quirks reproduced deliberately:
- the next neighbor is chosen by argmin of the *raw* (non-imaged) distance
  (wp:289-291) even though its distance contribution is minimum-imaged;
  (like the previous two-pass implementation, the argmin considers the K
  nearest-by-imaged-distance candidates rather than every atom in the
  3.7..7.4 A annulus — identical except for pathological boundary cases);
- centers need >= 2 in-shell neighbors AND >= 1 next-shell candidate,
  otherwise no LSI value is produced (valid=False).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from waterorderlib_tpu.ops import pairs


class LSIResult(NamedTuple):
    lsi: jnp.ndarray  # (Ns,) LSI values (0 where invalid)
    valid: jnp.ndarray  # (Ns,) mask of centers with a defined LSI
    count: jnp.ndarray  # (Ns,) in-shell neighbor count (= number of gaps)


@partial(jax.jit, static_argnames=("k", "row_block"))
def lsi(
    sub: jnp.ndarray,
    pos: jnp.ndarray,
    box: jnp.ndarray,
    low_cut: float = 0.0,
    high_cut: float = 3.7,
    k: int = 24,
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
) -> LSIResult:
    cand = pairs.topk_neighbors(
        sub, pos, box, k=k, low_cut=low_cut, high_cut=high_cut + 3.7, row_block=row_block
    )
    near = cand.valid & (cand.dist <= high_cut)  # ascending-distance prefix
    n_near = jnp.sum(near, axis=-1)
    nxt = cand.valid & (cand.dist > high_cut)
    has_next = jnp.any(nxt, axis=-1)

    # reference picks the next-shell member minimizing the RAW distance
    # (wp:289-291) but then uses its minimum-image distance in the list
    cand_pos = pos[cand.idx]  # (Ns, K, 3)
    raw_d = jnp.linalg.norm(cand_pos - sub[:, None, :], axis=-1)
    raw_d = jnp.where(nxt, raw_d, jnp.inf)
    pick = jnp.argmin(raw_d, axis=-1)  # (Ns,)
    next_dist = jnp.take_along_axis(cand.dist, pick[:, None], axis=1)[:, 0]

    # near distances are the sorted prefix; gaps between consecutive near
    # entries plus the final (next - last near) gap
    d = cand.dist  # ascending, +inf padded
    gaps_inner = d[:, 1:] - d[:, :-1]  # (Ns, K-1): gap i = d[i+1]-d[i]
    slot = jnp.arange(k - 1)[None, :]
    inner_ok = slot < (n_near - 1)[:, None]
    last_near = jnp.take_along_axis(d, jnp.maximum(n_near - 1, 0)[:, None], axis=1)[:, 0]
    final_gap = next_dist - last_near

    n_gaps = n_near  # c near + 1 next -> c gaps
    denom = jnp.maximum(n_gaps, 1)
    sum_gaps = jnp.sum(jnp.where(inner_ok, gaps_inner, 0.0), axis=-1) + final_gap
    mean = sum_gaps / denom
    var = (
        jnp.sum(jnp.where(inner_ok, (gaps_inner - mean[:, None]) ** 2, 0.0), axis=-1)
        + (final_gap - mean) ** 2
    ) / denom
    ok = (n_near > 1) & has_next
    return LSIResult(jnp.where(ok, var, 0.0), ok, jnp.where(ok, n_gaps, 0))
