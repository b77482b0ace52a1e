"""Hexagonal order parameter psi_6 (Dallin & Van Lehn 2019).

JAX replacement for `getOrderParamPsi`
(/root/reference/structureLibs/water_properties.py:393-433): for each center,
psi = | mean over neighbor pairs of exp(6i * theta) | where theta is the
3-body angle (degrees -> radians) between every pair of in-shell neighbors
with the center at the vertex. Centers with < 2 neighbors get psi = 0.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from waterorderlib_tpu.ops import pairs
from waterorderlib_tpu.order.angles import neighbor_angles


@partial(jax.jit, static_argnames=("k", "row_block"))
def order_param_psi(
    sub: jnp.ndarray,
    pos: jnp.ndarray,
    box: jnp.ndarray,
    low_cut: float = 0.0,
    high_cut: float = 10.0,
    k: int = 16,
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
) -> jnp.ndarray:
    angset = neighbor_angles(
        sub, pos, box, low_cut=low_cut, high_cut=high_cut, k=k, row_block=row_block
    )
    theta = jnp.radians(angset.ang) * 6.0
    ok = angset.valid
    n_pairs = jnp.sum(ok, axis=(-1, -2))
    denom = jnp.maximum(n_pairs, 1)
    re = jnp.sum(jnp.where(ok, jnp.cos(theta), 0.0), axis=(-1, -2)) / denom
    im = jnp.sum(jnp.where(ok, jnp.sin(theta), 0.0), axis=(-1, -2)) / denom
    psi = jnp.sqrt(re * re + im * im)
    return jnp.where(angset.count > 1, psi, 0.0)
