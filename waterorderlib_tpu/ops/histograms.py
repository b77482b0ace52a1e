"""On-device histograms with numpy-compatible bin semantics.

Every reference driver ends in `np.histogram(vals, bins=N, range=[lo, hi])`
over a ragged concatenated value list (e.g. orderParam_lib.py:1494-1497).
Here values come with validity masks instead of ragged shapes, and the
histogram is a fixed-shape scatter-add that runs inside jit, vmaps over
populations/frames, and sums across shards with `psum`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("n_bins",))
def masked_histogram(
    values: jnp.ndarray,
    mask: jnp.ndarray,
    n_bins: int,
    lo: float,
    hi: float,
) -> jnp.ndarray:
    """Histogram of `values[mask]` over [lo, hi] with np.histogram semantics:
    n_bins equal bins, left-inclusive, the final bin right-inclusive; values
    outside [lo, hi] are dropped."""
    # Threshold formulation (no scatter-add): the histogram is built from
    # cumulative threshold counts cum[k] = #values < lo + k*width and
    # differenced.
    # Out-of-range values cancel in the differences; the right edge is
    # added to the last bin explicitly (np.histogram semantics).
    width = (hi - lo) / n_bins
    flat = values.reshape(-1)
    m = mask.reshape(-1)
    thresholds = lo + jnp.arange(n_bins + 1, dtype=values.dtype) * width
    chunk = 64
    cums = []
    for k0 in range(0, n_bins + 1, chunk):
        t = thresholds[k0 : k0 + chunk]
        lt = (flat[:, None] < t[None, :]) & m[:, None]
        cums.append(jnp.sum(lt.astype(jnp.float32), axis=0))
    cum = jnp.concatenate(cums)
    hist = cum[1:] - cum[:-1]
    right_edge = jnp.sum(((flat == hi) & m).astype(jnp.float32))
    return hist.at[n_bins - 1].add(right_edge)


def bin_centers(n_bins: int, lo: float, hi: float):
    """Midpoints 0.5*(edges[:-1]+edges[1:]) as the drivers print them."""
    import numpy as np

    edges = np.linspace(lo, hi, n_bins + 1)
    return 0.5 * (edges[:-1] + edges[1:])


def masked_mean_var(values: jnp.ndarray, mask: jnp.ndarray, axis=-1):
    """(mean, population variance) over masked entries; NaN when empty,
    matching np.mean/np.var on an empty selection."""
    m = mask.astype(values.dtype)
    n = jnp.sum(m, axis=axis)
    safe_n = jnp.maximum(n, 1.0)
    mean = jnp.sum(values * m, axis=axis) / safe_n
    var = jnp.sum(m * (values - jnp.expand_dims(mean, axis)) ** 2, axis=axis) / safe_n
    nan = jnp.float32(jnp.nan)
    return jnp.where(n > 0, mean, nan), jnp.where(n > 0, var, nan)
