"""Spherical-harmonic neighborhood coefficients (Steinhardt / Keys-Iacovella-
Glotzer order parameters).

JAX replacement for `computeSphericalFourierCoeffs`
(/root/reference/structureLibs/water_properties.py:722-786): for each center,
the complex coefficient vector q_lm = mean over shell neighbors of
Y_lm(theta, phi), for l = minDegree..maxDegree, m = -l..l, packed exactly
like the reference into a (Ns, 1+maxDegree-minDegree, 2*maxDegree+1) complex
array (row l holds its 2l+1 values left-aligned, zero-padded).

The per-center Python loop + scipy.special.sph_harm of the reference becomes
one batched associated-Legendre recursion over the fixed-K neighbor tensor.
The recursion is vectorized over the m axis: all m-columns advance their
upward-in-l recurrence together on (M+1, Ns, K) tensors (13 fused steps for
l <= 12 instead of ~91 per-(l, m) op chains — the round-2 serial version
cost 153 ms/frame at 4k centers). Inactive columns (m > l) hold zeros until
their seeding step, so no masking junk ever enters the recurrence. The
device computation is entirely REAL float32 (no complex arithmetic on the
device); real/imaginary parts are assembled into the complex result on the
host.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from waterorderlib_tpu.core import pbc
from waterorderlib_tpu.ops import pairs


def _legendre_norms(max_degree: int) -> dict[tuple[int, int], float]:
    norms = {}
    for l in range(max_degree + 1):
        for m in range(0, l + 1):
            lognorm = 0.5 * (
                np.log(2 * l + 1) - np.log(4 * np.pi)
                + float(
                    np.sum(np.log(np.arange(1, l - m + 1)))
                    - np.sum(np.log(np.arange(1, l + m + 1)))
                )
            )
            norms[(l, m)] = float(np.exp(lognorm))
    return norms


# Associated-Legendre recurrences used by the batched core below (Condon-
# Shortley phase, matching scipy.special.sph_harm):
#   P_m^m     = (-1)^m (2m-1)!! (1-x^2)^(m/2)
#   P_{m+1}^m = x (2m+1) P_m^m
#   P_l^m     = ((2l-1) x P_{l-1}^m - (l+m-1) P_{l-2}^m) / (l-m)
#   Y_l^{-m}  = (-1)^m conj(Y_l^m)


@partial(jax.jit, static_argnames=("max_degree", "k", "row_block"))
def _coeff_sums_mpos(
    sub: jnp.ndarray,
    pos: jnp.ndarray,
    box: jnp.ndarray,
    low_cut: float,
    high_cut: float,
    max_degree: int,
    k: int,
    row_block: int,
):
    """Neighbor-averaged q_lm for m >= 0, all l at once.

    Returns (re (L_all, M+1, Ns), im (L_all, M+1, Ns), counts (Ns,)) with
    L_all = max_degree + 1; entries with m > l are zero. The m < 0 half
    follows from Y_l^{-m} = (-1)^m conj(Y_l^m) and is assembled on host.
    """
    neigh = pairs.topk_neighbors(
        sub, pos, box, k=k, low_cut=low_cut, high_cut=high_cut, row_block=row_block
    )
    rel = pbc.minimum_image(pos[neigh.idx] - sub[:, None, :], box)  # (Ns, K, 3)
    r = jnp.linalg.norm(rel, axis=-1)
    safe_r = jnp.where(r > 0, r, 1.0)
    x = jnp.clip(rel[..., 2] / safe_r, -1.0, 1.0)  # cos(polar), (Ns, K)
    azim = jnp.arctan2(rel[..., 1], rel[..., 0])
    sroot = jnp.sqrt(jnp.maximum(1.0 - x * x, 0.0))

    mm = max_degree
    m_col = np.arange(mm + 1, dtype=np.float32)[:, None, None]  # (M+1, 1, 1)
    dfact = np.array(
        [np.prod(np.arange(1, 2 * m, 2)) for m in range(mm + 1)], np.float32
    )
    sign = np.array([(-1.0) ** m for m in range(mm + 1)], np.float32)
    # P_m^m for every m at once: (-1)^m (2m-1)!! s^m, (M+1, Ns, K)
    pmm = (sign * dfact)[:, None, None] * sroot[None] ** m_col
    seed1 = x[None] * (2.0 * m_col + 1.0) * pmm  # P_{m+1}^m for every m

    # weights for the neighbor average, shared by every (l, m)
    w = neigh.valid.astype(jnp.float32)  # (Ns, K)
    wn = w / jnp.maximum(neigh.count, 1)[:, None]
    cosm = jnp.cos(m_col * azim[None])  # (M+1, Ns, K)
    sinm = jnp.sin(m_col * azim[None])
    norms_tbl = _legendre_norms(mm)
    norms = np.zeros((mm + 1, mm + 1), np.float32)  # (l, m), 0 for m > l
    for l in range(mm + 1):
        for m in range(l + 1):
            norms[l, m] = norms_tbl[(l, m)]

    re_rows, im_rows = [], []
    p_lm1 = jnp.zeros_like(pmm)  # P_{l-1} per m-column
    p_lm2 = jnp.zeros_like(pmm)  # P_{l-2} per m-column
    for l in range(mm + 1):
        lm = jnp.asarray(np.maximum(l - np.arange(mm + 1, dtype=np.float32), 1.0))
        gen = (
            (2.0 * l - 1.0) * x[None] * p_lm1 - (l - 1.0 + m_col) * p_lm2
        ) / lm[:, None, None]
        is_mm = np.arange(mm + 1) == l
        is_seed = np.arange(mm + 1) == l - 1
        p_l = jnp.where(
            jnp.asarray(is_mm)[:, None, None], pmm,
            jnp.where(jnp.asarray(is_seed)[:, None, None], seed1, gen),
        )
        base = jnp.asarray(norms[l])[:, None, None] * p_l  # (M+1, Ns, K)
        # HIGHEST: a default f32 contraction may run in TF32 on a GPU
        hi = jax.lax.Precision.HIGHEST
        re_rows.append(jnp.einsum("mnk,nk->mn", base * cosm, wn, precision=hi))
        im_rows.append(jnp.einsum("mnk,nk->mn", base * sinm, wn, precision=hi))
        p_lm2 = p_lm1
        p_lm1 = p_l
    re = jnp.stack(re_rows, axis=0)  # (L_all, M+1, Ns)
    im = jnp.stack(im_rows, axis=0)
    return re, im, neigh.count


def spherical_fourier_coeffs_real(
    sub: jnp.ndarray,
    pos: jnp.ndarray,
    box: jnp.ndarray,
    low_cut: float = 0.0,
    high_cut: float = 3.413,
    min_degree: int = 0,
    max_degree: int = 12,
    k: int = 16,
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
):
    """Returns (re (Ns, L, W), im (Ns, L, W), counts (Ns,)) as float32
    numpy arrays, with W = 2*max_degree + 1 and rows left-aligned exactly
    like the reference packing (water_properties.py:767-782)."""
    re_p, im_p, counts = _coeff_sums_mpos(
        jnp.asarray(sub), jnp.asarray(pos), jnp.asarray(box),
        float(low_cut), float(high_cut), max_degree, k,
        min(row_block, max(1, np.shape(sub)[0])),
    )
    re_p = np.asarray(re_p)  # (L_all, M+1, Ns)
    im_p = np.asarray(im_p)
    ns = re_p.shape[2]
    l_count = max_degree - min_degree + 1
    width = 2 * max_degree + 1
    re = np.zeros((ns, l_count, width), np.float32)
    im = np.zeros((ns, l_count, width), np.float32)
    for l in range(min_degree, max_degree + 1):
        row = l - min_degree
        for m in range(0, l + 1):
            re[:, row, l + m] = re_p[l, m]
            im[:, row, l + m] = im_p[l, m]
            if m > 0:  # Y_l^{-m} = (-1)^m conj(Y_l^m)
                sgn = (-1.0) ** m
                re[:, row, l - m] = sgn * re_p[l, m]
                im[:, row, l - m] = -sgn * im_p[l, m]
    return re, im, counts


def spherical_fourier_coeffs(
    sub, pos, box,
    low_cut: float = 0.0,
    high_cut: float = 3.413,
    min_degree: int = 0,
    max_degree: int = 12,
    k: int = 16,
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
):
    """Reference-shaped API: returns (coeffs (Ns, L, W) complex64 as a host
    numpy array, counts (Ns,)). The complex assembly happens on host, which
    keeps the device computation real."""
    re, im, counts = spherical_fourier_coeffs_real(
        jnp.asarray(sub), jnp.asarray(pos), jnp.asarray(box),
        low_cut, high_cut, min_degree, max_degree, k, row_block,
    )
    coeffs = np.asarray(re).astype(np.complex64)
    coeffs.imag = np.asarray(im)
    return coeffs, counts


def steinhardt_ql(coeffs, min_degree: int = 0) -> np.ndarray:
    """Rotationally invariant q_l = sqrt(4 pi / (2l+1) * sum_m |q_lm|^2)
    per center from the packed coefficient array (host numpy). (Ns, L)."""
    coeffs = np.asarray(coeffs)
    mag_sq = np.sum(np.abs(coeffs) ** 2, axis=-1)
    l_vals = np.arange(coeffs.shape[1]) + min_degree
    return np.sqrt(4.0 * np.pi / (2.0 * l_vals + 1.0) * mag_sq)
