"""Vectorized geometric primitives.

JAX replacements for the scalar Fortran helpers in the reference
(/root/reference/fortran/waterlib.f90): `Centroid` (:9-15), `crossProd3`
(:18-29), `RgWeights` (:50-64), `CosAngle3` (:683-703), `AngBetween`
(:954-965), `watOrient` (:973-1010), `watOHvec` (:1018-1044), `calcSD`
(:923-951), `SpherePoints` (:68-87), `tetraCosAng` (:867-895),
`lsiDists` (:900-918).

All functions are pure jnp, batched over leading axes, and designed to be
`vmap`ped over frames / centers instead of looped per atom in Python.
Angles are returned in degrees to match the reference conventions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from waterorderlib_tpu.core import pbc

RAD2DEG = 180.0 / np.pi
DEG2RAD = np.pi / 180.0


def centroid(pos: jnp.ndarray, axis: int = -2) -> jnp.ndarray:
    """Mean of positions along the atom axis (waterlib.f90:9-15)."""
    return jnp.mean(pos, axis=axis)


def rg_weights(pos: jnp.ndarray, weights: jnp.ndarray) -> jnp.ndarray:
    """Mass-weighted radius of gyration (waterlib.f90:50-64).

    pos: (..., N, 3); weights: (..., N). Center is the *unweighted* centroid,
    matching the reference.
    """
    center = jnp.mean(pos, axis=-2, keepdims=True)
    sq = jnp.sum((pos - center) ** 2, axis=-1)
    return jnp.sqrt(jnp.sum(weights * sq, axis=-1) / jnp.sum(weights, axis=-1))


def cos_angle_deg(p1: jnp.ndarray, p2: jnp.ndarray, p3: jnp.ndarray) -> jnp.ndarray:
    """Angle (degrees) at vertex p2 formed by p1-p2-p3 (waterlib.f90:683-703).

    Degenerate inputs (p1==p2 or p2==p3) return 0, matching the reference.
    Broadcasts over leading dims.
    """
    v21 = p1 - p2
    v23 = p3 - p2
    n1 = jnp.sum(v21 * v21, axis=-1)
    n2 = jnp.sum(v23 * v23, axis=-1)
    norm = jnp.sqrt(n1 * n2)
    cosv = jnp.where(norm > 0, jnp.sum(v21 * v23, axis=-1) / jnp.where(norm > 0, norm, 1.0), 1.0)
    ang = jnp.degrees(jnp.arccos(jnp.clip(cosv, -1.0, 1.0)))
    degenerate = (n1 == 0) | (n2 == 0)
    return jnp.where(degenerate, 0.0, ang)


def angle_between_deg(v1: jnp.ndarray, v2: jnp.ndarray) -> jnp.ndarray:
    """Angle (degrees) between *normalized* vectors (waterlib.f90:954-965)."""
    cosv = jnp.clip(jnp.sum(v1 * v2, axis=-1), -1.0, 1.0)
    return jnp.degrees(jnp.arccos(cosv))


def pair_angles_deg(
    ref: jnp.ndarray, neigh: jnp.ndarray, box: jnp.ndarray
) -> jnp.ndarray:
    """All 3-body angles (deg) among neighbors with `ref` at the vertex.

    Vectorized `tetraCosAng` (waterlib.f90:867-895): neighbors are imaged
    around ref first; returns the symmetric (..., K, K) matrix with zero
    diagonal.

    ref: (..., 3); neigh: (..., K, 3); box: (3,).
    """
    rel = pbc.minimum_image(neigh - ref[..., None, :], box)  # (..., K, 3)
    norms = jnp.linalg.norm(rel, axis=-1)  # (..., K)
    dots = jnp.einsum("...id,...jd->...ij", rel, rel, precision=jax.lax.Precision.HIGHEST)
    denom = norms[..., :, None] * norms[..., None, :]
    cosv = jnp.where(denom > 0, dots / jnp.where(denom > 0, denom, 1.0), 1.0)
    ang = jnp.degrees(jnp.arccos(jnp.clip(cosv, -1.0, 1.0)))
    k = neigh.shape[-2]
    eye = jnp.eye(k, dtype=bool)
    return jnp.where(eye, 0.0, ang)


def imaged_distances(ref: jnp.ndarray, neigh: jnp.ndarray, box: jnp.ndarray) -> jnp.ndarray:
    """Minimum-image distances from ref to each neighbor (waterlib.f90:900-918)."""
    return pbc.distance(ref[..., None, :], neigh, box)


def water_dipoles(
    opos: jnp.ndarray, hpos: jnp.ndarray, box: jnp.ndarray, normalize: bool = True
) -> jnp.ndarray:
    """Per-water dipole direction = sum of the two imaged OH vectors.

    Replaces `watOHvec` (waterlib.f90:1018-1044). opos: (..., Nw, 3);
    hpos: (..., 2*Nw, 3) ordered so hpos[2i], hpos[2i+1] belong to opos[i].
    """
    nw = opos.shape[-2]
    h = hpos.reshape(hpos.shape[:-2] + (nw, 2, 3))
    oh = pbc.minimum_image(h - opos[..., :, None, :], box)
    dip = pbc.minimum_image(jnp.sum(oh, axis=-2), box)
    if normalize:
        dip = dip / jnp.linalg.norm(dip, axis=-1, keepdims=True)
    return dip


def water_orientation(
    opos: jnp.ndarray, hpos: jnp.ndarray, refvec: jnp.ndarray, box: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-water (dipole-vs-ref, plane-normal-vs-ref) angles in degrees.

    Replaces `watOrient` (waterlib.f90:973-1010).
    """
    nw = opos.shape[-2]
    h = hpos.reshape(hpos.shape[:-2] + (nw, 2, 3))
    oh = pbc.minimum_image(h - opos[..., :, None, :], box)  # (..., Nw, 2, 3)
    dip = pbc.minimum_image(jnp.sum(oh, axis=-2), box)
    dip = dip / jnp.linalg.norm(dip, axis=-1, keepdims=True)
    plane = jnp.cross(oh[..., 0, :], oh[..., 1, :])
    plane = plane / jnp.linalg.norm(plane, axis=-1, keepdims=True)
    ref = refvec / jnp.linalg.norm(refvec, axis=-1, keepdims=True)
    return angle_between_deg(dip, ref), angle_between_deg(plane, ref)


def squared_displacement(
    pos: jnp.ndarray, prev_pos: jnp.ndarray, ref_pos: jnp.ndarray, box: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Unwrapped squared displacement per coordinate (waterlib.f90:923-951).

    Returns (sd (..., N, 3), new_pos (..., N, 3)) where new_pos is the
    PBC-unwrapped continuation of prev_pos and sd = (new_pos - ref_pos)**2.
    The MSD building block.
    """
    step = pbc.minimum_image(pos - prev_pos, box)
    new_pos = prev_pos + step
    sd = (new_pos - ref_pos) ** 2
    return sd, new_pos


def sphere_points(n: int) -> np.ndarray:
    """Golden-spiral points on the unit sphere (waterlib.f90:68-87;
    surface_library.py:41-53). Host-side (static geometry), returns (n, 3).
    """
    inc = np.pi * (3.0 - np.sqrt(5.0))
    off = 2.0 / n
    k = np.arange(n, dtype=np.float64)
    y = k * off - 1.0 + off / 2.0
    r = np.sqrt(np.maximum(0.0, 1.0 - y * y))
    phi = k * inc
    return np.stack([np.cos(phi) * r, y, np.sin(phi) * r], axis=1)
