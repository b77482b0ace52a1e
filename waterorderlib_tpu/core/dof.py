"""Curvilinear degrees of freedom for 1-3 water molecules (Lazaridis-Karplus
convention) and the matching curvature-aware distance metrics.

JAX replacements for `get1BodyDOFs`/`get2BodyDOFs`/`get3BodyDOFs`
(/root/reference/structureLibs/water_properties.py:787-921) and
`distanceMetric1B/2B/3B` (wp:924-977; duplicated in Fortran at
waterlib.f90:1474-1543). All functions are elementwise over leading batch
axes, so `vmap`/`jit` fuse them over molecule sets; coordinates must already
be minimum-imaged (same contract as the reference).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

R_SQ = 0.09572**2
SIN_TW = float(np.sin(np.radians(104.52)) ** 2)


def _unit(v):
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def _acos_dot(a, b):
    return jnp.arccos(jnp.clip(jnp.sum(a * b, axis=-1), -1.0, 1.0))


def one_body_dofs(coord_o, coord_h1, coord_h2) -> jnp.ndarray:
    """6 DOFs of a single water (wp:787-840): oxygen xyz, dipole azimuth
    (arctan2), dipole polar angle, and rotation about the dipole measured
    against the z-reference plane. Shapes (..., 3) -> (..., 6)."""
    r_od = _unit(0.5 * (coord_h1 + coord_h2) - coord_o)
    r_hh = _unit(coord_h2 - coord_h1)
    unit_ref = jnp.array([0.0, 0.0, 1.0], coord_o.dtype)
    cross_x = _unit(jnp.cross(r_od, jnp.broadcast_to(unit_ref, r_od.shape)))
    return jnp.concatenate(
        [
            coord_o,
            jnp.arctan2(r_od[..., 1], r_od[..., 0])[..., None],
            jnp.arccos(jnp.clip(r_od[..., 2], -1.0, 1.0))[..., None],
            _acos_dot(r_hh, cross_x)[..., None],
        ],
        axis=-1,
    )


def two_body_dofs(o1, h11, h12, o2, h21, h22) -> jnp.ndarray:
    """6 relative DOFs of a water pair (wp:853-884): rO1O2, theta1, theta2,
    phi, chi1, chi2. The donor-ordering rule (H nearer the other oxygen
    first, wp:869-877) is reproduced with a `where`."""
    r12 = o2 - o1
    d12 = jnp.linalg.norm(r12, axis=-1, keepdims=True)
    u12 = r12 / d12
    u21 = -u12
    d1 = _unit(0.5 * (h11 + h12) - o1)
    d2 = _unit(0.5 * (h21 + h22) - o2)

    swap1 = jnp.linalg.norm(h11 - o2, axis=-1) <= jnp.linalg.norm(h12 - o2, axis=-1)
    hh1 = _unit(jnp.where(swap1[..., None], h12 - h11, h11 - h12))
    swap2 = jnp.linalg.norm(h21 - o1, axis=-1) <= jnp.linalg.norm(h22 - o1, axis=-1)
    hh2 = _unit(jnp.where(swap2[..., None], h22 - h21, h21 - h22))

    c1 = _unit(jnp.cross(u12, d1))
    c2 = _unit(jnp.cross(d2, u21))
    return jnp.stack(
        [
            d12[..., 0],
            _acos_dot(d1, u12),
            _acos_dot(d2, u21),
            _acos_dot(c1, c2),
            _acos_dot(hh1, c1),
            _acos_dot(hh2, c2),
        ],
        axis=-1,
    )


def three_body_dofs(o1, h11, h12, o2, h21, h22, o3, h31, h32) -> jnp.ndarray:
    """6 three-body DOFs (wp:887-921): rO1O3, theta_3b, omega (rotation of
    water 3 about O1-O2), then theta3/phi3/chi3 of the third water."""
    u12 = _unit(o2 - o1)
    r13 = o3 - o1
    d13 = jnp.linalg.norm(r13, axis=-1, keepdims=True)
    u13 = r13 / d13
    u31 = -u13
    d1 = _unit(0.5 * (h11 + h12) - o1)
    d3 = _unit(0.5 * (h31 + h32) - o3)
    swap3 = jnp.linalg.norm(h31 - o1, axis=-1) <= jnp.linalg.norm(h32 - o1, axis=-1)
    hh3 = _unit(jnp.where(swap3[..., None], h32 - h31, h31 - h32))
    c12 = _unit(jnp.cross(u12, d1))
    c13 = _unit(jnp.cross(u13, d1))
    c31 = _unit(jnp.cross(d3, u31))
    rperp = _unit(u13 - jnp.sum(u12 * u13, axis=-1, keepdims=True) * u12)
    return jnp.stack(
        [
            d13[..., 0],
            _acos_dot(u12, u13),
            _acos_dot(rperp, c12),
            _acos_dot(d3, u31),
            _acos_dot(c13, c31),
            _acos_dot(hh3, c31),
        ],
        axis=-1,
    )


def distance_metric_1b(vec1, vec2, r_sq: float = R_SQ, sin_tw: float = SIN_TW):
    """Curvature-aware metric on 6-dim 1-body DOF vectors (wp:924-936)."""
    d = (vec2 - vec1) ** 2
    return jnp.sqrt(
        d[..., 0] + d[..., 1] + d[..., 2] + r_sq * d[..., 3]
        + r_sq * jnp.sin(vec2[..., 3]) * jnp.sin(vec1[..., 3]) * d[..., 4]
        + r_sq * sin_tw * d[..., 5]
    )


def distance_metric_2b(vec1, vec2, r_sq: float = R_SQ, sin_tw: float = SIN_TW):
    """Metric on 12-dim (1-body + 2-body) DOF vectors (wp:939-954)."""
    d = (vec2 - vec1) ** 2
    return jnp.sqrt(
        d[..., 0] + d[..., 1] + d[..., 2] + r_sq * d[..., 3]
        + r_sq * jnp.sin(vec2[..., 3]) * jnp.sin(vec1[..., 3]) * d[..., 4]
        + r_sq * sin_tw * d[..., 5]
        + d[..., 6] + r_sq * d[..., 7] + r_sq * d[..., 8]
        + r_sq * jnp.sin(vec2[..., 8]) * jnp.sin(vec1[..., 8]) * d[..., 9]
        + r_sq * sin_tw * d[..., 10] + r_sq * sin_tw * d[..., 11]
    )


def distance_metric_3b(vec1, vec2, r_sq: float = R_SQ, sin_tw: float = SIN_TW):
    """Metric on 18-dim (1+2+3-body) DOF vectors (wp:957-977)."""
    d = (vec2 - vec1) ** 2
    return jnp.sqrt(
        d[..., 0] + d[..., 1] + d[..., 2] + r_sq * d[..., 3]
        + r_sq * jnp.sin(vec2[..., 3]) * jnp.sin(vec1[..., 3]) * d[..., 4]
        + r_sq * sin_tw * d[..., 5]
        + d[..., 6] + r_sq * d[..., 7] + r_sq * d[..., 8]
        + r_sq * jnp.sin(vec2[..., 8]) * jnp.sin(vec1[..., 8]) * d[..., 9]
        + r_sq * sin_tw * d[..., 10] + r_sq * sin_tw * d[..., 11]
        + d[..., 12] + vec2[..., 12] * vec1[..., 12] * d[..., 13]
        + vec2[..., 12] * vec1[..., 12]
        * jnp.sin(vec2[..., 13]) * jnp.sin(vec1[..., 13]) * d[..., 14]
        + r_sq * d[..., 15]
        + r_sq * jnp.sin(vec2[..., 15]) * jnp.sin(vec1[..., 15]) * d[..., 16]
        + r_sq * sin_tw * d[..., 17]
    )
