"""Periodic-boundary-condition primitives.

JAX replacement for the inline minimum-image arithmetic used by every
Fortran kernel in the reference (`distvec - BoxL*anint(distvec*iBoxL)`,
e.g. /root/reference/fortran/waterlib.f90:741, :848) and for `reimage`
(waterlib.f90:32-47).

Everything here is pure `jax.numpy`, shape-polymorphic over leading batch
dimensions, and `vmap`/`jit` friendly. Boxes are orthorhombic, represented as
a length-3 vector of box edge lengths; a non-positive component disables
wrapping along that axis (matching the Fortran
`merge(1/BoxL, 0, BoxL >= 0)` convention).
"""

from __future__ import annotations

import jax.numpy as jnp


def inverse_box(box: jnp.ndarray) -> jnp.ndarray:
    """1/box with zeros where the box edge is non-positive (no wrapping).

    Mirrors `iBoxL = merge(1.d0/BoxL, 0.d0, BoxL >= 0.d0)` used by every
    reference kernel. (Note the reference uses >= 0, so a zero edge would
    divide by zero there; we guard it.)
    """
    box = jnp.asarray(box)
    safe = jnp.where(box > 0, box, 1.0)
    return jnp.where(box > 0, 1.0 / safe, 0.0)


def minimum_image(disp: jnp.ndarray, box: jnp.ndarray) -> jnp.ndarray:
    """Apply the minimum-image convention to displacement vectors.

    disp: (..., 3) displacement(s); box: (3,) edge lengths (or broadcastable).
    Returns the wrapped displacement `disp - box * round(disp / box)`.

    The Fortran `anint` rounds half away from zero while `jnp.round` rounds
    half to even; the two differ only on the measure-zero set where a
    component of disp/box is exactly +/-0.5.
    """
    ibox = inverse_box(box)
    return disp - box * jnp.round(disp * ibox)


def displacement(a: jnp.ndarray, b: jnp.ndarray, box: jnp.ndarray) -> jnp.ndarray:
    """Minimum-image displacement b - a, shapes broadcast over (..., 3)."""
    return minimum_image(b - a, box)


def distance_sq(a: jnp.ndarray, b: jnp.ndarray, box: jnp.ndarray) -> jnp.ndarray:
    """Squared minimum-image distance between broadcast position arrays."""
    d = displacement(a, b, box)
    return jnp.sum(d * d, axis=-1)


def distance(a: jnp.ndarray, b: jnp.ndarray, box: jnp.ndarray) -> jnp.ndarray:
    """Minimum-image distance between broadcast position arrays."""
    return jnp.sqrt(distance_sq(a, b, box))


def reimage(pos: jnp.ndarray, ref: jnp.ndarray, box: jnp.ndarray) -> jnp.ndarray:
    """Wrap positions to the minimum image around a reference point.

    Replaces `reimage` (waterlib.f90:32-47): returns `ref + mi(pos - ref)`,
    i.e. each position translated by integer box vectors so it lies within
    half a box of `ref` along every periodic axis.

    pos: (..., 3); ref: (3,) or broadcastable; box: (3,).
    """
    return ref + minimum_image(pos - ref, box)


def wrap_into_box(pos: jnp.ndarray, box: jnp.ndarray) -> jnp.ndarray:
    """Wrap positions into [0, box) along each periodic axis."""
    ibox = inverse_box(box)
    wrapped = pos - box * jnp.floor(pos * ibox)
    return jnp.where(box > 0, wrapped, pos)
