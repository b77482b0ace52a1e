"""Water-orientation analyses and sub-volume P(N) statistics.

Replaces `waterOrientation`/`waterOrientationBinZ`
(/root/reference/structureLibs/water_properties.py:578-638) and
`binnedVolumePofN` (wp:641-676). The 2-D (angle, z) histogram runs on device
via a flattened scatter-add with np.histogram2d edge semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from waterorderlib_tpu.core import geometry
from waterorderlib_tpu.density import fields


def water_orientation(o_pos, h_pos, box, ref_vec=(0.0, 0.0, 1.0)):
    """(dipole angles, plane-normal angles) in degrees per water
    (wp:622-638 wrapping watOrient)."""
    ref = jnp.asarray(ref_vec, jnp.asarray(o_pos).dtype)
    return geometry.water_orientation(jnp.asarray(o_pos), jnp.asarray(h_pos), ref, jnp.asarray(box))


def _hist2d(x, y, x_edges, y_edges):
    """np.histogram2d semantics on device: uniform-edge assumption-free
    digitize via searchsorted; right-most edge inclusive."""
    xi = jnp.searchsorted(x_edges, x, side="right") - 1
    yi = jnp.searchsorted(y_edges, y, side="right") - 1
    nx = x_edges.shape[0] - 1
    ny = y_edges.shape[0] - 1
    xi = jnp.where(x == x_edges[-1], nx - 1, xi)
    yi = jnp.where(y == y_edges[-1], ny - 1, yi)
    ok = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
    flat = jnp.where(ok, xi * ny + yi, 0)
    return (
        jnp.zeros(nx * ny, jnp.float32).at[flat].add(ok.astype(jnp.float32)).reshape(nx, ny)
    )


def water_orientation_bin_z(
    o_pos, h_pos, box, ref_vec=(0.0, 0.0, 1.0), ref_bins=None, ang_bins=None
):
    """2-D histograms of (plane angle, z) and (dipole angle, z)
    (wp:578-620). Returns (plane_hist, dip_hist) with angle bins on rows.

    Note the reference histograms the *plane* angles against a per-hydrogen
    duplicated z coordinate (zOposforH, wp:600-601) even though watOrient
    emits one plane angle per water — so only the first half of that
    duplicated array pairs up. np.histogram2d truncates to the shorter
    length... it actually raises instead; in practice refBins pairs with
    per-water z, which is what we use for both histograms."""
    o_pos = jnp.asarray(o_pos)
    ref = jnp.asarray(ref_vec, o_pos.dtype)
    ref = ref / jnp.linalg.norm(ref)
    z = jnp.matmul(o_pos, ref, precision=jax.lax.Precision.HIGHEST)
    dip, plane = geometry.water_orientation(o_pos, jnp.asarray(h_pos), ref, jnp.asarray(box))
    if ref_bins is None:
        ref_bins = np.arange(float(jnp.min(z)), float(jnp.max(z)), 0.2)
    if ang_bins is None:
        ang_bins = np.arange(0.0, 180.001, 180.0 / 500.0)
    ref_bins = jnp.asarray(ref_bins)
    ang_bins = jnp.asarray(ang_bins)
    plane_hist = _hist2d(plane, z, ang_bins, ref_bins)
    dip_hist = _hist2d(dip, z, ang_bins, ref_bins)
    return plane_hist, dip_hist


def binned_volume_pofn(o_pos, vol_bins, num_bins, bin_mask=None):
    """P(N) in cubic sub-volumes (wp:641-676): bin waters onto the grid
    counting only those inside each cell's inscribed sphere (bin_on_grid),
    then histogram the per-cell counts with `num_bins` edges."""
    xb, yb, zb = (jnp.asarray(b) for b in vol_bins)
    nx, ny, nz = len(vol_bins[0]), len(vol_bins[1]), len(vol_bins[2])
    hist = fields.bin_on_grid(jnp.asarray(o_pos), xb, yb, zb, nx, ny, nz)
    hist = np.asarray(hist)
    if bin_mask is None:
        bin_mask = np.ones((nx - 1, ny - 1, nz - 1), dtype=bool)
    if bin_mask.shape != (nx - 1, ny - 1, nz - 1):
        raise ValueError("bin_mask shape does not match spatial bins")
    counts, _ = np.histogram(hist[bin_mask].ravel(), bins=np.asarray(num_bins))
    return counts
