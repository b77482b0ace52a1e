"""Isosurface mesh builders around a solute.

Replaces `sasaGrid` (/root/reference/structureLibs/surface_library.py:120-167),
`densityGrid` (:170-210) and `densityVoxel` (:213-241). The scalar fields
(signed SASA distance, Willard-Chandler density, raw box-count density) are
computed on device by the blocked XLA grid sweeps; isosurface extraction runs
host-side marching tetrahedra (surface.mesh) since no Qhull/skimage exists
in this stack.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from waterorderlib_tpu.density import fields
from waterorderlib_tpu.ops import pairs
from waterorderlib_tpu.surface.mesh import marching_tetrahedra


def sasa_grid(heavy_pos: np.ndarray, box: np.ndarray, cutoff: np.ndarray, n_bins: int = 50):
    """SASA-style isosurface mesh (surface_library.py:120-167): on a grid
    spanning 0.8*min..1.2*max of the heavy atoms, evaluate the signed field
    min_j(d(grid, atom_j)^2 - cutoff_j^2) and extract the zero level set.
    cutoff: per-atom radii (e.g. vdW + probe). Returns (verts, faces)."""
    heavy_pos = np.asarray(heavy_pos, float)
    lo = 0.8 * heavy_pos.min(axis=0)
    hi = 1.2 * heavy_pos.max(axis=0)
    axes = [np.linspace(lo[d], hi[d], n_bins) for d in range(3)]
    pts = fields.make_grid(*axes)
    metric = pairs.signed_sq_metric(
        jnp.asarray(pts, jnp.float32), jnp.asarray(heavy_pos, jnp.float32),
        jnp.asarray(box, jnp.float32), jnp.asarray(cutoff, jnp.float32),
    )
    field = np.asarray(jnp.min(metric, axis=1)).reshape(n_bins, n_bins, n_bins)
    spacing = [(hi[d] - lo[d]) / (n_bins - 1) for d in range(3)]
    # negative inside the surface; extract the 0 level of -field so normals
    # (toward higher values) point outward
    verts, faces = marching_tetrahedra(-field, 0.0, spacing=spacing, origin=lo)
    return verts, faces


def density_grid(
    heavy_pos: np.ndarray,
    wat_pos: np.ndarray,
    box: np.ndarray,
    level: float = 0.016,
    smoothlen: float = 2.4,
    n_bins: int = 81,
):
    """Willard-Chandler instantaneous interface mesh
    (surface_library.py:170-210): coarse-grained water density on a cube
    spanning the solute extent plus half a box, isosurface at ~half bulk
    density. Returns (verts, faces) centered like the reference (mesh
    shifted so its extent is centered at the origin)."""
    heavy_pos = np.asarray(heavy_pos, float)
    all_min = float(heavy_pos.min())
    all_max = float(heavy_pos.max())
    half = float(np.asarray(box).reshape(-1)[0]) / 2.0
    span = np.linspace(all_min - half, all_max + half, n_bins)
    spacing = span[1] - span[0]
    g = span[:-1] + spacing  # the reference drops the first edge (:192-194)
    n = len(g)
    dens, _ = fields.willard_density_field(
        jnp.asarray(wat_pos, jnp.float32),
        jnp.asarray(g, jnp.float32), jnp.asarray(g, jnp.float32), jnp.asarray(g, jnp.float32),
        jnp.asarray(box, jnp.float32).reshape(-1), smoothlen, nx=n, ny=n, nz=n,
    )
    verts, faces = marching_tetrahedra(
        np.asarray(dens), level, spacing=(spacing,) * 3, origin=(0.0, 0.0, 0.0)
    )
    if len(verts):
        verts = verts - all_min
        verts = verts - 0.5 * verts.max()
    return verts, faces


def density_voxel(heavy_pos: np.ndarray, wat_pos: np.ndarray, box: np.ndarray, n_bins: int = 11):
    """Raw box-count density voxels around the solute
    (surface_library.py:213-241). Returns (n_bins-1,)^3 density values."""
    heavy_pos = np.asarray(heavy_pos, float)
    lo = 0.8 * heavy_pos.min(axis=0)
    hi = 1.2 * heavy_pos.max(axis=0)
    axes = []
    for d in range(3):
        span = np.linspace(lo[d], hi[d], n_bins)
        w = span[1] - span[0]
        axes.append(span[:-1] + w)
    n = n_bins - 1
    dens = fields.density_field(
        jnp.asarray(wat_pos, jnp.float32),
        jnp.asarray(axes[0], jnp.float32), jnp.asarray(axes[1], jnp.float32),
        jnp.asarray(axes[2], jnp.float32),
        jnp.asarray(box, jnp.float32).reshape(-1), nx=n, ny=n, nz=n,
    )
    return np.asarray(dens)
