"""Density fields on grids: raw box-count, Willard-Chandler coarse-grained,
spherical probe volumes, and interface-water bookkeeping.

JAX replacements for the grid kernels in
/root/reference/fortran/waterlib.f90: `DensityField` (:1220-1268),
`WillardDensityField` (:1286-1341), `WillardDensityPoints` (:1351-1398),
`probeGrid` (:1106-1134), `binOnGrid` (:1047-1099), and `InterfaceWater`
(:1414-1469).

These are the highest-FLOP kernels in the library (G^3 x N Gaussian
evaluations per frame for the Willard field); here the G^3 grid is flattened
and processed in row blocks against all atoms at once, so the work is a
dense VPU sweep instead of a quadruple Fortran loop.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from waterorderlib_tpu.core import pbc
from waterorderlib_tpu.ops.pairs import DEFAULT_ROW_BLOCK, _pad_rows, _block_rows


def make_grid(gridx, gridy, gridz) -> jnp.ndarray:
    """Flattened (Nx*Ny*Nz, 3) grid points from per-axis coordinates,
    x-major to match the Fortran (i, j, k) loop order."""
    gx, gy, gz = (np.asarray(g) for g in (gridx, gridy, gridz))
    pts = np.stack(np.meshgrid(gx, gy, gz, indexing="ij"), axis=-1)
    return pts.reshape(-1, 3)


@partial(jax.jit, static_argnames=("row_block",))
def willard_density_points(
    pos: jnp.ndarray,
    pts: jnp.ndarray,
    box: jnp.ndarray,
    smoothlen: float = 2.4,
    row_block: int = DEFAULT_ROW_BLOCK,
):
    """Truncated-shifted Gaussian density + unit normals at arbitrary points
    (waterlib.f90:1351-1398). Returns (dens (P,), norms (P, 3)).

    The Gaussian is truncated at 3*sigma and shifted so it reaches zero
    there (ref :1303, :1320-1330); normals point along the density gradient.
    """
    sig2 = smoothlen * smoothlen
    shift = np.exp(-4.5) / (2.0 * np.pi * sig2) ** 1.5

    def one_block(blk):
        d = pbc.minimum_image(blk[:, None, :] - pos[None, :, :], box)  # (B, N, 3)
        rsq = jnp.sum(d * d, axis=-1)
        inside = rsq < 9.0 * sig2
        g = jnp.exp(-rsq / (2.0 * sig2)) / (2.0 * np.pi * sig2) ** 1.5
        dens_f = jnp.where(inside, g - shift, 0.0)
        # gradient term: -r_vec * g / sigma^2 (ref :1330); here d = pt - wat
        norm_f = jnp.where(inside[..., None], -d * g[..., None] / sig2, 0.0)
        dens = jnp.sum(dens_f, axis=1)
        normvec = jnp.sum(norm_f, axis=1)
        nn = jnp.linalg.norm(normvec, axis=-1, keepdims=True)
        return dens, normvec / jnp.where(nn > 0, nn, 1.0)

    block = min(row_block, max(1, pts.shape[0]))
    padded, n = _pad_rows(pts, block)
    dens, norms = jax.lax.map(one_block, _block_rows(padded, block))
    return dens.reshape(-1)[:n], norms.reshape(-1, 3)[:n]


@partial(jax.jit, static_argnames=("nx", "ny", "nz", "row_block"))
def willard_density_field(
    pos: jnp.ndarray,
    gridx: jnp.ndarray,
    gridy: jnp.ndarray,
    gridz: jnp.ndarray,
    box: jnp.ndarray,
    smoothlen: float = 2.4,
    nx: int = 0,
    ny: int = 0,
    nz: int = 0,
    row_block: int = DEFAULT_ROW_BLOCK,
):
    """Willard-Chandler field on a regular grid (waterlib.f90:1286-1341).
    Returns (dens (Nx, Ny, Nz), norms (Nx, Ny, Nz, 3)). nx/ny/nz are the
    static grid sizes (pass gridx.shape[0] etc.)."""
    pts = jnp.stack(
        jnp.meshgrid(gridx, gridy, gridz, indexing="ij"), axis=-1
    ).reshape(-1, 3)
    dens, norms = willard_density_points(pos, pts, box, smoothlen, row_block)
    return dens.reshape(nx, ny, nz), norms.reshape(nx, ny, nz, 3)


@partial(jax.jit, static_argnames=("nx", "ny", "nz", "row_block"))
def density_field(
    pos: jnp.ndarray,
    gridx: jnp.ndarray,
    gridy: jnp.ndarray,
    gridz: jnp.ndarray,
    box: jnp.ndarray,
    nx: int = 0,
    ny: int = 0,
    nz: int = 0,
    row_block: int = DEFAULT_ROW_BLOCK,
):
    """Raw box-count density (waterlib.f90:1220-1268): atoms reimaged around
    each grid point and counted if within +-binwidth/2 along every axis
    (inclusive edges), normalized by binwidth^3."""
    binwidth = gridx[1] - gridx[0]
    pts = jnp.stack(
        jnp.meshgrid(gridx, gridy, gridz, indexing="ij"), axis=-1
    ).reshape(-1, 3)

    def one_block(blk):
        d = pbc.minimum_image(pos[None, :, :] - blk[:, None, :], box)  # (B, N, 3)
        inside = jnp.all(jnp.abs(d) <= binwidth / 2.0, axis=-1)
        return jnp.sum(inside, axis=1).astype(jnp.float32)

    block = min(row_block, max(1, pts.shape[0]))
    padded, n = _pad_rows(pts, block)
    counts = jax.lax.map(one_block, _block_rows(padded, block)).reshape(-1)[:n]
    return (counts / binwidth**3).reshape(nx, ny, nz)


@partial(jax.jit, static_argnames=("row_block",))
def probe_grid(
    pos: jnp.ndarray,
    grid_pos: jnp.ndarray,
    box: jnp.ndarray,
    probe_radius: float,
    row_block: int = DEFAULT_ROW_BLOCK,
) -> jnp.ndarray:
    """Count positions within probe_radius (inclusive) of each grid point
    (waterlib.f90:1106-1134)."""

    def one_block(blk):
        dsq = jnp.sum(
            pbc.minimum_image(pos[None, :, :] - blk[:, None, :], box) ** 2, axis=-1
        )
        return jnp.sum(dsq <= probe_radius * probe_radius, axis=1).astype(jnp.int32)

    block = min(row_block, max(1, grid_pos.shape[0]))
    padded, n = _pad_rows(grid_pos, block)
    return jax.lax.map(one_block, _block_rows(padded, block)).reshape(-1)[:n]


@partial(jax.jit, static_argnames=("nx", "ny", "nz"))
def bin_on_grid(
    opos: jnp.ndarray,
    xbins: jnp.ndarray,
    ybins: jnp.ndarray,
    zbins: jnp.ndarray,
    nx: int,
    ny: int,
    nz: int,
) -> jnp.ndarray:
    """Bin positions onto a uniform cubic grid, counting only points inside
    the sphere inscribed in each cell (waterlib.f90:1047-1099). nx/ny/nz are
    the static *bin-edge* counts; output is (nx-1, ny-1, nz-1) int32."""
    w = xbins[1] - xbins[0]
    radsq = w * w / 4.0
    ix = jnp.floor((opos[:, 0] - xbins[0]) / w).astype(jnp.int32)
    iy = jnp.floor((opos[:, 1] - ybins[0]) / w).astype(jnp.int32)
    iz = jnp.floor((opos[:, 2] - zbins[0]) / w).astype(jnp.int32)
    ok = (ix >= 0) & (ix < nx - 1) & (iy >= 0) & (iy < ny - 1) & (iz >= 0) & (iz < nz - 1)
    cx = xbins[0] + (jnp.clip(ix, 0, nx - 2).astype(opos.dtype) + 0.5) * w
    cy = ybins[0] + (jnp.clip(iy, 0, ny - 2).astype(opos.dtype) + 0.5) * w
    cz = zbins[0] + (jnp.clip(iz, 0, nz - 2).astype(opos.dtype) + 0.5) * w
    dsq = (opos[:, 0] - cx) ** 2 + (opos[:, 1] - cy) ** 2 + (opos[:, 2] - cz) ** 2
    ok = ok & (dsq <= radsq)
    flat = (
        jnp.clip(ix, 0, nx - 2) * ((ny - 1) * (nz - 1))
        + jnp.clip(iy, 0, ny - 2) * (nz - 1)
        + jnp.clip(iz, 0, nz - 2)
    )
    hist = jnp.zeros((nx - 1) * (ny - 1) * (nz - 1), jnp.int32).at[
        jnp.where(ok, flat, 0)
    ].add(ok.astype(jnp.int32))
    return hist.reshape(nx - 1, ny - 1, nz - 1)


class InterfaceWaterResult(NamedTuple):
    wat_close: jnp.ndarray  # (Nw,) index of closest surface point per water
    surf_close: jnp.ndarray  # (Ng,) index of closest water per surface point
    num_water: jnp.ndarray  # scalar: waters with projected distance <= cutoff
    wat_dists: jnp.ndarray  # (Nw,) signed distance to interface (projection)


@partial(jax.jit, static_argnames=("row_block",))
def interface_water(
    pos: jnp.ndarray,
    grid_pos: jnp.ndarray,
    grid_norm: jnp.ndarray,
    box: jnp.ndarray,
    cutoff: float,
    row_block: int = DEFAULT_ROW_BLOCK,
) -> InterfaceWaterResult:
    """Closest-point bookkeeping between waters and interface points
    (waterlib.f90:1414-1469): nearest surface point per water, nearest water
    per surface point, per-water signed distance along the local surface
    normal, and the count with projection <= cutoff."""

    def one_block(blk):
        # blk: (B, 3) water positions
        d = pbc.minimum_image(blk[:, None, :] - grid_pos[None, :, :], box)
        dsq = jnp.sum(d * d, axis=-1)  # (B, Ng)
        wclose = jnp.argmin(dsq, axis=1).astype(jnp.int32)
        dmin = jnp.min(dsq, axis=1)
        # projection of (water - closest surface point) onto its normal
        nvec = grid_norm[wclose]
        dvec = pbc.minimum_image(blk - grid_pos[wclose], box)
        proj = jnp.sum(dvec * nvec, axis=-1)
        return wclose, dmin, proj, dsq

    block = min(row_block, max(1, pos.shape[0]))
    padded, n = _pad_rows(pos, block)
    wclose_b, dmin_b, proj_b, dsq_b = jax.lax.map(one_block, _block_rows(padded, block))
    wat_close = wclose_b.reshape(-1)[:n]
    proj = proj_b.reshape(-1)[:n]
    dsq_full = dsq_b.reshape(-1, grid_pos.shape[0])[:n]  # (Nw, Ng)
    surf_close = jnp.argmin(dsq_full, axis=0).astype(jnp.int32)
    num_water = jnp.sum(proj <= cutoff).astype(jnp.int32)
    return InterfaceWaterResult(wat_close, surf_close, num_water, proj)
