"""Z-slab windows for neighbour searches over a whole trajectory.

Sort each frame's coordinates by its own z, extend the sorted array with
wrapped copies of the boundary slabs so periodic neighbours stay contiguous,
and give each tile of rows one contiguous column window wide enough to hold
every candidate within `margin` of the tile. Since every frame has its own
ordering and its own box, atoms that diffuse between frames and boxes that
change size (NPT) need no allowance. Exactness is certified, not assumed:
`covered` checks that every tile's window held all of its slab candidates,
frame by frame.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class SlabPrep(NamedTuple):
    ext_t: jnp.ndarray    # (F, 3, n_ext) extended z-sorted coordinates
    starts: jnp.ndarray   # (F, n_tiles) first window column of each row tile
    covered: jnp.ndarray  # (F,) bool: every window held its slab candidates
    order: jnp.ndarray    # (F, N) per-frame z-ordering (sorted slot -> atom)
    w: int                # static window width actually used
    n_tiles: int


def slab_prep_traj(
    pos: jnp.ndarray,
    boxes: jnp.ndarray,
    margin: float,
    row_tile: int,
    window: int,
    pad: int,
    chunk: int = 128,
) -> SlabPrep:
    """Per-frame z-ordering prep for a whole trajectory.

    pos: (F, N, 3); boxes: (F, 3) orthorhombic edges. The window width is a
    multiple of `chunk` and never exceeds N: a wider window could hold an
    atom and its periodic copy, counting that neighbour twice.
    """
    n = pos.shape[1]
    n_pad_rows = -(-n // row_tile) * row_tile
    n_tiles = n_pad_rows // row_tile
    if n_pad_rows - n > pad:
        raise ValueError("row_tile remainder exceeds the boundary pad")
    w = min(-(-window // chunk) * chunk, (n // chunk) * chunk)
    if w <= 0:
        raise ValueError(f"n={n} is smaller than one column chunk ({chunk})")

    wrapped = jnp.mod(pos, boxes[:, None, :])
    order = jnp.argsort(wrapped[..., 2], axis=1)
    sp = jnp.take_along_axis(wrapped, order[..., None], axis=1)
    shift = jnp.zeros_like(boxes).at[:, 2].set(boxes[:, 2])[:, None, :]
    ext = jnp.concatenate([sp[:, -pad:] - shift, sp, sp[:, :pad] + shift], axis=1)
    n_ext = ext.shape[1]

    def windows(ext_z, zs):
        tile_first = jnp.arange(n_tiles) * row_tile
        tile_last = jnp.minimum(tile_first + row_tile - 1, n - 1)
        z_lo = zs[tile_first] - margin
        z_hi = zs[tile_last] + margin
        starts = jnp.searchsorted(ext_z, z_lo, side="left")
        ends = jnp.searchsorted(ext_z, z_hi, side="right")
        starts = jnp.clip(starts, 0, n_ext - w)
        # the boundary slabs must be at least `margin` deep in z, or
        # cross-boundary candidates fall outside ext while the windows look
        # covered
        pad_ok = (ext_z[0] <= z_lo[0]) & (ext_z[-1] >= z_hi[-1])
        return starts, jnp.all(ends - starts <= w) & pad_ok

    starts, covered = jax.vmap(windows)(ext[..., 2], sp[..., 2])
    ext_t = jnp.transpose(ext, (0, 2, 1)).astype(jnp.float32)
    return SlabPrep(ext_t, starts.astype(jnp.int32), covered, order, w, n_tiles)


def suggest_window(n: int, box_z: float, margin: float = 4.5, row_tile: int = 64,
                   safety: float = 1.35, chunk: int = 128) -> int:
    """Window width (a multiple of `chunk`) expected to cover a row tile's
    slab; the `covered` certificate checks it at run time."""
    tile_extent = row_tile / n * box_z
    slab = tile_extent + 2.0 * margin
    est = n * slab / box_z * safety + 2 * chunk
    return int(-(-est // chunk) * chunk)


def suggest_pad(n: int, box_z: float, depth: float, safety: float = 1.6) -> int:
    """Boundary-copy count (multiple of 128, capped at n) whose z extent is
    expected to exceed `depth` (the margin). The `covered` certificate still
    verifies sufficiency at run time."""
    est = n * depth / box_z * safety + 128
    return int(min(n, -(-est // 128) * 128))


def unsort_frames(arr_sorted: jnp.ndarray, order: jnp.ndarray) -> jnp.ndarray:
    """(F, N, ...) results from each frame's z-order back to atom order."""
    def one(src, o):
        inv = jnp.zeros_like(o).at[o].set(jnp.arange(o.shape[0], dtype=o.dtype))
        return src[inv]

    return jax.vmap(one)(arr_sorted, order)
