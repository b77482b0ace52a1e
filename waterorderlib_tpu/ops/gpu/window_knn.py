"""K nearest neighbours inside z-slab windows: a Pallas kernel for the GPU.

Replaces the all-pairs search (`ops.pairs.topk_neighbors`: a (rows, N)
distance block and a sort-based `lax.top_k` over all N lanes per row) for
whole trajectories whose frames share one z-ordering (`ops.slab`). Each
program owns one tile of z-sorted rows of one frame and walks its own
contiguous column window in `chunk`-wide pieces. Distances stay in
registers; each row carries a sorted top-K of (squared distance, column)
and merges a chunk into it only while the chunk still holds a candidate
nearer than the row's current K-th, so chunks far from the tile in z cost
one reduction each.

The kernel is written for the Triton route (`backend="triton"`): the grid
is (frames, row tiles), each program loads its own window start, and K is
static, so callers with other shell sizes reuse it.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from waterorderlib_tpu.ops import pairs, slab


def _min_image(d, box_l, inv_l):
    return d - box_l * jnp.floor(d * inv_l + 0.5)


def _kernel(params_ref, boxes_ref, starts_ref, ext_ref, dsq_ref, col_ref, cnt_ref,
            *, k, row_tile, chunk, n_chunks, pad):
    f = pl.program_id(0)
    i = pl.program_id(1)
    low_sq = params_ref[0]
    high_sq = params_ref[1]
    box = [boxes_ref[f, a] for a in range(3)]
    inv = [1.0 / b for b in box]
    row0 = pad + i * row_tile
    rows = [plgpu.load(ext_ref.at[f, a, pl.ds(row0, row_tile)])[:, None] for a in range(3)]
    start = starts_ref[f, i]
    lane = jax.lax.broadcasted_iota(jnp.int32, (row_tile, chunk), 1)
    big = jnp.int32(2**30)

    def insert(best_d, best_c, m, c):
        # one pass of a sorted insertion: slot s takes (m, c) if strictly
        # nearer, and the displaced entry moves on to slot s + 1 (ties keep
        # the earlier column, which was merged first)
        out_d, out_c = [], []
        for s in range(k):
            take = m < best_d[s]
            out_d.append(jnp.where(take, m, best_d[s]))
            out_c.append(jnp.where(take, c, best_c[s]))
            m, c = jnp.where(take, best_d[s], m), jnp.where(take, best_c[s], c)
        return tuple(out_d), tuple(out_c)

    def one_chunk(j, carry):
        best_d, best_c, cnt = carry
        c0 = start + j * chunk
        dsq = jnp.zeros((row_tile, chunk), jnp.float32)
        for a in range(3):
            cols = plgpu.load(ext_ref.at[f, a, pl.ds(c0, chunk)])[None, :]
            d = _min_image(cols - rows[a], box[a], inv[a])
            dsq = dsq + d * d
        valid = (dsq > low_sq) & (dsq <= high_sq)
        cnt = cnt + jnp.sum(valid.astype(jnp.int32), axis=1)
        dsq = jnp.where(valid, dsq, jnp.inf)
        m = jnp.min(dsq, axis=1)

        def improves(state):
            _, bd, _, m = state
            return jnp.max((m < bd[k - 1]).astype(jnp.int32)) > 0

        def extract(state):
            dsq, bd, bc, m = state
            first = jnp.min(jnp.where(dsq == m[:, None], lane, big), axis=1)
            bd, bc = insert(bd, bc, m, c0 + first)
            dsq = jnp.where(lane == first[:, None], jnp.inf, dsq)
            return dsq, bd, bc, jnp.min(dsq, axis=1)

        _, best_d, best_c, _ = jax.lax.while_loop(
            improves, extract, (dsq, best_d, best_c, m)
        )
        return best_d, best_c, cnt

    init = (
        tuple(jnp.full((row_tile,), jnp.inf, jnp.float32) for _ in range(k)),
        tuple(jnp.full((row_tile,), -1, jnp.int32) for _ in range(k)),
        jnp.zeros((row_tile,), jnp.int32),
    )
    best_d, best_c, cnt = jax.lax.fori_loop(0, n_chunks, one_chunk, init)
    out = pl.ds(i * row_tile, row_tile)
    for s in range(k):
        plgpu.store(dsq_ref.at[f, s, out], best_d[s])
        plgpu.store(col_ref.at[f, s, out], best_c[s])
    plgpu.store(cnt_ref.at[f, out], cnt)


@partial(jax.jit, static_argnames=("k", "row_tile", "chunk", "window", "pad",
                                   "interpret"))
def window_knn(ext_t, boxes, starts, low_cut, high_cut, *, k, row_tile, chunk,
               window, pad, interpret=False):
    """Top-K per z-sorted row of every frame inside its tile's window.

    ext_t: (F, 3, n_ext) extended coordinates with the N sorted rows at
    [pad, pad + N); starts: (F, n_tiles) window start columns; window: a
    multiple of `chunk` with start + window <= n_ext.

    Returns (dsq (F, K, n_tiles*row_tile) ascending squared distances, +inf
    in empty slots; col (F, K, .) extended-array columns, -1 in empty slots;
    count (F, .) shell members seen in the window).
    """
    F = ext_t.shape[0]
    n_tiles = starts.shape[1]
    n_rows = n_tiles * row_tile
    params = jnp.stack([
        jnp.asarray(low_cut, jnp.float32) ** 2,
        jnp.asarray(high_cut, jnp.float32) ** 2,
    ])
    kernel = partial(
        _kernel, k=k, row_tile=row_tile, chunk=chunk, n_chunks=window // chunk,
        pad=pad,
    )
    return pl.pallas_call(
        kernel,
        grid=(F, n_tiles),
        out_shape=(
            jax.ShapeDtypeStruct((F, k, n_rows), jnp.float32),
            jax.ShapeDtypeStruct((F, k, n_rows), jnp.int32),
            jax.ShapeDtypeStruct((F, n_rows), jnp.int32),
        ),
        backend="triton",
        # 4 warps beat 8 at 32-row tiles on the H100 (PERF.md)
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="window_knn",
    )(params, boxes.astype(jnp.float32), starts, ext_t)


class TrajNeighbors(NamedTuple):
    neigh: pairs.NeighborList  # (F, N, K) per frame, indices into atoms
    exact: jnp.ndarray         # (F, N) bool: row's top-K is the true one
    covered: jnp.ndarray       # (F,) bool: every window held its slab


@partial(jax.jit, static_argnames=("k", "row_tile", "window", "pad", "chunk",
                                   "interpret"))
def knn_traj(pos, boxes, low_cut, high_cut, margin, *, k, row_tile, window,
             pad, chunk=128, interpret=False):
    """Windowed K nearest neighbours of every atom in every frame.

    pos: (F, N, 3); boxes: (F, 3). Neighbour lists are in the original atom
    order and have the `pairs.topk_neighbors` layout. A row is `exact` when
    its K-th neighbour lies within `margin` (or the whole shell does), since
    every candidate within `margin` is inside its window whenever `covered`
    holds; `count` is then exact too for shells within `margin`.
    """
    n = pos.shape[1]
    prep = slab.slab_prep_traj(pos, boxes, margin, row_tile, window, pad, chunk)
    dsq, col, cnt = window_knn(
        prep.ext_t, boxes, prep.starts, low_cut, high_cut, k=k,
        row_tile=row_tile, chunk=chunk, window=prep.w, pad=pad,
        interpret=interpret,
    )
    dsq = jnp.transpose(dsq, (0, 2, 1))[:, :n]
    col = jnp.transpose(col, (0, 2, 1))[:, :n]
    valid = col >= 0
    # extended column -> sorted slot -> atom, per frame
    idx = jnp.where(valid, jax.vmap(lambda o, c: o[c])(prep.order, jnp.mod(col - pad, n)), 0)
    exact = (valid[..., k - 1] & (dsq[..., k - 1] <= margin * margin)) | (
        high_cut * high_cut <= margin * margin
    )
    neigh = pairs.NeighborList(
        *(slab.unsort_frames(a, prep.order)
          for a in (jnp.sqrt(dsq), idx, valid, cnt[:, :n]))
    )
    return TrajNeighbors(neigh, slab.unsort_frames(exact, prep.order), prep.covered)
