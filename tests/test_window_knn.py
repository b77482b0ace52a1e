"""Windowed K-nearest-neighbour kernel (ops/gpu/window_knn.py) and the z-slab
windows it runs on (ops/slab.py).

On the CPU the kernel runs through the Pallas interpreter and is compared
with the all-pairs XLA search; its Triton lowering is checked by exporting
it for CUDA. Tests marked `gpu` compile it for the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from waterorderlib_tpu.io.synthetic import make_water_box
from waterorderlib_tpu.ops import pairs, slab
from waterorderlib_tpu.ops.gpu import window_knn
from waterorderlib_tpu.order import qtet


def _waters(n, n_frames=2, seed=1, **kw):
    top, traj = make_water_box(n, n_frames=n_frames, seed=seed, **kw)
    wi, _, _ = top.get_wat_inds()
    return (
        jnp.asarray(traj.positions[:, wi], jnp.float32),
        jnp.asarray(traj.boxes, jnp.float32),
    )


def _xla_neighbors(pos, boxes, k, low, high):
    return jax.vmap(
        lambda p, b: pairs.topk_neighbors(p, p, b, k=k, low_cut=low, high_cut=high)
    )(pos, boxes)


# (n, k, low_cut, high_cut, margin, row_tile): N not divisible by the tile,
# a lower cutoff, a shell inside the margin (exact counts), a wider K (its
# K-th neighbour needs a wider margin), and exactly two row tiles
CASES = {
    "nondivisible": (1000, 4, 0.0, 10.0, 4.5, 64),
    "low_cut": (1000, 4, 2.6, 10.0, 4.5, 64),
    "shell_in_margin": (700, 4, 0.0, 3.5, 4.5, 64),
    "k8": (1000, 8, 0.0, 10.0, 6.0, 32),
    "two_tiles": (2000, 4, 0.0, 3.0, 3.0, 1024),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_knn_interpret_matches_xla(case):
    n, k, low, high, margin, row_tile = CASES[case]
    pos, boxes = _waters(n)
    bz = float(boxes[0, 2])
    window = slab.suggest_window(n, bz, margin, row_tile)
    pad = slab.suggest_pad(n, bz, margin)
    nb = window_knn.knn_traj(
        pos, boxes, low, high, margin, k=k, row_tile=row_tile, window=window,
        pad=pad, interpret=True,
    )
    assert bool(nb.covered.all())
    assert bool(nb.exact.all())
    ref = _xla_neighbors(pos, boxes, k, low, high)
    np.testing.assert_array_equal(np.asarray(nb.neigh.valid), np.asarray(ref.valid))
    np.testing.assert_array_equal(np.asarray(nb.neigh.idx), np.asarray(ref.idx))
    ok = np.asarray(ref.valid)
    np.testing.assert_allclose(
        np.asarray(nb.neigh.dist)[ok], np.asarray(ref.dist)[ok], atol=1e-5
    )
    if high <= margin:  # the window holds the whole shell: counts are exact
        np.testing.assert_array_equal(np.asarray(nb.neigh.count), np.asarray(ref.count))
    if k == 4:
        q, exact, covered = qtet.order_param_q_windowed(
            pos, boxes, low, high, margin, row_tile=row_tile, window=window,
            pad=pad, interpret=True,
        )
        np.testing.assert_allclose(
            np.asarray(q), np.asarray(qtet.order_param_q_traj(pos, boxes, low, high)),
            atol=1e-5,
        )


def test_certified_q_falls_back_on_sparse_box(caplog):
    """A slab of atoms in a tall, mostly empty box fails the window
    coverage certificate (the windows are sized for the mean density): the
    certified path logs it and serves the XLA all-pairs result."""
    import logging

    from waterorderlib_tpu.utils import logging as wol_logging

    rs = np.random.RandomState(0)
    n = 2000
    box = np.array([40.0, 40.0, 200.0], np.float32)
    pts = rs.uniform(0, 1, (2, n, 3)) * np.array([40.0, 40.0, 2.0]) + [0, 0, 50.0]
    pos = jnp.asarray(pts, jnp.float32)
    boxes = jnp.asarray(np.tile(box, (2, 1)))
    wol_logging._LOGGED_ONCE.discard(
        ("order_param_q_certified", "window coverage certificate failed")
    )
    with caplog.at_level(logging.WARNING, logger="waterorderlib_tpu"):
        q, tier = qtet.order_param_q_certified(pos, boxes, 0.0, 10.0, interpret=True)
    assert tier == "xla"
    assert any("coverage certificate failed" in r.message for r in caplog.records)
    np.testing.assert_array_equal(
        np.asarray(q), np.asarray(qtet.order_param_q_traj(pos, boxes, 0.0, 10.0))
    )


def test_certified_q_patches_uncertified_rows():
    """An atom in an empty pocket has its 4th neighbour beyond the margin:
    its row is uncertified, recomputed on the XLA path and patched in."""
    pos, boxes = _waters(3000)
    p0 = np.asarray(pos[0])
    d = p0 - p0[0]
    d -= np.asarray(boxes[0]) * np.round(d / np.asarray(boxes[0]))
    r = np.linalg.norm(d, axis=1)
    keep = (r == 0) | (r > 5.0)
    pos = pos[:, keep]
    q, tier = qtet.order_param_q_certified(pos, boxes, 0.0, 10.0, interpret=True)
    assert tier == "window+patch"
    np.testing.assert_allclose(
        np.asarray(q), np.asarray(qtet.order_param_q_traj(pos, boxes, 0.0, 10.0)),
        atol=1e-6,
    )


def _knn_vs_xla(pos, boxes, row_tile=qtet.ROW_TILE):
    """Windowed K=4 search (interpreted) against the all-pairs search of
    each frame: every frame covered, every row certified and equal."""
    n, bz = pos.shape[1], float(boxes[0, 2])
    window = slab.suggest_window(n, bz, qtet.MARGIN, row_tile)
    pad = slab.suggest_pad(n, bz, qtet.MARGIN)
    nb = window_knn.knn_traj(
        pos, boxes, 0.0, 10.0, qtet.MARGIN, k=4, row_tile=row_tile,
        window=window, pad=pad, interpret=True,
    )
    ref = _xla_neighbors(pos, boxes, 4, 0.0, 10.0)
    assert bool(nb.covered.all()) and bool(nb.exact.all())
    np.testing.assert_array_equal(np.asarray(nb.neigh.idx), np.asarray(ref.idx))


def test_window_knn_diffusing_trajectory_matches_xla():
    """Waters that diffuse as liquid water does (0.23 A^2/ps, frames 10 ps
    apart, i.e. 2.3 per frame: several Angstrom between frames, far more
    than a window's slack over a batch): each frame is z-sorted on its own,
    so every window stays covered and every row matches the all-pairs
    search."""
    pos, boxes = _waters(1000, n_frames=6, seed=3, diffusion=2.3)
    p = np.asarray(pos)
    drift = np.abs(p[-1, :, 2] - p[0, :, 2])
    drift = np.minimum(drift, float(boxes[0, 2]) - drift)
    assert drift.max() > 6.0  # beyond the slack of frame-0 windows
    _knn_vs_xla(pos, boxes)


def test_window_knn_npt_trajectory_matches_xla():
    """Frames whose box breathes by +-3% (positions scaled with it): each
    frame's windows and boundary copies follow its own box, so every row
    matches the all-pairs search of its own frame."""
    pos, boxes = _waters(900, n_frames=3, seed=4)
    scale = jnp.asarray([1.0, 0.97, 1.03], jnp.float32)
    _knn_vs_xla(pos * scale[:, None, None], boxes * scale[:, None], row_tile=64)


@pytest.mark.parametrize("k,row_tile", [(4, 64), (16, 128)])
def test_window_knn_lowers_for_cuda(k, row_tile):
    """The kernel lowers to Triton IR for CUDA (exported from the CPU; the
    GPU compiler itself runs only on the card)."""
    from jax import export

    F, n, pad = 2, 1000, 512
    n_tiles = -(-n // row_tile)
    fn = jax.jit(
        lambda e, b, s: window_knn.window_knn(
            e, b, s, 0.0, 10.0, k=k, row_tile=row_tile, chunk=128, window=768,
            pad=pad,
        )
    )
    exp = export.export(
        fn, platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")],
    )(
        jax.ShapeDtypeStruct((F, 3, n + 2 * pad), jnp.float32),
        jax.ShapeDtypeStruct((F, 3), jnp.float32),
        jax.ShapeDtypeStruct((F, n_tiles), jnp.int32),
    )
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text and 'name = "window_knn"' in text


@pytest.mark.gpu
def test_window_knn_on_gpu_matches_xla():
    """The production tile on a diffusing 4,096-water trajectory."""
    pos, boxes = _waters(4096, n_frames=4, diffusion=2.3)
    bz = float(boxes[0, 2])
    window = slab.suggest_window(4096, bz, qtet.MARGIN, qtet.ROW_TILE)
    pad = slab.suggest_pad(4096, bz, qtet.MARGIN)
    q, exact, covered = qtet.order_param_q_windowed(
        pos, boxes, 0.0, 10.0, qtet.MARGIN, row_tile=qtet.ROW_TILE,
        window=window, pad=pad,
    )
    assert bool(covered.all()) and bool(exact.all())
    np.testing.assert_allclose(
        np.asarray(q), np.asarray(qtet.order_param_q_traj(pos, boxes, 0.0, 10.0)),
        atol=1e-5,
    )
