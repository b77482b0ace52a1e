"""Golden tests for the H-bond kernel and graph clustering."""

import jax.numpy as jnp
import numpy as np
import pytest

from waterorderlib_tpu.hbonds import bonds, clusters
from waterorderlib_tpu.io.synthetic import make_water_box
from reference import refimpl


def _j(x):
    return jnp.asarray(x, jnp.float32)


def test_hbond_known_geometry():
    box = np.array([50.0, 50.0, 50.0])
    # donor O at origin with H pointing at the acceptor 2.8 A away on +x:
    # D-H...A angle = 180 -> bonded
    acc = np.array([[2.8, 0.0, 0.0]])
    don = np.array([[0.0, 0.0, 0.0]])
    donh = np.array([[0.9572, 0.0, 0.0]])
    m = np.asarray(bonds.general_hbonds(_j(acc), _j(don), _j(donh), _j(box), 3.5, 150.0))
    assert m[0, 0]
    # H pointing away -> angle 0 -> not bonded
    donh2 = np.array([[-0.9572, 0.0, 0.0]])
    m2 = np.asarray(bonds.general_hbonds(_j(acc), _j(don), _j(donh2), _j(box), 3.5, 150.0))
    assert not m2[0, 0]
    # too far -> not bonded even if linear
    acc3 = np.array([[4.0, 0.0, 0.0]])
    m3 = np.asarray(bonds.general_hbonds(_j(acc3), _j(don), _j(donh), _j(box), 3.5, 150.0))
    assert not m3[0, 0]


def test_hbonds_match_reference_water_box():
    top, traj = make_water_box(64, n_frames=1, seed=11)
    pos = traj.positions[0].astype(np.float64)
    box = traj.boxes[0].astype(np.float64)
    o_inds, h_inds, _ = top.get_wat_inds()
    hbO, _ = top.get_hb_inds(np.array([], int), o_inds)
    acc, don, donh = (pos[hbO[0]], pos[hbO[1]], pos[hbO[2]])
    want = refimpl.general_hbonds(acc, don, donh, box, 3.5, 120.0)
    got = np.asarray(
        bonds.general_hbonds(_j(acc), _j(don), _j(donh), _j(box), 3.5, 120.0)
    )
    assert np.mean(got != want) < 1e-3
    assert want.sum() > 0  # fixture actually contains H-bonds


def test_hbond_excludes_self_pairs():
    box = np.array([20.0, 20.0, 20.0])
    o = np.array([[5.0, 5.0, 5.0]])
    h = np.array([[5.9572, 5.0, 5.0]])
    m = np.asarray(bonds.general_hbonds(_j(o), _j(o), _j(h), _j(box), 3.5, 120.0))
    assert not m[0, 0]


def test_connected_components_chain_and_isolated():
    n = 6
    adj = np.zeros((n, n), bool)
    # chain 0-1-2, pair 3-4, isolated 5
    adj[0, 1] = adj[1, 0] = adj[1, 2] = adj[2, 1] = True
    adj[3, 4] = adj[4, 3] = True
    labels = np.asarray(clusters.connected_components(jnp.asarray(adj)))
    np.testing.assert_array_equal(labels, [0, 0, 0, 3, 3, 5])
    sizes = np.asarray(clusters.cluster_sizes(jnp.asarray(adj)))
    np.testing.assert_array_equal(sizes, [3, 0, 0, 2, 0, 1])
    dist = np.asarray(clusters.cluster_size_distribution(jnp.asarray(adj)))
    assert dist[1] == 1 and dist[2] == 1 and dist[3] == 1
    assert float(clusters.mean_cluster_size(jnp.asarray(adj))) == 2.0


def test_connected_components_ring():
    n = 8
    adj = np.zeros((n, n), bool)
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = True
    labels = np.asarray(clusters.connected_components(jnp.asarray(adj)))
    assert np.all(labels == 0)


def test_per_molecule_counts():
    mat = jnp.asarray(np.array([[True, False], [True, True]]))
    acc_mol = jnp.asarray(np.array([0, 1]))
    don_mol = jnp.asarray(np.array([0, 1]))
    counts = np.asarray(bonds.per_molecule_counts(mat, acc_mol, don_mol, 2))
    # mol0: acceptor row0 (1) + donor col0 (2) = 3; mol1: row1 (2) + col1 (1) = 3
    np.testing.assert_array_equal(counts, [3.0, 3.0])


@pytest.mark.parametrize("block", [7, 64, 1000])
def test_hbond_counts_blocked_matches_matrix_sums(block):
    """Blocked counting = row/column sums of the dense H-bond matrix, for
    blocks that do not divide the acceptor count and one larger than it."""
    top, traj = make_water_box(150, n_frames=1, seed=5)
    wat = top.get_wat_inds()[0]
    acc, don, donh = top.get_hb_inds(np.array([], int), wat)[0]
    p = jnp.asarray(traj.positions[0], jnp.float32)
    box = jnp.asarray(traj.boxes[0], jnp.float32)
    mat = np.asarray(bonds.general_hbonds(p[acc], p[don], p[donh], box, 3.5, 120.0))
    a_cnt, d_cnt = bonds.hbond_counts(p[acc], p[don], p[donh], box, 3.5, 120.0, block=block)
    assert mat.sum() > 0
    np.testing.assert_array_equal(np.asarray(a_cnt), mat.sum(axis=1))
    np.testing.assert_array_equal(np.asarray(d_cnt), mat.sum(axis=0))


@pytest.mark.parametrize("n_acc,n_don", [(3, 0), (0, 4), (2, 300)])
def test_hbond_counts_small_and_empty_sets(n_acc, n_don):
    """Solute-sized and empty acceptor/donor sets (the hb_calc cross terms)."""
    rs = np.random.RandomState(n_acc + n_don)
    box = jnp.asarray([12.0, 12.0, 12.0], jnp.float32)
    a = jnp.asarray(rs.uniform(0, 12, (n_acc, 3)), jnp.float32)
    d = jnp.asarray(rs.uniform(0, 12, (n_don, 3)), jnp.float32)
    dh = d + jnp.asarray(rs.normal(scale=0.5, size=(n_don, 3)), jnp.float32)
    a_cnt, d_cnt = bonds.hbond_counts(a, d, dh, box, 3.5, 120.0)
    assert a_cnt.shape == (n_acc,) and d_cnt.shape == (n_don,)
    if n_acc and n_don:
        mat = np.asarray(bonds.general_hbonds(a, d, dh, box, 3.5, 120.0))
        np.testing.assert_array_equal(np.asarray(a_cnt), mat.sum(axis=1))
        np.testing.assert_array_equal(np.asarray(d_cnt), mat.sum(axis=0))
