"""Tests for topology selectors, trajectory round-trip, synthetic boxes,
and the block-average statistics engine."""

import numpy as np

from waterorderlib_tpu.io.synthetic import make_water_box, WATER_NUMBER_DENSITY
from waterorderlib_tpu.io.topology import Topology
from waterorderlib_tpu.io.trajectory import Trajectory, load_system
from waterorderlib_tpu.stats import blocks


def test_water_topology_selectors():
    top, traj = make_water_box(27, n_frames=2, solute_elements=["C", "C", "O"], seed=1)
    o, h, len_wat = top.get_wat_inds()
    assert len(o) == 27 and len(h) == 54 and len_wat == 3
    np.testing.assert_array_equal(o, np.arange(27) * 3)
    heavy = top.get_heavy_inds()
    assert len(heavy) == 27 + 3  # water O + 3 solute heavy atoms
    sol, sol_h, sol_c, sol_n, sol_o, sol_s = top.get_sol_inds()
    assert len(sol) == 3 and len(sol_c) == 2 and len(sol_o) == 1 and len(sol_h) == 0
    phobic = top.get_phobic_inds()
    assert len(phobic) == 2
    philic = top.get_philic_inds()
    assert len(philic) == 27 + 1


def test_hb_inds_water():
    top, _ = make_water_box(4, seed=2)
    o_inds, _, _ = top.get_wat_inds()
    hbO, hbN = top.get_hb_inds(np.array([], int), o_inds)
    acc, don, donh = hbO
    assert len(acc) == 4
    assert len(don) == 8 and len(donh) == 8  # each O twice (two hydrogens)
    np.testing.assert_array_equal(don[:2], [0, 0])
    assert len(hbN[0]) == 0


def test_trajectory_roundtrip(tmp_path):
    top, traj = make_water_box(8, n_frames=5, seed=3)
    p = str(tmp_path / "traj.npz")
    traj.save(p, topology=top)
    top2, traj2 = load_system(p, p, stride=2)
    assert traj2.n_frames == 3
    np.testing.assert_allclose(traj2.positions, traj.positions[::2], atol=1e-6)
    o, h, lw = top2.get_wat_inds()
    assert len(o) == 8 and lw == 3


def test_topology_json_roundtrip(tmp_path):
    top, _ = make_water_box(3, solute_elements=["C"], seed=4)
    p = str(tmp_path / "top.json")
    top.to_json(p)
    top2 = Topology.from_json(p)
    np.testing.assert_array_equal(top2.res_ids, top.res_ids)
    assert list(top2.elements) == list(top.elements)
    np.testing.assert_array_equal(top2.bonds, top.bonds)


def test_synthetic_density():
    n = 125
    top, traj = make_water_box(n, n_frames=1, seed=5)
    box = traj.boxes[0]
    vol = float(np.prod(box.astype(np.float64)))
    assert np.isclose(n / vol, WATER_NUMBER_DENSITY, rtol=1e-5)
    # O-H distances correct
    pos = traj.positions[0]
    o = pos[0::3]
    h1 = pos[1::3]
    d = np.linalg.norm(h1 - o, axis=1)
    np.testing.assert_allclose(d, 0.9572, atol=1e-3)


def test_synthetic_diffusion_msd():
    """Lattice hops give a mean squared displacement of 6 D t, keep frame 0
    and the oxygen sites of the static box, and leave the molecules whole."""
    n, f, D = 512, 40, 0.23
    _, moving = make_water_box(n, n_frames=f, seed=6, diffusion=D)
    _, static = make_water_box(n, n_frames=1, seed=6)
    np.testing.assert_array_equal(moving.positions[0], static.positions[0])
    o = moving.positions[:, 0::3].astype(np.float64)
    L = float(moving.boxes[0, 0])
    step = np.diff(o, axis=0)
    step -= L * np.round(step / L)
    msd = (np.cumsum(step, axis=0)[-1] ** 2).sum(-1).mean()
    assert abs(msd - 6 * D * (f - 1)) < 0.2 * 6 * D * (f - 1)
    h1 = moving.positions[-1, 1::3]
    np.testing.assert_allclose(np.linalg.norm(h1 - o[-1], axis=1), 0.9572, atol=1e-3)


def test_block_average_shrinks_with_n():
    rs = np.random.RandomState(0)
    small = blocks.block_average(rs.normal(size=200), seed=1)
    large = blocks.block_average(rs.normal(size=20000), seed=1)
    assert large < small
    m, ci = blocks.mean_and_ci(np.ones(100), seed=1)
    assert m == 1.0 and ci == 0.0


def test_chunk_se():
    x = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    se = blocks.chunk_se(x)
    np.testing.assert_allclose(se, np.std(x, axis=0, ddof=1) / np.sqrt(2))
