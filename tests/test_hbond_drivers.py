"""End-to-end tests for H-bond drivers and bound/wrap decomposition."""

import numpy as np

from waterorderlib_tpu.io.synthetic import make_water_box
from waterorderlib_tpu.drivers import hbonds_driver
from reference import refimpl

N_WAT = 32
N_FRAMES = 4


def _system_with_solute():
    # a 3-atom solute with an O so it can both accept and (via no H) not donate
    return make_water_box(N_WAT, n_frames=N_FRAMES, seed=13, solute_elements=["C", "O", "C"])


def test_hb_calc_water_only(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=9)
    avg_wat, avg_sol = hbonds_driver.hb_calc(top, traj, output_dir=str(tmp_path))
    assert avg_wat > 0.0  # dense water box must have H-bonds
    assert avg_sol == 0.0
    h = np.loadtxt(tmp_path / "hbDistribution_water.txt")
    assert h.shape == (10, 2)
    assert h[:, 1].sum() == N_WAT * N_FRAMES


def test_hb_calc_matches_reference_frame():
    top, traj = make_water_box(N_WAT, n_frames=1, seed=9)
    wat_inds, wat_h, _ = top.get_wat_inds()
    hbO, _ = top.get_hb_inds(np.array([], int), wat_inds)
    pos = traj.positions[0].astype(np.float64)
    box = traj.boxes[0].astype(np.float64)
    mat = refimpl.general_hbonds(pos[hbO[0]], pos[hbO[1]], pos[hbO[2]], box, 3.5, 120.0)
    want_tot = mat.sum(axis=1) + (mat.sum(axis=0)[::2] + mat.sum(axis=0)[1::2])
    avg_wat, _ = hbonds_driver.hb_calc(top, traj, output_dir="/tmp")
    assert abs(avg_wat - want_tot.mean()) < 1e-2


def test_get_bound_wrap(tmp_path):
    top, traj = _system_with_solute()
    res = hbonds_driver.get_bound_wrap(top, traj)
    assert len(res) == N_FRAMES
    wat_inds, _, _ = top.get_wat_inds()
    for bound, wrap, shell, non_shell in res:
        # partitions: bound+wrap = shell; shell+nonshell = all waters
        assert set(bound) | set(wrap) == set(shell)
        assert set(bound) & set(wrap) == set()
        assert len(shell) + len(non_shell) == N_WAT
        assert set(shell).issubset(set(wat_inds))
    # the solute is in the box center so some waters must be in the shell
    assert len(res[0][2]) > 0
    single = hbonds_driver.get_bound_wrap(top, traj, frame_index=0)
    np.testing.assert_array_equal(single[2], res[0][2])


def test_bound_wrap_matches_bruteforce():
    top, traj = _system_with_solute()
    pos = traj.positions[0].astype(np.float64)
    box = traj.boxes[0].astype(np.float64)
    wat_inds, _, _ = top.get_wat_inds()
    sol_inds, _, _, sol_n, sol_o, _ = top.get_sol_inds()
    # brute-force shell: water O within 4.0 of any solute heavy
    nb = refimpl.near_neighbors(pos[sol_inds], pos[wat_inds], box, 0.0, 4.0)
    want_shell = wat_inds[np.any(nb, axis=0)]
    _, _, shell, _ = hbonds_driver.get_bound_wrap(top, traj, frame_index=0)
    np.testing.assert_array_equal(np.sort(shell), np.sort(want_shell))


def test_hb_cluster_stats(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=15)
    wat_inds, _, _ = top.get_wat_inds()
    hbO, _ = top.get_hb_inds(np.array([], int), wat_inds)
    mean_ci = hbonds_driver.get_hb_cluster_stats(
        top, traj, hbO[0], hbO[1], hbO[2], output_dir=str(tmp_path)
    )
    assert mean_ci[0] >= 1.0
    dist = np.loadtxt(tmp_path / "clusterDistribution.txt")
    assert dist[:, 1].sum() > 0


def test_ion_cluster_stats(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=2, seed=16)
    # pretend the first 8 oxygens are ions with alternating charge
    wat_inds, _, _ = top.get_wat_inds()
    ions = wat_inds[:8]
    charges = np.array([1.0, -1.0] * 4)
    (size_mean, size_ci), (eff_mean, eff_ci) = hbonds_driver.get_ion_cluster_stats(
        top, traj, ions, charges, cutoff=5.0, output_dir=str(tmp_path)
    )
    assert size_mean >= 1.0
    assert np.isfinite(eff_mean)


def test_neighbor_stats(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=2, seed=17)
    wat_inds, _, _ = top.get_wat_inds()
    mol_ids = np.arange(N_WAT)
    mean_ci = hbonds_driver.get_neighbor_stats(
        top, traj, wat_inds, mol_ids, cutoff=3.5, output_dir=str(tmp_path)
    )
    assert mean_ci[0] > 0
    assert (tmp_path / "coordDistribution.txt").exists()


def test_hb_calc_with_solute_matches_reference_frame(tmp_path):
    """Water H-bonds including the water-solute terms, through the blocked
    counter, against the numpy reference on one frame."""
    top, traj = make_water_box(60, n_frames=1, seed=21, solute_elements=["C", "O", "N", "O"])
    _, hb_o, hb_n = hbonds_driver._sol_hb_triplets(top)
    assert sum(len(t[0]) for t in (hb_o, hb_n)) > 0  # the solute accepts
    tot = refimpl.hbonds_per_water(
        top, traj.positions[0].astype(np.float64), traj.boxes[0].astype(np.float64)
    )
    avg_wat, avg_sol = hbonds_driver.hb_calc(top, traj, output_dir=str(tmp_path))
    assert abs(avg_wat - tot.mean()) < 1e-6
    assert np.isfinite(avg_sol)
