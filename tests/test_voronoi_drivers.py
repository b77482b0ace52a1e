"""End-to-end tests for Voronoi drivers (voronoiCalc, contactAreaCalc,
hydratedVolumeCalc)."""

import numpy as np

from waterorderlib_tpu.io.synthetic import make_water_box
from waterorderlib_tpu.drivers import voronoi_driver

N_WAT = 27
N_FRAMES = 4


def test_voronoi_calc(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=41)
    avg_v, var_v, avg_a, var_a, avg_e, var_e = voronoi_driver.voronoi_calc(
        top, traj, output_dir=str(tmp_path)
    )
    # mean water cell volume should be close to V_box / N
    vol_per_water = float(np.prod(traj.boxes[0].astype(float))) / N_WAT
    assert abs(avg_v[0][0] - vol_per_water) / vol_per_water < 0.25
    assert avg_e[0][0] >= 1.0  # asphericity >= 1 (sphere limit)
    for f in ("VolDistribution_0.txt", "AreaDistribution_0.txt", "EtaDistribution_0.txt"):
        assert (tmp_path / f).exists()


def test_voronoi_calc_with_pops(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=42)
    wat_inds, _, _ = top.get_wat_inds()
    sub = [[wat_inds[:5]] for _ in range(N_FRAMES)]
    avg_v, *_ = voronoi_driver.voronoi_calc(
        top, traj, sub_inds=sub, n_pops=1, output_dir=str(tmp_path)
    )
    assert np.isfinite(avg_v[0][1])
    assert (tmp_path / "VolDistribution_1.txt").exists()


def test_contact_area_calc():
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=43, solute_elements=["C", "O", "C"])
    tot, tot_ci, frac, frac_ci = voronoi_driver.contact_area_calc(top, traj)
    assert tot[0] > 0  # total solute surface
    assert all(f >= 0 for f in frac)
    # phobic + philic fractions should account for a meaningful share
    assert frac[0] + frac[1] > 0


def test_hydrated_volume_calc():
    top, traj = make_water_box(N_WAT, n_frames=2, seed=44, solute_elements=["C", "C"])
    (vol, vol_ci), (area, area_ci) = voronoi_driver.hydrated_volume_calc(top, traj)
    assert vol > 0 and area > 0


def test_voronoi_calc_device_batched_is_default_and_chunk_invariant(tmp_path):
    """The device engine batches frames by default (no-mesh trajectory
    calls must not take the slow per-frame ladder) and
    chunking must not change the statistics: chunk_frames=1 vs one big
    chunk produce identical results, both matching the host engine."""
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=45)
    kw = dict(output_dir=str(tmp_path), engine="device")
    res_big = voronoi_driver.voronoi_calc(top, traj, chunk_frames=N_FRAMES, **kw)
    res_one = voronoi_driver.voronoi_calc(top, traj, chunk_frames=1, **kw)
    res_def = voronoi_driver.voronoi_calc(top, traj, **kw)  # default batched
    for a, b, c in zip(res_big, res_one, res_def):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[0], c[0])
    res_host = voronoi_driver.voronoi_calc(
        top, traj, output_dir=str(tmp_path), engine="host"
    )
    # f32 device vs f64 host: statistics agree to f32 tolerance
    np.testing.assert_allclose(res_def[0][0], res_host[0][0], rtol=5e-3)
    np.testing.assert_allclose(res_def[2][0], res_host[2][0], rtol=5e-3)


def test_pick_engine_auto_requires_tpu(monkeypatch):
    # "auto" only routes to the device tessellation when the backend is a
    # GPU — on CPU the clip builder loses to Qhull at every size — and only
    # for enough points x frames to repay the device program's compile
    from waterorderlib_tpu.ops import backend

    pick = voronoi_driver._pick_engine
    monkeypatch.setattr(backend, "is_gpu", lambda: False)
    assert pick("auto", 100_000, 1000, "volumes") == "host"
    monkeypatch.setattr(backend, "is_gpu", lambda: True)
    assert pick("auto", 4101, 1000, "volumes") == "device"
    assert pick("auto", 4101, 32, "volumes") == "host"  # a short run: Qhull
    assert pick("auto", 4101, 32, "contacts") == "device"
    assert pick("auto", 4101, 8, "contacts") == "host"
    # explicit engines are never overridden
    monkeypatch.setattr(backend, "is_gpu", lambda: False)
    assert pick("device", 100, 1, "volumes") == "device"
    assert pick("host", 100_000, 1000, "contacts") == "host"
