"""Standalone sharded-parity checks, run in a CPU-pinned subprocess.

`tests/test_parallel.py` runs this script in a subprocess whose env forces
an 8-virtual-device CPU platform, so every `pytest tests/` invocation
exercises all mesh shapes (4x2, 8x1, 2x4) plus non-divisible F/N padding.
"""

import numpy as np
import jax
import jax.numpy as jnp

from waterorderlib_tpu.parallel import mesh as pmesh
from waterorderlib_tpu.order import qtet
from waterorderlib_tpu.ops import pairs


def _data(n_frames=4, n_wat=128, seed=0):
    rs = np.random.RandomState(seed)
    box_len = (n_wat / 0.033456) ** (1.0 / 3.0)
    pos = rs.uniform(0, box_len, (n_frames, n_wat, 3)).astype(np.float32)
    boxes = np.tile(np.array([box_len] * 3, np.float32), (n_frames, 1))
    return jnp.asarray(pos), jnp.asarray(boxes)


def _q_reference(pos, boxes):
    return np.stack(
        [
            np.asarray(qtet.order_param_q(pos[f], pos[f], boxes[f], 0.0, 10.0, row_block=64))
            for f in range(pos.shape[0])
        ]
    )


def check_mesh_shape(df, da, n_frames, n_wat):
    pos, boxes = _data(n_frames=n_frames, n_wat=n_wat)
    m = pmesh.make_mesh(df, da)
    q, mean_q, hist = pmesh.sharded_q_analysis(pos, boxes, m, row_block=64)
    q_ref = _q_reference(pos, boxes)
    np.testing.assert_allclose(np.asarray(q), q_ref, atol=2e-5)
    np.testing.assert_allclose(np.asarray(mean_q), q_ref.mean(axis=1), atol=2e-5)
    assert float(np.asarray(hist).sum()) <= q_ref.size  # out-of-range q dropped
    print(f"mesh {df}x{da} F={n_frames} N={n_wat}: ok")


def check_padded(df, da, n_frames, n_wat):
    """Non-divisible F and N through the NaN-padding wrapper."""
    pos, boxes = _data(n_frames=n_frames, n_wat=n_wat)
    m = pmesh.make_mesh(df, da)
    q, mean_q, hist = pmesh.sharded_q_analysis_padded(pos, boxes, m, row_block=64)
    assert q.shape == (n_frames, n_wat)
    assert mean_q.shape == (n_frames,)
    q_ref = _q_reference(pos, boxes)
    np.testing.assert_allclose(np.asarray(q), q_ref, atol=2e-5)
    np.testing.assert_allclose(np.asarray(mean_q), q_ref.mean(axis=1), atol=2e-5)
    in_range = np.sum((q_ref >= 0.0) & (q_ref <= 1.0))
    assert abs(float(np.asarray(hist).sum()) - in_range) <= 2
    print(f"padded mesh {df}x{da} F={n_frames} N={n_wat}: ok")


def check_three_body_hist(df, da):
    from waterorderlib_tpu.order import angles as angles_mod

    pos, boxes = _data(n_frames=8, n_wat=96)
    m = pmesh.make_mesh(df, da)
    got = pmesh.sharded_three_body_hist(pos, boxes, m, row_block=96)
    want = np.zeros(500, np.float32)
    for f in range(8):
        aset = angles_mod.neighbor_angles(pos[f], pos[f], boxes[f], 0.0, 3.413, k=16)
        want += np.asarray(angles_mod.angle_histogram(aset))
    np.testing.assert_allclose(np.asarray(got), want, atol=2)
    print(f"three-body histogram mesh {df}x{da}: ok")


def check_distance_histogram(df, da):
    pos, boxes = _data(n_frames=8)
    m = pmesh.make_mesh(df, da)
    counts = pmesh.sharded_distance_histogram(pos, pos, boxes, m, 0.2, 40, same=True)
    want = np.zeros(40, np.float32)
    for f in range(8):
        want += np.asarray(
            pairs.distance_histogram(pos[f], pos[f], boxes[f], 0.2, 40, same=True)
        )
    np.testing.assert_allclose(np.asarray(counts), want, atol=2)
    print(f"distance histogram mesh {df}x{da}: ok")


def check_lsi_psi6_analysis(df, da):
    """sharded LSI / psi6 population analyses match the unsharded driver
    cores (moments-psum formulation vs two-pass masked_mean_var)."""
    from waterorderlib_tpu.drivers import orderparams as op

    n_frames, n_wat = 5, 100  # non-divisible F and N
    pos, boxes = _data(n_frames=n_frames, n_wat=n_wat, seed=7)
    rs = np.random.RandomState(3)
    pops = rs.rand(n_frames, 1, n_wat) < 0.4
    masks = jnp.asarray(
        np.concatenate([np.ones((n_frames, 1, n_wat), bool), pops], axis=1)
    )
    m = pmesh.make_mesh(df, da)

    h_ref, (mean_ref, var_ref) = op._lsi_core(
        pos, boxes, masks, 0.0, 3.7, 16, 64, 500, 0.0, 0.3
    )
    h_got, (mean_got, var_got) = pmesh.sharded_lsi_analysis(
        pos, boxes, masks, m, 0.0, 3.7, k=16, row_block=64
    )
    np.testing.assert_allclose(np.asarray(h_got), np.asarray(h_ref), atol=1e-3)
    np.testing.assert_allclose(np.asarray(mean_got), np.asarray(mean_ref), atol=1e-5)
    np.testing.assert_allclose(np.asarray(var_got), np.asarray(var_ref), atol=1e-5)

    # psi6: reference = the driver's unsharded step over each frame
    from waterorderlib_tpu.order import psi6 as psi6_mod
    from waterorderlib_tpu.ops import histograms as hist_mod

    h_got, (mean_got, var_got) = pmesh.sharded_psi6_analysis(
        pos, boxes, masks, m, 0.0, 7.0, k=24, row_block=64
    )
    h_ref = np.zeros((2, 500), np.float32)
    for f in range(n_frames):
        psi = psi6_mod.order_param_psi(pos[f], pos[f], boxes[f], 0.0, 7.0, k=24, row_block=64)
        for p in range(2):
            mk = masks[f, p]
            h_ref[p] += np.asarray(hist_mod.masked_histogram(psi, mk, 500, 0.0, 1.0))
            mean, var = hist_mod.masked_mean_var(psi[None, :], mk[None, :])
            np.testing.assert_allclose(float(mean_got[f, p]), float(mean[0]), atol=1e-5)
            np.testing.assert_allclose(float(var_got[f, p]), float(var[0]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(h_got), h_ref, atol=1e-3)
    print(f"lsi/psi6 analysis mesh {df}x{da}: ok")


def check_three_body_analysis(df, da):
    """sharded full 3-body analysis matches the unsharded core: global +
    2-D histograms, per-frame per-pop frac/avg/var/entropy/n_wats."""
    from waterorderlib_tpu.drivers import orderparams as op

    n_frames, n_wat = 5, 100
    pos, boxes = _data(n_frames=n_frames, n_wat=n_wat, seed=9)
    rs = np.random.RandomState(5)
    pops = rs.rand(n_frames, 1, n_wat) < 0.5
    masks = jnp.asarray(
        np.concatenate([np.ones((n_frames, 1, n_wat), bool), pops], axis=1)
    )
    m = pmesh.make_mesh(df, da)

    (h_ref, h2_ref), stats_ref = op._three_body_core(
        pos, boxes, masks, 0.0, 3.413, 16, 64, 500, 0.0, 180.0, 14
    )
    (h_got, h2_got), stats_got = pmesh.sharded_three_body_analysis(
        pos, boxes, masks, m, 0.0, 3.413, k=16, row_block=64
    )
    np.testing.assert_allclose(np.asarray(h_got), np.asarray(h_ref), atol=1e-3)
    np.testing.assert_allclose(np.asarray(h2_got), np.asarray(h2_ref), atol=1e-3)
    names = ["frac", "avg", "var", "ent", "n_wats"]
    for name, got, ref in zip(names, stats_got, stats_ref):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref), atol=2e-5, err_msg=name
        )
    print(f"three-body analysis mesh {df}x{da}: ok")


def check_rdf_mesh(df, da, tmp="/tmp/_sharded_rdf_check"):
    """rdf_calc(mesh=...) per-frame sharded histograms match single-device."""
    import os
    import shutil
    from waterorderlib_tpu.io.synthetic import make_water_box
    from waterorderlib_tpu.drivers.rdf import rdf_calc

    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp + "/a")
    os.makedirs(tmp + "/b")
    top, traj = make_water_box(60, n_frames=5, seed=63, solute_elements=["C", "O"])
    m = pmesh.make_mesh(df, da)
    ra = rdf_calc(top, traj, output_dir=tmp + "/a")
    rb = rdf_calc(top, traj, output_dir=tmp + "/b", mesh=m)
    for a, b in zip(ra, rb):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)
    ha = np.loadtxt(tmp + "/a/rdf.txt")
    hb = np.loadtxt(tmp + "/b/rdf.txt")
    np.testing.assert_allclose(ha, hb, rtol=1e-5, atol=1e-8)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"rdf mesh option {df}x{da}: ok")


def check_hb_mesh(df, da, tmp="/tmp/_sharded_hb_check"):
    """hb_calc(mesh=...) frame-DP sharding matches single-device."""
    import os
    import shutil
    from waterorderlib_tpu.io.synthetic import make_water_box
    from waterorderlib_tpu.drivers.hbonds_driver import hb_calc

    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp + "/a")
    os.makedirs(tmp + "/b")
    top, traj = make_water_box(20, n_frames=5, seed=64, solute_elements=["O", "C"])
    m = pmesh.make_mesh(df, da)
    wa, sa = hb_calc(top, traj, output_dir=tmp + "/a")
    wb, sb = hb_calc(top, traj, output_dir=tmp + "/b", mesh=m)
    np.testing.assert_allclose(wa, wb, rtol=1e-6)
    np.testing.assert_allclose(sa, sb, rtol=1e-6)
    ha = np.loadtxt(tmp + "/a/hbDistribution_water.txt")
    hb = np.loadtxt(tmp + "/b/hbDistribution_water.txt")
    np.testing.assert_allclose(ha, hb, atol=1e-4)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"hb mesh option {df}x{da}: ok")


def check_chempot_mesh(df, da, tmp="/tmp/_sharded_chempot_check"):
    """chem_pot_calc(mesh=...) frame-DP sharding bit-matches single-device:
    the overlap histogram is a psum of frame-local histograms whose PRNG
    keys are indexed by global frame."""
    import os
    import shutil
    from waterorderlib_tpu.io.synthetic import make_water_box
    from waterorderlib_tpu.drivers.chempot import chem_pot_calc

    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp + "/a")
    os.makedirs(tmp + "/b")
    top, traj = make_water_box(24, n_frames=5, seed=65, solute_elements=["C"])
    m = pmesh.make_mesh(df, da)
    for kw in (False, True):
        mu_a, n_a, n2_a = chem_pot_calc(
            top, traj, keyword=kw, n_insertions=1000, output_dir=tmp + "/a"
        )
        mu_b, n_b, n2_b = chem_pot_calc(
            top, traj, keyword=kw, n_insertions=1000, output_dir=tmp + "/b", mesh=m
        )
        assert n_a == n_b and n2_a == n2_b, (kw, n_a, n_b)
        assert (mu_a == mu_b) or (np.isinf(mu_a) and np.isinf(mu_b))
        fn = "HS-solute_overlap_hist_Shell.txt" if kw else "HS-solute_overlap_hist.txt"
        ha = np.loadtxt(tmp + "/a/" + fn)
        hb = np.loadtxt(tmp + "/b/" + fn)
        np.testing.assert_array_equal(ha, hb)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"chempot mesh option {df}x{da}: ok")


def check_driver_mesh_option(df, da, tmp="/tmp/_sharded_driver_check"):
    """tet_order_calc(mesh=...) shards the q computation across the device
    mesh and matches the single-device driver exactly."""
    import os
    import shutil
    from waterorderlib_tpu.io.synthetic import make_water_box
    from waterorderlib_tpu.drivers.orderparams import tet_order_calc

    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp + "/a")
    os.makedirs(tmp + "/b")
    top, traj = make_water_box(100, n_frames=6, seed=61)  # non-divisible F/N
    m = pmesh.make_mesh(df, da)
    a_avg, a_var = tet_order_calc(top, traj, output_dir=tmp + "/a", row_block=32)
    b_avg, b_var = tet_order_calc(top, traj, output_dir=tmp + "/b", row_block=32, mesh=m)
    np.testing.assert_allclose(a_avg[0], b_avg[0], atol=2e-6)
    ha = np.loadtxt(tmp + "/a/qDistribution_0.txt")
    hb = np.loadtxt(tmp + "/b/qDistribution_0.txt")
    assert np.abs(ha[:, 1] - hb[:, 1]).sum() <= 2
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"driver mesh option {df}x{da}: ok")


def check_msd_mesh(df, da, tmp="/tmp/_sharded_msd_check"):
    """msd_calc(mesh=...) atom-TP sharding matches the single-device scan
    (reduction order differs only in the final mean: allclose to f32)."""
    import os
    import shutil
    from waterorderlib_tpu.io.synthetic import make_water_box
    from waterorderlib_tpu.drivers.msd import msd_calc

    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp + "/a")
    os.makedirs(tmp + "/b")
    top, traj = make_water_box(50, n_frames=6, seed=67)  # N % 8 != 0
    m = pmesh.make_mesh(df, da)
    msd_a, d_a = msd_calc(top, traj, output_dir=tmp + "/a")
    msd_b, d_b = msd_calc(top, traj, output_dir=tmp + "/b", mesh=m)
    np.testing.assert_allclose(msd_a, msd_b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-4, atol=1e-8)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"msd mesh option {df}x{da}: ok")


def check_voronoi_mesh(df, da, tmp="/tmp/_sharded_voronoi_check"):
    """voronoi_calc(engine='device', mesh=...) frame-DP tier-1 matches the
    per-frame device engine (certification identical; volumes/areas agree
    to f32 blocking noise on the certified cells)."""
    import os
    import shutil
    from waterorderlib_tpu.io.synthetic import make_water_box
    from waterorderlib_tpu.drivers.voronoi_driver import voronoi_calc

    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp + "/a")
    os.makedirs(tmp + "/b")
    # F=5 also exercises the repeat-last-frame padding (5 % 8 != 0)
    top, traj = make_water_box(60, n_frames=5, seed=66, solute_elements=["C"])
    m = pmesh.make_mesh(df, da)
    ra = voronoi_calc(top, traj, output_dir=tmp + "/a", engine="device")
    rb = voronoi_calc(top, traj, output_dir=tmp + "/b", engine="device", mesh=m)
    for (mean_a, ci_a), (mean_b, ci_b) in zip(ra, rb):
        np.testing.assert_allclose(mean_a, mean_b, rtol=1e-4)
        np.testing.assert_allclose(ci_a, ci_b, rtol=1e-2, atol=1e-7)
    ha = np.loadtxt(tmp + "/a/VolDistribution_0.txt")
    hb = np.loadtxt(tmp + "/b/VolDistribution_0.txt")
    assert np.abs(ha[:, 1] - hb[:, 1]).sum() <= 2
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"voronoi mesh option {df}x{da}: ok")


def check_contacts_mesh(df, da):
    """contact_area_calc / hydrated_volume_calc with mesh= (frames-DP
    batched tier-1 contacts) match the per-frame device path, and
    chunk_frames= chunking matches the one-shot batch."""
    import numpy as np

    from waterorderlib_tpu.io.synthetic import make_water_box
    from waterorderlib_tpu.drivers.voronoi_driver import (
        contact_area_calc,
        hydrated_volume_calc,
    )

    # F=5 exercises the repeat-last-frame padding (5 % 8 != 0)
    top, traj = make_water_box(60, n_frames=5, seed=67, solute_elements=["C", "O"])
    m = pmesh.make_mesh(df, da)
    ra = contact_area_calc(top, traj, engine="device")
    rb = contact_area_calc(top, traj, engine="device", mesh=m)
    rc = contact_area_calc(top, traj, engine="device", chunk_frames=2)
    for a, b, c in zip(ra, rb, rc):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-9)
    ha = hydrated_volume_calc(top, traj, engine="device")
    hb = hydrated_volume_calc(top, traj, engine="device", mesh=m, chunk_frames=3)
    for (ma, ca), (mb, cb) in zip(ha, hb):
        np.testing.assert_allclose(ma, mb, rtol=1e-6)
        np.testing.assert_allclose(ca, cb, rtol=1e-4, atol=1e-8)
    print(f"contacts mesh option {df}x{da}: ok")


def main():
    assert len(jax.devices()) >= 8, f"need 8 devices, have {len(jax.devices())}"
    check_mesh_shape(4, 2, n_frames=4, n_wat=128)
    check_mesh_shape(8, 1, n_frames=8, n_wat=128)
    check_mesh_shape(2, 4, n_frames=4, n_wat=128)
    check_padded(4, 2, n_frames=5, n_wat=100)  # F % 4 != 0, N % 2 != 0
    check_padded(2, 4, n_frames=3, n_wat=97)
    check_distance_histogram(4, 2)
    check_distance_histogram(8, 1)
    check_three_body_hist(4, 2)
    check_lsi_psi6_analysis(4, 2)
    check_three_body_analysis(4, 2)
    check_three_body_analysis(2, 4)
    check_rdf_mesh(4, 2)
    check_hb_mesh(4, 2)
    check_chempot_mesh(4, 2)
    check_msd_mesh(4, 2)
    check_voronoi_mesh(4, 2)
    check_contacts_mesh(4, 2)
    check_driver_mesh_option(4, 2)
    print("sharded checks: all ok")


if __name__ == "__main__":
    main()
