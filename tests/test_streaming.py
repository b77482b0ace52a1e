"""Streaming trajectory pipeline: lazy readers + chunked drivers match the
single-shot path (histogram counts exactly; float statistics to 1-2 ulp —
XLA may tile reductions differently per compile shape on an accelerator,
so bitwise equality across different batch sizes is not guaranteed there)."""

import numpy as np


def _ulp_close(a, b):
    np.testing.assert_allclose(a, b, rtol=3e-7, atol=1e-8)

from waterorderlib_tpu.io.synthetic import make_water_box
from waterorderlib_tpu.io import netcdf, dcd
from waterorderlib_tpu.io.streaming import LazyNetCDF, LazyDCD, iter_chunks
from waterorderlib_tpu.drivers import orderparams

N_WAT = 48
N_FRAMES = 10


def test_lazy_netcdf_matches_full_read(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=51)
    p = str(tmp_path / "t.nc")
    netcdf.write_amber_netcdf(p, traj)
    rdr = LazyNetCDF(p)
    assert rdr.n_frames == N_FRAMES and rdr.n_atoms == traj.n_atoms
    pos, boxes = rdr.read(3, 4)
    np.testing.assert_array_equal(pos, traj.positions[3:7])
    np.testing.assert_array_equal(boxes, traj.boxes[3:7])
    rdr.close()


def test_lazy_dcd_matches_full_read(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=52)
    p = str(tmp_path / "t.dcd")
    dcd.write_dcd(p, traj)
    rdr = LazyDCD(p)
    assert rdr.n_frames == N_FRAMES and rdr.n_atoms == traj.n_atoms
    pos, boxes = rdr.read(7, 5)  # clipped to the final 3 frames
    assert pos.shape[0] == 3
    np.testing.assert_array_equal(pos, traj.positions[7:])
    np.testing.assert_array_equal(boxes, traj.boxes[7:])
    rdr.close()


def test_iter_chunks_covers_trajectory_with_stride(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=53)
    p = str(tmp_path / "t.nc")
    netcdf.write_amber_netcdf(p, traj)
    got_pos = [c[0] for c in iter_chunks(p, chunk_frames=3, stride=2)]
    got = np.concatenate(got_pos, axis=0)
    np.testing.assert_array_equal(got, traj.positions[::2])


def test_tet_order_calc_chunked_bitmatches_single_shot(tmp_path):
    """>= 4 chunks through the NetCDF lazy reader == one-shot (VERDICT #6)."""
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=54)
    p = str(tmp_path / "t.nc")
    netcdf.write_amber_netcdf(p, traj)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a_avg, a_var = orderparams.tet_order_calc(
        top, traj, output_dir=str(tmp_path / "a"), row_block=16
    )
    b_avg, b_var = orderparams.tet_order_calc(
        top, p, output_dir=str(tmp_path / "b"), row_block=16, chunk_frames=3
    )
    _ulp_close(a_avg[0], b_avg[0])
    _ulp_close(a_var[0], b_var[0])
    ha = np.loadtxt(tmp_path / "a" / "qDistribution_0.txt")
    hb = np.loadtxt(tmp_path / "b" / "qDistribution_0.txt")
    np.testing.assert_array_equal(ha, hb)


def test_tet_order_calc_chunked_with_populations(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=55)
    wat_inds, _, _ = top.get_wat_inds()
    sub = [[wat_inds[:10]] for _ in range(N_FRAMES)]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a_avg, _ = orderparams.tet_order_calc(
        top, traj, sub_inds=sub, n_pops=1, output_dir=str(tmp_path / "a"), row_block=16
    )
    b_avg, _ = orderparams.tet_order_calc(
        top, traj, sub_inds=sub, n_pops=1, output_dir=str(tmp_path / "b"),
        row_block=16, chunk_frames=4,
    )
    _ulp_close(a_avg[0], b_avg[0])


def test_three_body_calc_chunked_bitmatches(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=56)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ra = orderparams.three_body_calc(top, traj, output_dir=str(tmp_path / "a"), row_block=16)
    rb = orderparams.three_body_calc(
        top, traj, output_dir=str(tmp_path / "b"), row_block=16, chunk_frames=3
    )
    for a, b in zip(ra, rb):
        _ulp_close(a[0], b[0])
    ha = np.loadtxt(tmp_path / "a" / "3bDistribution_0.txt")
    hb = np.loadtxt(tmp_path / "b" / "3bDistribution_0.txt")
    np.testing.assert_array_equal(ha, hb)


def test_lsi_calc_chunked_bitmatches(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=57)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    aa, va = orderparams.lsi_calc(top, traj, output_dir=str(tmp_path / "a"), row_block=16)
    ab, vb = orderparams.lsi_calc(
        top, traj, output_dir=str(tmp_path / "b"), row_block=16, chunk_frames=4
    )
    _ulp_close(aa[0], ab[0])
    ha = np.loadtxt(tmp_path / "a" / "lsiDistribution_0.txt")
    hb = np.loadtxt(tmp_path / "b" / "lsiDistribution_0.txt")
    np.testing.assert_array_equal(ha, hb)


def test_chunked_checkpoint_resume(tmp_path):
    """An interrupted chunked scan resumes from the checkpoint and matches
    the uninterrupted result exactly (elastic recovery, SURVEY §5)."""
    import os
    from waterorderlib_tpu.io import netcdf as nc_mod

    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=58)
    p = str(tmp_path / "t.nc")
    nc_mod.write_amber_netcdf(p, traj)
    ck = str(tmp_path / "ck.npz")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want_avg, want_var = orderparams.tet_order_calc(
        top, p, output_dir=str(tmp_path / "a"), row_block=16, chunk_frames=3
    )

    # interrupt after 2 chunks by monkeypatching the core path
    calls = {"n": 0}
    orig = orderparams._tet_core

    def failing(*a, **k):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("injected failure")
        return orig(*a, **k)

    orderparams._tet_core = failing
    try:
        import pytest
        with pytest.raises(RuntimeError):
            orderparams.tet_order_calc(
                top, p, output_dir=str(tmp_path / "b"), row_block=16,
                chunk_frames=3, checkpoint=ck,
            )
    finally:
        orderparams._tet_core = orig
    assert os.path.exists(ck)  # partial state persisted

    got_avg, got_var = orderparams.tet_order_calc(
        top, p, output_dir=str(tmp_path / "b"), row_block=16,
        chunk_frames=3, checkpoint=ck,
    )
    _ulp_close(want_avg[0], got_avg[0])
    _ulp_close(want_var[0], got_var[0])
    assert not os.path.exists(ck)  # removed on success
    ha = np.loadtxt(tmp_path / "a" / "qDistribution_0.txt")
    hb = np.loadtxt(tmp_path / "b" / "qDistribution_0.txt")
    np.testing.assert_array_equal(ha, hb)


def test_rdf_calc_chunked_bitmatches(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=59, solute_elements=["C", "O"])
    p = str(tmp_path / "t.nc")
    netcdf.write_amber_netcdf(p, traj)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    from waterorderlib_tpu.drivers.rdf import rdf_calc

    ra = rdf_calc(top, traj, output_dir=str(tmp_path / "a"))
    rb = rdf_calc(top, p, output_dir=str(tmp_path / "b"), chunk_frames=3)
    for a, b in zip(ra, rb):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "a" / "rdf.txt"), np.loadtxt(tmp_path / "b" / "rdf.txt")
    )


def test_hb_calc_chunked_bitmatches(tmp_path):
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=60, solute_elements=["O", "C"])
    p = str(tmp_path / "t.nc")
    netcdf.write_amber_netcdf(p, traj)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    from waterorderlib_tpu.drivers.hbonds_driver import hb_calc

    wa, sa = hb_calc(top, traj, output_dir=str(tmp_path / "a"))
    wb, sb = hb_calc(top, p, output_dir=str(tmp_path / "b"), chunk_frames=3)
    _ulp_close(np.asarray(wa), np.asarray(wb))
    _ulp_close(np.asarray(sa), np.asarray(sb))
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "a" / "hbDistribution_water.txt"),
        np.loadtxt(tmp_path / "b" / "hbDistribution_water.txt"),
    )


def test_chem_pot_chunked_bitmatches(tmp_path):
    top, traj = make_water_box(40, n_frames=6, seed=62)
    p = str(tmp_path / "t.nc")
    netcdf.write_amber_netcdf(p, traj)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    from waterorderlib_tpu.drivers.chempot import chem_pot_calc

    ra = chem_pot_calc(top, traj, n_insertions=2048, probe_radius=2.0,
                       output_dir=str(tmp_path / "a"), seed=5)
    rb = chem_pot_calc(top, p, n_insertions=2048, probe_radius=2.0,
                       output_dir=str(tmp_path / "b"), seed=5, chunk_frames=2)
    assert ra == rb
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "a" / "HS-solute_overlap_hist.txt"),
        np.loadtxt(tmp_path / "b" / "HS-solute_overlap_hist.txt"),
    )


def test_checkpoint_rejects_stale_trajectory(tmp_path):
    """A checkpoint written against one trajectory must NOT be resumed when
    the run points at a different trajectory or different cutoffs — the
    fingerprint covers trajectory identity and analysis parameters."""
    import os

    from waterorderlib_tpu.io import netcdf as nc_mod

    top, traj_a = make_water_box(N_WAT, n_frames=N_FRAMES, seed=61)
    _, traj_b = make_water_box(N_WAT, n_frames=N_FRAMES, seed=62)
    pa = str(tmp_path / "a.nc")
    pb = str(tmp_path / "b.nc")
    nc_mod.write_amber_netcdf(pa, traj_a)
    nc_mod.write_amber_netcdf(pb, traj_b)
    ck = str(tmp_path / "ck.npz")

    # interrupt a run over trajectory A after the first chunk
    calls = {"n": 0}
    orig = orderparams._tet_core

    def failing(*a, **k):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("injected")
        return orig(*a, **k)

    orderparams._tet_core = failing
    try:
        try:
            orderparams.tet_order_calc(
                top, pa, output_dir=str(tmp_path), row_block=16,
                chunk_frames=3, checkpoint=ck,
            )
        except RuntimeError:
            pass
    finally:
        orderparams._tet_core = orig
    assert os.path.exists(ck)

    # clean run over trajectory B with the same checkpoint path: A's partial
    # state must be discarded, so the result equals a no-checkpoint run
    (tmp_path / "want").mkdir()
    (tmp_path / "got").mkdir()
    want_avg, _ = orderparams.tet_order_calc(
        top, pb, output_dir=str(tmp_path / "want"), row_block=16, chunk_frames=3
    )
    got_avg, _ = orderparams.tet_order_calc(
        top, pb, output_dir=str(tmp_path / "got"), row_block=16,
        chunk_frames=3, checkpoint=ck,
    )
    np.testing.assert_array_equal(np.asarray(want_avg[0]), np.asarray(got_avg[0]))
