"""Backend dispatch and tier logging for tet_order_calc.

One function (`ops.backend.is_gpu`) decides whether the windowed GPU kernel
serves q; the driver logs which path served each call. On the CPU the kernel
runs here through the Pallas interpreter (forced), and must agree with the
XLA path. A kernel error propagates: nothing hides a broken device path.
"""

import functools
import logging

import jax
import numpy as np
import pytest

from waterorderlib_tpu.drivers import orderparams as op
from waterorderlib_tpu.io.synthetic import make_water_box
from waterorderlib_tpu.ops import backend
from waterorderlib_tpu.ops.gpu import window_knn
from waterorderlib_tpu.order import qtet


@pytest.fixture()
def fresh_tier_log():
    saved = set(op._logged_tiers)
    op._logged_tiers.clear()
    yield
    op._logged_tiers.clear()
    op._logged_tiers.update(saved)


@pytest.fixture()
def kernel_interpreted(monkeypatch):
    """Dispatch as on a GPU, with the kernel run by the Pallas interpreter."""
    monkeypatch.setattr(backend, "is_gpu", lambda: True)
    monkeypatch.setattr(
        qtet, "order_param_q_certified",
        functools.partial(qtet.order_param_q_certified, interpret=True),
    )


def _system(n_wat=1200, n_frames=3):
    return make_water_box(n_wat, n_frames=n_frames, seed=7)


def test_dispatcher_picks_xla_on_cpu(fresh_tier_log, caplog, tmp_path):
    assert jax.default_backend() == "cpu" and not backend.is_gpu()
    top, traj = _system(300, 2)
    with caplog.at_level(logging.INFO, logger="waterorderlib_tpu"):
        op.tet_order_calc(top, traj, output_dir=str(tmp_path))
    assert ("tet_order_calc", "xla") in op._logged_tiers
    assert not any(t[0] == "tet_order_calc" and t[1].startswith("window")
                   for t in op._logged_tiers)


def test_happy_path_logs_pallas_tier(
    fresh_tier_log, kernel_interpreted, caplog, tmp_path, monkeypatch
):
    """tet_order_calc through the dispatcher with the kernel (interpreted)
    logs the window tier and matches the XLA path."""
    top, traj = _system()
    (tmp_path / "k").mkdir()
    with caplog.at_level(logging.INFO, logger="waterorderlib_tpu"):
        got = op.tet_order_calc(top, traj, output_dir=str(tmp_path / "k"))
    assert ("tet_order_calc", "window") in op._logged_tiers
    assert any("serving tier=window" in r.message for r in caplog.records)
    monkeypatch.setattr(backend, "is_gpu", lambda: False)
    want = op.tet_order_calc(top, traj, output_dir=str(tmp_path))
    np.testing.assert_allclose(got[0][0], want[0][0], atol=1e-6)
    np.testing.assert_allclose(got[1][0], want[1][0], atol=1e-6)
    h_k = np.loadtxt(tmp_path / "k" / "qDistribution_0.txt")
    h_x = np.loadtxt(tmp_path / "qDistribution_0.txt")
    np.testing.assert_array_equal(h_k, h_x)


def test_broken_kernel_logs_and_falls_back_correctly(
    fresh_tier_log, kernel_interpreted, monkeypatch, tmp_path
):
    """A kernel compile/run error is not caught: it reaches the caller
    instead of silently serving a slower path."""
    top, traj = _system()

    def boom(*a, **k):
        raise jax.errors.JaxRuntimeError("simulated Triton compile failure")

    monkeypatch.setattr(window_knn, "window_knn", boom)
    qtet.order_param_q_windowed.clear_cache()
    window_knn.knn_traj.clear_cache()
    with pytest.raises(jax.errors.JaxRuntimeError):
        op.tet_order_calc(top, traj, output_dir=str(tmp_path))


def test_unexpected_exception_propagates(
    fresh_tier_log, kernel_interpreted, monkeypatch, tmp_path
):
    """A non-kernel error (a bug) must NOT be swallowed by the dispatch."""
    top, traj = _system()

    def bug(*a, **k):
        raise TypeError("not a kernel failure")

    monkeypatch.setattr(qtet, "order_param_q_certified", bug)
    with pytest.raises(TypeError):
        op.tet_order_calc(top, traj, output_dir=str(tmp_path))


@pytest.mark.gpu
def test_tet_order_calc_gpu_serves_window_tier(fresh_tier_log, tmp_path):
    top, traj = _system(4096, 4)
    got = op.tet_order_calc(top, traj, output_dir=str(tmp_path))
    assert ("tet_order_calc", "window") in op._logged_tiers
    assert np.isfinite(got[0][0]).all()
