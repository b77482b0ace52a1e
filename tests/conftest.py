"""Test configuration: CPU with 8 virtual devices unless WOL_TEST_GPU=1.

Multi-device sharding tests run on a spoofed 8-device CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8), the standard JAX
substitute for several cards. Must run before jax is imported anywhere.

Tests marked `gpu` need an NVIDIA GPU: they skip (from a fixture, never at
import) unless JAX's backend is a GPU. `chip_smoke.py` runs them on the
card with WOL_TEST_GPU=1, which leaves the default backend in place.
"""

import os
import sys

if os.environ.get("WOL_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(__file__))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

if os.environ.get("WOL_TEST_GPU") != "1":
    # a plugin may have imported jax before this file ran
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests unless the backend really is a GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run on the card via chip_smoke.py")


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(20260816)


def make_water_box(n_waters: int, box_len: float, seed: int = 0, jitter: float = 0.35):
    """Synthetic water-oxygen positions: jittered cubic lattice filling the box.

    Dense enough to have realistic neighbor shells, deterministic, and with
    no dependence on any external trajectory file.
    """
    rs = np.random.RandomState(seed)
    n_side = int(np.ceil(n_waters ** (1.0 / 3.0)))
    spacing = box_len / n_side
    grid = np.arange(n_side) * spacing + spacing / 2
    pts = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"), axis=-1).reshape(-1, 3)
    pts = pts[rs.permutation(len(pts))[:n_waters]]
    pts = pts + rs.uniform(-jitter, jitter, pts.shape) * spacing
    return np.mod(pts, box_len)


@pytest.fixture(scope="session")
def small_box():
    """216 waters in an 18.6 A box (bulk-water density ~0.0334 / A^3)."""
    box_len = 18.6
    pos = make_water_box(216, box_len, seed=3)
    return pos, np.array([box_len, box_len, box_len])
