"""Multi-device sharding tests, run in CPU-pinned subprocesses.

Every sharded check runs in a subprocess whose env forces an 8-device
virtual CPU platform, independent of how the pytest process itself started
jax — they execute on every `pytest tests/` invocation.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(n_devices=8):
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
        PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
    )
    return env


def _run(code_or_path, timeout=1200):
    if os.path.exists(code_or_path):
        cmd = [sys.executable, code_or_path]
    else:
        cmd = [sys.executable, "-c", code_or_path]
    return subprocess.run(
        cmd, cwd=REPO, env=_cpu_env(), capture_output=True, text=True, timeout=timeout
    )


def test_multichip_dryrun_subprocess():
    """The driver-facing entry: full sharded step over the default mesh."""
    out = _run("import __graft_entry__ as g; g.dryrun_multichip(8)")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dryrun_multichip ok" in out.stdout


def test_multichip_dryrun_env_vars_lie_about_backend():
    """The env vars claim a CPU platform with 8 devices, but jax is ALREADY
    live in the process on a different configuration (here: 1 CPU device).
    A pre-check that trusted the env-var strings would run in-process on
    the live (wrong) backend; dryrun_multichip must re-exec a CPU-pinned
    subprocess instead.
    """
    code = (
        "import os\n"
        "os.environ.pop('XLA_FLAGS', None)\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "import jax\n"
        "assert len(jax.devices()) == 1, jax.devices()\n"
        "# driver-style: env vars set AFTER jax is live claim 8 devices\n"
        "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'\n"
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(8)\n"
        "print('env-lie dryrun ok')\n"
    )
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("_WOL_DRYRUN_CHILD", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, (out.stdout[-1000:] + out.stderr[-3000:])
    assert "env-lie dryrun ok" in out.stdout


def test_dryrun_child_marker_fails_loudly_instead_of_recursing():
    """If the re-exec'd child is still not CPU-pinned, it must raise (not
    fork another child forever)."""
    code = (
        "import os\n"
        "os.environ.pop('XLA_FLAGS', None)\n"
        "import jax\n"  # live with 1 CPU device
        "import __graft_entry__ as g\n"
        "try:\n"
        "    g.dryrun_multichip(8)\n"
        "except RuntimeError as e:\n"
        "    assert 'not CPU-pinned' in str(e), e\n"
        "    print('child guard ok')\n"
    )
    env = _cpu_env()
    env.pop("XLA_FLAGS", None)
    env["_WOL_DRYRUN_CHILD"] = "1"
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, (out.stdout[-1000:] + out.stderr[-3000:])
    assert "child guard ok" in out.stdout


def test_child_env_scrub_unit():
    """The child env must pin CPU and force the device count while keeping
    every other variable — pure function, no subprocess."""
    import __graft_entry__ as g

    base = {
        "JAX_PLATFORMS": "cuda",
        "PYTHONPATH": "/some/repo",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2 --xla_foo",
        "HOME": "/home/user",
    }
    env = g._child_env(base, 8)
    assert env["JAX_PLATFORMS"] == "cpu"
    assert env["PYTHONPATH"] == "/some/repo"
    assert "--xla_force_host_platform_device_count=8" in env["XLA_FLAGS"]
    assert "count=2" not in env["XLA_FLAGS"]
    assert "--xla_foo" in env["XLA_FLAGS"]
    assert env["_WOL_DRYRUN_CHILD"] == "1"
    assert env["HOME"] == "/home/user"
    assert base["JAX_PLATFORMS"] == "cuda"  # the caller's dict is untouched


def test_graft_entry_module_has_no_jax_import():
    """Importing __graft_entry__ (what a dryrun parent does first) must not
    import jax: the parent stays off every backend. The property under test
    is that the module itself adds no jax import."""
    import __graft_entry__ as g

    code = (
        "import sys\n"
        "pre = 'jax' in sys.modules\n"
        "import __graft_entry__\n"
        "assert pre or 'jax' not in sys.modules, 'module import pulled in jax'\n"
        "print('no-jax import ok')\n"
    )
    env = g._child_env(dict(os.environ), 8)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "no-jax import ok" in out.stdout


def test_bench_structured_error_on_unavailable_backend():
    """bench.py measures the GPU only: with no usable backend (simulated
    with a nonexistent jax platform), and likewise on the CPU, it prints
    one parseable JSON error line and exits non-zero, never a number."""
    import json

    for platform in ("nonexistent_plugin", "cpu"):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = platform
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "bench.py")], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=300,
        )
        assert out.returncode != 0, out.stdout[-2000:]
        parsed = json.loads(out.stdout.strip().splitlines()[-1])
        assert parsed["error"] == "no_gpu_backend"
        assert parsed["value"] is None
        assert parsed["detail"]


def test_sharded_parity_all_mesh_shapes_subprocess():
    """q_tet + distance-histogram parity on 4x2 / 8x1 / 2x4 meshes, plus
    non-divisible F/N through the padding wrapper (one subprocess run covers
    all shapes to amortize startup/compile)."""
    out = _run(os.path.join(REPO, "tests", "_sharded_checks.py"))
    assert out.returncode == 0, (out.stdout[-1000:] + out.stderr[-3000:])
    assert "sharded checks: all ok" in out.stdout
