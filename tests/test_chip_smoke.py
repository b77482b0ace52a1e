"""chip_smoke.py refuses to report anything without an NVIDIA GPU."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=600,
    )


def _printed_ok(stdout):
    for line in stdout.strip().splitlines()[-1:]:
        try:
            return json.loads(line).get("ok") is True
        except (ValueError, AttributeError):
            return False
    return False


def test_chip_smoke_fails_on_cpu():
    out = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert out.returncode != 0
    assert not _printed_ok(out.stdout)
    assert "FAILED" in out.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert out.returncode != 0
    assert not _printed_ok(out.stdout)
    assert "not beside chip_smoke.py" in out.stdout
