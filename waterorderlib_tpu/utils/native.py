"""Native helpers under `native/`, compiled from source at first use.

The sources are in the repository and the binaries are not: `native.build`
compiles one with the same flags as `native/Makefile` (`make -C native`
builds them all at once) and returns its path, or None when there is no
C++ compiler or the build fails, in which case callers use their numpy
paths.
"""

from __future__ import annotations

import os
import shutil
import subprocess

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)

# target -> (source, shared library?)
_TARGETS = {
    "libdcd.so": ("dcdlib.cc", True),
    "libmdcrd.so": ("mdcrdlib.cc", True),
    "baseline_qtet": ("baseline_qtet.cc", False),
}


def build(target: str) -> str | None:
    """Path to `native/<target>`, compiled first if missing or older than
    its source."""
    src_name, shared = _TARGETS[target]
    src = os.path.join(NATIVE_DIR, src_name)
    out = os.path.join(NATIVE_DIR, target)
    if not os.path.exists(src):
        return out if os.path.exists(out) else None
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    # build beside the target and rename, so concurrent first uses never
    # load a half-written file
    tmp = f"{out}.{os.getpid()}.tmp"
    flags = ["-shared", "-fPIC"] if shared else []
    res = subprocess.run(
        [cxx, "-O3", *flags, "-o", tmp, src], capture_output=True, text=True
    )
    if res.returncode != 0:
        from waterorderlib_tpu.utils.logging import get_logger

        get_logger().warning("building native/%s failed: %s", target, res.stderr[-500:])
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    os.replace(tmp, out)
    return out
