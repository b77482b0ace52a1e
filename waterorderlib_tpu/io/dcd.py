"""CHARMM/NAMD/AMBER-style DCD binary trajectory reader and writer.

Replaces the reference's pytraj trajectory loading
(/root/reference/structureLibs/TrajObject.py:33) for the ubiquitous DCD
format. Pure numpy (np.fromfile over Fortran-style records); a C++ reader
(native/dcdlib) accelerates bulk decoding, compiled at first use and
loaded via ctypes.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from waterorderlib_tpu.io.trajectory import Trajectory

_NATIVE = None


def _native():
    global _NATIVE
    if _NATIVE is None:
        from waterorderlib_tpu.utils import native

        so = native.build("libdcd.so")
        if so is not None:
            lib = ctypes.CDLL(so)
            lib.dcd_read.restype = ctypes.c_int
            lib.dcd_read.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int),  # n_frames out
                ctypes.POINTER(ctypes.c_int),  # n_atoms out
                ctypes.c_void_p,  # positions buffer (or NULL to query)
                ctypes.c_void_p,  # boxes buffer (or NULL)
                ctypes.c_long,  # buffer capacity in floats
            ]
            _NATIVE = lib
        else:
            _NATIVE = False
    return _NATIVE or None


def read_dcd(path: str, stride: int = 1) -> Trajectory:
    """Read a DCD file into a Trajectory (positions f32, boxes f32).

    Handles the standard 84-byte CORD header, optional per-frame unit cell
    (6 doubles: a, gamma, b, beta, alpha, c — only the orthorhombic a/b/c
    are used), and fixed-atom-free frames.
    """
    lib = _native()
    if lib is not None:
        nf = ctypes.c_int()
        na = ctypes.c_int()
        ret = lib.dcd_read(path.encode(), ctypes.byref(nf), ctypes.byref(na), None, None, 0)
        if ret == 0:
            pos = np.empty((nf.value, na.value, 3), np.float32)
            boxes = np.empty((nf.value, 3), np.float32)
            ret = lib.dcd_read(
                path.encode(), ctypes.byref(nf), ctypes.byref(na),
                pos.ctypes.data_as(ctypes.c_void_p), boxes.ctypes.data_as(ctypes.c_void_p),
                pos.size,
            )
            if ret == 0:
                traj = Trajectory(pos, boxes)
                return traj.strided(stride) if stride > 1 else traj
        # fall through to the numpy reader on any native failure

    with open(path, "rb") as fh:
        data = fh.read()
    off = 0

    def record():
        nonlocal off
        if off + 4 > len(data):
            raise ValueError(f"{path}: truncated DCD record header")
        (n,) = struct.unpack_from("<i", data, off)
        if n < 0 or off + 8 + n > len(data):
            raise ValueError(f"{path}: corrupt DCD record (length {n})")
        off += 4
        payload = data[off : off + n]
        off += n
        (n2,) = struct.unpack_from("<i", data, off)
        off += 4
        if n2 != n:
            raise ValueError(f"{path}: corrupt DCD record framing")
        return payload

    header = record()
    if header[:4] != b"CORD":
        raise ValueError("not a DCD file (missing CORD magic)")
    icntrl = struct.unpack_from("<20i", header, 4)
    n_frames = icntrl[0]
    has_cell = icntrl[10] != 0
    record()  # title block
    (n_atoms,) = struct.unpack("<i", record())

    positions = []
    boxes = []
    for _ in range(max(n_frames, 0) or 10**9):
        if off >= len(data):
            break
        if has_cell:
            cell = np.frombuffer(record(), dtype="<f8")
            boxes.append([cell[0], cell[2], cell[5]])
        else:
            boxes.append([-1.0, -1.0, -1.0])
        x = np.frombuffer(record(), dtype="<f4")
        y = np.frombuffer(record(), dtype="<f4")
        z = np.frombuffer(record(), dtype="<f4")
        positions.append(np.stack([x[:n_atoms], y[:n_atoms], z[:n_atoms]], axis=1))

    traj = Trajectory(np.asarray(positions), np.asarray(boxes, np.float32))
    return traj.strided(stride) if stride > 1 else traj


def write_dcd(path: str, traj: Trajectory):
    """Write a minimal orthorhombic-cell DCD file (for tests/round-trip)."""
    n_frames, n_atoms = traj.n_frames, traj.n_atoms

    def rec(payload: bytes) -> bytes:
        return struct.pack("<i", len(payload)) + payload + struct.pack("<i", len(payload))

    icntrl = [0] * 20
    icntrl[0] = n_frames
    icntrl[10] = 1  # unit cell present
    header = b"CORD" + struct.pack("<20i", *icntrl)
    title = struct.pack("<i", 1) + b"written by waterorderlib_tpu".ljust(80)
    with open(path, "wb") as fh:
        fh.write(rec(header))
        fh.write(rec(title))
        fh.write(rec(struct.pack("<i", n_atoms)))
        for f in range(n_frames):
            b = traj.boxes[f].astype(np.float64)
            cell = np.array([b[0], 90.0, b[1], 90.0, 90.0, b[2]], np.float64)
            fh.write(rec(cell.tobytes()))
            p = traj.positions[f].astype(np.float32)
            for d in range(3):
                fh.write(rec(np.ascontiguousarray(p[:, d]).tobytes()))
