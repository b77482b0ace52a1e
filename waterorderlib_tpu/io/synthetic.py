"""Synthetic system generators for tests, benchmarks, and examples.

The reference has no test fixtures at all (its drivers require real AMBER
topology/trajectory files); these generators produce deterministic in-repo
water boxes with realistic geometry so every driver can run end-to-end with
zero external file dependencies.
"""

from __future__ import annotations

import numpy as np

from waterorderlib_tpu.io.topology import Topology
from waterorderlib_tpu.io.trajectory import Trajectory

OH_LEN = 0.9572  # TIP3P O-H bond length (Angstrom)
HOH_ANG = np.radians(104.52)  # TIP3P H-O-H angle
WATER_NUMBER_DENSITY = 0.033456  # Angstrom^-3


def _random_rotations(n: int, rs: np.random.RandomState) -> np.ndarray:
    """n uniform random rotation matrices (via normalized quaternions)."""
    q = rs.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def _lattice_sites(n_waters: int, box_len: float, seed: int, jitter: float):
    """(positions (n_waters, 3), cubic-grid cell of each, cells per side)."""
    rs = np.random.RandomState(seed)
    n_side = int(np.ceil(n_waters ** (1.0 / 3.0)))
    spacing = box_len / n_side
    grid = np.arange(n_side) * spacing + spacing / 2
    pts = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"), -1).reshape(-1, 3)
    cells = rs.permutation(len(pts))[:n_waters]
    pts = pts[cells] + rs.uniform(-jitter, jitter, (n_waters, 3)) * spacing
    return np.mod(pts, box_len), cells, n_side


def water_oxygen_lattice(n_waters: int, box_len: float, seed: int = 0, jitter: float = 0.35):
    """Jittered cubic lattice of oxygen positions filling a cubic box."""
    return _lattice_sites(n_waters, box_len, seed, jitter)[0]


def _hop(grid: np.ndarray, rs: np.random.RandomState, p_swap: float) -> None:
    """One sweep of nearest-neighbour swaps on an (n, n, n) periodic grid of
    molecule labels (-1 = empty cell), in place: along a random axis, cells
    are paired by a random parity and each pair of occupied cells swaps its
    molecules with probability `p_swap`."""
    n = grid.shape[0]
    g = np.moveaxis(grid, rs.randint(3), 0)  # a view: swaps write through
    i = np.arange(rs.randint(2), 2 * (n // 2), 2)
    j = (i + 1) % n
    gi, gj = g[i].copy(), g[j].copy()
    swap = (rs.uniform(size=gi.shape) < p_swap) & (gi >= 0) & (gj >= 0)
    g[i] = np.where(swap, gj, gi)
    g[j] = np.where(swap, gi, gj)


def make_water_topology(n_waters: int, solute_elements: list[str] | None = None) -> Topology:
    """Topology for n rigid waters (O, H1, H2 per residue) plus an optional
    single solute residue 'MOL' whose atoms are listed after the waters."""
    names, elements, res_names, res_ids, bonds, masses = [], [], [], [], [], []
    for i in range(n_waters):
        base = 3 * i
        names += ["O", "H1", "H2"]
        elements += ["O", "H", "H"]
        res_names += ["WAT"] * 3
        res_ids += [i] * 3
        bonds += [[base, base + 1], [base, base + 2]]
        masses += [15.999, 1.008, 1.008]
    if solute_elements:
        base = 3 * n_waters
        for k, el in enumerate(solute_elements):
            names.append(f"{el}{k + 1}")
            elements.append(el)
            res_names.append("MOL")
            res_ids.append(n_waters)
            masses.append({"C": 12.011, "N": 14.007, "O": 15.999, "S": 32.06, "H": 1.008}.get(el, 12.0))
        # chain bonds within the solute
        for k in range(len(solute_elements) - 1):
            bonds.append([base + k, base + k + 1])
    return Topology(
        names=np.array(names, dtype=object),
        elements=np.array(elements, dtype=object),
        res_names=np.array(res_names, dtype=object),
        res_ids=np.array(res_ids),
        bonds=np.array(bonds, dtype=int).reshape(-1, 2),
        masses=np.array(masses),
    )


def make_water_box(
    n_waters: int,
    n_frames: int = 1,
    density: float = WATER_NUMBER_DENSITY,
    seed: int = 0,
    solute_elements: list[str] | None = None,
    frame_jitter: float = 0.08,
    diffusion: float = 0.0,
) -> tuple[Topology, Trajectory]:
    """Deterministic multi-frame box of rigid waters at the given density.

    Waters sit on a jittered lattice with random orientations; successive
    frames add small random displacements (no physics, but realistic
    neighbor statistics). The optional solute is a compact chain of heavy
    atoms near the box center.

    diffusion: self-diffusion coefficient in A^2/ps for frames saved 1 ps
    apart (liquid water at 298 K: ~0.23). When positive, waters also hop
    between neighbouring lattice sites by pairwise swaps, at the rate that
    gives a mean squared displacement of 6 * diffusion per frame: molecules
    wander across the box as in an MD trajectory, while the sites keep the
    liquid-like neighbour statistics of frame 0.
    """
    box_len = (n_waters / density) ** (1.0 / 3.0)
    rs = np.random.RandomState(seed)
    o_pos, cells, n_side = _lattice_sites(n_waters, box_len, seed, 0.35)

    # local water geometry: O at origin, H's in the xz plane
    h1 = np.array([OH_LEN * np.sin(HOH_ANG / 2), 0.0, OH_LEN * np.cos(HOH_ANG / 2)])
    h2 = np.array([-OH_LEN * np.sin(HOH_ANG / 2), 0.0, OH_LEN * np.cos(HOH_ANG / 2)])

    top = make_water_topology(n_waters, solute_elements)
    n_sol = len(solute_elements) if solute_elements else 0
    n_atoms = 3 * n_waters + n_sol

    frames = np.zeros((n_frames, n_atoms, 3), dtype=np.float64)
    boxes = np.tile(np.array([box_len] * 3), (n_frames, 1))

    if n_sol:
        center = np.array([box_len / 2] * 3)
        sol0 = center + np.arange(n_sol)[:, None] * np.array([1.5, 0.2, -0.1])
        # push waters off the solute to avoid overlaps
        for s in sol0:
            d = o_pos - s
            d -= box_len * np.round(d / box_len)
            r = np.linalg.norm(d, axis=1)
            close = r < 2.6
            o_pos[close] += (d[close].T / np.maximum(r[close], 1e-6) * (2.6 - r[close])).T

    # site k sits in grid cell cells[k]; grid holds the molecule on each
    # cell, so molecule m is at o_pos[site[m]]
    site_of_cell = np.full(n_side**3, -1)
    site_of_cell[cells] = np.arange(n_waters)
    grid = np.full(n_side**3, -1)
    grid[cells] = np.arange(n_waters)
    grid = grid.reshape((n_side,) * 3)
    hops = 6.0 * diffusion / (box_len / n_side) ** 2  # per molecule per frame
    # few enough swaps per sweep that a molecule rarely swaps straight back
    n_sweeps = int(np.ceil(hops / 0.2))
    site = np.arange(n_waters)
    for f in range(n_frames):
        if f > 0 and n_sweeps:
            for _ in range(n_sweeps):
                _hop(grid, rs, hops / n_sweeps)
            flat = grid.reshape(-1)
            occ = flat >= 0
            site[flat[occ]] = site_of_cell[occ]
        o_f = o_pos[site] + rs.normal(scale=frame_jitter, size=o_pos.shape)
        rots = _random_rotations(n_waters, rs)
        h1_f = o_f + rots @ h1
        h2_f = o_f + rots @ h2
        wat = np.stack([o_f, h1_f, h2_f], axis=1).reshape(-1, 3)
        frames[f, : 3 * n_waters] = wat
        if n_sol:
            frames[f, 3 * n_waters :] = sol0 + rs.normal(scale=frame_jitter / 2, size=(n_sol, 3))

    return top, Trajectory(frames, boxes)
