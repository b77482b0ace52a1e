"""Hydrogen-bond detection kernel.

JAX replacement for the canonical `generalHbonds`
(/root/reference/fortran/waterlib.f90:1136-1210) and its Python wrapper
`HBondsGeneral` (/root/reference/structureLibs/water_properties.py:681-719).

Criteria (acceptor i, donor j with matching hydrogen j):
  - minimum-image heavy-heavy distance < distCut, with distSq <= 0.01
    excluded (drops self pairs);
  - the D-H...A angle, measured at the hydrogen between the normalized
    imaged H->A and H->D vectors, must be >= angCut degrees (180 = linear).

Donor heavy atoms appear once per attached hydrogen (so donor_pos and
donor_h_pos align), exactly the reference's convention.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from waterorderlib_tpu.core import pbc


@jax.jit
def general_hbonds(
    acceptor_pos: jnp.ndarray,
    donor_pos: jnp.ndarray,
    donor_h_pos: jnp.ndarray,
    box: jnp.ndarray,
    dist_cut: float = 3.5,
    ang_cut: float = 120.0,
) -> jnp.ndarray:
    """Boolean (Nacc, Ndon) H-bond matrix (not symmetric)."""
    dv = pbc.minimum_image(donor_pos[None, :, :] - acceptor_pos[:, None, :], box)
    dsq = jnp.sum(dv * dv, axis=-1)  # (Na, Nd)
    within = (dsq <= dist_cut * dist_cut) & (dsq > 1.0e-2)

    acc_vec = pbc.minimum_image(acceptor_pos[:, None, :] - donor_h_pos[None, :, :], box)
    acc_vec = acc_vec / jnp.maximum(jnp.linalg.norm(acc_vec, axis=-1, keepdims=True), 1e-12)
    don_vec = pbc.minimum_image(donor_pos - donor_h_pos, box)
    don_vec = don_vec / jnp.maximum(jnp.linalg.norm(don_vec, axis=-1, keepdims=True), 1e-12)
    cos_ang = jnp.sum(acc_vec * don_vec[None, :, :], axis=-1)
    ang = jnp.degrees(jnp.arccos(jnp.clip(cos_ang, -1.0, 1.0)))
    return within & (ang >= ang_cut)


@partial(jax.jit, static_argnames=("block",))
def hbond_counts(
    acceptor_pos: jnp.ndarray,
    donor_pos: jnp.ndarray,
    donor_h_pos: jnp.ndarray,
    box: jnp.ndarray,
    dist_cut: float = 3.5,
    ang_cut: float = 120.0,
    block: int = 256,
):
    """Row and column sums of `general_hbonds` without the (Nacc, Ndon)
    matrix: (per-acceptor counts (Nacc,), per-donor counts (Ndon,)), int32.

    A scan over `block`-row acceptor blocks keeps only one (block, Ndon)
    tile alive and accumulates the donor counts in its carry, so memory is
    O(block * Ndon) at any system size."""
    na, nd = acceptor_pos.shape[0], donor_pos.shape[0]
    if na == 0 or nd == 0:
        return jnp.zeros(na, jnp.int32), jnp.zeros(nd, jnp.int32)
    block = min(block, na)
    n_blocks = -(-na // block)
    rows = jnp.pad(acceptor_pos, ((0, n_blocks * block - na), (0, 0)))
    real = jnp.arange(n_blocks * block) < na

    def one(don_cnt, blk):
        acc, ok = blk
        m = general_hbonds(acc, donor_pos, donor_h_pos, box, dist_cut, ang_cut)
        m = m & ok[:, None]
        return don_cnt + jnp.sum(m, axis=0, dtype=jnp.int32), jnp.sum(m, axis=1, dtype=jnp.int32)

    don_cnt, acc_cnt = jax.lax.scan(
        one, jnp.zeros(nd, jnp.int32),
        (rows.reshape(n_blocks, block, 3), real.reshape(n_blocks, block)),
    )
    return acc_cnt.reshape(-1)[:na], don_cnt


@partial(jax.jit, static_argnames=())
def hbond_counts_and_midpoints(
    acceptor_pos: jnp.ndarray,
    donor_pos: jnp.ndarray,
    donor_h_pos: jnp.ndarray,
    box: jnp.ndarray,
    dist_cut: float = 3.5,
    ang_cut: float = 120.0,
):
    """(n_bonds, bond_matrix, midpoints) like `HBondsGeneral` (wp:681-719).

    midpoints: (Nacc, Ndon, 3) imaged acceptor-donor midpoint for every pair
    (consumers mask by the bond matrix; the reference returns only bonded
    midpoints as a ragged list).
    """
    mat = general_hbonds(acceptor_pos, donor_pos, donor_h_pos, box, dist_cut, ang_cut)
    dv = pbc.minimum_image(donor_pos[None, :, :] - acceptor_pos[:, None, :], box)
    mid = acceptor_pos[:, None, :] + 0.5 * dv
    return jnp.sum(mat), mat, mid


def per_molecule_counts(bond_matrix: jnp.ndarray, acc_mol: jnp.ndarray, don_mol: jnp.ndarray, n_mol: int):
    """Fold an atom-level bond matrix to per-molecule H-bond counts.

    acc_mol/don_mol map acceptor/donor rows to molecule ids. Replaces the
    index-stride folding loops in hbCalc (orderParam_lib.py:850-860).
    Returns (n_mol,) counts of H-bonds each molecule participates in
    (as acceptor + as donor).
    """
    acc_counts = jnp.zeros(n_mol, jnp.float32).at[acc_mol].add(
        jnp.sum(bond_matrix, axis=1).astype(jnp.float32)
    )
    don_counts = jnp.zeros(n_mol, jnp.float32).at[don_mol].add(
        jnp.sum(bond_matrix, axis=0).astype(jnp.float32)
    )
    return acc_counts + don_counts
