"""Hydration-shell population decomposition (bound / wrap / shell / non-shell).

JAX replacement for `getBoundWrap`
(/root/reference/structureLibs/orderParam_lib.py:419-572):

- **shell**  = waters whose oxygen lies within (0, cutoff] of any solute
               heavy atom (ref :495-498, `wl.nearneighbors`);
- **bound**  = shell waters H-bonded to the solute, either accepting from a
               solute O-H donor (ref :521-538 watSolHBs) or donating to a
               solute O acceptor (ref :541-553 solWatHBs) — note the
               reference computes but never uses the solute *N* triplets
               here, so neither do we;
- **wrap**   = shell minus bound (ref :563-570);
- **non-shell** = all other waters.

Instead of ragged per-frame index lists, populations are fixed-shape boolean
masks over the water-oxygen axis, computed for *all* waters at once. This is
exactly equivalent: an H-bond requires the heavy-heavy distance to be below
hbDist < cutoff, so any solute-H-bonded water is automatically in the shell,
and restricting the H-bond search to shell waters (as the reference does)
changes nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from waterorderlib_tpu.hbonds.bonds import general_hbonds
from waterorderlib_tpu.ops import pairs


class BoundWrap(NamedTuple):
    shell: jnp.ndarray  # (Nw,) water in hydration shell
    bound: jnp.ndarray  # (Nw,) shell water H-bonded to solute
    wrap: jnp.ndarray  # (Nw,) shell water not H-bonded to solute
    non_shell: jnp.ndarray  # (Nw,)


@jax.jit
def bound_wrap_masks(
    wat_o_pos: jnp.ndarray,  # (Nw, 3) water oxygen positions
    wat_donh_pos: jnp.ndarray,  # (Nw*2, 3) water hydrogens (2 per O, O-major)
    sol_pos: jnp.ndarray,  # (Nsol, 3) solute heavy atoms
    sol_acc_o_pos: jnp.ndarray,  # (NaccO, 3) solute O acceptors
    sol_don_o_pos: jnp.ndarray,  # (NdonO, 3) solute O donors (dup per H)
    sol_donh_o_pos: jnp.ndarray,  # (NdonO, 3) solute donor hydrogens
    box: jnp.ndarray,
    cutoff: float = 4.0,
    hb_dist: float = 3.0,
    hb_ang: float = 150.0,
) -> BoundWrap:
    nw = wat_o_pos.shape[0]
    # shell: any solute heavy atom within (0, cutoff] of the water oxygen
    nb = pairs.neighbor_mask(sol_pos, wat_o_pos, box, 0.0, cutoff)  # (Nsol, Nw)
    shell = jnp.any(nb, axis=0)

    # water accepts from solute O-H donors
    wat_sol = general_hbonds(wat_o_pos, sol_don_o_pos, sol_donh_o_pos, box, hb_dist, hb_ang)
    acc_any = jnp.any(wat_sol, axis=1)  # (Nw,)

    # water donates to solute O acceptors; water donors = each O twice
    wat_don_pos = jnp.repeat(wat_o_pos, 2, axis=0)  # (2Nw, 3)
    sol_wat = general_hbonds(sol_acc_o_pos, wat_don_pos, wat_donh_pos, box, hb_dist, hb_ang)
    don_entry = jnp.any(sol_wat, axis=0).reshape(nw, 2)
    don_any = jnp.any(don_entry, axis=1)

    bound = shell & (acc_any | don_any)
    wrap = shell & ~bound
    return BoundWrap(shell, bound, wrap, ~shell)
