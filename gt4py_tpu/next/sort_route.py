"""Sort-routing gathers for truly-IRREGULAR connectivity tables.

The affine window remap (affine_remap.py) covers quasi-structured
tables; this module compiles an arbitrary static gather into a small
sequence of static permutations (a sort with STATIC keys is a static
permutation):

    out[i] = data[idx[i]]        (idx static, N outputs, M sources)

1. **Seed permutation**: route every distinct source value to the FIRST
   output position that wants it (injective, so a permutation after
   padding to a common size P).
2. **Doubling rounds**: positions already holding a value donate it to
   one more position per round (classic pointer doubling); each round's
   donor->dest map is injective, i.e. one more static permutation plus
   a static select.  ``ceil(log2 L)`` rounds cover multiplicity ``L``.
3. **Residual patch**: skip values, occurrences beyond the round cap,
   and anything outside the planned value window go through the base
   clipped-``take`` path (tiny, keeps exact base-path semantics).

Values are only MOVED, never recomputed, so the result is bit-identical
to the take path by construction.  The numpy oracle keeps plain take
(CLAUDE.md: the oracle defines numerics); this path engages for
jax-backed Fields only, mirroring affine_remap's dispatch.

A static permutation runs as ``lax.sort_key_val`` with the static key
array.  The module was built for a machine without fast random-access
gathers; whether plain ``take`` is faster on a GPU is an open
measurement (ROADMAP.md), so the default is unchanged.

Reference behavior: gather through NeighborTables of
src/gt4py/next/embedded/nd_array_field.py:615-1023.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

#: residual fraction above which a plan is rejected
_MAX_RESIDUAL = 0.10
#: tables smaller than this are not worth planning (take is fine)
_MIN_SIZE = 65536
#: occurrence-rank cap: ranks >= 2**_MAX_ROUNDS become residual
_MAX_ROUNDS = 3
#: profitability: sort-route only when P*(rounds+1)*S < take_cost*N
#: (chip r5: sort ~1.5 ns/elem/pass, take ~7.2 ns/elem)
_SORT_NS, _TAKE_NS = 1.5, 7.2


def _enabled() -> bool:
    return os.environ.get("GT4PY_TPU_SORT_GATHER", "1") != "0"


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """Routing recipe: out_flat = rounds(seed(pad(window(data))))[:N]."""

    n_out: int  # N: flattened table size
    vmin: int  # planned source-value window [vmin, vmax]
    vmax: int
    P: int  # routing size: >= max(N, window)
    #: sort KEY arrays (each a P-permutation): sorting vals by keys[r]
    #: realizes dest[j] = src[perm_r(j)]
    keys: Tuple[np.ndarray, ...]
    #: per round r >= 1: bool (P,) -- positions receiving a copy
    masks: Tuple[np.ndarray, ...]
    res_pos: np.ndarray  # positions handled by the take patch
    res_idx: np.ndarray  # raw table values at those positions


def build_gather_plan(
    table: np.ndarray, skip_value: Optional[int]
) -> Optional[GatherPlan]:
    """Plan a (possibly multi-column) neighbor table; None when take is
    the better choice (small/ultra-hub tables)."""
    table = np.asarray(table)
    if table.size < _MIN_SIZE:
        return None
    idx = table.reshape(-1).astype(np.int64)
    N = idx.size
    good = np.ones(N, dtype=bool)
    if skip_value is not None:
        good &= idx != skip_value
    if not good.any():
        return None
    vmin = int(idx[good].min())
    vmax = int(idx[good].max())
    W = vmax - vmin + 1
    P = max(N, W)

    # group positions by source slot; rank = occurrence index within slot
    slots = np.where(good, idx - vmin, -1)
    order = np.argsort(slots, kind="stable")  # residuals (-1) first
    n_bad = int(N - good.sum())
    pos_sorted = order[n_bad:]  # positions grouped by slot, ascending
    slot_sorted = slots[pos_sorted]
    first = np.ones(pos_sorted.size, dtype=bool)
    first[1:] = slot_sorted[1:] != slot_sorted[:-1]
    # occurrence rank via grouped cumcount
    grp_start = np.flatnonzero(first)
    rank = np.arange(pos_sorted.size) - np.repeat(
        grp_start, np.diff(np.append(grp_start, pos_sorted.size))
    )

    cap = 1 << _MAX_ROUNDS
    over = rank >= cap
    res_mask = ~good
    res_mask[pos_sorted[over]] = True
    if res_mask.sum() > _MAX_RESIDUAL * N:
        return None
    L = int(rank[~over].max()) + 1 if (~over).any() else 1
    rounds = max(0, (L - 1).bit_length())

    # profitability vs plain take
    if _SORT_NS * P * (rounds + 1) >= _TAKE_NS * N:
        return None

    def complete(partial_dest_to_src: np.ndarray) -> np.ndarray:
        """Fill -1 entries to a full P-permutation (arbitrary matching
        of unused sources onto unassigned destinations)."""
        used = np.zeros(P, dtype=bool)
        assigned = partial_dest_to_src >= 0
        used[partial_dest_to_src[assigned]] = True
        free_src = np.flatnonzero(~used)
        free_dst = np.flatnonzero(~assigned)
        out = partial_dest_to_src.copy()
        out[free_dst] = free_src
        return out

    def keys_for(dest_to_src: np.ndarray) -> np.ndarray:
        """sort_key_val(keys, vals)[1][j] == vals[argwhere(keys == j)]:
        to get dest[j] = src[sigma(j)], key[s] = sigma^{-1}(s)."""
        inv = np.empty(P, dtype=np.int64)
        inv[dest_to_src] = np.arange(P)
        return inv.astype(np.int32)

    keys = []
    masks = []
    # seed: dest position (rank 0) <- source slot
    seed = np.full(P, -1, dtype=np.int64)
    r0 = rank == 0
    seed[pos_sorted[r0]] = slot_sorted[r0]
    keys.append(keys_for(complete(seed)))

    for r in range(1, rounds + 1):
        half = 1 << (r - 1)
        sel = (rank >= half) & (rank < 2 * half) & ~over
        dests = pos_sorted[sel]
        # donor = same slot, rank - half: pos_sorted is rank-ordered
        # within each slot, so the donor sits `half` entries earlier
        donors = pos_sorted[np.flatnonzero(sel) - half]
        sigma = np.full(P, -1, dtype=np.int64)
        sigma[dests] = donors
        keys.append(keys_for(complete(sigma)))
        m = np.zeros(P, dtype=bool)
        m[dests] = True
        masks.append(m)

    res_pos = np.flatnonzero(res_mask).astype(np.int64)
    return GatherPlan(
        n_out=N,
        vmin=vmin,
        vmax=vmax,
        P=P,
        keys=tuple(keys),
        masks=tuple(masks),
        res_pos=res_pos,
        res_idx=idx[res_pos].copy(),
    )


def plan_for(conn) -> Optional[GatherPlan]:
    """Cached gather plan for an irregular Connectivity (None when the
    take path or affine remap should be used instead).  Cache keying and
    the immutability freeze mirror affine_remap.plan_for."""
    from . import affine_remap

    cached = conn.__dict__.get("_sort_route_plan")
    token = affine_remap.table_token(conn.table)
    if cached is not None and cached[0] == token:
        return cached[1]
    plan = None
    if _enabled() and isinstance(conn.table, np.ndarray):
        plan = build_gather_plan(conn.table, conn.skip_value)
        if plan is not None:
            try:
                conn.table.flags.writeable = False
            except ValueError:
                pass
    conn.__dict__["_sort_route_plan"] = (token, plan)
    return plan


def _permute(vals, keys_np: np.ndarray):
    """Static permutation dest[j] = src[sigma(j)] of a 1D jax array,
    through the fastest available executor."""
    import jax.numpy as jnp
    from jax import lax

    return lax.sort_key_val(jnp.asarray(keys_np), vals)[1]


def apply_gather_plan(plan: GatherPlan, data, own_start: int, axis: int):
    """Gather ``data`` through the planned table: identical layout and
    values to ``take(data, clip(table - own_start), axis)`` (flat; the
    caller reshapes to the table shape).  None when the runtime domain
    does not cover the planned value window (base-path clip semantics
    must apply)."""
    import jax.numpy as jnp

    nc = data.shape[axis]
    if plan.vmin - own_start < 0 or plan.vmax - own_start >= nc:
        return None

    # flatten the non-gather axes: route along a leading axis
    moved = jnp.moveaxis(data, axis, 0)
    rest = moved.shape[1:]
    flat = moved.reshape(moved.shape[0], -1)
    ncols = flat.shape[1]

    lo = plan.vmin - own_start
    win = jnp.asarray(flat[lo : lo + (plan.vmax - plan.vmin + 1)])
    if win.shape[0] < plan.P:
        win = jnp.pad(win, ((0, plan.P - win.shape[0]), (0, 0)))

    def route(col):
        cur = _permute(col, plan.keys[0])
        for keys_r, mask_r in zip(plan.keys[1:], plan.masks):
            movedv = _permute(cur, keys_r)
            cur = jnp.where(jnp.asarray(mask_r), movedv, cur)
        return cur[: plan.n_out]

    if ncols == 1:
        out_flat = route(win[:, 0])[:, None]
    else:
        import jax

        out_flat = jax.vmap(route, in_axes=1, out_axes=1)(win)

    if plan.res_pos.size:
        safe = np.clip(plan.res_idx - own_start, 0, nc - 1)
        vals = jnp.take(flat, jnp.asarray(safe), axis=0)
        out_flat = out_flat.at[jnp.asarray(plan.res_pos)].set(vals)

    out = out_flat.reshape((plan.n_out,) + rest)
    return jnp.moveaxis(out, 0, axis)
