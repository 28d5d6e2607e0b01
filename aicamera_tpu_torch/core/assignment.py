"""Optimal assignment (shortest-augmenting-path LAPJV) and the DeepSORT
matching cascade.

The port of ``aicamera_tpu/core/assignment.py``: ``solve_square`` with its
vectorised row-argmin pre-assignment and sequential augmenting phase,
``min_cost_matching`` with the reference's threshold semantics (costs above
``max_distance`` clamped to ``max_distance + 1e-5``; a match is accepted only
if its original cost is ``<= max_distance``), and the DeepSORT
``matching_cascade`` over ``time_since_update`` levels.

:func:`min_cost_matching` and :func:`matching_cascade` pick by device: on
CUDA tensors they launch the hand-written kernel (``ops/assignment.py``, one
launch a call, nothing read back), on CPU tensors they run the plain
versions here, which are also the kernel's oracle on the card. Both take one
problem or a batch with a leading axis (``cost (B, R, C)``: the streams of a
multi-stream step, as ``jax.vmap`` of the JAX functions); a batch is one
launch, and the plain versions loop over its problems. The plain versions
run the JAX package's ``lax.while_loop``s and ``lax.cond``s as Python
control flow over values they read from their tensors. Ties resolve as in
JAX: ``argmin`` takes the first minimum, and row order is kept.

The helpers of the tracker steps (:func:`_scatter_drop`,
:func:`place_new_tracks`, :func:`_claim`) work along the last axis of their
index and mask arguments, over any leading stream axes.

``TRACKER_SYNCS`` would count a tracker step's reads of the GPU. No core's
step makes one (DeepSORT, ByteTrack and OC-SORT select where the JAX
package branches), so it stays at 0: the tests and ``chip_smoke.py`` hold
it there.
"""

from __future__ import annotations

import torch

from ..ops import assignment as _kernel
from ..syncs import SyncCounter

TRACKER_SYNCS = SyncCounter()


def _scatter_drop(arr: torch.Tensor, idx: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].set(values, mode="drop")`` for indices in ``[0, T]``
    along the axis ``idx.ndim - 1`` of ``arr`` (T long): index T is a dump
    row that is cut off. ``idx (..., N)``, ``values (..., N, *rest)`` and
    ``arr (..., T, *rest)`` share their leading (stream) axes."""
    ax = idx.ndim - 1
    t = arr.shape[ax]
    ext = torch.cat([arr, arr.narrow(ax, 0, 1)], dim=ax)  # a new tensor
    rest = ext.shape[ax + 1:]
    index = idx.reshape(idx.shape + (1,) * len(rest)).expand(
        idx.shape + rest)
    return ext.scatter_(ax, index, values.to(arr.dtype)).narrow(ax, 0, t)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the axis ``idx.ndim - 1`` of ``x``: ``x (..., N,
    *rest)`` gathered by ``idx (..., T)`` into ``(..., T, *rest)``."""
    ax = idx.ndim - 1
    rest = x.shape[ax + 1:]
    return torch.gather(x, ax, idx.reshape(idx.shape + (1,) * len(rest))
                        .expand(idx.shape + rest))


def place_new_tracks(active: torch.Tensor, new_det: torch.Tensor):
    """Slots for the detections that start tracks: the r-th new detection
    takes the r-th lowest free slot. ``active (..., T)``, ``new_det (...,
    N)``. Returns ``(slot_for_det (..., N) int64 with the dump index T where
    nothing is placed, det_rank (..., N) int64, n_new, dropped)``, the last
    two int32 of the leading shape."""
    t = active.shape[-1]
    rows = torch.arange(t, device=active.device).expand(active.shape)
    free = ~active
    n_free = torch.sum(free, -1, keepdim=True)
    slot_rank = torch.cumsum(free, -1) - 1
    slot_of_rank = _scatter_drop(
        torch.full(active.shape, t, dtype=torch.int64, device=active.device),
        torch.where(free, slot_rank, t), rows)
    det_rank = torch.cumsum(new_det, -1) - 1
    can_place = new_det & (det_rank < n_free)
    slot_for_det = torch.where(
        can_place, _take(slot_of_rank, torch.clamp(det_rank, 0, t - 1)), t)
    return (slot_for_det, det_rank, torch.sum(can_place, -1).to(torch.int32),
            torch.sum(new_det & ~can_place, -1).to(torch.int32))


def _augment_row(i: int, cost, u, v, col4row, row4col):
    """Run one shortest augmenting path from row ``i`` and apply it."""
    n = cost.shape[0]
    dev = cost.device
    sr = torch.zeros(n, dtype=torch.bool, device=dev)
    sc = torch.zeros(n, dtype=torch.bool, device=dev)
    spc = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    path = torch.full((n,), -1, dtype=torch.int64, device=dev)
    min_val = torch.zeros((), dtype=torch.float32, device=dev)
    inf = torch.full_like(spc, float("inf"))
    cur_row = i
    while True:
        sr[cur_row] = True
        reduced = min_val + cost[cur_row] - u[cur_row] - v
        upd = (~sc) & (reduced < spc)
        spc = torch.where(upd, reduced, spc)
        path = torch.where(upd, torch.full_like(path, cur_row), path)
        masked = torch.where(sc, inf, spc)
        j_dev = torch.argmin(masked)
        min_val = masked[j_dev]
        sc[j_dev] = True
        j, r = torch.stack([j_dev, row4col[j_dev]]).tolist()
        if r < 0:
            sink = j
            break
        cur_row = r

    # Dual variable update (potentials), as in the classical JV scheme.
    rows = torch.arange(n, device=dev)
    u = u.clone()
    u[i] += min_val
    spc_at_assigned = spc[torch.clamp(col4row, 0, n - 1)]
    u = torch.where(sr & (rows != i), u + min_val - spc_at_assigned, u)
    v = torch.where(sc, v - (min_val - spc), v)

    # Augment: walk back from the sink flipping assignments.
    row4col = row4col.clone()
    col4row = col4row.clone()
    j = sink
    while True:
        i_, j_next = torch.stack([path[j], col4row[path[j]]]).tolist()
        row4col[j] = i_
        col4row[i_] = j
        if i_ == i:
            break
        j = j_next
    return u, v, col4row, row4col


def solve_square(cost: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """Optimal assignment on a square (n, n) cost matrix of finite costs.

    Rows where ``row_mask`` is False stay unassigned. Returns ``col4row``
    (n,) int64 with -1 for unassigned rows. Each eligible row first claims
    its cheapest column (collisions go to the smallest row index); only the
    losers run the sequential augmenting phase, in row order.
    """
    n = cost.shape[0]
    dev = cost.device
    cost = cost.float()
    rows = torch.arange(n, device=dev)
    jmin = torch.argmin(cost, dim=1)
    # the value at the argmin: of a -0.0 and a +0.0 minimum, the first
    rowmin = torch.gather(cost, 1, jmin[:, None])[:, 0]
    dump = torch.full_like(jmin, n)
    winner = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, torch.where(row_mask, jmin, dump), rows,
                           reduce="amin", include_self=True)
    assigned = row_mask & (winner[:n][jmin] == rows)
    col4row = torch.where(assigned, jmin, torch.full_like(jmin, -1))
    row4col = _scatter_drop(torch.full((n,), -1, dtype=torch.int64,
                                       device=dev),
                            torch.where(assigned, jmin, dump),
                            torch.where(assigned, rows,
                                        torch.full_like(rows, -1)))
    u = torch.where(assigned, rowmin, torch.zeros_like(rowmin))
    v = torch.zeros(n, dtype=torch.float32, device=dev)

    todo = row_mask & ~assigned
    # the losers, in ascending row order
    todo_rows = [i for i, t in enumerate(todo.tolist()) if t]
    for i in todo_rows:
        u, v, col4row, row4col = _augment_row(i, cost, u, v, col4row,
                                              row4col)
    return col4row


def _on_cuda(cost: torch.Tensor) -> bool:
    if cost.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the assignment runs on CUDA or CPU tensors (got "
                         f"{cost.device})")
    return cost.device.type == "cuda"


def min_cost_matching(cost: torch.Tensor, row_mask: torch.Tensor,
                      col_mask: torch.Tensor,
                      max_distance: float) -> torch.Tensor:
    """Masked minimum-cost matching with the reference's threshold
    semantics. ``cost (R, C)`` f32, bool masks; returns ``(R,)`` int64,
    the matched column per row or -1. A batch ``(B, R, C)`` with ``(B, R)``
    and ``(B, C)`` masks gives ``(B, R)``. CUDA tensors: the kernel (one
    launch a call); CPU tensors: :func:`min_cost_matching_plain`."""
    if _on_cuda(cost):   # the kernel's wrapper checks the arguments
        return _kernel.KERNEL.min_cost_matching(cost, row_mask, col_mask,
                                                max_distance)
    _kernel.check_args(cost, row_mask, col_mask)
    return min_cost_matching_plain(cost, row_mask, col_mask, max_distance)


def _per_problem(fn, *args):
    """``fn`` over the problems of a batch (a leading axis on every tensor
    argument), its outputs stacked: the plain versions' batch."""
    outs = [fn(*(a[b] if torch.is_tensor(a) else a for a in args))
            for b in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(x) for x in zip(*outs))
    return torch.stack(outs)


def min_cost_matching_plain(cost: torch.Tensor, row_mask: torch.Tensor,
                            col_mask: torch.Tensor,
                            max_distance: float) -> torch.Tensor:
    """The plain version of :func:`min_cost_matching`; a batch loops over
    its problems."""
    if cost.ndim == 3:
        return _per_problem(min_cost_matching_plain, cost, row_mask,
                            col_mask, max_distance)
    r, c = cost.shape
    n = max(r, c)
    dev = cost.device
    max_d = torch.tensor(max_distance, dtype=torch.float32, device=dev)
    clamp = max_d + 1e-5  # f32 arithmetic, as in JAX

    eligible = row_mask[:, None] & col_mask[None, :]
    feasible = eligible & (cost <= max_d)
    # Rows/cols with no feasible entry can never yield an accepted match.
    row_ok = row_mask & torch.any(feasible, dim=1)
    col_ok = col_mask & torch.any(feasible, dim=0)

    eligible = row_ok[:, None] & col_ok[None, :]
    clamped = torch.where(eligible & (cost <= max_d), cost.float(), clamp)
    padded = clamp.expand(n, n).clone()
    padded[:r, :c] = clamped
    row_mask_p = torch.zeros(n, dtype=torch.bool, device=dev)
    row_mask_p[:r] = row_ok
    col4row = solve_square(padded, row_mask_p)[:r]

    j = torch.clamp(col4row, 0, c - 1)
    ok = (row_mask & (col4row >= 0) & (col4row < c) & col_mask[j]
          & (cost[torch.arange(r, device=dev), j] <= max_d))
    return torch.where(ok, col4row, torch.full_like(col4row, -1))


def _claim(lvl_match: torch.Tensor, det_unmatched: torch.Tensor):
    """The detections still unmatched once the rows' ``lvl_match (...,
    T)`` claimed theirs: ``det_unmatched (..., N)``."""
    nd = det_unmatched.shape[-1]
    claimed = _scatter_drop(
        torch.zeros_like(det_unmatched),
        torch.where(lvl_match >= 0, lvl_match,
                    torch.full_like(lvl_match, nd)),
        torch.ones_like(lvl_match, dtype=torch.bool))
    return det_unmatched & ~claimed


def matching_cascade(cost: torch.Tensor, track_level: torch.Tensor,
                     track_eligible: torch.Tensor, det_valid: torch.Tensor,
                     max_distance: float, cascade_depth: int):
    """DeepSORT matching cascade over ``time_since_update`` levels: one
    assignment per level present in ``[1, cascade_depth]``, ascending,
    against the still-unmatched detections, until none is left.

    Returns ``(match (T,) int64 det index or -1, det_unmatched (N,) bool)``;
    a batch (``cost (B, T, N)``, the other arguments with the same leading
    axis) gives ``(B, T)`` and ``(B, N)``. CUDA tensors: the kernel, every
    problem's whole cascade in one launch; CPU tensors:
    :func:`matching_cascade_plain`.
    """
    if _on_cuda(cost):
        return _kernel.KERNEL.matching_cascade(
            cost, track_level, track_eligible, det_valid, max_distance,
            cascade_depth)
    _kernel.check_args(cost, track_eligible, det_valid)
    return matching_cascade_plain(cost, track_level, track_eligible,
                                  det_valid, max_distance, cascade_depth)


def matching_cascade_plain(cost: torch.Tensor, track_level: torch.Tensor,
                           track_eligible: torch.Tensor,
                           det_valid: torch.Tensor, max_distance: float,
                           cascade_depth: int):
    """The plain version of :func:`matching_cascade`; a batch loops over
    its problems."""
    if cost.ndim == 3:
        return _per_problem(matching_cascade_plain, cost, track_level,
                            track_eligible, det_valid, max_distance,
                            cascade_depth)
    t = cost.shape[0]
    sentinel = cascade_depth + 1
    lv = torch.where(
        track_eligible & (track_level >= 1) & (track_level <= cascade_depth),
        track_level.long(), torch.full_like(track_level, sentinel).long())
    # the levels present, ascending
    levels = sorted(set(lv.tolist()) - {sentinel})
    match = torch.full((t,), -1, dtype=torch.int64, device=cost.device)
    det_unmatched = det_valid
    for n, level in enumerate(levels):
        # Stop once every detection is claimed (an assignment against no
        # columns matches nothing, so the first level needs no check).
        if n and not bool(torch.any(det_unmatched)):
            break
        rows = track_eligible & (track_level == level)
        lvl_match = min_cost_matching_plain(cost, rows, det_unmatched,
                                            max_distance)
        match = torch.where(lvl_match >= 0, lvl_match, match)
        det_unmatched = _claim(lvl_match, det_unmatched)
    return match, det_unmatched
