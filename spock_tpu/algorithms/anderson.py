"""Anderson acceleration (type-II) direction for SuperMann.

Counterpart of ``anderson!`` (``/root/reference/src/model_algorithms/
qnewton_directions/anderson.jl``): window-m history of residual differences
``dR`` and ``dP = dZ - dR``; direction

    d = -r - dP^T gamma,   gamma = argmin || dR^T gamma - r ||_2.

Departures from the reference:

* **History = tuple of m pytree rows** (not a shifted [B, m, K] tensor):
  separate rows keep clean per-leaf layouts, the Gram/projection reductions
  fuse into single passes with no flatten/unflatten, and the ring update
  rebinds one row instead of copying the buffer.  Row order is irrelevant
  to the least-squares solve.
* **Normal equations, not incremental QR**: a tiny m x m system per lane
  with Tikhonov regularization; accuracy differences are absorbed by
  SuperMann's K1/K2 safeguards.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..zv import tmap


def _solve3(A, b):
    """Closed-form batched 3x3 solve via the adjugate (Cramer).

    [B, 3, 3] systems: jnp.linalg.solve lowers to a batched LU chain; the
    explicit formula is a handful of fused elementwise ops on [B] scalars."""
    a, bb, c = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    d, e, f = A[:, 1, 0], A[:, 1, 1], A[:, 1, 2]
    g, h, i = A[:, 2, 0], A[:, 2, 1], A[:, 2, 2]
    co00 = e * i - f * h
    co01 = f * g - d * i
    co02 = d * h - e * g
    det = a * co00 + bb * co01 + c * co02
    co10 = c * h - bb * i
    co11 = a * i - c * g
    co12 = bb * g - a * h
    co20 = bb * f - c * e
    co21 = c * d - a * f
    co22 = a * e - bb * d
    x0 = co00 * b[:, 0] + co10 * b[:, 1] + co20 * b[:, 2]
    x1 = co01 * b[:, 0] + co11 * b[:, 1] + co21 * b[:, 2]
    x2 = co02 * b[:, 0] + co12 * b[:, 1] + co22 * b[:, 2]
    inv = 1.0 / jnp.where(det != 0, det, 1.0)
    return jnp.stack([x0, x1, x2], axis=-1) * inv[:, None]


def direction_flat(MR, MP, r, valid=None):
    """Flat-history Anderson direction.

    MR/MP: [B, m, K] histories (rows in arbitrary order); r: [B, K].
    Returns d = -r - gamma' MP with gamma from regularized normal equations.

    valid: optional [B, m] bool — rows whose history is live for the lane's
    CURRENT solve.  Invalid rows are excluded *algebraically* (their Gram
    entries, projections, and gamma are zeroed — exactly what physically
    zeroed rows would contribute), so stale rows left over from a previous
    solve in the same buffer never need an O(B m K) zeroing pass.  This is
    what lets the async MPC farm refill a lane without touching the
    histories.

    Bandwidth note: the Gram and projection run as batched matmuls, so no
    [B, m, m, K] broadcast product is ever formed.
    """
    m = MR.shape[1]
    dtype = MR.dtype
    G = jnp.matmul(MR, MR.swapaxes(-1, -2))  # [B, m, m]
    c = jnp.matmul(MR, r[:, :, None])[..., 0]  # [B, m]
    if valid is not None:
        vm = valid.astype(dtype)  # [B, m]
        G = G * (vm[:, :, None] * vm[:, None, :])
        c = c * vm
    tr = jnp.trace(G, axis1=-2, axis2=-1)
    eps = jnp.asarray(1e-10, dtype) * (tr / m) + jnp.asarray(1e-30, dtype)
    Greg = G + eps[:, None, None] * jnp.eye(m, dtype=dtype)
    if m == 3:
        gamma = _solve3(Greg, c)
    else:
        gamma = jnp.linalg.solve(Greg, c[..., None])[..., 0]
    if valid is not None:
        gamma = gamma * vm
    return -r - jnp.matmul(gamma[:, None, :], MP)[:, 0]


def hist_insert(H, new):
    """Insert ``new`` as row 0 of a newest-first history, shifting older rows
    right (the oldest falls off).

    H: pytree with leaves [B, m, *event]; new: matching pytree with leaves
    [B, *event].  Newest-first rotation replaces the ring-slot scheme: the
    row order is identical for every lane at every iteration, so a lane
    refilled mid-farm sees exactly the history layout a standalone
    warm-started solve would — bitwise, not just algebraically."""
    return tmap(
        lambda h, nl: jnp.concatenate([nl[:, None], h[:, :-1]], axis=1),
        H,
        new,
    )


def direction_struct(MR, MP, r, niter):
    """Anderson direction over structured newest-first histories.

    MR/MP: pytrees with leaves [B, m, *event] (row 0 = newest, see
    :func:`hist_insert`); r: residual pytree (leaves [B, *event]); niter:
    [B] per-lane iteration counter of the current solve.

    Row j was inserted j iterations ago, so it belongs to the lane's current
    solve iff ``j <= niter`` — stale rows (left over from a previous solve
    after an async-farm refill) are excluded *algebraically*: their Gram
    entries and gamma weights are zeroed, contributing the exact zeros
    physically zeroed rows would.  No O(B m K) reset pass, and the result is
    bitwise equal to a standalone warm solve (validity masking commutes with
    the closed-form 3x3 solve).

    All reductions are leafwise (no flatten/concat across the node axis), so
    node shardings of the leaves survive: the Gram lowers to per-shard
    partial sums + an all-reduce of [B, m, m] scalars — this is what makes
    SuperMann runnable on node-sharded big trees.
    """
    mr_leaves = jax.tree_util.tree_leaves(MR)
    mp_leaves = jax.tree_util.tree_leaves(MP)
    r_leaves = jax.tree_util.tree_leaves(r)
    m = mr_leaves[0].shape[1]
    B = mr_leaves[0].shape[0]
    dtype = mr_leaves[0].dtype

    def red(a):
        return jnp.sum(a, axis=tuple(range(1, a.ndim)))

    # Gram G_ij = <y_i, y_j> and c_j = <y_j, r>, leafwise accumulation; m is
    # tiny (3) so the symmetric entry loop beats any batched-matmul reshape
    # (which would merge — and therefore gather — sharded node axes).
    G = [[jnp.zeros((B,), dtype) for _ in range(m)] for _ in range(m)]
    c = [jnp.zeros((B,), dtype) for _ in range(m)]
    for hl, rl in zip(mr_leaves, r_leaves):
        for i in range(m):
            for j in range(i, m):
                G[i][j] = G[i][j] + red(hl[:, i] * hl[:, j])
            c[i] = c[i] + red(hl[:, i] * rl)
    for i in range(m):
        for j in range(i):
            G[i][j] = G[j][i]
    Gm = jnp.stack([jnp.stack(row, axis=-1) for row in G], axis=-2)
    cm = jnp.stack(c, axis=-1)

    vm = (jnp.arange(m)[None, :] <= niter[:, None]).astype(dtype)  # [B, m]
    Gm = Gm * (vm[:, :, None] * vm[:, None, :])
    cm = cm * vm
    tr = jnp.trace(Gm, axis1=-2, axis2=-1)
    eps = jnp.asarray(1e-10, dtype) * (tr / m) + jnp.asarray(1e-30, dtype)
    Greg = Gm + eps[:, None, None] * jnp.eye(m, dtype=dtype)
    if m == 3:
        gamma = _solve3(Greg, cm)
    else:
        gamma = jnp.linalg.solve(Greg, cm[..., None])[..., 0]
    gamma = gamma * vm

    def comb(rl, pl):
        acc = -rl
        for j in range(m):
            g = gamma[:, j].reshape((B,) + (1,) * (rl.ndim - 1))
            acc = acc - g * pl[:, j]
        return acc

    return tmap(comb, r, MP)


def write_slot(rows: Tuple, col, slot):
    """Functionally replace ring slot ``slot`` (traced scalar) with ``col``.

    ``rows`` is a tuple of arbitrary (matching) pytrees; ``col`` a pytree of
    the same structure as each row."""
    m = len(rows)
    branches = [
        (lambda i: lambda ops: ops[1][:i] + (ops[0],) + ops[1][i + 1 :])(i)
        for i in range(m)
    ]
    return jax.lax.switch(slot, branches, (col, rows))


def direction_tree(MR: Tuple, MP: Tuple, r_tree, vdot_fn):
    """d = -r - sum_i gamma_i MP_i with gamma from regularized normal
    equations over the MR rows.

    MR/MP: tuples of pytree rows; r_tree: residual pytree;
    vdot_fn(a, b) -> [B] per-lane inner product over a row pytree.
    Returns the direction as a pytree of the row structure.
    """
    m = len(MR)
    G = jnp.stack(
        [
            jnp.stack([vdot_fn(MR[i], MR[j]) for j in range(m)], axis=-1)
            for i in range(m)
        ],
        axis=-2,
    )  # [B, m, m]
    c = jnp.stack([vdot_fn(MR[i], r_tree) for i in range(m)], axis=-1)
    dtype = G.dtype
    tr = jnp.trace(G, axis1=-2, axis2=-1)
    eps = jnp.asarray(1e-10, dtype) * (tr[:, None, None] / m) + jnp.asarray(
        1e-30, dtype
    )
    gamma = jnp.linalg.solve(G + eps * jnp.eye(m, dtype=dtype), c[..., None])[
        ..., 0
    ]  # [B, m]

    def combine(*leaves):
        # leaves: (r_leaf, MP_0_leaf, ..., MP_{m-1}_leaf)
        r_leaf = leaves[0]
        out = -r_leaf
        for i in range(m):
            g = gamma[:, i].reshape((-1,) + (1,) * (r_leaf.ndim - 1))
            out = out - g * leaves[1 + i]
        return out

    return tmap(combine, r_tree, *MP)
