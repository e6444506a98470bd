"""Structured primal/dual iterate pytrees.

The reference packs everything into two flat vectors ``z`` (primal) and ``v``
(dual) with hand-maintained offset tables (``implicit_l.jl:5-44,106-158``).
We keep the iterates *structured* — a pytree of stage-major node
arrays — so that every operator block is a dense tensor op and XLA fuses the
elementwise glue.  Flattening to the reference's vector layout is provided
only for tests / oracle comparison (:mod:`spock_tpu.utils.refvec`).

All arrays carry an arbitrary leading batch shape ``[...]``; the event
(per-solve) dims are documented per field.  ``n``, ``n_nonleaf``, ``n_leaf``
below refer to :class:`spock_tpu.tree.UniformTree`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclasses.dataclass(frozen=True)
class Primal:
    """Primal iterate z = (x, u, s, tau, y).

    Shapes (event part) — FEATURE-MAJOR: the node axis is always LAST so the
    (large) node dimension is the contiguous minor dimension and the small
    feature dims (nx ~ 2..50) are strided over it.

      x:   [nx, n]          — state at every node.
      u:   [nu, n_nonleaf]  — input at every non-leaf node.
      s:   [n]              — epigraph variable per node (s[0] is the objective).
      tau: [n - 1]          — stage-cost epigraph per non-root node; tau[j-1]
                              belongs to node j.
      y:   [ny, n_nonleaf]  — risk dual per non-leaf node.

    Mirrors the reference's z layout ``[x; u; s; tau; y]``
    (``implicit_l.jl:106-158``).
    """

    x: Any
    u: Any
    s: Any
    tau: Any
    y: Any


@_register
@dataclasses.dataclass(frozen=True)
class Dual:
    """Dual iterate v, one field per block of the implicit operator L.

    Shapes (event part, feature-major — node axis last) and the forward map
    v = L z (cf. ``implicit_l.jl:177-318``):
      y:    [ny, n_nonleaf] — copy of z.y                        (ref. v1)
      sby:  [n_nonleaf]     — s_i - b_i' y_i                     (ref. v2)
      qx:   [nx, n - 1]     — sqrtQ_j @ x_{parent(j)}            (ref. v3)
      ru:   [nu, n - 1]     — sqrtR_j @ u_{parent(j)}            (ref. v4)
      t5:   [n - 1]         — tau_j / 2                          (ref. v5)
      t6:   [n - 1]         — tau_j / 2                          (ref. v6)
      cx:   [nx, n_nonleaf] — x_i (non-leaf box-constraint copy) (ref. v7, x part)
      cu:   [nu, n_nonleaf] — u_i (non-leaf box-constraint copy) (ref. v7, u part)
      qNx:  [nx, n_leaf]    — sqrtQN_i @ x_i (leaves)            (ref. v11)
      s12:  [n_leaf]        — s_i / 2 (leaves)                   (ref. v12)
      s13:  [n_leaf]        — s_i / 2 (leaves)                   (ref. v13)
      cxN:  [nx, n_leaf]    — x_i (leaf box-constraint copy)     (ref. v14)

    The reference interleaves v7 as ((x_i, u_i))_i in one flat block
    (``constraints.jl:111-128``); keeping (cx, cu) separate is equivalent up
    to a permutation and avoids the interleave shuffle entirely.
    """

    y: Any
    sby: Any
    qx: Any
    ru: Any
    t5: Any
    t6: Any
    cx: Any
    cu: Any
    qNx: Any
    s12: Any
    s13: Any
    cxN: Any
    # Optional polytopic constraint blocks (no reference counterpart — the
    # reference only supports boxes).  None when the problem has no polytope.
    #   pnl: [nc, n_nonleaf]  = Gx x_i + Gu u_i, constrained to [lo, hi]
    #   plf: [ncN, n_leaf]    = GxN x_i, constrained to [loN, hiN]
    pnl: Any = None
    plf: Any = None


# ---------------------------------------------------------------------------
# Generic pytree arithmetic helpers (used by the algorithms).
# ---------------------------------------------------------------------------

def tmap(f, *trees):
    return jax.tree_util.tree_map(f, *trees)


def axpy(a, x, y):
    """a * x + y, leafwise (a is a scalar or per-lane array broadcast below)."""
    return tmap(lambda xl, yl: a * xl + yl, x, y)


def lincomb(a, x, b, y):
    return tmap(lambda xl, yl: a * xl + b * yl, x, y)


def sub(x, y):
    return tmap(jnp.subtract, x, y)


def add(x, y):
    return tmap(jnp.add, x, y)


def scale(a, x):
    return tmap(lambda l: a * l, x)


def zeros_like(x):
    return tmap(jnp.zeros_like, x)


def vdot(x, y, batch_ndim: int = 0):
    """Inner product over event dims; returns array of the batch shape."""

    def leaf_dot(a, b):
        axes = tuple(range(batch_ndim, a.ndim))
        return jnp.sum(a * b, axis=axes)

    leaves = jax.tree_util.tree_leaves(tmap(leaf_dot, x, y))
    return sum(leaves[1:], leaves[0])


def inf_norm(x, batch_ndim: int = 0):
    def leaf_max(a):
        axes = tuple(range(batch_ndim, a.ndim))
        return jnp.max(jnp.abs(a), axis=axes)

    leaves = jax.tree_util.tree_leaves(tmap(leaf_max, x))
    out = leaves[0]
    for l in leaves[1:]:
        out = jnp.maximum(out, l)
    return out


def where_mask(mask, new, old):
    """Select ``new`` where ``mask`` (batch-shaped bool) else ``old``, leafwise."""

    def sel(a, b):
        m = mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim))
        return jnp.where(m, a, b)

    return tmap(sel, new, old)


def ravel(x, batch_ndim: int = 0):
    """Concatenate all leaves into one [..., K] vector (batch dims preserved).

    Leaf order is the dataclass field order — deterministic, but NOT the
    reference's flat layout (see utils.refvec for that).
    """
    leaves = jax.tree_util.tree_leaves(x)

    def flat(a):
        return a.reshape(a.shape[:batch_ndim] + (-1,))

    return jnp.concatenate([flat(l) for l in leaves], axis=-1)
