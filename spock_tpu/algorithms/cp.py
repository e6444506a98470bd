"""Plain Chambolle-Pock iteration ("CPOCK").

Counterpart of ``run_cp!`` (``/root/reference/src/model_algorithms/
cp.jl:188-232``): one jitted, lane-masked ``lax.while_loop`` over batched
iterates.  Default step sizes sigma = gamma = 0.99 / ||L|| use the
power-iteration estimate from the build step instead of the reference's
hardcoded constant (``models/cpock.jl:63``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..problem import ProblemData, ProblemMeta
from ..zv import Dual, Primal, sub
from .common import (
    SolveResult,
    bwhere,
    check_termination,
    cp_sweep,
    register,
    residual_norms,
)


@register
@dataclasses.dataclass(frozen=True)
class CPCarry:
    z: Primal
    v: Dual
    res0: Any  # [B, 2]
    done: Any  # [B] bool
    niter: Any  # [B] int32
    xi1: Any  # [B]
    xi2: Any  # [B]
    it: Any  # scalar int32
    hist: Any  # [max_iter, B, 2] residual trace (shape (0,...) when disabled)


def run_cp(
    data: ProblemData,
    meta: ProblemMeta,
    x0,
    z0: Primal,
    v0: Dual,
    tol,
    max_iter,
    gamma=None,
    sigma=None,
    lam: float = 1.0,
    record: bool = False,
    constrain=None,
) -> SolveResult:
    """Solve to tolerance from a warm start (z0, v0); everything batched [B, ...].

    x0: [B, nx].  Returns a :class:`SolveResult`.

    record=True keeps a per-iteration (xi1, xi2) trace in ``result.residuals``
    — the batched equivalent of the reference's LOG verbose mode (``cp.jl:82-97``,
    which appends residuals to .dat files).

    constrain: optional ``tree -> tree`` sharding hook (e.g.
    ``parallel.mesh.node_constrainer``) applied to (z, v) every iteration so
    node-sharded big-tree solves keep their layout through the loop.
    """
    if gamma is None or sigma is None:
        step = 0.99 / jnp.sqrt(data.L_sq)
        gamma = sigma = step
    B = x0.shape[0]

    init = CPCarry(
        z=z0,
        v=v0,
        res0=jnp.full((B, 2), -jnp.inf, x0.dtype),
        done=jnp.zeros((B,), bool),
        niter=jnp.zeros((B,), jnp.int32),
        xi1=jnp.full((B,), jnp.inf, x0.dtype),
        xi2=jnp.full((B,), jnp.inf, x0.dtype),
        it=jnp.zeros((), jnp.int32),
        hist=jnp.zeros((max_iter if record else 0, B, 2), x0.dtype),
    )

    def cond(c: CPCarry):
        return (~jnp.all(c.done)) & (c.it < max_iter)

    def body(c: CPCarry):
        zc, vc = c.z, c.v
        if constrain is not None:
            zc, vc = constrain(zc), constrain(vc)
        zbar, vbar = cp_sweep(data, meta, zc, vc, gamma, sigma, x0)
        if lam == 1.0:
            z_new, v_new = zbar, vbar
        else:
            from ..zv import lincomb

            z_new = lincomb(lam, zbar, 1.0 - lam, c.z)
            v_new = lincomb(lam, vbar, 1.0 - lam, c.v)

        xi1, xi2 = residual_norms(
            data, meta, sub(z_new, c.z), sub(v_new, c.v), gamma, sigma
        )
        conv, res0 = check_termination(xi1, xi2, c.res0, tol)
        active = ~c.done
        hist = c.hist
        if record:
            hist = hist.at[c.it].set(jnp.stack([xi1, xi2], axis=-1))
        return CPCarry(
            z=bwhere(active, z_new, c.z),
            v=bwhere(active, v_new, c.v),
            res0=jnp.where(active[:, None], res0, c.res0),
            done=c.done | conv,
            niter=c.niter + active.astype(jnp.int32),
            xi1=jnp.where(active, xi1, c.xi1),
            xi2=jnp.where(active, xi2, c.xi2),
            it=c.it + 1,
            hist=hist,
        )

    out = jax.lax.while_loop(cond, body, init)
    return SolveResult(
        z=out.z,
        v=out.v,
        iterations=out.niter,
        status=jnp.where(out.done, 0, 1).astype(jnp.int32),
        xi1=out.xi1,
        xi2=out.xi2,
        residuals=out.hist if record else None,
    )
