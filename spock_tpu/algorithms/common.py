"""Shared pieces of the iterative algorithms (CP and SuperMann).

Batch convention: all iterates carry exactly one leading lane axis [B, ...];
per-lane scalars (norms, flags, counters) have shape [B].  Lane-masked
updates give exact per-lane termination semantics — a converged lane's
iterate is frozen, unlike plain vmap-of-while which would keep updating it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..ops.linop import apply_L, apply_LT, metric_apply
from ..ops.prox import prox_f, prox_h_conj
from ..zv import Dual, Primal, inf_norm, lincomb, sub, tmap, vdot


def register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


def bexpand(a, ref):
    """Broadcast a [B]-shaped per-lane scalar against a [B, ...] leaf."""
    return a.reshape(a.shape + (1,) * (ref.ndim - a.ndim))


def bwhere(mask, new, old):
    """Lane-masked select over a pytree."""
    return tmap(
        lambda n, o: jnp.where(bexpand(mask, n), n, o), new, old
    )


def blincomb(a, x, b, y):
    """Per-lane linear combination a*x + b*y (a, b: [B])."""
    return tmap(
        lambda xl, yl: bexpand(a, xl) * xl + bexpand(b, yl) * yl, x, y
    )


def cp_sweep(data, meta, z: Primal, v: Dual, gamma, sigma, x0):
    """One Chambolle-Pock sweep: returns (zbar, vbar).

    zbar = prox_f(z - gamma L' v); vbar = prox_h*(v + sigma L (2 zbar - z)).
    (cf. update_zbar!/update_vbar!, ``src/model_algorithms/cp.jl:5-32``)
    """
    z1 = tmap(lambda a, b: a - gamma * b, z, apply_LT(data, meta, v))
    zbar = prox_f(data, meta, z1, gamma, x0)
    z_refl = lincomb(2.0, zbar, -1.0, z)
    v1 = tmap(lambda a, b: a + sigma * b, v, apply_L(data, meta, z_refl))
    return zbar, prox_h_conj(data, meta, v1, sigma)


def cp_sweep_metric(data, meta, z: Primal, v: Dual, gamma, sigma, x0):
    """One CP sweep plus the metric image of its fixed-point residual plus
    the per-lane reductions SuperMann consumes: returns ``(zbar, vbar, Mrz,
    Mrv, rnorm_sq, nMrz, nMrv)`` with ``(Mrz, Mrv) = M (z - zbar, v -
    vbar)``, ``rnorm_sq = <r, M r>`` and nMrz/nMrv the inf-norms of M r's
    halves."""
    zbar, vbar = cp_sweep(data, meta, z, v, gamma, sigma, x0)
    rz, rv = sub(z, zbar), sub(v, vbar)
    Mrz, Mrv = metric_apply(data, meta, rz, rv, gamma, sigma)
    rnorm_sq = vdot(rz, Mrz, 1) + vdot(rv, Mrv, 1)
    return (
        zbar, vbar, Mrz, Mrv, rnorm_sq,
        inf_norm(Mrz, batch_ndim=1), inf_norm(Mrv, batch_ndim=1),
    )


def candidate_sweep(
    data, meta, z: Primal, v: Dual, dz: Primal, dv: Dual, tau, gamma, sigma,
    x0, Md=None,
):
    """SuperMann candidate evaluation at (w, u) = (z, v) + tau (dz, dv):
    the CP sweep at the candidate, the metric image of the candidate
    residual, and the scalars the K1/K2 tests consume.

    Returns ``(wbar, ubar, Mrz, Mrv, rnorm_sq, nMrz, nMrv, rho_dot, nMdz,
    nMdv)`` — the first seven as :func:`cp_sweep_metric` at the candidate
    point, plus ``rho_dot = <r~, M d>`` (sp.jl:193-222's rho correction) and
    the inf-norms of M d's halves.  ``Md`` may carry a precomputed ``(Mdz,
    Mdv)``: d is trial-independent, so the caller hoists this L/L' pair out
    of the backtracking loop."""
    tau = jnp.asarray(tau)
    w = tmap(lambda a, b: a + bexpand(tau, a) * b, z, dz)
    u = tmap(lambda a, b: a + bexpand(tau, a) * b, v, dv)
    wbar, ubar, Mrz, Mrv, rnorm_sq, nMrz, nMrv = cp_sweep_metric(
        data, meta, w, u, gamma, sigma, x0
    )
    Mdz, Mdv = Md if Md is not None else metric_apply(
        data, meta, dz, dv, gamma, sigma
    )
    rho_dot = vdot(sub(w, wbar), Mdz, 1) + vdot(sub(u, ubar), Mdv, 1)
    return (
        wbar, ubar, Mrz, Mrv, rnorm_sq, nMrz, nMrv, rho_dot,
        inf_norm(Mdz, batch_ndim=1), inf_norm(Mdv, batch_ndim=1),
    )


def residual_norms(data, meta, dz: Primal, dv: Dual, gamma, sigma):
    """Termination residuals (cf. should_terminate!, ``cp.jl:54-123``):

      xi1 = || L' dv - dz / gamma ||_inf,  xi2 = || L dz - dv / sigma ||_inf,

    per lane.  One L' + one L application.
    """
    xi1 = tmap(lambda a, b: a - b / gamma, apply_LT(data, meta, dv), dz)
    xi2 = tmap(lambda a, b: a - b / sigma, apply_L(data, meta, dz), dv)
    return inf_norm(xi1, batch_ndim=1), inf_norm(xi2, batch_ndim=1)


def check_termination(xi1, xi2, res0, tol):
    """Relative-to-first-residual criterion (``cp.jl:102-119``).  Returns
    (converged [B], updated res0 [B, 2]).  On the first iteration res0 is
    -inf so the check degrades to the absolute tolerance, matching the
    reference's max(tol * res0, tol) with res0 = -inf."""
    conv = (xi1 <= jnp.maximum(tol * res0[:, 0], tol)) & (
        xi2 <= jnp.maximum(tol * res0[:, 1], tol)
    )
    xi = jnp.stack([xi1, xi2], axis=-1)
    res0_new = jnp.where(jnp.isneginf(res0), xi, res0)
    return conv, res0_new


@register
@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Outcome of a batched solve.

    Unlike the reference (which returns nothing and only prints the iteration
    count — SURVEY.md §5 'failure detection: none'), we report an explicit
    per-lane status: 0 = converged, 1 = hit max_iter.
    """

    z: Primal
    v: Dual
    iterations: Any  # [B] int32
    status: Any  # [B] int32
    xi1: Any  # [B] final residuals
    xi2: Any  # [B]
    residuals: Any = None  # [max_iter, B, k] per-iteration trace (record=True)

    @property
    def converged(self):
        return self.status == 0
