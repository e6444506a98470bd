"""SuperMann-globalized Chambolle-Pock with quasi-Newton directions — the
"SPOCK" algorithm.

Counterpart of ``run_sp!`` (``/root/reference/src/model_algorithms/
sp.jl:358-469``).  The CP operator is wrapped as the fixed-point residual
r = (z - zbar, v - vbar); each iteration generates a quasi-Newton candidate
(z, v) + tau * d and accepts it via the K1 (educated) or K2 (GKM safeguard)
rules, falling back to a plain relaxed CP step; norms/inner products use the
CP metric M = [[I, -gamma L'], [-sigma L, I]].

Differences from the reference, on purpose:
* The reference's line search never actually shrinks tau — ``perform_
  linesearch!`` returns ``tau * beta`` but the call site discards the result
  (``sp.jl:439``), so all MAX_BACKTRACK retries evaluate the same candidate.
  We implement the real geometric backtracking tau <- beta * tau the SPOCK
  paper specifies.
* K0 "blind" updates are compiled out by default, matching the effective
  reference behavior (``should_perform_k0`` ends in ``&& false``, sp.jl:80),
  but can be enabled via :class:`SuperMannOpts`.
* rho = <r~, M (r~ - tau d)> is computed as <r~, M r~> - tau <r~, M d> with
  M d hoisted out of the backtracking loop — one L/L' pair saved per retry.

Everything is lane-masked over the batch axis: each lane independently
chooses K1/K2/fallback and its own backtracking depth.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..problem import ProblemData, ProblemMeta
from ..zv import Dual, Primal, lincomb, sub, tmap
from . import anderson, broyden
from .common import (
    SolveResult,
    bexpand,
    bwhere,
    candidate_sweep,
    check_termination,
    cp_sweep_metric,
    register,
)
from ..ops.linop import metric_apply


@dataclasses.dataclass(frozen=True)
class SuperMannOpts:
    """Tuning knobs; defaults mirror ``run_sp!``'s keyword defaults
    (``sp.jl:358-372``)."""

    c0: float = 0.99
    c1: float = 0.99
    q: float = 0.99
    sigma_k2: float = 0.1
    beta: float = 0.5
    max_backtracks: int = 8
    lam: float = 1.0  # CP fallback relaxation
    lam_sp: float = 1.0  # K2 projection relaxation
    aa_window: int = 3  # ANDERSON_BUFFER_SIZE (anderson.jl:6)
    k0: bool = False  # blind updates (disabled in the reference)
    direction: str = "anderson"  # "anderson" | "broyden" | "residual"
    broyden_mem: int = 20  # restart length MAX_K (restarted_broyden.jl:8)


# ---------------------------------------------------------------------------
# flat <-> structured conversion for the quasi-Newton history
# ---------------------------------------------------------------------------


def _ravel_pair(z: Primal, v: Dual):
    leaves = jax.tree_util.tree_leaves((z, v))
    B = leaves[0].shape[0]
    return jnp.concatenate([l.reshape(B, -1) for l in leaves], axis=-1)


def _unravel_pair(meta: ProblemMeta, flat, like_z: Primal, like_v: Dual):
    leaves, treedef = jax.tree_util.tree_flatten((like_z, like_v))
    out = []
    off = 0
    B = flat.shape[0]
    for l in leaves:
        size = int(np_prod(l.shape[1:]))
        out.append(flat[:, off : off + size].reshape(l.shape))
        off += size
    return jax.tree_util.tree_unflatten(treedef, out)


def np_prod(shape):
    p = 1
    for s in shape:
        p *= s
    return p


@register
@dataclasses.dataclass(frozen=True)
class SPCarry:
    x0: Any  # [B, nx] — per-lane initial state (rewritable by async drivers)
    z: Primal
    v: Dual
    r_prev: Any  # (Primal, Dual) previous residual (feeds the secant y)
    s_prev: Any  # (Primal, Dual) z_k - z_{k-1} (the quasi-Newton secant s)
    dirstate: Any  # direction-provider state (AA history / Broyden ring)
    r_safe: Any  # [B]
    eta: Any  # [B] (K0 threshold)
    res0: Any  # [B, 2]
    done: Any  # [B]
    niter: Any  # [B]
    xi1: Any
    xi2: Any
    it: Any  # scalar
    hist: Any  # [max_iter, B, 3] (xi1, xi2, backtracks); shape (0,..) if off
    # sweep cache: when a lane accepted the tau=1 K1 candidate, the
    # candidate's sweep/metric results ARE the next iteration's (zbar, vbar,
    # ||r||, inf-norms) for that lane — reuse instead of recomputing (1 sweep
    # + 1 metric application saved per iteration in warm steady state).
    # Validity is tracked per lane and used batch-wide (lax.cond on
    # all-valid).
    cache_valid: Any  # [B] bool
    zbar_c: Primal
    vbar_c: Dual
    rnorm_c: Any  # [B]
    nMrz_c: Any  # [B] inf-norm of M r's primal half (cached with the sweep)
    nMrv_c: Any  # [B]


@register
@dataclasses.dataclass(frozen=True)
class _BTCarry:
    tau: Any  # [B]
    looping: Any  # [B]
    z_acc: Primal
    v_acc: Dual
    r_safe: Any  # [B]
    xi1: Any  # [B] termination residual at the accepted update
    xi2: Any  # [B]
    bt: Any  # scalar


def _make_candidate(
    data, meta, x0, z, v, dz, dv, rnorm, q_pow, opts, gamma, sigma
):
    """Build the one-backtracking-trial closure at per-lane step size tau.

    Returns the updated acceptance state plus the candidate's sweep results
    (the peeled tau=1 trial reuses them as the next iteration's cache)."""
    # d is trial-independent: hoist the M d = metric_apply(dz, dv) L/L' pair
    # out of the backtracking trials.
    Md = metric_apply(data, meta, dz, dv, gamma, sigma)

    def candidate(tau, looping, b_z_acc, b_v_acc, b_r_safe, b_xi1, b_xi2):
        (
            wbar, ubar, Mrw, Mru, rt_sq, nMrwz, nMrwv, rho_dot,
            nMdz, nMdv,
        ) = candidate_sweep(
            data, meta, z, v, dz, dv, tau, gamma, sigma, x0, Md=Md
        )
        w = tmap(lambda zl, dl: zl + bexpand(tau, zl) * dl, z, dz)
        u = tmap(lambda vl, dl: vl + bexpand(tau, vl) * dl, v, dv)
        rw = sub(w, wbar)
        ru = sub(u, ubar)
        rt_sq = jnp.maximum(rt_sq, 0.0)
        rtilde = jnp.sqrt(rt_sq)
        rho = rt_sq - tau * rho_dot

        k1 = (rnorm <= b_r_safe) & (rtilde <= opts.c1 * rnorm) & looping
        k2 = (rho >= opts.sigma_k2 * rnorm * rtilde) & looping & (~k1)
        # K2 safeguarded projection step (sp.jl:204-222)
        coef = jnp.where(
            rt_sq > 0, rho / jnp.where(rt_sq > 0, rt_sq, 1.0), 0.0
        )
        coef = opts.lam_sp * coef
        z_k2 = tmap(lambda zl, rl: zl - bexpand(coef, zl) * rl, z, rw)
        v_k2 = tmap(lambda vl, rl: vl - bexpand(coef, vl) * rl, v, ru)

        z_acc = bwhere(k1, w, bwhere(k2, z_k2, b_z_acc))
        v_acc = bwhere(k1, u, bwhere(k2, v_k2, b_v_acc))
        r_safe = jnp.where(k1, rtilde + q_pow, b_r_safe)
        # Operator-free termination residuals at acceptance:
        #   K1: dz_iter = tau*d  => xi1 = tau*||M dz||_inf/gamma
        #   K2: dz_iter = -coef*rw => xi1 = coef*||M rw||_inf/gamma
        # (both follow from M's definition; saves the L/L' pair the
        # reference spends in should_terminate!, sp.jl:286-292)
        xi1 = jnp.where(
            k1,
            tau * nMdz / gamma,
            jnp.where(k2, coef * nMrwz / gamma, b_xi1),
        )
        xi2 = jnp.where(
            k1,
            tau * nMdv / sigma,
            jnp.where(k2, coef * nMrwv / sigma, b_xi2),
        )
        looping_out = looping & (~k1) & (~k2)
        return (
            (z_acc, v_acc, r_safe, xi1, xi2, looping_out, k1),
            (wbar, ubar, rtilde, nMrwz, nMrwv),
        )

    return candidate


def _run_backtracks(
    candidate, opts, looping1, z_a, v_a, r_safe_a, xi1_a, xi2_a, dtype
):
    """Geometric backtracking for lanes still looping after the tau=1 trial."""
    B = looping1.shape[0]

    def bt_cond(b: _BTCarry):
        return jnp.any(b.looping) & (b.bt <= opts.max_backtracks)

    def bt_body(b: _BTCarry):
        (z_acc, v_acc, r_safe, xi1, xi2, looping, _), _unused = candidate(
            b.tau, b.looping, b.z_acc, b.v_acc, b.r_safe, b.xi1, b.xi2
        )
        tau = jnp.where(looping, b.tau * opts.beta, b.tau)
        return _BTCarry(
            tau=tau,
            looping=looping,
            z_acc=z_acc,
            v_acc=v_acc,
            r_safe=r_safe,
            xi1=xi1,
            xi2=xi2,
            bt=b.bt + 1,
        )

    bt0 = _BTCarry(
        tau=jnp.full((B,), opts.beta, dtype),
        looping=looping1,
        z_acc=z_a,
        v_acc=v_a,
        r_safe=r_safe_a,
        xi1=xi1_a,
        xi2=xi2_a,
        bt=jnp.ones((), jnp.int32),
    )
    return jax.lax.while_loop(bt_cond, bt_body, bt0)


def sp_init(
    meta: ProblemMeta,
    x0,
    z0: Primal,
    v0: Dual,
    opts: SuperMannOpts = SuperMannOpts(),
    max_iter: int = 1000,
    record: bool = False,
) -> SPCarry:
    """Build the initial SuperMann carry for a batch of lanes."""
    B = x0.shape[0]
    dtype = x0.dtype
    if opts.direction == "anderson":
        # structured newest-first histories: one (Primal, Dual)-shaped pytree
        # per window row, leaves [B, m, *event].  No flat concat across the
        # node axis, so the histories shard like the iterates.
        def hzeros(l):
            return jnp.zeros((B, opts.aa_window) + l.shape[1:], dtype)

        dirstate0 = (tmap(hzeros, (z0, v0)), tmap(hzeros, (z0, v0)))
    elif opts.direction == "broyden":
        K = _ravel_pair(z0, v0).shape[-1]
        dirstate0 = broyden.init(B, K, opts.broyden_mem, dtype)
    elif opts.direction == "residual":
        dirstate0 = ()
    else:
        raise ValueError(f"unknown direction {opts.direction!r}")

    zpair = (tmap(jnp.zeros_like, z0), tmap(jnp.zeros_like, v0))
    return SPCarry(
        x0=x0,
        z=z0,
        v=v0,
        r_prev=zpair,
        s_prev=zpair,
        dirstate=dirstate0,
        r_safe=jnp.full((B,), jnp.inf, dtype),
        eta=jnp.full((B,), jnp.inf, dtype),
        res0=jnp.full((B, 2), -jnp.inf, dtype),
        done=jnp.zeros((B,), bool),
        niter=jnp.zeros((B,), jnp.int32),
        xi1=jnp.full((B,), jnp.inf, dtype),
        xi2=jnp.full((B,), jnp.inf, dtype),
        it=jnp.zeros((), jnp.int32),
        hist=jnp.zeros((max_iter if record else 0, B, 3), dtype),
        cache_valid=jnp.zeros((B,), bool),
        zbar_c=tmap(jnp.zeros_like, z0),
        vbar_c=tmap(jnp.zeros_like, v0),
        rnorm_c=jnp.zeros((B,), dtype),
        nMrz_c=jnp.zeros((B,), dtype),
        nMrv_c=jnp.zeros((B,), dtype),
    )


def sp_body(
    data: ProblemData,
    meta: ProblemMeta,
    tol,
    opts: SuperMannOpts = SuperMannOpts(),
    gamma=None,
    sigma=None,
    record: bool = False,
    constrain=None,
):
    """Returns the one-iteration transition function carry -> carry.

    Exposed separately from :func:`run_supermann` so outer drivers (the
    asynchronous MPC farm, custom schedulers) can embed the iteration in
    their own loops.
    """
    if gamma is None or sigma is None:
        step = 0.99 / jnp.sqrt(data.L_sq)
        gamma = sigma = step

    def body(c: SPCarry):
        if constrain is not None:
            # re-pin iterate shardings each iteration (node-sharded big trees)
            c = dataclasses.replace(c, z=constrain(c.z), v=constrain(c.v))
        B = c.done.shape[0]
        dtype = c.r_safe.dtype
        x0 = c.x0
        # ---- CP sweep + fixed-point residual (sp.jl:392-395) ----
        def fresh_sweep(_):
            zbar, vbar, _Mrz, _Mrv, rnsq, nMrz, nMrv = cp_sweep_metric(
                data, meta, c.z, c.v, gamma, sigma, x0
            )
            rnorm = jnp.sqrt(jnp.maximum(rnsq, 0.0))
            return zbar, vbar, rnorm, nMrz, nMrv

        def cached_sweep(_):
            return (c.zbar_c, c.vbar_c, c.rnorm_c, c.nMrz_c, c.nMrv_c)

        # batch-wide cache use: recomputing is always CORRECT, so one
        # any-lane-invalid triggers a fresh sweep for everyone.
        zbar, vbar, rnorm, nMrz, nMrv = jax.lax.cond(
            jnp.all(c.cache_valid), cached_sweep, fresh_sweep, None
        )
        rz = sub(c.z, zbar)
        rv = sub(c.v, vbar)
        r_pair = (rz, rv)

        # ---- quasi-Newton direction (sp.jl:397-401) ----
        # A lane on its first iteration of a solve (niter == 0: fresh start
        # or farm refill) has no valid previous residual/step: mask them to
        # zero on the READ side.  This fuses into the elementwise ops (no
        # extra pass) and replaces the farm's O(B K) per-refill resets.
        has_prev = c.niter > 0
        if opts.direction == "anderson":
            # Newest-first rotation of structured (Primal, Dual) histories
            # (anderson.hist_insert): row j was inserted j iterations ago, so
            # validity is simply j <= niter — rows older than the lane's
            # current solve (possible only after a farm refill) are excluded
            # algebraically and the refilled lane's trajectory is BITWISE
            # equal to a standalone warm-started solve (the row layout no
            # longer depends on a global ring phase).
            y = bwhere(
                has_prev,
                (sub(rz, c.r_prev[0]), sub(rv, c.r_prev[1])),
                r_pair,
            )
            p = bwhere(
                has_prev,
                tmap(jnp.subtract, c.s_prev, y),
                tmap(jnp.negative, y),
            )
            MR = anderson.hist_insert(c.dirstate[0], y)
            MP = anderson.hist_insert(c.dirstate[1], p)
            dz, dv = anderson.direction_struct(MR, MP, r_pair, c.niter)
            dirstate = (MR, MP)
        elif opts.direction == "broyden":
            hp = has_prev[:, None]
            r_flat = _ravel_pair(rz, rv)
            y_flat = r_flat - jnp.where(
                hp, _ravel_pair(*c.r_prev), 0.0
            )
            s_flat = jnp.where(hp, _ravel_pair(*c.s_prev), 0.0)
            sz, sv = _unravel_pair(meta, s_flat, c.z, c.v)
            Msz, Msv = metric_apply(data, meta, sz, sv, gamma, sigma)
            ps_flat = _ravel_pair(Msz, Msv)
            d_flat, dirstate = broyden.direction(
                c.dirstate, r_flat, s_flat, y_flat, ps_flat, opts.broyden_mem
            )
            dz, dv = _unravel_pair(meta, d_flat, c.z, c.v)
        else:  # plain residual direction (KM step candidates)
            dz, dv = tmap(jnp.negative, rz), tmap(jnp.negative, rv)
            dirstate = ()

        # ---- CP fallback (sp.jl:443-446) ----
        if opts.lam == 1.0:
            z_fb, v_fb = zbar, vbar
        else:
            z_fb = lincomb(opts.lam, zbar, 1.0 - opts.lam, c.z)
            v_fb = lincomb(opts.lam, vbar, 1.0 - opts.lam, c.v)
        # operator-free termination residuals for the fallback step:
        # dz_iter = -lam*rz  =>  xi1 = lam*||M rz||_inf/gamma, etc.
        xi1_fb = opts.lam * nMrz / gamma
        xi2_fb = opts.lam * nMrv / sigma

        # ---- K0 blind update (sp.jl:73-107; disabled by default) ----
        if opts.k0:
            k0_mask = rnorm <= opts.c0 * c.eta
            eta_new = jnp.where(k0_mask, rnorm, c.eta)
            z_init = bwhere(k0_mask, tmap(jnp.add, c.z, dz), z_fb)
            v_init = bwhere(k0_mask, tmap(jnp.add, c.v, dv), v_fb)
            # termination residuals for K0 lanes use the FIXED-POINT residual
            # scale (as a KM step would), not the blind step ||M d||: a
            # degenerate quasi-Newton direction (d ~ 0 with r large) must not
            # read as convergence — K0 has no K1/K2-style progress guard.
            xi1_init = jnp.where(k0_mask, nMrz / gamma, xi1_fb)
            xi2_init = jnp.where(k0_mask, nMrv / sigma, xi2_fb)
            loop_init = ~k0_mask
        else:
            eta_new = c.eta
            z_init, v_init = z_fb, v_fb
            xi1_init, xi2_init = xi1_fb, xi2_fb
            loop_init = jnp.ones((B,), bool)

        # r_safe decay q^k uses the PER-LANE iteration counter: in the async
        # farm lanes are at different phases of their own solves (for a
        # standalone batch solve niter == it on every active lane, so this is
        # identical to the reference's q^iter, sp.jl:186).
        q_pow = jnp.asarray(opts.q, dtype) ** c.niter.astype(dtype)

        candidate = _make_candidate(
            data, meta, x0, c.z, c.v, dz, dv, rnorm, q_pow, opts, gamma,
            sigma,
        )

        # ---- peeled first trial at tau = 1 (the common accept path) ----
        looping0 = loop_init & (~c.done)
        (z_a, v_a, r_safe_a, xi1_a, xi2_a, looping1, k1_first), cache = (
            candidate(
                jnp.ones((B,), dtype),
                looping0,
                z_init,
                v_init,
                c.r_safe,
                xi1_init,
                xi2_init,
            )
        )

        bt = _run_backtracks(
            candidate, opts, looping1, z_a, v_a, r_safe_a, xi1_a, xi2_a,
            dtype,
        )
        z_new, v_new = bt.z_acc, bt.v_acc

        # ---- termination (sp.jl:270-344), from the accumulated norms ----
        xi1, xi2 = bt.xi1, bt.xi2
        conv, res0 = check_termination(xi1, xi2, c.res0, tol)
        s_new = (sub(z_new, c.z), sub(v_new, c.v))
        # per-lane cache validity: the lane either accepted this exact tau=1
        # candidate (so sweep(z_new) == cached candidate values) or is/became
        # done (frozen iterate — its sweep results are never consumed)
        cache_valid = k1_first | c.done | conv

        active = ~c.done
        hist = c.hist
        if record:
            bts = jnp.broadcast_to(
                (bt.bt - 1).astype(dtype), xi1.shape
            )
            hist = hist.at[c.it].set(jnp.stack([xi1, xi2, bts], axis=-1))
        return SPCarry(
            x0=c.x0,
            z=bwhere(active, z_new, c.z),
            v=bwhere(active, v_new, c.v),
            r_prev=bwhere(active, r_pair, c.r_prev),
            s_prev=bwhere(active, s_new, c.s_prev),
            # NOTE: dirstate deliberately NOT lane-masked — finished lanes'
            # iterates are frozen elsewhere, their direction is never applied,
            # and masking would cost a full pass over the history rows.
            dirstate=dirstate,
            r_safe=jnp.where(active, bt.r_safe, c.r_safe),
            eta=jnp.where(active, eta_new, c.eta),
            res0=jnp.where(active[:, None], res0, c.res0),
            done=c.done | conv,
            niter=c.niter + active.astype(jnp.int32),
            xi1=jnp.where(active, xi1, c.xi1),
            xi2=jnp.where(active, xi2, c.xi2),
            it=c.it + 1,
            hist=hist,
            cache_valid=cache_valid,
            zbar_c=cache[0],
            vbar_c=cache[1],
            rnorm_c=cache[2],
            nMrz_c=cache[3],
            nMrv_c=cache[4],
        )

    return body


def run_supermann(
    data: ProblemData,
    meta: ProblemMeta,
    x0,
    z0: Primal,
    v0: Dual,
    tol,
    max_iter,
    opts: SuperMannOpts = SuperMannOpts(),
    gamma=None,
    sigma=None,
    record: bool = False,
    constrain=None,
) -> SolveResult:
    init = sp_init(meta, x0, z0, v0, opts, max_iter=max_iter, record=record)
    body = sp_body(
        data, meta, tol, opts, gamma=gamma, sigma=sigma, record=record,
        constrain=constrain,
    )

    def cond(c: SPCarry):
        return (~jnp.all(c.done)) & (c.it < max_iter)

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
