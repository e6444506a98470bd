"""Receding-horizon MPC simulation with warm starting.

Counterpart of the reference's MPC driver loop (``examples/server_heat/
mpc_simulation.jl:38-183``): at each step solve the risk-averse problem from
the current state, apply the root input, advance the plant with a sampled
realization, and warm-start the next solve from the previous primal-dual
iterate (the reference does this implicitly by keeping z/v in the model
struct; here the state is threaded explicitly through ``lax.scan``).

Everything is batched: B independent plants/solvers advance in lockstep —
the lane axis is the unit of device parallelism.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .algorithms import supermann as sp_alg
from .algorithms import cp as cp_alg
from .problem import ProblemData, ProblemMeta
from .solver import zero_dual, zero_primal


@dataclasses.dataclass(frozen=True)
class MPCResult:
    xs: Any  # [T+1, B, nx] closed-loop states
    us: Any  # [T, B, nu] applied inputs
    iterations: Any  # [T, B] solver iterations per step
    status: Any  # [T, B]
    objective: Any  # [T, B] s_root per step


jax.tree_util.register_dataclass(
    MPCResult,
    data_fields=["xs", "us", "iterations", "status", "objective"],
    meta_fields=[],
)


@partial(
    jax.jit,
    static_argnames=("meta", "algorithm", "max_iter", "opts"),
)
def simulate(
    data: ProblemData,
    meta: ProblemMeta,
    x0,
    ws,
    tol,
    algorithm: str = "spock",
    max_iter: int = 1000,
    opts: sp_alg.SuperMannOpts = sp_alg.SuperMannOpts(),
) -> MPCResult:
    """Closed-loop simulation.

    x0: [B, nx] initial states; ws: [T, B] int realization indices drawn by
    the caller (the reference samples uniform w each step,
    ``mpc_simulation.jl:170-177``); tol: solver tolerance per step.
    """
    B = x0.shape[0]
    dtype = x0.dtype
    z = zero_primal(meta, (B,), dtype)
    v = zero_dual(meta, (B,), dtype)

    def step(carry, w):
        x, z, v = carry
        if algorithm == "spock":
            res = sp_alg.run_supermann(
                data, meta, x, z, v, tol=tol, max_iter=max_iter, opts=opts
            )
        else:
            res = cp_alg.run_cp(
                data, meta, x, z, v, tol=tol, max_iter=max_iter
            )
        u0 = res.z.u[:, :, 0]  # root input (u is [B, nu, n_nonleaf])
        # plant update x+ = A[w] x + B[w] u
        Aw = data.A[w]  # [B, nx, nx]
        Bw = data.B[w]
        x_next = jnp.einsum("bxy,by->bx", Aw, x) + jnp.einsum(
            "bxu,bu->bx", Bw, u0
        )
        out = (x_next, res.iterations, res.status, res.z.s[:, 0], u0)
        return (x_next, res.z, res.v), out

    (_, _, _), (xs, iters, status, obj, us) = jax.lax.scan(
        step, (x0, z, v), ws
    )
    return MPCResult(
        xs=jnp.concatenate([x0[None], xs], axis=0),
        us=us,
        iterations=iters,
        status=status,
        objective=obj,
    )


# ---------------------------------------------------------------------------
# Asynchronous MPC farm
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AsyncMPCResult:
    steps_done: Any  # [B] MPC steps completed per lane
    iters_per_step: Any  # [T, B] solver iterations per completed step
    us: Any  # [T, B, nu] applied inputs per step
    xs: Any  # [B, nx] final states
    total_iterations: Any  # scalar — while-loop iterations executed
    z: Any  # final primal state (chain into another run for steady state)
    v: Any  # final dual state


jax.tree_util.register_dataclass(
    AsyncMPCResult,
    data_fields=[
        "steps_done", "iters_per_step", "us", "xs", "total_iterations",
        "z", "v",
    ],
    meta_fields=[],
)


@partial(jax.jit, static_argnames=("meta", "opts"))
def _simulate_async_jit(
    data: ProblemData,
    meta: ProblemMeta,
    ws,
    tol,
    n_steps,  # DYNAMIC [] int32 — one compiled program serves any step
    #           count <= ws.shape[0] (records are sized by ws)
    opts: sp_alg.SuperMannOpts,
    iter_budget,
    init,
):
    """Receding-horizon MPC where every lane advances its own chain the
    moment its solve converges — no batch-level straggler barrier.

    In the synchronous :func:`simulate`, each MPC step's wall time is set by
    the slowest of B lanes (p100 of the iteration distribution); here a lane
    that converges in 3 iterations immediately starts its next warm-started
    step while a 30-iteration lane keeps iterating.  Throughput approaches
    the mean-iteration bound instead of the max — the right execution model
    for batched MPC farms on SIMD hardware.  (No reference counterpart; the
    reference is single-instance.)

    x0: [B, nx]; ws: [T, B] realization indices; n_steps: MPC steps per lane.
    """
    body = sp_alg.sp_body(data, meta, tol, opts)
    B = init["step_idx"].shape[0]
    lane_ids = jnp.arange(B)

    def cond(st):
        return jnp.any(st["step_idx"] < n_steps) & (
            st["total"] < iter_budget
        )

    def advance(st):
        sp = body(st["sp"])
        # lanes whose current solve just converged and still have steps to do
        fin = sp.done & (st["step_idx"] < n_steps)
        u0 = sp.z.u[:, :, 0]
        # record
        iters_rec = st["iters_rec"].at[st["step_idx"], lane_ids].add(
            jnp.where(fin, sp.niter, 0)
        )
        us_rec = st["us_rec"].at[st["step_idx"], lane_ids].add(
            jnp.where(fin[:, None], u0, 0.0)
        )
        # plant update with each lane's own realization sequence
        w = jnp.take_along_axis(
            ws, jnp.minimum(st["step_idx"], ws.shape[0] - 1)[None, :], axis=0
        )[0]
        Aw, Bw = data.A[w], data.B[w]
        x_next = jnp.einsum("bxy,by->bx", Aw, sp.x0) + jnp.einsum(
            "bxu,bu->bx", Bw, u0
        )
        new_x0 = jnp.where(fin[:, None], x_next, sp.x0)
        step_idx = st["step_idx"] + fin.astype(jnp.int32)
        # reset per-solve solver flags for refilled lanes (warm z/v kept —
        # the reference's warm-start semantics; res0 reset per solve as in
        # models/spock.jl:248).  A lane stays done only when it has no steps
        # left; a lane that just converged with steps remaining restarts.
        # The quasi-Newton memory (r_prev/s_prev and the AA history) needs
        # NO data reset: niter=0 makes sp_body mask the stale
        # r_prev/s_prev reads, and the newest-first AA history's validity
        # rule (row j usable iff j <= niter) excludes rows older than the
        # current solve algebraically — zero Gram/gamma contributions,
        # exactly what physically zeroed rows would give.  Because the row
        # layout is rotation-based (no global ring phase), the refilled lane
        # is BITWISE identical to a standalone warm-started solve, without
        # the O(B m K) zeroing passes an explicit reset would cost.  Broyden
        # keeps its internal ring state, which must still be zeroed per lane.
        repl = dict(
            x0=new_x0,
            done=sp.done & ~(fin & (step_idx < n_steps)),
            res0=jnp.where(fin[:, None], -jnp.inf, sp.res0),
            r_safe=jnp.where(fin, jnp.inf, sp.r_safe),
            niter=jnp.where(fin, 0, sp.niter),
            # a lane that advanced has a new x0 — its cached sweep (which
            # pins x_root = x0 inside prox_f) no longer matches
            cache_valid=sp.cache_valid & ~fin,
            eta=jnp.where(fin, jnp.inf, sp.eta),
        )
        if opts.direction == "broyden":
            def lane_reset(a):
                m = fin.reshape(fin.shape + (1,) * (a.ndim - 1))
                return jnp.where(m, jnp.zeros_like(a), a)

            repl["dirstate"] = jax.tree_util.tree_map(lane_reset, sp.dirstate)
        sp = dataclasses.replace(sp, **repl)
        return dict(
            sp=sp,
            step_idx=step_idx,
            iters_rec=iters_rec,
            us_rec=us_rec,
            total=st["total"] + 1,
        )

    out = jax.lax.while_loop(cond, advance, init)
    res = AsyncMPCResult(
        steps_done=out["step_idx"],
        iters_per_step=out["iters_rec"],
        us=out["us_rec"],
        xs=out["sp"].x0,
        total_iterations=out["total"],
        z=out["sp"].z,
        v=out["sp"].v,
    )
    return res, out


def simulate_async(
    data: ProblemData,
    meta: ProblemMeta,
    x0,
    ws,
    tol,
    n_steps: int,
    opts: sp_alg.SuperMannOpts = sp_alg.SuperMannOpts(),
    max_total_iters: int = 1_000_000,
    z0=None,
    v0=None,
    iters_per_launch: int = 0,
    resume=None,
) -> AsyncMPCResult:
    """Host wrapper around the jitted farm.

    iters_per_launch > 0 chunks the device while_loop into bounded launches
    (the carry round-trips through jit boundaries, not the host; the host
    checks for completion between launches); 0 = one launch.
    resume: opaque state from a previous call (continues the same farm).
    """
    B = x0.shape[0]
    dtype = x0.dtype
    ws = jnp.asarray(ws)
    assert n_steps <= ws.shape[0], (n_steps, ws.shape)
    n_steps_a = jnp.asarray(n_steps, jnp.int32)
    if resume is None:
        if z0 is None:
            z0 = zero_primal(meta, (B,), dtype)
        if v0 is None:
            v0 = zero_dual(meta, (B,), dtype)
        state = dict(
            sp=sp_alg.sp_init(meta, x0, z0, v0, opts),
            step_idx=jnp.zeros((B,), jnp.int32),
            # records sized by ws (static), indexed up to n_steps (dynamic):
            # one compiled program serves every phase of a bench run
            iters_rec=jnp.zeros((ws.shape[0], B), jnp.int32),
            us_rec=jnp.zeros((ws.shape[0], B, meta.nu), dtype),
            total=jnp.zeros((), jnp.int32),
        )
    else:
        state = resume

    if iters_per_launch <= 0:
        res, state = _simulate_async_jit(
            data, meta, ws, tol, n_steps_a, opts,
            jnp.asarray(max_total_iters, jnp.int32), state,
        )
        return res

    while True:
        budget = jnp.minimum(
            state["total"] + iters_per_launch,
            jnp.asarray(max_total_iters, jnp.int32),
        )
        res, state = _simulate_async_jit(
            data, meta, ws, tol, n_steps_a, opts, budget, state
        )
        jax.block_until_ready(res.steps_done)
        if bool(
            np.all(np.asarray(res.steps_done) >= n_steps)
        ) or int(res.total_iterations) >= max_total_iters:
            return res
