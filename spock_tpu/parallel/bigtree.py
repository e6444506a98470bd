"""Node-sharded solves for trees larger than one device ("big-tree" path).

The reference scales deep horizons purely sequentially in host RAM
(``examples/server_heat/scaling.jl:9-24``, N up to 15); here the stage-major
node axis of every iterate is split across a ``Mesh(..., ("node",))`` so the
dominant leaf-heavy stages live in distributed memory and the elementwise
prox/update work executes shard-locally.  Stage-boundary data movement
(parent<->child regrouping of the sibling-major layout) lowers to XLA
collectives between devices.

GSPMD only shards evenly-divisible dimensions, and tree stage sizes are
powers of d — so the sharded carry holds a **node-padded** copy of each leaf
(last axis rounded up to a mesh multiple, zero-filled).  Each loop iteration
unpads (shard-local slice), runs the ordinary batched kernels, and re-pads +
re-constrains the result.  Numerics are identical to the unsharded solver:
the pads never enter the math.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..algorithms import supermann as sp_alg
from ..algorithms.common import (
    SolveResult,
    bwhere,
    check_termination,
    cp_sweep,
    residual_norms,
)
from ..problem import ProblemData, ProblemMeta
from ..solver import zero_dual, zero_primal
from ..zv import sub, tmap
from .mesh import node_constrainer, replicate, shard_nodes


def pad_nodes(tree, mult: int):
    """Zero-pad the last (node) axis of every leaf to a multiple of ``mult``."""

    def pad(a):
        w = a.shape[-1]
        extra = (-w) % mult
        if extra == 0:
            return a
        cfg = [(0, 0)] * (a.ndim - 1) + [(0, extra)]
        return jnp.pad(a, cfg)

    return tmap(pad, tree)


def unpad_nodes(tree_padded, template):
    """Slice each leaf back to the template's node-axis length.

    ``template`` only needs ``.shape`` per leaf — pass
    ``jax.eval_shape`` results to avoid materializing big-tree zeros."""

    def cut(a, t):
        return a[..., : t.shape[-1]] if a.shape[-1] != t.shape[-1] else a

    return tmap(cut, tree_padded, template)


def run_cp_sharded(
    data: ProblemData,
    meta: ProblemMeta,
    x0,
    tol,
    max_iter: int,
    mesh,
    z0=None,
    v0=None,
    gamma=None,
    sigma=None,
    stats=None,
) -> SolveResult:
    """Chambolle-Pock with node-sharded iterates.  x0: [B, nx] (replicated).

    Problem data is replicated (it is O(stages), not O(nodes), thanks to the
    broadcast-uniform factor layout); only the iterates are distributed.
    Returns an ordinary (unpadded) :class:`SolveResult` whose iterates keep
    their shard placement.
    """
    if gamma is None or sigma is None:
        step = 0.99 / jnp.sqrt(data.L_sq)
        gamma = sigma = step
    L = mesh.shape["node"]
    B = x0.shape[0]
    dtype = x0.dtype
    tmpl_z = zero_primal(meta, (B,), dtype)
    tmpl_v = zero_dual(meta, (B,), dtype)
    if z0 is None:
        z0 = tmpl_z
    if v0 is None:
        v0 = tmpl_v
    constrain = node_constrainer(mesh)
    data_r = replicate(data, mesh)
    zp0 = shard_nodes(pad_nodes(z0, L), mesh)
    vp0 = shard_nodes(pad_nodes(v0, L), mesh)

    def cond(c):
        return (~jnp.all(c["done"])) & (c["it"] < max_iter)

    @jax.jit
    def solve(x0, zp, vp):
        def body(c):
            z = unpad_nodes(c["zp"], tmpl_z)
            v = unpad_nodes(c["vp"], tmpl_v)
            zbar, vbar = cp_sweep(data_r, meta, z, v, gamma, sigma, x0)
            xi1, xi2 = residual_norms(
                data_r, meta, sub(zbar, z), sub(vbar, v), gamma, sigma
            )
            conv, res0 = check_termination(xi1, xi2, c["res0"], tol)
            active = ~c["done"]
            zp_new = constrain(pad_nodes(bwhere(active, zbar, z), L))
            vp_new = constrain(pad_nodes(bwhere(active, vbar, v), L))
            return dict(
                zp=zp_new,
                vp=vp_new,
                res0=jnp.where(active[:, None], res0, c["res0"]),
                done=c["done"] | conv,
                niter=c["niter"] + active.astype(jnp.int32),
                xi1=jnp.where(active, xi1, c["xi1"]),
                xi2=jnp.where(active, xi2, c["xi2"]),
                it=c["it"] + 1,
            )

        init = dict(
            zp=zp,
            vp=vp,
            res0=jnp.full((B, 2), -jnp.inf, dtype),
            done=jnp.zeros((B,), bool),
            niter=jnp.zeros((B,), jnp.int32),
            xi1=jnp.full((B,), jnp.inf, dtype),
            xi2=jnp.full((B,), jnp.inf, dtype),
            it=jnp.zeros((), jnp.int32),
        )
        out = jax.lax.while_loop(cond, body, init)
        return out

    if stats is not None:
        stats.update(_comm_stats(solve, x0, zp0, vp0))
    out = solve(x0, zp0, vp0)
    res = SolveResult(
        z=unpad_nodes(out["zp"], tmpl_z),
        v=unpad_nodes(out["vp"], tmpl_v),
        iterations=out["niter"],
        status=jnp.where(out["done"], 0, 1).astype(jnp.int32),
        xi1=out["xi1"],
        xi2=out["xi2"],
    )
    # second value: the raw padded, node-sharded final iterates (callers that
    # keep working distributed — warm starts, sharding checks — use these)
    return res, (out["zp"], out["vp"])


def _comm_stats(jitted, *args) -> dict:
    """Collective count/bytes of the compiled sharded program (the
    quantitative communication-volume side of the node-sharding story —
    counted from the compiled program, so virtual meshes measure it too)."""
    from ..utils.profiling import hlo_collective_stats

    compiled = jitted.lower(*args).compile()
    return hlo_collective_stats(compiled.as_text())


def run_sp_sharded(
    data: ProblemData,
    meta: ProblemMeta,
    x0,
    tol,
    max_iter: int,
    mesh,
    opts: "sp_alg.SuperMannOpts" = None,
    z0=None,
    v0=None,
    gamma=None,
    sigma=None,
    stats=None,
    record: bool = False,
) -> SolveResult:
    """SuperMann (SPOCK) with node-sharded iterates — the headline algorithm
    on big trees, not just plain CP.

    Made possible by the structured quasi-Newton machinery: the Anderson
    histories are (Primal, Dual)-shaped rows and every Gram/combine reduction
    is leafwise (algorithms/anderson.direction_struct), so all quasi-Newton
    state shards along the node axis like the iterates themselves — the old
    flat [B, K] layout concatenated across the node axis, which would have
    all-gathered every iteration.  The whole SPCarry (z, v, r_prev, s_prev,
    AA rows, sweep cache) is node-padded and re-constrained each iteration,
    exactly like :func:`run_cp_sharded`; per-lane scalars are replicated.
    """
    if opts is None:
        opts = sp_alg.SuperMannOpts()
    assert opts.direction in ("anderson", "residual"), (
        "broyden keeps flat [B, K] state — not node-shardable"
    )
    L = mesh.shape["node"]
    B = x0.shape[0]
    dtype = x0.dtype
    if z0 is None:
        z0 = zero_primal(meta, (B,), dtype)
    if v0 is None:
        v0 = zero_dual(meta, (B,), dtype)
    constrain = node_constrainer(mesh)
    data_r = replicate(data, mesh)

    init = sp_alg.sp_init(
        meta, x0, z0, v0, opts, max_iter=max_iter, record=record
    )
    # shapes-only template of the unpadded carry (no big-tree zeros)
    tmpl = jax.eval_shape(lambda c: c, init)
    pad_fields = (
        "z", "v", "r_prev", "s_prev", "dirstate", "zbar_c", "vbar_c",
    )

    def pad_carry(c):
        repl = {
            f: constrain(pad_nodes(getattr(c, f), L)) for f in pad_fields
        }
        return dataclasses.replace(c, **repl)

    def unpad_carry(cp_):
        repl = {
            f: unpad_nodes(getattr(cp_, f), getattr(tmpl, f))
            for f in pad_fields
        }
        return dataclasses.replace(cp_, **repl)

    body_sp = sp_alg.sp_body(data_r, meta, tol, opts, gamma=gamma,
                             sigma=sigma, record=record)

    @jax.jit
    def solve(cp0):
        def body(cp_):
            return pad_carry(body_sp(unpad_carry(cp_)))

        def cond(cp_):
            return (~jnp.all(cp_.done)) & (cp_.it < max_iter)

        return jax.lax.while_loop(cond, body, cp0)

    if stats is not None:
        stats.update(_comm_stats(solve, pad_carry(init)))
    out = solve(pad_carry(init))
    res = SolveResult(
        z=unpad_nodes(out.z, tmpl.z),
        v=unpad_nodes(out.v, tmpl.v),
        iterations=out.niter,
        status=jnp.where(out.done, 0, 1).astype(jnp.int32),
        xi1=out.xi1,
        xi2=out.xi2,
        residuals=out.hist if record else None,
    )
    return res, (out.z, out.v)
