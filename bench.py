"""Headline benchmark: warm-started server_heat MPC solves/s on one GPU.

Matches the driver metric in BASELINE.json: server_heat tree (nx = nu = 20,
N = 10, d = 2 — the reference's mpc_simulation.jl configuration), tolerance
eps = 1e-3, warm-started receding-horizon steps, measured in steady state.

Execution model: the asynchronous MPC farm (spock_tpu.mpc.simulate_async) —
B independent receding-horizon chains advance in lockstep iterations, each
chain starting its next warm-started solve the moment the previous one
converges, so throughput is set by the mean iteration count, not the
slowest lane.  Phase 1 (untimed) runs the chains to warm steady state;
phase 2 measures.  Prints one JSON line naming the device it ran on.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def main():
    from spock_tpu.utils import compile_cache

    compile_cache.enable()
    import jax
    import jax.numpy as jnp

    from spock_tpu import build, mpc
    from spock_tpu.models import server_heat
    from spock_tpu.utils import profiling

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench: measures a GPU; JAX's backend is {jax.default_backend()!r}"
        )

    B = int(os.environ.get("SPOCK_BENCH_B", "128"))
    warm_steps = int(os.environ.get("SPOCK_BENCH_WARMUP", "8"))
    timed_steps = int(os.environ.get("SPOCK_BENCH_STEPS", "200"))
    repeats = int(os.environ.get("SPOCK_BENCH_REPEATS", "3"))
    N, nx, d = 10, 20, 2
    tol = 1e-3

    spec = server_heat.make_spec(N=N, nx=nx, d=d)
    data, meta = build(spec, dtype=jnp.float32)

    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.uniform(-0.6, 0.6, (B, meta.nx)), jnp.float32)
    # ONE realization array for every phase: n_steps is dynamic in the farm,
    # so warmup / timing / parity all reuse a single compiled program.
    ws = jnp.asarray(rng.integers(0, d, size=(timed_steps, B)))
    tol_a = jnp.asarray(tol, jnp.float32)

    # farm iterations per device launch (0 = the whole run in one launch);
    # the launch budget is a dynamic arg, so changing it never recompiles.
    chunk = int(os.environ.get("SPOCK_BENCH_CHUNK", "400"))
    # fail-fast iteration ceiling: the healthy run needs ~1-2k farm
    # iterations total; a lane that stops converging (NaN) would otherwise
    # spin to the 1e6 default
    cap = int(os.environ.get("SPOCK_BENCH_MAX_ITERS", "25000"))

    import sys

    def progress(msg):
        print(f"[bench +{time.perf_counter() - T0:7.1f}s] {msg}",
              file=sys.stderr, flush=True)

    T0 = time.perf_counter()
    progress("compiling + warmup phase (cold chains -> steady state)")
    # phase 1: cold chains -> warm steady state
    res1 = mpc.simulate_async(
        data, meta, x0, ws, tol_a, n_steps=warm_steps,
        iters_per_launch=chunk, max_total_iters=cap,
    )
    jax.block_until_ready(res1)
    progress(
        f"phase 1 done: steps_done min={int(np.asarray(res1.steps_done).min())}"
        f" total_iters={int(res1.total_iterations)}"
    )
    assert int(np.asarray(res1.steps_done).min()) == warm_steps, (
        "warmup did not complete within the iteration cap: "
        f"steps_done={np.asarray(res1.steps_done)}, cap={cap} "
        "(a lane is likely not converging)"
    )

    # phase 2: timed identical repeated runs (median of >= 3 repeats x 200
    # steps).  Same compiled program as phase 1.
    res2 = mpc.simulate_async(
        data, meta, res1.xs, ws, tol_a, n_steps=timed_steps,
        z0=res1.z, v0=res1.v, iters_per_launch=chunk, max_total_iters=cap,
    )
    jax.block_until_ready(res2)
    progress("phase 2 warm pass done; timing")
    rates, walls = [], []
    for rep in range(repeats):
        t0 = time.perf_counter()
        res2 = mpc.simulate_async(
            data, meta, res1.xs, ws, tol_a, n_steps=timed_steps,
            z0=res1.z, v0=res1.v, iters_per_launch=chunk,
            max_total_iters=cap,
        )
        jax.block_until_ready(res2)
        dt = time.perf_counter() - t0
        walls.append(dt)
        rates.append(int(np.asarray(res2.steps_done).sum()) / dt)
        progress(f"repeat {rep + 1}/{repeats}: {rates[-1]:.1f} solves/s")

    solves_per_s = float(np.median(rates))
    iters = np.asarray(res2.iters_per_step).astype(float)

    # float32 correctness gate: applied root controls of a fresh tol=1e-3
    # float32 solve on the device vs the float64 native oracle (tol=1e-5) at
    # the same states (BASELINE.json: "controls match ... to 1e-4").  The
    # cold solves run as a 1-step farm from zero (z0, v0) — the SAME
    # compiled program as the timed phases, not a second giant compile.
    controls_max_err = None
    n_check = int(os.environ.get("SPOCK_BENCH_PARITY_LANES", "2"))
    if n_check > 0:
        from spock_tpu.baselines.native import NativeSolver

        progress("parity check (cold 1-step farm + native oracle)")
        xs = np.asarray(res2.xs)
        res_p = mpc.simulate_async(
            data, meta, res2.xs, ws, tol_a, n_steps=1,
            iters_per_launch=chunk, max_total_iters=cap,
        )
        u0_f32 = np.asarray(res_p.us)[0]  # [B, nu] cold root controls
        ns = NativeSolver(spec)
        errs = []
        for i in range(n_check):
            ref = ns.solve(
                np.asarray(xs[i], np.float64), tol=1e-5, max_iter=20000,
                algorithm="spock", warm_start=False,
            )
            assert ref["converged"]
            errs.append(float(np.max(np.abs(u0_f32[i] - ref["u"][0]))))
        controls_max_err = max(errs)

    d0 = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "warm_mpc_solves_per_s",
                "value": solves_per_s,
                "unit": "solves/s/device",
                "detail": {
                    "B": B,
                    "config": f"server_heat nx={nx} N={N} d={d} tol={tol} async",
                    "timed_steps": timed_steps,
                    "repeats": repeats,
                    "rates": rates,
                    "mean_iters_per_solve": float(iters.mean()),
                    "p99_iters": float(np.percentile(iters, 99)),
                    "total_sweep_iterations": int(res2.total_iterations),
                    "wall_s": float(np.median(walls)),
                    "controls_max_err": controls_max_err,
                    "device": {
                        "platform": d0.platform,
                        "kind": d0.device_kind,
                        "count": len(jax.devices()),
                        "card": profiling.card_info(),
                        "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
                    },
                },
            }
        )
    )


if __name__ == "__main__":
    main()
