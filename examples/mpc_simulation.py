"""MPC closed-loop benchmark (counterpart of the reference's
``examples/server_heat/mpc_simulation.jl``: nx = nu = 20, N = 10, d = 2,
tol = 1e-3, 20 MPC steps, M repeats).

The batched twist: instead of running the M repeats sequentially, they are
the batch axis — all repeats advance in lockstep on one device.

Usage: python examples/mpc_simulation.py [--cpu] [--repeats 15] [--steps 20]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on host CPU")
    ap.add_argument("--repeats", type=int, default=15)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--nx", type=int, default=20)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--use-async", action="store_true",
                    help="asynchronous farm (per-lane chain advancement)")
    ap.add_argument("--plot", action="store_true",
                    help="write a per-step cost PNG to examples/output/")
    args = ap.parse_args()

    import os

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import numpy as np

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if args.f64 else jnp.float32

    from spock_tpu import build, mpc
    from spock_tpu.models import server_heat

    spec = server_heat.make_spec(N=args.horizon, nx=args.nx, d=2)
    data, meta = build(spec, dtype=dtype)

    rng = np.random.default_rng(0)
    B = args.repeats
    x0 = jnp.asarray(rng.uniform(-0.1, 0.1, (B, meta.nx)), dtype)
    ws = jnp.asarray(rng.integers(0, 2, (args.steps, B)))

    def run_once():
        if args.use_async:
            return mpc.simulate_async(
                data, meta, x0, ws, jnp.asarray(args.tol, dtype),
                n_steps=args.steps, iters_per_launch=200,
            )
        return mpc.simulate(data, meta, x0, ws, tol=jnp.asarray(args.tol, dtype))

    t0 = time.perf_counter()
    res = run_once()
    jax.block_until_ready(res)
    compile_and_run = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = run_once()
    jax.block_until_ready(res)
    run = time.perf_counter() - t0

    iters = np.asarray(
        res.iters_per_step if args.use_async else res.iterations
    )
    png = None
    if args.plot:
        from plotting import SERIES, new_axes, save

        per_step_ms = 1e3 * run / args.steps
        fig, ax = new_axes(
            f"Warm-started MPC: solver iterations per step "
            f"(nx={args.nx} N={args.horizon}, {per_step_ms:.1f} ms/step, "
            f"B={B} repeats)",
            "MPC step",
            "SuperMann iterations per solve",
        )
        steps_ax = np.arange(1, iters.shape[0] + 1)
        s = SERIES["spock"]
        ax.fill_between(
            steps_ax, iters.min(axis=1), iters.max(axis=1),
            color=s["color"], alpha=0.18, lw=0,
        )
        ax.plot(
            steps_ax, iters.mean(axis=1), color=s["color"], lw=2,
            marker="o", ms=4,
        )
        ax.set_ylim(bottom=0)
        png = save(fig, "mpc_simulation.png")

    print(
        json.dumps(
            {
                "config": vars(args),
                "total_wall_s": round(run, 4),
                "per_step_wall_ms": round(1e3 * run / args.steps, 3),
                "per_solve_wall_ms": round(1e3 * run / (args.steps * B), 4),
                "mean_iters_cold_step": float(iters[0].mean()),
                "mean_iters_warm_steps": float(iters[1:].mean()),
                "unconverged": 0
                if args.use_async
                else int((np.asarray(res.status) != 0).sum()),
                "compile_s": round(compile_and_run - run, 2),
                "device": str(jax.devices()[0]),
                "png": png,
            },
            indent=2,
        )
    )


if __name__ == "__main__":
    main()
