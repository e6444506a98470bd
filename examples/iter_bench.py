"""Device time of one CP sweep and one SuperMann iteration, and the number of
device kernels each launches, at the benchmark's width (server_heat
nx = nu = 20, N = 10, d = 2, B = 128, float32) on a GPU.

Three windows, each timed by the host clock around ``block_until_ready`` and
then traced with ``jax.profiler`` (a separate run of the same window):

* ``sweep``   — ``cp_sweep_metric`` called back to back;
* ``farm``    — the warm asynchronous MPC farm (``mpc.simulate_async``) in
  steady state, per farm iteration (one SuperMann iteration of all lanes);
* ``cold``    — a cold ``Solver(..., "spock")`` solve of all lanes, per
  SuperMann iteration (backtracking included).

Prints one JSON object; ``--out`` also writes it to a file.

    python examples/iter_bench.py [--trace-dir DIR] [--out FILE]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
)

import argparse
import json
import os
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "traces", "iter_bench",
    ))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from spock_tpu.utils import compile_cache, profiling

    compile_cache.enable()
    import jax
    import jax.numpy as jnp
    import numpy as np

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"iter_bench: measures a GPU; JAX's backend is "
            f"{jax.default_backend()!r}"
        )
    from spock_tpu import Solver, build, mpc
    from spock_tpu.algorithms.common import cp_sweep_metric
    from spock_tpu.models import server_heat
    from spock_tpu.solver import zero_dual, zero_primal

    B = 128
    spec = server_heat.make_spec(N=10, nx=20, d=2)
    data, meta = build(spec, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    d0 = jax.devices()[0]
    report = {
        "device": {
            "platform": d0.platform, "kind": d0.device_kind,
            "count": len(jax.devices()), "card": profiling.card_info(),
            "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
        },
        "config": f"server_heat nx=20 N=10 d=2 nodes={meta.tree.n} B={B} "
                  "float32",
    }

    def window(name, run, per, n_units):
        """Host-timed run, then a traced run of the same work."""
        jax.block_until_ready(run())  # compile + warm
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        wall = time.perf_counter() - t0
        tdir = os.path.join(args.trace_dir, name)
        with profiling.trace(tdir):
            jax.block_until_ready(run())
        st = profiling.trace_device_stats(tdir)
        n = n_units()
        report[name] = {
            "units": n, "per": per,
            "host_ms_per": 1e3 * wall / n,
            "device_busy_ms_per": st["busy_ns"] / 1e6 / n,
            "kernels_per": st["events"] / n,
            "device_busy_share_traced": st["busy_ns"] / max(
                sum(p["window_ns"] for p in st["planes"].values()), 1.0
            ),
            "top_kernels_ms": {
                k: v / 1e6 for k, v in list(st["top_ns"].items())[:6]
            },
        }
        print(name, json.dumps(report[name]), flush=True)

    # ---- CP sweep + metric, back to back ----
    z, v = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        (zero_primal(meta, (B,)), zero_dual(meta, (B,))),
    )
    x0 = jnp.asarray(rng.uniform(-0.6, 0.6, (B, meta.nx)), jnp.float32)
    gamma = 0.99 / float(np.sqrt(float(data.L_sq)))
    sweep = jax.jit(
        lambda z, v: cp_sweep_metric(data, meta, z, v, gamma, gamma, x0)
    )
    reps = 50

    def run_sweeps():
        out = None
        for _ in range(reps):
            out = sweep(z, v)
        return out

    window("sweep", run_sweeps, "cp_sweep_metric call", lambda: reps)

    # ---- warm farm, steady state ----
    tol = jnp.asarray(1e-3, jnp.float32)
    steps = 50
    ws = jnp.asarray(rng.integers(0, 2, (steps, B)))
    warm = mpc.simulate_async(data, meta, x0, ws, tol, n_steps=8)
    last = {}

    def run_farm():
        last["res"] = mpc.simulate_async(
            data, meta, warm.xs, ws, tol, n_steps=steps, z0=warm.z,
            v0=warm.v,
        )
        return last["res"]

    window("farm", run_farm, "farm iteration (all lanes)",
           lambda: int(last["res"].total_iterations))
    iters = np.asarray(last["res"].iters_per_step).astype(float)
    report["farm"]["mean_iters_per_solve"] = float(iters.mean())
    report["farm"]["solves"] = int(np.asarray(last["res"].steps_done).sum())

    # ---- cold SPOCK solve of all lanes ----
    solver = Solver(data, meta, algorithm="spock")

    def run_cold():
        last["cold"] = solver.solve(x0, tol=1e-3)
        return last["cold"]

    window("cold", run_cold, "SuperMann iteration (all lanes)",
           lambda: int(np.asarray(last["cold"].iterations).max()))

    report["memory_peak_bytes"] = (d0.memory_stats() or {}).get(
        "peak_bytes_in_use"
    )
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
