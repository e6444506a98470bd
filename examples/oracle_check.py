"""Three-tier oracle cross-check at the headline configuration.

Solves the same risk-averse OCP instances (server_heat, N=10, nx=20, d=2 —
2047 nodes, the headline bench config) with three independent code paths and
reports pairwise control/objective agreement:

1. the JAX engine (SuperMann, float32 on the default device — the GPU in
   production);
2. the native C++ CP/SuperMann tier (float64, same splitting math,
   independent implementation);
3. the sparse conic ADMM oracle (float64, independent *method family*:
   explicit sparse standard form + cached LU + cone projections —
   ``baselines/admm_ref.py``, the role of the reference's Mosek/SCS
   backends, ``model_mosek.jl:133-511``).

Usage: python examples/oracle_check.py [--cpu] [--n-instances 3]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n-instances", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--json-out", default=None,
                    help="write the full report to this path")
    args = ap.parse_args()

    if args.cpu:
        _os.environ["JAX_PLATFORMS"] = "cpu"
    from spock_tpu.utils import compile_cache

    compile_cache.enable()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from spock_tpu import build
    from spock_tpu.baselines import admm_ref
    from spock_tpu.baselines.native import NativeSolver
    from spock_tpu.models import server_heat

    spec = server_heat.make_spec(N=10, nx=20, d=2)
    data, meta = build(spec, dtype=jnp.float32)
    d0 = jax.devices()[0]
    device = {"platform": d0.platform, "kind": d0.device_kind}
    rng = np.random.default_rng(0)
    K = args.n_instances
    x0 = np.asarray(rng.uniform(-0.6, 0.6, (K, meta.nx)), np.float32)

    # Cold solves as a padded 1-step async farm at the HEADLINE shapes
    # (B=128, ws [200, B]) — the exact program bench.py compiles, so on a
    # warm cache this costs no compile.
    from spock_tpu import mpc

    B = 128
    x0_pad = np.zeros((B, meta.nx), np.float32)
    x0_pad[:K] = x0
    ws = jnp.zeros((200, B), jnp.int32)
    res = mpc.simulate_async(
        data, meta, jnp.asarray(x0_pad), ws,
        jnp.asarray(args.tol, jnp.float32), n_steps=1,
        iters_per_launch=200, max_total_iters=25000,
    )
    jax.block_until_ready(res.steps_done)
    assert int(np.asarray(res.steps_done).min()) == 1, "cold solve stalled"
    u_jax = np.asarray(res.us)[0][:K]  # recorded root controls, step 1
    obj_jax = np.asarray(res.z.s)[:K, 0]  # frozen converged iterates

    rows = []
    for i in range(K):
        nat = NativeSolver(spec).solve(
            np.asarray(x0[i], np.float64), tol=1e-6, max_iter=50000,
            algorithm="spock", warm_start=False,
        )
        adm = admm_ref.solve(
            spec, np.asarray(x0[i], np.float64), tol=1e-8, max_iter=20000
        )
        rows.append(
            {
                "instance": i,
                "jax_converged": bool(res.steps_done[i] == 1),
                "native_converged": bool(nat["converged"]),
                "admm_converged": bool(adm["converged"]),
                "u0_err_jax_vs_native": float(
                    np.max(np.abs(u_jax[i] - nat["u"][0]))
                ),
                "u0_err_jax_vs_admm": float(
                    np.max(np.abs(u_jax[i] - adm["u"][0]))
                ),
                "u0_err_native_vs_admm": float(
                    np.max(np.abs(nat["u"][0] - adm["u"][0]))
                ),
                "obj": {
                    "jax": float(obj_jax[i]),
                    "native": float(nat["objective"]),
                    "admm": float(adm["objective"]),
                },
            }
        )
        print(json.dumps(rows[-1]))

    worst_oracles = max(r["u0_err_native_vs_admm"] for r in rows)
    worst_engine = max(r["u0_err_jax_vs_native"] for r in rows)
    summary = {
        "summary": "oracle agreement",
        "device": device,
        # the two float64 oracles agree independently of the engine ...
        "worst_u0_err_native_vs_admm": worst_oracles,
        "oracles_ok": worst_oracles < 1e-4,
        # ... AND the engine must track them: a cold float32 tol=1e-3 solve
        # lands within 1e-3 of the float64 oracle (the tolerance itself
        # leaves ~6e-4 on this protocol)
        "worst_u0_err_engine_vs_native": worst_engine,
        "engine_ok": worst_engine < 1e-3,
    }
    summary["ok"] = bool(summary["oracles_ok"] and summary["engine_ok"])
    print(json.dumps(summary))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"instances": rows, **summary}, f, indent=1)
    if not summary["ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
