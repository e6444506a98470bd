"""Two-process throughput-efficiency measurement (SURVEY.md §7 step 7).

The round-4 multi-host story had correctness (tests/test_multihost.py) but
no RATE number behind the >=80% scaling-efficiency claim.  This script
measures it on the CPU-process proxy for a 2-host pod: fixed lanes PER
process (weak scaling), dp-sharded batched SPOCK solves over a
``jax.distributed`` global mesh, aggregate solves/s at 1 process vs 2
processes:

    efficiency = rate(2 procs) / (2 * rate(1 proc))

Per-solve state never crosses processes under dp sharding; the only
cross-process traffic is the termination all-reduce (`jnp.all(done)` each
iteration), so the extrapolation is: per iteration one 1-bit all-reduce
+ loop-control sync, amortized over B_local lanes of solver math — the same
structure a real 2-host run has over its network.

Usage: python examples/multihost_eff.py            # driver (runs workers)
       python examples/multihost_eff.py worker <pid> <nproc> <port> <out>
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

B_LOCAL = 32  # lanes per process (weak scaling; one CPU device each)
N_SOLVES = 6  # timed warm-started solves
N, NX, D = 6, 8, 2
TOL = 1e-4


def worker(pid: int, nproc: int, port: str, out_path: str):
    os.environ["JAX_PLATFORMS"] = "cpu"
    # ONE virtual device per process: parties must not exceed physical cores
    # (this host: 2), else the measurement reads core oversubscription, not
    # communication overhead
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    from spock_tpu.parallel.mesh import init_distributed

    if nproc > 1:
        init_distributed(
            f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
        )
        assert jax.process_count() == nproc

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from spock_tpu import build
    from spock_tpu.models import server_heat
    from spock_tpu.solver import Solver, zero_dual, zero_primal

    spec = server_heat.make_spec(N=N, nx=NX, d=D)
    data, meta = build(spec, dtype=jnp.float64)
    mesh = Mesh(np.array(jax.devices()), ("dp",))
    B = B_LOCAL * nproc
    rng = np.random.default_rng(0)
    x0s = rng.uniform(-0.5, 0.5, (N_SOLVES + 1, B, meta.nx))

    def make_global(arr, spec_):
        arr = np.asarray(arr)
        sh = NamedSharding(mesh, spec_)
        return jax.make_array_from_callback(arr.shape, sh,
                                            lambda idx: arr[idx])

    def shard_dp(tree):
        return jax.tree_util.tree_map(
            lambda a: make_global(
                a, P("dp", *([None] * (np.ndim(a) - 1)))
            ),
            tree,
        )

    def replicate(tree):
        return jax.tree_util.tree_map(lambda a: make_global(a, P()), tree)

    data_g = replicate(data)
    z = shard_dp(zero_primal(meta, (B,), jnp.float64))
    v = shard_dp(zero_dual(meta, (B,), jnp.float64))
    solver = Solver(data_g, meta, algorithm="spock", max_iter=3000)

    # compile + cold solve (excluded from timing)
    res = solver.solve(shard_dp(x0s[0]), z0=z, v0=v, tol=TOL)
    jax.block_until_ready(res.z)
    z, v = res.z, res.v

    iters = 0
    t0 = time.perf_counter()
    for k in range(1, N_SOLVES + 1):
        res = solver.solve(shard_dp(x0s[k]), z0=z, v0=v, tol=TOL)
        jax.block_until_ready(res.z)
        z, v = res.z, res.v
        iters += int(jnp.max(res.iterations))
    wall = time.perf_counter() - t0

    if pid == 0:
        rate = B * N_SOLVES / wall
        with open(out_path, "w") as f:
            json.dump(
                {"nproc": nproc, "B_global": B, "solves": N_SOLVES,
                 "wall_s": round(wall, 3),
                 "rate_solves_per_s": round(rate, 2),
                 "sum_max_iters": iters},
                f,
            )
    print(f"proc {pid}/{nproc}: ok wall={wall:.2f}s", flush=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_config(nproc: int, out: str):
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", str(pid),
             str(nproc), port, out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for pid in range(nproc)
    ]
    outs = [p.communicate(timeout=1800)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(o[-3000:])
    with open(out) as f:
        return json.load(f)


def main():
    outdir = os.path.join(_REPO, "examples", "output")
    os.makedirs(outdir, exist_ok=True)
    r1 = run_config(1, "/tmp/mh_eff_1.json")
    print(json.dumps(r1), flush=True)
    r2 = run_config(2, "/tmp/mh_eff_2.json")
    print(json.dumps(r2), flush=True)
    eff = r2["rate_solves_per_s"] / (2.0 * r1["rate_solves_per_s"])
    payload = {
        "config": {"model": f"server_heat N={N} nx={NX} d={D}", "tol": TOL,
                   "B_local": B_LOCAL, "solves": N_SOLVES,
                   "proxy": "2 jax.distributed CPU processes"},
        "one_process": r1,
        "two_process": r2,
        "weak_scaling_efficiency": round(eff, 4),
        "extrapolation": (
            "dp sharding keeps all per-solve state process-local; the only "
            "cross-process traffic is the per-iteration termination "
            "all-reduce of one bool per lane batch plus loop control "
            "(not measured on accelerators)."
        ),
    }
    path = os.path.join(outdir, "multihost_eff.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps({"wrote": path, "efficiency": payload[
        "weak_scaling_efficiency"]}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        main()
