"""Smoke run of spock_tpu on NVIDIA GPUs through the entry points a user calls.

One card (the default), phases in order; the first failure ends the run with
a non-zero exit code:

1. device  - refuse unless JAX's default backend is a GPU (no CPU fallback);
2. solves  - ``Solver(..., "cp")`` and ``Solver(..., "spock")`` at the
             benchmark's width (server_heat nx = nu = 20, N = 10, d = 2,
             B = 128 lanes, tol 1e-3, float32), cold from the farm's
             starting states; every lane converges, CP's root controls
             match the float64 native CP solver run to the same tolerance,
             and both stay within the tolerance band of the float64
             tol-1e-5 solution;
3. sweep   - one ``cp_sweep_metric`` at full width in float32 on the card
             against the same function in float64 on the CPU;
4. mpc     - ``mpc.simulate`` (3 steps, B = 8) and ``mpc.simulate_async``
             (B = 128: 8 warm steps, then 50 timed steps); then cold CP and
             SPOCK solves at the closed-loop states the farm reached, whose
             root controls must be within 1e-4 of the float64 native oracle
             solved to tol 1e-5.

``--cards 4`` runs only the paths that span cards, each with its comparison:

a. dp fleet  - ``mpc.simulate_async`` at B = 512, lanes sharded 128 per card,
               against the same 512 lanes on card 0 alone (as four 128-lane
               calls, and as one 512-lane call);
b. big tree  - ``parallel.bigtree.run_cp_sharded`` on server_heat d = 3,
               N = 10, nx = 20 over a 4-card ("node",) mesh, against the
               unsharded ``Solver(..., "cp")`` on card 0.

Progress goes to stdout; the last line of stdout is exactly
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

    python chip_smoke.py
    python chip_smoke.py --cards 4
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

N, NX, D = 10, 20, 2
B = 128
TOL = 1e-3
# Root controls vs the float64 native solver (BASELINE.json's criterion).
# spock_tpu pins jax_default_matmul_precision="highest", so float32 dots on
# the card run in full float32, not TF32.
CONTROL_TOL = 1e-4
SWEEP_TOL = 1e-5  # max-abs error / inf-norm, float32 card vs float64 CPU
ORACLE_TOL = 1e-5
ORACLE_LANES = 2
ITER_CAP = 25_000  # farm iteration ceiling: a lane that stops converging fails
# --cards 4 (a): one cold step solved at two batch sizes lands anywhere in
# the tol-1e-3 band of each; warm steps from one state agree far closer.
FLEET_BAND = 5e-3
WARM_REL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def check_device(jax) -> list:
    """JAX's devices; exits non-zero unless the default backend is a GPU."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU, but JAX's backend is {backend!r}"
        )
    return jax.devices()


def last_line(devices) -> str:
    """The contract's last line, built from JAX's own device report."""
    d0 = devices[0]
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": d0.platform,
                "kind": d0.device_kind,
                "count": len(devices),
            },
        }
    )


class Background:
    """``fn(*args)`` on a daemon thread, so a failing run exits at once
    instead of waiting for it."""

    def __init__(self, fn, *args):
        self._out = {}
        self._thread = threading.Thread(
            target=lambda: self._out.update(value=fn(*args)), daemon=True
        )
        self._thread.start()

    def result(self):
        self._thread.join()
        if "value" not in self._out:
            raise AssertionError("background computation failed")
        return self._out["value"]


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling (or fetching from
    the persistent cache), summed from ``jax.monitoring`` events."""

    def __init__(self, jax):
        self.secs = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.secs += duration


class Phase:
    """Logs one phase's wall seconds and the compile seconds inside it."""

    def __init__(self, name, clock, card):
        self.name, self.clock, self.card = name, clock, card

    def __enter__(self):
        self.t0, self.c0 = time.perf_counter(), self.clock.secs
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            wall = time.perf_counter() - self.t0
            comp = self.clock.secs - self.c0
            log(f"[{self.name}] compile_s={comp:.3f} run_s={wall - comp:.3f} "
                f"wall_s={wall:.3f} card={self.card}")
        return False


def oracle_controls(spec, xs, algorithm, tol):
    """Root controls u_1 of the float64 native solver, cold, per state.
    The native call releases the GIL, so callers run this in a thread
    beside the card's work."""
    import numpy as np

    from spock_tpu.baselines.native import NativeSolver

    ns = NativeSolver(spec)
    out = []
    for x in xs:
        r = ns.solve(np.asarray(x, np.float64), tol=tol, max_iter=50_000,
                     algorithm=algorithm, warm_start=False)
        if not r["converged"]:
            raise AssertionError(f"native {algorithm} did not converge")
        out.append(r["u"][0])
    return np.stack(out)


def cold_solve(jax, np, data, meta, algorithm, x0):
    """Cold batched solve; every lane must converge.  Returns (u_1, iters)."""
    from spock_tpu import Solver

    res = jax.block_until_ready(
        Solver(data, meta, algorithm=algorithm).solve(x0, tol=TOL)
    )
    conv = np.asarray(res.converged)
    if not bool(np.all(conv)):
        raise AssertionError(
            f"{algorithm}: {int((~conv).sum())} of {conv.size} lanes did not "
            "converge"
        )
    return np.asarray(res.z.u[:, :, 0], np.float64), np.asarray(res.iterations)


def max_err(a, b) -> float:
    import numpy as np

    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def phase_solves(jax, np, spec, data, meta, x0):
    """Cold CP and SPOCK solves of every lane from the farm's start states.

    The solver stops on a residual relative to its first one (the
    reference's rule), so from these states tol 1e-3 leaves the controls a
    few 1e-4 from the exact solution in any implementation.  Gates: CP
    within 1e-4 of the native CP solver run to the same tolerance, and each
    algorithm no further from the tol-1e-5 solution than twice the native
    solver's own distance at the same tolerance (and at least 1e-4)."""
    lanes = x0[:ORACLE_LANES]
    exact = Background(oracle_controls, spec, lanes, "spock", ORACLE_TOL)
    same = {alg: Background(oracle_controls, spec, lanes, alg, TOL)
            for alg in ("cp", "spock")}
    solved = {alg: cold_solve(jax, np, data, meta, alg, x0)
              for alg in ("cp", "spock")}
    exact = exact.result()
    for alg in ("cp", "spock"):
        u, it = solved[alg]
        ref = same[alg].result()
        e_same = max_err(u[:ORACLE_LANES], ref)
        e_exact = max_err(u[:ORACLE_LANES], exact)
        own = max_err(ref, exact)
        limit = max(2.0 * own, CONTROL_TOL)
        log(f"solve {alg}: lanes={it.size} converged=all iterations "
            f"mean={it.mean():.1f} max={it.max()}; root controls, "
            f"{ORACLE_LANES} lanes: vs native {alg} at tol {TOL:g} "
            f"{e_same:.3e}; vs tol-{ORACLE_TOL:g} oracle {e_exact:.3e} "
            f"(limit {limit:.3e}: twice native {alg}'s own {own:.3e})")
        if alg == "cp" and not e_same <= CONTROL_TOL:
            raise AssertionError(
                f"cp: root controls {e_same:.3e} from the native CP solver"
            )
        if not e_exact <= limit:
            raise AssertionError(
                f"{alg}: root controls {e_exact:.3e} from the tol-"
                f"{ORACLE_TOL:g} oracle, limit {limit:.3e}"
            )


def sweep_error(jax, jnp, np, spec, batch, seed, precision="highest"):
    """Worst leaf of ``cp_sweep_metric`` (max-abs error over the leaf's
    inf-norm): float32 on the default device vs float64 on the CPU, from
    random (z, v) at the problem's shapes."""
    from spock_tpu import build
    from spock_tpu.algorithms.common import cp_sweep_metric
    from spock_tpu.solver import zero_dual, zero_primal

    def run(dtype, device, gamma=None):
        with jax.default_device(device):
            data, meta = build(spec, dtype=dtype)
            rng = np.random.default_rng(seed)
            z, v = jax.tree_util.tree_map(
                lambda a: jnp.asarray(rng.standard_normal(a.shape), dtype),
                (zero_primal(meta, (batch,)), zero_dual(meta, (batch,))),
            )
            x0 = jnp.asarray(rng.uniform(-0.6, 0.6, (batch, meta.nx)), dtype)
            if gamma is None:
                gamma = 0.99 / float(np.sqrt(float(data.L_sq)))
            f = jax.jit(
                lambda d, z, v, x0: cp_sweep_metric(
                    d, meta, z, v, gamma, gamma, x0
                )
            )
            out = jax.tree_util.tree_map(np.asarray, f(data, z, v, x0))
            return out, gamma

    with jax.enable_x64():
        ref, gamma = run(jnp.float64, jax.devices("cpu")[0])
    with jax.default_matmul_precision(precision):
        got, _ = run(jnp.float32, jax.devices()[0], gamma)
    worst = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        scale = max(float(np.max(np.abs(b))), 1e-30)
        worst = max(worst, max_err(a, b) / scale)
    return worst


def phase_mpc(jax, jnp, np, spec, data, meta, x0, rng, card):
    """Synchronous and asynchronous receding-horizon MPC, then cold solves
    at the closed-loop states against the tol-1e-5 oracle."""
    from spock_tpu import mpc

    tol = jnp.asarray(TOL, jnp.float32)
    ws3 = jnp.asarray(rng.integers(0, D, (3, 8)))
    res = jax.block_until_ready(
        mpc.simulate(data, meta, jnp.asarray(x0[:8]), ws3, tol)
    )
    if not (bool(np.all(np.asarray(res.status) == 0))
            and bool(np.all(np.isfinite(np.asarray(res.us))))):
        raise AssertionError("mpc.simulate: a lane failed or is not finite")
    log(f"mpc.simulate: B=8 steps=3 iterations per step and lane "
        f"{np.asarray(res.iterations).tolist()}")

    warm, timed = 8, 50
    ws = jnp.asarray(rng.integers(0, D, (timed, len(x0))))
    res1 = jax.block_until_ready(mpc.simulate_async(
        data, meta, jnp.asarray(x0), ws, tol, n_steps=warm,
        max_total_iters=ITER_CAP,
    ))
    if int(np.asarray(res1.steps_done).min()) != warm:
        raise AssertionError("async farm warm-up: a lane did not finish")
    t0 = time.perf_counter()
    res2 = jax.block_until_ready(mpc.simulate_async(
        data, meta, res1.xs, ws, tol, n_steps=timed, z0=res1.z, v0=res1.v,
        max_total_iters=ITER_CAP,
    ))
    dt = time.perf_counter() - t0
    done = np.asarray(res2.steps_done)
    us = np.asarray(res2.us)
    if not (bool(np.all(done == timed)) and bool(np.all(np.isfinite(us)))):
        raise AssertionError(
            f"async farm: steps_done min {done.min()} of {timed}, finite "
            f"controls {bool(np.all(np.isfinite(us)))}"
        )
    iters = np.asarray(res2.iters_per_step).astype(float)
    log(f"mpc.simulate_async: B={len(x0)} warm={warm} timed={timed} "
        f"every lane finished every step; solves/s={done.sum() / dt:.2f} "
        f"mean_iters={iters.mean():.3f} p99_iters="
        f"{np.percentile(iters, 99):.1f} farm_iterations="
        f"{int(res2.total_iterations)} wall_s={dt:.4f} card={card}")

    xs = np.asarray(res2.xs)
    exact = oracle_controls(spec, xs[:ORACLE_LANES], "spock", ORACLE_TOL)
    for alg in ("cp", "spock"):
        u, it = cold_solve(jax, np, data, meta, alg, xs)
        err = max_err(u[:ORACLE_LANES], exact)
        log(f"closed-loop solve {alg}: B={it.size} cold, converged=all, "
            f"iterations mean={it.mean():.1f}; root controls vs "
            f"tol-{ORACLE_TOL:g} f64 oracle ({ORACLE_LANES} lanes) "
            f"{err:.3e}")
        if not err <= CONTROL_TOL:
            raise AssertionError(f"{alg}: root controls {err:.3e} off")


def main_one(jax, jnp, np, clock, card):
    from spock_tpu import build
    from spock_tpu.models import server_heat

    spec = server_heat.make_spec(N=N, nx=NX, d=D)
    rng = np.random.default_rng(0)
    with Phase("build", clock, card):
        data, meta = build(spec, dtype=jnp.float32)
    log(f"problem: server_heat nx=nu={NX} N={N} d={D} nodes={meta.tree.n} "
        f"B={B} tol={TOL:g} float32")
    x0 = rng.uniform(-0.6, 0.6, (B, NX)).astype(np.float32)
    with Phase("solves", clock, card):
        phase_solves(jax, np, spec, data, meta, x0)
    with Phase("sweep", clock, card):
        err = sweep_error(jax, jnp, np, spec, B, seed=1)
        log(f"sweep parity (cp_sweep_metric, B={B}, f32 card vs f64 CPU, "
            f"precision=highest): max-abs err / inf-norm = {err:.3e}")
        if not err <= SWEEP_TOL:
            raise AssertionError(f"sweep parity {err:.3e} > {SWEEP_TOL:g}")
        err_tf32 = sweep_error(jax, jnp, np, spec, B, seed=1,
                               precision="default")
        log(f"finding: the same sweep at precision=default (TF32 dots): "
            f"{err_tf32:.3e}")
    with Phase("mpc", clock, card):
        phase_mpc(jax, jnp, np, spec, data, meta, x0, rng, card)


def fleet_4(jax, jnp, np, devices, clock, card):
    """(a) dp-sharded async farm vs the same lanes on card 0.

    A lane's arithmetic depends on the program it runs in: the batch size
    and the partitioning XLA compiled it for.  Cold tol-1e-3 SuperMann
    solves amplify such last-bit differences to the width of the tolerance
    band and, over 8 receding-horizon steps, beyond.  The witness of that
    is card 0 alone, run once as four 128-lane calls and once as one
    512-lane call.  Gates: every lane finishes every step; the first cold
    step of the sharded farm is within the band (FLEET_BAND) of card 0's;
    over 8 cold steps the sharded farm is no further from card 0 than
    twice the witness; and from a shared warm state 8 warm steps agree to
    1e-3 of max |u|."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from spock_tpu import build, mpc
    from spock_tpu.models import server_heat
    from spock_tpu.parallel import mesh as pmesh
    from spock_tpu.solver import zero_dual, zero_primal

    spec = server_heat.make_spec(N=N, nx=NX, d=D)
    data, meta = build(spec, dtype=jnp.float32)
    n_dev = len(devices)
    Bf, steps = B * n_dev, 8
    rng = np.random.default_rng(2)
    x0 = jnp.asarray(rng.uniform(-0.6, 0.6, (Bf, NX)), jnp.float32)
    ws = jnp.asarray(rng.integers(0, D, (steps, Bf)))
    tol = jnp.asarray(TOL, jnp.float32)
    mesh = Mesh(np.asarray(devices), ("batch",))
    data_r = pmesh.replicate(data, mesh)
    ws_r = jax.device_put(ws, NamedSharding(mesh, P(None, "batch")))
    z0, v0 = zero_primal(meta, (Bf,)), zero_dual(meta, (Bf,))

    def sharded(x, z, v):
        return jax.block_until_ready(mpc.simulate_async(
            data_r, meta, pmesh.shard_batch(x, mesh), ws_r, tol,
            n_steps=steps, z0=pmesh.shard_batch(z, mesh),
            v0=pmesh.shard_batch(v, mesh), max_total_iters=ITER_CAP,
        ))

    def card0(x, z, v, lanes=slice(None)):
        x, z, v = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a)[lanes]), (x, z, v))
        return jax.block_until_ready(mpc.simulate_async(
            data, meta, x, ws[:, lanes], tol, n_steps=steps, z0=z, v0=v,
            max_total_iters=ITER_CAP,
        ))

    def done(res):
        sd = np.asarray(res.steps_done)
        if sd.min() != steps:
            raise AssertionError(f"fleet: a lane did {sd.min()} of {steps} steps")

    with Phase("fleet-cold-sharded", clock, card):
        res_s = sharded(x0, z0, v0)
    done(res_s)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devices]
    n_us = len(res_s.us.sharding.device_set)
    log(f"fleet sharded: B={Bf} over {n_dev} cards; us on {n_us} "
        f"devices, z.x on {len(res_s.z.x.sharding.device_set)}; "
        f"peak_bytes_in_use per card {peaks}")
    if n_us != n_dev:
        raise AssertionError("fleet: sharded result is not spread over cards")
    with Phase(f"fleet-cold-card0-{n_dev}x{B}", clock, card):
        parts = [card0(x0, z0, v0, slice(i * B, (i + 1) * B))
                 for i in range(n_dev)]
    with Phase(f"fleet-cold-card0-1x{Bf}", clock, card):
        res_l = card0(x0, z0, v0)
    for r in parts + [res_l]:
        done(r)
    us_s, us_l = np.asarray(res_s.us), np.asarray(res_l.us)
    us_q = np.concatenate([np.asarray(r.us) for r in parts], axis=1)
    e_all, e_first = max_err(us_s, us_l), max_err(us_s[0], us_l[0])
    witness = max_err(us_q, us_l)
    log(f"fleet cold, {steps} steps, every lane done: controls sharded vs "
        f"card0 1x{Bf} {e_all:.3e} (first step {e_first:.3e}, limit "
        f"{FLEET_BAND:g}); witness card0 {n_dev}x{B} vs 1x{Bf} {witness:.3e}"
        f" (first step {max_err(us_q[0], us_l[0]):.3e}); sharded vs card0 "
        f"{n_dev}x{B} {max_err(us_s, us_q):.3e}; max |u| "
        f"{float(np.max(np.abs(us_l))):.3e}")
    if not e_first <= FLEET_BAND:
        raise AssertionError(f"fleet: first cold step differs by {e_first:.3e}")
    if not e_all <= max(2.0 * witness, CONTROL_TOL):
        raise AssertionError(
            f"fleet: cold steps differ by {e_all:.3e}, witness {witness:.3e}")

    with Phase("fleet-warmup-sharded", clock, card):
        res = sharded(res_s.xs, res_s.z, res_s.v)
        res = sharded(res.xs, res.z, res.v)
    done(res)
    with Phase("fleet-warm-sharded", clock, card):
        res_s = sharded(res.xs, res.z, res.v)
    with Phase(f"fleet-warm-card0-1x{Bf}", clock, card):
        res_l = card0(res.xs, res.z, res.v)
    done(res_s)
    done(res_l)
    err = max_err(res_s.us, res_l.us)
    u_max = float(np.max(np.abs(np.asarray(res_l.us))))
    log(f"fleet warm, {steps} steps after {3 * steps} shared: controls "
        f"sharded vs card0 1x{Bf} {err:.3e} (limit {WARM_REL:g} x max |u| "
        f"{u_max:.3e})")
    if not err <= WARM_REL * u_max:
        raise AssertionError(f"fleet: warm controls differ by {err:.3e}")


def bigtree_problem(np):
    from spock_tpu.models import server_heat

    spec = server_heat.make_spec(N=N, nx=NX, d=3)
    x0 = np.random.default_rng(3).uniform(-0.6, 0.6, (1, NX))
    return spec, x0.astype(np.float32)


def bigtree_4(jax, jnp, np, devices, clock, card):
    """(b) node-sharded CP on a d=3 tree vs the unsharded solve on card 0.

    Both root-control vectors are printed in full.  The float64 native CP
    solver needs about 5.5 minutes on one CPU core for this tree, so its
    comparison is made off the card: tests/test_composed_path.py (marked
    slow) holds card 0's solver to it on the CPU."""
    from jax.sharding import Mesh

    from spock_tpu import build
    from spock_tpu.parallel import bigtree

    spec, x0 = bigtree_problem(np)
    data, meta = build(spec, dtype=jnp.float32)
    log(f"big tree: server_heat nx={NX} N={N} d=3 nodes={meta.tree.n}")
    with Phase("bigtree-sharded", clock, card):
        res_s, _ = bigtree.run_cp_sharded(
            data, meta, jnp.asarray(x0), tol=jnp.asarray(TOL, jnp.float32),
            max_iter=5000, mesh=Mesh(np.asarray(devices), ("node",)),
        )
        res_s = jax.block_until_ready(res_s)
    if not bool(res_s.converged[0]):
        raise AssertionError("big tree: the sharded solve did not converge")
    with Phase("bigtree-card0", clock, card):
        u_l, it_l = cold_solve(jax, np, data, meta, "cp", x0)
    u_s = np.asarray(res_s.z.u[:, :, 0], np.float64)
    e_sl = max_err(u_s, u_l)
    log(f"big tree: iterations sharded={int(res_s.iterations[0])} "
        f"card0={int(it_l[0])}; root controls sharded-vs-card0={e_sl:.3e}")
    log(f"big tree: root controls sharded {u_s[0].tolist()}")
    log(f"big tree: root controls card0 {u_l[0].tolist()}")
    if not e_sl <= CONTROL_TOL:
        raise AssertionError("big tree: sharded and card-0 controls differ")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    # The float64 references run on JAX's CPU device beside the card.
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    from spock_tpu.utils import compile_cache, profiling

    cache_dir = compile_cache.enable()
    import jax
    import jax.numpy as jnp
    import numpy as np

    devices = check_device(jax)
    card = profiling.card_info()
    d0 = devices[0]
    log(f"device: platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devices)} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"nvidia-smi name, power.limit: {card}")
    log(f"compile cache: {cache_dir}")
    clock = CompileClock(jax)

    if args.cards == 1:
        main_one(jax, jnp, np, clock, card)
    else:
        if len(devices) < 4:
            raise SystemExit(f"--cards 4 needs 4 GPUs, found {len(devices)}")
        fleet_4(jax, jnp, np, devices[:4], clock, card)
        bigtree_4(jax, jnp, np, devices[:4], clock, card)
    log(f"total compile_s={clock.secs:.3f}")
    print(last_line(devices), flush=True)


if __name__ == "__main__":
    main()
