"""The plain jnp/lax solver path end to end, and the entry-point helpers
around it: composed CP and SPOCK solves against the float64 native oracle
across the problem classes the solver supports, per-node costs against the
scipy oracle, backtracking, the polytope MPC farm, the compile-cache and
native-library helpers, and the GPU smoke script's refusal on a CPU."""

import dataclasses as dc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spock_tpu import build, mpc, problem, risks
from spock_tpu.algorithms import supermann as sp_alg
from spock_tpu.algorithms.common import candidate_sweep, cp_sweep_metric
from spock_tpu.baselines import native, scipy_ref
from spock_tpu.models import car, server_heat
from spock_tpu.ops.linop import metric_apply
from spock_tpu.solver import Solver, zero_dual, zero_primal
from spock_tpu.utils import compile_cache, profiling
from tests.test_core_ops import rand_dual, rand_primal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _polytope_spec():
    spec = server_heat.make_spec(N=4, nx=4, d=2)
    Gx = np.array([[1.0, 0.5, 0.0, 0.0], [0.0, 0.0, 1.0, -0.3]])
    poly = problem.Polytope(
        Gx=Gx,
        Gu=np.array([[0.2, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.1]]),
        lo=np.array([-1.5, -1.0]),
        hi=np.array([1.5, 1.0]),
        GxN=Gx[:1],
        loN=np.array([-1.2]),
        hiN=np.array([1.2]),
    )
    return dc.replace(spec, polytope=poly)


def _nonuniform_spec():
    spec = server_heat.make_spec(N=4, nx=4, d=2)
    n_nl = spec.tree.n_nonleaf
    rng = np.random.default_rng(13)
    ps = rng.dirichlet(np.ones(2), size=n_nl)
    alphas = rng.uniform(0.7, 0.99, n_nl)
    return dc.replace(spec, risk=risks.avar_nonuniform(ps, alphas))


def _case(which):
    """(spec, [2, nx] initial states) of one problem class."""
    if which == "server_heat":
        spec = server_heat.make_spec(N=4, nx=4, d=2)
    elif which == "car":
        spec = car.make_spec(N=4, d=2)
    elif which == "d3":
        spec = server_heat.make_spec(N=3, nx=3, d=3)
    elif which == "polytope":
        spec = _polytope_spec()
    else:
        spec = _nonuniform_spec()
    nx = spec.dynamics.A.shape[-1]
    x0 = np.random.default_rng(5).uniform(-0.5, 0.5, (2, nx))
    return spec, x0


@pytest.mark.parametrize("algorithm", ["cp", "spock"])
@pytest.mark.parametrize(
    "which", ["server_heat", "car", "d3", "polytope", "nonuniform"]
)
def test_composed_solve_matches_native_oracle(which, algorithm):
    """Two lanes, float64, tol 1e-7: root controls and objective within
    2e-4 of the native C++ solver run to 1e-9."""
    spec, x0 = _case(which)
    data, meta = build(spec, dtype=jnp.float64)
    res = Solver(data, meta, algorithm=algorithm, max_iter=40_000).solve(
        x0, tol=1e-7
    )
    assert bool(jnp.all(res.converged))
    nat = native.NativeSolver(spec)
    for i in range(2):
        ref = nat.solve(x0[i], tol=1e-9, max_iter=60_000,
                        algorithm="spock", warm_start=False)
        assert ref["converged"]
        np.testing.assert_allclose(
            np.asarray(res.z.u)[i, :, 0], ref["u"][0], atol=2e-4
        )
        np.testing.assert_allclose(
            float(res.z.s[i, 0]), ref["objective"], atol=2e-4
        )


def _per_node_cost_spec():
    spec = server_heat.make_spec(N=3, nx=3, d=2)
    t = spec.tree
    rng = np.random.default_rng(31)

    def spd(n_nodes, dim, base):
        out = base * rng.uniform(0.5, 2.0, (n_nodes, 1, 1)) * np.eye(dim)
        out += rng.uniform(-0.02, 0.02, (n_nodes, dim, dim))
        return 0.5 * (out + out.transpose(0, 2, 1)) + 0.1 * np.eye(dim)

    cost = problem.Cost(
        Q=spd(t.n - 1, 3, 0.1), R=spd(t.n - 1, 3, 1.0), QN=spd(t.n_leaf, 3, 0.1)
    )
    return dc.replace(spec, cost=cost)


@pytest.mark.parametrize("algorithm", ["cp", "spock"])
def test_per_node_costs_match_scipy_oracle(algorithm):
    """Per-node Q/R/QN (the native oracle refuses them) against SLSQP."""
    spec = _per_node_cost_spec()
    with pytest.raises(NotImplementedError):
        native.NativeSolver(spec)
    data, meta = build(spec, dtype=jnp.float64)
    assert data.sqrtQ.shape[0] == spec.tree.n - 1
    x0 = np.array([0.5, -0.4, 0.3])
    res = Solver(data, meta, algorithm=algorithm, max_iter=40_000).solve(
        x0, tol=1e-7
    )
    assert bool(res.converged)
    ora = scipy_ref.solve(spec, x0=x0)
    np.testing.assert_allclose(np.asarray(res.z.u)[:, 0], ora["u"][0],
                               atol=3e-4)
    np.testing.assert_allclose(float(res.z.s[0]), ora["objective"], atol=3e-4)


def test_backtracking_solve_matches_oracle():
    """Some iterations of this solve run the geometric backtracking loop
    (record=True hist column 2 counts its trials), and the result still
    matches the oracle."""
    spec = server_heat.make_spec(N=4, nx=4, d=2)
    data, meta = build(spec, dtype=jnp.float64)
    x0 = np.array([[0.4, -0.3, 0.5, 0.2], [-0.6, 0.5, 0.1, -0.2]])
    res = sp_alg.run_supermann(
        data, meta, jnp.asarray(x0), zero_primal(meta, (2,), jnp.float64),
        zero_dual(meta, (2,), jnp.float64), tol=jnp.asarray(1e-7),
        max_iter=3000, record=True,
    )
    assert bool(jnp.all(res.status == 0))
    hist = np.asarray(res.residuals)
    assert (hist[:, :, 2] > 0).any()
    nat = native.NativeSolver(spec)
    for i in range(2):
        ref = nat.solve(x0[i], tol=1e-9, max_iter=60_000, algorithm="spock",
                        warm_start=False)
        np.testing.assert_allclose(
            np.asarray(res.z.u)[i, :, 0], ref["u"][0], atol=2e-4
        )


def test_polytope_farm_equals_standalone_warm_solves():
    """One lane of the async farm on a polytope problem against the same
    receding-horizon chain solved step by step with warm-started Solver
    calls."""
    spec = _polytope_spec()
    data, meta = build(spec, dtype=jnp.float64)
    T, tol = 3, 1e-8
    x0 = np.array([[0.4, -0.3, 0.5, 0.2]])
    ws = np.array([[1], [0], [1]])
    farm = mpc.simulate_async(data, meta, jnp.asarray(x0), jnp.asarray(ws),
                              tol=tol, n_steps=T)
    assert int(farm.steps_done[0]) == T
    solver = Solver(data, meta, algorithm="spock")
    x, z, v = x0, None, None
    A, Bm = spec.dynamics.A, spec.dynamics.B
    for k in range(T):
        res = solver.solve(x, z0=z, v0=v, tol=tol)
        assert bool(res.converged[0])
        u = np.asarray(res.z.u)[0, :, 0]
        np.testing.assert_allclose(np.asarray(farm.us)[k, 0], u, atol=1e-5)
        w = ws[k, 0]
        x = (A[w] @ x[0] + Bm[w] @ u)[None]
        z, v = res.z, res.v
    np.testing.assert_allclose(np.asarray(farm.xs), x, atol=1e-5)


def test_sharded_farm_equals_per_device_batches():
    """On the CPU the lane-sharded async farm gives each lane what a
    one-device farm of the per-device batch gives it, bit for bit (on GPUs
    the partitioned program's arithmetic differs in the last bits, and
    chip_smoke.py --cards 4 compares against a witness instead)."""
    from spock_tpu.parallel import mesh as pmesh

    data, meta = build(server_heat.make_spec(N=4, nx=4, d=2),
                       dtype=jnp.float32)
    n_dev, per, T = 4, 2, 4
    rng = np.random.default_rng(8)
    x0 = jnp.asarray(rng.uniform(-0.6, 0.6, (n_dev * per, 4)), jnp.float32)
    ws = jnp.asarray(rng.integers(0, 2, (T, n_dev * per)))
    m = pmesh.make_mesh(n_dev)
    res = mpc.simulate_async(pmesh.replicate(data, m), meta,
                             pmesh.shard_batch(x0, m), ws, tol=1e-3,
                             n_steps=T)
    assert len(res.us.sharding.device_set) == n_dev
    parts = [mpc.simulate_async(data, meta, x0[i * per:(i + 1) * per],
                                ws[:, i * per:(i + 1) * per], tol=1e-3,
                                n_steps=T) for i in range(n_dev)]
    np.testing.assert_array_equal(
        np.asarray(res.steps_done),
        np.concatenate([np.asarray(p.steps_done) for p in parts]))
    np.testing.assert_allclose(
        np.asarray(res.us),
        np.concatenate([np.asarray(p.us) for p in parts], axis=1),
        atol=1e-6)


def test_candidate_sweep_at_zero_step_is_the_sweep():
    """candidate_sweep at tau = 0 evaluates the plain sweep at (z, v), and a
    hoisted M d gives the same result as one computed inside."""
    data, meta = build(server_heat.make_spec(N=3, nx=3, d=2),
                       dtype=jnp.float64)
    rng = np.random.default_rng(2)
    B = 3
    z, v = rand_primal(rng, meta, (B,)), rand_dual(rng, meta, (B,))
    dz, dv = rand_primal(rng, meta, (B,)), rand_dual(rng, meta, (B,))
    x0 = jnp.asarray(rng.uniform(-0.5, 0.5, (B, meta.nx)))
    g = s = 0.3
    base = cp_sweep_metric(data, meta, z, v, g, s, x0)
    cand = candidate_sweep(data, meta, z, v, dz, dv, jnp.zeros(B), g, s, x0)
    hoisted = candidate_sweep(data, meta, z, v, dz, dv, jnp.zeros(B), g, s,
                              x0, Md=metric_apply(data, meta, dz, dv, g, s))
    for a, b in zip(jax.tree_util.tree_leaves(base),
                    jax.tree_util.tree_leaves(cand[:7])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
    for a, b in zip(jax.tree_util.tree_leaves(cand),
                    jax.tree_util.tree_leaves(hoisted)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_solve_imports_no_pallas():
    """The package holds no Pallas code, and a full solve loads none."""
    for root, _, files in os.walk(os.path.join(REPO, "spock_tpu")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert "pallas" not in fh.read(), f
    code = (
        "import sys, numpy as np, jax.numpy as jnp\n"
        "from spock_tpu import build, Solver\n"
        "from spock_tpu.models import car\n"
        "d, m = build(car.make_spec(N=3, d=2), dtype=jnp.float32)\n"
        "r = Solver(d, m).solve(np.array([0.1, 0.1]), tol=1e-3)\n"
        "assert bool(r.converged)\n"
        "print(sorted(k for k in sys.modules if 'pallas' in k))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_compile_cache_respects_env(monkeypatch):
    monkeypatch.setenv(compile_cache.ENV, "/somewhere/else")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_refuses_cpu_backend():
    assert jax.default_backend() == "cpu"
    with pytest.raises(SystemExit) as exc:
        _chip_smoke().check_device(jax)
    assert exc.value.code not in (0, None)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_last_line_has_exactly_the_contract_keys():
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    line = _chip_smoke().last_line([dev])
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100", "count": 1},
    }


@pytest.mark.skipif(
    os.environ.get("SPOCK_SLOW_TESTS") != "1",
    reason="d=3 native oracle run (~6 min); set SPOCK_SLOW_TESTS=1",
)
def test_bigtree_d3_cp_matches_native():
    """chip_smoke.py --cards 4 (b)'s tree at full size: the float32 CP solve
    that its node-sharded solve is held to, against the float64 native CP
    solver at the same tolerance."""
    spec, x0 = _chip_smoke().bigtree_problem(np)
    data, meta = build(spec, dtype=jnp.float32)
    res = Solver(data, meta, algorithm="cp").solve(x0, tol=1e-3)
    assert bool(res.converged[0])
    ref = native.NativeSolver(spec).solve(
        np.asarray(x0[0], np.float64), tol=1e-3, max_iter=50_000,
        algorithm="cp", warm_start=False)
    assert ref["converged"]
    np.testing.assert_allclose(np.asarray(res.z.u)[0, :, 0], ref["u"][0],
                               atol=1e-4)


def test_dryrun_multichip_refuses_too_few_devices():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert len(jax.devices()) == 8
    with pytest.raises(RuntimeError, match="needs 16 devices"):
        mod.dryrun_multichip(16)


def test_native_library_rebuilds_when_source_is_newer(tmp_path, monkeypatch):
    for f in ("build.sh", "spock_cpu.cpp"):
        shutil.copy(os.path.join(native.NATIVE_DIR, f), tmp_path / f)
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    so = native.ensure_built()
    assert so == str(tmp_path / "libspock_cpu.so") and os.path.exists(so)
    src = str(tmp_path / "spock_cpu.cpp")
    # library newer than its source: left alone
    os.utime(src, (1_000_000, 1_000_000))
    os.utime(so, (2_000_000, 2_000_000))
    native.ensure_built()
    assert os.path.getmtime(so) == 2_000_000
    # source edited after the build: rebuilt
    os.utime(src, (3_000_000, 3_000_000))
    native.ensure_built()
    assert os.path.getmtime(so) > 3_000_000


def test_trace_device_stats_reads_a_recorded_trace(tmp_path, monkeypatch):
    """The reduction run on a CPU trace: its host plane's XLA lines stand
    in for a GPU plane's stream lines."""
    f = jax.jit(lambda x: jnp.sin(x) @ x + 1.0)
    x = jnp.ones((32, 32))
    f(x).block_until_ready()
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            f(x).block_until_ready()
    monkeypatch.setattr(profiling, "DEVICE_PLANE_PREFIX", "/host:CPU")
    monkeypatch.setattr(profiling, "KERNEL_LINE", "XLA")
    st = profiling.trace_device_stats(str(tmp_path))
    plane = st["planes"]["/host:CPU"]
    assert st["events"] == plane["events"] > 0
    assert 0 < plane["busy_ns"] <= plane["event_ns"]
    assert plane["busy_ns"] <= plane["window_ns"]
    assert st["top_ns"]
