"""ctypes bindings for the native C++ CPU solver (native/spock_cpu.cpp).

The native tier plays the role of the reference's external baseline solvers
(Mosek/Ipopt/... via JuMP, ``model_mosek.jl``) but is self-contained: the
same splitting in double precision on one CPU core, with the offline
factorization supplied by the Python build step.  Covers the full feature
surface of the JAX engine's problem class: uniform or per-node risk
measures, per-dimension box bounds, and two-sided polytopic constraints
(round 5; uniform Q/R/QN remain required — per-node costs fall back to the
scipy/ADMM oracles).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import numpy as np

from .. import problem as prob
from ..risks import dual_cone
from ..tree import UniformTree

_KIND_CODE = {"zero": 0, "nonneg": 1, "nonpos": 2, "reals": 3, "soc": 4}


def _nonleaf_perm(t: UniformTree) -> np.ndarray:
    """perm[heap_idx] = python_idx over non-leaf nodes.

    The C++ solver walks the tree in heap order (children of node i are
    d*i+1+c, so within a stage: pos = parent_pos*d + c) while the Python
    tree is SIBLING-major within stages (pos = c*m_parent + parent_pos,
    tree.py:110-117).  Uniform data is order-invariant; per-node risk
    arrays must be permuted into the C++ ordering."""
    d = t.d
    perm = np.zeros(t.n_nonleaf, np.int64)
    for st in range(t.N - 1):
        off = t.stage_offset(st)
        if st == 0:
            perm[0] = 0
            continue
        m_par = t.stage_size(st - 1)
        for lp in range(m_par):
            for c in range(d):
                perm[off + lp * d + c] = off + c * m_par + lp
    return perm

_LIB = None
NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)


def ensure_built() -> str:
    """Path of ``libspock_cpu.so`` in ``NATIVE_DIR``, (re)built by
    ``build.sh`` when it is missing or older than ``spock_cpu.cpp``.  The
    library is never committed: it is compiled for the host that runs it."""
    so = os.path.join(NATIVE_DIR, "libspock_cpu.so")
    src = os.path.join(NATIVE_DIR, "spock_cpu.cpp")
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        subprocess.run(
            ["sh", os.path.join(NATIVE_DIR, "build.sh")], check=True,
            stdout=subprocess.DEVNULL,
        )
    return so


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(ensure_built())
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    argtypes = (
        [ctypes.c_int] * 5          # N d nx nu ny
        + [dp] * 7                  # A B sqrtQ sqrtR sqrtQN bvec ker
        + [ctypes.c_int]            # risk_per_node
        + [dp] * 4                  # Kfac Rtinv ABK PB
        + [dp] * 4                  # x_min x_max u_min u_max (vectors)
        + [ip, ip, ctypes.c_int]    # cones
        + [ctypes.c_int] + [dp] * 4  # nc Gx Gu plo phi
        + [ctypes.c_int] + [dp] * 3  # ncL GxN ploN phiN
        + [dp]                      # x0
        + [ctypes.c_double] * 3     # gamma sigma tol
        + [ctypes.c_long]           # max_iter
        + [dp, dp]                  # z v
    )
    lib.spock_cpu_solve_cp.restype = ctypes.c_long
    lib.spock_cpu_solve_cp.argtypes = argtypes
    lib.spock_cpu_solve_sp.restype = ctypes.c_long
    lib.spock_cpu_solve_sp.argtypes = argtypes
    _LIB = lib
    return lib


class NativeSolver:
    """Chambolle-Pock solve on the native CPU backend."""

    def __init__(self, spec: prob.Spec):
        t: UniformTree = spec.tree
        self.tree = t
        A = np.ascontiguousarray(spec.dynamics.A, dtype=np.float64)
        B = np.ascontiguousarray(spec.dynamics.B, dtype=np.float64)
        self.nx, self.nu = A.shape[-1], B.shape[-1]

        for name, arr in [("Q", spec.cost.Q), ("R", spec.cost.R), ("QN", spec.cost.QN)]:
            a = np.asarray(arr)
            if a.shape[0] != 1 and not np.all(a == a[:1]):
                raise NotImplementedError(
                    f"native backend: per-node {name} not supported"
                )
        E, F, b = spec.risk.E, spec.risk.F, spec.risk.b
        self.ny = b.shape[-1]
        self.risk_per_node = int(
            b.shape[0] != 1
            and not (
                np.all(E == E[:1]) and np.all(F == F[:1])
                and np.all(b == b[:1])
            )
        )

        self.sqrtQ = prob._sqrtm_psd(np.asarray(spec.cost.Q[:1], np.float64))[0]
        self.sqrtR = prob._sqrtm_psd(np.asarray(spec.cost.R[:1], np.float64))[0]
        self.sqrtQN = prob._sqrtm_psd(np.asarray(spec.cost.QN[:1], np.float64))[0]
        if self.risk_per_node:
            # [n_nl, ny] / [n_nl, m, m] with strided per-node access in C++,
            # permuted from the Python sibling-major order to heap order
            perm = _nonleaf_perm(t)
            self.b = np.ascontiguousarray(
                np.broadcast_to(b, (t.n_nonleaf, self.ny))[perm], np.float64
            )
            self.ker = np.ascontiguousarray(
                prob._kernel_projectors(spec.risk, t.d, uniform=False)[perm],
                np.float64,
            )
        else:
            self.b = np.ascontiguousarray(b[0], np.float64)
            self.ker = np.ascontiguousarray(
                prob._kernel_projectors(
                    type(spec.risk)(
                        E=E[:1], F=F[:1], b=b[:1], cone=spec.risk.cone
                    ),
                    t.d,
                    uniform=True,
                )[0],
                np.float64,
            )
        ric = prob._riccati_offline(t, A, B, uniform=True)
        self.Kfac = np.ascontiguousarray(np.stack([k[0] for k in ric.K]))
        self.Rtinv = np.ascontiguousarray(np.stack([r[0] for r in ric.Rtinv]))
        self.ABK = np.ascontiguousarray(np.stack([a[0] for a in ric.ABK]))
        self.PB = np.ascontiguousarray(np.stack([a[0] for a in ric.PB]))
        self.A, self.B = A, B

        dc = dual_cone(spec.risk.cone)
        self.cone_kinds = np.asarray(
            [_KIND_CODE[k] for k, _ in dc], np.int32
        )
        self.cone_dims = np.asarray([d_ for _, d_ in dc], np.int32)

        cst = spec.constraints
        bvecs = lambda a, dim: np.ascontiguousarray(
            np.broadcast_to(np.asarray(a, np.float64), (dim,))
        )
        self.x_min = bvecs(cst.x_min, self.nx)
        self.x_max = bvecs(cst.x_max, self.nx)
        self.u_min = bvecs(cst.u_min, self.nu)
        self.u_max = bvecs(cst.u_max, self.nu)

        # two-sided polytopes (dual rows appended to v)
        poly = spec.polytope
        c64 = lambda a: np.ascontiguousarray(a, np.float64)
        if poly is not None and poly.Gx is not None:
            self.Gx, self.Gu = c64(poly.Gx), c64(poly.Gu)
            self.plo, self.phi = c64(poly.lo), c64(poly.hi)
            self.nc = self.Gx.shape[0]
        else:
            self.Gx = self.Gu = self.plo = self.phi = np.zeros(0)
            self.nc = 0
        if poly is not None and poly.GxN is not None:
            self.GxN = c64(poly.GxN)
            self.ploN, self.phiN = c64(poly.loN), c64(poly.hiN)
            self.ncL = self.GxN.shape[0]
        else:
            self.GxN = self.ploN = self.phiN = np.zeros(0)
            self.ncL = 0

        # ||L||^2 from the JAX power iteration would need device code; use a
        # numpy power iteration on the same operator instead.
        self.L_sq = self._power_iteration()

        self.nz = (
            t.n * self.nx
            + t.n_nonleaf * self.nu
            + t.n
            + (t.n - 1)
            + t.n_nonleaf * self.ny
        )
        self.nv = (
            t.n_nonleaf * self.ny
            + t.n_nonleaf
            + (t.n - 1) * (self.nx + self.nu + 2)
            + t.n_nonleaf * (self.nx + self.nu)
            + t.n_leaf * (2 * self.nx + 2)
            + t.n_nonleaf * self.nc
            + t.n_leaf * self.ncL
        )
        self.z = np.zeros(self.nz)
        self.v = np.zeros(self.nv)

    def _power_iteration(self, iters: int = 60) -> float:
        """numpy estimate of ||L||^2 (same math as ops.linop.estimate_L_sq)."""
        t = self.tree
        rng = np.random.default_rng(0)
        nx, nu, ny, d = self.nx, self.nu, self.ny, t.d
        x = rng.standard_normal((t.n, nx))
        u = rng.standard_normal((t.n_nonleaf, nu))
        s = rng.standard_normal(t.n)
        tau = rng.standard_normal(t.n - 1)
        y = rng.standard_normal((t.n_nonleaf, ny))
        lam = 1.0
        for _ in range(iters):
            # L
            xp = np.repeat(x[: t.n_nonleaf], d, axis=0)
            up = np.repeat(u, d, axis=0)
            bmat = (
                self.b if self.risk_per_node
                else np.broadcast_to(self.b, (t.n_nonleaf, ny))
            )
            v1 = y
            v2 = s[: t.n_nonleaf] - np.sum(y * bmat, axis=-1)
            v3 = xp @ self.sqrtQ.T
            v4 = up @ self.sqrtR.T
            v5 = v6 = 0.5 * tau
            v7x, v7u = x[: t.n_nonleaf], u
            v11 = x[t.leaf_start :] @ self.sqrtQN.T
            v12 = v13 = 0.5 * s[t.leaf_start :]
            v14 = x[t.leaf_start :]
            vp = vpN = None
            if self.nc:
                vp = x[: t.n_nonleaf] @ self.Gx.T + u @ self.Gu.T
            if self.ncL:
                vpN = x[t.leaf_start :] @ self.GxN.T
            # L'
            xn = v7x + (v3 @ self.sqrtQ).reshape(t.n_nonleaf, d, nx).sum(1)
            xl = v14 + v11 @ self.sqrtQN
            un = v7u + (v4 @ self.sqrtR).reshape(t.n_nonleaf, d, nu).sum(1)
            if self.nc:
                xn = xn + vp @ self.Gx
                un = un + vp @ self.Gu
            if self.ncL:
                xl = xl + vpN @ self.GxN
            yn = v1 - bmat * v2[:, None]
            taun = 0.5 * (v5 + v6)
            sn = np.concatenate([v2, 0.5 * (v12 + v13)])
            w = (np.concatenate([xn, xl]), un, sn, taun, yn)
            nrm_sq = sum(float(np.sum(a * a)) for a in w)
            dot = (
                float(np.sum(w[0] * x))
                + float(np.sum(w[1] * u))
                + float(np.sum(w[2] * s))
                + float(np.sum(w[3] * tau))
                + float(np.sum(w[4] * y))
            )
            denom = (
                float(np.sum(x * x))
                + float(np.sum(u * u))
                + float(np.sum(s * s))
                + float(np.sum(tau * tau))
                + float(np.sum(y * y))
            )
            lam = dot / max(denom, 1e-30)
            nrm = np.sqrt(max(nrm_sq, 1e-30))
            x, u, s, tau, y = (a / nrm for a in w)
        return lam * 1.02

    def solve(
        self,
        x0,
        tol: float = 1e-3,
        max_iter: int = 5000,
        warm_start: bool = True,
        algorithm: str = "cp",
    ):
        """Returns dict(x, u, s, tau, y, iterations, converged).  z/v persist
        across calls (implicit warm start, like the reference).
        algorithm: "cp" or "spock" (SuperMann + Anderson)."""
        lib = _lib()
        t = self.tree
        if not warm_start:
            self.z[:] = 0.0
            self.v[:] = 0.0
        step = 0.99 / np.sqrt(self.L_sq)
        x0 = np.ascontiguousarray(x0, np.float64)
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int32)
        as_dp = lambda a: a.ctypes.data_as(dp)
        fn = (
            lib.spock_cpu_solve_sp
            if algorithm == "spock"
            else lib.spock_cpu_solve_cp
        )
        it = fn(
            t.N,
            t.d,
            self.nx,
            self.nu,
            self.ny,
            as_dp(self.A),
            as_dp(self.B),
            as_dp(np.ascontiguousarray(self.sqrtQ)),
            as_dp(np.ascontiguousarray(self.sqrtR)),
            as_dp(np.ascontiguousarray(self.sqrtQN)),
            as_dp(self.b),
            as_dp(self.ker),
            self.risk_per_node,
            as_dp(self.Kfac),
            as_dp(self.Rtinv),
            as_dp(self.ABK),
            as_dp(self.PB),
            as_dp(self.x_min),
            as_dp(self.x_max),
            as_dp(self.u_min),
            as_dp(self.u_max),
            self.cone_kinds.ctypes.data_as(ip),
            self.cone_dims.ctypes.data_as(ip),
            len(self.cone_dims),
            self.nc,
            as_dp(self.Gx),
            as_dp(self.Gu),
            as_dp(self.plo),
            as_dp(self.phi),
            self.ncL,
            as_dp(self.GxN),
            as_dp(self.ploN),
            as_dp(self.phiN),
            as_dp(x0),
            step,
            step,
            tol,
            max_iter,
            as_dp(self.z),
            as_dp(self.v),
        )
        converged = it >= 0
        iters = it if converged else -1 - it
        nx, nu, ny = self.nx, self.nu, self.ny
        ox, ou = 0, t.n * nx
        os_, ot = ou + t.n_nonleaf * nu, ou + t.n_nonleaf * nu + t.n
        oy = ot + t.n - 1
        return {
            "x": self.z[ox:ou].reshape(t.n, nx).copy(),
            "u": self.z[ou:os_].reshape(t.n_nonleaf, nu).copy(),
            "s": self.z[os_:ot].copy(),
            "tau": self.z[ot:oy].copy(),
            "y": self.z[oy:].reshape(t.n_nonleaf, ny).copy(),
            "iterations": iters,
            "converged": converged,
            "objective": float(self.z[os_]),
        }
