"""spock_tpu — a batched JAX engine for multistage risk-averse optimal control
on scenario trees.

A from-scratch JAX/XLA re-design of the capability surface of
``kul-optec/spock.jl``: scenario trees with uniform branching, linear
tree-indexed dynamics, quadratic costs, conic risk measures (AV@R, total
variation, ...), box constraints, solved by a Chambolle-Pock primal-dual
iteration optionally accelerated by SuperMann + Anderson (the SPOCK
algorithm).  Designed batch-first: thousands of independent MPC solves per
device, sharded over a device mesh.
"""

import os as _os

import jax as _jax

# Full-f32 matmuls framework-wide.  On a GPU the DEFAULT precision lets XLA
# run float32 dots in TF32 (~10 mantissa bits): the solver's fixed-point
# residual then floors near the 1e-3 tolerance, and warm-started lanes whose
# termination threshold is the absolute tol can stall at that floor.
# "highest" keeps f32 dots in full float32; the products here are small
# (feature dims of tens), so little is given up.
# Override with SPOCK_MATMUL_PRECISION=default|float32|highest if needed.
_jax.config.update(
    "jax_default_matmul_precision",
    _os.environ.get("SPOCK_MATMUL_PRECISION", "highest"),
)

from . import mpc, problem, risks, solver, zv  # noqa: F401
from .algorithms.common import SolveResult  # noqa: F401
from .algorithms.supermann import SuperMannOpts  # noqa: F401
from .problem import Box, Cost, Dynamics, Polytope, Spec, build  # noqa: F401
from .solver import Solver  # noqa: F401
from .tree import UniformTree  # noqa: F401

__version__ = "0.1.0"
