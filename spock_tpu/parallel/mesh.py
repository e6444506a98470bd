"""Multi-chip / multi-host scaling of batched solves.

The reference is single-process single-thread (SURVEY.md §2.2); this
package's distribution model is:

* **dp axis ("batch")** — independent MPC solves sharded across chips.  Each
  lane's solve state never leaves its shard; the only cross-chip traffic is
  the all-lanes-done reduction inside the termination while_loop, which XLA
  lowers to an all-reduce (NCCL over NVLink on GPUs) automatically under jit-with-shardings.
* **node axis** — for single trees too large for one chip, the stage-major
  node dimension of every iterate is sharded over a "node" mesh axis
  (:func:`shard_nodes`): the dominant leaf-heavy stages split across
  devices, elementwise prox/update work stays fully local, and the
  stage-boundary slices/reshapes of the sibling-major layout lower to XLA
  collective-permutes/all-gathers of the (small) early stages only.  The
  solver keeps iterates node-sharded through the iteration loop via
  ``with_sharding_constraint`` (:func:`node_constrainer`).

Multi-host: call :func:`init_distributed` once per process, then build the
mesh over ``jax.devices()`` as usual — XLA inserts the cross-host
collectives where the mesh spans hosts.  Every device reaches every other,
so meshes are 1-D and follow the algorithm, not a network topology.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Initialize JAX's multi-host runtime (no-op when single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def batch_sharding(mesh: Mesh, axis: str = "batch") -> NamedSharding:
    """Sharding that splits the leading (lane) dim of an array."""
    return NamedSharding(mesh, P(axis))


def shard_batch(tree, mesh: Mesh, axis: str = "batch"):
    """Place every leaf of a batched pytree with its lane dim sharded."""

    def place(a):
        spec = P(axis, *([None] * (a.ndim - 1)))
        return jax.device_put(a, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(place, tree)


def replicate(tree, mesh: Mesh):
    """Replicate problem data on every device of the mesh."""

    def place(a):
        return jax.device_put(a, NamedSharding(mesh, P()))

    return jax.tree_util.tree_map(place, tree)


# ---------------------------------------------------------------------------
# node-axis (big-tree) sharding
# ---------------------------------------------------------------------------


def _node_spec(a, mesh: Mesh, node_axis: str, batch_axis: Optional[str],
               min_nodes: int) -> P:
    """PartitionSpec for one iterate leaf: node axis (LAST dim) sharded when
    divisible by the mesh axis size; leading lane dim optionally dp-sharded."""
    ndev = mesh.shape[node_axis]
    axes = [None] * a.ndim
    if batch_axis is not None and a.ndim >= 1:
        axes[0] = batch_axis
    # GSPMD needs even divisibility; tree-stage node counts are d^k, so big
    # trees go through parallel.bigtree's padded layout first.  Undivisible
    # or tiny leaves stay replicated.
    if (
        a.ndim >= 1
        and a.shape[-1] >= max(min_nodes, ndev)
        and a.shape[-1] % ndev == 0
    ):
        axes[-1] = node_axis
    return P(*axes)


def shard_nodes(tree, mesh: Mesh, node_axis: str = "node",
                batch_axis: Optional[str] = None, min_nodes: int = 2):
    """Place iterate pytrees (Primal/Dual/x0/...) with the trailing node axis
    sharded over ``mesh[node_axis]`` (and optionally the leading lane axis
    over ``batch_axis``).  Leaves whose node count is too small or not
    divisible stay replicated along that axis — the early tree stages are
    tiny; all the memory is in the last stages, which always divide for
    d % ndev == 0 or ndev | d^k."""

    def place(a):
        return jax.device_put(
            a, NamedSharding(mesh, _node_spec(a, mesh, node_axis, batch_axis,
                                              min_nodes))
        )

    return jax.tree_util.tree_map(place, tree)


def node_constrainer(mesh: Mesh, node_axis: str = "node",
                     batch_axis: Optional[str] = None, min_nodes: int = 2):
    """Returns ``constrain(tree) -> tree`` applying with_sharding_constraint
    with the :func:`shard_nodes` layout — hook it into the solver loop
    (``Solver(..., constrain=...)`` / ``run_cp(..., constrain=...)``) so XLA
    keeps iterates node-sharded across iterations instead of silently
    all-gathering."""

    def constrain(tree):
        return jax.tree_util.tree_map(
            lambda a: jax.lax.with_sharding_constraint(
                a,
                NamedSharding(
                    mesh, _node_spec(a, mesh, node_axis, batch_axis, min_nodes)
                ),
            ),
            tree,
        )

    return constrain
