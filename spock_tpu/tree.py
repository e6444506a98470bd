"""Scenario-tree topology for uniform branching factor, in closed form.

Layout note
-----------
The reference (``/root/reference/src/scenario_tree.jl:25-109``) stores the tree
as dictionaries ``child_mapping``/``anc_mapping`` plus per-node index records.
We instead exploit the *algebraic* structure of a uniform-branching tree
laid out stage-major with a **sibling-major order inside each stage**:

* node indices are 0-based; the root is node ``0``;
* stage ``t`` occupies the contiguous index range
  ``[stage_offset(t), stage_offset(t+1))`` with ``stage_offset(t) =
  (d**t - 1) // (d - 1)``;
* within stage ``t`` (t >= 1), the k-th children of all stage-(t-1) parents
  form one contiguous block: stage-local index ``k * m + i`` where ``m =
  stage_size(t-1)`` and ``i`` is the parent's stage-local index;
* the realization ("w") index of a node is its sibling index ``k``.

Consequence: *every* parent/child data movement is a contiguous slice or
reshape of the node axis — ``children-of-stage`` grouping is
``block.reshape(d, m)``, parent replication is ``concat([parents] * d)``.
No gathers, no strided access, and no [., n, d]-shaped temporaries with a
tiny minor dimension.

This ordering differs from the reference's interleaved one (reference:
child k of parent i at stage-local ``i*d + k`` — ``scenario_tree.jl:83-87``);
:meth:`UniformTree.perm_to_reference` gives the node permutation for
flat-layout interop (used by ``utils.refvec``).

All fields are plain Python ints so a :class:`UniformTree` can be used as a
static (hashable) argument of jitted functions.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class UniformTree:
    """Topology of a scenario tree with uniform branching factor ``d``.

    Mirrors the capability of ``generate_scenario_tree_uniform_branching_factor_v2``
    (``/root/reference/src/scenario_tree.jl:61-109``) without materializing any
    index maps.

    Attributes:
      N: number of stages (the root is stage 0; leaves are stage ``N - 1``).
         Matches the reference's ``N``.
      d: branching factor (>= 2).
    """

    N: int
    d: int

    def __post_init__(self):
        if self.d <= 1:
            raise ValueError(f"Branching factor d must be > 1, got {self.d}.")
        if self.N <= 1:
            raise ValueError(f"Horizon N must be > 1, got {self.N}.")

    # ---- node counts (cf. scenario_tree.jl:67-71) ----
    @property
    def n(self) -> int:
        """Total number of nodes, (d^N - 1) / (d - 1)."""
        return (self.d**self.N - 1) // (self.d - 1)

    @property
    def n_leaf(self) -> int:
        """Number of leaf nodes, d^(N-1)."""
        return self.d ** (self.N - 1)

    @property
    def n_nonleaf(self) -> int:
        """Number of non-leaf nodes, (d^(N-1) - 1)/(d - 1)."""
        return (self.d ** (self.N - 1) - 1) // (self.d - 1)

    @property
    def leaf_start(self) -> int:
        """Index of the first leaf node (0-based)."""
        return self.n_nonleaf

    # ---- stage structure (cf. min_index_per_timestep, scenario_tree.jl:107) ----
    def stage_offset(self, t: int) -> int:
        """Index of the first node of stage ``t`` (0-based, t in [0, N])."""
        return (self.d**t - 1) // (self.d - 1)

    def stage_size(self, t: int) -> int:
        return self.d**t

    def stage_slice(self, t: int) -> slice:
        return slice(self.stage_offset(t), self.stage_offset(t + 1))

    def stage_of(self, j: int) -> int:
        """Stage index of node ``j`` (host-side helper)."""
        t = 0
        while self.stage_offset(t + 1) <= j:
            t += 1
        return t

    # ---- closed-form maps (sibling-major within each stage) ----
    def parent(self, j: int) -> int:
        if j <= 0:
            raise ValueError("The root has no parent.")
        t = self.stage_of(j)
        loc = j - self.stage_offset(t)
        m = self.stage_size(t - 1)
        return self.stage_offset(t - 1) + loc % m

    def children(self, i: int) -> tuple:
        if i >= self.n_nonleaf:
            raise ValueError(f"Node {i} is a leaf; it has no children.")
        t = self.stage_of(i)
        loc = i - self.stage_offset(t)
        m = self.stage_size(t)
        base = self.stage_offset(t + 1)
        return tuple(base + k * m + loc for k in range(self.d))

    def w(self, j: int) -> int:
        """Realization index of non-root node ``j`` (which (A, B) pair was used
        on the edge parent(j) -> j) — the sibling-block index."""
        if j <= 0:
            raise ValueError("The root has no realization index.")
        t = self.stage_of(j)
        loc = j - self.stage_offset(t)
        return loc // self.stage_size(t - 1)

    # ---- interop with the reference's interleaved numbering ----
    def perm_to_reference(self):
        """perm[our_id] = reference_id (both 0-based, reference = child k of
        parent i at stage-local i*d + k).  Stage-major in both."""
        import numpy as np

        perm = np.zeros(self.n, dtype=np.int64)
        # map recursively: ref parent ids needed; build ours->ref per stage
        ours_to_ref_prev = {0: 0}
        for t in range(1, self.N):
            m = self.stage_size(t - 1)
            off, off_p = self.stage_offset(t), self.stage_offset(t - 1)
            cur = {}
            for k in range(self.d):
                for i in range(m):
                    ours = off + k * m + i
                    ref_parent_loc = ours_to_ref_prev[off_p + i] - off_p
                    ref = off + ref_parent_loc * self.d + k
                    cur[ours] = ref
                    perm[ours] = ref
            ours_to_ref_prev = cur
        return perm
