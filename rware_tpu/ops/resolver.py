"""Vectorized collision resolver — the "masked-commit" kernel.

The reference resolves simultaneous movement by building a fresh networkx
DiGraph every step and running ``weakly_connected_components`` /
``find_cycle`` / ``dag_longest_path`` per component
(``/root/reference/rware/warehouse.py:821-876``).  That is inherently
sequential, allocation-heavy Python.

This module re-derives the same semantics from the structure of the problem:
each occupied cell has **out-degree exactly one** (the move requested by the
agent standing on it), so the movement graph is a *functional graph*.  Every
weakly-connected component therefore contains exactly one terminus — either a
single directed cycle or a single empty "sink" cell — which lets all of the
reference's graph algorithms collapse into O(N) iterations of O(N^2)
element-wise/boolean tensor ops (N = number of agents, <= a few dozen).  The
whole resolver is branch-free, shape-static, `vmap`-able over thousands of
environments and fuses into the surrounding XLA program.

Semantics reproduced exactly (validated by the golden tests):
  * agents whose action keeps them in place (rotations, toggles, NOOPs,
    wall-clamped forwards, pre-cancelled moves) form self-loops: length-1
    cycles that always commit (rware/warehouse.py:844,854);
  * a component containing a length-2 cycle (head-on swap) commits **nobody**
    (rware/warehouse.py:855-858);
  * a component containing any other cycle commits exactly the agents on the
    cycle (rware/warehouse.py:859-863);
  * an acyclic component commits exactly the agents on the longest chain into
    its sink cell (rware/warehouse.py:864-869).  Ties between equal-length
    chains merging at a cell are broken toward the lowest agent index, which
    matches networkx's first-max rule for edges inserted in agent order (the
    reference's tie order is otherwise arbitrary — see SURVEY.md §2 #8).

Everything else (who failed => NOOP) is handled by the caller.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _take(arr: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather tolerating -1 indices (clipped; caller masks by idx >= 0)."""
    return jnp.take(arr, jnp.maximum(idx, 0), axis=0)


def resolve_moves(
    start_x: jax.Array,
    start_y: jax.Array,
    target_x: jax.Array,
    target_y: jax.Array,
) -> jax.Array:
    """Decide which agents' requested moves commit.

    Args:
      start_x, start_y: (N,) int32 current agent cells (all distinct).
      target_x, target_y: (N,) int32 requested cells; equal to start for any
        agent not attempting a translation.

    Returns:
      (N,) bool — True for agents whose request commits.  Agents with
      target == start always commit unless their component is poisoned by a
      head-on swap (which, by the one-terminus property, cannot happen: a
      self-loop is itself a terminus, so it can never share a component with
      a 2-cycle).
    """
    n = start_x.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)

    # -- successor pointers: next[i] = agent standing on my target cell, or -1.
    # (N, N) match[i, j] = target_i == start_j.  Starts are distinct so each
    # row has at most one hit.
    match = (target_x[:, None] == start_x[None, :]) & (
        target_y[:, None] == start_y[None, :]
    )
    has_next = jnp.any(match, axis=1)
    nxt = jnp.where(has_next, jnp.argmax(match, axis=1).astype(jnp.int32), -1)

    # -- cycle membership: follow successor pointers N steps; i is on a cycle
    # iff the walk returns to i.  Self-loops (next[i] == i) are length-1 cycles.
    def cycle_body(_, carry):
        cur, on_cycle = carry
        on_cycle = on_cycle | (cur == idx)
        cur = jnp.where(cur >= 0, _take(nxt, cur), -1)
        return cur, on_cycle

    # Unrolled: n is the (small, static) agent count; straight-line code
    # lets XLA fuse the whole resolver into the surrounding step program
    # instead of emitting while-loops.
    _, on_cycle = jax.lax.fori_loop(
        0, n, cycle_body, (nxt, jnp.zeros(n, dtype=bool)), unroll=True
    )

    # -- head-on swaps: i <-> j with i != j.
    two_cycle = has_next & (nxt != idx) & (_take(nxt, nxt) == idx)

    # -- weak-component closure over agents.  Two agents are adjacent iff their
    # edges share a cell: next-pointer either way, or a shared target cell.
    shared_target = (target_x[:, None] == target_x[None, :]) & (
        target_y[:, None] == target_y[None, :]
    )
    nxt_edge = match  # match[i, j] == (nxt[i] == j) where has_next
    adj = shared_target | nxt_edge | nxt_edge.T | jnp.eye(n, dtype=bool)
    # Transitive closure by repeated squaring: O(log N) boolean matmuls.
    doublings = max(1, (n - 1).bit_length())
    for _ in range(doublings):
        adj = adj | jnp.einsum("ik,kj->ij", adj, adj)

    comp_poisoned = jnp.any(adj & two_cycle[None, :], axis=1)
    comp_has_cycle = jnp.any(adj & on_cycle[None, :], axis=1)

    # -- cycle rule: commit exactly on-cycle agents, unless the component's
    # cycle is a head-on swap (then the whole component fails).
    committed_cycle = on_cycle & ~comp_poisoned

    # -- chain rule (acyclic components): commit the longest chain into the
    # sink.  depth[i] = longest chain of agents ending at i (inclusive).
    pred = match.T  # pred[j, i] = True iff nxt[i] == j ... transposed: pred[i, j] = nxt[j] == i

    def depth_body(_, depth):
        # depth'[i] = 1 + max_{j : nxt[j] == i} depth[j]   (0 if no preds)
        best_in = jnp.max(jnp.where(pred, depth[None, :], 0), axis=1)
        return 1 + best_in

    depth = jax.lax.fori_loop(
        0, n, depth_body, jnp.ones(n, dtype=jnp.int32), unroll=True
    )

    # chosen[i]: i is the winning predecessor of its target cell — the
    # max-depth agent among all agents sharing the target, lowest index first.
    beats = (depth[None, :] < depth[:, None]) | (
        (depth[None, :] == depth[:, None]) & (idx[None, :] >= idx[:, None])
    )
    chosen = jnp.all(~shared_target | beats, axis=1)

    # committed_chain[i] = chosen[i] and (my target is the sink, or the agent I
    # follow is itself committed).  Fixed point reached in <= N iterations.
    def chain_body(_, cc):
        follow_ok = jnp.where(has_next, _take(cc, nxt), True)
        return chosen & follow_ok

    committed_chain = jax.lax.fori_loop(
        0, n, chain_body, chosen & ~has_next, unroll=True
    )
    committed_chain = committed_chain & ~comp_has_cycle

    return committed_cycle | committed_chain
