"""The environment state: one immutable pytree of device arrays.

The reference scatters its state across mutable Python objects (``Agent`` /
``Shelf`` instances with class-level id counters, rware/warehouse.py:73-137)
and a derived id grid.  Here the entire state of ONE environment is a single
pytree dataclass of small integer arrays; a batch of B environments is simply the
same pytree with a leading batch axis (created via ``jax.vmap``), which is
also the unit of sharding across a device mesh and of orbax checkpointing.

Index conventions:
  * agents and shelves are 0-indexed device-side; the reference's 1-based ids
    appear only at the gym-adapter boundary.
  * ``agent_carrying`` holds the 0-based shelf index being carried, or -1.
  * ``request_queue`` holds 0-based shelf indices; slot order is semantically
    meaningful (deliveries replace the slot in place, rware/warehouse.py:917).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from rware_tpu import pytree


@pytree.dataclass
class WarehouseState:
    """Complete dynamic state of one warehouse environment."""

    agent_x: jax.Array  # (N,) int32
    agent_y: jax.Array  # (N,) int32
    agent_dir: jax.Array  # (N,) int32, Direction values
    agent_carrying: jax.Array  # (N,) int32, shelf index or -1
    agent_has_delivered: jax.Array  # (N,) bool
    agent_message: jax.Array  # (N, msg_bits) float32
    shelf_x: jax.Array  # (S,) int32
    shelf_y: jax.Array  # (S,) int32
    request_queue: jax.Array  # (R,) int32, shelf indices
    cur_steps: jax.Array  # () int32
    cur_inactive_steps: jax.Array  # () int32
    key: jax.Array  # PRNG key for this environment's stream

    # -- derived views ---------------------------------------------------------

    @property
    def n_agents(self) -> int:
        return self.agent_x.shape[-1]

    @property
    def n_shelves(self) -> int:
        return self.shelf_x.shape[-1]

    def in_queue_mask(self) -> jax.Array:
        """(S,) bool: which shelves are currently requested."""
        s = jnp.arange(self.n_shelves, dtype=jnp.int32)
        return jnp.any(self.request_queue[..., None] == s, axis=-2)

    # -- test-injection API ----------------------------------------------------
    # The reference tests teleport entities by mutating agent/shelf attributes
    # and calling _recalc_grid() (e.g. tests/test_movement.py:50-61).  The
    # functional equivalent returns an updated state; there is no grid to
    # recalculate because grids are derived on the fly.

    def set_agent(self, i, *, x=None, y=None, direction=None, carrying=None,
                  has_delivered=None) -> "WarehouseState":
        """Return a state with agent ``i`` teleported/modified."""
        out = self
        if x is not None:
            out = out.replace(agent_x=out.agent_x.at[..., i].set(x))
        if y is not None:
            out = out.replace(agent_y=out.agent_y.at[..., i].set(y))
        if direction is not None:
            out = out.replace(agent_dir=out.agent_dir.at[..., i].set(int(direction)))
        if carrying is not None:
            out = out.replace(agent_carrying=out.agent_carrying.at[..., i].set(carrying))
        if has_delivered is not None:
            out = out.replace(
                agent_has_delivered=out.agent_has_delivered.at[..., i].set(has_delivered)
            )
        return out

    def set_shelf(self, s, *, x=None, y=None) -> "WarehouseState":
        """Return a state with shelf ``s`` teleported."""
        out = self
        if x is not None:
            out = out.replace(shelf_x=out.shelf_x.at[..., s].set(x))
        if y is not None:
            out = out.replace(shelf_y=out.shelf_y.at[..., s].set(y))
        return out

    def set_request(self, slot, shelf_index) -> "WarehouseState":
        """Return a state with request-queue ``slot`` pointing at ``shelf_index``."""
        return self.replace(
            request_queue=self.request_queue.at[..., slot].set(shelf_index)
        )

    def shelf_at(self, x, y) -> jax.Array:
        """0-based index of the shelf at (x, y), or -1 (unbatched state only)."""
        match = (self.shelf_x == x) & (self.shelf_y == y)
        return jnp.where(jnp.any(match), jnp.argmax(match), -1).astype(jnp.int32)

    def agent_at(self, x, y) -> jax.Array:
        """0-based index of the agent at (x, y), or -1 (unbatched state only)."""
        match = (self.agent_x == x) & (self.agent_y == y)
        return jnp.where(jnp.any(match), jnp.argmax(match), -1).astype(jnp.int32)
