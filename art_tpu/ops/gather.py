"""Row fetches for per-ray table lookups.

The wavefront does a dozen per-ray lookups per bounce (material rows,
texture rows, winner-primitive rows):

* tables are *packed* so each lookup fetches one wide row instead of many
  scalar columns (one gather per table instead of per field);
* small tables (<= ONEHOT_MAX rows) are fetched as a one-hot matrix
  product (R, N) @ (N, K), larger ones with a gather.  Scene
  material/texture tables are value-deduplicated at compile time so they
  stay under this bound.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

ONEHOT_MAX = 192


def take_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Fetch table[idx] rows: (N, K), (R,) -> (R, K)."""
    n = table.shape[0]
    if n <= ONEHOT_MAX:
        onehot = (idx[:, None] == jnp.arange(n, dtype=idx.dtype)[None, :]).astype(
            table.dtype
        )
        # HIGHEST: a default-precision f32 product may run in TF32 on a
        # GPU (or bf16 elsewhere) and fetch a rounded table[idx]; full-f32
        # passes keep the fetched rows bit-equal to the gather path.
        return jnp.dot(
            onehot, table,
            preferred_element_type=table.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
    return table[idx]
