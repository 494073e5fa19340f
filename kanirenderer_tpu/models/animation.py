"""Instance animation helpers.

The reference ships a test-only animation path that random-walks instance
positions every frame across 8 worker threads and re-uploads the instance
buffers (reference src/lib.rs:1394-1689, src/model.rs:86-92).  The
equivalent here is a pure jittable update of the per-object transforms — no
threads, no buffer re-uploads, just a new (O, 4, 4) array consumed by the
next render_frame.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def random_walk_objects(object_model: Array, key: Array, dt: Array,
                        speed: float = 100.0) -> tuple[Array, Array]:
    """Jitter every object's translation by a uniform random step.

    Mirrors ``test_move_model_vec3`` (reference src/model.rs:86-92): each
    axis moves by U(-1, 1) · speed · dt per frame.  Returns the updated
    model matrices and the split PRNG key.
    """
    key, sub = jax.random.split(key)
    o = object_model.shape[0]
    step = jax.random.uniform(sub, (o, 3), jnp.float32, -1.0, 1.0) \
        * speed * dt
    return object_model.at[:, :3, 3].add(step), key
