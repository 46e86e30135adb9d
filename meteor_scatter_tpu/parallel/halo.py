"""Neighbor halo exchange over the time axis via collective permute.

This is the distributed form of the reference's STFT overlap
(``noverlap = NFFT//2``, prime_detection.py:67 / main.py:53) and of FIR
warm-up tails: a time shard needs the trailing samples of its left
neighbor (and/or the leading samples of its right neighbor) to compute its
boundary frames exactly.  ``lax.ppermute`` sends each halo straight to
the neighbouring device — no all-to-all, no host round trip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def halo_exchange(
    x_local: jnp.ndarray,
    left_halo: int,
    right_halo: int,
    axis_name: str,
) -> jnp.ndarray:
    """Pad the last axis of the local shard with neighbor data.

    Returns ``concat(left_neighbor_tail, x_local, right_neighbor_head)``.
    Edge shards receive zeros (matching how an unsharded computation sees
    no samples before t=0 / after the end).  Works inside ``shard_map``.
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    parts = []
    if left_halo > 0:
        tail = x_local[..., -left_halo:]
        # send my tail to my right neighbor → I receive left neighbor's tail
        recv = lax.ppermute(tail, axis_name, [(i, (i + 1) % n) for i in range(n)])
        recv = jnp.where(idx == 0, jnp.zeros_like(recv), recv)
        parts.append(recv)
    parts.append(x_local)
    if right_halo > 0:
        head = x_local[..., :right_halo]
        # send my head to my left neighbor → I receive right neighbor's head
        recv = lax.ppermute(head, axis_name, [(i, (i - 1) % n) for i in range(n)])
        recv = jnp.where(idx == n - 1, jnp.zeros_like(recv), recv)
        parts.append(recv)
    return jnp.concatenate(parts, axis=-1)
