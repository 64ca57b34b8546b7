"""Device-side frame assembly in plain XLA: per-block payloads and their
LE32 block headers packed into ONE contiguous byte buffer.

The encode kernels leave each block's compressed bytes in a bound-sized
row.  The reference writes blocks in place in a single pass
(lz4frame.c:511-525, 575-682); here an exclusive scan over
``4 + payload_len`` gives every block its output offset -- with the
stored-block rule folded in: a block whose compressed size reaches its
plaintext size ships the plaintext (lz4frame.c:518-524) -- and one gather
fetches every output byte from its block's header, compressed row or
plaintext row.  The host then fetches ONE buffer and wraps it with the
frame header and endmark.  Block checksums are not supported on this path
(callers assemble on the host when they are enabled).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("TB",))
def _pack(comp_rows, olen, val_rows, blen, *, TB):
    B, M = comp_rows.shape
    NS = val_rows.shape[1]
    live = blen > 0
    stored = jnp.logical_and(olen >= blen, live)
    eff = jnp.where(stored, blen, olen)
    step = jnp.where(live, 4 + eff, 0)
    end = jnp.cumsum(step)
    start = end - step
    hdr = jnp.where(stored, blen | jnp.int32(-(1 << 31)), olen)
    i = jnp.arange(TB, dtype=jnp.int32)
    b = jnp.minimum(jnp.searchsorted(end, i, side="right"), B - 1)
    local = i - start[b]
    k = jnp.maximum(local - 4, 0)
    payload = jnp.where(stored[b], val_rows[b, jnp.minimum(k, NS - 1)],
                        comp_rows[b, jnp.minimum(k, M - 1)])
    head = hdr[b] >> (8 * jnp.clip(local, 0, 3))
    byte = jnp.where(local < 4, head, payload) & 0xFF
    return jnp.where(i < end[-1], byte, 0).astype(jnp.uint8), end[-1]


def pack_frame_payloads(comp_rows: jax.Array, olen: jax.Array,
                        val_rows: jax.Array, blens) -> tuple:
    """Assemble [4-byte header | payload] for every block into one flat
    device buffer.

    Args:
      comp_rows: [B, M] int32 compressed byte lanes (encode kernel out).
      olen: [B] int32 compressed lengths (device).
      val_rows: [B, NS] int32 val32 lanes of the plaintext blocks (lane p
        low byte = byte p) -- the stored-block fallback source.
      blens: [B] plaintext block lengths (zero rows are padding).

    Returns (flat [TB] uint8 device buffer, total bytes as a device
    scalar); nothing waits for the device, so a caller can dispatch the
    next chunk before fetching this one.
    """
    B, M = comp_rows.shape
    NS = val_rows.shape[1]
    TB = -(-(B * (4 + max(M, NS))) // 128) * 128
    return _pack(comp_rows, olen.astype(jnp.int32), val_rows,
                 jnp.asarray(np.asarray(blens, np.int32)), TB=TB)
