"""Shared helpers for the device kernels.

Byte streams cross the public kernel boundary as int32 *unpacked bytes*
(one byte per 32-bit element); the kernels themselves read and write
uint8 and the wrappers convert at the boundary.  Kernels are Pallas
kernels lowered through Triton; on the CPU backend (the test suite) they
run in Pallas interpret mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def on_cpu() -> bool:
    """True on the CPU backend, where kernels run in interpret mode.

    The device path targets the GPU; any other backend is an error rather
    than a silent fallback."""
    platform = jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(f"no kernel route for the {platform!r} backend; "
                       "the device kernels run on an NVIDIA GPU "
                       "(or interpreted on the CPU)")


def triton_call(kernel, *, num_warps: int, interpret: bool, **kwargs):
    """``pl.pallas_call`` through Triton (the route is always named: a call
    that names none gets Mosaic GPU)."""
    return pl.pallas_call(
        kernel, backend="triton", interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        **kwargs)


def sync(interpret: bool) -> None:
    """Make this program's earlier stores visible to all its threads.

    A Triton program spreads a vector over its threads, so bytes one
    thread stored are read back by another only after a barrier.  The
    interpreter runs sequentially and has no barrier to lower."""
    if not interpret:
        plgpu.debug_barrier()


def bucket_pow2(x: int, lo: int, hi: int | None = None) -> int:
    """Round x up to a power of two in [lo, hi] (clamped to hi): static
    shapes that follow the data are bucketed, so that distinct sizes reuse
    compiled programs instead of compiling one each."""
    n = lo
    while n < x and (hi is None or n < hi):
        n *= 2
    return n if hi is None else min(n, hi)


@functools.partial(jax.jit, static_argnames=("row_bytes",))
def bytes_to_i32_rows(packed: jax.Array, row_bytes: int) -> jax.Array:
    """[B, row_bytes//4] int32 packed words -> [B, row_bytes] int32 bytes."""
    w = packed.astype(jnp.int32)
    b0 = w & 0xFF
    b1 = (w >> 8) & 0xFF
    b2 = (w >> 16) & 0xFF
    b3 = (w >> 24) & 0xFF
    stacked = jnp.stack([b0, b1, b2, b3], axis=-1)  # [B, W, 4]
    return stacked.reshape(packed.shape[0], row_bytes)


@jax.jit
def i32_rows_to_bytes(rows: jax.Array) -> jax.Array:
    """[B, N] int32 bytes -> [B, N//4] int32 packed words (LE)."""
    B, N = rows.shape
    r = rows.reshape(B, N // 4, 4)
    return (r[..., 0] | (r[..., 1] << 8) | (r[..., 2] << 16)
            | (r[..., 3] << 24))


def np_pack_rows(buffers, row_bytes: int):
    """Host helper: list of byte strings -> ([B, row_bytes//4] int32 words,
    [B] int32 lengths).  Rows are zero padded."""
    import numpy as np
    B = len(buffers)
    arr = np.zeros((B, row_bytes), dtype=np.uint8)
    lens = np.zeros((B,), dtype=np.int32)
    for i, b in enumerate(buffers):
        arr[i, :len(b)] = np.frombuffer(bytes(b), dtype=np.uint8)
        lens[i] = len(b)
    return arr.view("<i4").astype(np.int32), lens
