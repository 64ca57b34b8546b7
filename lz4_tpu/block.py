"""Simple one-shot block API — the ``lz4.h`` public-surface analog.

Name-for-name parity with the reference's simple functions
(``/root/reference/lib/lz4.h:112-220``):

  ``LZ4_compress_default``     -> :func:`compress_default`
  ``LZ4_compress_fast``        -> :func:`compress_fast`
  ``LZ4_compress_destSize``    -> :func:`compress_dest_size`
  ``LZ4_decompress_safe``      -> :func:`decompress_safe`
  ``LZ4_decompress_safe_partial`` -> :func:`decompress_safe_partial`
  ``LZ4_compressBound``        -> :func:`compress_bound`

Single buffers route to the exact host codec (``ops/block_np.py`` —
one Python call's latency beats a device round trip for one block);
*batches* are where the device path pays off: :func:`compress_batch` /
:func:`decompress_batch` run every block as one kernel program
(``tpu.encode_batch`` / ``tpu.decode_batch``).  Streaming (dictionary)
modes live in :mod:`lz4_tpu.stream`; frames in :mod:`lz4_tpu.frame`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .ops import block_np
from .ops.block_np import Lz4BlockError  # noqa: F401  (re-export)
from .spec import compress_bound  # noqa: F401  (re-export)


def compress_default(src: bytes, capacity: Optional[int] = None) -> bytes:
    """``LZ4_compress_default`` (lz4.h:141): one block, acceleration 1.

    Returns ``b""`` when ``capacity`` is given and the compressed output
    would not fit (the reference returns 0 — fail, don't truncate).
    """
    return compress_fast(src, 1, capacity)


def compress_fast(src: bytes, acceleration: int = 1,
                  capacity: Optional[int] = None) -> bytes:
    """``LZ4_compress_fast`` (lz4.h:154): acceleration trades ratio for
    encode speed (skip-acceleration step grows)."""
    if capacity is None:
        return block_np.compress_block(src, acceleration)
    return block_np.compress_block_limited(src, capacity, acceleration)


def compress_dest_size(src: bytes, capacity: int,
                       acceleration: int = 1) -> Tuple[bytes, int]:
    """``LZ4_compress_destSize`` (lz4.h:172): fill ``capacity`` bytes,
    returning (compressed, source bytes consumed)."""
    consumed, out = block_np.compress_block_dest_size(src, capacity,
                                                      acceleration)
    return out, consumed


def decompress_safe(comp: bytes, max_output: int,
                    dict_: bytes = b"") -> bytes:
    """``LZ4_decompress_safe`` (lz4.h:188) / ``_usingDict`` (lz4.h:330):
    bounds-checked decode; raises :class:`Lz4BlockError` on malformed
    input (the reference returns a negative length)."""
    return block_np.decompress_block(comp, max_output, dict_)


def decompress_safe_partial(comp: bytes, target: int) -> bytes:
    """``LZ4_decompress_safe_partial`` (lz4.h:205): stop once ``target``
    decoded bytes are produced; the block need not be consumed fully."""
    return block_np.decompress_block(comp, target, partial=True)


def decompress_dest_size(comp: bytes, dest_capacity: int,
                         dict_: bytes = b"") -> Tuple[bytes, int]:
    """The fork's resumable destSize decode (reference
    ``LZ4_decompress_destSize_generic``, lz4.c:1098-1320): fill at most
    ``dest_capacity`` output bytes, stopping at a token boundary (the
    ``token_ip``/``token_op`` rewind, lz4.c:1161-1163, 1316-1319), and
    report the source bytes consumed so the caller can resume with more
    input/output.  Returns ``(produced, consumed_src)``; the block is
    done when ``consumed_src == len(comp)``.  See also
    :meth:`lz4_tpu.stream.BlockDecompressStream.decompress_dest_size_continue`
    for the chained-window form."""
    consumed, out = block_np.decompress_block_dest_size(
        comp, dest_capacity, dict_)
    return out, consumed


def decompress_fast(comp: bytes, original_size: int,
                    dict_: bytes = b"") -> Tuple[bytes, int]:
    """``LZ4_decompress_fast`` (lz4.h:219) / ``_fast_usingDict``
    (lz4.h:331): decode exactly ``original_size`` bytes and report how
    many compressed bytes were read, so callers can walk concatenated
    blocks.  Unlike the C entry (which trusts its input) this stays
    bounds-checked — the reference marks the speed trick "unprotected";
    safety here costs nothing because the host path is an oracle."""
    comp = bytes(comp)
    n = len(comp)
    produced, i = 0, 0
    while True:
        if i >= n:
            raise block_np.Lz4BlockError("truncated: missing token")
        token = comp[i]
        i += 1
        litlen = token >> 4
        if litlen == 15:
            while True:
                if i >= n:
                    raise block_np.Lz4BlockError("truncated literal length")
                b = comp[i]
                i += 1
                litlen += b
                if b != 255:
                    break
        i += litlen
        produced += litlen
        if produced == original_size:
            break                     # literals-only last sequence
        if i + 2 > n:
            raise block_np.Lz4BlockError("truncated offset")
        i += 2
        mlen = token & 15
        if mlen == 15:
            while True:
                if i >= n:
                    raise block_np.Lz4BlockError("truncated match length")
                b = comp[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        produced += mlen + 4
        if produced > original_size:
            raise block_np.Lz4BlockError(
                "block does not decode to original_size")
    if i > n:
        raise block_np.Lz4BlockError("truncated literals")
    return block_np.decompress_block(comp[:i], original_size, dict_), i


def compress_batch(buffers: List[bytes], block_size: int = 65536,
                   acceleration: int = 1, min_match: int = 4):
    """Batch compression on the device: every buffer is one program of
    the encode kernel.  Returns a list of compressed blocks.

    This is the TPU-native payoff surface — use it where the reference
    would loop ``LZ4_compress_default`` over chunks."""
    from .tpu import encode_batch

    rows, lens = encode_batch(buffers, block_size, acceleration,
                              min_match)
    return [rows[i, :lens[i]].astype("uint8").tobytes()
            for i in range(len(buffers))]


def decompress_batch(comp_list: List[bytes], out_cap: int,
                     out_lens: Optional[List[int]] = None):
    """Batch decode on the device (one kernel program per block).  Returns a
    list of decoded byte strings; raises on any malformed block."""
    from .tpu import decode_batch

    return decode_batch(comp_list, out_cap, out_lens)
