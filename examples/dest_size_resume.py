"""Resumable destSize decoding — the fork's signature decoder property.

The reference fork rewrote its block decoder as a resumable state
machine (reference lz4.c:1098-1320): decoding stops at a TOKEN BOUNDARY
when the destination fills or the source ends, reporting how much of
each was used, so the caller can continue with more output or input —
the property that makes scatter-gather possible (lz4sg.c feeds one
block through many buffers with zero intermediate copies).

This example drives the same contract here, three ways:

1. one block filling several small destination buffers
   (block_np.decompress_block_dest_size / the iovec use case)
2. one block arriving in input pieces (expect_more_input)
3. the batched DEVICE variant (kernels.decode_blocks_dest_size):
   per-row produced+consumed counts, resume with the produced bytes
   as the dictionary window
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lz4_tpu.ops.block_np import (compress_block,
                                  decompress_block_dest_size)
from lz4_tpu.stream import BlockDecompressStream
from lz4_tpu.utils.datagen import gen_buffer


def main() -> int:
    data = gen_buffer(200_000, 0.7, 12345)
    comp = compress_block(data)
    print(f"block: {len(data)} -> {len(comp)} bytes")

    # 1. fill 16KB destination buffers one at a time
    dec = BlockDecompressStream()
    pos, pieces = 0, []
    while pos < len(comp):
        consumed, out = dec.decompress_dest_size_continue(
            comp[pos:], 16384)
        pos += consumed
        pieces.append(out)
    assert b"".join(pieces) == data
    print(f"split-output resume: {len(pieces)} buffers, "
          f"sizes {[len(p) for p in pieces[:4]]}...")

    # 2. the input arrives in chunks; each call consumes whole sequences
    fed, produced = 0, b""
    chunk = 4096
    while fed < len(comp):
        piece = comp[fed:fed + max(chunk, 1)]
        last = fed + len(piece) >= len(comp)
        consumed, out = decompress_block_dest_size(
            piece, len(data) - len(produced), dict_=produced,
            expect_more_input=not last)
        fed += consumed if consumed else len(piece)  # need more input
        produced += out
        if not consumed and not out:
            chunk *= 2
    assert produced == data
    print(f"split-input resume: fed in ~{chunk}B chunks, OK")

    # 3. device variant (the GPU kernel; interpreted on the CPU)
    import numpy as np
    import jax.numpy as jnp
    from lz4_tpu.kernels.decode_kernel import decode_blocks_dest_size

    M = -(-len(comp) // 128) * 128
    arr = np.zeros((1, M), np.int32)
    arr[0, :len(comp)] = np.frombuffer(comp, np.uint8)
    caps = jnp.asarray([65536], jnp.int32)
    out, olen, cons = decode_blocks_dest_size(
        jnp.asarray(arr), jnp.asarray([len(comp)], jnp.int32),
        caps, 65536)
    olen0, cons0 = int(np.asarray(olen)[0]), int(np.asarray(cons)[0])
    piece1 = bytes(np.asarray(out)[0, :olen0].astype(np.uint8))
    assert piece1 == data[:olen0]
    print(f"device destSize decode: produced {olen0} of {len(data)}, "
          f"consumed {cons0} of {len(comp)} — resume with the produced "
          f"bytes as the window (see tests/test_destsize_kernel.py)")
    return 0


if __name__ == "__main__":
    main()
