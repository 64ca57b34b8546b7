"""Seeded property fuzzer (the reference fuzzer.c model, scaled to CI).

Every failure is reproducible from the cycle seed, like FUZ_rand-based
cycles (fuzzer.c:152-158).  Each cycle draws a block and a dict from a
shared compressible noise pool (fuzzer.c:86-89 analog) and runs the
assertion battery of fuzzer.c:400-713: round-trips, destSize exactness,
limitedOutput must-fail-one-byte-short, partial decode, short-output
rejection, dict modes, and cross-decoding with the reference library.
"""

import os
import random

import pytest

from lz4_tpu.hc import compress_hc_block
from lz4_tpu.ops.block_np import (
    Lz4BlockError,
    compress_block,
    compress_block_dest_size,
    compress_block_limited,
    decompress_block,
)
from lz4_tpu.utils.datagen import gen_buffer

from . import oracle

POOL = gen_buffer(1 << 20, 0.65, 0xF00D)  # shared noise pool
# CI default keeps latency moderate; soak runs scale it up,
# reference-style (programs/Makefile:65 runs the real battery time-boxed):
#   LZ4TPU_FUZZ_CYCLES=10000 python -m pytest tests/test_fuzz.py -q
CYCLES = int(os.environ.get("LZ4TPU_FUZZ_CYCLES", "200"))


def cycle_params(seed):
    rng = random.Random(seed)
    size = rng.randint(1, 1 << rng.randint(4, 16))
    start = rng.randint(0, len(POOL) - size)
    block = POOL[start:start + size]
    dsize = rng.randint(0, 1 << rng.randint(0, 14))
    dstart = rng.randint(0, len(POOL) - dsize) if dsize else 0
    dict_ = POOL[dstart:dstart + dsize]
    return rng, block, dict_


@pytest.mark.parametrize("seed", range(CYCLES))
def test_fuzz_cycle(seed):
    rng, block, dict_ = cycle_params(seed)

    # 1. plain roundtrip
    comp = compress_block(block)
    assert decompress_block(comp, len(block)) == block

    # 2. one-byte-short output must fail (fuzzer.c:500-529)
    if block:
        with pytest.raises(Lz4BlockError):
            decompress_block(comp, len(block) - 1)

    # 3. limitedOutput: exact size ok, one byte short fails (563-584)
    assert compress_block_limited(block, len(comp)) == comp
    assert compress_block_limited(block, len(comp) - 1) == b""

    # 4. destSize: fits capacity, decodes to consumed prefix (400-432)
    cap = rng.randint(1, max(2, len(comp)))
    consumed, dcomp = compress_block_dest_size(block, cap)
    assert len(dcomp) <= cap
    if consumed:
        assert decompress_block(dcomp, consumed) == block[:consumed]

    # 5. partial decode at a random target (534-539)
    target = rng.randint(0, len(block))
    assert decompress_block(comp, target, partial=True) == block[:target]

    # 6. dict mode roundtrip (589-713)
    dcomp2 = compress_block(block, dict_=dict_)
    assert decompress_block(dcomp2, len(block), dict_=dict_) == block

    # 7. HC at a random level
    level = rng.choice([3, 6, 9])
    hcomp = compress_hc_block(block, level, dict_=dict_)
    assert decompress_block(hcomp, len(block), dict_=dict_) == block

    # 8. cross-decode with the reference library
    if oracle.available():
        assert oracle.ref_decompress(comp, len(block)) == block
        if block:
            rcomp = oracle.ref_compress(block)
            assert decompress_block(rcomp, len(block)) == block
        assert oracle.ref_decompress_usingdict(
            dcomp2, len(block), dict_) == block


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_corrupted_streams_never_crash(seed):
    """Malicious/corrupted inputs must raise, never mis-write (the
    FUZ_AddressOverflow class, fuzzer.c:205-289)."""
    rng, block, _ = cycle_params(1000 + seed)
    comp = bytearray(compress_block(block))
    for _ in range(20):
        mut = bytearray(comp)
        for _ in range(rng.randint(1, 8)):
            mut[rng.randrange(len(mut))] = rng.randrange(256)
        try:
            out = decompress_block(bytes(mut), len(block))
            assert len(out) <= len(block)
        except Lz4BlockError:
            pass  # rejection is correct


def test_fuzz_kernel_agrees_with_host():
    """Decode kernel and host decoder agree on valid and truncated input."""
    import numpy as np
    import jax.numpy as jnp
    from lz4_tpu.kernels.decode_kernel import decode_blocks

    blocks = [cycle_params(2000 + i)[1][:4096] for i in range(8)]
    comps = [compress_block(b) for b in blocks]
    M = ((max(len(c) for c in comps) + 127) // 128) * 128
    arr = np.zeros((len(comps), M), np.int32)
    lens = np.zeros((len(comps),), np.int32)
    for i, c in enumerate(comps):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
        lens[i] = len(c)
    out, olen = decode_blocks(jnp.asarray(arr), jnp.asarray(lens), 4096)
    out, olen = np.asarray(out), np.asarray(olen)
    for i, b in enumerate(blocks):
        assert olen[i] == len(b)
        assert bytes(out[i, :olen[i]].astype(np.uint8)) == b


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_linked_device_chain(seed):
    """Random multi-block streams through the linked device kernels:
    encode chain -> decode chain and via the frame container, plus a
    corruption probe. Reproducible from the cycle seed."""
    import jax.numpy as jnp
    from lz4_tpu.frame import FramePreferences
    from lz4_tpu.kernels.decode_kernel import decode_blocks_linked
    from lz4_tpu.tpu import compress_frame_device, decompress_frame_device

    rng = random.Random(9_000 + seed)
    BS = 65536
    nb = rng.randint(2, 4)
    parts = []
    total = nb * BS - rng.randint(0, BS - 1)
    while sum(map(len, parts)) < total:
        size = rng.randint(1, 1 << rng.randint(6, 15))
        start = rng.randint(0, len(POOL) - size)
        parts.append(POOL[start:start + size])
        if rng.random() < 0.2:
            parts.append(bytes(rng.getrandbits(8) for _ in range(rng.randint(1, 300))))
    data = b"".join(parts)[:total]

    prefs = FramePreferences(block_size_id=4, block_independent=False,
                             content_checksum=bool(rng.getrandbits(1)),
                             block_checksum=bool(rng.getrandbits(1)))
    frame = compress_frame_device(data, prefs)
    out, used = decompress_frame_device(frame)
    assert out == data and used == len(frame)
    # r132 predates the block-checksum FLG bit (v1.8+): only frames
    # without it are oracle-decodable
    if oracle.available() and not prefs.block_checksum:
        assert oracle.ref_decompress_frame(frame, len(data)) == data

    # corruption: flip a byte in a block payload; with checksums on, the
    # decoder must either raise or still produce the original bytes (a
    # flip in padding/ignored bits) — never silently return wrong data
    if prefs.content_checksum or prefs.block_checksum:
        from lz4_tpu.frame import Lz4FrameError
        pos = rng.randint(15, len(frame) - 9)
        bad = bytearray(frame)
        bad[pos] ^= 0x40
        try:
            out2, _ = decompress_frame_device(bytes(bad))
        except Lz4FrameError:
            out2 = None  # rejected, as expected
        assert out2 is None or out2 == data, "corruption accepted"


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_device_encode_reference_decodes(seed):
    """Device-path fuzz lane: random blocks through the
    ENCODE KERNEL, each decoded by the reference C library per cycle —
    the kernel analog of fuzzer.c's cross-decoding battery.  Batched so
    one kernel launch covers the cycle's whole case set."""
    if not oracle.available():
        pytest.skip("reference oracle unavailable")
    import numpy as np
    import jax.numpy as jnp
    from lz4_tpu.kernels.common import np_pack_rows
    from lz4_tpu.kernels.encode_kernel import (bytes_to_val32_rows,
                                               encode_blocks)
    from lz4_tpu.tpu import fetch_byte_rows

    rng = random.Random(31_000 + seed)
    blocks = []
    for _ in range(16):
        size = rng.randint(1, 1 << rng.randint(4, 13))
        start = rng.randint(0, len(POOL) - size)
        b = POOL[start:start + size]
        if rng.random() < 0.25:   # splice incompressible noise
            b = bytes(rng.getrandbits(8) for _ in range(size))
        blocks.append(b)
    BS = -(-max(map(len, blocks)) // 128) * 128
    mm = rng.choice([4, 8, 12])
    packed, lens = np_pack_rows(blocks, BS)
    val = bytes_to_val32_rows(jnp.asarray(packed), BS)
    out, olen = encode_blocks(val, jnp.asarray(lens), 1, min_match=mm)
    outb, olen = fetch_byte_rows(out), np.asarray(olen)
    for i, b in enumerate(blocks):
        comp = outb[i, :olen[i]].tobytes()
        assert oracle.ref_decompress(comp, len(b)) == b, \
            f"seed={seed} case={i} mm={mm}"
