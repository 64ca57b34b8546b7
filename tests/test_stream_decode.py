"""Ring-buffered stream decoder: >64KB blocks (the reference CLI default,
-B7 4MB, lz4io.c:182-188) decoded on device — linked and independent
frames, stored-block splices, partial blocks, corruption verdicts."""

import os

import numpy as np
import pytest

from lz4_tpu.kernels.decode_kernel import decode_stream
from lz4_tpu.ops.block_np import compress_block
from lz4_tpu.tpu import decompress_frame_device
from lz4_tpu.utils.datagen import gen_buffer, incompressible

from . import oracle

SLOW = os.environ.get("LZ4TPU_SLOW_TESTS", "0") == "1"


def test_stream_decode_independent_256k():
    # interpret-mode cost is per-sequence: use few-sequence (highly
    # compressible) data at CI scale; chip_smoke.py and bench.py
    # exercise the dense-sequence regime on the GPU
    data = gen_buffer(300_000, 0.97, 55)
    BS = 262144
    blocks = [data[i:i + BS] for i in range(0, len(data), BS)]
    payloads = [compress_block(b) for b in blocks]
    out, olen = decode_stream(payloads, BS, len(data), linked=False)
    assert (np.asarray(olen) == [len(b) for b in blocks]).all()
    flat = np.asarray(out).astype(np.uint8).reshape(-1)
    assert bytes(flat[:len(data)]) == data


@pytest.mark.skipif(
    os.environ.get("LZ4TPU_SLOW_TESTS", "0") != "1",
    reason="interpret cost scales with content/128 chunk iterations; the "
           "-B6 -BD reference-file test covers linked large blocks in CI")
def test_stream_decode_linked_1m():
    # sized for CPU-interpret latency: 1 full 1MB block + remainder of
    # few-sequence data (interpret costs ~0.5ms/sequence)
    data = gen_buffer(1_100_000, 0.985, 77)
    BS = 1 << 20
    blocks = [data[i:i + BS] for i in range(0, len(data), BS)]
    payloads = [compress_block(b, dict_=(blocks[j - 1][-65536:] if j
                                         else b""))
                for j, b in enumerate(blocks)]
    out, olen = decode_stream(payloads, BS, len(data), linked=True)
    assert (np.asarray(olen) == [len(b) for b in blocks]).all()
    flat = np.asarray(out).astype(np.uint8).reshape(-1)
    assert bytes(flat[:len(data)]) == data


_ARGS = ([(), ("-B7", "-BD"), ("-B5",), ("-B6", "-BD")] if SLOW
         else [(), ("-B6", "-BD")])


@pytest.mark.skipif(not oracle.available(), reason="no reference")
@pytest.mark.parametrize("args", _ARGS)
def test_reference_cli_files_decode_on_device(args):
    """Reference-CLI-produced files at every >64KB block size run through
    the device stream kernel (no host-codec fallback)."""
    data = gen_buffer((4 << 20) if SLOW else (300 << 10), 0.98, 42) \
        + incompressible(20_000, 3)
    frame = oracle.ref_cli_compress(data, args)
    out, used = decompress_frame_device(frame)
    assert out == data


def test_stream_decode_short_midstream_block():
    """A flushed (shorter than block_size) mid-stream block is legal LZ4F:
    every block must keep its full block_size output cap — a draining
    capacity pool starved later blocks and failed valid frames.  Also
    covers the frame path end-to-end."""
    import struct

    from lz4_tpu import spec as _spec
    from lz4_tpu.frame import FramePreferences, encode_frame_header

    BS = 262144
    chunks = [gen_buffer(BS, 0.97, 21), gen_buffer(1000, 0.97, 22),
              gen_buffer(BS, 0.97, 23)]
    payloads = [compress_block(c) for c in chunks]
    # kernel-level: per-block caps default to block_size each
    out, olen = decode_stream(payloads, BS, sum(len(c) for c in chunks),
                              linked=False)
    assert (np.asarray(olen) == [len(c) for c in chunks]).all()
    flat = np.asarray(out).astype(np.uint8).reshape(-1)
    assert bytes(flat[:sum(len(c) for c in chunks)]) == b"".join(chunks)

    # frame-level: mid-stream short STORED block (exact-length cap hint)
    prefs = FramePreferences(block_size_id=5, block_independent=True)
    parts = [encode_frame_header(prefs)]
    for i, c in enumerate(chunks):
        if i == 1:
            parts.append(struct.pack("<I",
                                     len(c) | _spec.UNCOMPRESSED_BIT))
            parts.append(c)
        else:
            parts.append(struct.pack("<I", len(payloads[i])))
            parts.append(payloads[i])
    parts.append(struct.pack("<I", 0))
    frame = b"".join(parts)
    got, used = decompress_frame_device(frame)
    assert got == b"".join(chunks)
    assert used == len(frame)


def test_stream_decode_corruption_verdict_parity():
    """Mutated blocks: the stream kernel's accept/reject verdict (and, on
    accept, the decoded length) matches the host oracle's — a bit flip may
    legitimately still yield a valid stream."""
    import random
    from lz4_tpu.ops.block_np import Lz4BlockError, decompress_block
    rng = random.Random(5)
    data = gen_buffer(300_000, 0.98, 9)
    BS = 262144
    blocks = [data[i:i + BS] for i in range(0, len(data), BS)]
    clean = [compress_block(b) for b in blocks]
    for trial in range(4 if SLOW else 2):
        payloads = [bytearray(c) for c in clean]
        k = trial % len(payloads)
        payloads[k][rng.randrange(len(payloads[k]))] ^= 1 << rng.randrange(8)
        payloads = [bytes(p) for p in payloads]
        _, olen = decode_stream(payloads, BS, len(data), linked=False)
        olen = np.asarray(olen)
        try:
            ref = decompress_block(payloads[k], BS)
            assert olen[k] == len(ref), trial
        except Lz4BlockError:
            assert olen[k] == -1, trial


@pytest.mark.skipif(not oracle.available() or not SLOW,
                    reason="8MB-block shapes crawl under interpret; "
                           "LZ4TPU_SLOW_TESTS=1 enables")
def test_legacy_device_decode():
    """Reference -l (legacy 0x184C2102, 8MB blocks) files decode through
    the stream kernel (tpu.decompress_legacy_device)."""
    from lz4_tpu.tpu import decompress_legacy_device
    data = gen_buffer(200_000, 0.97, 12)
    frame = oracle.ref_cli_compress(data, ("-l",))
    out, used = decompress_legacy_device(frame)
    assert out == data
