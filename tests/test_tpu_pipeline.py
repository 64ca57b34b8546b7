"""Device frame pipeline + mesh parallelism (CPU interpret + 8-dev mesh)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from lz4_tpu.frame import FramePreferences, decompress_frame
from lz4_tpu.kernels.common import np_pack_rows
from lz4_tpu.parallel.mesh import (
    decode_blocks_sharded,
    default_mesh,
    encode_blocks_sharded,
    roundtrip_step,
    shard_rows,
)
from lz4_tpu.kernels.encode_kernel import bytes_to_val32_rows
from lz4_tpu.tpu import compress_frame_device, decompress_frame_device
from lz4_tpu.utils.datagen import gen_buffer, incompressible

from . import oracle

DATA = gen_buffer(20_000, 0.7, 900)
BS = 2048  # small device blocks keep interpret-mode tests fast


def test_device_frame_roundtrip():
    prefs = FramePreferences(block_size_id=4, content_checksum=True,
                             content_size=len(DATA))
    frame = compress_frame_device(DATA, prefs, block_size=BS)
    out, used = decompress_frame_device(frame)
    assert out == DATA and used == len(frame)


def test_device_frame_decodes_on_host_and_reference():
    frame = compress_frame_device(DATA, block_size=BS)
    out, _ = decompress_frame(frame)  # host decoder
    assert out == DATA
    if oracle.available():
        assert oracle.ref_decompress_frame(frame, len(DATA)) == DATA


def test_device_decodes_host_frames():
    from lz4_tpu.frame import compress_frame
    prefs = FramePreferences(block_size_id=4, block_independent=True)
    frame = compress_frame(DATA, prefs)
    out, _ = decompress_frame_device(frame)
    assert out == DATA


def test_device_frame_stored_blocks():
    noise = incompressible(8192)
    frame = compress_frame_device(noise, block_size=BS)
    out, _ = decompress_frame_device(frame)
    assert out == noise
    assert len(frame) < len(noise) + 128


def test_device_frame_empty():
    frame = compress_frame_device(b"", block_size=BS)
    out, _ = decompress_frame_device(frame)
    assert out == b""


def test_mesh_roundtrip_step():
    mesh = default_mesh(8)
    B = 16
    bufs = [gen_buffer(512, 0.7, i) for i in range(B)]
    packed, lens = np_pack_rows(bufs, 512)
    pw = shard_rows(mesh, jnp.asarray(packed))
    ln = shard_rows(mesh, jnp.asarray(lens))
    clen, olen, bad = jax.jit(
        lambda w, l: roundtrip_step(mesh, w, l, 512))(pw, ln)
    assert int(np.asarray(bad)) == 0
    assert (np.asarray(olen) == np.asarray(lens)).all()


def test_mesh_sharded_encode_decode_match_single_device():
    mesh = default_mesh(8)
    B = 8
    bufs = [gen_buffer(1024, 0.6, 50 + i) for i in range(B)]
    packed, lens = np_pack_rows(bufs, 1024)
    val = bytes_to_val32_rows(jnp.asarray(packed), 1024)
    comp, clen = encode_blocks_sharded(mesh, shard_rows(mesh, val),
                                       shard_rows(mesh, jnp.asarray(lens)))
    out, olen = decode_blocks_sharded(mesh, comp, clen, 1024)
    out, olen = np.asarray(out), np.asarray(olen)
    for i, b in enumerate(bufs):
        assert olen[i] == len(b)
        assert bytes(out[i, :olen[i]].astype(np.uint8)) == b


def test_graft_entry():
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    comp, clen = jax.jit(fn)(*args)
    assert comp.shape[0] == args[0].shape[0]
    __graft_entry__.dryrun_multichip(8)


# ---------------------------------------------------------------------------
# linked (chained-window) device decode
# ---------------------------------------------------------------------------

def _mixed_data(n):
    parts = []
    i = 0
    while sum(map(len, parts)) < n:
        parts.append(gen_buffer(3000, 0.6, 40 + i))
        parts.append(incompressible(600))
        i += 1
    return b"".join(parts)[:n]


def test_device_linked_frame_roundtrip():
    from lz4_tpu.frame import compress_frame
    data = _mixed_data(3 * 65536 + 777)
    prefs = FramePreferences(block_size_id=4, block_independent=False,
                             content_checksum=True, content_size=len(data))
    # host compressor emits a genuine linked frame (64KB blocks)
    frame = compress_frame(data, prefs)
    out, used = decompress_frame_device(frame)
    assert out == data and used == len(frame)


def test_device_linked_decode_of_reference_frame():
    if not oracle.available():
        pytest.skip("reference library unavailable")
    data = _mixed_data(200_000)
    # blockMode=0 is LZ4F_blockLinked, bsid 4 = 64KB blocks
    frame = oracle.ref_compress_frame(data, block_size_id=4, block_mode=0)
    out, used = decompress_frame_device(frame)
    assert out == data


def test_device_linked_stored_block_splice():
    from lz4_tpu.frame import compress_frame
    # incompressible blocks force stored-block fallbacks inside the chain,
    # while later compressible blocks may match into them via the window
    data = incompressible(2 * 65536) + gen_buffer(65536, 0.5, 7) + \
        incompressible(65536 // 2)
    prefs = FramePreferences(block_size_id=4, block_independent=False)
    frame = compress_frame(data, prefs)
    out, _ = decompress_frame_device(frame)
    assert out == data


def test_device_linked_kernel_matches_window_semantics():
    from lz4_tpu.kernels.decode_kernel import decode_blocks_linked
    from lz4_tpu.ops.block_np import compress_block
    # hand-build a chain whose window is exactly the previous block,
    # matching the kernel's 64KB-full-blocks contract at test scale
    data = _mixed_data(4 * BS)
    blocks = [data[i:i + BS] for i in range(0, len(data), BS)]
    payloads = [compress_block(b, dict_=(blocks[i - 1] if i else b""))
                for i, b in enumerate(blocks)]
    M = -(-max(len(c) for c in payloads) // 128) * 128
    arr = np.zeros((len(payloads), M), np.int32)
    lens = np.zeros((len(payloads),), np.int32)
    for i, c in enumerate(payloads):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
        lens[i] = len(c)
    out, olen = decode_blocks_linked(jnp.asarray(arr), jnp.asarray(lens), BS)
    out, olen = np.asarray(out), np.asarray(olen)
    for i, b in enumerate(blocks):
        assert olen[i] == len(b), (i, olen[i])
        assert bytes(out[i, :olen[i]].astype(np.uint8)) == b, i


def test_device_linked_rejects_corrupt_chain():
    from lz4_tpu.kernels.decode_kernel import decode_blocks_linked
    from lz4_tpu.ops.block_np import compress_block
    data = _mixed_data(3 * BS)
    blocks = [data[i:i + BS] for i in range(0, len(data), BS)]
    payloads = [compress_block(b, dict_=(blocks[i - 1] if i else b""))
                for i, b in enumerate(blocks)]
    M = -(-max(len(c) for c in payloads) // 128) * 128
    arr = np.zeros((len(payloads), M), np.int32)
    lens = np.zeros((len(payloads),), np.int32)
    for i, c in enumerate(payloads):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
        lens[i] = len(c)
    lens[1] -= 2  # truncate a middle block
    out, olen = decode_blocks_linked(jnp.asarray(arr), jnp.asarray(lens), BS)
    assert np.asarray(olen)[1] == -1


# ---------------------------------------------------------------------------
# linked (streaming) device encode
# ---------------------------------------------------------------------------

def test_device_linked_encode_roundtrip_and_reference():
    from lz4_tpu.frame import decompress_frame
    data = _mixed_data(3 * 65536 + 999)
    prefs = FramePreferences(block_size_id=4, block_independent=False,
                             content_checksum=True, content_size=len(data))
    frame = compress_frame_device(data, prefs)
    # header advertises linked blocks
    from lz4_tpu.frame import decode_frame_header
    assert not decode_frame_header(frame).block_independent
    out, _ = decompress_frame(frame)          # host decoder
    assert out == data
    out2, _ = decompress_frame_device(frame)  # device chain decoder
    assert out2 == data
    if oracle.available():
        assert oracle.ref_decompress_frame(frame, len(data)) == data


def test_device_linked_encode_beats_independent_ratio():
    # repeated content across block boundaries: linking must help
    seed = gen_buffer(65536, 0.8, 123)
    data = seed * 3
    prefs_l = FramePreferences(block_size_id=4, block_independent=False)
    prefs_i = FramePreferences(block_size_id=4, block_independent=True)
    linked = compress_frame_device(data, prefs_l)
    indep = compress_frame_device(data, prefs_i, block_size=65536)
    assert len(linked) < len(indep)
    out, _ = decompress_frame_device(linked)
    assert out == data


def test_compress_frame_mesh_single_linked_frame():
    """One blob -> one linked frame, sharded over the 8-device mesh with
    window handoff via input-overlap + table seeding (full ratio)."""
    from lz4_tpu.frame import decompress_frame
    from lz4_tpu.parallel.mesh import compress_frame_mesh, default_mesh
    mesh = default_mesh()
    # repeats at distance exactly 65535: visible to the linked 64KB
    # window, invisible inside any single independent 64KB block — so
    # the ratio property below tests the cross-shard window handoff
    # itself, not the in-block matcher
    seed = incompressible(65_535, 55)
    data = (seed * 9)[:5 * 65536 + 12345]
    frame = compress_frame_mesh(mesh, data)
    out, used = decompress_frame(frame)
    assert out == data and used == len(frame)
    if oracle.available():
        assert oracle.ref_decompress_frame(frame, len(data)) == data
    # window handoff must preserve cross-shard matches: the sharded frame
    # must compress meaningfully better than independent blocks
    indep = compress_frame_device(
        data, FramePreferences(block_size_id=4, block_independent=True),
        block_size=65536)
    assert len(frame) < 0.9 * len(indep)
    # and the device chain decoder reads it back too
    out2, _ = decompress_frame_device(frame)
    assert out2 == data


def test_device_linked_partial_middle_block_falls_back():
    """A flushed (partial, non-final) block is legal LZ4F but breaks the
    kernel's one-block-window contract; decompress_frame_device must fall
    back to the host codec rather than raise (found by review)."""
    from lz4_tpu.frame import FrameCompressor
    seg = gen_buffer(65536 + 30000, 0.7, 321)
    prefs = FramePreferences(block_size_id=4, block_independent=False,
                             content_checksum=True)
    c = FrameCompressor(prefs)
    frame = c.begin() + c.update(seg) + c.flush() + c.update(seg) + c.end()
    out, used = decompress_frame_device(frame)
    assert out == seg + seg and used == len(frame)


def test_device_linked_multigroup_window_handoff(monkeypatch):
    """The grouped pipelined decode path: a linked chain longer
    than one dispatch group must hand the 64KB window between groups as
    a device-side slice (decode_blocks_linked init_window) and reassemble
    in order.  Group size is shrunk so CI exercises 3 groups + padding."""
    from lz4_tpu import tpu as tpu_mod
    from lz4_tpu.frame import compress_frame
    monkeypatch.setattr(tpu_mod, "DEC_GROUP_BLOCKS", 4)
    data = _mixed_data(11 * 65536 + 12345)      # 12 blocks -> 3 groups
    prefs = FramePreferences(block_size_id=4, block_independent=False,
                             content_checksum=True, content_size=len(data))
    frame = compress_frame(data, prefs)
    out, used = decompress_frame_device(frame)
    assert out == data and used == len(frame)


def test_device_linked_multigroup_partial_block_falls_back(monkeypatch):
    """A flushed short block in a LATER group must still route the whole
    frame to the host fallback (the group containing it reports the
    mismatch at drain time)."""
    from lz4_tpu import tpu as tpu_mod
    from lz4_tpu.frame import FrameCompressor
    monkeypatch.setattr(tpu_mod, "DEC_GROUP_BLOCKS", 4)
    seg = gen_buffer(6 * 65536 + 1000, 0.7, 99)
    prefs = FramePreferences(block_size_id=4, block_independent=False,
                             content_checksum=True)
    c = FrameCompressor(prefs)
    frame = c.begin() + c.update(seg) + c.flush() + c.update(seg) + c.end()
    out, used = decompress_frame_device(frame)
    assert out == seg + seg and used == len(frame)
