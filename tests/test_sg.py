"""Scatter-gather layer vs the reference LZ4_SG implementation.

Mirrors sgtest.c's coverage (programs/sgtest.c:357-995): 1x1 pairs, the
16x4KB -> 17x4KB case and its inverse, LZ4F-interop (any SG frame decodes
with a plain LZ4F decoder), mirrored-list round-trips with random
exponentially-distributed buffer sizes, and header validation codes.
"""

import random

import pytest

from lz4_tpu import spec
from lz4_tpu.frame import decompress_frame
from lz4_tpu.sg import (
    SgError,
    sg_compress,
    sg_compress_bound,
    sg_decode_header,
    sg_decompress,
)
from lz4_tpu.utils.datagen import gen_buffer, incompressible

from . import oracle

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference oracle unavailable")


def split_buffers(data: bytes, sizes):
    out, pos = [], 0
    for s in sizes:
        out.append(data[pos:pos + s])
        pos += s
    assert pos == len(data)
    return out


def trim_to_filled(bufs, caps, total):
    """Mirror sgtest: keep only the filled prefix of the output list."""
    filled = []
    rem = total
    for b, c in zip(bufs, caps):
        if rem <= 0:
            break
        take = min(c, rem)
        filled.append(b[:take])
        rem -= take
    return filled


def concat_filled(bufs, caps, total):
    return b"".join(trim_to_filled(bufs, caps, total))


DATA64K = gen_buffer(65536, 0.7, 200)


def test_basic_1x1():
    data = gen_buffer(4096, 0.7, 201)
    caps = [sg_compress_bound(len(data), 1, 1)]
    total, consumed, outs = sg_compress([data], caps)
    assert total > 0 and consumed == len(data)
    n, decoded = sg_decompress(trim_to_filled(outs, caps, total), [len(data)])
    assert n == len(data)
    assert decoded[0] == data


def test_16x4k_to_17x4k_and_inverse():
    data = DATA64K
    for n_in, n_out in ((16, 17), (17, 16)):
        in_sizes = [len(data) // n_in] * n_in
        in_sizes[-1] += len(data) - sum(in_sizes)
        ins = split_buffers(data, in_sizes)
        caps = [4096 + 64] * n_out
        total, consumed, outs = sg_compress(ins, caps)
        assert consumed == len(data), (n_in, n_out, consumed)
        n, decoded = sg_decompress(trim_to_filled(outs, caps, total), in_sizes)
        assert n == len(data)
        assert b"".join(decoded) == data


def test_sg_frame_decodes_with_plain_lz4f():
    """sgtest.c:258-354 property: SG frames are ordinary LZ4F frames."""
    data = DATA64K
    ins = split_buffers(data, [4096] * 16)
    caps = [8192] * 10
    total, consumed, outs = sg_compress(ins, caps)
    assert consumed == len(data)
    frame = concat_filled(outs, caps, total)
    # our frame decoder
    out, used = decompress_frame(frame)
    assert out == data and used == len(frame)
    # the reference LZ4F decoder
    assert oracle.ref_decompress_frame(frame, len(data)) == data


def test_reference_sg_decodes_ours():
    data = DATA64K
    ins = split_buffers(data, [4096] * 16)
    caps = [4096 + 100] * 17
    total, consumed, outs = sg_compress(ins, caps)
    assert consumed == len(data)
    comp_bufs = trim_to_filled(outs, caps, total)
    ret, decoded = oracle.ref_sg_decompress(comp_bufs, [4096] * 16)
    assert ret == len(data), ret
    assert b"".join(decoded) == data


def test_we_decode_reference_sg():
    data = DATA64K
    in_sizes = [4096] * 16
    ins = split_buffers(data, in_sizes)
    caps = [4096 + 100] * 17
    ret, outs, consumed = oracle.ref_sg_compress(ins, caps)
    assert ret > 0 and consumed == len(data)
    comp_bufs = trim_to_filled(outs, caps, ret)
    n, decoded = sg_decompress(comp_bufs, in_sizes)
    assert n == len(data)
    assert b"".join(decoded) == data


def test_compressed_sizes_match_reference():
    """Same inputs, same split => our frame should be no larger."""
    data = DATA64K
    ins = split_buffers(data, [4096] * 16)
    caps = [8192] * 17
    ret_ref, _, _ = oracle.ref_sg_compress(ins, caps)
    total, _, _ = sg_compress(ins, caps)
    assert total <= ret_ref * 1.01 + 64, (total, ret_ref)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fuzzer_style_roundtrip(seed):
    """Random buffer lists (sgtest.c:536-995 style, scaled down)."""
    rng = random.Random(seed)

    def rnd_exp(max_val):
        # exponential-ish distribution like sgtest's rnd_exponential
        e = rng.randint(0, 14)
        return max(1, min(max_val, rng.randint(1, 1 << e)))

    total_size = rng.randint(1000, 200_000)
    data = gen_buffer(total_size, rng.choice([0.4, 0.7, 0.9]), 300 + seed)
    # input split
    in_sizes = []
    rem = total_size
    while rem > 0 and len(in_sizes) < 19:
        s = min(rem, rnd_exp(131_072))
        in_sizes.append(s)
        rem -= s
    if rem:
        in_sizes.append(rem)
    ins = split_buffers(data, in_sizes)
    # output caps generous enough
    bound = sg_compress_bound(total_size, len(ins), 8)
    n_out = rng.randint(1, 8)
    caps = [max(spec.SG_MIN_FIRST_OUT + 8,
                bound // n_out + 64) for _ in range(n_out)]
    total, consumed, outs = sg_compress(ins, caps)
    assert consumed == total_size, (in_sizes, caps)
    comp_bufs = trim_to_filled(outs, caps, total)
    # 1) mirrored SG decode, host and device chain kernel
    n, decoded = sg_decompress(comp_bufs, in_sizes)
    assert n == total_size
    assert b"".join(decoded) == data
    n_d, decoded_d = sg_decompress(comp_bufs, in_sizes, use_device=True)
    assert n_d == n and decoded_d == decoded
    # 2) plain LZ4F decode of the concatenated frame
    frame = b"".join(comp_bufs)
    out, _ = decompress_frame(frame)
    assert out == data
    # 3) reference LZ4F decoder
    assert oracle.ref_decompress_frame(frame, total_size) == data


def test_incompressible_stays_in_place():
    data = incompressible(16384, seed=9)
    ins = split_buffers(data, [4096] * 4)
    caps = [4096 + 200] * 5
    total, consumed, outs = sg_compress(ins, caps)
    assert consumed == len(data)
    # expansion is bounded: headers + per-block literal overhead only
    assert total <= len(data) + len(data) // 255 + 200
    frame = concat_filled(outs, caps, total)
    out, _ = decompress_frame(frame)
    assert out == data


def test_header_validation_codes():
    data = gen_buffer(4096, 0.7, 400)
    caps = [sg_compress_bound(len(data), 1, 1)]
    total, _, outs = sg_compress([data], caps)
    frame = bytearray(concat_filled(outs, caps, total))

    def code_of(buf):
        try:
            sg_decode_header(bytes(buf))
            return 0
        except SgError as e:
            return e.code

    good = frame[:15]
    assert code_of(good) == 0

    bad = bytearray(good); bad[0] ^= 0xFF
    assert code_of(bad) == -1          # magic
    bad = bytearray(good); bad[4] = (bad[4] & 0x3F) | 0x80
    assert code_of(bad) == -2          # version
    bad = bytearray(good); bad[14] ^= 0xFF
    assert code_of(bad) == -3          # header checksum

    from lz4_tpu.ops.xxhash_np import xxh32

    def refix(b):
        b[14] = (xxh32(bytes(b[4:14]), 0) >> 8) & 0xFF
        return b

    bad = refix(bytearray(good)); bad[4] |= 1 << 4; bad = refix(bad)
    assert code_of(bad) == -4          # block checksum present
    bad = bytearray(good); bad[4] |= 1 << 2; bad = refix(bad)
    assert code_of(bad) == -5          # content checksum present
    bad = bytearray(good); bad[4] &= ~(1 << 3); bad = refix(bad)
    assert code_of(bad) == -6          # no content size
    bad = bytearray(good); bad[4] |= 1 << 5; bad = refix(bad)
    assert code_of(bad) == -7          # independent blocks


def test_input_validation():
    with pytest.raises(SgError):
        sg_compress([], [100])
    with pytest.raises(SgError):
        sg_compress([b"x"], [])
    with pytest.raises(SgError):
        sg_compress([b""], [100])      # input buffer < 1 byte
    with pytest.raises(SgError):
        sg_compress([b"x" * 100], [5])  # output buffer < 10 bytes
    # first output buffer below 15+4+2 fails with 0 (not an exception)
    total, consumed, outs = sg_compress([b"x" * 100], [spec.SG_MIN_FIRST_OUT - 1, 100])
    assert total == 0


def test_bound_is_sufficient():
    for seed in range(5):
        rng = random.Random(1000 + seed)
        n_in = rng.randint(1, 10)
        sizes = [rng.randint(1, 5000) for _ in range(n_in)]
        data = gen_buffer(sum(sizes), 0.3, 500 + seed)  # poorly compressible
        ins = split_buffers(data, sizes)
        bound = sg_compress_bound(len(data), n_in, 1)
        assert bound > 0
        total, consumed, outs = sg_compress(ins, [bound])
        assert consumed == len(data)
        assert total <= bound


# ---------------------------------------------------------------------------
# device scatter-gather decode (continuous-space chain kernel)
# ---------------------------------------------------------------------------

def test_device_sg_matches_host_16x4k():
    data = gen_buffer(16 * 4096, 0.7, 77)
    ins = split_buffers(data, [4096] * 16)
    caps = [4096 + 100] * 17
    total, consumed, outs = sg_compress(ins, caps)
    assert consumed == len(data)
    comp_bufs = trim_to_filled(outs, caps, total)
    sizes = [4096] * 16
    t_host, outs_host = sg_decompress(comp_bufs, sizes)
    t_dev, outs_dev = sg_decompress(comp_bufs, sizes, use_device=True)
    assert t_dev == t_host and outs_dev == outs_host
    assert b"".join(outs_dev)[:len(data)] == data


def test_device_sg_matches_host_ragged():
    rng = __import__("random").Random(5)
    data = gen_buffer(150_000, 0.6, 99)
    sizes, pos = [], 0
    while pos < len(data):
        sz = min(rng.randint(1, 50_000), len(data) - pos)
        sizes.append(sz)
        pos += sz
    ins = []
    pos = 0
    for sz in sizes:
        ins.append(data[pos:pos + sz])
        pos += sz
    caps = [max(sz + 64, 80) for sz in sizes] + [4096]
    total, consumed, outs = sg_compress(ins, caps)
    assert consumed == len(data)
    comp_bufs = trim_to_filled(outs, caps, total)
    t_host, outs_host = sg_decompress(comp_bufs, sizes)
    t_dev, outs_dev = sg_decompress(comp_bufs, sizes, use_device=True)
    assert t_dev == t_host and outs_dev == outs_host


def test_device_sg_decodes_reference_frames():
    if not oracle.available():
        pytest.skip("oracle unavailable")
    data = gen_buffer(16 * 4096, 0.8, 31)
    ins = [data[i:i + 4096] for i in range(0, len(data), 4096)]
    caps = [4096] * 17
    ret, outs, consumed = oracle.ref_sg_compress(ins, caps)
    assert ret > 0 and consumed == len(data)
    comp_bufs = trim_to_filled(outs, caps, ret)
    t_dev, outs_dev = sg_decompress(comp_bufs, [4096] * 16,
                                    use_device=True)
    assert t_dev == len(data)
    assert b"".join(outs_dev)[:len(data)] == data


def test_device_sg_large_blocks_stream_path():
    """SG chains with >64KB blocks (reference allows 4MB, lz4sg.c:544)
    decode on device through the stream decoder instead of bailing to
    the host."""
    # few-sequence data keeps CPU-interpret cost bounded; block sizes
    # straddle the 64KB kernel envelope
    data = gen_buffer(1_400_000, 0.985, 321)
    sizes = [900_000, 400_000, 100_000]
    ins = split_buffers(data, sizes)
    caps = [len(data) + 4096]
    total, consumed, outs = sg_compress(ins, caps)
    assert consumed == len(data)
    comp_bufs = trim_to_filled(outs, caps, total)
    t_host, outs_host = sg_decompress(comp_bufs, sizes)
    t_dev, outs_dev = sg_decompress(comp_bufs, sizes, use_device=True)
    assert t_dev == t_host and outs_dev == outs_host
    assert b"".join(outs_dev)[:len(data)] == data
    if oracle.available():
        ret, ref_outs = oracle.ref_sg_decompress(comp_bufs, sizes)
        assert ret > 0
        assert b"".join(ref_outs)[:len(data)] == data
        assert outs_dev == [bytes(o) for o in ref_outs]


def test_sg_mesh_roundtrip():
    """SG frames over a device mesh (the reference's 8-process multi-core
    SG analog, README.md:39-45): uniform 4-buffer lists compressed on the
    host, decoded sharded across the 8-device virtual mesh — results must
    match the single-list paths and stay LZ4F-decodable."""
    from lz4_tpu.parallel.mesh import default_mesh, sg_decompress_mesh

    mesh = default_mesh(8)
    sizes = [2048] * 4
    L = 4
    lists = [split_buffers(gen_buffer(8192, 0.8, 4_000 + i), sizes)
             for i in range(L)]
    caps = [2048 + 256] * 5

    comp_lists = []
    for i, lst in enumerate(lists):
        total, consumed, outs = sg_compress(lst, caps)
        assert consumed == 8192 and total > 0
        # plain LZ4F decodability of every frame (sgtest.c:258-354)
        content, _ = decompress_frame(concat_filled(outs, caps, total))
        assert content == b"".join(lst)
        comp_lists.append(trim_to_filled(outs, caps, total))

    decoded = sg_decompress_mesh(mesh, comp_lists, sizes)
    for i, (total, outs) in enumerate(decoded):
        assert total == 8192
        assert [bytes(o) for o in outs] == lists[i]


def test_sg_mesh_ragged_layouts(monkeypatch):
    """RAGGED SG frames over the mesh: three distinct buffer layouts
    decode through the device chains — layout buckets, not host
    fallback (asserted by failing the fallback entry point)."""
    from lz4_tpu import sg as sg_mod
    from lz4_tpu.parallel.mesh import default_mesh, sg_decompress_mesh

    mesh = default_mesh(8)
    layouts = [[2048, 2048], [1024, 3072], [4096]]
    caps_per = [[2048 + 256] * 3, [3072 + 256] * 2, [4096 + 256, 512]]
    lists, all_caps = [], []
    for i in range(6):
        lay = layouts[i % 3]
        lists.append(split_buffers(gen_buffer(4096, 0.8, 9_000 + i), lay))
        all_caps.append(caps_per[i % 3])

    comp_lists = []
    for i, lst in enumerate(lists):
        total, consumed, outs = sg_compress(lst, all_caps[i])
        assert consumed == 4096 and total > 0
        comp_lists.append(trim_to_filled(outs, all_caps[i], total))

    real_decompress = sg_mod.sg_decompress

    def guard_decompress(bufs, caps, block_decompress=None, **kw):
        assert block_decompress is not None, "host-fallback decompress!"
        return real_decompress(bufs, caps,
                               block_decompress=block_decompress, **kw)

    monkeypatch.setattr(sg_mod, "sg_decompress", guard_decompress)
    decoded = sg_decompress_mesh(mesh, comp_lists,
                                 [layouts[i % 3] for i in range(6)])
    for i, (total, outs) in enumerate(decoded):
        assert total == 4096
        assert [bytes(o) for o in outs] == lists[i]
