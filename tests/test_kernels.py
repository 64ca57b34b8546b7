"""Kernel tests (CPU interpret mode; tests/test_gpu.py runs them compiled).

The kernels must match the host oracle bit-for-bit on decode and produce
reference-decodable output on encode.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from lz4_tpu.kernels.common import np_pack_rows, bytes_to_i32_rows, i32_rows_to_bytes
from lz4_tpu.kernels.decode_kernel import decode_blocks
from lz4_tpu.kernels.encode_kernel import bytes_to_val32_rows, encode_blocks
from lz4_tpu.ops.block_np import compress_block, decompress_block
from lz4_tpu.utils.datagen import gen_buffer, incompressible

from . import oracle

NS = 2048


def pack_comp(comps):
    M = ((max(len(c) for c in comps) + 127) // 128) * 128 or 128
    B = len(comps)
    arr = np.zeros((B, M), np.int32)
    lens = np.zeros((B,), np.int32)
    for i, c in enumerate(comps):
        arr[i, :len(c)] = np.frombuffer(bytes(c), np.uint8)
        lens[i] = len(c)
    return jnp.array(arr), jnp.array(lens)


BLOCKS = ([gen_buffer(NS, p, i) for i, p in enumerate([0.3, 0.6, 0.9, 0.99])]
          + [b"", b"x" * 13, b"hello world hello world!", b"\x00" * NS,
             incompressible(NS), b"ab" * (NS // 2)])


def test_decode_kernel_matches_oracle():
    comps = [compress_block(b) for b in BLOCKS]
    arr, lens = pack_comp(comps)
    out, olen = decode_blocks(arr, lens, NS)
    out, olen = np.array(out), np.array(olen)
    for i, b in enumerate(BLOCKS):
        assert olen[i] == len(b), i
        assert bytes(out[i, :olen[i]].astype(np.uint8)) == b, i


def test_decode_kernel_rejects_malformed():
    comps = [compress_block(b) for b in BLOCKS if len(b) > 100]
    arr, lens = pack_comp(comps)
    bad_lens = np.array(lens) - 3          # truncated streams
    _, olen = decode_blocks(arr, jnp.array(bad_lens), NS)
    assert (np.array(olen) == -1).all()
    # offset-0 block
    bad = bytes([0x10, ord("A"), 0x00, 0x00])
    arr2, lens2 = pack_comp([bad])
    _, olen2 = decode_blocks(arr2, lens2, NS)
    assert np.array(olen2)[0] == -1


def test_decode_kernel_output_cap_enforced():
    comps = [compress_block(BLOCKS[0])]
    arr, lens = pack_comp(comps)
    _, olen = decode_blocks(arr, lens, len(BLOCKS[0]) - 1)
    assert np.array(olen)[0] == -1


def test_decode_kernel_dict_mode():
    dict_ = gen_buffer(1024, 0.7, 40)
    data = dict_[100:500] + gen_buffer(200, 0.5, 41) + dict_[700:900]
    comp = compress_block(data, dict_=dict_)
    arr, lens = pack_comp([comp])
    P = 1024
    drow = np.zeros((1, P), np.int32)
    db = np.frombuffer(dict_, np.uint8)
    drow[0, P - len(db):] = db
    out, olen = decode_blocks(arr, lens, 1024,
                              jnp.array(drow),
                              jnp.array([len(db)], np.int32))
    assert int(olen[0]) == len(data)
    assert bytes(np.array(out)[0, :len(data)].astype(np.uint8)) == data


def test_encode_kernel_roundtrip_and_ratio():
    packed, lens = np_pack_rows(BLOCKS, NS)
    val = bytes_to_val32_rows(jnp.array(packed), NS)
    out, olen = encode_blocks(val, jnp.array(lens))
    out, olen = np.array(out), np.array(olen)
    ours, refs = 0, 0
    for i, b in enumerate(BLOCKS):
        comp = bytes(out[i, :olen[i]].astype(np.uint8))
        assert decompress_block(comp, len(b)) == b, i
        if oracle.available() and b:
            assert oracle.ref_decompress(comp, len(b)) == b, i
            ref = len(oracle.ref_compress(b))
            # per-block sanity only: the sorted-candidate matcher parses
            # differently from the reference's hash table (LZ4 allows any
            # parse), so individual tiny blocks may diverge a few percent
            # either way; the aggregate must match or beat the reference
            assert len(comp) <= ref * 1.08 + 16, (i, len(comp), ref)
            ours += len(comp)
            refs += ref
    if refs:
        assert ours <= refs * 1.01, (ours, refs)


def test_encode_then_decode_kernels():
    """Full device-path round trip: encode kernel -> decode kernel."""
    data = [gen_buffer(NS, 0.7, 70 + i) for i in range(4)]
    packed, lens = np_pack_rows(data, NS)
    val = bytes_to_val32_rows(jnp.array(packed), NS)
    cout, clen = encode_blocks(val, jnp.array(lens))
    out, olen = decode_blocks(cout, clen, NS)
    out, olen = np.array(out), np.array(olen)
    for i, b in enumerate(data):
        assert olen[i] == len(b)
        assert bytes(out[i, :olen[i]].astype(np.uint8)) == b


def test_acceleration_parameter():
    data = [gen_buffer(NS, 0.7, 99)]
    packed, lens = np_pack_rows(data, NS)
    val = bytes_to_val32_rows(jnp.array(packed), NS)
    sizes = []
    for acc in (1, 8):
        _, olen = encode_blocks(val, jnp.array(lens), acceleration=acc)
        sizes.append(int(olen[0]))
    assert sizes[0] <= sizes[1]


def test_pack_unpack_helpers():
    data = [gen_buffer(333, 0.5, 7), b"", incompressible(1024)]
    packed, lens = np_pack_rows(data, 1024 + 128 - 24)
    rows = bytes_to_i32_rows(jnp.array(packed), 1128)
    rows_np = np.array(rows)
    for i, b in enumerate(data):
        assert bytes(rows_np[i, :len(b)].astype(np.uint8)) == b
    back = i32_rows_to_bytes(rows)
    assert np.array_equal(np.array(back), np.array(packed))


def test_encode_min_match_knob():
    """min_match > 4 drops short matches (decode-speed lever): streams stay
    valid, decode back exactly, and contain no match shorter than the
    floor."""
    import numpy as np
    from lz4_tpu.kernels.encode_kernel import (bytes_to_val32_rows,
                                               encode_blocks)
    from lz4_tpu.kernels.common import np_pack_rows
    from lz4_tpu.ops.block_np import decompress_block
    from lz4_tpu.utils.datagen import gen_buffer
    import jax.numpy as jnp

    data = gen_buffer(30_000, 0.7, 424)
    packed, lens = np_pack_rows([data], 30_080)
    val = bytes_to_val32_rows(jnp.asarray(packed), 30_080)
    sizes = {}
    for mm in (4, 8, 12):
        out, olen = encode_blocks(val, jnp.asarray(lens), min_match=mm)
        n = int(np.asarray(olen)[0])
        comp = bytes(np.asarray(out)[0, :n].astype(np.uint8))
        assert decompress_block(comp, len(data)) == data
        sizes[mm] = n
        # parse the stream: every match must be >= mm bytes
        i, end = 0, n
        while i < end:
            tok = comp[i]; i += 1
            ll = tok >> 4
            if ll == 15:
                while True:
                    b = comp[i]; i += 1; ll += b
                    if b != 255:
                        break
            i += ll
            if i >= end:
                break
            i += 2
            ml = tok & 15
            if ml == 15:
                while True:
                    b = comp[i]; i += 1; ml += b
                    if b != 255:
                        break
            assert ml + 4 >= mm, (mm, ml + 4)
    # no monotonicity assert: skipping a short match occasionally exposes a
    # better long one (greedy parse), so sizes may dip slightly; the
    # guarantees are the match floor and round-trip above
    assert sizes[12] > 0.8 * sizes[4]


def test_encode_linked_min_match_knob():
    from lz4_tpu.kernels.encode_kernel import encode_blocks_linked
    from lz4_tpu.kernels.decode_kernel import decode_blocks_linked
    from lz4_tpu.tpu import linked_val_rows, fetch_byte_rows
    from lz4_tpu.utils.datagen import gen_buffer
    import numpy as np
    import jax.numpy as jnp

    data = gen_buffer(3 * 65536, 0.75, 99)
    nb = 3
    val, lens = linked_val_rows(data, 1, nb)
    sizes = {}
    for mm in (4, 10):
        out, olen = encode_blocks_linked(val, jnp.asarray(lens),
                                         min_match=mm)
        olen_np = np.asarray(olen[0])
        outb = fetch_byte_rows(out[0])
        payloads = [outb[k, :olen_np[k]].tobytes() for k in range(nb)]
        M = -(-max(map(len, payloads)) // 128) * 128
        arr = np.zeros((nb, M), np.int32)
        clens = np.zeros((nb,), np.int32)
        for i, c in enumerate(payloads):
            arr[i, :len(c)] = np.frombuffer(c, np.uint8)
            clens[i] = len(c)
        dout, dlen = decode_blocks_linked(jnp.asarray(arr),
                                          jnp.asarray(clens), 65536)
        assert (np.asarray(dlen) == lens[0]).all()
        got = b"".join(bytes(np.asarray(dout)[k, :lens[0][k]].astype(np.uint8))
                       for k in range(nb))
        assert got == data

        def nseq(blk):
            cnt, ip = 0, 0
            while ip < len(blk):
                tok = blk[ip]; ip += 1
                ll = tok >> 4
                if ll == 15:
                    while blk[ip] == 255:
                        ll += 255
                        ip += 1
                    ll += blk[ip]
                    ip += 1
                ip += ll
                cnt += 1
                if ip >= len(blk):
                    break
                ip += 2
                if (tok & 15) == 15:
                    while blk[ip] == 255:
                        ip += 1
                    ip += 1
            return cnt

        sizes[mm] = sum(nseq(c) for c in payloads)
    # the knob's contract: fewer sequences (= faster sequence-bound
    # decode); compressed SIZE may go either way with the exact matcher
    assert sizes[10] < sizes[4]


def test_encode_linked_adaptive_mm_rows():
    """Per-block dynamic min_match (adaptive mode): a uniform mm_rows
    vector must reproduce the static kernel's bytes exactly, and a mixed
    vector must round-trip and honor each block's match floor."""
    from lz4_tpu.kernels.decode_kernel import decode_blocks_linked
    from lz4_tpu.kernels.encode_kernel import (cand_frac8_rows,
                                               encode_blocks_linked)
    from lz4_tpu.tpu import fetch_byte_rows, linked_val_rows
    from lz4_tpu.utils.datagen import gen_buffer
    import numpy as np
    import jax.numpy as jnp

    data = gen_buffer(3 * 65536, 0.8, 123)
    nb = 3
    val, lens = linked_val_rows(data, 1, nb)

    for mm in (4, 12):
        out_s, olen_s = encode_blocks_linked(val, jnp.asarray(lens),
                                             min_match=mm, reject_step=3)
        mmr = jnp.full((1, nb), mm, jnp.int32)
        out_d, olen_d = encode_blocks_linked(val, jnp.asarray(lens),
                                             min_match=4, reject_step=3,
                                             mm_rows=mmr)
        assert (np.asarray(olen_s) == np.asarray(olen_d)).all()
        assert (np.asarray(out_s) == np.asarray(out_d)).all()

    # mixed: block 0 default, block 1 mm=12, block 2 mm=8
    mmr = jnp.asarray([[4, 12, 8]], jnp.int32)
    out, olen = encode_blocks_linked(val, jnp.asarray(lens),
                                     reject_step=3, mm_rows=mmr)
    olen_np = np.asarray(olen[0])
    outb = fetch_byte_rows(out[0])
    payloads = [outb[k, :olen_np[k]].tobytes() for k in range(nb)]
    M = -(-max(map(len, payloads)) // 128) * 128
    arr = np.zeros((nb, M), np.int32)
    clens = np.zeros((nb,), np.int32)
    for i, c in enumerate(payloads):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
        clens[i] = len(c)
    dout, dlen = decode_blocks_linked(jnp.asarray(arr), jnp.asarray(clens),
                                      65536)
    assert (np.asarray(dlen) == lens[0]).all()
    got = b"".join(bytes(np.asarray(dout)[k, :lens[0][k]].astype(np.uint8))
                   for k in range(nb))
    assert got == data

    # the long-match-density statistic is shaped right and bounded
    fr = np.asarray(cand_frac8_rows(val[0, :, 65536:]))
    assert fr.shape == (nb,)
    assert (fr >= 0).all() and (fr <= 1).all()
