"""Device destSize decode: the resumable token-boundary stop of the decode
kernel (reference lz4.c:1161-1163, 1316-1319), resumed with the produced
bytes as the dictionary window."""


def test_device_dest_size_decode_resume():
    """Device-side resumable destSize DECODE (lz4.c:1316-1319 rewind):
    rows stop at token boundaries when out of room; host-orchestrated
    resume with the produced bytes as the window reproduces the
    whole-buffer decode; corruption still reports -1."""
    import numpy as np
    import jax.numpy as jnp
    from lz4_tpu.kernels.decode_kernel import (decode_blocks,
                                               decode_blocks_dest_size)
    from lz4_tpu.ops.block_np import compress_block
    from lz4_tpu.utils.datagen import gen_buffer

    blocks = [gen_buffer(4096, 0.7, 70 + i) for i in range(3)]
    comps = [compress_block(b) for b in blocks]
    M = -(-max(map(len, comps)) // 128) * 128
    arr = np.zeros((len(comps), M), np.int32)
    clens = np.zeros((len(comps),), np.int32)
    for i, c in enumerate(comps):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
        clens[i] = len(c)
    arr_j, clens_j = jnp.asarray(arr), jnp.asarray(clens)

    # full-capacity: must behave like decode_blocks with cons == len
    caps = jnp.full((3,), 4096, jnp.int32)
    out, olen, cons = decode_blocks_dest_size(arr_j, clens_j, caps, 4096)
    out, olen, cons = map(np.asarray, (out, olen, cons))
    for i, b in enumerate(blocks):
        assert olen[i] == len(b) and cons[i] == len(comps[i])
        assert bytes(out[i, :4096].astype(np.uint8)) == b

    # constrained capacity: token-boundary stop, then resume with the
    # produced bytes as a dictionary window
    caps = jnp.asarray([1000, 2000, 3000], jnp.int32)
    out, olen, cons = decode_blocks_dest_size(arr_j, clens_j, caps, 4096)
    out, olen, cons = map(np.asarray, (out, olen, cons))
    for i, b in enumerate(blocks):
        assert 0 <= olen[i] <= int(caps[i])
        assert 0 <= cons[i] < len(comps[i])
        piece1 = bytes(out[i, :olen[i]].astype(np.uint8))
        assert piece1 == b[:olen[i]]
        # resume on device: remaining compressed bytes + window
        rest = comps[i][cons[i]:]
        M2 = -(-len(rest) // 128) * 128
        a2 = np.zeros((1, M2), np.int32)
        a2[0, :len(rest)] = np.frombuffer(rest, np.uint8)
        win = piece1[-65536:]
        P = -(-len(win) // 128) * 128
        d2 = np.zeros((1, P), np.int32)
        d2[0, P - len(win):] = np.frombuffer(win, np.uint8)
        out2, olen2, cons2 = decode_blocks_dest_size(
            jnp.asarray(a2), jnp.asarray([len(rest)], jnp.int32),
            jnp.full((1,), 4096, jnp.int32), 4096,
            dict_rows=jnp.asarray(d2),
            dict_lens=jnp.asarray([len(win)], jnp.int32))
        olen2, cons2 = int(np.asarray(olen2)[0]), int(np.asarray(cons2)[0])
        assert cons2 == len(rest)
        piece2 = bytes(np.asarray(out2)[0, :olen2].astype(np.uint8))
        assert piece1 + piece2 == b

    # corruption: offset 0 must report -1, not a clean stop
    bad = bytearray(comps[0])
    i0 = bad[0] >> 4
    bad[1 + i0] = 0
    bad[2 + i0] = 0
    a3 = np.zeros((1, M), np.int32)
    a3[0, :len(bad)] = np.frombuffer(bytes(bad), np.uint8)
    _, olen3, cons3 = decode_blocks_dest_size(
        jnp.asarray(a3), jnp.asarray([len(bad)], jnp.int32),
        jnp.full((1,), 4096, jnp.int32), 4096)
    assert int(np.asarray(olen3)[0]) == -1
    assert int(np.asarray(cons3)[0]) == -1
