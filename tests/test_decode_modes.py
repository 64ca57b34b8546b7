"""One decode body serves every decode form; each form is checked against
the host codec (``ops/block_np.py``) in interpret mode, together with the
wrappers' padding and the frame decoder's choice of form."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lz4_tpu import io as lio
from lz4_tpu import tpu
from lz4_tpu.frame import FramePreferences, compress_frame
from lz4_tpu.kernels import common
from lz4_tpu.kernels import decode_kernel as dk
from lz4_tpu.ops.block_np import compress_block, decompress_block, \
    decompress_block_dest_size
from lz4_tpu.stream import BlockCompressStream
from lz4_tpu.utils.datagen import gen_buffer

PARTS = [gen_buffer(65536, 0.6, 11), gen_buffer(65536, 0.8, 12),
         gen_buffer(20_000, 0.4, 13)]
DATA = b"".join(PARTS)


def rows(comps, width=None):
    """Compressed payloads -> ([B, M] int32 byte rows, [B] lengths)."""
    M = width or max(128, -(-max(map(len, comps)) // 128) * 128)
    arr = np.zeros((len(comps), M), np.int32)
    for i, c in enumerate(comps):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
    return jnp.asarray(arr), jnp.asarray([len(c) for c in comps], jnp.int32)


def chained(data, sizes):
    """Linked payloads: each chunk may match into everything before it."""
    s = BlockCompressStream()
    out, pos = [], 0
    for n in sizes:
        out.append(s.compress_continue(data[pos:pos + n]))
        pos += n
    return out


def as_bytes(row, n):
    return np.asarray(row)[:n].astype(np.uint8).tobytes()


def mode_batch():
    comps = [compress_block(p) for p in PARTS]
    out, olen = dk.decode_blocks(*rows(comps), 65536)
    got = [as_bytes(out[i], int(olen[i])) for i in range(len(PARTS))]
    return got, [decompress_block(c, 65536) for c in comps]


def mode_dict():
    dicts = [PARTS[0], PARTS[2]]
    srcs = [PARTS[1], PARTS[0][:30_000]]
    comps = [compress_block(s, dict_=d) for s, d in zip(srcs, dicts)]
    drows = np.zeros((2, 65536), np.int32)
    for i, d in enumerate(dicts):
        drows[i, 65536 - len(d):] = np.frombuffer(d, np.uint8)
    out, olen = dk.decode_blocks(
        *rows(comps), 65536, dict_rows=jnp.asarray(drows),
        dict_lens=jnp.asarray([len(d) for d in dicts], jnp.int32))
    got = [as_bytes(out[i], int(olen[i])) for i in range(2)]
    return got, [decompress_block(c, 65536, d)
                 for c, d in zip(comps, dicts)]


def mode_linked():
    comps = chained(DATA, [65536, 65536, 20_000])
    out, olen = dk.decode_blocks_linked(*rows(comps), 65536)
    return (b"".join(as_bytes(out[i], int(olen[i])) for i in range(3)),
            DATA)


def mode_dest_size():
    comps = [compress_block(p) for p in PARTS]
    caps = [5000, 65536, 19_000]
    out, olen, cons = dk.decode_blocks_dest_size(
        *rows(comps), jnp.asarray(caps, jnp.int32), 65536)
    got = [(int(cons[i]), as_bytes(out[i], int(olen[i])))
           for i in range(3)]
    return got, [decompress_block_dest_size(c, cap)
                 for c, cap in zip(comps, caps)]


def mode_sg():
    sizes = [4096, 30_000, 65536, 1000, 50_000]
    data = gen_buffer(sum(sizes), 0.7, 14)
    out, olen = dk.decode_blocks_sg(*rows(chained(data, sizes)), sizes)
    assert np.asarray(olen).tolist() == sizes
    flat = np.asarray(out).reshape(-1)
    return as_bytes(flat[dk.SG_LEAD:], len(data)), data


def mode_stream_256k():
    data = gen_buffer(300_000, 0.7, 15)
    comps = chained(data, [262_144, 300_000 - 262_144])
    out, olen = dk.decode_stream(comps, 262_144, len(data), linked=True)
    assert np.asarray(olen).tolist() == [262_144, 300_000 - 262_144]
    return as_bytes(np.asarray(out).reshape(-1), len(data)), data


MODES = {f.__name__[5:]: f for f in (mode_batch, mode_dict, mode_linked,
                                      mode_dest_size, mode_sg,
                                      mode_stream_256k)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_decode_mode_matches_host_codec(mode):
    got, want = MODES[mode]()
    assert got == want


def test_decode_wrapper_handles_odd_widths():
    """Row widths and capacities need not be multiples of anything."""
    src = [b"abc" * 300, gen_buffer(1000, 0.5, 16)]
    comps = [compress_block(s) for s in src]
    arr, lens = rows(comps, width=max(map(len, comps)) + 3)
    out, olen = dk.decode_blocks(arr, lens, 1001)
    assert out.shape == (2, 1001)
    assert [as_bytes(out[i], int(olen[i])) for i in range(2)] == src


def test_decode_out_caps_bound_each_row():
    comps = [compress_block(p) for p in PARTS[:2]]
    _, olen = dk.decode_blocks(*rows(comps), 65536,
                               out_caps=jnp.asarray([65536, 1000]))
    assert np.asarray(olen).tolist() == [65536, -1]


def test_stream_pads_block_count():
    """Five blocks run as eight; the padding blocks report nothing."""
    data = gen_buffer(5 * 65536, 0.8, 17)
    comps = [compress_block(data[i:i + 65536])
             for i in range(0, len(data), 65536)]
    out, olen = dk.decode_stream(comps, 65536, len(data), linked=False)
    assert np.asarray(olen).tolist() == [65536] * 5
    assert as_bytes(np.asarray(out).reshape(-1), len(data)) == data


@pytest.mark.parametrize("bsid, independent, form", [
    (4, True, "decode_batch"),
    (4, False, "decode_blocks_linked"),
    (5, True, "decode_stream"),
    (5, False, "decode_stream"),
])
def test_frame_decoder_chooses_form(monkeypatch, bsid, independent, form):
    data = gen_buffer(70_000, 0.7, 18)
    frame = compress_frame(data, FramePreferences(
        block_size_id=bsid, block_independent=independent,
        content_checksum=True))
    used = []
    for mod, name in ((tpu, "decode_batch"), (tpu, "decode_blocks_linked"),
                      (dk, "decode_stream")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            used.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    before = sum(tpu.HOST_FALLBACKS.values())
    content, n = tpu.decompress_frame_device(frame)
    assert content == data and n == len(frame)
    assert set(used) == {form}
    assert sum(tpu.HOST_FALLBACKS.values()) == before


def test_short_linked_block_falls_back_and_is_counted():
    """A flushed (short) block mid-chain is legal LZ4F but outside the
    chain kernel's one-block window: the host decodes it, and says so."""
    from lz4_tpu.frame import FrameCompressor
    comp = FrameCompressor(FramePreferences(block_size_id=4))
    data = gen_buffer(100_000, 0.7, 19)
    frame = (comp.begin() + comp.update(data[:1000]) + comp.flush()
             + comp.update(data[1000:]) + comp.end())
    before = tpu.HOST_FALLBACKS["linked block short of its size"]
    content, _ = tpu.decompress_frame_device(frame)
    assert content == data
    assert tpu.HOST_FALLBACKS["linked block short of its size"] == before + 1


@pytest.mark.parametrize("backend, interpret", [("cpu", True),
                                                ("gpu", False),
                                                ("metal", None)])
def test_kernel_route_follows_backend(monkeypatch, backend, interpret):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if interpret is None:
        with pytest.raises(RuntimeError):
            common.on_cpu()
    else:
        assert common.on_cpu() is interpret


def test_device_selection_is_the_gpu(monkeypatch):
    monkeypatch.delenv("LZ4TPU_FORCE_CPU", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert lio._device_available()
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert not lio._device_available()

    def broken():
        raise RuntimeError("backend failed to start")
    monkeypatch.setattr(jax, "default_backend", broken)
    with pytest.raises(RuntimeError):
        lio._device_available()


def sg_frame(data, in_size, out_cap):
    """An SG frame of ``data`` in ``in_size`` input buffers, trimmed to
    the filled output buffers."""
    from lz4_tpu import sg
    ins = [data[i:i + in_size] for i in range(0, len(data), in_size)]
    caps = [out_cap] * (len(ins) + 1)
    total, consumed, outs = sg.sg_compress(ins, caps)
    assert consumed == len(data)
    bufs, rem = [], total
    for b in outs:
        if rem <= 0:
            break
        bufs.append(b[:min(len(b), rem)])
        rem -= len(bufs[-1])
    return bufs, [len(b) for b in ins]


@pytest.mark.parametrize("corpus", ["datagen", "text"])
def test_sg_decompress_on_device_matches_host(corpus):
    """Blocks that do not fill their output slice (text compresses into
    fewer bytes than the slice) decode on the device too."""
    from lz4_tpu import sg
    data = (gen_buffer(16 * 4096, 0.7, 20) if corpus == "datagen"
            else b"".join(b"line %d: the quick brown fox\n" % i
                          for i in range(2400))[:16 * 4096])
    bufs, sizes = sg_frame(data, 4096, 4096)
    before = sum(tpu.HOST_FALLBACKS.values())
    dev = sg.sg_decompress(bufs, sizes, use_device=True)
    assert dev == sg.sg_decompress(bufs, sizes)
    assert b"".join(dev[1]) == data
    assert sum(tpu.HOST_FALLBACKS.values()) == before


def test_sg_decompress_mesh_matches_host():
    from lz4_tpu import sg
    from lz4_tpu.parallel.mesh import default_mesh, sg_decompress_mesh
    frames = [sg_frame(gen_buffer(8192, 0.8, 21 + i), 2048, 2048 + 256)
              for i in range(3)]
    got = sg_decompress_mesh(default_mesh(8), [f for f, _ in frames],
                             [s for _, s in frames])
    assert got == [sg.sg_decompress(f, s) for f, s in frames]


def test_sg_compress_refuses_a_device_request():
    """SG compression runs on the host; a device request is an error, not
    silently ignored."""
    from lz4_tpu import sg
    with pytest.raises(TypeError):
        sg.sg_compress([b"x" * 4096], [8192], use_device=True)


def test_many_blocks_under_a_4mb_header_stay_on_device():
    """The CLI writes 64 KB blocks under a -B7 (4 MB) header.  Each block's
    output is placed by its measured size, not by the header's maximum,
    so hundreds of blocks fit the stream decoder (capacity by the header
    would be 600 x 4 MB, past its int32 positions)."""
    data = gen_buffer(600 * 128, 0.7, 22)
    frame = tpu.compress_frame_device(
        data, FramePreferences(block_size_id=7, block_independent=True,
                               content_checksum=True), block_size=128)
    before = sum(tpu.HOST_FALLBACKS.values())
    assert tpu.decompress_frame_device(frame)[0] == data
    assert sum(tpu.HOST_FALLBACKS.values()) == before
