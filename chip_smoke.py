#!/usr/bin/env python
"""Smoke check of the device path on one NVIDIA GPU (four with --four).

Drives the LZ4F frame path through the entry points a user calls, at the
benchmark's size (64 MiB of Python-stdlib text), and checks every result
against the host codec:

  1. compile each kernel at its real widths and print its memory use;
  2. the frame path: compress_frame_device / decompress_frame_device at
     the LZ4F default (linked 64 KB blocks, content checksum), then with
     independent blocks; the first MiB must reproduce a recorded frame;
  3. 16 MiB frames the host codec wrote with 4 MB blocks (the reference
     CLI default, -B7), independent and linked;
  4. the CLI, called in-process, on a 64 MiB file;
  5. batch, scatter-gather, destSize resume and malformed blocks.

``--four`` runs only the four-card phase: a mesh round trip and a
256 MiB mesh-compressed frame, each compared with the same work on one
card.

Every comparison is byte equality.  The script exits non-zero, with no
result line, when JAX finds no GPU or any phase fails; a decode that
falls back to the host codec is a failure.  Times printed are smoke
timings, not benchmark numbers.  Usage:

    python chip_smoke.py            # one card
    python chip_smoke.py --four     # four cards
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
MAIN_BYTES = 64 << 20      # the benchmark's corpus size
STREAM_BYTES = 16 << 20    # frames with 4 MB blocks
BATCH = 1024               # buffers of 4-64 KB in the batch phase
MESH_BLOCKS = 256          # 64 KB blocks per card in the mesh round trip
MESH_BYTES = 256 << 20     # the mesh-compressed frame
SEED = 0x5EED


def say(*parts) -> None:
    print(*parts, flush=True)


def corpus(nbytes: int) -> bytes:
    from bench import real_text_corpus
    return real_text_corpus(nbytes)


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def check_no_host_fallback(phase: str) -> None:
    from lz4_tpu import tpu
    expect(not tpu.HOST_FALLBACKS,
           f"{phase}: host fallback fired {dict(tpu.HOST_FALLBACKS)}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_compile() -> None:
    """Compile each kernel at its real widths; print its memory use."""
    import jax
    import jax.numpy as jnp

    from lz4_tpu.kernels import decode_kernel as dk
    from lz4_tpu.kernels import encode_kernel as ek
    from lz4_tpu.kernels import pack
    from lz4_tpu.spec import compress_bound

    S = jax.ShapeDtypeStruct
    i32, u8 = jnp.int32, jnp.uint8
    B, BS = 1024, 65536
    M = -(-compress_bound(BS) // 128) * 128
    steps = {
        "decode, 1024 x 64 KB rows": dk._decode_blocks.lower(
            S((B, M), i32), S((B,), i32), S((B, 0), i32), S((B,), i32),
            S((B,), i32), N=BS, resumable=False, interpret=False),
        "stream block sizes, one 4 MB block": dk._block_sizes.lower(
            S((4, 4), i32), S((8 << 20,), u8), interpret=False),
        "stream decode, one 4 MB block": dk._decode_chain.lower(
            S((4, 6), i32), S((8 << 20,), u8), S((8 << 20,), u8),
            window="fixed", block=0, parallel=True, interpret=False),
        "linked encode, 1024 x [prev | cur]": ek._encode_blocks_linked.lower(
            S((1, B, 2 * BS), i32), S((1, B), i32), S((1,), i32), None,
            acceleration=1, interpret=False, min_match=4, reject_step=1),
        "frame pack, 1024 blocks": pack._pack.lower(
            S((B, M), i32), S((B,), i32), S((B, BS), i32), S((B,), i32),
            TB=-(-(B * (4 + M)) // 128) * 128),
    }
    for name, lowered in steps.items():
        say(f"  {name}: {lowered.compile().memory_analysis()}")


def phase_frame() -> None:
    """The frame path at the LZ4F default, then with independent blocks."""
    from lz4_tpu import tpu
    from lz4_tpu.frame import FramePreferences, decompress_frame

    data = corpus(MAIN_BYTES)
    for name, independent in (("linked 64 KB (LZ4F default)", False),
                              ("independent 64 KB (-BI)", True)):
        prefs = FramePreferences(block_independent=independent,
                                 content_checksum=True)
        frame = tpu.compress_frame_device(data, prefs)
        content, used = tpu.decompress_frame_device(frame)
        expect(content == data and used == len(frame),
               f"{name}: device round trip")
        expect(decompress_frame(frame)[0] == data,
               f"{name}: host decode of the device frame")
        say(f"  {name}: {len(data)} -> {len(frame)} bytes, "
            f"ratio {len(frame) / len(data):.4f}")

    # the first MiB, as the previous encoder wrote it
    want = (REPO / "tests/fixtures/stdlib_1mib_linked.lz4").read_bytes()
    first, _ = decompress_frame(want)
    got = tpu.compress_frame_device(
        first, FramePreferences(block_independent=False,
                                content_checksum=True))
    expect(got == want, "first MiB: frame differs from the recorded one")
    say(f"  first MiB frame matches the recorded frame "
        f"({len(want)} bytes); this machine's stdlib "
        f"{'starts with' if data[:len(first)] == first else 'differs from'}"
        " the recorded MiB")
    check_no_host_fallback("frame")


def phase_stream() -> None:
    """Host-written 4 MB-block frames through the device stream decoder."""
    from lz4_tpu import tpu
    from lz4_tpu.frame import FramePreferences, compress_frame

    data = corpus(STREAM_BYTES)
    for independent in (True, False):
        frame = compress_frame(data, FramePreferences(
            block_size_id=7, block_independent=independent,
            content_checksum=True))
        content, used = tpu.decompress_frame_device(frame)
        expect(content == data and used == len(frame),
               f"4 MB blocks, independent={independent}")
        say(f"  4 MB blocks, {'independent' if independent else 'linked'}:"
            f" {len(frame)} bytes decoded")
    check_no_host_fallback("stream")


def phase_cli() -> None:
    """The CLI, in-process, on a 64 MiB file; the device is chosen
    automatically."""
    from lz4_tpu import cli, io, tpu

    expect(io._device_available(), "CLI: device not selected")
    calls = {"encode_batch": 0, "decompress_frame_device": 0}
    real = {name: getattr(tpu, name) for name in calls}
    for name in calls:
        def spy(*a, _name=name, **k):
            calls[_name] += 1
            return real[_name](*a, **k)
        setattr(tpu, name, spy)
    try:
        data = corpus(MAIN_BYTES)
        with tempfile.TemporaryDirectory() as d:
            src = Path(d) / "corpus.bin"
            src.write_bytes(data)
            lz4 = Path(d) / "corpus.bin.lz4"
            out = Path(d) / "corpus.out"
            expect(cli.main(["lz4t", "-q", "-f", str(src), str(lz4)]) == 0,
                   "CLI compress")
            expect(cli.main(["lz4t", "-q", "-d", "-f", str(lz4),
                             str(out)]) == 0, "CLI decompress")
            expect(out.read_bytes() == data, "CLI round trip")
            size = lz4.stat().st_size
    finally:
        for name, fn in real.items():
            setattr(tpu, name, fn)
    expect(calls["encode_batch"] > 0 and calls["decompress_frame_device"] > 0,
           f"CLI did not run the device path: {calls}")
    say(f"  CLI: {len(data)} -> {size} bytes and back; device calls {calls}")
    check_no_host_fallback("cli")


def phase_batch_sg() -> None:
    """Batch API, SG decode, destSize resume and malformed blocks."""
    import jax.numpy as jnp

    from lz4_tpu import block, sg
    from lz4_tpu.kernels.decode_kernel import decode_blocks, \
        decode_blocks_dest_size
    from lz4_tpu.ops.block_np import Lz4BlockError, compress_block, \
        decompress_block

    rng = np.random.default_rng(SEED)
    text = corpus(MAIN_BYTES)
    sizes = rng.integers(4096, 65537, BATCH)
    starts = rng.integers(0, len(text) - 65536, BATCH)
    bufs = [text[s:s + n] for s, n in zip(starts, sizes)]
    comps = block.compress_batch(bufs)
    expect(block.decompress_batch(comps, 65536) == bufs, "batch round trip")
    expect(all(decompress_block(c, len(b)) == b
               for c, b in zip(comps, bufs)), "host decode of batch blocks")
    say(f"  batch: {BATCH} buffers, {sum(map(len, bufs))} -> "
        f"{sum(map(len, comps))} bytes")

    ins = [text[i * 4096:(i + 1) * 4096] for i in range(16)]
    caps = [4096] * 17
    total, consumed, outs = sg.sg_compress(ins, caps)
    expect(consumed == 16 * 4096 and total > 0, "SG compress")
    comp_bufs, rem = [], total
    for b in outs:
        if rem <= 0:
            break
        comp_bufs.append(b[:min(len(b), rem)])
        rem -= len(comp_bufs[-1])
    host = sg.sg_decompress(comp_bufs, [4096] * 16)
    dev = sg.sg_decompress(comp_bufs, [4096] * 16, use_device=True)
    expect(dev == host and b"".join(dev[1]) == b"".join(ins),
           "SG decode on the device")
    say(f"  SG: 16 x 4 KB -> {total} bytes in {len(comp_bufs)} buffers")

    # destSize: stop at a token boundary, then resume with the window
    blk = [text[i * 65536:(i + 1) * 65536] for i in range(4)]
    cb = [compress_block(b) for b in blk]
    arr, clen = _rows(cb)
    caps = jnp.asarray([1000, 30000, 65535, 65536], jnp.int32)
    out, olen, cons = map(np.asarray, decode_blocks_dest_size(
        arr, clen, caps, 65536))
    for i, b in enumerate(blk):
        head = out[i, :olen[i]].astype(np.uint8).tobytes()
        rest = cb[i][cons[i]:]
        win = np.zeros((1, 65536), np.int32)
        win[0, 65536 - len(head):] = np.frombuffer(head, np.uint8)
        a2, l2 = _rows([rest])
        out2, olen2, cons2 = map(np.asarray, decode_blocks_dest_size(
            a2, l2, jnp.asarray([65536], jnp.int32), 65536,
            dict_rows=jnp.asarray(win),
            dict_lens=jnp.asarray([len(head)], jnp.int32)))
        tail = out2[0, :olen2[0]].astype(np.uint8).tobytes()
        expect(cons2[0] == len(rest) and head + tail == b,
               f"destSize resume, block {i}")
    say(f"  destSize: stopped at {olen.tolist()} bytes and resumed")

    # malformed blocks: the device's verdicts are the host codec's
    cases = _malformed(rng, text)
    arr, clen = _rows(cases)
    out, olen = map(np.asarray, decode_blocks(arr, clen, 65536))
    rejected = 0
    for i, c in enumerate(cases):
        try:
            ref = decompress_block(c, 65536)
        except Lz4BlockError:
            expect(olen[i] == -1, f"malformed case {i}: accepted")
            rejected += 1
            continue
        expect(olen[i] == len(ref) and
               out[i, :olen[i]].astype(np.uint8).tobytes() == ref,
               f"malformed case {i}: output differs")
    say(f"  malformed: {len(cases)} cases, {rejected} rejected by both")
    check_no_host_fallback("batch/sg")


def _rows(comps):
    import jax.numpy as jnp

    M = max(128, -(-max(map(len, comps)) // 128) * 128)
    arr = np.zeros((len(comps), M), np.int32)
    for i, c in enumerate(comps):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
    return jnp.asarray(arr), jnp.asarray([len(c) for c in comps], jnp.int32)


def _malformed(rng, text):
    """Truncations, bit flips, literal-length bombs, wild offsets and
    offset 0, on blocks of up to 64 KB."""
    from lz4_tpu.ops.block_np import compress_block

    cases = []
    for i in range(96):
        n = int(rng.integers(1, 65537))
        s = int(rng.integers(0, len(text) - n))
        comp = bytearray(compress_block(text[s:s + n]))
        kind = i % 4
        if kind == 0 and len(comp) > 4:
            comp = comp[:int(rng.integers(1, len(comp)))]
        elif kind == 1:
            comp[int(rng.integers(len(comp)))] ^= 1 << int(rng.integers(8))
        elif kind == 2:
            comp = (bytearray([0xF0]) + bytearray([255] * int(
                rng.integers(1, 31))) + comp)
        else:
            comp = bytearray([0x12, 0xAA, 0xFF, 0xFF]) + comp
        cases.append(bytes(comp))
    cases.append(bytes([0xF0, 255, 255, 255, 255, 10]) + b"A" * 4)
    cases.append(bytes([0x10, 65, 0, 0, 0]))
    return cases


def phase_four() -> None:
    """A mesh round trip and a mesh-compressed frame on four cards, each
    compared with the same work on one card."""
    import jax
    import jax.numpy as jnp

    from lz4_tpu.frame import decompress_frame
    from lz4_tpu.kernels.common import np_pack_rows
    from lz4_tpu.parallel.mesh import compress_frame_mesh, default_mesh, \
        roundtrip_step, shard_rows

    expect(len(jax.devices()) >= 4, "four cards needed")
    mesh4, mesh1 = default_mesh(4), default_mesh(1)
    text = corpus(MESH_BYTES)
    B = 4 * MESH_BLOCKS
    packed, lens = np_pack_rows(
        [text[i * 65536:(i + 1) * 65536] for i in range(B)], 65536)
    results = {}
    for name, mesh in (("four cards", mesh4), ("one card", mesh1)):
        words = shard_rows(mesh, jnp.asarray(packed))
        ln = shard_rows(mesh, jnp.asarray(lens))
        step = jax.jit(lambda w, l, m=mesh: roundtrip_step(m, w, l, 65536))
        clen, olen, bad = step(words, ln)
        expect(int(bad) == 0 and (np.asarray(olen) == lens).all(),
               f"mesh round trip on {name}")
        results[name] = np.asarray(clen)
        say(f"  round trip on {name}: {B} x 64 KB -> "
            f"{int(results[name].sum())} bytes; shards on "
            f"{sorted({str(s.device) for s in clen.addressable_shards})}")
    expect((results["four cards"] == results["one card"]).all(),
           "compressed lengths differ between four cards and one")

    frames = {name: compress_frame_mesh(mesh, text)
              for name, mesh in (("four cards", mesh4), ("one card", mesh1))}
    expect(frames["four cards"] == frames["one card"],
           "mesh frame differs between four cards and one")
    expect(decompress_frame(frames["four cards"])[0] == text,
           "host decode of the mesh frame")
    say(f"  mesh frame: {len(text)} -> {len(frames['four cards'])} bytes, "
        "identical on four cards and one")


PHASES = {
    "compile": phase_compile,
    "frame": phase_frame,
    "stream": phase_stream,
    "cli": phase_cli,
    "batch_sg": phase_batch_sg,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from lz4_tpu.runtime import card_name_and_power, use_compile_cache

    use_compile_cache()
    dev = jax.devices()[0]
    say(card_name_and_power())
    say(f"jax {jax.__version__}, {dev.device_kind}, "
        f"{len(jax.devices())} device(s)")
    phases = {"four": phase_four} if args.four else PHASES
    for name, phase in phases.items():
        t0 = time.perf_counter()
        say(f"phase {name}")
        phase()
        say(f"  smoke timing (not a benchmark): {name} "
            f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
