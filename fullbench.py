#!/usr/bin/env python
"""Per-entry-point micro-benchmark (the reference's fullbench analog,
programs/fullbench.c): one MB/s line per public codec entry point, on the
host oracle codec, the native helpers, and the GPU kernels and device
frame pipeline.  Every device line names the device it ran on; without a
GPU the device section fails instead of reporting host numbers.

Usage: python fullbench.py [--mb N] [--host-only]
"""

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def timeit(fn, iters=3):
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def report(name, nbytes, secs, where="host"):
    print(f"{name:<44}{nbytes / 1e6 / max(secs, 1e-12):>10.1f} MB/s"
          f"  [{where}]")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--host-only", action="store_true")
    args = ap.parse_args()

    from lz4_tpu.utils.datagen import gen_buffer_np
    from lz4_tpu.ops import block_np
    from lz4_tpu import hc, frame, sg, stream
    from lz4_tpu.ops import xxhash_native, xxhash_np

    data = gen_buffer_np(args.mb << 20, 0.7, 42)
    n = len(data)
    chunk = 65536
    chunks = [data[i:i + chunk] for i in range(0, n, chunk)]
    comp_chunks = [block_np.compress_block(c) for c in chunks]
    small = data[:65536]

    print(f"== host oracle codec ({args.mb} MB corpus, 64KB blocks) ==")
    report("block_np.compress_block", n,
           timeit(lambda: [block_np.compress_block(c) for c in chunks], 1))
    report("block_np.decompress_block", n,
           timeit(lambda: [block_np.decompress_block(c, chunk)
                           for c in comp_chunks], 1))
    report("hc.compress_hc_block level 9 (64KB)", len(small),
           timeit(lambda: hc.compress_hc_block(small, 9), 1))
    f = frame.compress_frame(small)
    report("frame.compress_frame (64KB)", len(small),
           timeit(lambda: frame.compress_frame(small), 1))
    report("frame.decompress_frame (64KB)", len(small),
           timeit(lambda: frame.decompress_frame(f), 1))
    st = stream.BlockCompressStream()
    report("stream.compress_continue (16KB chain)", len(small),
           timeit(lambda: [st.compress_continue(small[i:i + 16384])
                           for i in range(0, len(small), 16384)], 1))
    ins = [small[i:i + 4096] for i in range(0, len(small), 4096)]
    caps = [4096 + 128] * 17
    report("sg.sg_compress (16x4KB)", len(small),
           timeit(lambda: sg.sg_compress(ins, caps), 1))
    total, _, outs = sg.sg_compress(ins, caps)
    comp_bufs = []
    rem = total
    for b, c in zip(outs, caps):
        if rem <= 0:
            break
        take = min(c, rem)
        comp_bufs.append(b[:take])
        rem -= take
    if len(comp_bufs) > 1 and len(comp_bufs[-1]) < 2:
        comp_bufs[-2] += comp_bufs.pop()  # merge endmark tail (<2B buffers)
    report("sg.sg_decompress (16x4KB)", len(small),
           timeit(lambda: sg.sg_decompress(comp_bufs, [4096] * 16), 1))

    print("== checksums ==")
    report("xxhash_native.xxh32", n, timeit(lambda: xxhash_native.xxh32(data)))
    report("xxhash_native.xxh64", n, timeit(lambda: xxhash_native.xxh64(data)))
    report("xxhash_np.xxh32 (python, 64KB)", len(small),
           timeit(lambda: xxhash_np.xxh32(small), 1))

    if args.host_only:
        return

    import jax
    if jax.default_backend() != "gpu":
        sys.exit("fullbench: JAX found no GPU; the device section needs "
                 "the card (--host-only runs the host section alone)")
    from lz4_tpu.runtime import device_label, use_compile_cache
    use_compile_cache()
    dev = device_label()
    where = (f"{dev['platform']} {dev['kind']} x{dev['count']}, "
             f"{dev['card']}")

    def dreport(name, nbytes, secs):
        report(name, nbytes, secs, where)

    import jax.numpy as jnp
    from lz4_tpu.kernels.common import np_pack_rows
    from lz4_tpu.kernels.decode_kernel import decode_blocks
    from lz4_tpu.kernels.encode_kernel import bytes_to_val32_rows, \
        encode_blocks
    from lz4_tpu.tpu import compress_frame_device, decompress_frame_device

    print("== device kernels (device-resident, 64KB blocks) ==")
    packed, lens = np_pack_rows(chunks, chunk)
    pd, ld = jnp.asarray(packed), jnp.asarray(lens)

    def enc():
        val = bytes_to_val32_rows(pd, chunk)
        c, cl = encode_blocks(val, ld)
        np.asarray(cl)
        return c, cl

    comp_d, clen_d = enc()
    dreport("kernels.encode_blocks", n, timeit(lambda: enc()))

    def dec():
        _, ol = decode_blocks(comp_d, clen_d, chunk)
        np.asarray(ol)
    dec()
    dreport("kernels.decode_blocks", n, timeit(dec))

    from lz4_tpu.kernels.decode_kernel import decode_blocks_linked

    def declink():
        _, ol = decode_blocks_linked(comp_d, clen_d, chunk)
        np.asarray(ol)
    declink()
    dreport("kernels.decode_blocks_linked", n, timeit(declink))

    from lz4_tpu.kernels.decode_kernel import decode_blocks_sg

    # SG chain decode: same payloads, arbitrary output offsets
    sg_sizes = [int(x) for x in np.asarray(lens)]

    def sgdec():
        out, ol = decode_blocks_sg(comp_d, clen_d, sg_sizes)
        np.asarray(ol)
    sgdec()
    dreport("kernels.decode_blocks_sg", n, timeit(sgdec))

    from lz4_tpu.kernels.decode_kernel import decode_blocks_dest_size

    dhalf = jnp.asarray(np.full((len(chunks),), chunk // 2, np.int32))

    def decds():
        _, ol, cons = decode_blocks_dest_size(comp_d, clen_d, dhalf,
                                              chunk // 2)
        np.asarray(cons)
    decds()
    dreport("kernels.decode_dest_size (cap=n/2, resumable)", n // 2,
           timeit(decds))

    # stream decoder: raw 256KB-block frame at arbitrary byte offsets
    from lz4_tpu.frame import FramePreferences
    from lz4_tpu.tpu import _decompress_frame_device_stream
    from lz4_tpu.frame import decode_frame_header

    # a real 256KB-block frame via the host codec (the stream decoder
    # engages for >64KB blocks)
    from lz4_tpu.frame import FrameCompressor
    fc = FrameCompressor(FramePreferences(block_size_id=5))
    frame5 = fc.begin() + fc.update(data) + fc.end()
    info5 = decode_frame_header(frame5)

    def sdec():
        _decompress_frame_device_stream(frame5, info5)
    sdec()
    dreport("kernels.decode_stream (256KB blocks, raw frame)", n,
           timeit(sdec, 1))

    print("== device frame pipeline (incl. host assembly + transfers) ==")
    fr = compress_frame_device(data)
    dreport("tpu.compress_frame_device", n,
           timeit(lambda: compress_frame_device(data), 1))
    dreport("tpu.decompress_frame_device", n,
           timeit(lambda: decompress_frame_device(fr), 1))


if __name__ == "__main__":
    main()
