#!/usr/bin/env python
"""Benchmark: the device LZ4 codec vs the reference C library.

Protocol mirrors the reference CLI bench (programs/bench.c:240-434): warm
in-memory buffers, best-of-N timed runs, checksum-verified round trip.
Corpus (default): REAL TEXT -- Python stdlib sources, deterministic
(Silesia is not obtainable offline); identical bytes for both sides.
LZ4TPU_BENCH_CORPUS=datagen selects the synthetic mix instead.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "MB/s", "vs_baseline": N, ...extras}

value        = per-GPU decode throughput, KERNEL-only with
               device-resident buffers (warm-memory protocol)
pipeline_*   = END-TO-END frame pipeline (upload + kernels + pack +
               fetch + host frame walk) -- what a file user gets
vs_baseline  = value / reference single-thread decode MB/s measured in
               the same run, or, when the reference library is absent,
               / the reference's published 2297 MB/s, measured on a Xeon
               E5-2697 v3 (README.md:28), which is not this host
device       = platform, device_kind, count, card name and power limit

The script fails when JAX finds no GPU: it never reports CPU numbers.

The default operating point (min_match) is chosen so the LINKED-frame
ratio BEATS the reference's own linked ratio on this corpus
(ratio_vs_baseline_linked <= 1.0) — speed never rides a ratio giveaway.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

# 64MB amortizes the jit dispatch and transfer overhead
CORPUS_MB = int(os.environ.get("LZ4TPU_BENCH_MB", "64"))
BLOCK = 65536
RUNS = 3
# the reference's published single-thread decode rate, measured on a Xeon
# E5-2697 v3 (reference README.md:28, BASELINE.md) -- not this host
PUBLISHED_DECODE_MBS = 2297.0


CORPUS_KIND = os.environ.get("LZ4TPU_BENCH_CORPUS", "pytext")


def real_text_corpus(nbytes: int) -> bytes:
    """Deterministic real-text corpus: Python stdlib sources concatenated
    in sorted order (Silesia is not obtainable offline; this is real
    structured text with Silesia-like redundancy, identical bytes for
    both sides of the comparison)."""
    import sysconfig
    root = Path(sysconfig.get_paths()["stdlib"])
    parts, size = [], 0
    for p in sorted(root.rglob("*.py")):
        try:
            b = p.read_bytes()
        except OSError:
            continue
        parts.append(b)
        size += len(b)
        if size >= nbytes:
            break
    data = b"".join(parts)[:nbytes]
    if len(data) < nbytes:   # stdlib smaller than requested: repeat
        data = (data * (nbytes // max(len(data), 1) + 1))[:nbytes]
    return data


def get_corpus() -> bytes:
    if CORPUS_KIND == "pytext":
        return real_text_corpus(CORPUS_MB * (1 << 20))
    from lz4_tpu.utils.datagen import gen_buffer
    probs = [0.5, 0.7, 0.8, 0.9]
    per = CORPUS_MB * (1 << 20) // len(probs)
    return b"".join(gen_buffer(per, p, seed=7_000 + i)
                    for i, p in enumerate(probs))


def bench_reference(data: bytes):
    """Best-of-N reference-lib encode/decode MB/s over 64KB chunks."""
    sys.path.insert(0, str(REPO / "tests"))
    try:
        from tests import oracle
        if not oracle.available():
            return None
        import ctypes
        lib = oracle.get_lib()
        chunks = [data[i:i + BLOCK] for i in range(0, len(data), BLOCK)]
        bound = BLOCK + BLOCK // 255 + 32
        dsts = [ctypes.create_string_buffer(bound) for _ in chunks]
        enc_t = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            clens = [lib.LZ4_compress_default(c, d, len(c), bound)
                     for c, d in zip(chunks, dsts)]
            enc_t.append(time.perf_counter() - t0)
        comp = [d.raw[:n] for d, n in zip(dsts, clens)]
        outs = [ctypes.create_string_buffer(BLOCK) for _ in chunks]
        dec_t = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            for c, o, ch in zip(comp, outs, chunks):
                lib.LZ4_decompress_safe(c, o, len(c), len(ch))
            dec_t.append(time.perf_counter() - t0)
        mb = len(data) / 1e6
        ratio = sum(clens) / len(data)
        return {"enc_mbs": mb / min(enc_t), "dec_mbs": mb / min(dec_t),
                "ratio": ratio}
    except Exception:
        return None


def bench_reference_linked(data: bytes):
    """Reference LZ4F *linked* 64KB frame baseline -- the matched-mode
    comparison for our linked bench artifact:
    LZ4F_compressFrame with blockMode=blockLinked, blockSizeID=4
    (lz4frame.c:546-555 selects LZ4_compress_fast_continue) and one-shot
    LZ4F_decompress, timed best-of-N on the same bytes."""
    sys.path.insert(0, str(REPO / "tests"))
    try:
        from tests import oracle
        if not oracle.available():
            return None
        import ctypes
        lib = oracle.get_lib()
        frame = oracle.ref_compress_frame(data, block_size_id=4,
                                          block_mode=0)
        enc_t = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            frame = oracle.ref_compress_frame(data, block_size_id=4,
                                              block_mode=0)
            enc_t.append(time.perf_counter() - t0)
        # one-shot LZ4F_decompress into a single pre-sized buffer (no
        # Python-side joins in the timed region: the baseline must not be
        # penalized by harness overhead)
        lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
        lib.LZ4F_decompress.restype = ctypes.c_size_t
        dst = ctypes.create_string_buffer(len(data) + 16)
        dec_t = []
        for _ in range(RUNS):
            ctx = ctypes.c_void_p()
            lib.LZ4F_createDecompressionContext(ctypes.byref(ctx), 100)
            t0 = time.perf_counter()
            dst_sz = ctypes.c_size_t(len(dst))
            src_sz = ctypes.c_size_t(len(frame))
            hint = lib.LZ4F_decompress(ctx, dst, ctypes.byref(dst_sz),
                                       frame, ctypes.byref(src_sz), None)
            dec_t.append(time.perf_counter() - t0)
            lib.LZ4F_freeDecompressionContext(ctx)
            assert not lib.LZ4F_isError(ctypes.c_size_t(hint))
            assert dst_sz.value == len(data)
        assert dst.raw[:len(data)] == data
        mb = len(data) / 1e6
        return {"enc_mbs": mb / min(enc_t), "dec_mbs": mb / min(dec_t),
                "ratio": len(frame) / len(data)}
    except Exception:
        return None


def main():
    import jax

    if jax.default_backend() != "gpu":
        sys.exit("bench.py: JAX found no GPU; device numbers need the card")
    from lz4_tpu.runtime import device_label, use_compile_cache
    use_compile_cache()
    device = device_label()
    data = get_corpus()
    mb = len(data) / 1e6

    ref = bench_reference(data)
    ref_linked = bench_reference_linked(data)

    import jax.numpy as jnp

    from lz4_tpu.frame import FramePreferences
    from lz4_tpu.ops.xxhash_native import xxh64
    from lz4_tpu.tpu import compress_frame_device, decompress_frame_device

    crc0 = xxh64(data)
    prefs = FramePreferences(block_size_id=4, content_size=len(data))

    # encode-side tuning: min_match drops short matches (fewer sequences
    # to decode) and reject_step bounds the rescan cost of rejected
    # candidates.  Operating-point rule: the fastest decode whose linked
    # ratio stays at or below the reference's own linked ratio on the same
    # bytes.  On real text that selected mm=8 (ratio 0.3642 against the
    # reference's 0.3759); mm=6 is the ratio optimum (0.3385) for
    # ratio-first users (--min-match 6); datagen tolerates mm=14.
    _mm_default = "8" if CORPUS_KIND == "pytext" else "14"
    _rj_default = "1" if CORPUS_KIND == "pytext" else "3"
    MM = int(os.environ.get("LZ4TPU_BENCH_MIN_MATCH", _mm_default))
    RJ = int(os.environ.get("LZ4TPU_BENCH_REJECT_STEP", _rj_default))

    # correctness gate: full frame pipeline round-trips bit-exactly
    # (linked mode — the LZ4F default blockMode)
    frame = compress_frame_device(data, prefs, block_size=BLOCK,
                                  min_match=MM, reject_step=RJ)
    out, _ = decompress_frame_device(frame)
    assert xxh64(out) == crc0, "round-trip corrupted"
    ratio = len(frame) / len(data)

    # throughput: warm device-resident buffers, matching the reference
    # bench's warm-memory protocol (programs/bench.c:316-408); completion
    # is forced by fetching the small length vectors.  Timed kernels are
    # the linked-chain codecs -- the same ones the frame pipeline uses.
    from lz4_tpu.kernels.decode_kernel import decode_blocks_linked
    from lz4_tpu.kernels.encode_kernel import encode_blocks_linked
    from lz4_tpu.tpu import linked_val_rows, upload_byte_rows, \
        fetch_byte_rows

    nb = -(-len(data) // BLOCK)
    val, lens = linked_val_rows(data, 1, nb)
    comp, clen = encode_blocks_linked(val, jnp.asarray(lens), 1,
                                      min_match=MM,
                                      reject_step=RJ)  # warm/compile
    clen_np = np.asarray(clen[0])
    block_ratio = clen_np.sum() / len(data)

    # independent-block ratio at the same settings: the honest number
    # against the 64KB-chunk LZ4_compress_default baseline convention
    # (the linked artifact gets window carry the independent baseline
    # doesn't)
    from lz4_tpu.kernels.common import np_pack_rows
    from lz4_tpu.kernels.encode_kernel import bytes_to_val32_rows, \
        encode_blocks
    _chunks = [data[i:i + BLOCK] for i in range(0, len(data), BLOCK)]
    _packed, _ilens = np_pack_rows(_chunks, BLOCK)
    _ival = bytes_to_val32_rows(jnp.asarray(_packed), BLOCK)
    _, _iolen = encode_blocks(_ival, jnp.asarray(_ilens), 1,
                              min_match=MM, reject_step=RJ)
    block_ratio_indep = float(np.asarray(_iolen).sum()) / len(data)
    outb = fetch_byte_rows(comp[0])
    payloads = [outb[k, :clen_np[k]].tobytes() for k in range(nb)]
    M = -(-max(map(len, payloads)) // 128) * 128
    arr = np.zeros((nb, M), np.uint8)
    clens2 = np.zeros((nb,), np.int32)
    for i, c in enumerate(payloads):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
        clens2[i] = len(c)
    rows, clens2_d = upload_byte_rows(arr), jnp.asarray(clens2)
    _, dlen = decode_blocks_linked(rows, clens2_d, BLOCK)
    assert (np.asarray(dlen) == lens[0]).all()

    # optional profiler trace: LZ4TPU_BENCH_PROFILE=<dir> writes a
    # jax.profiler trace covering one encode+decode pass of the timed
    # kernels
    prof_dir = os.environ.get("LZ4TPU_BENCH_PROFILE")
    if prof_dir:
        import jax
        with jax.profiler.trace(prof_dir):
            _ = np.asarray(encode_blocks_linked(val, jnp.asarray(lens), 1,
                                                min_match=MM,
                                                reject_step=RJ)[1])
            _ = np.asarray(decode_blocks_linked(rows, clens2_d, BLOCK)[1])

    enc_t, dec_t = [], []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        _, clen3 = encode_blocks_linked(val, jnp.asarray(lens), 1,
                                        min_match=MM, reject_step=RJ)
        _ = np.asarray(clen3)
        enc_t.append(time.perf_counter() - t0)
    for _ in range(RUNS):
        t0 = time.perf_counter()
        _, dlen2 = decode_blocks_linked(rows, clens2_d, BLOCK)
        _ = np.asarray(dlen2)
        dec_t.append(time.perf_counter() - t0)

    enc_mbs = mb / min(enc_t)
    dec_mbs = mb / min(dec_t)

    # host<->device LINK bandwidth, measured separately from compute so
    # the end-to-end pipeline numbers decompose into transfer vs kernel.
    # Payload: the real content bytes as packed words (the transfer
    # layout every pipeline path uses).
    link_arr = np.frombuffer(data[:len(data) & ~127], np.uint8) \
        .reshape(-1, 128)
    up_t, down_t = [], []
    dev_rows = upload_byte_rows(link_arr)       # warm/compile
    _ = fetch_byte_rows(dev_rows[:4])
    for _ in range(RUNS):
        t0 = time.perf_counter()
        r = upload_byte_rows(link_arr)
        _ = fetch_byte_rows(r[:4])              # force completion
        up_t.append(time.perf_counter() - t0)
    for _ in range(RUNS):
        t0 = time.perf_counter()
        _ = fetch_byte_rows(dev_rows)
        down_t.append(time.perf_counter() - t0)
    link_up_mbs = mb / min(up_t)
    link_down_mbs = mb / min(down_t)

    # END-TO-END pipeline (the number a file user gets): host bytes ->
    # upload -> kernels -> device frame pack -> fetch -> host frame walk
    # and back (reference whole-loop protocol, programs/bench.c:358-408)
    penc_t, pdec_t = [], []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        frame2 = compress_frame_device(data, prefs, block_size=BLOCK,
                                       min_match=MM, reject_step=RJ)
        penc_t.append(time.perf_counter() - t0)
    for _ in range(RUNS):
        t0 = time.perf_counter()
        out2, _ = decompress_frame_device(frame2)
        pdec_t.append(time.perf_counter() - t0)
    pipe_enc_mbs = mb / min(penc_t)
    pipe_dec_mbs = mb / min(pdec_t)

    base_dec = ref["dec_mbs"] if ref else PUBLISHED_DECODE_MBS
    result = {
        "metric": "lz4 linked-block decode, KERNEL on-device (64KB blocks)",
        "device": device,
        "value": round(dec_mbs, 1),
        "unit": "MB/s",
        "vs_baseline": round(dec_mbs / base_dec, 4),
        "encode_mbs": round(enc_mbs, 1),
        "pipeline_decode_mbs": round(pipe_dec_mbs, 1),
        "pipeline_encode_mbs": round(pipe_enc_mbs, 1),
        "link_upload_mbs": round(link_up_mbs, 1),
        "link_fetch_mbs": round(link_down_mbs, 1),
        "ratio": round(ratio, 4),
        "block_ratio": round(float(block_ratio), 4),
        "block_ratio_indep": round(block_ratio_indep, 4),
        "min_match": MM,
        "reject_step": RJ,
        "corpus_mb": round(mb, 1),
        "corpus_note": ("datagen mix p=0.5/0.7/0.8/0.9"
                        if CORPUS_KIND != "pytext" else
                        "python stdlib sources (real text)") +
                       " (Silesia is not obtainable offline; both sides "
                       "measured on identical bytes; "
                       "LZ4TPU_BENCH_CORPUS=pytext selects real text)",
        "baseline_decode_mbs": round(base_dec, 1),
        "baseline_decode_source": (
            "reference library, this run" if ref else
            "published, Xeon E5-2697 v3 (reference README.md:28)"),
        "baseline_encode_mbs": round(ref["enc_mbs"], 1) if ref else None,
        "baseline_ratio": round(ref["ratio"], 4) if ref else None,
        "ratio_vs_baseline": round(ratio / ref["ratio"], 4) if ref else None,
        # matched-mode comparison: our artifact is a LINKED 64KB frame, so
        # the honest ratio gate is against the reference's linked frames
        "baseline_linked_decode_mbs":
            round(ref_linked["dec_mbs"], 1) if ref_linked else None,
        "baseline_linked_encode_mbs":
            round(ref_linked["enc_mbs"], 1) if ref_linked else None,
        "baseline_ratio_linked":
            round(ref_linked["ratio"], 4) if ref_linked else None,
        "ratio_vs_baseline_linked":
            round(ratio / ref_linked["ratio"], 4) if ref_linked else None,
        "provenance": {
            "corpus": CORPUS_KIND,
            "corpus_bytes": len(data),
            "date": time.strftime("%Y-%m-%d"),
            "baselines": ("reference C library timed in-process this "
                          "run (best-of-%d) on the identical bytes" % RUNS
                          if ref else "reference library absent; "
                          "published rate used"),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
