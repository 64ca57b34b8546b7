"""lz4-compatible command line interface.

Capability parity with the reference CLI (reference ``programs/lz4cli.c``):
gzip-like UX, levels ``-0..-16``, ``-d/-z/-t/-f/-c/-m/-k/-l``, block knobs
``-B4..-B7 -BD -BX``, ``--content-size``, ``--[no-]frame-crc``,
``--[no-]sparse``, ``--rm``, ``-b`` benchmark mode (programs/bench.c),
stdin/stdout via ``-``, console-safety refusals (lz4cli.c:493-497), output
name derivation (lz4cli.c:508-540), and the ``lz4cat``/``unlz4`` argv[0]
personalities (lz4cli.c:301-302).

Run as ``python -m lz4_tpu.cli`` or via the installed ``lz4t`` script.
"""

from __future__ import annotations

import os
import sys
import time

from . import __version__, spec
from .io import (
    IoPrefs,
    LZ4_EXTENSION,
    compress_filename,
    compress_multiple,
    decompress_filename,
    decompress_multiple,
)

USAGE = f"""\
*** tpu-lz4 v{__version__}, GPU-accelerated LZ4 CLI ***
Usage: lz4t [arg] [input] [output]

input/output  : files or `-` for stdin/stdout
Arguments:
 -1..-2       : fast compression (default: -1)
 -3..-16      : high compression (LZ4HC levels)
 -d           : decompression
 -z           : force compression
 -t           : test compressed file integrity
 -f           : overwrite output without prompting
 -c           : force write to stdout
 -m           : compress multiple input files (output: file.lz4)
 -k           : keep source files (default)
 --rm         : remove source files after success
 -l           : use legacy frame format (0x184C2102)
 -B4..-B7     : block size 64KB / 256KB / 1MB / 4MB (default: -B7)
 -BD          : block dependency (improves small-block ratio)
 -BX          : add block checksums
 --content-size   : embed the uncompressed size in the frame header
 --[no-]frame-crc : content checksum (default: enabled)
 --[no-]sparse    : sparse file support on decode (default: enabled)
 --min-match=N    : drop matches shorter than N bytes (N>=4; larger output,
                    proportionally faster decode -- a device speed lever)
 -b#          : benchmark file(s) at level #
 -i#          : iterations for benchmark (default: 3)
 -q / -v      : quieter / more verbose
 -h / -H      : this help
 -V / --version : show version
"""


def _die(msg: str, code: int = 1):
    print(f"lz4t: {msg}", file=sys.stderr)
    sys.exit(code)


def _derive_output(input_name: str, decompress: bool) -> str:
    """Output-name derivation (lz4cli.c:508-540)."""
    if input_name == "-":
        return "-"
    if decompress:
        if input_name.endswith(LZ4_EXTENSION):
            return input_name[:-len(LZ4_EXTENSION)]
        _die(f"cannot determine output name for {input_name} "
             "(no .lz4 suffix); specify one")
    return input_name + LZ4_EXTENSION


def _timed_rate(fn, nbytes: int, iterations: int, min_seconds: float):
    """Reference bench protocol (programs/bench.c:99-100, 358-408): each
    measurement loops ``fn`` until at least ``min_seconds`` of wall time
    have elapsed (so short inputs are not dispatch-noise), rate = bytes
    processed / elapsed; best rate over ``iterations`` measurements.
    Returns (best_bytes_per_second, last_result)."""
    best = 0.0
    result = fn()          # warm: jit compiles stay out of the windows
    for _ in range(max(1, iterations)):
        loops = 0
        t0 = time.perf_counter()
        while True:
            result = fn()
            loops += 1
            el = time.perf_counter() - t0
            if el >= min_seconds:
                break
        best = max(best, nbytes * loops / max(el, 1e-9))
    return best, result


def _bench(paths, prefs: IoPrefs, level: int, iterations: int) -> int:
    """-b mode (parity: BMK_benchFiles, programs/bench.c:240-434):
    4MB default chunking (bench.c:107), >=2s timed windows per
    measurement / best-of-N (bench.c:99-100, 358-408), and an XXH32
    round-trip verification (bench.c:346, 406-407).  LZ4T_BENCH_SECONDS
    shortens the window for CI."""
    import numpy as _np

    from .ops.xxhash_native import xxh32
    from .hc import compress_hc_block
    from .ops.block_np import compress_block, decompress_block
    from .io import _device_available
    from .runtime import device_label

    min_s = float(os.environ.get("LZ4T_BENCH_SECONDS", "2.0"))
    # -B sets the chunk size like the reference's bench (bench.c:107);
    # default -B7 = 4MB
    chunk_size = spec.BLOCK_SIZES.get(prefs.block_size_id, 4 * 1024 * 1024)
    for path in paths:
        data = open(path, "rb").read()
        chunks = [data[i:i + chunk_size]
                  for i in range(0, len(data), chunk_size)] or [b""]
        crc0 = xxh32(data)
        use_device = _device_available()
        if use_device and level < 3:
            dev = device_label()
            where = (f"{dev['platform']} {dev['kind']} x{dev['count']}, "
                     f"{dev['card']}")
        else:
            where = "host codec"

        if use_device and level < 3:
            # fast levels: the linked-chain codecs (the same kernels the
            # frame pipeline uses); chunking matches the reference's
            # whole-chunk LZ4_compress semantics at 64KB window ratio
            import jax.numpy as _jnp
            from .kernels.decode_kernel import decode_blocks_linked
            from .kernels.encode_kernel import encode_blocks_linked
            from .tpu import linked_val_rows, upload_byte_rows, \
                fetch_byte_rows
            bs = 65536
            nb = -(-max(len(data), 1) // bs)
            val, lens = linked_val_rows(data, 1, nb)
            lens_d = _jnp.asarray(lens)
            mm = max(4, prefs.min_match)

            def enc_once():
                comp, clen = encode_blocks_linked(
                    val, lens_d, max(1, prefs.acceleration), min_match=mm)
                return comp, _np.asarray(clen[0])

            rate_c, (comp_d, clen_np) = _timed_rate(
                enc_once, len(data), iterations, min_s)
            comp_size = int(clen_np.sum())
            outb = fetch_byte_rows(comp_d[0])
            payloads = [outb[k, :clen_np[k]].tobytes() for k in range(nb)]
            M = -(-max(map(len, payloads)) // 128) * 128
            arr = _np.zeros((nb, M), _np.uint8)
            clens2 = _np.zeros((nb,), _np.int32)
            for i, c in enumerate(payloads):
                arr[i, :len(c)] = _np.frombuffer(c, _np.uint8)
                clens2[i] = len(c)
            rows_d = upload_byte_rows(arr)
            clens2_d = _jnp.asarray(clens2)

            def dec_once():
                out, dlen = decode_blocks_linked(rows_d, clens2_d, bs)
                return out, _np.asarray(dlen)

            rate_d, (out_d, dlen_np) = _timed_rate(
                dec_once, len(data), iterations, min_s)
            outb2 = fetch_byte_rows(out_d)
            rebuilt = b"".join(
                outb2[k, :dlen_np[k]].tobytes() for k in range(nb))
        else:
            def enc(c):
                return (compress_hc_block(c, level) if level >= 3
                        else compress_block(c, max(1, prefs.acceleration)))

            rate_c, comp = _timed_rate(
                lambda: [enc(c) for c in chunks], len(data), iterations,
                min_s)
            comp_size = sum(len(c) for c in comp)
            rate_d, outs = _timed_rate(
                lambda: [decompress_block(c, len(ch))
                         for c, ch in zip(comp, chunks)],
                len(data), iterations, min_s)
            rebuilt = b"".join(outs)

        if xxh32(rebuilt) != crc0:
            _die(f"{path}: benchmark round-trip corruption!")
        n = max(1, len(data))
        print(f"{os.path.basename(path):<20}:{len(data):>9} ->"
              f"{comp_size:>9} ({100.0 * comp_size / n:6.2f}%),"
              f"{rate_c / 1e6:8.1f} MB/s,"
              f"{rate_d / 1e6:8.1f} MB/s  [{where}]")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = os.path.basename(argv[0]) if argv else "lz4t"
    args = argv[1:]

    prefs = IoPrefs()
    decompress = False
    force_stdout = False
    multiple = False
    bench_mode = False
    level = 1
    iterations = 3
    files: list[str] = []

    # argv[0] personalities (lz4cli.c:301-302)
    if "lz4cat" in prog:
        decompress = True
        force_stdout = True
        prefs.overwrite = True
    elif "unlz4" in prog:
        decompress = True

    i = 0
    while i < len(args):
        a = args[i]
        i += 1
        if a == "--":
            files += args[i:]
            break
        if a in ("-h", "-H", "--help"):
            print(USAGE)
            return 0
        if a in ("-V", "--version"):
            print(f"tpu-lz4 v{__version__} (LZ4 frame spec v1.5.1)")
            return 0
        if a == "--content-size":
            prefs.content_size = True
            continue
        if a == "--frame-crc":
            prefs.content_checksum = True
            continue
        if a == "--no-frame-crc":
            prefs.content_checksum = False
            continue
        if a == "--sparse":
            prefs.sparse = True
            continue
        if a == "--no-sparse":
            prefs.sparse = False
            continue
        if a.startswith("--min-match"):
            # encode-side speed lever: drop matches shorter than N bytes
            # (fewer sequences -> faster decode, larger output)
            try:
                prefs.min_match = max(4, int(a.split("=", 1)[1]))
            except (IndexError, ValueError):
                _die("--min-match=N expects an integer >= 4")
            continue
        if a == "--rm":
            prefs.remove_src = True
            continue
        if a == "--keep":
            prefs.remove_src = False
            continue
        if a in ("-", ):
            files.append("-")
            continue
        if a.startswith("--"):
            _die(f"unknown option {a}")
        if a.startswith("-") and len(a) > 1:
            j = 1
            while j < len(a):
                c = a[j]
                if c.isdigit():
                    # compression level, possibly multi-digit
                    k = j
                    while k < len(a) and a[k].isdigit():
                        k += 1
                    level = int(a[j:k])
                    if level > 16:
                        level = 16
                    prefs.level = level
                    j = k
                    continue
                if c == "z":
                    decompress = False
                elif c == "d":
                    decompress = True
                elif c == "t":
                    prefs.test_mode = True
                    decompress = True
                elif c == "f":
                    prefs.overwrite = True
                elif c == "c":
                    force_stdout = True
                    prefs.overwrite = True
                elif c == "m":
                    multiple = True
                elif c == "k":
                    prefs.remove_src = False
                elif c == "l":
                    prefs.legacy = True
                elif c == "q":
                    prefs.verbosity = max(0, prefs.verbosity - 1)
                elif c == "v":
                    prefs.verbosity += 1
                elif c == "b":
                    bench_mode = True
                    if j + 1 < len(a) and a[j + 1].isdigit():
                        k = j + 1
                        while k < len(a) and a[k].isdigit():
                            k += 1
                        level = int(a[j + 1:k])
                        prefs.level = level
                        j = k - 1
                elif c == "i":
                    if j + 1 < len(a) and a[j + 1].isdigit():
                        iterations = int(a[j + 1])
                        j += 1
                elif c == "B":
                    if j + 1 < len(a) and a[j + 1] in "4567":
                        prefs.block_size_id = int(a[j + 1])
                        j += 1
                    elif j + 1 < len(a) and a[j + 1] == "D":
                        prefs.block_linked = True
                        j += 1
                    elif j + 1 < len(a) and a[j + 1] == "X":
                        prefs.block_checksum = True
                        j += 1
                    else:
                        _die("-B expects 4..7, D or X")
                else:
                    _die(f"unknown option -{c}")
                j += 1
            continue
        files.append(a)

    from .io import _device_available
    from .runtime import use_compile_cache
    if _device_available():
        use_compile_cache()

    if bench_mode:
        if not files:
            _die("benchmark mode needs at least one file")
        return _bench(files, prefs, level, iterations)

    if not files:
        if sys.stdin.isatty():
            print(USAGE)
            return 0
        files = ["-"]

    if multiple:
        if decompress:
            return decompress_multiple(files, prefs)
        return compress_multiple(files, prefs)

    src = files[0]
    dst = files[1] if len(files) > 1 else None
    if dst is None:
        if force_stdout or src == "-":
            dst = "-"
        else:
            dst = _derive_output(src, decompress)

    # console-safety refusals (lz4cli.c:493-497, 543-547)
    if dst == "-" and sys.stdout.isatty() and not decompress \
            and not prefs.test_mode and not force_stdout:
        _die("refusing to write compressed data to a terminal; use -c or -f")

    # pass-through: forced decompression of non-LZ4 input copies it verbatim
    # (reference lz4io.c:946-952 gated on g_overwrite; lz4cat sets it too)
    prefs.pass_through = decompress and prefs.overwrite

    try:
        if decompress:
            r, w = decompress_filename(src, dst, prefs)
            if prefs.test_mode and prefs.verbosity >= 2:
                print(f"{src:<30}: decoded {w} bytes OK", file=sys.stderr)
            elif prefs.verbosity >= 2 and dst != "-":
                print(f"{src:<30}: decoded {w} bytes", file=sys.stderr)
        else:
            r, w = compress_filename(src, dst, prefs)
            if prefs.verbosity >= 2 and dst != "-":
                pct = 100.0 * w / max(1, r)
                print(f"Compressed {r} bytes into {w} bytes ==> {pct:.2f}%",
                      file=sys.stderr)
    except FileExistsError as e:
        _die(str(e))
    except FileNotFoundError as e:
        _die(str(e))
    except Exception as e:
        _die(str(e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
