"""File I/O engine: frame-format files, legacy format, sparse writing.

Capability parity with the reference I/O layer (reference
``programs/lz4io.c``): compress/decompress/test files or stdio streams,
multi-frame concatenation, skippable-frame skipping, pass-through of
non-LZ4 data, legacy-format encode/decode (lz4io.c:344-413, 730-779),
sparse-file writing that seeks over zero runs (lz4io.c:641-726), and
multi-file operation (lz4io.c:596-624).

The block codec is chosen per call: with a GPU present, fast levels run
the device pipeline (chunked 4MB reads, linked or independent) and
decode routes through the device decoder (any block size, legacy
included); HC levels, and everything on a machine without a GPU, run the
host codec.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
import sys
import time
from pathlib import Path
from typing import BinaryIO, Optional

from . import spec
from .frame import (
    FrameCompressor,
    FrameDecompressor,
    FramePreferences,
    Lz4FrameError,
    compress_legacy,
    decompress_legacy,
)

LZ4_EXTENSION = ".lz4"
CHUNK = 4 * 1024 * 1024  # read granularity (lz4io.c uses 4MB reads)


@dataclasses.dataclass
class IoPrefs:
    """The g_* knobs of lz4io.c:134-140, as a struct."""

    level: int = 1                  # 0-2 fast, >=3 HC
    block_size_id: int = 7          # -B4..7
    block_linked: bool = False      # -BD sets linked; reference default is
                                    # independent (lz4io.c:138)
    block_checksum: bool = False    # -BX
    content_checksum: bool = True   # --no-frame-crc clears
    content_size: bool = False      # --content-size
    sparse: bool = True             # --no-sparse clears (auto off for stdout)
    overwrite: bool = False         # -f
    test_mode: bool = False         # -t
    legacy: bool = False            # -l
    pass_through: bool = False      # -d -f on non-lz4 input
    remove_src: bool = False        # --rm
    use_device: Optional[bool] = None  # None = auto
    acceleration: int = 1
    min_match: int = 4              # --min-match: ratio/decode-speed lever
    verbosity: int = 2


def _device_available() -> bool:
    """True when JAX's default backend is the GPU.  A backend that fails
    to start raises; it is not read as "no device"."""
    if os.environ.get("LZ4TPU_FORCE_CPU", "0") == "1":
        return False
    import jax
    return jax.default_backend() == "gpu"


def _prefs_to_frame(p: IoPrefs, content_size: Optional[int]) -> FramePreferences:
    return FramePreferences(
        block_size_id=p.block_size_id,
        block_independent=not p.block_linked,
        content_checksum=p.content_checksum,
        block_checksum=p.block_checksum,
        content_size=content_size,
        level=p.level if p.level >= 3 else 0,
        acceleration=max(1, p.acceleration),
    )


class ProgressMeter:
    """150 ms-throttled stderr progress display (parity: DISPLAYUPDATE,
    lz4io.c:123-128): shown at default verbosity (>=2) once more than
    16 MB has been processed, refreshed at most every 150 ms, erased by
    ``done()``.  Streams of unknown size show MB processed; known sizes
    add the ratio so far, like LZ4IO_compressFilename_extRess's meter."""

    INTERVAL = 0.150
    MIN_BYTES = 16 * 1024 * 1024

    def __init__(self, prefs: IoPrefs, verb: str,
                 total: Optional[int] = None):
        self.enabled = prefs.verbosity >= 2
        self.verb = verb
        self.total = total
        self.next_at = time.monotonic() + self.INTERVAL
        self.shown = False

    def update(self, processed: int, produced: int) -> None:
        if not self.enabled or processed < self.MIN_BYTES:
            return
        now = time.monotonic()
        if now < self.next_at:
            return
        self.next_at = now + self.INTERVAL
        msg = f"\r{self.verb} : {processed >> 20} MB"
        if self.total:
            msg += f" ({100.0 * processed / self.total:.1f}%)"
        if produced and processed:
            msg += f"  ==> {100.0 * produced / processed:.2f}%"
        sys.stderr.write(msg + "   ")
        sys.stderr.flush()
        self.shown = True

    def done(self) -> None:
        if self.shown:
            sys.stderr.write("\r" + " " * 60 + "\r")
            sys.stderr.flush()
            self.shown = False


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def compress_stream(src: BinaryIO, dst: BinaryIO, prefs: IoPrefs,
                    src_size: Optional[int] = None) -> tuple[int, int]:
    """Compress a stream to a .lz4 frame; returns (read, written)."""
    if prefs.legacy:
        data = src.read()
        out = compress_legacy(data, acceleration=prefs.acceleration,
                              level=prefs.level)
        dst.write(out)
        return len(data), len(out)

    use_device = prefs.use_device
    if use_device is None:
        # fast levels route to the device kernels; linked (-BD) uses the
        # chained streaming kernel at its 64KB window granularity
        use_device = _device_available()

    if prefs.level >= 3:
        use_device = False      # HC levels run the host codec (hc.py)

    if use_device:
        if prefs.block_linked and spec.BLOCK_SIZES[prefs.block_size_id] \
                >= 65536:
            # chunked streaming: bounded host memory for any file size
            # (lz4io.c:497-542 4MB-read discipline), 64KB window carried
            # across chunks by the linked kernel's prefix seeding
            from .tpu import DeviceFrameCompressor
            fp = _prefs_to_frame(prefs,
                                 src_size if prefs.content_size else None)
            fp.block_size_id = 4
            comp = DeviceFrameCompressor(fp,
                                         acceleration=prefs.acceleration,
                                         min_match=prefs.min_match)
            header = comp.begin()
            dst.write(header)
            total_in, total_out = 0, len(header)
            meter = ProgressMeter(prefs, "Read", src_size)
            while True:
                chunk = src.read(CHUNK)
                if not chunk:
                    break
                total_in += len(chunk)
                out = comp.update(chunk)
                total_out += len(out)
                dst.write(out)
                meter.update(total_in, total_out)
            tail = comp.end()
            dst.write(tail)
            meter.done()
            return total_in, total_out + len(tail)
        # block-independent frames chunk trivially (no window carry):
        # each 4MB read batches its 64KB blocks over the grid
        from .frame import encode_frame_header
        from .ops.xxhash_np import XXH32State
        from .tpu import encode_batch
        bs = min(65536, spec.BLOCK_SIZES[prefs.block_size_id])
        fp = _prefs_to_frame(prefs, src_size if prefs.content_size else None)
        header = encode_frame_header(fp)
        dst.write(header)
        total_in, total_out = 0, len(header)
        xxh = XXH32State(0)
        meter = ProgressMeter(prefs, "Read", src_size)
        while True:
            chunk = src.read(CHUNK)
            if not chunk:
                break
            total_in += len(chunk)
            if fp.content_checksum:
                xxh.update(chunk)
            blocks = [chunk[i:i + bs] for i in range(0, len(chunk), bs)]
            comp_rows, comp_lens = encode_batch(
                blocks, bs, prefs.acceleration, prefs.min_match)
            parts = []
            for i, blk in enumerate(blocks):
                clen = int(comp_lens[i])
                if clen >= len(blk):
                    payload = blk
                    bh = struct.pack("<I",
                                     len(blk) | spec.UNCOMPRESSED_BIT)
                else:
                    payload = comp_rows[i, :clen].tobytes()
                    bh = struct.pack("<I", clen)
                parts.append(bh)
                parts.append(payload)
                if fp.block_checksum:
                    from .ops.xxhash_native import xxh32 as _x32
                    parts.append(struct.pack("<I", _x32(payload, 0)))
            out = b"".join(parts)
            total_out += len(out)
            dst.write(out)
            meter.update(total_in, total_out)
        tail = struct.pack("<I", 0)
        if fp.content_checksum:
            tail += struct.pack("<I", xxh.digest())
        dst.write(tail)
        meter.done()
        return total_in, total_out + len(tail)

    fp = _prefs_to_frame(prefs, src_size if prefs.content_size else None)
    comp = FrameCompressor(fp)
    header = comp.begin()
    dst.write(header)
    total_in = 0
    total_out = len(header)
    meter = ProgressMeter(prefs, "Read", src_size)
    while True:
        chunk = src.read(CHUNK)
        if not chunk:
            break
        total_in += len(chunk)
        out = comp.update(chunk)
        total_out += len(out)
        dst.write(out)
        meter.update(total_in, total_out)
    tail = comp.end()
    dst.write(tail)
    meter.done()
    return total_in, total_out + len(tail)


# ---------------------------------------------------------------------------
# decompression (with sparse writing)
# ---------------------------------------------------------------------------

class SparseWriter:
    """Zero-run skipping writer (parity: LZ4IO_fwriteSparse,
    lz4io.c:641-726).  Seeks over long zero runs; ftruncate fixes the tail.
    """

    GRAIN = 4096

    def __init__(self, f: BinaryIO, enabled: bool):
        self.f = f
        self.enabled = enabled and f.seekable()
        self.pending_zeros = 0
        self.written = 0

    def write(self, data: bytes) -> None:
        self.written += len(data)
        if not self.enabled:
            self.f.write(data)
            return
        view = memoryview(data)
        while view:
            take = min(len(view), self.GRAIN)
            piece = view[:take]
            if piece == b"\x00" * take:
                self.pending_zeros += take
            else:
                if self.pending_zeros:
                    self.f.seek(self.pending_zeros, io.SEEK_CUR)
                    self.pending_zeros = 0
                self.f.write(piece)
            view = view[take:]

    def close(self) -> None:
        if self.pending_zeros and self.enabled:
            # materialize the final hole (lz4io writes a last byte)
            self.f.seek(self.pending_zeros - 1, io.SEEK_CUR)
            self.f.write(b"\x00")
            self.pending_zeros = 0


def decompress_stream(src: BinaryIO, dst, prefs: IoPrefs) -> tuple[int, int]:
    """Decode all concatenated frames from ``src``; returns (read, written).

    Handles LZ4F frames, legacy frames, skippable frames, and pass-through
    (magic dispatch parity: lz4io.c:904-956).
    """
    total_in = total_out = 0
    buf = src.read()
    pos = 0
    use_device = prefs.use_device
    if use_device is None:
        use_device = _device_available()
    first = True
    meter = ProgressMeter(prefs, "Decoded", None)
    while pos < len(buf):
        if len(buf) - pos < 4:
            if first and prefs.pass_through:
                dst.write(buf[pos:])
                total_out += len(buf) - pos
                pos = len(buf)
                break
            if first:
                raise Lz4FrameError("input too short")
            # trailing garbage after a valid stream: stop without error
            # (lz4io.c:948-952 "Stream followed by unrecognized data")
            break
        magic = struct.unpack_from("<I", buf, pos)[0]
        if magic == spec.FRAME_MAGIC:
            content, used = _decode_one_frame(buf[pos:], prefs, use_device)
            dst.write(content)
            total_out += len(content)
            pos += used
        elif magic == spec.LEGACY_MAGIC:
            if use_device:
                from .tpu import decompress_legacy_device
                content, used = decompress_legacy_device(buf[pos:])
            else:
                content, used = decompress_legacy(buf[pos:])
            dst.write(content)
            total_out += len(content)
            pos += used
        elif (magic & spec.SKIPPABLE_MAGIC_MASK) == spec.SKIPPABLE_MAGIC_MIN:
            if len(buf) - pos < 8:
                raise Lz4FrameError("truncated skippable frame")
            size = struct.unpack_from("<I", buf, pos + 4)[0]
            pos += 8 + size
        else:
            # unknown magic: pass the whole input through when forced on
            # the FIRST stream (lz4io.c:946-952 pass-through contract);
            # after a valid stream, stop without error
            if first and prefs.pass_through:
                dst.write(buf[pos:])
                total_out += len(buf) - pos
                pos = len(buf)
            elif first:
                raise Lz4FrameError(f"unrecognized header {magic:#010x}")
            else:
                break
        first = False
        meter.update(total_out, 0)
    meter.done()
    total_in = pos
    return total_in, total_out


def _decode_one_frame(data: bytes, prefs: IoPrefs, use_device: bool):
    if use_device:
        from .tpu import DeviceLayoutUnsupported, \
            decompress_frame_device, note_host_fallback
        try:
            return decompress_frame_device(data)
        except DeviceLayoutUnsupported:
            # layout outside the kernels' envelope: host path below
            note_host_fallback("frame layout outside the device envelope")
    d = FrameDecompressor()
    used, out = d.feed(data)
    if not d.finished:
        raise Lz4FrameError("truncated frame")
    return out, used


# ---------------------------------------------------------------------------
# file-level operations (parity: LZ4IO_compressFilename etc.)
# ---------------------------------------------------------------------------

def _open_dst(path: str, prefs: IoPrefs) -> BinaryIO:
    if path == "-":
        return sys.stdout.buffer
    if os.path.exists(path) and not prefs.overwrite:
        raise FileExistsError(f"{path} already exists; use -f to overwrite")
    return open(path, "wb")


def compress_filename(src_path: str, dst_path: str, prefs: IoPrefs) -> tuple[int, int]:
    src = sys.stdin.buffer if src_path == "-" else open(src_path, "rb")
    try:
        size = None
        if src_path != "-":
            size = os.path.getsize(src_path)
        dst = _open_dst(dst_path, prefs)
        try:
            r, w = compress_stream(src, dst, prefs, size)
        finally:
            if dst is not sys.stdout.buffer:
                dst.close()
    finally:
        if src is not sys.stdin.buffer:
            src.close()
    if prefs.remove_src and src_path != "-":
        os.unlink(src_path)
    return r, w


def decompress_filename(src_path: str, dst_path: str, prefs: IoPrefs) -> tuple[int, int]:
    src = sys.stdin.buffer if src_path == "-" else open(src_path, "rb")
    try:
        if prefs.test_mode:
            sink = io.BytesIO()
            r, w = decompress_stream(src, sink, prefs)
            return r, w
        dst = _open_dst(dst_path, prefs)
        sparse = SparseWriter(dst, prefs.sparse and dst is not sys.stdout.buffer)
        try:
            r, w = decompress_stream(src, sparse, prefs)
            sparse.close()
            if sparse.enabled:
                dst.truncate(sparse.written)
        finally:
            if dst is not sys.stdout.buffer:
                dst.close()
    finally:
        if src is not sys.stdin.buffer:
            src.close()
    if prefs.remove_src and src_path != "-":
        os.unlink(src_path)
    return r, w


def compress_multiple(paths, prefs: IoPrefs) -> int:
    """-m: each file -> file.lz4 (lz4io.c:596-624)."""
    errors = 0
    for p in paths:
        try:
            compress_filename(p, p + LZ4_EXTENSION, prefs)
        except Exception as e:
            print(f"lz4: {p}: {e}", file=sys.stderr)
            errors += 1
    return errors


def decompress_multiple(paths, prefs: IoPrefs) -> int:
    errors = 0
    for p in paths:
        if not p.endswith(LZ4_EXTENSION):
            print(f"lz4: {p}: unknown suffix, skipping", file=sys.stderr)
            errors += 1
            continue
        try:
            decompress_filename(p, p[:-len(LZ4_EXTENSION)], prefs)
        except Exception as e:
            print(f"lz4: {p}: {e}", file=sys.stderr)
            errors += 1
    return errors
