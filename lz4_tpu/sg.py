"""LZ4_SG: scatter-gather compression into a single LZ4F-compatible frame.

Capability parity with the fork's flagship layer (reference ``lib/lz4sg.c``):
a list of input buffers is compressed into a list of output buffers as ONE
block-linked LZ4F frame with an embedded content size and no checksums.
One LZ4 block is produced per (input-remainder x output-remainder) pair, so
data never crosses buffer boundaries and incompressible bytes stay in place
as literals.  Wire conventions reproduced exactly:

* fixed 15-byte header, FLG = v01|linked|contentSize (lz4sg.c:173-204)
* 4-byte LE block size headers backfilled after destSize compression
  (lz4sg.c:432-475)
* output buffer advanced when fewer than 5 bytes remain; the gap is filled
  with a 5-byte zero-pad block {LE32 1, 0x00} split across the boundary
  (lz4sg.c:493-519); decode skips and validates it (lz4sg.c:646-683)
* 4-byte endmark, possibly split across two buffers (lz4sg.c:310-324)
* header rewritten afterwards when max block size exceeds 64KB or the
  actual content size shrank (lz4sg.c:340-345)

Error codes match the reference's negative-int convention.  Every frame
produced here is decodable by any plain LZ4F decoder (including the
reference's) -- the property sgtest.c:258-354 checks.
"""

from __future__ import annotations

import struct
from typing import Callable, List, Optional, Sequence, Tuple

from . import spec
from .ops import block_np
from .ops.xxhash_np import xxh32

BH = spec.BLOCK_HEADER_SIZE  # 4
ZERO_PAD = struct.pack("<I", 1) + b"\x00"  # 5-byte zero-pad block


class SgError(ValueError):
    def __init__(self, code: int, msg: str):
        super().__init__(f"SG error {code}: {msg}")
        self.code = code


# (src, capacity, dict_, acceleration) -> (consumed, block_bytes)
DestSizeCompressor = Callable[[bytes, int, bytes, int], Tuple[int, bytes]]


def _default_dest_size(src: bytes, capacity: int, dict_: bytes,
                       acceleration: int) -> Tuple[int, bytes]:
    return block_np.compress_block_dest_size(src, capacity,
                                             acceleration=acceleration,
                                             dict_=dict_)


def sg_compress_bound(source_size: int, n_in: int, n_out: int) -> int:
    """Parity with LZ4_SG_compressBound (lz4sg.c:350-377), including its
    documented fudge terms (the bound is approximate but sufficient)."""
    if source_size > 0x7E000000 or source_size <= n_in:
        return 0
    one = spec.compress_bound(source_size // n_in)
    zero_pads = (1 + min(n_in, n_out)) * (1 + BH)
    patch = 13 + (100 if n_in == 1 else 0)
    return (spec.SG_FRAME_HEADER_SIZE + spec.ENDMARK_SIZE + patch
            + (n_in + n_out) * BH + zero_pads + one * n_in)


def _encode_sg_header(content_size: int, max_block_size: int) -> bytes:
    """15-byte SG frame header (lz4sg.c:173-204)."""
    flg = (spec.FLG_VERSION << 6) | (0 << 5)  # blockLinked => indep bit 0
    if content_size > 0:
        flg |= 1 << 3
    bsid = 4 if max_block_size <= 64 * 1024 else 7
    desc = bytes([flg, bsid << 4]) + struct.pack("<Q", content_size)
    hc = (xxh32(desc, 0) >> 8) & 0xFF
    return struct.pack("<I", spec.FRAME_MAGIC) + desc + bytes([hc])


def sg_decode_header(buf: bytes) -> int:
    """Validate an SG frame header; return the content size.

    Parity with LZ4_SG_decodeHeader (lz4sg.c:205-268): raises SgError with
    the reference's code for bad magic (-1), version (-2), header checksum
    (-3), block checksum present (-4), content checksum present (-5),
    missing content size (-6), independent blocks (-7).
    """
    if len(buf) < spec.SG_FRAME_HEADER_SIZE:
        raise SgError(0, "header too small")
    magic = struct.unpack_from("<I", buf)[0]
    if magic != spec.FRAME_MAGIC:
        raise SgError(-1, f"invalid magic {magic:#x}")
    flg = buf[4]
    if (flg >> 6) != spec.FLG_VERSION:
        raise SgError(-2, "unsupported version")
    hc = (xxh32(buf[4:spec.SG_FRAME_HEADER_SIZE - 1], 0) >> 8) & 0xFF
    if hc != buf[spec.SG_FRAME_HEADER_SIZE - 1]:
        raise SgError(-3, "header checksum mismatch")
    if flg & (1 << 4):
        raise SgError(-4, "block checksum unsupported")
    if flg & (1 << 2):
        raise SgError(-5, "content checksum unsupported")
    if not flg & (1 << 3):
        raise SgError(-6, "content size required")
    if flg & (1 << 5):
        raise SgError(-7, "independent blocks unsupported")
    return struct.unpack_from("<Q", buf, 6)[0]


class _OutWalk:
    """Byte-position walker over a list of output bytearrays."""

    def __init__(self, bufs: List[bytearray]):
        self.bufs = bufs
        self.idx = 0
        self.pos = 0        # position within current buffer
        self.total = 0

    def remaining_in_buf(self) -> int:
        return len(self.bufs[self.idx]) - self.pos

    def write(self, data: bytes) -> None:
        """Write possibly across buffer boundaries."""
        off = 0
        while off < len(data):
            take = min(len(data) - off, self.remaining_in_buf())
            b = self.bufs[self.idx]
            b[self.pos:self.pos + take] = data[off:off + take]
            self.pos += take
            self.total += take
            off += take
            if self.remaining_in_buf() == 0 and off < len(data):
                self.idx += 1
                self.pos = 0
                if self.idx >= len(self.bufs):
                    raise SgError(0, "output buffers exhausted")


def sg_compress(in_bufs: Sequence[bytes], out_caps: Sequence[int],
                source_size: Optional[int] = None,
                max_output: Optional[int] = None,
                acceleration: int = 1,
                dest_size_compress: DestSizeCompressor = _default_dest_size,
                ) -> Tuple[int, int, List[bytes]]:
    """Compress a scatter-gather list into one frame across ``out_caps``.

    Returns ``(total_out, consumed, out_bufs)``; total_out == 0 on failure
    (reference convention, lz4sg.c:701-764).  Negative codes raise SgError
    mirroring LZ4_compress_fast_sg_extState's validation (-1.. -4).

    Compression runs on the host: each block is one destSize compression
    (``dest_size_compress``, the exact host codec by default).  SG
    *decode* has a device path (``sg_decompress(use_device=True)``).
    """
    in_bufs = [bytes(b) for b in in_bufs]
    n_in, n_out = len(in_bufs), len(out_caps)
    if n_in == 0:
        raise SgError(-1, "no input buffers")
    if n_out == 0:
        raise SgError(-2, "no output buffers")
    for b in in_bufs:
        if not 1 <= len(b) <= spec.SG_MAX_BLOCK_SIZE:
            raise SgError(-3, f"input buffer length {len(b)} unsupported")
    for c in out_caps:
        if c < spec.SG_MIN_OUT_BUF:
            raise SgError(-4, f"output buffer length {c} unsupported")

    content_size = sum(len(b) for b in in_bufs) if source_size is None \
        else source_size
    max_dest = sum(out_caps) if max_output is None else max_output
    if out_caps[0] < spec.SG_MIN_FIRST_OUT:
        return 0, 0, []

    outs = [bytearray(c) for c in out_caps]
    header = _encode_sg_header(content_size, 64 * 1024)

    # --- block loop (parity: LZ4_compress_fast_sg_extState, lz4sg.c:385-534)
    # Window model: LZ4's streaming codec remembers the current contiguous
    # run (prefix) plus ONE external-dict segment -- the previous run
    # (lz4.h:271-286 ring rules; lz4.c:1384-1390).  With non-contiguous SG
    # buffers that means matches may only reach into the current input
    # buffer's consumed prefix and the immediately-previous input buffer.
    prev_dict = b""       # previous input buffer (ext dict segment)
    cur_prefix = b""      # consumed bytes of the current input buffer
    in_idx, in_pos = 0, 0
    total_in = 0
    ow = _OutWalk(outs)
    ow.pos = len(header)  # out_skip_size
    ow.total = len(header)
    outs[0][:len(header)] = header
    max_out_block = 0

    while total_in < content_size and ow.total + BH < max_dest:
        # reserve block header space (always fits in current buffer: the
        # advance rule below keeps >=6 bytes available here)
        hdr_idx, hdr_pos = ow.idx, ow.pos
        ow.pos += BH
        ow.total += BH

        irem = content_size - total_in
        orem = max_dest - ow.total
        i_size = min(len(in_bufs[in_idx]) - in_pos, irem)
        o_size = min(ow.remaining_in_buf(), orem)

        src_piece = in_bufs[in_idx][in_pos:in_pos + i_size]
        window = (prev_dict + cur_prefix)[-spec.WINDOW_SIZE:]
        consumed, block = dest_size_compress(src_piece, o_size, window,
                                             acceleration)
        if consumed == 0 or len(block) == 0:
            return 0, 0, []  # no progress possible
        outs[hdr_idx][hdr_pos:hdr_pos + BH] = struct.pack("<I", len(block))
        buf = outs[ow.idx]
        buf[ow.pos:ow.pos + len(block)] = block
        o_written = len(block)
        max_out_block = max(max_out_block, o_written)
        total_in += consumed
        cur_prefix += src_piece[:consumed]

        # advance input (lz4sg.c:483-491); buffer switch rotates the window
        if consumed == i_size:
            in_idx += 1
            in_pos = 0
            prev_dict = cur_prefix
            cur_prefix = b""
            if in_idx >= n_in:
                ow.pos += o_written
                ow.total += o_written
                break
        else:
            in_pos += consumed

        # advance output (lz4sg.c:493-519)
        if o_written + 1 + BH >= o_size:
            cur_rem = o_size - o_written
            end_of_block = ow.pos + o_written
            ow.idx += 1
            ow.total += o_written
            if ow.idx >= n_out:
                ow.pos = end_of_block  # keep position coherent for endmark
                ow.idx -= 1
                break
            if o_written != o_size and ow.total + BH < max_dest:
                # zero-pad block split across the boundary
                buf[end_of_block:end_of_block + cur_rem] = ZERO_PAD[:cur_rem]
                nxt = 1 + BH - cur_rem
                outs[ow.idx][:nxt] = ZERO_PAD[cur_rem:]
                ow.pos = nxt
                ow.total += 1 + BH
            else:
                ow.pos = 0
        else:
            ow.pos += o_written
            ow.total += o_written

    # --- endmark + header rewrite (parity: LZ4_SG_compressEnd, 270-348)
    out_position = ow.total
    if out_position + spec.ENDMARK_SIZE > max_dest:
        return 0, total_in, []
    # locate endmark across buffers
    pos = 0
    end_idx = None
    for i, b in enumerate(outs):
        if pos + len(b) > out_position:
            end_idx, end_off = i, out_position - pos
            break
        pos += len(b)
    if end_idx is None:
        return 0, total_in, []
    cur_rem = len(outs[end_idx]) - end_off
    if spec.ENDMARK_SIZE <= cur_rem:
        outs[end_idx][end_off:end_off + 4] = b"\x00" * 4
    else:
        if end_idx + 1 >= n_out:
            return 0, total_in, []
        outs[end_idx][end_off:] = b"\x00" * cur_rem
        outs[end_idx + 1][:4 - cur_rem] = b"\x00" * (4 - cur_rem)

    max_in_block = max(len(b) for b in in_bufs)
    max_block = max(max_in_block, max_out_block)
    if max_block > 64 * 1024 or total_in != content_size:
        new_hdr = _encode_sg_header(total_in, max_block)
        outs[0][:len(new_hdr)] = new_hdr

    return out_position + 4, total_in, [bytes(b) for b in outs]


def sg_decompress(in_bufs: Sequence[bytes], out_caps: Sequence[int],
                  compressed_size: Optional[int] = None,
                  max_output: Optional[int] = None,
                  block_decompress=None,
                  use_device: bool = False,
                  ) -> Tuple[int, List[bytes]]:
    """Decompress an SG frame back into a scatter-gather list.

    Returns ``(total_out, out_bufs)``.  Parity with LZ4_SG_decompress +
    LZ4_decompress_fast_sg_extState (lz4sg.c:536-695, 766-809): block
    headers straddling input buffers are reassembled from a 5-byte scratch,
    zero-pad blocks are validated and skipped, and decode stops once the
    embedded content size is produced.
    """
    if use_device and block_decompress is None:
        try:
            return _sg_decompress_device(in_bufs, out_caps,
                                         compressed_size, max_output)
        except _SgDeviceUnsupported:
            # host path below handles every layout
            from .tpu import note_host_fallback
            note_host_fallback("SG chain outside the device envelope")
    in_bufs = [bytes(b) for b in in_bufs]
    n_in, n_out = len(in_bufs), len(out_caps)
    if n_in == 0:
        raise SgError(-1, "no input buffers")
    if n_out == 0:
        raise SgError(-2, "no output buffers")
    for b in in_bufs:
        if len(b) < 2:
            raise SgError(-3, "input buffer too small")
    for c in out_caps:
        if c < 1:
            raise SgError(-4, "output buffer too small")
    if len(in_bufs[0]) < spec.SG_FRAME_HEADER_SIZE:
        return 0, []

    original_size = sg_decode_header(in_bufs[0])
    comp_size = sum(len(b) for b in in_bufs) if compressed_size is None \
        else compressed_size
    max_out = sum(out_caps) if max_output is None else max_output
    if max_out < original_size:
        return 0, []

    if block_decompress is None:
        def block_decompress(comp, out_cap, dict_):
            return block_np.decompress_block(comp, out_cap, dict_=dict_,
                                             partial=False)

    outs = [bytearray(c) for c in out_caps]
    window = b""
    in_idx, in_pos = 0, spec.SG_FRAME_HEADER_SIZE
    out_idx, out_pos = 0, 0
    total_in = in_pos
    total_out = 0

    pending_block_size = None  # set when a straddled header was consumed
    while True:
        if pending_block_size is None:
            # loop guard only applies when a fresh header must be read
            # (the reference's goto _next_compressed_block skips it)
            if not (total_in + BH < comp_size and total_out < original_size):
                break
            cbs = struct.unpack_from("<I",
                                     in_bufs[in_idx], in_pos)[0]
            if cbs > spec.SG_MAX_BLOCK_SIZE:
                raise SgError(-int(cbs) if cbs else -1,
                              f"unsupported compressed block size {cbs}")
            in_pos += BH
            total_in += BH
        else:
            cbs = pending_block_size
            pending_block_size = None
            if cbs > spec.SG_MAX_BLOCK_SIZE:
                raise SgError(-int(cbs) if cbs else -1,
                              f"unsupported compressed block size {cbs}")

        irem = comp_size - total_in
        orem = original_size - total_out
        i_size = min(len(in_bufs[in_idx]) - in_pos, irem)
        o_size = min(out_caps[out_idx] - out_pos, orem)
        if cbs > i_size:
            raise SgError(-int(cbs), "compressed block larger than input rem")

        comp = in_bufs[in_idx][in_pos:in_pos + cbs]
        decoded = block_decompress(comp, o_size, window)
        o_written = len(decoded)
        outs[out_idx][out_pos:out_pos + o_written] = decoded
        window = (window + decoded)[-spec.WINDOW_SIZE:]
        total_in += cbs
        total_out += o_written

        # advance output (exact fill advances the buffer)
        if o_written == o_size:
            out_idx += 1
            out_pos = 0
            if out_idx >= n_out:
                break
        else:
            out_pos += o_written

        # advance input; handle straddled headers / zero-pads (646-690)
        i_used = cbs
        if i_used + 1 + BH >= i_size:
            cur_rem = i_size - i_used
            tail_start = in_pos + i_used
            in_idx += 1
            if in_idx >= n_in:
                break
            if i_used != i_size and total_in + BH < comp_size:
                scratch = (in_bufs[in_idx - 1][tail_start:tail_start + cur_rem]
                           + in_bufs[in_idx][:1 + BH - cur_rem])
                nxt_size = struct.unpack_from("<I", scratch)[0]
                in_pos = 1 + BH - cur_rem
                total_in += 1 + BH
                if nxt_size == 1:
                    if scratch[BH] != 0:
                        raise SgError(-total_in, "invalid zero-pad block")
                    # valid pad: skip it
                else:
                    # real block whose header straddles: resume with it
                    in_pos -= 1
                    total_in -= 1
                    pending_block_size = nxt_size
            else:
                in_pos = 0
        else:
            in_pos += i_used

    return total_out, [bytes(b) for b in outs]


class _SgDeviceUnsupported(Exception):
    """Layout outside the device kernel's envelope; take the host path."""


def _size_stand_in(collected):
    """A block codec for the host walk that decodes nothing: it records
    (payload, decoded size) and returns that many placeholder bytes, the
    size read from the block's token stream (block_np.
    get_decompressed_size), so the walk advances exactly like a real
    decode.  Blocks outside the device envelope raise
    _SgDeviceUnsupported."""
    def stand_in(comp, out_cap, dict_):
        if len(comp) == 1 and comp == b"\x00":
            return b""           # empty block: contributes nothing
        if len(comp) > spec.SG_MAX_BLOCK_SIZE + 512:
            raise _SgDeviceUnsupported()
        try:
            size = block_np.get_decompressed_size(comp)
        except block_np.Lz4BlockError:
            raise _SgDeviceUnsupported() from None
        if size > out_cap:
            raise _SgDeviceUnsupported()
        collected.append((bytes(comp), size))
        return b"\x00" * size
    return stand_in


def _sg_decompress_device(in_bufs, out_caps, compressed_size, max_output):
    """Device scatter-gather decode: walk the iovec list once on the host
    with a stand-in codec that only reads each block's decoded size from
    its token stream, then decode the whole chain into one continuous
    device space and slice the result.

    Falls back (raising _SgDeviceUnsupported) for blocks beyond the
    kernel's 64KB envelope, malformed blocks, or a chain that does not
    decode to the walked sizes (the host gives exact errors).
    """
    import numpy as np

    collected = []
    size_stand_in = _size_stand_in(collected)

    total, _ = sg_decompress(in_bufs, out_caps, compressed_size,
                             max_output, block_decompress=size_stand_in)
    if not collected:
        return total, [bytes(bytearray(c)) for c in out_caps]

    import jax.numpy as jnp
    from .tpu import fetch_byte_rows

    sizes = [sz for _, sz in collected]
    if total != sum(sizes) or total > (1 << 30):
        raise _SgDeviceUnsupported()  # int32 offsets in the kernel

    if max(sizes) > spec.WINDOW_SIZE:
        # large blocks (reference allows up to 4MB, lz4sg.c:544): run the
        # whole chain through the stream decoder -- linked=True carries
        # the window across block boundaries exactly like
        # LZ4_decompress_safe_continue in the SG walk (lz4sg.c:611)
        from .kernels.decode_kernel import decode_stream

        bs = -(-max(sizes) // spec.WINDOW_SIZE) * spec.WINDOW_SIZE
        out, olen = decode_stream([c for c, _ in collected], bs, total,
                                  linked=True, out_caps=sizes)
        olen = np.asarray(olen)
        if (olen != np.asarray(sizes, olen.dtype)).any():
            raise _SgDeviceUnsupported()  # host path gives exact errors
        flat = fetch_byte_rows(out).reshape(-1)
        content = bytes(flat[:total])
    else:
        from .kernels.decode_kernel import decode_blocks_sg

        M = -(-max(len(c) for c, _ in collected) // 128) * 128
        B = len(collected)
        arr = np.zeros((B, M), np.int32)
        lens = np.zeros((B,), np.int32)
        for i, (c, _) in enumerate(collected):
            arr[i, :len(c)] = np.frombuffer(c, np.uint8)
            lens[i] = len(c)
        out, olen = decode_blocks_sg(jnp.asarray(arr), jnp.asarray(lens),
                                     sizes)
        olen = np.asarray(olen)
        if (olen != np.asarray(sizes, olen.dtype)).any():
            raise _SgDeviceUnsupported()  # host path re-derives errors
        flat = fetch_byte_rows(out).reshape(-1)
        content = bytes(flat[spec.WINDOW_SIZE:spec.WINDOW_SIZE + total])

    outs = []
    pos = 0
    for cap in out_caps:
        take = min(cap, max(total - pos, 0))
        buf = bytearray(cap)
        buf[:take] = content[pos:pos + take]
        outs.append(bytes(buf))
        pos += take
    return total, outs
