"""Device frame codec: LZ4F frames driven through the GPU kernels.

This is the production pipeline (reference call stacks 3.1/3.2): all
block compute runs on the device, one kernel program per block; the host
only assembles/parses the byte-exact frame container (headers are a few
bytes per 64KB -- negligible, and inherently sequential).

Layout notes:
* encode: every block is one program of the scan kernel; linked 64 KB
  blocks see the previous block as their window, so they scan in
  parallel too.  The frame is packed on the device (kernels/pack.py)
* decode: independent <=64KB blocks decode one program each; a linked
  chain decodes in order inside one program; larger blocks (up to the
  reference CLI's default 4MB, lz4io.c:182-188) take the stream decoder
  (decode_kernel.decode_stream)

A frame that is legal LZ4F but outside the kernels' envelope is decoded
by the host codec instead; every such fallback is counted in
``HOST_FALLBACKS``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import struct
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import spec
from .frame import FrameDecompressor, FrameInfo, FramePreferences, \
    Lz4FrameError, decode_frame_header, encode_frame_header
from .kernels.common import bucket_pow2, bytes_to_i32_rows, \
    i32_rows_to_bytes, np_pack_rows
from .kernels.decode_kernel import decode_blocks, decode_blocks_linked
from .kernels.encode_kernel import bytes_to_val32_rows, encode_blocks, \
    encode_blocks_linked
from .kernels.pack import pack_frame_payloads
from .ops.xxhash_native import xxh32 as xxh32_fast

BLOCK = 65536  # device-path block granularity

# host-codec decodes of frames the device path handed back, by reason
HOST_FALLBACKS: collections.Counter = collections.Counter()


def note_host_fallback(reason: str) -> None:
    """Count one frame (or SG list) decoded on the host instead of the
    device: a legal layout outside the kernels' envelope."""
    HOST_FALLBACKS[reason] += 1

# linked-chain decode pipelining: blocks per dispatched group (64 = 4MB
# of content; tests shrink it to exercise multi-group window handoff)
DEC_GROUP_BLOCKS = 64


class DeviceLayoutUnsupported(Lz4FrameError):
    """The frame is (as far as parsed) valid but its layout is outside the
    device kernels' envelope (e.g. oversized blocks).  Callers catch this
    to fall back to the host codec; genuine decode errors raise plain
    Lz4FrameError and must propagate (no redundant host re-decode)."""


def fetch_byte_rows(rows_i32) -> np.ndarray:
    """Fetch [B, M] int32 byte lanes from device as uint8, packing to real
    bytes on-device first: the host link moves 4x less data.

    M must be a multiple of 4 (all kernel row widths are 128-aligned).
    """
    packed = i32_rows_to_bytes(rows_i32)
    pn = np.ascontiguousarray(np.asarray(packed).astype('<i4', copy=False))
    return pn.view(np.uint8).reshape(pn.shape[0], -1)


def fetch_packed(flat_u8, total) -> bytes:
    """The first ``total`` bytes of a packed device buffer; the fetched
    prefix is bucketed to a power of two so slices compile once."""
    total = int(total)
    n = bucket_pow2(total, 512, flat_u8.shape[0])
    return np.asarray(flat_u8[:n])[:total].tobytes()


def upload_byte_rows(arr_u8: np.ndarray):
    """Upload [B, M] uint8 rows as packed words, unpacking to int32 byte
    lanes on-device (4x less link traffic than uploading int32 bytes)."""
    B, M = arr_u8.shape
    packed = np.ascontiguousarray(arr_u8).view('<i4')
    return bytes_to_i32_rows(jnp.asarray(packed), M)


def _split_blocks(data: bytes, block_size: int) -> List[bytes]:
    if not data:
        return [b""]
    return [data[i:i + block_size] for i in range(0, len(data), block_size)]


# ---------------------------------------------------------------------------
# device batch codec (arrays in, arrays out) -- building block for frames
# and for the mesh-parallel path in lz4_tpu.parallel
# ---------------------------------------------------------------------------

def encode_batch(buffers: List[bytes], block_size: int = BLOCK,
                 acceleration: int = 1, min_match: int = 4,
                 reject_step: int = 1):
    """Compress a list of <=block_size buffers on device.

    Returns (comp_rows int32 np [B, M], comp_lens np [B]).
    """
    packed, lens = np_pack_rows(buffers, block_size)
    val = bytes_to_val32_rows(jnp.asarray(packed), block_size)
    out, olen = encode_blocks(val, jnp.asarray(lens), acceleration,
                              min_match=min_match,
                              reject_step=reject_step)
    olen = np.asarray(olen)
    # fetch only up to the longest payload (the host link is the
    # bottleneck), bucketed to powers of two so repeated chunked calls
    # reuse compiled packing kernels instead of recompiling per size
    maxb = bucket_pow2(int(olen.max(initial=0)), 512, out.shape[1])
    return fetch_byte_rows(out[:, :maxb]), olen


def decode_batch(comp_list: List[bytes], out_cap: int,
                 out_lens: Optional[List[int]] = None):
    """Decompress a list of independent blocks on device.

    Returns list of byte strings; raises Lz4FrameError on any -1 row.
    """
    M = max((len(c) for c in comp_list), default=1)
    M = -(-max(M, 1) // 128) * 128
    B = len(comp_list)
    arr = np.zeros((B, M), np.uint8)
    lens = np.zeros((B,), np.int32)
    for i, c in enumerate(comp_list):
        arr[i, :len(c)] = np.frombuffer(bytes(c), np.uint8)
        lens[i] = len(c)
    caps = None
    if out_lens is not None:
        caps = jnp.asarray(np.asarray(out_lens, np.int32))
    out, olen = decode_blocks(upload_byte_rows(arr), jnp.asarray(lens),
                              out_cap, out_caps=caps)
    cap4 = out_cap - out_cap % 4  # packed fetch needs 4-byte multiples
    outb = fetch_byte_rows(out[:, :cap4])
    olen = np.asarray(olen)
    if (olen < 0).any():
        bad = int(np.nonzero(olen < 0)[0][0])
        raise Lz4FrameError(f"device decode failed on block {bad}")
    if cap4 == out_cap:
        return [bytes(outb[i, :olen[i]]) for i in range(B)]
    tail = np.asarray(out[:, cap4:])
    return [bytes(outb[i, :min(olen[i], cap4)])
            + bytes(tail[i, :max(olen[i] - cap4, 0)].astype(np.uint8))
            for i in range(B)]


# ---------------------------------------------------------------------------
# frame pipeline
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("NB", "BS"))
def _chunk_windows(packed, prev_tail, prefix_len, *, NB, BS):
    """[NB, BS//4] packed words of ONE chunk + [1, BS//4] previous-tail
    words -> [1, NB, 2*BS] val32 window rows, built on device: the chunk
    crosses the link ONCE (host-built [prev | cur] windows would double
    the upload traffic).
    Row 0's window is the tail's last ``prefix_len`` bytes
    (right-aligned); lanes below it are zeroed (the scan's ``q >= low``
    guard never reads them, so lane-granular masking is safe)."""
    prev = jnp.concatenate([prev_tail, packed[:-1]], axis=0)
    rows2 = jnp.concatenate([prev, packed], axis=1)
    val = bytes_to_val32_rows(rows2, 2 * BS)
    lanepos = jnp.arange(2 * BS, dtype=jnp.int32)
    keep = lanepos >= (BS - prefix_len)
    val = val.at[0].set(jnp.where(keep, val[0], 0))
    return val.reshape(1, NB, 2 * BS)


@functools.partial(jax.jit, static_argnames=("S", "NB", "BS"))
def _linked_windows(packed, *, S, NB, BS):
    """[S*NB, BS//4] packed words of the FLAT stream -> [S, NB, 2*BS]
    val32 window rows, built on device (the [prev | cur] duplication
    never crosses the host link)."""
    # ONE stream split S x NB: block g's window is GLOBAL block g-1,
    # crossing the (s, 0) row-group boundaries
    prev = jnp.concatenate(
        [jnp.zeros((1, BS // 4), jnp.int32), packed[:-1]], axis=0)
    rows2 = jnp.concatenate([prev, packed], axis=1)
    return bytes_to_val32_rows(rows2, 2 * BS).reshape(S, NB, 2 * BS)


def linked_val_rows(data: bytes, S: int, NB: int):
    """Build the streaming kernel's input for a stream split into S x NB
    64 KB blocks (global block g -> row (g // NB, g % NB)): each row holds
    the stream's bytes [(g-1)*64K, (g+1)*64K) as val32 lanes, zero padded
    at the front of block 0 and past the stream tail.

    The host uploads the flat stream ONCE as packed words; the
    overlapping [prev | cur] windows are constructed on device
    (_linked_windows) — half the link traffic and host copying of the
    materialized-window layout this replaced (bit-identical rows).

    Returns (val [S, NB, 131072] jnp int32, lens [S, NB] np int32).
    """
    BS = spec.WINDOW_SIZE
    nb_total = max(1, -(-len(data) // BS))
    assert nb_total <= S * NB
    lens = np.zeros((S, NB), np.int32)
    for g in range(nb_total):
        lens[g // NB, g % NB] = min(BS, len(data) - g * BS)
    flat = np.zeros((S * NB * BS,), np.uint8)
    flat[:len(data)] = np.frombuffer(data, np.uint8)
    packed = np.ascontiguousarray(flat).view("<i4").reshape(
        S * NB, BS // 4)
    return _linked_windows(jnp.asarray(packed), S=S, NB=NB, BS=BS), lens


def assemble_linked_frame(data: bytes, prefs: FramePreferences,
                          payloads, block_lens) -> bytes:
    """Header + per-block payloads (stored fallback, lz4frame.c:518-524)
    + endmark + optional checksums, for a linked chain in stream order."""
    parts = [encode_frame_header(prefs)]
    pos = 0
    for payload, blen in zip(payloads, block_lens):
        if blen == 0:
            continue
        if len(payload) >= blen:
            # the next block's window is the plaintext either way
            payload = data[pos:pos + blen]
            header = struct.pack("<I", blen | spec.UNCOMPRESSED_BIT)
        else:
            header = struct.pack("<I", len(payload))
        parts.append(header)
        parts.append(payload)
        if prefs.block_checksum:
            parts.append(struct.pack("<I", xxh32_fast(payload, 0)))
        pos += blen
    parts.append(struct.pack("<I", 0))
    if prefs.content_checksum:
        parts.append(struct.pack("<I", xxh32_fast(data, 0)))
    return b"".join(parts)


def encode_stream_linked(data: bytes, acceleration: int = 1,
                         min_match: int = 4, reject_step: int = 1):
    """Compress one stream as a chain of linked 64 KB blocks on device.

    Returns (payloads, block_lens): per-block compressed bytes + their
    plaintext lengths, with LZ4_compress_fast_continue window semantics
    (each block may match into the previous block).
    """
    data = bytes(data)
    if len(data) >= (1 << 31) - (1 << 17):
        # the linked kernel tracks global stream positions as int32 and
        # has no renormalization pass (the reference rescales at 2GB,
        # lz4.c:954-973); chunk the stream (io.compress_stream does) or
        # split into multiple frames beyond this envelope
        raise Lz4FrameError("stream exceeds the linked kernel's 2GB "
                            "position envelope; use chunked compression")
    nb = max(1, -(-len(data) // spec.WINDOW_SIZE))
    val, lens = linked_val_rows(data, 1, nb)
    out, olen = encode_blocks_linked(val, jnp.asarray(lens), acceleration,
                                     min_match=min_match,
                                     reject_step=reject_step)
    outb = fetch_byte_rows(out[0])
    olen = np.asarray(olen[0])
    payloads = [outb[k, :olen[k]].tobytes() for k in range(nb)]
    return payloads, [int(lens[0, k]) for k in range(nb)]


def compress_frame_device(data: bytes,
                          prefs: Optional[FramePreferences] = None,
                          block_size: int = BLOCK,
                          acceleration: int = 1,
                          min_match: int = 4,
                          reject_step: int = 1) -> bytes:
    """One-shot frame compression with all block compute on the device.

    Every block is one program of the scan kernel; linked frames
    (``prefs.block_independent=False`` with 64 KB blocks) give each block
    the previous one as its window.  Parity target:
    LZ4F_compressFrame for either blockMode.
    """
    prefs = dataclasses.replace(prefs) if prefs else FramePreferences()
    linked = (not prefs.block_independent and len(data) > spec.WINDOW_SIZE
              and block_size == spec.WINDOW_SIZE)
    if linked:
        if len(data) > (8 << 20):
            # large inputs go through the chunked compressor: 4MB chunks
            # with one chunk always in flight, so upload/kernel/fetch
            # overlap (double buffering) instead of running serially
            comp = DeviceFrameCompressor(prefs, acceleration, min_match,
                                         reject_step)
            parts = [comp.begin()]
            CH = 4 << 20
            for i in range(0, len(data), CH):
                parts.append(comp.update(data[i:i + CH]))
            parts.append(comp.end())
            return b"".join(parts)
        return _compress_frame_device_linked(data, prefs, acceleration,
                                             min_match, reject_step)
    # When a linked frame was requested but the data fits one block (or the
    # block size is not the chain unit), blocks are compressed independently
    # — still a valid linked stream (no match ever crosses a boundary) — and
    # the emitted FLG keeps the requested block-mode bit so the header
    # matches what the reference CLI writes for -BD (lz4io.c:138).
    if prefs.block_size_id == 0:
        prefs.block_size_id = spec.optimal_block_size_id(block_size)
    if block_size > spec.BLOCK_SIZES[prefs.block_size_id]:
        raise Lz4FrameError("block_size exceeds frame block maximum")
    if prefs.content_size is not None and prefs.content_size != len(data):
        raise Lz4FrameError("content_size does not match data")

    data = bytes(data)
    blocks = _split_blocks(data, block_size)

    if not prefs.block_checksum:
        # device-side assembly: headers + payloads (with the stored-block
        # fallback) are packed into ONE contiguous buffer -- a single
        # fetch replaces the per-block Python joins (reference writes
        # blocks in place, lz4frame.c:511-525)
        packed, lens = np_pack_rows(blocks, block_size)
        val = bytes_to_val32_rows(jnp.asarray(packed), block_size)
        out, olen = encode_blocks(val, jnp.asarray(lens), acceleration,
                                  min_match=min_match,
                                  reject_step=reject_step)
        body = fetch_packed(*pack_frame_payloads(out, olen, val, lens))
        parts = [encode_frame_header(prefs), body,
                 struct.pack("<I", 0)]
        if prefs.content_checksum:
            parts.append(struct.pack("<I", xxh32_fast(data, 0)))
        return b"".join(parts)

    comp_rows, comp_lens = encode_batch(blocks, block_size, acceleration,
                                        min_match, reject_step)

    parts = [encode_frame_header(prefs)]
    pos = 0
    for i, blk in enumerate(blocks):
        if not blk:
            continue
        clen = int(comp_lens[i])
        if clen >= len(blk):
            # stored-block fallback (lz4frame.c:518-524)
            payload = blk
            header = struct.pack("<I", len(blk) | spec.UNCOMPRESSED_BIT)
        else:
            payload = comp_rows[i, :clen].astype(np.uint8).tobytes()
            header = struct.pack("<I", clen)
        parts.append(header)
        parts.append(payload)
        if prefs.block_checksum:
            parts.append(struct.pack("<I", xxh32_fast(payload, 0)))
        pos += len(blk)
    parts.append(struct.pack("<I", 0))
    if prefs.content_checksum:
        parts.append(struct.pack("<I", xxh32_fast(data, 0)))
    return b"".join(parts)


def _compress_frame_device_linked(data: bytes, prefs: FramePreferences,
                                  acceleration: int,
                                  min_match: int = 4,
                                  reject_step: int = 1) -> bytes:
    """Linked-frame assembly over the linked scan."""
    prefs.block_independent = False
    if prefs.block_size_id == 0:
        prefs.block_size_id = 4        # 64KB, the kernel's chain unit
    if spec.BLOCK_SIZES[prefs.block_size_id] < spec.WINDOW_SIZE:
        raise Lz4FrameError("invalid block size id")
    if prefs.content_size is not None and prefs.content_size != len(data):
        raise Lz4FrameError("content_size does not match data")

    data = bytes(data)
    if not prefs.block_checksum:
        # device-side assembly (see the independent path): the linked
        # chain's blocks pack into one buffer; the stored-block fallback
        # ships the plaintext from the val rows' block lanes, preserving
        # the next block's window exactly like assemble_linked_frame
        nb = max(1, -(-len(data) // spec.WINDOW_SIZE))
        val, lens = linked_val_rows(data, 1, nb)
        out, olen = encode_blocks_linked(val, jnp.asarray(lens),
                                         acceleration,
                                         min_match=min_match,
                                         reject_step=reject_step)
        body = fetch_packed(*pack_frame_payloads(
            out.reshape(nb, -1), olen.reshape(nb),
            val[0, :, spec.WINDOW_SIZE:], lens[0]))
        parts = [encode_frame_header(prefs), body,
                 struct.pack("<I", 0)]
        if prefs.content_checksum:
            parts.append(struct.pack("<I", xxh32_fast(data, 0)))
        return b"".join(parts)

    payloads, block_lens = encode_stream_linked(data, acceleration,
                                                min_match, reject_step)
    return assemble_linked_frame(data, prefs, payloads, block_lens)


def _literal_block(payload: bytes) -> bytes:
    """Wrap raw bytes as a literals-only LZ4 block (token + run + bytes).

    Used to splice a stored (uncompressed, lz4frame.c:518-524) block into
    a linked chain decoded on device: the wrapped block decodes to the
    stored bytes and so keeps the 64 KB window contract intact.
    """
    n = len(payload)
    if n < 15:
        return bytes([n << 4]) + payload
    ext = n - 15
    out = bytearray([0xF0])
    while ext >= 255:
        out.append(255)
        ext -= 255
    out.append(ext)
    return bytes(out) + payload


def decompress_frame_device(frame: bytes) -> Tuple[bytes, int]:
    """One-shot frame decompression with block compute on the device.

    Handles block-independent frames (batched grid decode) and
    block-linked frames with block size <= 64 KB (chained-window kernel,
    the reference CLI's default output mode).  Returns
    (content, bytes_consumed).
    """
    info = decode_frame_header(frame)
    if info.block_size > BLOCK:
        # large blocks (reference CLI default is 4MB, lz4io.c:182-188)
        # take the stream decoder
        return _decompress_frame_device_stream(frame, info)
    pos = info.header_size
    comp_blocks: List[bytes] = []
    stored: List[Optional[bytes]] = []
    while True:
        if pos + 4 > len(frame):
            raise Lz4FrameError("truncated frame")
        raw = struct.unpack_from("<I", frame, pos)[0]
        pos += 4
        if raw == 0:
            break
        size = raw & ~spec.UNCOMPRESSED_BIT
        if pos + size > len(frame):
            raise Lz4FrameError("truncated block")
        payload = frame[pos:pos + size]
        pos += size
        if info.block_checksum:
            want = struct.unpack_from("<I", frame, pos)[0]
            pos += 4
            if xxh32_fast(payload, 0) != want:
                raise Lz4FrameError("block checksum mismatch")
        if raw & spec.UNCOMPRESSED_BIT:
            stored.append(payload)
            comp_blocks.append(None)
        else:
            stored.append(None)
            comp_blocks.append(payload)

    if info.block_independent:
        todo = [c for c in comp_blocks if c is not None]
        decoded = decode_batch(todo, info.block_size) if todo else []
        it = iter(decoded)
        content = b"".join(s if s is not None else next(it)
                           for s in stored)
    elif not comp_blocks:
        content = b""
    else:
        # linked chain: stored blocks splice in as literal-only blocks so
        # the kernel's block-to-block window carry stays correct
        payloads = [c if c is not None else _literal_block(s)
                    for c, s in zip(comp_blocks, stored)]
        bs = info.block_size
        if bs < spec.WINDOW_SIZE:
            # window would span several blocks (non-conformant but legal
            # framing): the host codec tracks the true 64KB window
            note_host_fallback("linked blocks under 64 KB")
            d = FrameDecompressor()
            used, content = d.feed(frame)
            if not d.finished:
                raise Lz4FrameError("truncated frame")
            return content, used
        # Pipelined group decode: the chain is cut into G-block groups;
        # group g+1's upload + kernel are DISPATCHED before group g's
        # result is fetched, so host<->device transfers overlap kernel
        # compute (double buffering).  The 64KB window crosses group
        # boundaries as a device-to-device slice of the previous group's
        # last output block -- no host round-trip.
        G = DEC_GROUP_BLOCKS         # 4MB of content per group at 64KB
        B = len(payloads)
        ngroups = -(-B // G)
        win = None                   # device [1, bs] int32 byte lanes
        pending: List = []           # dispatched, not yet fetched
        chunks: List[bytes] = []
        bad = False

        def drain():
            nonlocal bad
            out_d, olen_d, nreal, last = pending.pop(0)
            out_h, olen_h = fetch_byte_rows(out_d), np.asarray(olen_d)
            olen_h = olen_h[:nreal]
            # every block must fill exactly bs except the global last
            full = olen_h[:-1] if last else olen_h
            if (olen_h < 0).any() or (full != bs).any():
                bad = True
                return
            for i in range(nreal):
                chunks.append(bytes(out_h[i, :olen_h[i]]))

        for gi in range(ngroups):
            grp = payloads[gi * G:(gi + 1) * G]
            nreal = len(grp)
            # pad the tail group to G with empty literal-only blocks so
            # every group reuses ONE compiled kernel shape
            pads = G - nreal if ngroups > 1 else 0
            grp = grp + [b"\x00"] * pads
            M = bucket_pow2(
                -(-max(len(c) for c in grp) // 128) * 128, 512, 1 << 17)
            arr = np.zeros((len(grp), M), np.uint8)
            lens = np.zeros((len(grp),), np.int32)
            for i, c in enumerate(grp):
                arr[i, :len(c)] = np.frombuffer(bytes(c), np.uint8)
                lens[i] = len(c)
            out_d, olen_d = decode_blocks_linked(
                upload_byte_rows(arr), jnp.asarray(lens), bs,
                init_window=win,
                init_window_len=bs if win is not None else 0)
            win = out_d[nreal - 1:nreal]
            pending.append((out_d, olen_d, nreal, gi == ngroups - 1))
            if len(pending) > 1:
                drain()
        while pending:
            drain()
        if bad:
            # A partial (flushed) non-final block is legal LZ4F but breaks
            # the kernel's one-block-window contract — successors then see
            # an empty window and report -1, so the errors and the layout
            # check must BOTH route here.  The host codec tracks the true
            # cumulative 64KB window and also gives precise errors for
            # genuinely corrupt frames.
            note_host_fallback("linked block short of its size")
            d = FrameDecompressor()
            used, content = d.feed(frame)
            if not d.finished:
                raise Lz4FrameError("truncated frame")
            return content, used
        content = b"".join(chunks)

    if info.content_checksum:
        if pos + 4 > len(frame):
            raise Lz4FrameError("truncated content checksum")
        want = struct.unpack_from("<I", frame, pos)[0]
        pos += 4
        if xxh32_fast(content, 0) != want:
            raise Lz4FrameError("content checksum mismatch")
    if info.content_size is not None and info.content_size != len(content):
        raise Lz4FrameError("frame content size mismatch")
    return content, pos


def _decompress_frame_device_stream(frame: bytes, info: FrameInfo):
    """Decode a frame with >64KB blocks through the stream decoder
    (decode_kernel.decode_stream): any block size up to 4MB, linked or
    independent, stored blocks spliced as literal-only blocks."""
    from .kernels.decode_kernel import decode_stream

    pos = info.header_size
    payloads: List[bytes] = []
    lens_hint: List[Optional[int]] = []
    while True:
        if pos + 4 > len(frame):
            raise Lz4FrameError("truncated frame")
        raw = struct.unpack_from("<I", frame, pos)[0]
        pos += 4
        if raw == 0:
            break
        size = raw & ~spec.UNCOMPRESSED_BIT
        if pos + size > len(frame):
            raise Lz4FrameError("truncated block")
        payload = frame[pos:pos + size]
        pos += size
        if info.block_checksum:
            want = struct.unpack_from("<I", frame, pos)[0]
            pos += 4
            if xxh32_fast(payload, 0) != want:
                raise Lz4FrameError("block checksum mismatch")
        if raw & spec.UNCOMPRESSED_BIT:
            payloads.append(_literal_block(payload))
            lens_hint.append(len(payload))
        else:
            payloads.append(payload)
            lens_hint.append(None)

    if not payloads:
        content = b""
    else:
        # per-block caps: stored blocks their exact length, compressed
        # blocks the full block_size (a mid-stream flushed short block is
        # legal LZ4F and must not starve later blocks' capacity)
        caps = [h if h is not None else info.block_size
                for h in lens_hint]
        try:
            out, olen = decode_stream(payloads, info.block_size, sum(caps),
                                      linked=not info.block_independent,
                                      out_caps=caps)
        except ValueError as e:
            # beyond the stream decoder's int32 positions
            raise DeviceLayoutUnsupported(str(e)) from None
        olen = np.asarray(olen)
        if (olen < 0).any():
            # could be corruption OR a layout the stream kernel does not
            # model; the host codec decides (and gives precise errors)
            raise DeviceLayoutUnsupported(
                f"stream kernel rejected block "
                f"{int(np.nonzero(olen < 0)[0][0])}")
        total = int(olen.sum())
        flat = fetch_byte_rows(out).reshape(-1)
        content = bytes(flat[:total])

    if info.content_checksum:
        if pos + 4 > len(frame):
            raise Lz4FrameError("truncated content checksum")
        want = struct.unpack_from("<I", frame, pos)[0]
        pos += 4
        if xxh32_fast(content, 0) != want:
            raise Lz4FrameError("content checksum mismatch")
    if info.content_size is not None and info.content_size != len(content):
        raise Lz4FrameError("frame content size mismatch")
    return content, pos


# ---------------------------------------------------------------------------
# chunked (streaming) device compression: LZ4F frames of unbounded size
# with bounded host memory (reference lz4io.c:497-542 works in 4MB reads)
# ---------------------------------------------------------------------------

class DeviceFrameCompressor:
    """Streaming LZ4F compression on device: feed chunks, emit frame bytes.

    Produces ONE linked 64KB-block frame (the reference CLI's -B4 -BD
    shape); the 64KB window carries across chunks via the linked kernel's
    dictionary-prefix seeding (LZ4_loadDict parity), so the output ratio
    matches whole-buffer compression.  Parity: LZ4F_compressBegin/Update/
    End driven from 4MB reads (lz4io.c:497-542) -- but with every block
    compressed on the device and O(64KB) host state.
    """

    def __init__(self, prefs: Optional[FramePreferences] = None,
                 acceleration: int = 1, min_match: int = 4,
                 reject_step: int = 1):
        from .ops.xxhash_np import XXH32State
        self.prefs = dataclasses.replace(prefs) if prefs \
            else FramePreferences()
        self.prefs.block_independent = False
        if self.prefs.block_size_id == 0:
            self.prefs.block_size_id = 4
        self.acceleration = acceleration
        self.min_match = min_match
        self.reject_step = reject_step
        self._tail = b""        # last 64KB of content (window carry)
        self._buf = b""         # sub-block input remainder
        self._xxh = XXH32State(0)
        self._begun = False
        self._pending = None    # dispatched device work awaiting fetch
        self._tail_dev = None   # (device [1, BS//4] words, len): window
                                # handoff without re-uploading the tail

    def begin(self) -> bytes:
        self._begun = True
        return encode_frame_header(self.prefs)

    def _emit_pending(self) -> bytes:
        """Fetch and assemble the previously dispatched chunk's frame
        bytes.  Keeping one chunk in flight double-buffers the pipeline:
        chunk k's kernel runs while chunk k-1's result crosses the link
        and chunk k+1 is read from disk."""
        if self._pending is None:
            return b""
        kind, payload = self._pending
        self._pending = None
        if kind == "flat":
            return fetch_packed(*payload)
        out, olen_d, lens, data = payload
        nb = out.shape[1] if out.ndim == 3 else out.shape[0]
        olen = np.asarray(olen_d[0])
        maxb = bucket_pow2(int(olen.max(initial=0)), 512, out.shape[-1])
        outb = fetch_byte_rows(out[0][:, :maxb])
        payloads = [outb[k, :olen[k]].tobytes() for k in range(nb)]
        parts = []
        pos = 0
        for k, pl_ in enumerate(payloads):
            blen = int(lens[0, k])
            if blen == 0:
                continue
            if len(pl_) >= blen:
                pl_ = data[pos:pos + blen]
                header = struct.pack("<I", blen | spec.UNCOMPRESSED_BIT)
            else:
                header = struct.pack("<I", len(pl_))
            parts.append(header)
            parts.append(pl_)
            if self.prefs.block_checksum:
                parts.append(struct.pack("<I", xxh32_fast(pl_, 0)))
            pos += blen
        return b"".join(parts)

    def _encode(self, data: bytes, prefix: bytes) -> bytes:
        """Compress whole data (multiple of 64KB, or a final partial) as
        linked blocks with ``prefix`` as the leading window —
        synchronously (dispatch + emit)."""
        self._dispatch(data, prefix)
        return self._emit_pending()

    def _dispatch(self, data: bytes, prefix: bytes) -> None:
        """Dispatch device compression of ``data`` without waiting."""
        BS = spec.WINDOW_SIZE
        nb = max(1, -(-len(data) // BS))
        if data and len(data) % BS == 0:
            # whole-block chunks (the update() steady state): upload the
            # packed content ONCE and build the [prev | cur] windows on
            # device; the window handoff between chunks is a device-
            # resident slice of the previous chunk's upload, so chunk
            # content crosses the link exactly once
            packed_np = np.frombuffer(data, np.uint8).reshape(nb, BS) \
                .view("<i4")
            packed_d = jnp.asarray(packed_np)
            if self._tail_dev is not None:
                tail_d, plen = self._tail_dev
            else:
                t = np.zeros((BS,), np.uint8)
                if prefix:
                    t[BS - len(prefix):] = np.frombuffer(prefix, np.uint8)
                tail_d = jnp.asarray(
                    np.ascontiguousarray(t).view("<i4")
                    .reshape(1, BS // 4))
                plen = len(prefix)
            val = _chunk_windows(packed_d, tail_d,
                                 jnp.int32(plen), NB=nb, BS=BS)
            self._tail_dev = (packed_d[nb - 1:nb], BS)
            lens = np.full((1, nb), BS, np.int32)
            prefix_lens = jnp.asarray(np.asarray([plen], np.int32))
        else:
            # partial tail (flush()/end()): host-built windows; the
            # device tail no longer matches the true window afterwards
            self._tail_dev = None
            rows = np.zeros((1, nb, 2 * BS), np.uint8)
            lens = np.zeros((1, nb), np.int32)
            for k in range(nb):
                lo, hi = (k - 1) * BS, (k + 1) * BS
                if k == 0:
                    rows[0, 0, BS - len(prefix):BS] = np.frombuffer(
                        prefix, np.uint8)
                    chunk = data[0:hi]
                    rows[0, 0, BS:BS + len(chunk)] = np.frombuffer(
                        chunk, np.uint8)
                else:
                    chunk = data[lo:hi]
                    rows[0, k, :len(chunk)] = np.frombuffer(chunk,
                                                            np.uint8)
                lens[0, k] = min(BS, len(data) - k * BS)
            w = rows.reshape(nb, 2 * BS // 4, 4).astype(np.uint32)
            packed = (w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16)
                      | (w[..., 3] << 24)).astype(np.int32)
            val = bytes_to_val32_rows(jnp.asarray(packed),
                                      2 * BS).reshape(1, nb, 2 * BS)
            prefix_lens = jnp.asarray(
                np.asarray([len(prefix)], np.int32))
        out, olen_d = encode_blocks_linked(val, jnp.asarray(lens),
                                           self.acceleration,
                                           prefix_lens=prefix_lens,
                                           min_match=self.min_match,
                                           reject_step=self.reject_step)
        if not self.prefs.block_checksum:
            # device-side assembly (kernels/pack.py): one packed fetch
            # per chunk instead of per-block joins
            self._pending = ("flat", pack_frame_payloads(
                out.reshape(nb, -1), olen_d.reshape(nb),
                val[0, :, BS:], lens[0]))
            return
        self._pending = ("blocks", (out, olen_d, lens, data))

    def update(self, chunk: bytes) -> bytes:
        assert self._begun, "call begin() first"
        BS = spec.WINDOW_SIZE
        data = self._buf + bytes(chunk)
        whole = (len(data) // BS) * BS
        self._buf = data[whole:]
        data = data[:whole]
        if not data:
            return b""
        if self.prefs.content_checksum:
            self._xxh.update(data)
        # double buffering: dispatch THIS chunk's kernels, then fetch the
        # PREVIOUS chunk's result while they run (the window carry is
        # host-tracked from the input, so chunk k+1 never waits on chunk
        # k's device results)
        prev = self._pending
        self._pending = None
        self._dispatch(data, self._tail)
        cur, self._pending = self._pending, prev
        out = self._emit_pending()
        self._pending = cur
        self._tail = data[-BS:]
        return out

    def flush(self) -> bytes:
        """Emit the buffered sub-block remainder NOW as a (possibly
        short) linked block — bounded-latency emission for callers that
        cannot wait for a whole 64KB block or for end().  Parity:
        LZ4F_flush (reference lz4frame.c:693-722); like the reference,
        a flush mid-stream simply produces a shorter block and the
        window keeps carrying, so flushed frames decode identically.
        Returns b"" when nothing is buffered."""
        assert self._begun, "call begin() first"
        drained = self._emit_pending()      # preserve emission order
        if not self._buf:
            return drained
        data, self._buf = self._buf, b""
        if self.prefs.content_checksum:
            self._xxh.update(data)
        out = self._encode(data, self._tail)
        self._tail = ((self._tail + data)[-spec.WINDOW_SIZE:]
                      if len(data) < spec.WINDOW_SIZE
                      else data[-spec.WINDOW_SIZE:])
        return drained + out

    def end(self) -> bytes:
        parts = [self._emit_pending()]      # drain the in-flight chunk
        if self._buf:
            if self.prefs.content_checksum:
                self._xxh.update(self._buf)
            parts.append(self._encode(self._buf, self._tail))
            self._buf = b""
        parts.append(struct.pack("<I", 0))
        if self.prefs.content_checksum:
            parts.append(struct.pack("<I", self._xxh.digest()))
        return b"".join(parts)


def decompress_legacy_device(data: bytes):
    """Decode a legacy frame (0x184C2102, 8MB independent blocks,
    lz4io.c:730-779) through the stream decoder, the raw frame uploaded
    verbatim.  Returns (content, bytes_consumed)."""
    from .kernels.decode_kernel import decode_stream_raw

    if len(data) < 4 or struct.unpack_from("<I", data)[0] != \
            spec.LEGACY_MAGIC:
        raise Lz4FrameError("not a legacy frame")
    pos = 4
    bstart, clen = [], []
    while pos + 4 <= len(data):
        size = struct.unpack_from("<I", data, pos)[0]
        if size == spec.FRAME_MAGIC or size == spec.LEGACY_MAGIC or \
                (size & spec.SKIPPABLE_MAGIC_MASK) == \
                spec.SKIPPABLE_MAGIC_MIN:
            break
        pos += 4
        if pos + size > len(data):
            raise Lz4FrameError("truncated legacy block")
        bstart.append(pos)
        clen.append(size)
        pos += size
    if not bstart:
        return b"", pos
    flat = np.frombuffer(data[:pos], np.uint8)
    stored = np.zeros((len(bstart),), np.int32)
    cap = len(bstart) * spec.LEGACY_BLOCK_SIZE
    out, olen = decode_stream_raw(flat, bstart, clen, stored,
                                  spec.LEGACY_BLOCK_SIZE, cap,
                                  linked=False)
    olen = np.asarray(olen)
    if (olen < 0).any():
        raise Lz4FrameError(
            f"legacy device decode failed on block "
            f"{int(np.nonzero(olen < 0)[0][0])}")
    total = int(olen.sum())
    flat_out = fetch_byte_rows(out).reshape(-1)
    return bytes(flat_out[:total]), pos
