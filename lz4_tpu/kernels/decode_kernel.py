"""LZ4 block decoder for the GPU: one Pallas kernel body through Triton.

An LZ4 token stream is sequential inside a block, so a block is decoded
by one program (one warp) running a token machine: the token, its length
extensions and the match offset are scalar loads, and literal runs and
match copies move as masked vector loads and stores of ``COPY`` bytes,
straight from the compressed input to the output's final place in device
memory.  An overlapping match (offset < length) copies in chunks of at
most ``offset`` bytes and doubles its source distance as the copied run
grows: any multiple of the offset is an equally valid source once that
many bytes exist, so even offset-1 runs settle into full-width chunks.

The 64 KB match window is read back from the output itself, so a window
is simply bytes in front of a block's output: a dictionary, the previous
block of a linked chain or the preceding bytes of a scatter-gather space
sits there, and the block's *window floor* says how far back a match may
reach.

Two launch shapes serve every decode form:

* ``blocks``: one program per independent block (batch, dictionary and
  destSize decode); programs run in any order.
* ``chain``: one program that decodes a whole chain in order, for the
  forms whose blocks depend on earlier output (linked frames, scatter-
  gather chains, linked streams).  GPU programs run in no fixed order,
  so the chain loop lives inside one program.

The stream decoder (one frame's blocks of 64 KB-8 MB as one output
stream) first walks every block's tokens in parallel without moving a
byte, to learn its decoded size; the sizes place each block's output, so
independent blocks then decode one program each and a linked stream as
one chain.

Semantics parity: ``LZ4_decompress_safe`` (reference lz4.c:1098-1320 via
the 1360 wrapper) -- bounds-checked literal and match copies, dictionary
windows (``_usingDict``, lz4.c:1512), errors reported as negative lengths.
Every sequence is validated whole before a byte moves, so a sequence that
does not fit stops cleanly at a token boundary: the destSize rewind
(lz4.c:1161-1163, 1316-1319).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .common import bucket_pow2, on_cpu, sync, triton_call

ERR_MALFORMED = -1
COPY = 32            # bytes per masked vector copy (one per thread)
NUM_WARPS = 1

# sequence outcomes
_RUN, _DONE, _CORRUPT, _FULL = 0, 1, 2, 3


def _decode_block(src, dst, s0, n, o0, olim, floor, interpret, copy=True):
    """Decode the block ``src[s0:s0+n]`` into ``dst[o0:olim]``; matches may
    reach back to ``dst[floor]``.  Returns (status, ip, op) at the last
    token boundary.  With ``copy=False`` no byte moves: the walk only
    measures the block."""
    iend = s0 + n
    last = src.shape[0] - 1
    lanes = lax.iota(jnp.int32, COPY)

    def byte(i):
        return src[jnp.clip(i, 0, last)].astype(jnp.int32)

    def length(nib, ip):
        """A nibble of 15 continues in extension bytes while they are 255."""
        def body(c):
            total, ip, ok, _ = c
            ok = jnp.logical_and(ok, ip < iend)
            b = jnp.where(ok, byte(ip), 0)
            return total + b, ip + 1, ok, b == 255

        total, ip, ok, _ = lax.while_loop(
            lambda c: jnp.logical_and(c[2], c[3]), body,
            (nib, ip, jnp.bool_(True), nib == 15))
        return total, ip, ok

    def copy_literals(ip, op, count):
        def body(k, carry):
            off = k * COPY + lanes
            m = off < count
            v = plgpu.load(src.at[jnp.minimum(ip + off, last)], mask=m,
                           other=0)
            plgpu.store(dst.at[op + off], v, mask=m)
            return carry

        lax.fori_loop(0, (count + COPY - 1) // COPY, body, 0)

    def copy_match(op, offset, count):
        def body(c):
            op, rem, dist = c
            sync(interpret)      # the source may be bytes just stored
            take = jnp.minimum(jnp.minimum(rem, dist), COPY)
            m = lanes < take
            v = plgpu.load(dst.at[op - dist + lanes], mask=m, other=0)
            plgpu.store(dst.at[op + lanes], v, mask=m)
            rem = rem - take
            dist = jnp.where(2 * dist - offset <= count - rem, 2 * dist,
                             dist)
            return op + take, rem, dist

        lax.while_loop(lambda c: c[1] > 0, body, (op, count, offset))

    def step(c):
        ip0, op, _ = c
        tok = byte(ip0)
        lit, ip, ok = length(tok >> 4, ip0 + 1)
        ok_lit = jnp.logical_and(ok, lit <= iend - ip)
        mpos = ip + lit
        ended = jnp.logical_and(ok_lit, mpos == iend)
        ok_off = jnp.logical_and(ok_lit, iend - mpos >= 2)
        offset = jnp.where(ok_off, byte(mpos) | (byte(mpos + 1) << 8), 1)
        mlen, ipm, ok_ml = length(tok & 15, mpos + 2)
        mlen = mlen + 4
        op1 = op + lit
        ok_match = jnp.logical_and(
            jnp.logical_and(ok_off, ok_ml),
            jnp.logical_and(offset > 0, offset <= op1 - floor))
        valid = jnp.logical_and(ok_lit, jnp.logical_or(ended, ok_match))
        room = jnp.logical_and(
            lit <= olim - op, jnp.logical_or(ended, mlen <= olim - op1))
        go = jnp.logical_and(valid, room)
        match = jnp.logical_and(go, jnp.logical_not(ended))
        if copy:
            copy_literals(ip, op, jnp.where(go, lit, 0))
            copy_match(op1, offset, jnp.where(match, mlen, 0))
        # _DONE / _RUN after a clean step, _FULL / _CORRUPT otherwise
        status = jnp.where(go, ended.astype(jnp.int32),
                           _CORRUPT + valid.astype(jnp.int32))
        ip = jnp.where(match, ipm, jnp.where(go, mpos, ip0))
        op = jnp.where(go, op1 + jnp.where(match, mlen, 0), op)
        return ip, op, status

    ip, op, status = lax.while_loop(
        lambda c: jnp.logical_and(c[2] == _RUN, c[0] < iend), step,
        (s0, o0, jnp.int32(_RUN)))
    return status, ip, op


def _copy_stored(src, dst, s0, n, o0, cap):
    """An uncompressed block (lz4frame.c:518-524) copied as one literal
    run; it fails when it does not fit its capacity."""
    lanes = lax.iota(jnp.int32, COPY)
    last = src.shape[0] - 1
    ok = n <= cap

    def body(k, carry):
        off = k * COPY + lanes
        m = off < n
        v = plgpu.load(src.at[jnp.minimum(s0 + off, last)], mask=m, other=0)
        plgpu.store(dst.at[o0 + off], v, mask=m)
        return carry

    lax.fori_loop(0, jnp.where(ok, (n + COPY - 1) // COPY, 0), body, 0)
    status = _CORRUPT - ok.astype(jnp.int32)          # _DONE or _CORRUPT
    return status, s0 + n, o0 + jnp.where(ok, n, 0)


# ---------------------------------------------------------------------------
# blocks: one program per independent block
# ---------------------------------------------------------------------------

def _blocks_kernel(P: int, resumable: bool, interpret: bool):
    """Row b: compressed row -> [window P | output] row.  meta[b] = (clen,
    capacity, window length)."""
    def kernel(meta, src, dst_in, dst, olen, *cons):
        del dst_in                      # aliased to dst
        b = pl.program_id(0)
        n = meta[b, 0]
        status, ip, op = _decode_block(src, dst, 0, n, P, P + meta[b, 1],
                                       P - meta[b, 2], interpret)
        if resumable:
            # destSize contract: any clean stop reports produced and
            # consumed counts; only corruption reports -1
            ok = status != _CORRUPT
            olen[b] = jnp.where(ok, op - P, ERR_MALFORMED)
            cons[0][b] = jnp.where(
                ok, jnp.where(status == _DONE, n, ip), ERR_MALFORMED)
        else:
            olen[b] = jnp.where(status == _DONE, op - P, ERR_MALFORMED)
    return kernel


@functools.partial(jax.jit, static_argnames=("N", "resumable", "interpret"))
def _decode_blocks(comp, clen, dict_rows, plen, ocap, *, N, resumable,
                   interpret):
    B, M = comp.shape
    P = dict_rows.shape[1]
    dst0 = jnp.concatenate(
        [dict_rows.astype(jnp.uint8), jnp.zeros((B, N), jnp.uint8)], axis=1)
    meta = jnp.stack([clen, jnp.minimum(ocap, N), plen], axis=1)
    out_shape = [jax.ShapeDtypeStruct((B, P + N), jnp.uint8),
                 jax.ShapeDtypeStruct((B,), jnp.int32)]
    out_specs = [pl.BlockSpec((None, P + N), lambda b: (b, 0)),
                 pl.BlockSpec((B,), lambda b: (0,))]
    if resumable:
        out_shape.append(jax.ShapeDtypeStruct((B,), jnp.int32))
        out_specs.append(pl.BlockSpec((B,), lambda b: (0,)))
    res = triton_call(
        _blocks_kernel(P, resumable, interpret),
        num_warps=NUM_WARPS, interpret=interpret,
        grid=(B,),
        in_specs=[pl.BlockSpec((B, 3), lambda b: (0, 0)),
                  pl.BlockSpec((None, M), lambda b: (b, 0)),
                  pl.BlockSpec((None, P + N), lambda b: (b, 0))],
        out_specs=tuple(out_specs),
        out_shape=tuple(out_shape),
        input_output_aliases={2: 0},
    )(meta, comp.astype(jnp.uint8), dst0)
    out = res[0][:, P:].astype(jnp.int32)
    return (out,) + tuple(res[1:])


def _dict_args(B, dict_rows, dict_lens):
    if dict_rows is None:
        return jnp.zeros((B, 0), jnp.int32), jnp.zeros((B,), jnp.int32)
    return dict_rows, dict_lens.astype(jnp.int32)


def decode_blocks(comp_bytes_i32: jax.Array, comp_lens: jax.Array,
                  out_cap: int,
                  dict_rows: jax.Array | None = None,
                  dict_lens: jax.Array | None = None,
                  out_caps: jax.Array | None = None):
    """Decode a batch of independent (or dict-prefixed) LZ4 blocks.

    Args:
      comp_bytes_i32: [B, M] int32 bytes (zero padded rows).
      comp_lens: [B] int32 lengths.
      out_cap: static decoded capacity per row.
      dict_rows: optional [B, P] int32 dictionary bytes, RIGHT-aligned in
        each row (row i holds its dict in lanes [P-dict_lens[i], P)).
      dict_lens: [B] int32 dictionary lengths.
      out_caps: optional [B] per-row exact output capacity (defaults to
        out_cap); decoding past it reports -1, like LZ4_decompress_safe.

    Returns (out [B, out_cap] int32 bytes, olen [B] int32; -1 = malformed).
    """
    B = comp_bytes_i32.shape[0]
    dict_rows, dict_lens = _dict_args(B, dict_rows, dict_lens)
    ocap = (jnp.full((B,), out_cap, jnp.int32) if out_caps is None
            else out_caps.astype(jnp.int32))
    return _decode_blocks(comp_bytes_i32, comp_lens.astype(jnp.int32),
                          dict_rows, dict_lens, ocap, N=int(out_cap),
                          resumable=False, interpret=on_cpu())


def decode_blocks_dest_size(comp_bytes_i32: jax.Array,
                            comp_lens: jax.Array,
                            out_caps: jax.Array, out_cap_max: int,
                            dict_rows: jax.Array | None = None,
                            dict_lens: jax.Array | None = None):
    """Batched resumable destSize decode (the fork's token-boundary
    rewind, lz4.c:1161-1163, 1316-1319, on device): every row fills at
    most ``out_caps[i]`` bytes and stops at a TOKEN BOUNDARY, reporting
    both the bytes produced and the source bytes consumed.

    Returns (out [B, out_cap_max], olen [B], cons [B]):
      olen >= 0, cons == comp_lens[i]  -> consumed to the end of the
        source AT A TOKEN BOUNDARY.  This usually means "decoded fully",
        but a malformed block that ends exactly after a match (no
        terminal literal-only sequence) also lands here: the caller must
        validate olen against the expected decoded size, exactly as
        lz4sg.c does with its exact block extents (plain decode_blocks
        reports -1 for the same bytes because it requires the terminal
        literal sequence).
      olen >= 0, cons <  comp_lens[i]  -> clean stop (out of output
        room): resume by feeding comp[cons:] with the produced bytes as
        the dictionary window
      olen == cons == -1               -> corrupt input.  NOTE unlike the
        host decompress_block_dest_size, mid-sequence SOURCE truncation
        is reported here as corruption, not rewound: the device variant
        resumes across output exhaustion only, matching how lz4sg.c uses
        the contract (whole-block payloads, room-limited outputs).
    """
    B = comp_bytes_i32.shape[0]
    dict_rows, dict_lens = _dict_args(B, dict_rows, dict_lens)
    return _decode_blocks(comp_bytes_i32, comp_lens.astype(jnp.int32),
                          dict_rows, dict_lens, out_caps.astype(jnp.int32),
                          N=int(out_cap_max), resumable=True,
                          interpret=on_cpu())


# ---------------------------------------------------------------------------
# chain: one program decodes a whole chain in order
# ---------------------------------------------------------------------------

def _chain_kernel(window: str, block: int, parallel: bool, interpret: bool):
    """Blocks at meta-given places of one flat input and output.  window:
    'fixed' (meta gives each output start and floor) or 'linked' (the
    window is the previous ``block``-byte slot when that block filled
    it).  ``parallel``: one program per block (independent blocks);
    otherwise one program walks the chain in order."""
    def kernel(meta, src, dst_in, dst, olen):
        del dst_in                      # aliased to dst

        def one(b, prev):
            s0, n, o0, cap = meta[b, 0], meta[b, 1], meta[b, 2], meta[b, 3]
            if window == "linked":
                floor = jnp.where(b == 0, meta[b, 4],
                                  jnp.where(prev == block, o0 - block, o0))
            else:
                floor = meta[b, 4]
            status, _, op = lax.cond(
                meta[b, 5] != 0,
                lambda: _copy_stored(src, dst, s0, n, o0, cap),
                lambda: _decode_block(src, dst, s0, n, o0, o0 + cap, floor,
                                      interpret))
            length = jnp.where(status == _DONE, op - o0, ERR_MALFORMED)
            olen[b] = length
            return length

        if parallel:
            one(pl.program_id(0), jnp.int32(0))
        else:
            lax.fori_loop(0, meta.shape[0], one, jnp.int32(0))
    return kernel


@functools.partial(jax.jit, static_argnames=("window", "block", "parallel",
                                              "interpret"))
def _decode_chain(meta, src, dst0, *, window, block, interpret,
                  parallel=False):
    B = meta.shape[0]
    return triton_call(
        _chain_kernel(window, block, parallel, interpret),
        num_warps=NUM_WARPS, interpret=interpret,
        grid=(B if parallel else 1,),
        out_shape=(jax.ShapeDtypeStruct(dst0.shape, jnp.uint8),
                   jax.ShapeDtypeStruct((B,), jnp.int32)),
        input_output_aliases={2: 0},
    )(meta, src, dst0)


def _sizes_kernel(interpret: bool):
    """Program b walks block b's tokens without moving a byte: its
    decoded size, or -1 when it does not parse within its capacity.
    meta[b] = (start, length, capacity, stored flag)."""
    def kernel(meta, src, size):
        b = pl.program_id(0)
        n, cap = meta[b, 1], meta[b, 2]
        status, _, op = _decode_block(src, None, meta[b, 0], n, 0, cap,
                                      -(1 << 30), interpret, copy=False)
        walked = jnp.where(status == _DONE, op, ERR_MALFORMED)
        stored = jnp.where(n <= cap, n, ERR_MALFORMED)
        size[b] = jnp.where(meta[b, 3] != 0, stored, walked)
    return kernel


@functools.partial(jax.jit, static_argnames=("interpret",))
def _block_sizes(meta, src, *, interpret):
    B = meta.shape[0]
    return triton_call(
        _sizes_kernel(interpret), num_warps=NUM_WARPS, interpret=interpret,
        grid=(B,), out_shape=jax.ShapeDtypeStruct((B,), jnp.int32),
    )(meta, src)


def _chain_meta(s0, n, o0, cap, floor, stored):
    """[B, 6] per-block columns of a chain: compressed start and length,
    output start, output capacity, window floor, stored flag."""
    return jnp.asarray(np.stack(
        [np.asarray(x, np.int64).astype(np.int32)
         for x in (s0, n, o0, cap, floor, stored)], axis=1))


def decode_blocks_linked(comp_bytes_i32: jax.Array, comp_lens: jax.Array,
                         block_size: int, init_window: jax.Array = None,
                         init_window_len: int = 0):
    """Decode a chain of linked LZ4 blocks (one stream, in order).

    Block ``b``'s 64 KB window is block ``b-1``'s output, matching the
    LZ4F blockLinked contract (reference lz4frame.c:644-657 carrying the
    dictionary via LZ4_compress_fast_continue / _usingDict): every block
    except the last must decode to exactly ``block_size`` bytes, which is
    how LZ4F compressors emit linked frames (lz4frame.c:575-682 buffers
    input to whole blocks).  A block after a short one sees no window.

    Args:
      comp_bytes_i32: [B, M] int32 bytes, block payloads in stream order.
      comp_lens: [B] int32 payload lengths.
      block_size: the frame's block size (multiple of 128, <= 64 KB; the
        window is the full previous block).
      init_window: optional [1, block_size] int32 byte lanes seeding
        block 0's window (right-aligned content, e.g. the previous
        group's last decoded block when decoding a long chain in
        groups -- may be a device array: the handoff stays on device).
      init_window_len: its byte length (<= block_size).

    Returns (out [B, block_size] int32 bytes, olen [B]; -1 = malformed).
    """
    B, M = comp_bytes_i32.shape
    if block_size % 128:
        raise ValueError("block_size must be a multiple of 128")
    N = block_size
    if init_window is not None and init_window_len:
        head = init_window.reshape(N).astype(jnp.uint8)
        plen = int(init_window_len)
    else:
        head = jnp.zeros((N,), jnp.uint8)
        plen = 0
    dst0 = jnp.concatenate([head, jnp.zeros((B * N,), jnp.uint8)])
    starts = N + N * np.arange(B)
    meta = _chain_meta(M * np.arange(B), np.zeros(B), starts,
                       np.full(B, N), starts - plen, np.zeros(B))
    meta = meta.at[:, 1].set(comp_lens.astype(jnp.int32))
    src = comp_bytes_i32.astype(jnp.uint8).reshape(B * M)
    dst, olen = _decode_chain(meta, src, dst0, window="linked", block=N,
                              interpret=on_cpu())
    return dst[N:].reshape(B, N).astype(jnp.int32), olen


SG_LEAD = 65536      # zero lead of the scatter-gather output space


def decode_blocks_sg(comp_bytes_i32: jax.Array, comp_lens: jax.Array,
                     out_sizes):
    """Decode a scatter-gather chain: block k's output lands at byte
    offset sum(out_sizes[:k]) of ONE continuous space, and its window is
    the preceding 64 KB of that space regardless of block boundaries
    (LZ4_decompress_fast_sg_extState semantics, lz4sg.c:536-695; the
    host walks the iovec list and supplies clean per-block payloads).

    Args:
      comp_bytes_i32: [B, M] int32 bytes (payloads, chain order).
      comp_lens: [B] int32 payload lengths.
      out_sizes: python list of expected decoded sizes (each <= 64KB).

    Returns (out [TOTR, 128] int32 device array whose byte stream starting
    at byte 65536 is the continuous content, olen [B]).
    """
    B, M = comp_bytes_i32.shape
    sizes = [int(x) for x in out_sizes]
    if any(x > 65536 for x in sizes):
        raise ValueError("sg kernel blocks are limited to 64KB outputs")
    N = -(-max(max(sizes, default=1), 1) // 128) * 128
    total = sum(sizes)
    if total + SG_LEAD + N + 256 >= 2 ** 31:
        # the kernel addresses the output space with int32 byte offsets
        raise ValueError("decode_blocks_sg output space exceeds the "
                         "kernel's int32 addressing limit")
    TOTR = SG_LEAD // 128 + -(-total // 128) + N // 128 + 2
    cum = np.zeros((B,), np.int64)
    if B > 1:
        cum[1:] = np.cumsum(sizes[:-1])
    meta = _chain_meta(M * np.arange(B), np.zeros(B), SG_LEAD + cum,
                       sizes, SG_LEAD + cum - np.minimum(cum, 65536),
                       np.zeros(B))
    meta = meta.at[:, 1].set(comp_lens.astype(jnp.int32))
    src = comp_bytes_i32.astype(jnp.uint8).reshape(B * M)
    dst, olen = _decode_chain(meta, src,
                              jnp.zeros((TOTR * 128,), jnp.uint8),
                              window="fixed", block=0, interpret=on_cpu())
    return dst.reshape(TOTR, 128).astype(jnp.int32), olen


# ---------------------------------------------------------------------------
# stream: one frame's block chain of any block size, decoded as a single
# output stream (what decodes reference-CLI default files: -B7 4MB blocks,
# lz4io.c:182-188, and legacy 8MB blocks)
# ---------------------------------------------------------------------------

PAGE = 65536


def decode_stream(payloads, block_size: int, content_cap: int,
                  linked: bool = True, out_caps=None):
    """Decode one frame's block chain of any block size on device.

    Args:
      payloads: list of compressed block payloads (stream order; stored
        blocks must be pre-wrapped as literal blocks by the caller).
      block_size: the frame's block size (64KB..4MB, multiple of 64KB).
      content_cap: total decoded capacity (each block <= block_size);
        the output is sized from the blocks' measured sizes instead.
      linked: blockMode (window crosses block boundaries when True).
      out_caps: optional per-block decoded capacities (e.g. exact stored
        lengths); defaults to block_size each.  A mid-stream flushed
        block shorter than block_size is legal LZ4F, so caps must be
        per-block, not a draining pool.

    Returns (out bytes-lane rows [(cap rows),128] int32, olen [B] int32
    per-block decoded lengths; -1 = malformed).
    """
    if block_size % PAGE:
        raise ValueError("block_size must be a multiple of 64KB")
    starts = np.zeros((len(payloads),), np.int64)
    if payloads:
        starts[1:] = np.cumsum([len(p) for p in payloads])[:-1]
    flat = np.frombuffer(b"".join(bytes(p) for p in payloads), np.uint8)
    return decode_stream_raw(flat, starts, [len(p) for p in payloads],
                             np.zeros((len(payloads),), np.int32),
                             block_size, content_cap, linked,
                             out_caps=out_caps)


def decode_stream_raw(flat_u8: np.ndarray, bstart, clen, stored,
                      block_size: int, content_cap: int,
                      linked: bool = True, out_caps=None):
    """decode_stream over payloads at arbitrary BYTE offsets of one flat
    buffer (e.g. a raw .lz4 frame uploaded verbatim): zero host repacking.

    ``stored`` flags mark uncompressed blocks (copied in-kernel).
    """
    B = len(bstart)
    interpret = on_cpu()
    # static shapes (input bytes, output bytes, block count) are bucketed
    # to powers of two so distinct file sizes reuse compiled kernels
    total = bucket_pow2(len(flat_u8) + 256, 4 * PAGE)
    if total >= 2 ** 31:
        raise ValueError("decode_stream input exceeds the kernel's int32 "
                         "addressing limit")
    src = np.zeros((total,), np.uint8)
    src[:len(flat_u8)] = flat_u8
    src = jnp.asarray(src)
    BP = bucket_pow2(B, 4)
    # padding blocks are empty stored blocks: they copy zero bytes
    pad = lambda x, fill: np.concatenate(    # noqa: E731
        [np.asarray(x, np.int64), np.full(BP - B, fill, np.int64)])
    starts, lens, flags = pad(bstart, 0), pad(clen, 0), pad(stored, 1)
    caps = pad(np.full(B, block_size) if out_caps is None else out_caps, 0)
    caps = np.minimum(caps, 1 << 23)
    # pass 1: every block's decoded size, in parallel; a block that does
    # not parse is reported as malformed and decodes nothing
    sizes = np.asarray(_block_sizes(
        jnp.asarray(np.stack([starts, lens, caps, flags], 1).astype(
            np.int32)), src, interpret=interpret)).astype(np.int64)
    bad = sizes < 0
    sizes = np.where(bad, 0, sizes)
    ostart = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    out_total = int(sizes.sum())
    if out_total + 256 >= 2 ** 31:
        # output positions are int32; fail loudly (to the caller's
        # host-fallback policy) before they can wrap
        raise ValueError("decode_stream output space exceeds the kernel's "
                         "int32 addressing limit")
    OR = bucket_pow2(-(-out_total // 128) + 2, 4 * PAGE // 128)
    # pass 2: each block decodes into its place; the window floor is the
    # stream start (linked) or the block's own start (independent)
    meta = _chain_meta(starts, np.where(bad, 0, lens), ostart, sizes,
                       np.zeros(BP) if linked else ostart,
                       np.where(bad, 1, flags))
    dst, olen = _decode_chain(
        meta, src, jnp.zeros((OR * 128,), jnp.uint8), window="fixed",
        block=0, parallel=not linked, interpret=interpret)
    olen = np.where(bad, ERR_MALFORMED, np.asarray(olen))
    return dst.reshape(OR, 128).astype(jnp.int32), olen[:B]
