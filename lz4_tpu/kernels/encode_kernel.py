"""LZ4 block encoder (fast/greedy): XLA match index, Triton scan kernel.

Parity: ``LZ4_compress_fast`` semantics (reference lz4.c:510-800) -- greedy
parse, skip acceleration (lz4.c:586-594), backward extension (lz4.c:635),
spec parsing restrictions (last 5 literals, 12-byte match tail).  Output
is a valid LZ4 block stream; byte-identity with the C encoder is NOT a
goal (the spec allows any parse), ratio parity is.

The reference's serial hash table -- probe, validate, insert at every
scanned position -- is replaced by a *sorted-candidate pass* that XLA runs
over whole rows before the scan:

  cand_delta_rows: sort (val32, position) per row -- equal 5-byte
  sequences become sort neighbours, so each position's nearest previous
  occurrence is one neighbour diff; a second sort un-permutes the deltas
  back to position order.

The scan then reads ``delta[p]`` (0 = no candidate in window): EXACT
candidates (no hash collisions, no validation load) and no table stores
in the scan loop.  Emitted offsets are ``delta`` itself, in [1, 65535] by
construction, which structurally excludes the offset-0 corruption class
(docs/STRIDE2_BUG.md).  A barren-jump table (distance to the next
candidate) lets the scan leap candidate-free runs.

The greedy parse is sequential inside a block, so one Triton program
(one warp) scans each block: candidate reads and match extension are
scalar loads of ``val32`` lanes (val32[p] = LE32 word at byte p, so a
4-byte compare is one load), literal runs move as masked vector copies.
Independent and linked blocks share the scan body; a linked block's row
is [previous block | block], so matches reach into the previous 64 KB
(LZ4_compress_fast_continue prefix mode, lz4.c:990-1045).

``min_match`` (the decode-speed knob: fewer sequences) pre-filters
candidates in the sorted pass for any mm >= 6: XOR byte-run counts
between sort neighbours give exact forward/backward length bounds, so
provably-rejectable candidates never reach the scan; ``reject_step``
bounds the rescan density of the rejects that survive.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .common import on_cpu, triton_call
from ..spec import compress_bound

POS_BITS = 18          # positions < 2^18 (blocks <= 256KB in this kernel)
SKIP_TRIGGER = 6
MAX_BLOCK = 1 << POS_BITS
WINDOW = 65536
COPY = 32              # bytes per masked vector copy (one per thread)
NUM_WARPS = 1


@functools.partial(jax.jit, static_argnames=("row_bytes",))
def bytes_to_val32_rows(packed_words: jax.Array, row_bytes: int) -> jax.Array:
    """[B, W] int32 packed LE words -> [B, row_bytes] int32 where lane p is
    the LE32 read at byte offset p (4-byte lookahead packed per lane; the
    last 3 lanes wrap to the row start)."""
    w = packed_words.astype(jnp.int32)
    b0 = w & 0xFF
    b1 = (w >> 8) & 0xFF
    b2 = (w >> 16) & 0xFF
    b3 = (w >> 24) & 0xFF
    by = jnp.stack([b0, b1, b2, b3], axis=-1).reshape(w.shape[0], row_bytes)
    v = (by
         + (jnp.roll(by, -1, axis=1) << 8)
         + (jnp.roll(by, -2, axis=1) << 16)
         + (jnp.roll(by, -3, axis=1) << 24))
    return v


@jax.jit
def cand_delta_rows(val: jax.Array, filter_mm=None) -> jax.Array:
    """[B, N] val32 rows -> [B, N] int32 candidate deltas: lane p holds
    ``p - p'`` for the NEAREST p' < p whose 5 bytes equal p's within the
    65535-byte match window, or 0 when none exists.

    Two lax.sorts per row: sorting (val32, b5<<18|pos) groups equal
    5-byte sequences adjacently -- the nearest previous occurrence is the
    sort predecessor -- then sorting (pos, delta) un-permutes.  This
    replaces the reference's scalar hash table (lz4.c:454-477, 598-612):
    exact -- no hash collisions.  The key is 5 bytes like the reference's
    64-bit build (lz4.c:462-468): a 4-byte key finds nearest-but-weak
    candidates (common 4-grams are everywhere) and was measured 4-10%
    worse on ratio; 5 bytes biases candidates toward longer matches.

    ``filter_mm`` (optional [B] int32 per-row min_match): rows with
    mm >= 6 get a NECESSARY-condition pre-filter applied here, in the
    sorted pass, instead of in the scan.  The sort carries val32@+4 and
    val32@-4 as passenger operands; XOR byte-run counts between the
    neighbour pair give the EXACT forward match length up to 8 (bytes
    0..4 equal by the 5-byte key; bytes 5..7 tested individually) and
    the EXACT backward run up to 4 -- so a candidate is zeroed precisely
    when fwd < 8 AND bwd < 4 AND fwd + bwd < mm, which the scan would
    provably reject anyway.  Survivors still get the exact
    ``ml >= min_match`` test in the scan.  (The wrapped-lane compares at
    row edges are heuristic: necessary-only either way; a false byte
    EQUALITY at a wrapped lane only keeps a candidate, and positions near
    the row end never start matches.)
    """
    B, N = val.shape
    assert N <= (1 << 19)
    pos_bits = 18 if N <= (1 << 18) else 19
    pos = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), (B, N))
    b5 = jnp.roll(val, -4, axis=-1) & 0xFF
    k2 = (b5 << pos_bits) | pos
    if filter_mm is None:
        sk, sk2 = lax.sort((val, k2), dimension=1, num_keys=2)
        keep = None
    else:
        v4 = jnp.roll(val, -4, axis=-1)
        vm4 = jnp.roll(val, 4, axis=-1)
        sk, sk2, sv4, svm4 = lax.sort((val, k2, v4, vm4), dimension=1,
                                      num_keys=2)
        tf = sv4[:, 1:] ^ sv4[:, :-1]      # bytes +4..+7 (byte +4 = key)
        tb = svm4[:, 1:] ^ svm4[:, :-1]    # bytes -4..-1
        # forward run: 5 key bytes + bytes +5, +6, +7 (prefix tests)
        m5 = (tf & 0x00FF00) == 0
        m6 = (tf & 0xFFFF00) == 0
        m7 = tf == 0
        fwd = (5 + m5.astype(jnp.int32) + m6.astype(jnp.int32)
               + m7.astype(jnp.int32))            # exact up to 8
        # backward run from byte -1 downward (suffix tests, top first)
        n1 = ((tb >> 24) & 0xFF) == 0
        n2 = ((tb >> 16) & 0xFFFF) == 0
        n3 = ((tb >> 8) & 0xFFFFFF) == 0
        n4 = tb == 0
        bwd = (n1.astype(jnp.int32) + n2.astype(jnp.int32)
               + n3.astype(jnp.int32) + n4.astype(jnp.int32))  # exact to 4
        mm_row = filter_mm.reshape(B, 1).astype(jnp.int32)
        keep = jnp.logical_or(
            jnp.logical_or(m7, n4),               # length caps reached:
            fwd + bwd >= mm_row)                  # true length unknown

    sp = sk2 & ((1 << pos_bits) - 1)
    same = jnp.logical_and(
        sk[:, 1:] == sk[:, :-1],
        (sk2 >> pos_bits)[:, 1:] == (sk2 >> pos_bits)[:, :-1])
    if keep is not None:
        same = jnp.logical_and(same, keep)
    same = jnp.concatenate([jnp.zeros((B, 1), bool), same], axis=1)
    prev = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), sp[:, :-1]], axis=1)
    d = jnp.where(same, sp - prev, 0)
    d = jnp.where(d <= 65535, d, 0)
    _, dd = lax.sort((sp, d), dimension=1, num_keys=1)
    return dd


def _next_candidate(d: jax.Array) -> jax.Array:
    """[R, N] candidate deltas -> [R, N] position of the next lane
    (>= itself) holding a candidate, N when none."""
    N = d.shape[1]
    pos = jnp.arange(N, dtype=jnp.int32)[None, :]
    cand = jnp.where(d > 0, pos, N)
    return jnp.flip(lax.cummin(jnp.flip(cand, axis=1), axis=1), axis=1)


@jax.jit
def _jump_rows(d: jax.Array) -> jax.Array:
    """[R, N] candidate deltas -> [R, N] int32 distance from each lane to
    the NEXT lane (>= itself) holding a candidate (N-pos when none, so a
    barren tail jumps straight out of the scan), clipped to 65535.

    The scan's skip path advances by max(accel step, jump): lanes between
    a barren position and its next candidate can produce neither a match
    nor a probe, so jumping them never skips a candidate; probe density
    is equal or better (fewer visits grow the accel step more slowly, so
    the parse can differ from the unjumped scan -- ratio-neutral-or-better,
    not byte-identical).  The reference's skip trigger (lz4.c:586-594)
    gambles geometrically on barren runs; the sorted pass has already
    measured them."""
    pos = jnp.arange(d.shape[1], dtype=jnp.int32)[None, :]
    return jnp.minimum(_next_candidate(d) - pos, 65535)


@jax.jit
def cand_frac8_rows(val: jax.Array) -> jax.Array:
    """[B, N] val32 rows -> [B] float32: fraction of positions whose
    nearest previous 5-byte-equal candidate also matches 8 forward bytes
    (i.e. would survive a min_match pre-filter) -- a one-sort statistic
    of long-match density used to pick a per-block min_match (adaptive
    mode).  Rides the same sort as ``cand_delta_rows`` with val32@+4
    carried as a passenger operand, so no gather is needed to compare
    candidate bytes."""
    B, N = val.shape
    pos = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), (B, N))
    b5 = jnp.roll(val, -4, axis=-1) & 0xFF
    v4 = jnp.roll(val, -4, axis=-1)
    k2 = (b5 << 18) | pos
    sk, sk2, sv4 = lax.sort((val, k2, v4), dimension=1, num_keys=2)
    sp = sk2 & ((1 << 18) - 1)
    same = jnp.logical_and(sk[:, 1:] == sk[:, :-1],
                           (sk2 >> 18)[:, 1:] == (sk2 >> 18)[:, :-1])
    near = (sp[:, 1:] - sp[:, :-1]) <= 65535
    m8 = jnp.logical_and(jnp.logical_and(same, near),
                         sv4[:, 1:] == sv4[:, :-1])
    return jnp.mean(m8.astype(jnp.float32), axis=1)


# ---------------------------------------------------------------------------
# the scan kernel
# ---------------------------------------------------------------------------

def _scan_kernel(NS: int, linked: bool, reject_step: int):
    """One program per block.  Independent rows: val [NS], cand [NS] =
    delta | jump << 16, block at lane 0.  Linked rows: val [WINDOW + NS]
    with the block at lane WINDOW, cand [NS] = delta, jump [NS // 4] =
    block-relative next-candidate position at lane 4k."""
    start = WINDOW if linked else 0

    def kernel(meta, val, cand, *rest):
        if linked:
            jump, out, olen = rest
        else:
            out, olen = rest
        b = pl.program_id(0)
        n = meta[b, 0]
        prefix = meta[b, 1]             # readable bytes before the block
        mm = meta[b, 2]
        reset = meta[b, 3]              # skip counter after a match
        lanes = lax.iota(jnp.int32, COPY)

        def word(p):
            return val[p]

        def byte(p):
            return val[p] & 0xFF

        def put(op, x):
            out[op] = x.astype(jnp.uint8)

        def put_run(op, e):
            """Length extension: e // 255 bytes of 255, then e % 255."""
            k = e // 255

            def body(j, carry):
                off = j * COPY + lanes
                plgpu.store(out.at[op + off],
                            jnp.full((COPY,), 255, jnp.uint8), mask=off < k)
                return carry

            lax.fori_loop(0, (k + COPY - 1) // COPY, body, 0)
            put(op + k, e - 255 * k)
            return op + k + 1

        def put_literals(op, src, count):
            def body(j, carry):
                off = j * COPY + lanes
                m = off < count
                v = plgpu.load(val.at[src + off], mask=m, other=0)
                plgpu.store(out.at[op + off], (v & 0xFF).astype(jnp.uint8),
                            mask=m)
                return carry

            lax.fori_loop(0, (count + COPY - 1) // COPY, body, 0)
            return op + count

        def put_sequence(op, anchor, litlen, offset, ml_code):
            """Token, literal run, LE16 offset, match-length extension."""
            put(op, (jnp.minimum(litlen, 15) << 4) | jnp.minimum(ml_code, 15))
            op = lax.cond(litlen >= 15, lambda o: put_run(o, litlen - 15),
                          lambda o: o, op + 1)
            op = put_literals(op, anchor, litlen)
            put(op, offset & 0xFF)
            put(op + 1, offset >> 8)
            return lax.cond(ml_code >= 15,
                            lambda o: put_run(o, ml_code - 15),
                            lambda o: o, op + 2)

        def put_last(op, anchor, litlen):
            """Trailing literal-only sequence."""
            put(op, jnp.minimum(litlen, 15) << 4)
            op = lax.cond(litlen >= 15, lambda o: put_run(o, litlen - 15),
                          lambda o: o, op + 1)
            return put_literals(op, anchor, litlen)

        n_end = start + n
        mflimit = n_end - 12      # last position a match may start
        matchlimit = n_end - 5    # matches may extend up to here (excl.)
        low = start - prefix      # lowest readable position

        def with_match(ip, op, anchor, scnt, q):
            # backward extension (catch-up, lz4.c:635)
            def bcond(c):
                mp, qq = c
                return jnp.logical_and(
                    jnp.logical_and(mp > anchor, qq > low),
                    byte(mp - 1) == byte(qq - 1))

            mp, q2 = lax.while_loop(bcond, lambda c: (c[0] - 1, c[1] - 1),
                                    (ip, q))

            # forward extension, 8 bytes per step...
            def f8cond(ml):
                return jnp.logical_and(
                    mp + ml + 8 <= matchlimit,
                    jnp.logical_and(word(q2 + ml) == word(mp + ml),
                                    word(q2 + ml + 4) == word(mp + ml + 4)))

            ml = lax.while_loop(f8cond, lambda ml: ml + 8, ip + 4 - mp)
            step4 = jnp.logical_and(mp + ml + 4 <= matchlimit,
                                    word(q2 + ml) == word(mp + ml))
            ml = ml + 4 * step4.astype(jnp.int32)
            # ...then the <4-byte tail from the XOR of the first
            # mismatching words (diff==0 means limit-stopped: tail=3 and
            # the min() clamp bounds it), lz4.c LZ4_count's role
            diff = word(q2 + ml) ^ word(mp + ml)
            tail = (((diff & 0xFF) == 0).astype(jnp.int32)
                    + ((diff & 0xFFFF) == 0).astype(jnp.int32)
                    + ((diff & 0xFFFFFF) == 0).astype(jnp.int32))
            ml = jnp.minimum(ml + tail, matchlimit - mp)

            def emit():
                op2 = put_sequence(op, anchor, mp - anchor, ip - q, ml - 4)
                return mp + ml, op2, mp + ml, reset

            # min-match knob: short matches stay literal; on reject the
            # scan advances by at most reject_step (dense probing finds
            # the long matches)
            return lax.cond(
                ml >= mm, emit,
                lambda: (ip + jnp.maximum(scnt >> SKIP_TRIGGER, reject_step),
                         op, anchor, scnt + 1))

        def skip(ip, op, anchor, scnt):
            step = scnt >> SKIP_TRIGGER
            if linked:
                # 4-granular next-candidate table: jump[j >> 2] is a lower
                # bound on the next candidate at or after any landing j,
                # so max(ip2, snap) never skips one
                ip2 = ip + step
                j = ip2 - start
                snap = start + jump[jnp.minimum(j >> 2, NS // 4 - 1)]
                ip2 = jnp.where(j < NS, jnp.maximum(ip2, snap), ip2)
            else:
                ip2 = ip + jnp.maximum(step, (cand[ip] >> 16) & 0xFFFF)
            return ip2, op, anchor, scnt + 1

        def body(state):
            ip, op, anchor, scnt = state
            d = cand[ip - start] & 0xFFFF
            q = ip - d
            # q >= low guards a partial prefix's zero padding: its val32
            # lanes equal real zero runs, so matches must not reach them
            good = jnp.logical_and(d > 0, q >= low)
            return lax.cond(good,
                            lambda: with_match(ip, op, anchor, scnt, q),
                            lambda: skip(ip, op, anchor, scnt))

        # a block with any window may match from its first byte; only a
        # windowless start skips position 0
        init = (start + (prefix <= 0).astype(jnp.int32),
                jnp.int32(0), jnp.int32(start), reset)
        run = n >= 13
        _, op, anchor, _ = lax.while_loop(
            lambda s: jnp.logical_and(run, s[0] <= mflimit), body, init)
        op = put_last(op, anchor, n_end - anchor)
        olen[b] = jnp.where(n > 0, op, 0) if linked else op

    return kernel


def _scan_meta(slen, prefix, mm, acceleration):
    """Per-block scan parameters: length, readable bytes before the
    block, min_match and the skip counter's reset value."""
    return jnp.stack([slen, prefix, mm,
                      jnp.full_like(slen, acceleration << SKIP_TRIGGER)],
                     axis=1)


@functools.partial(jax.jit, static_argnames=("linked", "reject_step",
                                              "interpret"))
def _scan(meta, val, cand, jump, *, linked, reject_step, interpret):
    B, W = val.shape
    NS = cand.shape[1]
    M = -(-compress_bound(NS) // 128) * 128
    args = [meta, val, cand]
    in_specs = [pl.BlockSpec((B, 4), lambda b: (0, 0)),
                pl.BlockSpec((None, W), lambda b: (b, 0)),
                pl.BlockSpec((None, NS), lambda b: (b, 0))]
    if linked:
        args.append(jump)
        in_specs.append(pl.BlockSpec((None, NS // 4), lambda b: (b, 0)))
    out, olen = triton_call(
        _scan_kernel(NS, linked, reject_step),
        num_warps=NUM_WARPS, interpret=interpret,
        grid=(B,),
        in_specs=in_specs,
        out_specs=(pl.BlockSpec((None, M), lambda b: (b, 0)),
                   pl.BlockSpec((B,), lambda b: (0,))),
        out_shape=(jax.ShapeDtypeStruct((B, M), jnp.uint8),
                   jax.ShapeDtypeStruct((B,), jnp.int32)),
    )(*args)
    return out.astype(jnp.int32), olen


@functools.partial(jax.jit, static_argnames=("acceleration", "interpret",
                                              "min_match", "reject_step"))
def _encode_blocks(val_rows, slen, *, acceleration, interpret, min_match,
                   reject_step):
    B = val_rows.shape[0]
    d_rows = cand_delta_rows(
        val_rows,
        jnp.full((B,), min_match, jnp.int32) if min_match >= 6 else None)
    # barren-jump distances ride the spare high 16 bits (deltas <= 65535);
    # jump = 65535 wraps into the sign bit and the scan recovers it as
    # (w >> 16) & 0xFFFF
    cand = d_rows | (_jump_rows(d_rows) << 16)
    meta = _scan_meta(slen, jnp.zeros((B,), jnp.int32),
                      jnp.full((B,), min_match, jnp.int32), acceleration)
    return _scan(meta, val_rows, cand, None, linked=False,
                 reject_step=reject_step, interpret=interpret)


def encode_blocks(val32_rows: jax.Array, src_lens: jax.Array,
                  acceleration: int = 1, min_match: int = 4,
                  reject_step: int = 1):
    """Compress a batch of independent blocks.

    Args:
      val32_rows: [B, NS] int32, lane p = LE32 word at byte p (see
        ``bytes_to_val32_rows``); NS must be a multiple of 128.
      src_lens: [B] int32 source lengths (each <= NS, < 2^18).
      min_match: shortest match to emit (4 = LZ4 default; larger values
        trade ratio for fewer sequences = faster decode).
      reject_step: scan advance on a rejected short match (min_match
        mode); >1 trades a sliver of ratio for encode speed.

    Returns (out [B, M] int32 bytes, olen [B] int32 compressed lengths),
    with M = 128-aligned compress_bound(NS).
    """
    B, NS = val32_rows.shape
    if NS % 128:
        raise ValueError("NS must be a multiple of 128")
    if NS > MAX_BLOCK:
        raise ValueError(f"block too large for kernel ({NS} > {MAX_BLOCK})")
    return _encode_blocks(val32_rows, src_lens.astype(jnp.int32),
                          acceleration=int(acceleration),
                          interpret=on_cpu(), min_match=int(min_match),
                          reject_step=int(reject_step))


@functools.partial(jax.jit,
                   static_argnames=("acceleration", "interpret", "min_match",
                                    "reject_step"))
def _encode_blocks_linked(val_rows, slen, prefix, mm_rows, *, acceleration,
                          interpret, min_match, reject_step):
    S, NB, W = val_rows.shape
    NS = W - WINDOW
    rows = val_rows.reshape(S * NB, W)
    # candidate deltas over each whole [window | block] row: candidates
    # reach into the previous block / dictionary prefix by construction
    if mm_rows is not None:
        mm = mm_rows.reshape(S * NB).astype(jnp.int32)
        filter_mm = mm
    else:
        mm = jnp.full((S * NB,), min_match, jnp.int32)
        filter_mm = mm if min_match >= 6 else None
    d = cand_delta_rows(rows, filter_mm)[:, WINDOW:]
    # positions past mflimit are never probed (lz4.c:539 parity: matches
    # may not start in the last 12 bytes), and they are the only lanes
    # whose val32 lookahead wrapped at the row edge
    d = jnp.where(jnp.arange(NS)[None, :] < NS - 12, d, 0)
    jump = _next_candidate(d)[:, ::4]
    k = jnp.arange(S * NB) % NB
    first = jnp.repeat(prefix.astype(jnp.int32), NB)
    meta = _scan_meta(slen.reshape(S * NB), jnp.where(k == 0, first, WINDOW),
                      mm, acceleration)
    out, olen = _scan(meta, rows, d, jump, linked=True,
                      reject_step=reject_step, interpret=interpret)
    return out.reshape(S, NB, -1), olen.reshape(S, NB)


def encode_blocks_linked(val32_rows: jax.Array, src_lens: jax.Array,
                         acceleration: int = 1,
                         prefix_lens: jax.Array | None = None,
                         min_match: int = 4, reject_step: int = 1,
                         mm_rows: jax.Array | None = None):
    """Compress streams of linked 64 KB blocks (device streaming mode).

    Block (s, k)'s row holds the previous block as its window, so matches
    reach 64 KB back exactly like ``LZ4_compress_fast_continue`` prefix
    mode (lz4.c:990-1045).  A stream may start with a pre-existing 64 KB
    dictionary prefix (prefix_lens[s] > 0): block 0's window lanes hold
    it and candidates pointing into it come straight from the sorted pass
    (the LZ4_loadDict table seeding of lz4.c:944-948 has no analog to
    run).  This is what lets ONE huge linked frame be encoded
    data-parallel with full window ratio and no communication: each
    shard's prefix is the preceding 64 KB of input.

    Args:
      val32_rows: [S, NB, 65536 + NS] int32 val32 lanes; row (s, k) covers
        stream s's bytes [(k-1)*64K, (k+1)*64K) (zeros pad the front of
        k=0 and the tail of the final partial block).  NS = 65536.
      src_lens: [S, NB] int32 block lengths (all 65536 except the last
        nonzero block per stream; zero rows are padding).
      prefix_lens: optional [S] int32 dictionary-prefix length for each
        stream's first block (0 or 65536; the prefix bytes live in row
        (s, 0)'s leading window lanes).
      min_match / reject_step: see ``encode_blocks``.
      mm_rows: optional [S, NB] int32 per-block min_match (adaptive
        mode); overrides ``min_match`` when given.

    Returns (out [S, NB, M] int32 bytes, olen [S, NB]).
    """
    S, NB, W = val32_rows.shape
    if W - WINDOW != WINDOW:
        raise ValueError("linked kernel uses 64KB blocks")
    if prefix_lens is None:
        prefix_lens = jnp.zeros((S,), jnp.int32)
    return _encode_blocks_linked(val32_rows, src_lens.astype(jnp.int32),
                                 prefix_lens, mm_rows,
                                 acceleration=int(acceleration),
                                 interpret=on_cpu(),
                                 min_match=int(min_match),
                                 reject_step=int(reject_step))
