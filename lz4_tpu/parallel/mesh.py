"""Device-mesh data parallelism for the block codec.

The parallelism model (SURVEY 2.5): frames and independent blocks are
embarrassingly parallel with variable-length outputs.  Batches of blocks
are sharded over a 1-D mesh with ``shard_map``; each device runs the
kernels on its shard; compressed lengths travel with the rows so the
host (or an all_gather) can assemble frames in order.  Dictionaries are
replicated.  The cards of one host reach each other all to all, so the
mesh is 1-D and follows the data alone.

The reference has no distribution layer at all (its multi-core story is
8 independent processes, README.md:39-45); this module is the device
replacement.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels.decode_kernel import decode_blocks
from ..kernels.encode_kernel import bytes_to_val32_rows, \
    encode_blocks, encode_blocks_linked

AXIS = "blocks"


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (AXIS,))


def pad_batch(n_rows: int, mesh: Mesh) -> int:
    """Rows must divide evenly over the mesh; callers pad with empty rows."""
    per = mesh.shape[AXIS]
    return -(-n_rows // per) * per


def encode_blocks_sharded(mesh: Mesh, val_rows: jax.Array, lens: jax.Array,
                          acceleration: int = 1):
    """Shard-mapped batch encode: rows split over the mesh axis.

    val_rows [B, NS] (B divisible by mesh size), lens [B].
    Returns (comp_rows [B, M], comp_lens [B]) with the same sharding.
    """
    fn = functools.partial(encode_blocks, acceleration=acceleration)
    mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS)),
        out_specs=(P(AXIS, None), P(AXIS)),
        check_vma=False,
    )
    return mapped(val_rows, lens)


def decode_blocks_sharded(mesh: Mesh, comp_rows: jax.Array, lens: jax.Array,
                          out_cap: int,
                          dict_rows: Optional[jax.Array] = None,
                          dict_lens: Optional[jax.Array] = None):
    """Shard-mapped batch decode (dictionaries sharded with their rows)."""
    if dict_rows is None:
        fn = functools.partial(decode_blocks, out_cap=out_cap)
        mapped = jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS)),
            out_specs=(P(AXIS, None), P(AXIS)),
            check_vma=False,
        )
        return mapped(comp_rows, lens)
    fn = functools.partial(decode_blocks, out_cap=out_cap)
    mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS), P(AXIS, None), P(AXIS)),
        out_specs=(P(AXIS, None), P(AXIS)),
        check_vma=False,
    )
    return mapped(comp_rows, lens, dict_rows, dict_lens)


def roundtrip_step(mesh: Mesh, packed_words: jax.Array, lens: jax.Array,
                   block_bytes: int, acceleration: int = 1):
    """One full data-parallel codec step: unpack -> encode -> decode.

    This is the framework's "training step" analog: the whole pipeline
    jitted over the mesh.  Returns (comp_lens, decoded_lens, ok) where ok
    is a replicated scalar (psum of mismatches == 0).
    """
    def step(words, ln):
        val = bytes_to_val32_rows(words, block_bytes)
        comp, clen = encode_blocks(val, ln, acceleration)
        out, olen = decode_blocks(comp, clen, block_bytes)
        bad = jnp.sum(jnp.where(olen == ln, 0, 1))
        bad = jax.lax.psum(bad, AXIS)
        return clen, olen, bad

    mapped = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P()),
        check_vma=False,
    )
    return mapped(packed_words, lens)


def shard_rows(mesh: Mesh, arr: jax.Array) -> jax.Array:
    """Place a [B, ...] array row-sharded over the mesh."""
    ndim = arr.ndim
    spec = P(AXIS, *([None] * (ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


# ---------------------------------------------------------------------------
# one huge linked frame, data-parallel over the mesh (SURVEY 2.5 / 5)
# ---------------------------------------------------------------------------

def encode_linked_sharded(mesh: Mesh, val_rows: jax.Array, lens: jax.Array,
                          prefix: jax.Array, acceleration: int = 1,
                          min_match: int = 4):
    """Shard-mapped streaming encode: stream (shard) axis over the mesh.

    val_rows [S, NB, 131072] val32 lanes, lens [S, NB], prefix [S].
    """
    fn = functools.partial(encode_blocks_linked, acceleration=acceleration,
                           min_match=min_match)
    mapped = jax.shard_map(
        lambda v, ln, pf: fn(v, ln, prefix_lens=pf),
        mesh=mesh,
        in_specs=(P(AXIS, None, None), P(AXIS, None), P(AXIS)),
        out_specs=(P(AXIS, None, None), P(AXIS, None)),
        check_vma=False,
    )
    return mapped(val_rows, lens, prefix)


# ---------------------------------------------------------------------------
# scatter-gather lists over the mesh -- the device analog of the
# reference's multi-core SG story (8 independent OS processes,
# README.md:39-45): L independent frames, one chain decode per frame,
# frames sharded over the mesh axis.
# ---------------------------------------------------------------------------

def sg_decompress_mesh(mesh: Mesh, comp_lists, out_caps):
    """Decompress many independent SG frames data-parallel over the mesh.

    ``comp_lists`` is a list of compressed iovec lists; ``out_caps`` the
    original buffer sizes (the SG contract: decompress buffers must
    equal the compression input sizes, lz4sg.h:96-100) — one shared cap
    list, or a per-frame list of cap lists for RAGGED frames.  Each
    frame's iovec walk runs on host (header/zero-pad bookkeeping, exact
    errors); the block chains execute on device, sharded over the mesh
    and BUCKETED by chain layout, so heterogeneous frames still run the
    device path (host fallback remains only for blocks beyond the
    kernel envelope, and is counted in ``tpu.HOST_FALLBACKS``).

    Returns a list of (total, out_bufs) per frame.
    """
    from .. import sg as sg_mod
    from ..kernels.decode_kernel import decode_blocks_sg
    from ..tpu import fetch_byte_rows, note_host_fallback

    if not comp_lists:
        return []
    if out_caps and isinstance(out_caps[0], (list, tuple)):
        caps_per = [list(map(int, c)) for c in out_caps]
        if len(caps_per) != len(comp_lists):
            raise ValueError("per-frame out_caps must match comp_lists")
    else:
        caps_per = [list(map(int, out_caps))] * len(comp_lists)

    # host walk of each frame with a stand-in codec that reads block
    # sizes from the token streams, to extract its block chain
    chains, totals = [], []
    for bufs, caps in zip(comp_lists, caps_per):
        collected = []
        try:
            total, _ = sg_mod.sg_decompress(
                bufs, caps,
                block_decompress=sg_mod._size_stand_in(collected))
        except sg_mod._SgDeviceUnsupported:
            collected, total = [], None      # host decode below
        chains.append(collected)
        totals.append(total)

    # RAGGED chains: bucket frames by their chain layout --
    # each distinct layout gets its own mesh-parallel device pass (one
    # compiled kernel per layout; no host fallback for any bucket whose
    # blocks fit the kernel envelope)
    results: list = [None] * len(comp_lists)
    buckets: dict = {}
    for i, ch in enumerate(chains):
        sizes = tuple(sz for _, sz in ch)
        if sizes and max(sizes) <= 65536:
            buckets.setdefault(sizes, []).append(i)
    for sizes_key, group in buckets.items():
        sizes0 = list(sizes_key)
        B = len(sizes0)
        M = max(len(c) for i in group for c, _ in chains[i])
        M = -(-M // 128) * 128
        D = mesh.shape[AXIS]
        L = len(group)
        Lp = -(-L // D) * D
        comp = np.zeros((Lp, B, M), np.int32)
        clen = np.zeros((Lp, B), np.int32)
        for k, i in enumerate(group):
            for j, (c, _) in enumerate(chains[i]):
                comp[k, j, :len(c)] = np.frombuffer(c, np.uint8)
                clen[k, j] = len(c)
        comp[L:] = comp[0]
        clen[L:] = clen[0]

        def body(c, ln, _sizes=sizes0):
            return jax.lax.map(
                lambda args: decode_blocks_sg(args[0], args[1], _sizes),
                (c, ln))

        mapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(AXIS, None, None), P(AXIS, None)),
            out_specs=(P(AXIS, None, None), P(AXIS, None)),
            check_vma=False,
        )
        out, olen = mapped(shard_rows(mesh, jnp.asarray(comp)),
                           shard_rows(mesh, jnp.asarray(clen)))
        olen = np.asarray(olen)
        tot0 = sum(sizes0)
        for k, i in enumerate(group):
            if (olen[k, :B] == np.asarray(sizes0)).all():
                flat = fetch_byte_rows(out[k]).reshape(-1)
                content = bytes(flat[65536:65536 + tot0])
                outs, pos = [], 0
                for c in caps_per[i]:
                    outs.append(content[pos:pos + c])
                    pos += c
                results[i] = (totals[i], outs)

    for i, bufs in enumerate(comp_lists):
        if results[i] is None:   # >64KB blocks or kernel mismatch
            note_host_fallback("SG frame outside the mesh decode envelope")
            results[i] = sg_mod.sg_decompress(bufs, caps_per[i])
    return results


def compress_frame_mesh(mesh: Mesh, data: bytes,
                        content_checksum: bool = True,
                        acceleration: int = 1,
                        min_match: int = 4) -> bytes:
    """Compress ONE blob into ONE linked LZ4F frame, data-parallel.

    The 64 KB window a shard's first block needs is just the preceding
    64 KB of *input*, so the host replicates it into the shard's rows and
    the scan matches into it (LZ4_loadDict parity) -- full linked-window
    ratio with zero inter-device communication.  Compressed
    lengths come back with the rows (the all-gather is the shard_map
    output resharding) and the host concatenates payloads in frame order.
    """
    from ..frame import FramePreferences
    from ..tpu import assemble_linked_frame, linked_val_rows

    BS = 65536
    data = bytes(data)
    if len(data) >= (1 << 31) - (1 << 17):
        raise ValueError("stream exceeds the linked kernel's 2GB int32 "
                         "position envelope (reference renormalizes at "
                         "2GB, lz4.c:954-973); split into multiple frames")
    D = mesh.shape[AXIS]
    nb_total = max(1, -(-len(data) // BS))
    NB = -(-nb_total // D)
    S = D
    val, lens = linked_val_rows(data, S, NB)
    prefix = np.zeros((S,), np.int32)
    for s in range(1, S):
        if lens[s, 0] > 0:
            prefix[s] = BS
    val = shard_rows(mesh, val)
    out, olen = encode_linked_sharded(mesh, val, jnp.asarray(lens),
                                      jnp.asarray(prefix), acceleration,
                                      min_match)
    from ..tpu import fetch_byte_rows
    outb = fetch_byte_rows(out.reshape(S * NB, out.shape[-1]))
    olen = np.asarray(olen)

    prefs = FramePreferences(block_size_id=4, block_independent=False,
                             content_checksum=content_checksum,
                             content_size=len(data))
    flat_olen = olen.reshape(-1)
    payloads = [outb[g, :flat_olen[g]].tobytes() for g in range(nb_total)]
    return assemble_linked_frame(data, prefs, payloads,
                                 [int(x) for x in lens.reshape(-1)[:nb_total]])
