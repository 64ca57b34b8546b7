"""Multi-host distribution: the codec over (hosts x cards).

The reference's only multi-core story is 8 independent OS processes
(reference README.md:39-45); the device replacement is the JAX
multi-process runtime: every host calls :func:`initialize`, builds ONE
global mesh over all devices, feeds its *local* shard of the work, and
the only cross-host traffic is (a) GSPMD's dictionary replication and
(b) an all-gather of per-shard compressed lengths so every host knows the
frame offsets of every block (compressed sizes are data-dependent, so
ordered assembly needs them — SURVEY 5 "distributed backend").  Payload
bytes never cross hosts: each host writes its own frame segment, exactly
like the per-shard files of a real ingestion pipeline.

Runs one process per GPU host (a process drives all the cards of its
host; a second JAX process on a card would find its memory reserved)
and, for CI, N processes x M CPU devices (``JAX_PLATFORMS=cpu`` +
``--xla_force_host_platform_device_count``): tests/test_multihost.py
drives 2 processes x 4 devices on localhost.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import AXIS
from ..kernels.encode_kernel import bytes_to_val32_rows, encode_blocks

__all__ = [
    "initialize", "global_mesh", "global_blocks",
    "encode_blocks_multihost", "decode_blocks_multihost",
    "decoded_segment", "frame_segment", "process_block_range",
]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the JAX distributed runtime (jax.distributed.initialize).

    Run one process per host, each driving that host's cards.  Nothing
    in the environment describes the cluster, so the coordinator address
    (``host:port`` of process 0), the process count and this process's
    id are passed explicitly.  Must run before the first JAX operation of
    the process.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh() -> Mesh:
    """1-D mesh over ALL devices of ALL processes (NVLink within a host,
    the network across hosts; XLA routes collectives accordingly)."""
    return Mesh(np.asarray(jax.devices()), (AXIS,))


def process_block_range(n_blocks: int) -> Tuple[int, int]:
    """The contiguous [lo, hi) slice of a length-n_blocks batch this
    process is responsible for (row-sharded over the global mesh)."""
    pc, pid = jax.process_count(), jax.process_index()
    per = -(-n_blocks // pc)
    lo = min(pid * per, n_blocks)
    return lo, min(lo + per, n_blocks)


def global_blocks(mesh: Mesh, local_rows: np.ndarray) -> jax.Array:
    """Build a process-spanning [B_global, W] array from this process's
    local rows (every process contributes its contiguous slice)."""
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(AXIS, None)), local_rows)


def encode_blocks_multihost(mesh: Mesh, words_global: jax.Array,
                            lens_global: jax.Array, block_bytes: int,
                            acceleration: int = 1, min_match: int = 4):
    """Compress a globally-sharded batch; lengths are all-gathered so every
    process holds the full [B_global] length vector (frame offsets), while
    compressed rows stay process-local.

    Returns (comp_rows global array [B, M], lengths np [B] replicated).
    """
    def step(words, ln):
        val = bytes_to_val32_rows(words, block_bytes)
        comp, clen = encode_blocks(val, ln, acceleration,
                                   min_match=min_match)
        all_len = jax.lax.all_gather(clen, AXIS, tiled=True)
        return comp, all_len

    mapped = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS)),
        out_specs=(P(AXIS, None), P()),
        check_vma=False,
    )
    comp, all_len = mapped(words_global, lens_global)
    # the replicated output's addressable shard holds the full vector
    return comp, np.asarray(all_len.addressable_shards[0].data)


def decode_blocks_multihost(mesh: Mesh, comp_global: jax.Array,
                            clens_global: jax.Array, out_cap: int):
    """Decompress a globally-sharded batch of independent blocks (one
    frame's blocks row-sharded over all processes' devices).  Decoded
    lengths are all-gathered (every process knows every block's size for
    ordered reassembly); decoded rows stay process-local.

    Returns (out_rows global array [B, out_cap], olen np [B] replicated).
    """
    from ..kernels.decode_kernel import decode_blocks

    def step(comp, ln):
        out, olen = decode_blocks(comp, ln, out_cap)
        all_olen = jax.lax.all_gather(olen, AXIS, tiled=True)
        return out, all_olen

    mapped = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS)),
        out_specs=(P(AXIS, None), P()),
        check_vma=False,
    )
    out, all_olen = mapped(comp_global, clens_global)
    return out, np.asarray(all_olen.addressable_shards[0].data)


def decoded_segment(out_global: jax.Array, olen_np: np.ndarray,
                    lo: int, hi: int) -> bytes:
    """This process's decoded bytes for blocks [lo, hi), in order (its
    segment of the reassembled content)."""
    from ..tpu import fetch_byte_rows

    shards = sorted(out_global.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    parts: List[bytes] = []
    for sh in shards:
        start = sh.index[0].start or 0
        rows = None
        for j in range(sh.data.shape[0]):
            g = start + j
            if g < lo or g >= hi or int(olen_np[g]) <= 0:
                continue
            if rows is None:
                cap4 = sh.data.shape[1] - sh.data.shape[1] % 4
                rows = fetch_byte_rows(sh.data[:, :cap4])
            parts.append(rows[j, :olen_np[g]].tobytes())
    return b"".join(parts)


def frame_segment(comp_global: jax.Array, lens_np: np.ndarray,
                  block_lens: Sequence[int], lo: int, hi: int) -> bytes:
    """Serialize this process's blocks [lo, hi) as frame bytes (block
    headers + payloads, stored fallback) — its segment of the one global
    block-independent frame.  Only locally-addressable rows are touched.
    """
    import struct
    from .. import spec
    from ..tpu import fetch_byte_rows

    shards = sorted(comp_global.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    parts: List[bytes] = []
    for sh in shards:
        start = sh.index[0].start or 0
        rows = None
        for j in range(sh.data.shape[0]):
            g = start + j
            if g < lo or g >= hi or int(block_lens[g]) == 0:
                continue
            if rows is None:
                rows = fetch_byte_rows(sh.data)
            clen = int(lens_np[g])
            payload = rows[j, :clen].tobytes()
            if clen >= int(block_lens[g]):
                raise ValueError("stored-block fallback needs plaintext; "
                                 "caller handles incompressible rows")
            parts.append(struct.pack("<I", clen) + payload)
    return b"".join(parts)
