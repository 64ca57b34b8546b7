"""Worker for the 2-process multi-host test (run by test_multihost.py).

Usage: python multihost_worker.py <coordinator> <num_procs> <proc_id> <dir>

Each process: joins the distributed runtime, builds the global mesh over
2x4 virtual CPU devices, contributes its local shard of a shared corpus,
compresses through the shard-mapped kernel with a length all-gather, and
writes its frame segment + the (replicated) length vector to <dir>.
Process 0 additionally writes the frame header/trailer so the test can
splice segments into one decodable frame.
"""

import os
import sys
import time

# a CPU test: the platform is forced so that two worker processes never
# open the same GPU (a JAX process reserves most of a card's memory)
flags = os.environ.get("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=4"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    coord, nproc, pid, outdir = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    from lz4_tpu.parallel import multihost as mh

    mh.initialize(coordinator_address=coord, num_processes=nproc,
                  process_id=pid)
    import numpy as np
    assert jax.process_count() == nproc
    assert len(jax.devices()) == nproc * 4, len(jax.devices())

    mesh = mh.global_mesh()

    from lz4_tpu.utils.datagen import gen_buffer
    BS = 4096                      # tiny blocks: CPU-interpret kernels
    data = gen_buffer(BS * 16, 0.7, 1234)   # 16 blocks over 8 devices
    blocks = [data[i:i + BS] for i in range(0, len(data), BS)]
    B = len(blocks)
    lo, hi = mh.process_block_range(B)

    # local rows: packed LE words of this process's slice
    from lz4_tpu.kernels.common import np_pack_rows
    packed, lens = np_pack_rows(blocks[lo:hi], BS)
    words = mh.global_blocks(mesh, packed)
    lens_g = jax.make_array_from_process_local_data(
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("blocks")),
        lens)

    t0 = time.perf_counter()
    comp, all_len = mh.encode_blocks_multihost(mesh, words, lens_g, BS)
    wall = time.perf_counter() - t0

    seg = mh.frame_segment(comp, all_len, [BS] * B, lo, hi)
    with open(os.path.join(outdir, f"seg{pid}.bin"), "wb") as f:
        f.write(seg)
    np.save(os.path.join(outdir, f"lens{pid}.npy"), all_len)

    if pid == 0:
        from lz4_tpu.frame import FramePreferences, encode_frame_header
        import struct
        from lz4_tpu.ops.xxhash_np import xxh32
        prefs = FramePreferences(block_size_id=4, block_independent=True,
                                 content_checksum=True)
        with open(os.path.join(outdir, "head.bin"), "wb") as f:
            f.write(encode_frame_header(prefs))
        with open(os.path.join(outdir, "tail.bin"), "wb") as f:
            f.write(struct.pack("<I", 0) + struct.pack("<I", xxh32(data, 0)))
        with open(os.path.join(outdir, "plain.bin"), "wb") as f:
            f.write(data)
    # ---- decode direction: the same frame's
    # blocks, row-sharded over both processes' devices, decoded through
    # the shard-mapped kernel with an olen all-gather; each process
    # writes its decoded segment for the test to splice
    from lz4_tpu.ops.block_np import compress_block
    comp_blocks = [compress_block(b) for b in blocks]
    M = max(len(c) for c in comp_blocks)
    M = -(-M // 128) * 128
    rows_local = np.zeros((hi - lo, M), np.int32)
    clens_local = np.zeros((hi - lo,), np.int32)
    for j, c in enumerate(comp_blocks[lo:hi]):
        rows_local[j, :len(c)] = np.frombuffer(c, np.uint8)
        clens_local[j] = len(c)
    comp_g = mh.global_blocks(mesh, rows_local)
    clens_g = jax.make_array_from_process_local_data(
        jax.sharding.NamedSharding(mesh,
                                   jax.sharding.PartitionSpec("blocks")),
        clens_local)
    out_g, all_olen = mh.decode_blocks_multihost(mesh, comp_g, clens_g, BS)
    assert (all_olen == [len(b) for b in blocks]).all(), all_olen
    dec = mh.decoded_segment(out_g, all_olen, lo, hi)
    with open(os.path.join(outdir, f"dec{pid}.bin"), "wb") as f:
        f.write(dec)

    with open(os.path.join(outdir, f"done{pid}"), "w") as f:
        f.write(f"{wall:.4f}")
    print(f"proc {pid}: blocks [{lo},{hi}) seg {len(seg)}B "
          f"dec {len(dec)}B wall {wall:.3f}s")


if __name__ == "__main__":
    main()
