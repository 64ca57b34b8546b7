"""Device pipeline: batch-compress blocks on the device, shard over a mesh.

Runs on the GPU when present, otherwise on a virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu).
"""

import numpy as np
import jax
import jax.numpy as jnp

from lz4_tpu.kernels.common import np_pack_rows
from lz4_tpu.parallel.mesh import default_mesh, roundtrip_step, shard_rows
from lz4_tpu.utils.datagen import gen_buffer


def main():
    mesh = default_mesh()
    n_dev = mesh.shape["blocks"]
    block_bytes = 4096
    B = n_dev * 4
    bufs = [gen_buffer(block_bytes, 0.7, i) for i in range(B)]
    packed, lens = np_pack_rows(bufs, block_bytes)
    pw = shard_rows(mesh, jnp.asarray(packed))
    ln = shard_rows(mesh, jnp.asarray(lens))
    step = jax.jit(lambda w, l: roundtrip_step(mesh, w, l, block_bytes))
    clen, olen, bad = step(pw, ln)
    assert int(np.asarray(bad)) == 0
    total_in = int(np.asarray(lens).sum())
    total_comp = int(np.asarray(clen).sum())
    print(f"{n_dev}-device mesh: {B} blocks, {total_in} -> {total_comp} "
          f"bytes, all round-tripped on device")


if __name__ == "__main__":
    main()
