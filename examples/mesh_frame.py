"""One huge linked LZ4F frame, compressed data-parallel over a device mesh.

The reference's multi-core story is N independent OS processes on N
separate files (README.md:39-45). Here ONE stream's 64KB blocks are
sharded over the mesh: each shard's first block carries the preceding
64KB of input as a dictionary prefix (LZ4_loadDict parity), so the
assembled frame has full linked-window ratio with zero inter-device
communication, and any LZ4F decoder reads it.

Run on CPU with a virtual mesh:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/mesh_frame.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lz4_tpu.frame import decompress_frame  # noqa: E402
from lz4_tpu.parallel.mesh import compress_frame_mesh, default_mesh  # noqa: E402
from lz4_tpu.utils.datagen import gen_buffer  # noqa: E402


def main():
    mesh = default_mesh()
    n_dev = mesh.devices.size
    data = b"".join(gen_buffer(50_000, 0.7, seed=i) for i in range(12))
    frame = compress_frame_mesh(mesh, data)
    out, used = decompress_frame(frame)
    assert out == data and used == len(frame)
    print(f"{len(data)} bytes -> {len(frame)} bytes "
          f"({len(frame) / len(data):.1%}) as ONE linked frame "
          f"across {n_dev} device(s); host decoder verified the bytes")


if __name__ == "__main__":
    main()
