"""tpu-lz4: an LZ4 codec framework in JAX, with GPU kernels.

Capability map to the reference (`infidob/lz4`, r132 + LZ4_SG fork):

* ``lz4_tpu.block``   -- block codec (reference lib/lz4.c, lib/lz4.h)
* ``lz4_tpu.hc``      -- high-compression codec (reference lib/lz4hc.c)
* ``lz4_tpu.frame``   -- LZ4F frame layer (reference lib/lz4frame.c)
* ``lz4_tpu.sg``      -- scatter-gather layer (reference lib/lz4sg.c)
* ``lz4_tpu.stream``  -- streaming dictionaries (reference lz4.c:920-1085)
* ``lz4_tpu.ops``     -- host oracles (numpy/pure-python reference semantics)
* ``lz4_tpu.kernels`` -- GPU kernels (Pallas through Triton) and their
  XLA index and pack steps
* ``lz4_tpu.tpu``     -- the device frame pipeline
* ``lz4_tpu.parallel``-- device-mesh sharding of blocks/frames
* ``lz4_tpu.utils``   -- datagen, CLI helpers
"""

__version__ = "0.1.0"

from . import spec  # noqa: F401
