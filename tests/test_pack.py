"""The XLA frame pack writes exactly the bytes the host assembly writes:
LE32 block headers, payloads, the stored-block rule (lz4frame.c:518-524)
and padding rows that contribute nothing."""

import struct

import numpy as np
import jax.numpy as jnp
import pytest

from lz4_tpu import spec
from lz4_tpu.kernels.common import np_pack_rows
from lz4_tpu.kernels.encode_kernel import bytes_to_val32_rows, encode_blocks
from lz4_tpu.kernels.pack import pack_frame_payloads
from lz4_tpu.tpu import fetch_packed
from lz4_tpu.utils.datagen import gen_buffer, incompressible

BS = 4096


def host_body(blocks, comp, clen):
    parts = []
    for i, blk in enumerate(blocks):
        if not blk:
            continue
        if clen[i] >= len(blk):
            parts += [struct.pack("<I", len(blk) | spec.UNCOMPRESSED_BIT),
                      blk]
        else:
            parts += [struct.pack("<I", int(clen[i])),
                      comp[i, :clen[i]].astype(np.uint8).tobytes()]
    return b"".join(parts)


CASES = {
    "compressible": [gen_buffer(BS, 0.8, i) for i in range(4)],
    "stored": [incompressible(BS, 3), incompressible(1000, 4)],
    "mixed": [gen_buffer(BS, 0.7, 5), incompressible(BS, 6),
              gen_buffer(3000, 0.9, 7), b"x" * 20],
    "padding_rows": [gen_buffer(BS, 0.7, 8), b"", gen_buffer(2000, 0.6, 9),
                     b""],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_matches_host_assembly(case):
    blocks = CASES[case]
    packed, lens = np_pack_rows(blocks, BS)
    val = bytes_to_val32_rows(jnp.asarray(packed), BS)
    comp, clen = encode_blocks(val, jnp.asarray(lens))
    flat, total = pack_frame_payloads(comp, clen, val, lens)
    want = host_body(blocks, np.asarray(comp), np.asarray(clen))
    assert int(total) == len(want)
    assert fetch_packed(flat, total) == want
    # bytes past the packed body are zero
    assert not np.asarray(flat)[len(want):].any()
