"""The scan kernel's output is byte-identical to the encoder it replaced.

``fixtures/encode_digests.json`` holds the sha256 of the compressed block
payloads (and of whole frames) that the previous encoder produced for the
same inputs and knobs, so every recorded ratio still holds.  Inputs:
``golden_input.bin`` and datagen ``gen_buffer(150_000, p, seed)``.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

from lz4_tpu.frame import FramePreferences, decompress_frame
from lz4_tpu.kernels.common import np_pack_rows
from lz4_tpu.kernels.encode_kernel import bytes_to_val32_rows, \
    encode_blocks, encode_blocks_linked
from lz4_tpu.tpu import DeviceFrameCompressor, compress_frame_device, \
    linked_val_rows
from lz4_tpu.utils.datagen import gen_buffer

FIX = Path(__file__).parent / "fixtures"
CASES = json.loads((FIX / "encode_digests.json").read_text())["cases"]
BLOCK_CASES = sorted(k for k in CASES if "frame" not in k)
FRAME_CASES = sorted(k for k in CASES if "frame" in k)


def corpus(name: str) -> bytes:
    if name == "golden":
        return (FIX / "golden_input.bin").read_bytes()
    seed = {"datagen_p05": 0x505, "datagen_p09": 0x909}[name]
    return gen_buffer(150_000, 0.5 if name == "datagen_p05" else 0.9, seed)


def encode_payloads(data, linked, min_match=4, acceleration=1,
                    reject_step=1, mm_rows=None):
    """(block lengths, concatenated payload bytes) from the scan kernel."""
    if linked:
        nb = -(-len(data) // 65536)
        val, lens = linked_val_rows(data, 1, nb)
        mm = None if mm_rows is None else \
            jnp.asarray(np.asarray([mm_rows], np.int32))
        out, olen = encode_blocks_linked(
            val, jnp.asarray(lens), acceleration, min_match=min_match,
            reject_step=reject_step, mm_rows=mm)
        out, olen = np.asarray(out[0]), np.asarray(olen[0])
    else:
        blocks = [data[i:i + 65536] for i in range(0, len(data), 65536)]
        packed, lens = np_pack_rows(blocks, 65536)
        val = bytes_to_val32_rows(jnp.asarray(packed), 65536)
        out, olen = encode_blocks(val, jnp.asarray(lens), acceleration,
                                  min_match=min_match,
                                  reject_step=reject_step)
        out, olen = np.asarray(out), np.asarray(olen)
    payload = b"".join(out[i, :olen[i]].astype(np.uint8).tobytes()
                       for i in range(len(olen)))
    return [int(x) for x in olen], payload


def knobs(case: str) -> dict:
    """'golden/linked/mm8/reject3' -> encode_payloads keyword arguments."""
    _, mode, mm, *rest = case.split("/")
    kw = {"linked": mode == "linked"}
    if mm.startswith("mm_rows"):
        kw["mm_rows"] = [int(x) for x in mm[len("mm_rows"):].split(",")]
    else:
        kw["min_match"] = int(mm[2:])
    for r in rest:
        if r.startswith("accel"):
            kw["acceleration"] = int(r[5:])
        if r.startswith("reject"):
            kw["reject_step"] = int(r[6:])
    return kw


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_scan_matches_recorded_digest(case):
    lens, payload = encode_payloads(corpus(case.split("/")[0]),
                                    **knobs(case))
    assert lens == CASES[case]["lens"]
    assert hashlib.sha256(payload).hexdigest() == CASES[case]["sha256"]


def frame_for(case: str) -> bytes:
    data = corpus(case.split("/")[0])
    if case.endswith("chunked_frame"):
        comp = DeviceFrameCompressor(FramePreferences(content_checksum=True))
        parts = [comp.begin()]
        parts += [comp.update(data[i:i + 65536])
                  for i in range(0, len(data), 65536)]
        return b"".join(parts + [comp.end()])
    prefs = FramePreferences(
        block_independent=case.endswith("independent"),
        content_checksum=True)
    return compress_frame_device(data, prefs)


@pytest.mark.parametrize("case", FRAME_CASES)
def test_frame_matches_recorded_digest(case):
    frame = frame_for(case)
    assert len(frame) == CASES[case]["len"]
    assert hashlib.sha256(frame).hexdigest() == CASES[case]["sha256"]
    assert decompress_frame(frame)[0] == corpus(case.split("/")[0])


def test_stdlib_frame_matches_recorded_frame():
    """The first MiB of the benchmark's Python-stdlib corpus, as a linked
    64 KB frame with a content checksum (the LZ4F default), byte for byte
    as the previous encoder wrote it."""
    want = (FIX / "stdlib_1mib_linked.lz4").read_bytes()
    data, _ = decompress_frame(want)
    got = compress_frame_device(
        data, FramePreferences(block_independent=False,
                               content_checksum=True))
    assert got == want
