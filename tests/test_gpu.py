"""The kernels compiled for the card (not interpreted) agree with the host
codec and with the recorded encoder output.  These need an NVIDIA GPU:
elsewhere they skip; on the card run ``python -m pytest -m gpu tests/``."""

import hashlib

import pytest

from lz4_tpu.frame import FramePreferences, decompress_frame

from .test_decode_modes import MODES
from .test_encode_digests import BLOCK_CASES, CASES, FRAME_CASES, \
    corpus, encode_payloads, frame_for, knobs

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("mode", sorted(MODES))
def test_gpu_decode_mode_matches_host_codec(gpu, mode):
    got, want = MODES[mode]()
    assert got == want


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_gpu_scan_matches_recorded_digest(gpu, case):
    lens, payload = encode_payloads(corpus(case.split("/")[0]),
                                    **knobs(case))
    assert lens == CASES[case]["lens"]
    assert hashlib.sha256(payload).hexdigest() == CASES[case]["sha256"]


@pytest.mark.parametrize("case", FRAME_CASES)
def test_gpu_frame_matches_recorded_digest(gpu, case):
    frame = frame_for(case)
    assert hashlib.sha256(frame).hexdigest() == CASES[case]["sha256"]


def test_gpu_frame_roundtrip_4mib(gpu):
    from lz4_tpu.tpu import compress_frame_device, decompress_frame_device
    from lz4_tpu.utils.datagen import gen_buffer
    data = gen_buffer(4 << 20, 0.7, 23)
    for independent in (False, True):
        frame = compress_frame_device(data, FramePreferences(
            block_independent=independent, content_checksum=True))
        assert decompress_frame_device(frame)[0] == data
        assert decompress_frame(frame)[0] == data
