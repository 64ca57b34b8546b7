"""Chunked (streaming) device compression: bounded host memory for any
file size.

The reference CLI works in 4MB reads (lz4io.c:497-542); the device
analog is DeviceFrameCompressor: every chunk's blocks compress on device
as one linked chain, and the 64KB window carries across chunks as the
linked scan's dictionary prefix (LZ4_loadDict parity, lz4.c:944-948), so
the output matches whole-buffer compression.
"""
import io
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lz4_tpu.frame import FramePreferences, decompress_frame
from lz4_tpu.tpu import DeviceFrameCompressor, compress_frame_device
from lz4_tpu.utils.datagen import gen_buffer


def main():
    data = gen_buffer(700_000, 0.8, 2024)

    comp = DeviceFrameCompressor(
        FramePreferences(block_independent=False))
    parts = [comp.begin()]
    src = io.BytesIO(data)
    while True:
        chunk = src.read(150_000)       # any chunking works
        if not chunk:
            break
        parts.append(comp.update(chunk))
    parts.append(comp.end())
    frame = b"".join(parts)

    content, _ = decompress_frame(frame)
    assert content == data

    whole = compress_frame_device(
        data, FramePreferences(block_independent=False))
    print(f"chunked: {len(frame)} bytes, whole-buffer: {len(whole)} bytes "
          f"(window carry keeps them within "
          f"{abs(len(frame) - len(whole))} bytes)")
    assert abs(len(frame) - len(whole)) < len(whole) // 100


if __name__ == "__main__":
    main()
