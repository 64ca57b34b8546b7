"""Adversarial decode inputs vs the kernel: verdict parity with the host.

Runs compiled on the GPU, interpreted on CPU CI; the same property holds in
both: for every malformed/malicious stream the kernel must agree with the
host oracle byte-for-byte on acceptance, output, and rejection (the
reference's fuzzer.c:400-529 guarantee class).
"""

import os
import random

import numpy as np
import jax.numpy as jnp
import pytest

from lz4_tpu.kernels.decode_kernel import decode_blocks, decode_blocks_linked
from lz4_tpu.ops.block_np import (Lz4BlockError, compress_block,
                                  decompress_block)
from lz4_tpu.utils.datagen import gen_buffer

CAP = 8192


def _cases(seed):
    rng = random.Random(seed)
    cases = []
    for i in range(24):
        data = gen_buffer(rng.randint(1, CAP), rng.uniform(0.3, 0.99),
                          seed * 100 + i)
        comp = bytearray(compress_block(data))
        kind = i % 4
        if kind == 0 and len(comp) > 4:
            comp = comp[:rng.randint(1, len(comp) - 1)]   # truncation
        elif kind == 1:
            comp[rng.randrange(len(comp))] ^= 1 << rng.randrange(8)
        elif kind == 2:  # literal-length bomb prefix
            comp = (bytearray([0xF0]) + bytearray([255] * rng.randint(1, 30))
                    + comp)
        else:            # wild-offset prefix
            comp = bytearray([0x12, 0xAA, 0xFF, 0xFF]) + comp
        cases.append(bytes(comp))
    cases.append(bytes([0xF0, 255, 255, 255, 255, 10]) + b"A" * 4)
    cases.append(bytes([0x10, 65, 0, 0, 0]))  # offset 0
    return cases


# soak knob: LZ4TPU_FUZZ_SEEDS=100 widens the seed sweep (CI default 4)
SEEDS = range(1, 1 + int(os.environ.get("LZ4TPU_FUZZ_SEEDS", "4")))


@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_verdicts_match_host_on_malformed(seed):
    cases = _cases(seed)
    M = -(-max(len(c) for c in cases) // 128) * 128
    arr = np.zeros((len(cases), M), np.int32)
    lens = np.zeros((len(cases),), np.int32)
    for i, c in enumerate(cases):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
        lens[i] = len(c)
    out, olen = decode_blocks(jnp.asarray(arr), jnp.asarray(lens), CAP)
    out, olen = np.asarray(out), np.asarray(olen)
    for i, c in enumerate(cases):
        try:
            ref = decompress_block(c, CAP)
        except Lz4BlockError:
            assert olen[i] == -1, f"case {i}: kernel accepted, host rejects"
            continue
        assert olen[i] == len(ref), i
        assert bytes(out[i, :olen[i]].astype(np.uint8)) == ref, i


def test_linked_chain_poisons_after_truncation():
    data = gen_buffer(3 * 65536, 0.7, 7)
    blocks = [data[k:k + 65536] for k in range(0, len(data), 65536)]
    pl_ = [compress_block(b, dict_=(blocks[j - 1] if j else b""))
           for j, b in enumerate(blocks)]
    M = -(-max(map(len, pl_)) // 128) * 128
    arr = np.zeros((3, M), np.int32)
    lens = np.zeros((3,), np.int32)
    for i, c in enumerate(pl_):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
        lens[i] = len(c)
    lens[0] -= 5
    _, olen = decode_blocks_linked(jnp.asarray(arr), jnp.asarray(lens),
                                   65536)
    assert np.asarray(olen)[0] == -1
