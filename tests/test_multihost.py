"""Multi-host runtime: 2 JAX processes x 4 virtual CPU devices on
localhost, one global mesh, shard-mapped compression with a compressed-
length all-gather, per-process frame segments spliced into ONE frame.

This is the CI stand-in for several GPU hosts, one process each
(SURVEY 2.5/5 distributed backend; the reference has no distribution
layer at all).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_compress(tmp_path):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "multihost_worker.py"),
             coord, "2", str(pid), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out.decode(errors="replace"))
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]

    import numpy as np
    lens0 = np.load(tmp_path / "lens0.npy")
    lens1 = np.load(tmp_path / "lens1.npy")
    # the all-gather gave both processes the SAME full length vector
    assert (lens0 == lens1).all()

    frame = ((tmp_path / "head.bin").read_bytes()
             + (tmp_path / "seg0.bin").read_bytes()
             + (tmp_path / "seg1.bin").read_bytes()
             + (tmp_path / "tail.bin").read_bytes())
    data = (tmp_path / "plain.bin").read_bytes()

    from lz4_tpu.frame import decompress_frame
    content, _ = decompress_frame(frame)
    assert content == data

    # decode direction: the per-process decoded segments splice back to
    # the original content (shard-mapped decode + olen all-gather)
    dec = ((tmp_path / "dec0.bin").read_bytes()
           + (tmp_path / "dec1.bin").read_bytes())
    assert dec == data

    from . import oracle
    if oracle.available():
        assert oracle.ref_decompress_frame(frame, len(data)) == data
