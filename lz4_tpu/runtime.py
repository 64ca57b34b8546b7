"""Process set-up shared by the CLI, the benchmarks and the smoke check:
where compiled programs are cached, and which device a number came from.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def use_compile_cache() -> str:
    """Keep JAX's persistent compile cache where JAX_COMPILATION_CACHE_DIR
    says (JAX reads the variable itself), or else in ``.jax_cache/`` of
    the checkout.  Returns the directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(CHECKOUT / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_name_and_power() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports them
    ("not measured" when there is no nvidia-smi)."""
    if shutil.which("nvidia-smi") is None:
        return "not measured"
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() \
        else "not measured"


def device_label() -> dict:
    """The device a measurement ran on, as JAX and nvidia-smi report it."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_name_and_power()}
