# lz4_tpu build/test shell — analog of the reference's Makefile targets
# (reference Makefile:60-117: test, sanitize-style soak, bench, examples).
# Everything runs from the repo root; no install step is required
# (pyproject.toml provides `pip install -e .` packaging).
#
# The CPU tiers run with JAX_PLATFORMS=cpu: kernels run in Pallas
# interpret mode.  `make gputest` and `make smoke` need an NVIDIA GPU.

PY ?= python
PYTEST ?= $(PY) -m pytest
CPU_ENV = JAX_PLATFORMS=cpu

.PHONY: all test gputest smoke slowtest soak bench fullbench examples multichip clean

all: test

# CI suite: CPU interpret + 8-device virtual mesh (tests/conftest.py)
test:
	$(CPU_ENV) $(PYTEST) tests/ -x -q

# the tests that need the card, and the smoke check of the device path
gputest:
	$(PYTEST) -m gpu tests/ -q

smoke:
	$(PY) chip_smoke.py

# widened envelopes (big blocks, long streams) — reference `make test` tier
slowtest:
	$(CPU_ENV) LZ4TPU_SLOW_TESTS=1 $(PYTEST) tests/ -x -q

# fuzz soak: ≥10k cycles across the block/frame/SG/kernel fuzz suites
# plus the widened-seed adversarial kernel battery (the SEEDS knob)
# (reference programs/Makefile:65 time-boxed fuzzer runs)
soak:
	$(CPU_ENV) LZ4TPU_FUZZ_CYCLES=10000 LZ4TPU_FUZZ_SEEDS=12 \
	  $(PYTEST) tests/test_fuzz.py tests/test_adversarial_kernel.py -x -q

# headline benchmark (one JSON line; needs the GPU)
bench:
	$(PY) bench.py

# per-entry-point table (reference programs/fullbench.c analog)
fullbench:
	$(PY) fullbench.py

examples:
	$(CPU_ENV) $(PYTEST) tests/test_examples.py -x -q

# compile-and-run the multi-chip training-step dryrun on a virtual mesh
multichip:
	$(CPU_ENV) XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  $(PY) -c "import __graft_entry__ as g; g.dryrun_multichip(8); print('ok')"

clean:
	rm -rf build dist *.egg-info lz4_tpu/__pycache__ tests/__pycache__
