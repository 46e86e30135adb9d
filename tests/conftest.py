"""Test configuration: run everything on CPU with 8 virtual devices so the
multi-device sharding paths (`meteor_scatter_tpu.parallel`) are exercised
without a GPU, per SURVEY.md §4's test plan.  Tests that need the card
carry the ``gpu`` marker and skip here; ``python chip_smoke.py`` runs
their checks on the card."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # whatever accelerator the host has
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# pin the CPU before any backend initializes, also where a plugin set
# jax_platforms programmatically
jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables at module boundaries.

    One pytest process compiles many hundreds of CPU executables across the
    suite; each holds JIT code pages and allocator mappings for the
    process's lifetime, and the XLA CPU compiler eventually segfaults on a
    fresh compile once the address space is cluttered (observed twice at
    ~85% of the full suite, in backend_compile, on graphs that compile
    fine in isolation).  Dropping the jit caches when a test module
    finishes keeps the live-executable population bounded; modules
    recompile what they share (seconds at test scale)."""
    yield
    jax.clear_caches()
