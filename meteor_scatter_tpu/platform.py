"""Which implementation each job uses on each platform.

The program runs on two JAX backends: the CPU (tests, small hosts) and an
NVIDIA GPU.  Every place that picks an implementation by platform asks
this module, so the choice lives in one table.  The CPU keeps the
reference formulations that the tests pin bit-exactly; the GPU entries are
the fastest formulations measured on an H100 whose event lists equal the
reference's (PERF.md, "Findings").  Any other backend is refused.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

_DEFAULTS = {
    "cpu": {"stream_front": "welch", "stream_solver": "scan", "scan_unroll": 1},
    "gpu": {"stream_front": "bins", "stream_solver": "fused", "scan_unroll": 16},
}


def platform() -> str:
    """``"cpu"`` or ``"gpu"`` for JAX's default backend; ``ValueError``
    for any other backend."""
    backend = jax.default_backend()
    if backend not in _DEFAULTS:
        raise ValueError(
            f"unsupported JAX backend {backend!r}: this program runs on "
            f"{' or '.join(sorted(_DEFAULTS))}"
        )
    return backend


def stream_front() -> str:
    """Streaming front half: ``"welch"`` (full Welch PSDs) or ``"bins"``
    (the three band levels as one GEMM)."""
    return _DEFAULTS[platform()]["stream_front"]


def stream_solver() -> str:
    """Streaming block-rate solver (``stream_process(impl=...)``)."""
    return _DEFAULTS[platform()]["stream_solver"]


def scan_unroll() -> int:
    """``lax.scan`` unroll factor of the streaming scan solver."""
    return _DEFAULTS[platform()]["scan_unroll"]


def interpret_kernels() -> bool:
    """Pallas kernels run in interpret mode on the CPU, where no caller
    picks them unless it names them (tests do); on the GPU they are always
    compiled, never interpreted."""
    return platform() == "cpu"


def enable_compile_cache() -> str:
    """Keep JAX's persistent compilation cache at one fixed path and
    return it.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
    itself and nothing is changed; otherwise the cache lives in
    ``.jax_cache`` at the root of the checkout (listed in .gitignore).
    The path is part of the cache key, so it never holds a temporary
    name, a process id or a time."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(Path(__file__).resolve().parent.parent / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
