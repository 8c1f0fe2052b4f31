"""The caches of a run, at fixed directories inside the checkout.

A run is a new process, and several run in every check: whatever one run
builds, the next should find.  :func:`use_checkout_caches` points each
cache of the process at ``<checkout>/.tribench_cache/``, before ``torch``
is imported:

  * ``torch_extensions/`` and ``triton/``: PyTorch's extension builds and
    Triton's kernel cache (the port's own CUDA kernels build under
    ``src/repro_torch/kernels/_build/``, inside the checkout already);
  * ``pycache/``: Python's compiled bytecode (``sys.pycache_prefix``).
    Where the installed packages hold no usable ``.pyc`` (a read-only or
    freshly copied environment), every process would otherwise compile
    ``torch``, ``sympy`` and ``torch._dynamo`` from source again, seconds
    of host work that the shared host makes vary from run to run.

Only the first run in a checkout fills them; the paths never depend on a
process id, a temporary name or the time.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path


def use_checkout_caches(checkout: Path) -> Path:
    """Point this process's caches at ``checkout/.tribench_cache``."""
    cache = Path(checkout) / ".tribench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False
    return cache
