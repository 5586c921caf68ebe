"""Suite-wide fixtures and process setup.

The tier-1 suite runs ~500 compile-heavy tests in ONE process; XLA's CPU
backend JITs every engine program it meets along the way. Two pieces of
setup keep that sustainable:

* the stack rlimit is raised up front — LLVM compilation recurses deeply
  and the 8 MB default soft limit leaves little headroom late in the run
  (the main-thread stack grows on demand up to the soft limit, so raising
  it here is enough),
* ``jax.clear_caches()`` runs between test modules, releasing executables
  cached for functions the finished module will never call again.
"""
import gc
import resource

import jax
import pytest


def _raise_stack_limit():
    soft, hard = resource.getrlimit(resource.RLIMIT_STACK)
    want = 512 * 1024 * 1024
    if soft != resource.RLIM_INFINITY and soft < want:
        if hard == resource.RLIM_INFINITY or hard >= want:
            try:
                resource.setrlimit(resource.RLIMIT_STACK, (want, hard))
            except (ValueError, OSError):
                pass


_raise_stack_limit()


@pytest.fixture(scope="module", autouse=True)
def _drop_stale_jit_caches():
    """Free executables compiled by previous modules before this one runs."""
    gc.collect()
    jax.clear_caches()
    yield


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one (tests/test_torch_gpu.py)"
    )
