"""An autouse fixture for the port's test files: while one of their modules
runs, JAX neither reads nor writes the persistent compilation cache that
``tests/conftest.py`` sets, and every reference executable the module
runs is compiled in this process, on this host.

The port replays the reference's XLA:CPU arithmetic bit for bit: its
fused multiply-adds, and reduction orders that follow the host's vector
width (F4, ``kernels/rl_score/ref.py::unfused_columns``).  An executable
read from the shared cache may have been compiled on a machine with
another CPU (loading such entries logs "... is not supported on the host
machine") and then computes with that machine's arithmetic.  Whether a
worker reads one depends on which entries the cache holds and on what
the worker ran before: an executable that another module loaded stays in
JAX's in-memory caches.  So the exact comparisons passed in one run and
failed in another (ROADMAP §3, F5 and F6).  Writing an entry serializes
the executable, which now and then killed an xdist worker as well.

The fixture therefore turns the persistent cache off and empties JAX's
in-memory caches when a module starts, and does both again when it ends,
so that the modules after it find JAX as they would have without it.

Import it into a test module (``from _reference_cache import
no_persistent_compile_cache  # noqa: F401``); a module that runs without
JAX (a card machine) is left as it is.
"""
import pytest


def _set(jax, cc, enabled: bool) -> None:
    jax.clear_caches()
    jax.config.update("jax_enable_compilation_cache", enabled)
    cc.reset_cache()        # the next compile asks the setting again


@pytest.fixture(autouse=True, scope="module")
def no_persistent_compile_cache():
    try:
        import jax
        from jax.experimental.compilation_cache import compilation_cache as cc
    except ImportError:          # a machine without the reference
        yield
        return
    prev = jax.config.jax_enable_compilation_cache
    _set(jax, cc, False)
    try:
        yield
    finally:
        _set(jax, cc, prev)
