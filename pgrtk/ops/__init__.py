"""Device kernels (JAX/XLA).

Importing this package points JAX's persistent compilation cache at one
fixed directory before the first compile on any device path: the one
`JAX_COMPILATION_CACHE_DIR` names when it is set, otherwise `.jax_cache`
at the root of the checkout (git-ignored).  The path is part of the
cache's key, so it never comes from a temporary name, a process id or
the time.
"""
import os
import sys

DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Return the compile-cache directory, setting it if the environment
    names none.  jax reads the variable when it is imported; if it
    already is, its config is updated instead."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = DEFAULT_COMPILE_CACHE_DIR
    os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    if "jax" in sys.modules:
        sys.modules["jax"].config.update("jax_compilation_cache_dir", path)
    return path


enable_compile_cache()
