"""unires-tpu: unified super-resolution / denoising for 3D medical images.

A from-scratch JAX/XLA re-design with the capabilities of brudfors/UniRes
(multi-channel joint-total-variation MAP reconstruction via ADMM + CG, with
data-driven hyper-parameters, rigid pose and even/odd slice scaling updates).
"""
import os

__version__ = "0.2.0"

# fixed in-checkout default for the persistent compilation cache (listed in
# .gitignore); a cache directory that moves between runs never hits
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    The directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set, and
    :data:`CACHE_DIR` otherwise; no other cache is configured.
    """
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir


_enable_compilation_cache()

from .settings import Settings, settings  # noqa: E402,F401
from .models.proj_op import ProjOp, proj_info  # noqa: E402,F401
from .models.forward import proj_apply, check_adjoint  # noqa: E402,F401
from .pipeline.run import init, fit, preproc  # noqa: E402,F401
from .pipeline.run import fit_batch, preproc_batch  # noqa: E402,F401
