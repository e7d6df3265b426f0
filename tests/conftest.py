"""Test configuration: force CPU jax with an 8-device virtual mesh.

Unit tests are hermetic and exercise multi-device sharding on virtual CPU
devices. The GPU run is `python chip_smoke.py` (see README.md).

A persistent compilation cache keeps warm reruns of the render-heavy tests
cheap: `.jax_cache_cpu` in the checkout, or JAX_COMPILATION_CACHE_DIR when
that is set. `@pytest.mark.slow` guards the long end-to-end renders
(excluded by default, see pytest.ini — run them with `pytest -m slow`).
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from rustracer_tpu.utils.device import REPO_ROOT, configure_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
configure_compile_cache(os.path.join(REPO_ROOT, ".jax_cache_cpu"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
