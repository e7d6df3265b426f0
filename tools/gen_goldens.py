"""Freeze golden renders for tests/test_golden.py.

Renders each gated scene end-to-end through the PBRT parser on CPU jax (the
same configuration the test suite uses) and stores the linear-RGB float32
image in tests/goldens/<name>.npz. Re-run ONLY when an intentional change to
the renderer's output is made; the diff of the regenerated goldens is the
review surface for that change.

Usage: python tools/gen_goldens.py [name ...]
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

from rustracer_tpu.utils.device import REPO_ROOT, configure_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
configure_compile_cache(os.path.join(REPO_ROOT, ".jax_cache_cpu"))

import numpy as np  # noqa: E402

GOLDEN_SCENES = [
    "cornell-box",
    "testball-matte",
    "testball-plastic",
    "testball-metal",
    "testball-glass",
    "testball-mirror",
    "testball-roughglass",
    "testball-roughmetal",
    "testball-substrate",
    "testball-disney",
    "testball-textured",
    "veach-mis",
    "envmap-dof",
    "bathroom",
]


def render_scene(name):
    from rustracer_tpu.scene.api import parse_scene
    api = parse_scene(os.path.join(REPO, "scenes", f"{name}.pbrt"))
    return np.asarray(api.scene.render())


def main(names):
    outdir = os.path.join(REPO, "tests", "goldens")
    os.makedirs(outdir, exist_ok=True)
    for name in names or GOLDEN_SCENES:
        img = render_scene(name)
        assert np.isfinite(img).all(), f"{name}: non-finite pixels"
        path = os.path.join(outdir, f"{name}.npz")
        np.savez_compressed(path, img=img.astype(np.float32))
        print(f"{name}: {img.shape} mean={img.mean():.4f} "
              f"max={img.max():.3f} -> {path}")


if __name__ == "__main__":
    main(sys.argv[1:])
