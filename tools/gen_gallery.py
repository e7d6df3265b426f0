"""Write renders/*.png from the frozen goldens (tests/goldens/*.npz).

The reference ships a renders/ gallery (renders/README.md) as capability
evidence; this repo's equivalent is generated from the golden-gated
renders so the gallery and the regression suite can never drift apart.
Regenerate with `python tools/gen_gallery.py` after tools/gen_goldens.py.
"""
import glob
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from rustracer_tpu.core.spectrum import srgb_encode  # noqa: E402
from rustracer_tpu.render.imageio import write_png8  # noqa: E402

OUT = os.path.join(REPO, "renders")


def main():
    os.makedirs(OUT, exist_ok=True)
    names = []
    for path in sorted(glob.glob(os.path.join(REPO, "tests", "goldens",
                                              "*.npz"))):
        name = os.path.splitext(os.path.basename(path))[0]
        img = np.load(path)["img"]
        png = np.asarray(srgb_encode(jnp.asarray(img)))
        out = os.path.join(OUT, f"rt-{name}.png")
        write_png8(out, (np.clip(png, 0, 1) * 255).astype(np.uint8))
        names.append(name)
        print(f"wrote {out} {img.shape}")
    with open(os.path.join(OUT, "README.md"), "w") as f:
        f.write(
            "# Render gallery\n\n"
            "Generated from the frozen golden renders (tests/goldens/*.npz)\n"
            "by tools/gen_gallery.py — the same images the regression suite\n"
            "gates, sRGB-encoded. Mirrors the reference's renders/ gallery\n"
            "(reference renders/README.md; its PNGs are git-lfs pointers in\n"
            "this environment, so no pixel comparison is possible — see\n"
            "tests/test_golden.py for the substitute gates).\n\n"
            + "\n".join(f"- `rt-{n}.png`" for n in names) + "\n")


if __name__ == "__main__":
    main()
