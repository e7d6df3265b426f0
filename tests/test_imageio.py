"""Hand-rolled PNG and TGA codecs (render/imageio.py): round trips over
every color mode and PNG filter type, and decodes checked against PIL,
which the test environment has but the renderer does not use."""
import os

import numpy as np
import pytest

from rustracer_tpu.render.imageio import (read_image, read_png8, read_tga8,
                                          write_image, write_png8, write_tga8)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = os.path.join(REPO, "scenes", "textures", "grid.png")


def _pixels(shape, seed=0):
    """Noise with flat runs, so filters and RLE packets both get work."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    a[:, : shape[1] // 3] = a[:, :1]
    return a


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4],
                         ids=["gray", "gray-alpha", "rgb", "rgba"])
def test_png_roundtrip(tmp_path, channels, filter_type):
    a = _pixels((13, 17, channels), seed=channels)
    path = str(tmp_path / "a.png")
    write_png8(path, a, filter_type=filter_type)
    np.testing.assert_array_equal(read_png8(path), a)


@pytest.mark.parametrize("filter_type", [0, 4], ids=["none", "paeth"])
def test_png_palette_roundtrip(tmp_path, filter_type):
    rng = np.random.default_rng(3)
    pal = rng.integers(0, 256, (7, 3), dtype=np.uint8)
    idx = rng.integers(0, 7, (9, 11), dtype=np.uint8)
    path = str(tmp_path / "p.png")
    write_png8(path, idx, palette=pal, filter_type=filter_type)
    np.testing.assert_array_equal(read_png8(path), pal[idx])


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
def test_tga_roundtrip(tmp_path, channels):
    a = _pixels((10, 15, channels), seed=10 + channels)
    path = str(tmp_path / "a.tga")
    write_tga8(path, a)
    np.testing.assert_array_equal(read_tga8(path), a)


def test_grid_texture_matches_pil():
    Image = pytest.importorskip("PIL.Image")
    ref = np.asarray(Image.open(GRID).convert("RGB"))
    np.testing.assert_array_equal(read_png8(GRID), ref)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_decode_matches_pil(tmp_path, mode):
    """PNGs written by PIL (its own filter choice per row) decode to PIL's
    pixels."""
    Image = pytest.importorskip("PIL.Image")
    rgb = _pixels((21, 19, 3), seed=5)
    im = Image.fromarray(rgb).convert(mode)
    path = str(tmp_path / f"{mode}.png")
    im.save(path)
    want = np.asarray(im.convert("RGB") if mode == "P" else im)
    got = read_png8(path)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("compression", [None, "tga_rle"], ids=["raw", "rle"])
def test_tga_decode_matches_pil(tmp_path, mode, compression):
    """TGAs written by PIL (uncompressed and RLE, packets longer than 128
    pixels, color-mapped included) decode to PIL's pixels."""
    Image = pytest.importorskip("PIL.Image")
    im = Image.fromarray(_pixels((12, 140, 3), seed=6)).convert(mode)
    path = str(tmp_path / f"{mode}.tga")
    im.save(path, compression=compression)
    want = np.asarray(Image.open(path).convert("RGB") if mode == "P"
                      else Image.open(path))
    got = read_tga8(path)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("ext", [".png", ".tga"])
def test_write_image_read_image_linear_roundtrip(tmp_path, ext):
    """Linear float → sRGB 8-bit file → linear float, within 8-bit steps."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0.0, 1.0, (6, 5, 3)).astype(np.float32)
    path = str(tmp_path / f"img{ext}")
    write_image(path, img)
    back = read_image(path)
    assert back.shape == img.shape
    # one sRGB code step is at most ~1.3% of the linear value near 1
    np.testing.assert_allclose(back, img, atol=0.013)
