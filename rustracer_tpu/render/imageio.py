"""Image I/O: PNG/TGA/EXR/HDR/PFM read; PNG/TGA/EXR write.

Reference: rustracer-core/src/imageio.rs (PNG/TGA via the `image` crate with
sRGB→linear, EXR via the `exr` crate, hand-rolled HDR/PFM readers, PNG
gamma-encoded 8-bit + EXR float writers). Everything is hand-rolled with
zlib, struct and NumPy: PNG (8/16-bit, non-interlaced gray, gray+alpha, RGB,
RGBA and palette, all five row filters), TGA (uncompressed and RLE
true-color, grayscale and color-mapped), EXR (scanline, none/ZIP/ZIPS
compression, half/float), Radiance HDR (RGBE) and PFM.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..core.spectrum import srgb_decode_np

EXR_MAGIC = 20000630


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def read_image(path: str) -> np.ndarray:
    """→ (H, W, 3) float32 LINEAR RGB (imageio.rs:16 read_image)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".png", ".tga"):
        arr = read_png8(path) if ext == ".png" else read_tga8(path)
        return srgb_decode_np(_to_rgb(arr).astype(np.float32) / 255.0)
    if ext == ".exr":
        return read_exr(path)
    if ext == ".hdr":
        return read_hdr(path)
    if ext == ".pfm":
        return read_pfm(path)
    raise ValueError(f"unsupported image format: {path}")


def _to_rgb(arr: np.ndarray) -> np.ndarray:
    """(H, W, C) 8-bit gray / gray+alpha / RGB / RGBA → (H, W, 3); alpha is
    dropped, not composited."""
    if arr.shape[2] <= 2:
        return np.repeat(arr[..., :1], 3, axis=2)
    return arr[..., :3]


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    """PNG Paeth predictor on int arrays (left, up, up-left)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters → (h, stride) uint8.

    Pixel (y, x) depends only on its left, upper and upper-left neighbours,
    so every anti-diagonal y + x = d depends only on the two before it: the
    rows are undone together, one diagonal at a time, each row by its own
    filter type (w + h vector steps instead of w * h scalar ones)."""
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"bad PNG filter type {ftype.max()}")
    w = stride // bpp
    cur = rows[:, 1:].astype(np.int16).reshape(h, w, bpp)
    f = ftype[:, None].astype(np.int16)
    # out[y + 1, x + 1] is pixel (y, x); row 0 and column 0 are the zeros
    # the filters see outside the image
    out = np.zeros((h + 1, w + 1, bpp), np.int16)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        xs = d - ys
        left, up, ul = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        fd = f[ys]
        pred = np.select([fd == 1, fd == 2, fd == 3, fd == 4],
                         [left, up, (left + up) >> 1, _paeth(left, up, ul)])
        out[ys + 1, xs + 1] = (cur[ys, xs] + pred) & 0xFF
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png8(path: str) -> np.ndarray:
    """PNG → (H, W, C) uint8 with C = 1 (gray), 2 (gray+alpha), 3 (RGB,
    palette) or 4 (RGBA). 16-bit samples keep their high byte."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, plte, hdr = 8, [], None, None
    while pos + 8 <= len(data):
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if interlace or color not in _PNG_CHANNELS or depth not in (8, 16) \
            or (color == 3 and depth != 8):
        raise ValueError(f"{path}: PNG color type {color}, depth {depth}, "
                         f"interlace {interlace} unsupported")
    nc = _PNG_CHANNELS[color]
    bpp = nc * depth // 8
    px = _png_unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    px = px.reshape(h, w, nc, depth // 8)[..., 0]      # big-endian high byte
    if color == 3:
        if plte is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return plte[px[..., 0]]
    return px


def _png_filter(px: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """Apply one PNG filter type to every row of (h, stride) uint8."""
    x = px.astype(np.int32)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    ul = np.zeros_like(x)
    ul[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
            4: _paeth(left, up, ul)}[ftype]
    return ((x - pred) & 0xFF).astype(np.uint8)


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + \
        struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)


def write_png8(path: str, arr: np.ndarray, palette=None, filter_type=1):
    """(H, W) / (H, W, C) uint8 → 8-bit PNG: C = 1 gray, 2 gray+alpha,
    3 RGB, 4 RGBA; with `palette` ((N, 3) uint8) `arr` holds palette
    indices. Every row uses `filter_type` (0 None .. 4 Paeth)."""
    arr = np.asarray(arr, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, nc = arr.shape
    if palette is not None:
        color = 3
    else:
        color = {1: 0, 2: 4, 3: 2, 4: 6}[nc]
    rows = _png_filter(arr.reshape(h, w * nc), filter_type, nc)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows],
                         axis=1).tobytes()
    out = _PNG_SIG + _png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
    if palette is not None:
        out += _png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    out += _png_chunk(b"IDAT", zlib.compress(raw, 6)) + \
        _png_chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def read_tga8(path: str) -> np.ndarray:
    """TGA (types 1/2/3 uncompressed, 9/10/11 RLE; 8-bit gray, 8-bit
    color-mapped, 16/24/32-bit true color) → (H, W, C) uint8, top row
    first, C = 1 (gray), 3 (RGB) or 4 (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    (id_len, cmap_type, itype, cmap_first, cmap_len, cmap_bits, _, _, w, h,
     bits, desc) = struct.unpack("<BBBHHBHHHHBB", data[:18])
    pos = 18 + id_len
    cmap = None
    if cmap_type:
        cb = (cmap_bits + 7) // 8
        cmap = _tga_pixels(data[pos:pos + cmap_len * cb], cmap_len, cb)
        pos += cmap_len * cb
    base = itype & ~8
    if base not in (1, 2, 3):
        raise ValueError(f"{path}: TGA image type {itype} unsupported")
    bpp = (bits + 7) // 8
    n = w * h
    if itype & 8:                                        # RLE packets
        out = bytearray()
        while len(out) < n * bpp:
            head = data[pos]
            pos += 1
            cnt = (head & 0x7F) + 1
            if head & 0x80:
                out += data[pos:pos + bpp] * cnt
                pos += bpp
            else:
                out += data[pos:pos + cnt * bpp]
                pos += cnt * bpp
        raw = bytes(out[:n * bpp])
    else:
        raw = data[pos:pos + n * bpp]
    if base == 1:
        idx = np.frombuffer(raw, np.uint8 if bpp == 1 else "<u2", count=n)
        px = cmap[idx.astype(np.int64) - cmap_first]
    elif base == 3:
        px = np.frombuffer(raw, np.uint8, count=n)[:, None]
    else:
        px = _tga_pixels(raw, n, bpp)
    px = px.reshape(h, w, -1)
    if not desc & 0x20:                                  # bottom-up origin
        px = px[::-1]
    if desc & 0x10:                                      # right-to-left
        px = px[:, ::-1]
    return np.ascontiguousarray(px)


def _tga_pixels(raw: bytes, n: int, bpp: int) -> np.ndarray:
    """n little-endian BGR(A) TGA pixels → (n, 3|4) uint8 RGB(A)."""
    if bpp == 2:
        v = np.frombuffer(raw, "<u2", count=n).astype(np.int32)
        rgb = np.stack([(v >> 10) & 31, (v >> 5) & 31, v & 31], -1)
        return ((rgb * 255 + 15) // 31).astype(np.uint8)
    px = np.frombuffer(raw, np.uint8, count=n * bpp).reshape(n, bpp)
    return px[:, [2, 1, 0, 3][:bpp]]


def write_tga8(path: str, arr: np.ndarray):
    """(H, W) / (H, W, C) uint8 → uncompressed TGA, C = 1 gray, 3 RGB,
    4 RGBA, top-left origin."""
    arr = np.asarray(arr, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, nc = arr.shape
    if nc not in (1, 3, 4):
        raise ValueError(f"TGA write: {nc} channels unsupported")
    px = arr.reshape(-1, nc)
    if nc >= 3:
        px = px[:, [2, 1, 0, 3][:nc]]
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 3 if nc == 1 else 2, 0, 0, 0,
                       0, 0, w, h, 8 * nc, 0x20 | (8 if nc == 4 else 0))
    with open(path, "wb") as f:
        f.write(head + px.tobytes())


def read_pfm(path: str) -> np.ndarray:
    """PFM incl. endian handling (imageio.rs:179-246)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        color = header == b"PF"
        dims = f.readline().split()
        while len(dims) < 2:
            dims += f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        count = w * h * (3 if color else 1)
        data = np.frombuffer(f.read(count * 4), dtype=dtype, count=count)
        data = data.astype(np.float32) * abs(scale) if abs(scale) != 1.0 \
            else data.astype(np.float32)
        if color:
            img = data.reshape(h, w, 3)
        else:
            img = np.repeat(data.reshape(h, w, 1), 3, axis=2)
        return img[::-1].copy()  # PFM stores bottom-up


def read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE .hdr reader (imageio.rs:114-132)."""
    with open(path, "rb") as f:
        line = f.readline()
        if not line.startswith(b"#?"):
            raise ValueError(f"{path}: not a Radiance HDR file")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
        dims = f.readline().split()
        # -Y H +X W
        h, w = int(dims[1]), int(dims[3])
        data = f.read()
    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2 and \
                (data[pos + 2] << 8 | data[pos + 3]) == w:
            # RLE scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]
                    pos += 1
                    if cnt > 128:
                        rgbe[y, x:x + cnt - 128, c] = data[pos]
                        pos += 1
                        x += cnt - 128
                    else:
                        rgbe[y, x:x + cnt, c] = np.frombuffer(
                            data[pos:pos + cnt], np.uint8)
                        pos += cnt
                        x += cnt
        else:
            row = np.frombuffer(data[pos:pos + 4 * w], np.uint8).reshape(w, 4)
            rgbe[y] = row
            pos += 4 * w
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0,
                     np.ldexp(1.0, exp - 136)).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None] * \
        np.where(exp[..., None] == 0, 0.0, 1.0)


def _read_exr_header(f):
    attrs = {}
    while True:
        name = b""
        while True:
            c = f.read(1)
            if c == b"\x00":
                break
            name += c
        if name == b"":
            break
        ty = b""
        while True:
            c = f.read(1)
            if c == b"\x00":
                break
            ty += c
        size = struct.unpack("<i", f.read(4))[0]
        attrs[name.decode()] = (ty.decode(), f.read(size))
    return attrs


def _parse_chlist(data: bytes):
    chans = []
    pos = 0
    while data[pos] != 0:
        name = b""
        while data[pos] != 0:
            name += data[pos:pos + 1]
            pos += 1
        pos += 1
        ptype, = struct.unpack_from("<i", data, pos)
        pos += 16
        chans.append((name.decode(), ptype))
    return chans


def read_exr(path: str) -> np.ndarray:
    """Minimal OpenEXR scanline reader: compression none/ZIPS/ZIP,
    half/float channels (imageio.rs:134-160 capability parity)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != EXR_MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        if version & 0x200:
            raise ValueError(f"{path}: tiled/multipart EXR unsupported")
        attrs = _read_exr_header(f)
        chans = _parse_chlist(attrs["channels"][1])
        comp = attrs["compression"][1][0]
        x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
        w = x1 - x0 + 1
        h = y1 - y0 + 1
        if comp == 0:
            lines_per_chunk = 1
        elif comp == 2:
            lines_per_chunk = 1   # ZIPS
        elif comp == 3:
            lines_per_chunk = 16  # ZIP
        else:
            raise ValueError(f"{path}: EXR compression {comp} unsupported "
                             "(none/ZIP/ZIPS only)")
        n_chunks = -(-h // lines_per_chunk)
        f.read(8 * n_chunks)  # offset table (sequential read, ignore)
        dt = {1: np.float16, 2: np.float32}
        sizes = {1: 2, 2: 4}
        out = {name: np.zeros((h, w), np.float32) for name, _ in chans}
        chans_sorted = sorted(chans)  # storage is alphabetical by channel
        for _ in range(n_chunks):
            y, nbytes = struct.unpack("<ii", f.read(8))
            raw = f.read(nbytes)
            ny = min(lines_per_chunk, y1 - y + 1)
            expect = ny * sum(w * sizes[pt] for _, pt in chans_sorted)
            if comp in (2, 3):
                raw = zlib.decompress(raw)
                if len(raw) == expect:
                    # undo EXR predictor + interleave
                    arr = np.frombuffer(raw, np.uint8).astype(np.int16)
                    arr = np.cumsum(arr - 128, dtype=np.int64) % 256
                    arr2 = arr.astype(np.uint8)
                    half = (len(arr2) + 1) // 2
                    out_b = np.zeros(len(arr2), np.uint8)
                    out_b[0::2] = arr2[:half]
                    out_b[1::2] = arr2[half:]
                    raw = out_b.tobytes()
            pos = 0
            for line in range(ny):
                for name, pt in chans_sorted:
                    n = w * sizes[pt]
                    vals = np.frombuffer(raw[pos:pos + n], dt[pt]).astype(np.float32)
                    out[name][y - y0 + line] = vals
                    pos += n
    if all(k in out for k in "RGB"):
        return np.stack([out["R"], out["G"], out["B"]], -1)
    if "Y" in out:
        return np.repeat(out["Y"][..., None], 3, -1)
    first = next(iter(out.values()))
    return np.repeat(first[..., None], 3, -1)


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def write_image(path: str, img: np.ndarray):
    """Linear RGB (H, W, 3) → file by extension (imageio.rs:35 write_image)."""
    ext = os.path.splitext(path)[1].lower()
    img = np.asarray(img, np.float32)
    if ext == ".png" or ext == "":
        write_png(path if ext else path + ".png", img)
    elif ext == ".exr":
        write_exr(path, img)
    elif ext == ".tga":
        write_tga8(path, _to_srgb8(img))
    else:
        raise ValueError(f"unsupported output format {ext}")


def _to_srgb8(img):
    img = np.clip(img, 0.0, 1.0)
    srgb = np.where(img <= 0.0031308, 12.92 * img,
                    1.055 * np.power(np.maximum(img, 1e-8), 1 / 2.4) - 0.055)
    return (np.clip(srgb, 0, 1) * 255 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray):
    """Gamma-corrected 8-bit PNG (imageio.rs:52-74)."""
    write_png8(path, _to_srgb8(img))


def _exr_attr(name: str, ty: str, data: bytes) -> bytes:
    return name.encode() + b"\x00" + ty.encode() + b"\x00" + \
        struct.pack("<i", len(data)) + data


def write_exr(path: str, img: np.ndarray):
    """Uncompressed float32 scanline EXR writer (imageio.rs:76-92)."""
    h, w = img.shape[:2]
    chlist = b""
    for name in ("B", "G", "R"):
        chlist += name.encode() + b"\x00" + struct.pack("<i", 2) + \
            b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1)
    chlist += b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b""
    header += _exr_attr("channels", "chlist", chlist)
    header += _exr_attr("compression", "compression", b"\x00")
    header += _exr_attr("dataWindow", "box2i", box)
    header += _exr_attr("displayWindow", "box2i", box)
    header += _exr_attr("lineOrder", "lineOrder", b"\x00")
    header += _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _exr_attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += _exr_attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", EXR_MAGIC, 2))
        f.write(header)
        offset0 = 8 + len(header) + 8 * h
        line_bytes = 8 + 3 * 4 * w
        for y in range(h):
            f.write(struct.pack("<Q", offset0 + y * line_bytes))
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * 4 * w))
            # channels alphabetical: B, G, R
            f.write(img[y, :, 2].astype("<f4").tobytes())
            f.write(img[y, :, 1].astype("<f4").tobytes())
            f.write(img[y, :, 0].astype("<f4").tobytes())
