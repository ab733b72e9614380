"""Image decode, encode and resize for the data pipeline, without cv2, PIL
or pandas (the GPU machine has none of them).

PNG is decoded here: the chunks are parsed in Python, the image data is
inflated by ``zlib`` (standard library; it releases the GIL) and the rows
are unfiltered by the host helper ``csrc/host_image.cpp`` (g++, built on
first use, loaded with ctypes, which also releases the GIL). Colour types
0, 2, 3, 4 and 6 are read at every bit depth, with cv2's conversions:

- ``read_image`` is ``cv2.imread(IMREAD_COLOR)`` turned to RGB: gray is
  replicated, alpha is dropped, 16-bit samples keep their high byte,
  samples below 8 bits are scaled to 0..255, palettes are expanded.
- ``read_mask`` is ``IMREAD_GRAYSCALE``: gray as is; colour through the
  luma weights of ``to_grayscale_3ch`` (libpng's own conversion inside
  cv2 may differ from these by 1).

Interlaced PNGs raise, naming the file. A file that is not a PNG is read
with cv2 or PIL when one of them is importable, and raises otherwise. A
corrupt or missing file gives None, as the JAX package's ``_decode_image``
does, so that the dataset's skip-to-next retry works.

``write_png`` encodes 8-bit gray, RGB or RGBA with ``zlib`` and a filter
type that cycles 0, 1, 2, 3, 4 by row, so that every filter occurs in the
files it writes. The resizes are the host helper's (cv2's conventions;
bilinear within 1 of cv2, nearest exact).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

from fmc_uia_tpu_torch.ops import build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# cv2's RGB2GRAY: round((9798 R + 19235 G + 3735 B) / 2^15)
_LUMA = (9798, 19235, 3735)


class _Corrupt(Exception):
    """A PNG stream that cannot be decoded."""


def _lib():
    return build.load_host("host_image")


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def to_gray(rgb: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] RGB -> [...] luma, with cv2 RGB2GRAY's fixed point."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    y = (r * _LUMA[0] + g * _LUMA[1] + b * _LUMA[2] + (1 << 14)) >> 15
    return y.astype(np.uint8)


def to_grayscale_3ch(image: np.ndarray) -> np.ndarray:
    """Luminance replicated to 3 channels (``data.force_grayscale``)."""
    gray = to_gray(image) if image.ndim == 3 and image.shape[2] == 3 \
        else image
    return np.stack([gray] * 3, axis=-1)


# ---------------------------------------------------------------------------
# PNG decode
# ---------------------------------------------------------------------------
def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise _Corrupt("truncated chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise _Corrupt(f"CRC mismatch in {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise _Corrupt("no IEND chunk")


def _unpack_bits(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """[H, rowbytes] packed samples of ``depth`` < 8 bits -> [H, width]."""
    bits = np.unpackbits(rows, axis=1)
    bits = bits[:, :width * depth].reshape(rows.shape[0], width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)


def decode_png(data: bytes, gray: bool, name: str = "<bytes>"
               ) -> np.ndarray:
    """Decode PNG bytes to uint8 RGB [H, W, 3] or, with ``gray``, [H, W].
    Raises ``ValueError`` on an interlaced image and ``_Corrupt`` on a
    stream that cannot be decoded."""
    if not data.startswith(PNG_SIGNATURE):
        raise _Corrupt("not a PNG")
    hdr, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise _Corrupt("bad IHDR")
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise _Corrupt("no IHDR")
    width, height, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise ValueError(f"{name}: interlaced PNGs are not supported")
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16) or (
            depth < 8 and ctype not in (0, 3)) or (depth == 16 and ctype == 3):
        raise _Corrupt(f"colour type {ctype} at {depth} bits")
    if width == 0 or height == 0 or (ctype == 3 and palette is None):
        raise _Corrupt("empty image or missing palette")
    ch = _CHANNELS[ctype]
    rowbytes = (width * ch * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise _Corrupt(str(e)) from None
    if len(raw) < height * (rowbytes + 1):
        raise _Corrupt("image data too short")
    rows = np.empty((height, rowbytes), np.uint8)
    bad = _lib().png_unfilter(raw, _u8p(rows), height, rowbytes,
                              max(1, ch * depth // 8))
    if bad:
        raise _Corrupt(f"filter type {raw[(bad - 1) * (rowbytes + 1)]} in "
                       f"row {bad - 1}")
    if depth == 16:  # big-endian samples: keep the high byte
        px = rows.reshape(height, width, ch, 2)[..., 0]
    elif depth == 8:
        px = rows.reshape(height, width, ch)
    else:
        px = _unpack_bits(rows, depth, width)[..., None]
        if ctype == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette[:256]
        px = pal[px[..., 0]]
    elif ctype in (4, 6):
        px = px[..., :-1]
    if gray:
        return to_gray(px) if px.shape[-1] == 3 else px[..., 0].copy()
    if px.shape[-1] == 1:
        return np.repeat(px, 3, axis=-1)
    return np.ascontiguousarray(px)


def _read(path: str, gray: bool) -> Optional[np.ndarray]:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data.startswith(PNG_SIGNATURE):
        try:
            return decode_png(data, gray, path)
        except _Corrupt:
            return None
    return _read_other(path, data, gray)


def _read_other(path: str, data: bytes, gray: bool) -> Optional[np.ndarray]:
    """A file that is not a PNG, through cv2 or else PIL."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        if img is None or gray:
            return img
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"{path}: not a PNG, and neither cv2 nor PIL is "
                         "installed to decode it") from None
    import io

    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("L" if gray else "RGB"))
    except (OSError, ValueError):
        return None


def read_image(path: str) -> Optional[np.ndarray]:
    """Decode an image file to RGB uint8 [H, W, 3]; None on failure."""
    return _read(path, gray=False)


def read_mask(path: str) -> Optional[np.ndarray]:
    """Decode a mask file to uint8 [H, W]; None on failure."""
    return _read(path, gray=True)


# ---------------------------------------------------------------------------
# PNG encode
# ---------------------------------------------------------------------------
def _filter_rows(px: np.ndarray, bpp: int) -> np.ndarray:
    """Filter [H, rowbytes] uint8 rows with type (row % 5); returns the
    [H, 1 + rowbytes] stream."""
    h, n = px.shape
    x = px.astype(np.int16)
    up_all = np.zeros_like(x)
    up_all[1:] = x[:-1]
    out = np.empty((h, n + 1), np.uint8)
    out[:, 0] = np.arange(h) % 5
    for t in range(5):
        cur, up = x[t::5], up_all[t::5]
        left = np.zeros_like(cur)
        left[:, bpp:] = cur[:, :-bpp]
        if t == 0:
            pred = 0
        elif t == 1:
            pred = left
        elif t == 2:
            pred = up
        elif t == 3:
            pred = (left + up) >> 1
        else:
            upleft = np.zeros_like(cur)
            upleft[:, bpp:] = up[:, :-bpp]
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        out[t::5, 1:] = (cur - pred).astype(np.uint8)
    return out


def encode_png(array: np.ndarray, level: int = 1) -> bytes:
    """uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG."""
    a = np.ascontiguousarray(array)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png: need uint8, got {a.dtype}")
    if a.ndim == 2:
        ctype, ch = 0, 1
    elif a.ndim == 3 and a.shape[2] in (3, 4):
        ctype, ch = (2, 3) if a.shape[2] == 3 else (6, 4)
    else:
        raise ValueError(f"write_png: need [H, W], [H, W, 3] or [H, W, 4], "
                         f"got {a.shape}")
    h, w = a.shape[:2]
    stream = _filter_rows(a.reshape(h, w * ch), ch)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(stream.tobytes(), max(1, level)))
            + chunk(b"IEND", b""))


def write_png(path: str, array: np.ndarray, level: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(array, level))


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------
def _resize(img: np.ndarray, dh: int, dw: int, fn) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    sh, sw = img.shape[:2]
    ch = img.shape[2] if img.ndim == 3 else 1
    out = np.empty((dh, dw) + img.shape[2:], np.uint8)
    fn(_u8p(img), sh, sw, ch, _u8p(out), dh, dw)
    return out


def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Bilinear uint8 HWC (or HW) resize, cv2 INTER_LINEAR's conventions."""
    return _resize(img, dh, dw, _lib().resize_bilinear_u8)


def resize_nearest(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Nearest uint8 HWC (or HW) resize, as cv2 INTER_NEAREST."""
    return _resize(img, dh, dw, _lib().resize_nearest_u8)


def resize_batch(images: Sequence[np.ndarray], dh: int, dw: int,
                 bilinear: bool = True, num_threads: int = 8) -> np.ndarray:
    """Resize a list of uint8 images with one channel count to one
    [N, dh, dw(, C)] batch on the helper's thread pool (one call, one GIL
    release for the batch)."""
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    n = len(images)
    ch = images[0].shape[2] if images[0].ndim == 3 else 1
    if any((im.shape[2] if im.ndim == 3 else 1) != ch for im in images):
        raise ValueError("resize_batch: images differ in channel count")
    out = np.empty((n, dh, dw, ch), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ptrs = (u8p * n)(*[_u8p(im) for im in images])
    shs = (ctypes.c_int * n)(*[im.shape[0] for im in images])
    sws = (ctypes.c_int * n)(*[im.shape[1] for im in images])
    _lib().resize_batch_u8(ptrs, shs, sws, ch, _u8p(out), n, dh, dw,
                           int(bilinear), num_threads)
    return out[..., 0] if images[0].ndim == 2 else out
