"""Image IO on the host: texture decode and framebuffer PNG write.

Replaces the reference's stb_image wrapper (`ImageLoader.cpp:8-19`, floats in
[0,1]) and the on-screen blit with a PNG writer.  Uses PIL when present and
falls back to a minimal PNG codec on `zlib`, so that the package has no hard
dependency beyond numpy and the committed PNG inputs (the env map) decode
everywhere."""
from __future__ import annotations

import struct
import zlib
import numpy as np

try:
    from PIL import Image as _PILImage
    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False


class ImageDecodeError(OSError):
    """An image file is missing or cannot be decoded."""


def load_image(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 4) float32 RGBA in [0,1].

    PNG decodes without Pillow; other formats need it.  Raises
    ImageDecodeError when the file is missing or undecodable."""
    if _HAVE_PIL:
        try:
            with _PILImage.open(path) as im:
                return np.asarray(im.convert("RGBA"),
                                  dtype=np.float32) / 255.0
        except Exception as exc:
            raise ImageDecodeError(f"cannot decode {path}: {exc}") from exc
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as exc:
        raise ImageDecodeError(f"cannot read {path}: {exc}") from exc
    rgba = decode_png(data)
    return rgba.astype(np.float32) / 255.0


def decode_png(data: bytes) -> np.ndarray:
    """Decode 8-bit, non-interlaced RGB/RGBA/grey PNG bytes to (H, W, 4)
    uint8.  Raises ImageDecodeError for anything else."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ImageDecodeError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ImageDecodeError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype)
    if depth != 8 or interlace or channels is None:
        raise ImageDecodeError(
            f"unsupported PNG (depth {depth}, colour type {ctype}, "
            f"interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * channels
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:  # Sub, Average and Paeth depend on the reconstructed left byte
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                b = prev[x]
                c = prev[x - channels] if x >= channels else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                elif ftype == 4:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                else:
                    raise ImageDecodeError(f"bad PNG filter {ftype}")
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    img = out.astype(np.uint8).reshape(h, w, channels)
    if channels < 3:  # grey (+ alpha)
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=2),
                              img[..., 1:]], axis=2)
    if img.shape[2] == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)],
                             axis=2)
    return img


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    chunk = tag + data
    return (struct.pack(">I", len(data)) + chunk
            + struct.pack(">I", zlib.crc32(chunk) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """Encode an (H, W, 3|4) float [0,1] or uint8 array as PNG bytes
    (the live viewer serves these over HTTP; `write_png` wraps this)."""
    arr = np.asarray(rgb)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if _HAVE_PIL:
        import io as _io
        buf = _io.BytesIO()
        _PILImage.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()
    return encode_png_plain(arr)


def encode_png_plain(arr: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, 3|4) uint8 array through `zlib` alone, with
    no row filters: the output depends on nothing but the pixels."""
    h, w = arr.shape[:2]
    channels = arr.shape[2]
    color_type = {3: 2, 4: 6}[channels]
    raw = b"".join(b"\x00" + arr[row].tobytes() for row in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                              color_type, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W, 4) float [0,1] or uint8 array as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def read_png(path: str) -> np.ndarray:
    """Read an image to (H, W, 3) float32 RGB in [0,1]."""
    return load_image(path)[:, :, :3]
