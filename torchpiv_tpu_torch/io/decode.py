"""Grayscale image decoding (numpy).

Copy of ``torchpiv_tpu/io/decode.py``: a zero-copy numpy decoder for 8-bit
grayscale/paletted BMP first, then cv2, imageio or PIL where installed.  All
return ``uint8 [H, W]`` arrays.  ``imwrite_gray`` writes BMP with numpy
alone, so synthetic folders can be made where no image library is
installed.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover - optional
    cv2 = None


def decode_bmp_gray8(buf: np.ndarray) -> Optional[np.ndarray]:
    """Fast path for uncompressed 8-bit BMP with a grayscale palette.

    Returns None if the buffer is not such a BMP (caller falls back).
    """
    if buf.size < 54 or buf[0] != 0x42 or buf[1] != 0x4D:  # 'BM'
        return None
    hdr = buf[:54].tobytes()
    data_offset = int.from_bytes(hdr[10:14], "little")
    dib_size = int.from_bytes(hdr[14:18], "little")
    if dib_size < 40:
        return None
    width = int.from_bytes(hdr[18:22], "little", signed=True)
    height = int.from_bytes(hdr[22:26], "little", signed=True)
    bpp = int.from_bytes(hdr[28:30], "little")
    compression = int.from_bytes(hdr[30:34], "little")
    if bpp != 8 or compression != 0 or width <= 0:
        return None
    # verify the palette is grayscale (identity ramp)
    pal_off = 14 + dib_size
    palette = buf[pal_off : pal_off + 1024]
    if palette.size == 1024:
        pal = palette.reshape(256, 4)
        if not (pal[:, 0] == pal[:, 1]).all() or not (pal[:, 1] == pal[:, 2]).all():
            return None
        ramp = pal[:, 0]
    else:
        return None
    stride = (width + 3) & ~3  # rows padded to 4 bytes
    flip = height > 0  # positive height = bottom-up storage
    h = abs(height)
    if data_offset + stride * h > buf.size:
        # truncated pixel data (camera mid-write): unreadable, not a crash
        return None
    px = buf[data_offset : data_offset + stride * h].reshape(h, stride)[:, :width]
    img = ramp[px] if not (ramp == np.arange(256, dtype=np.uint8)).all() else px
    return img[::-1].copy() if flip else img.copy()


def imread_gray(path: str) -> Optional[np.ndarray]:
    """Read any supported image as uint8 grayscale; None if unreadable
    (unreadable pairs are skipped upstream)."""
    try:
        buf = np.fromfile(path, dtype=np.uint8)
    except OSError:
        return None
    if buf.size == 0:
        return None
    img = decode_bmp_gray8(buf)
    if img is not None:
        return img
    if cv2 is not None:
        img = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
        if img is not None:
            return np.asarray(img, dtype=np.uint8)
    try:
        import imageio.v3 as iio

        img = iio.imread(path)
    except Exception:
        try:
            from PIL import Image

            img = np.asarray(Image.open(path).convert("L"))
        except Exception:
            return None
    img = np.asarray(img)
    if img.ndim == 3:
        # BT.601 luma, same weights cv2 uses for grayscale conversion.
        img = (
            0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
            if img.shape[-1] == 3
            else img[..., 0]
        )
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return img


def encode_bmp_gray8(img: np.ndarray) -> bytes:
    """Uncompressed bottom-up 8-bit BMP with an identity grayscale palette."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    stride = (w + 3) & ~3
    data_offset = 14 + 40 + 1024
    size = data_offset + stride * h
    header = (b"BM" + size.to_bytes(4, "little") + bytes(4)
              + data_offset.to_bytes(4, "little"))
    dib = (
        (40).to_bytes(4, "little") + w.to_bytes(4, "little", signed=True)
        + h.to_bytes(4, "little", signed=True) + (1).to_bytes(2, "little")
        + (8).to_bytes(2, "little") + bytes(4)
        + (stride * h).to_bytes(4, "little") + bytes(8)
        + (256).to_bytes(4, "little") + bytes(4)
    )
    palette = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
    palette[:, 3] = 0
    rows = np.zeros((h, stride), dtype=np.uint8)
    rows[:, :w] = img[::-1]
    return header + dib + palette.tobytes() + rows.tobytes()


def imwrite_gray(path: str, img: np.ndarray) -> None:
    """Write a uint8 grayscale image (format from the extension; BMP with
    numpy alone, others through cv2 or PIL)."""
    img = np.asarray(img, dtype=np.uint8)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp":
        with open(path, "wb") as f:
            f.write(encode_bmp_gray8(img))
        return
    if cv2 is not None:
        ok, enc = cv2.imencode(ext, img)
        if ok:
            enc.tofile(path)
            return
    from PIL import Image

    Image.fromarray(img, mode="L").save(path)
