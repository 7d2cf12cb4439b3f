"""Image file -> array loading (JAX counterpart
deeplearning4j_tpu/util/image_loader.py; the port's own copy of that
numpy module; reference util/ImageLoader.java).

The reference flattens images row-major into INDArrays with optional
resize (`ImageLoader.java: asRowVector/asMatrix/toImage`); here images
load into NHWC float32 host arrays in [0, 1], the layout the port's conv
layers take (they move batches to their device).

Backed by Pillow when it imports; otherwise the built-in PPM/PGM codec
does all of it: `save` writes PNM bytes whatever the file's extension
(a `.png` name included) and `as_array` reads them back, so a corpus
written without Pillow is read without it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

try:
    from PIL import Image

    _HAVE_PIL = True
except Exception:  # the PNM codec below does all of it
    _HAVE_PIL = False


def _read_pnm(path: str) -> np.ndarray:
    """Minimal PPM (P6) / PGM (P5) decoder — the no-dependency fallback."""
    with open(path, "rb") as f:
        data = f.read()
    fields: list = []
    i = 0
    while len(fields) < 4:
        if data[i:i + 1] == b"#":
            while data[i:i + 1] not in (b"\n", b""):
                i += 1
        elif data[i:i + 1].isspace():
            i += 1
        else:
            j = i
            while not data[j:j + 1].isspace():
                j += 1
            fields.append(data[i:j])
            i = j
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    if maxval != 255:
        raise ValueError(
            f"unsupported PNM maxval {maxval} in {path} (only 8-bit, "
            f"maxval 255, is supported)")
    i += 1  # single whitespace after maxval
    if magic == b"P6":
        arr = np.frombuffer(data, np.uint8, count=w * h * 3, offset=i)
        return arr.reshape(h, w, 3)
    if magic == b"P5":
        arr = np.frombuffer(data, np.uint8, count=w * h, offset=i)
        return arr.reshape(h, w, 1)
    raise ValueError(f"unsupported PNM magic {magic!r} in {path}")


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ih, iw = img.shape[:2]
    ri = (np.arange(h) * ih // h).clip(0, ih - 1)
    ci = (np.arange(w) * iw // w).clip(0, iw - 1)
    return img[ri][:, ci]


class ImageLoader:
    """Loads image files as [H, W, C] float32 arrays in [0, 1].

    height/width: optional resize target; channels: 1 (grayscale) or 3.
    """

    def __init__(self, height: Optional[int] = None,
                 width: Optional[int] = None, channels: int = 3):
        if channels not in (1, 3):
            raise ValueError("channels must be 1 or 3")
        if (height is None) != (width is None):
            raise ValueError("height and width must be set together "
                             "(or both omitted for no resize)")
        self.height = height
        self.width = width
        self.channels = channels

    # ------------------------------------------------------------- loading
    def as_array(self, path: str) -> np.ndarray:
        ext = os.path.splitext(path)[1].lower()
        if _HAVE_PIL and ext not in (".ppm", ".pgm"):
            with Image.open(path) as im:
                im = im.convert("L" if self.channels == 1 else "RGB")
                if self.height and self.width:
                    im = im.resize((self.width, self.height),
                                   Image.BILINEAR)
                arr = np.asarray(im, np.uint8)
        else:
            arr = _read_pnm(path)
            if self.channels == 1 and arr.shape[-1] == 3:
                arr = (arr @ np.array([0.299, 0.587, 0.114]))[..., None]
            elif self.channels == 3 and arr.shape[-1] == 1:
                arr = np.repeat(arr, 3, axis=-1)
            if self.height and self.width:
                arr = _resize_nearest(arr, self.height, self.width)
        if arr.ndim == 2:
            arr = arr[..., None]
        if self.channels == 3 and arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        return np.asarray(arr, np.float32) / 255.0

    def as_row_vector(self, path: str) -> np.ndarray:
        """Flattened [H*W*C] vector (reference asRowVector)."""
        return self.as_array(path).reshape(-1)

    def as_matrix(self, paths) -> np.ndarray:
        """Stack many files into one [N, H, W, C] batch (reference asMatrix)."""
        return np.stack([self.as_array(p) for p in paths])

    # -------------------------------------------------------------- saving
    @staticmethod
    def save(arr: np.ndarray, path: str) -> None:
        """Write a [H, W, C] float array in [0,1] back to an image file."""
        a = np.clip(np.asarray(arr), 0.0, 1.0)
        u8 = (a * 255.0 + 0.5).astype(np.uint8)
        ext = os.path.splitext(path)[1].lower()
        if _HAVE_PIL and ext not in (".ppm", ".pgm"):
            mode = "L" if u8.shape[-1] == 1 else "RGB"
            Image.fromarray(u8[..., 0] if mode == "L" else u8, mode).save(path)
            return
        h, w, c = u8.shape
        with open(path, "wb") as f:
            if c == 1:
                f.write(b"P5\n%d %d\n255\n" % (w, h))
                f.write(u8[..., 0].tobytes())
            else:
                f.write(b"P6\n%d %d\n255\n" % (w, h))
                f.write(u8.tobytes())


def crop_to_square(arr: np.ndarray) -> np.ndarray:
    """Center-crop to square (reference LFW pipeline crops faces)."""
    h, w = arr.shape[:2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return arr[top:top + s, left:left + s]
