"""ctypes bindings of the repo's native fastloader (``native/libfastloader.so``).

The port's copy of the JAX package's ``data/native.py``: multithreaded,
GIL-free host-side data helpers, each with a numpy fallback that runs when
the library is not built (``native/build.sh`` builds it with g++):

* bilinear resize, normalise, and the fused cover-resize + crop + normalise
  of an image;
* the threaded ``.npy`` batch load of pre-extracted latents.

This is host code: no tensor and no device is involved.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

__all__ = ["available", "resize_bilinear_u8", "crop_resize_norm",
           "batch_load_npy", "u8_to_f32_norm"]

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "libfastloader.so")


def _load(path: str):
    """The library at ``path`` with its signatures declared, or None."""
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.pf_resize_bilinear_u8.argtypes = [ptr, i64, i64, i64, ptr, i64, i64]
    lib.pf_resize_bilinear_u8.restype = None
    lib.pf_u8_to_f32_norm.argtypes = [ptr, ptr, i64]
    lib.pf_u8_to_f32_norm.restype = None
    lib.pf_crop_resize_norm.argtypes = [ptr, i64, i64, i64, ptr, i64, i64,
                                        i64, i64]
    lib.pf_crop_resize_norm.restype = ctypes.c_int
    lib.pf_batch_load_npy.argtypes = [ctypes.POINTER(ctypes.c_char_p), i64,
                                      ptr, i64, ctypes.c_int]
    lib.pf_batch_load_npy.restype = ctypes.c_int
    return lib


_lib = _load(_LIB_PATH)


def available() -> bool:
    return _lib is not None


def resize_bilinear_u8(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """uint8 [H, W, C] -> [oh, ow, C], bilinear with align_corners=False."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((oh, ow, c), np.uint8)
    if _lib is not None:
        _lib.pf_resize_bilinear_u8(img.ctypes.data, h, w, c, out.ctypes.data,
                                   oh, ow)
        return out
    fy = np.clip((np.arange(oh) + 0.5) * h / oh - 0.5, 0, h - 1)
    fx = np.clip((np.arange(ow) + 0.5) * w / ow - 0.5, 0, w - 1)
    y0 = fy.astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x0 = fx.astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0)[:, None, None]
    wx = (fx - x0)[None, :, None]
    imgf = img.astype(np.float32)
    top = imgf[y0][:, x0] * (1 - wx) + imgf[y0][:, x1] * wx
    bot = imgf[y1][:, x0] * (1 - wx) + imgf[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy + 0.5).astype(np.uint8)


def u8_to_f32_norm(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1] (``x / 127.5 - 1``)."""
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty(img.shape, np.float32)
    if _lib is not None:
        _lib.pf_u8_to_f32_norm(img.ctypes.data, out.ctypes.data, img.size)
        return out
    return img.astype(np.float32) / 127.5 - 1.0


def crop_resize_norm(img: np.ndarray, th: int, tw: int,
                     top: int, left: int) -> np.ndarray:
    """Cover-resize, crop at (top, left) and normalise: uint8 [H, W, C] ->
    float32 [th, tw, C]."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((th, tw, c), np.float32)
    if _lib is not None:
        rc = _lib.pf_crop_resize_norm(img.ctypes.data, h, w, c,
                                      out.ctypes.data, th, tw, top, left)
        if rc == 0:
            return out
    scale = max(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_bilinear_u8(img, nh, nw)
    return u8_to_f32_norm(resized[top: top + th, left: left + tw])


def batch_load_npy(paths: Sequence[str], item_shape,
                   num_threads: int = 8) -> np.ndarray:
    """float32 or float16 ``.npy`` files -> one float32 [N, *item_shape]
    batch; numpy loads them when the library is missing or fails on any."""
    n = len(paths)
    elems = int(np.prod(item_shape))
    out = np.empty((n, *item_shape), np.float32)
    if _lib is not None:
        names = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        if _lib.pf_batch_load_npy(names, n, out.ctypes.data, elems,
                                  num_threads) == 0:
            return out
    for i, p in enumerate(paths):
        out[i] = np.load(p).astype(np.float32).reshape(item_shape)
    return out
