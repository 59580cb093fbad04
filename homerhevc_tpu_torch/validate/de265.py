"""Conformance validation: decode Annex-B HEVC with the system libde265.

The port's own copy of homerhevc_tpu/validate/de265.py: the analog of the
C reference's external decode-and-compare quality strategy (`-o-raw` recon
dumps compared against a conformance decoder). We feed the produced .265
stream to libde265 via
ctypes and compare the decoded planes bit-exactly against the encoder's own
reconstruction.

Test/validation only — not on any encode path.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

_LIB_CANDIDATES = ["libde265.so.0", "libde265.so"]


def _load():
    for name in _LIB_CANDIDATES:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            lib = None
    if lib is None:
        return None
    lib.de265_new_decoder.restype = ctypes.c_void_p
    lib.de265_push_data.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    lib.de265_flush_data.argtypes = [ctypes.c_void_p]
    lib.de265_decode.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.de265_get_next_picture.restype = ctypes.c_void_p
    lib.de265_get_next_picture.argtypes = [ctypes.c_void_p]
    lib.de265_release_next_picture.argtypes = [ctypes.c_void_p]
    lib.de265_get_image_width.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.de265_get_image_height.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.de265_get_image_plane.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.de265_get_image_plane.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.de265_free_decoder.argtypes = [ctypes.c_void_p]
    lib.de265_get_error_text.restype = ctypes.c_char_p
    return lib


_lib = _load()


def available() -> bool:
    return _lib is not None


def decode_annexb(data: bytes, max_frames: int = 10000):
    """Decode an Annex-B byte stream; returns list of (y, u, v) uint8 frames.

    Raises RuntimeError on decoder errors.
    """
    if _lib is None:
        raise RuntimeError("libde265 not available")
    ctx = _lib.de265_new_decoder()
    frames = []
    errors = []
    try:
        err = _lib.de265_push_data(ctx, data, len(data), 0, None)
        if err != 0:
            raise RuntimeError(f"de265_push_data: {_lib.de265_get_error_text(err).decode()}")
        _lib.de265_flush_data(ctx)
        more = ctypes.c_int(1)
        while more.value and len(frames) < max_frames:
            err = _lib.de265_decode(ctx, ctypes.byref(more))
            if err not in (0, 1007):  # 1007 = DE265_ERROR_WAITING_FOR_INPUT_DATA
                errors.append(_lib.de265_get_error_text(err).decode())
                if err != 0 and len(errors) > 16:
                    break
            img = _lib.de265_get_next_picture(ctx)
            while img:
                planes = []
                for c in range(3):
                    w = _lib.de265_get_image_width(img, c)
                    h = _lib.de265_get_image_height(img, c)
                    stride = ctypes.c_int(0)
                    ptr = _lib.de265_get_image_plane(img, c, ctypes.byref(stride))
                    buf = np.ctypeslib.as_array(ptr, shape=(h, stride.value))
                    planes.append(buf[:, :w].copy())
                frames.append(tuple(planes))
                _lib.de265_release_next_picture(ctx)
                img = _lib.de265_get_next_picture(ctx)
        if errors:
            raise RuntimeError("decoder reported errors: " + "; ".join(errors[:4]))
        return frames
    finally:
        _lib.de265_free_decoder(ctx)
