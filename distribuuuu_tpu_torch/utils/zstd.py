"""zstd frames decoded through the system's ``libzstd.so.1`` (``ctypes``).

The orbax reader (``utils/orbax.py``) needs zstd for two things: the
OCDBT manifest and B-tree nodes, and the zarr chunks whose ``.zarray``
names the ``zstd`` compressor. The library is loaded on first use; a host
without it gets an error that names it, and there is no second route.
"""

from __future__ import annotations

import ctypes

LIBRARY = "libzstd.so.1"
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2
_lib = None


def _load():
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError:
            raise OSError(
                f"{LIBRARY} (the zstd library) is not on this host: reading an orbax "
                "checkpoint needs it (its nodes and chunks are zstd frames); install the "
                "system's libzstd"
            ) from None
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        _lib = lib
    return _lib


def decompress(data: bytes, size: int | None = None) -> bytes:
    """The content of the zstd frame ``data``. ``size`` is the expected
    content size where the frame header omits it (zarr's chunks do); a
    frame that states its size is held to it."""
    lib = _load()
    stated = lib.ZSTD_getFrameContentSize(data, len(data))
    if stated == _CONTENTSIZE_ERROR:
        raise ValueError("not a zstd frame")
    if stated != _CONTENTSIZE_UNKNOWN:
        if size is not None and stated != size:
            raise ValueError(f"zstd frame holds {stated} bytes, expected {size}")
        size = stated
    cap = size if size is not None else 8 * len(data)
    while True:  # an unsized frame (a large OCDBT node) grows its buffer until it fits
        out = ctypes.create_string_buffer(max(cap, 1))
        n = lib.ZSTD_decompress(out, cap, data, len(data))
        if not lib.ZSTD_isError(n):
            break
        err = lib.ZSTD_getErrorName(n).decode()
        if size is not None or "too small" not in err.lower():
            raise ValueError(f"zstd: {err}")
        cap *= 4
    if size is not None and n != size:
        raise ValueError(f"zstd frame decoded to {n} bytes, expected {size}")
    return out.raw[:n]
