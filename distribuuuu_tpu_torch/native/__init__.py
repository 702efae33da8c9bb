"""The host decoder's build and ctypes binding (counterpart of
distribuuuu_tpu/native/__init__.py).

``decode.cc`` (the port's own copy) is libjpeg/libpng decode, a
PIL-compatible resampler, normalization and a ``std::thread`` pool: one
call per batch that holds no Python lock. It is built with ``g++`` at
first use into ``distribuuuu_tpu_torch/_build/`` under a name keyed by a
hash of the source, through a per-process temporary file renamed into
place, so ranks that build at once never load a half-written library.
Without a toolchain or the libjpeg/libpng headers ``available()`` is
False and ``build_error()`` says why; ``data/imagefolder.py`` and
``data/shards/reader.py`` decide what that means for ``DATA.BACKEND``.
Files are decoded by path (``load_batch``, ``load_batch_u8``), shard
records from memory (``load_batch_mem``, ``load_batch_u8_mem``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "decode.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")
_ABI_VERSION = 4
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


class Geom(ctypes.Structure):
    """Mirror of decode.cc's Geom: one resample geometry per image."""

    _fields_ = [
        ("box_x", ctypes.c_double),
        ("box_y", ctypes.c_double),
        ("scale_x", ctypes.c_double),
        ("scale_y", ctypes.c_double),
        ("out_x0", ctypes.c_int32),
        ("out_y0", ctypes.c_int32),
        ("flip", ctypes.c_int32),
        ("_pad", ctypes.c_int32),
    ]


GEOM_DTYPE = np.dtype([
    ("box_x", np.float64),
    ("box_y", np.float64),
    ("scale_x", np.float64),
    ("scale_y", np.float64),
    ("out_x0", np.int32),
    ("out_y0", np.int32),
    ("flip", np.int32),
    ("_pad", np.int32),
])


def library_path() -> str:
    """Where the build of this source lands."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_CXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libdtpu_decode-{digest[:16]}.so")


def _build(lib_path: str) -> str | None:
    """Compile decode.cc into ``lib_path``; the error text, or None."""
    if os.path.exists(lib_path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = ["g++", *_CXX_FLAGS, _SRC, "-o", tmp, "-ljpeg", "-lpng"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"native build failed to launch: {exc}"
    if proc.returncode != 0:
        return f"native build failed:\n{proc.stderr[-2000:]}"
    os.replace(tmp, lib_path)
    return None


def _declare(lib) -> None:
    lib.dtpu_file_dims.restype = ctypes.c_int
    lib.dtpu_file_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
                                   ctypes.POINTER(ctypes.c_int32)]
    lib.dtpu_load_batch.restype = None
    lib.dtpu_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.dtpu_load_batch_u8.restype = None
    lib.dtpu_load_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
    ]
    # the in-memory entry points (shard records)
    lib.dtpu_mem_dims.restype = ctypes.c_int
    lib.dtpu_mem_dims.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.dtpu_load_batch_mem.restype = None
    lib.dtpu_load_batch_mem.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.dtpu_load_batch_u8_mem.restype = None
    lib.dtpu_load_batch_u8_mem.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
    ]


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        err = _build(path)
        if err is not None:
            _build_error = err
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            _build_error = f"native lib load failed: {exc}"
            return None
        lib.dtpu_abi_version.restype = ctypes.c_int
        if lib.dtpu_abi_version() != _ABI_VERSION:
            _build_error = f"native ABI mismatch in {path}"
            return None
        _declare(lib)
        _lib = lib
        return _lib


def available() -> bool:
    """True when the decoder built and loaded (builds on the first call)."""
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def file_dims(path: str) -> tuple[int, int] | None:
    """``(width, height)`` from the image header, or None if unsupported."""
    lib = _load()
    if lib is None:
        return None
    w, h = ctypes.c_int32(), ctypes.c_int32()
    if lib.dtpu_file_dims(path.encode(), ctypes.byref(w), ctypes.byref(h)):
        return None
    return w.value, h.value


def _batch_args(paths: list[str], geoms: np.ndarray):
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decode unavailable: {_build_error}")
    n = len(paths)
    geoms = np.ascontiguousarray(geoms, GEOM_DTYPE)
    if geoms.shape != (n,):
        raise ValueError(f"{geoms.shape[0]} geometries for {n} paths")
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    return lib, n, geoms, c_paths


def load_batch(paths: list[str], geoms: np.ndarray, out_size: tuple[int, int],
               mean: np.ndarray, std: np.ndarray, n_threads: int):
    """Decode, resample and normalize a batch: ``(images [n, h, w, 3]
    float32, statuses [n])``. A nonzero status marks an image the decoder
    could not take (another format, CMYK, alpha, corrupt); the caller redoes
    it through PIL."""
    lib, n, geoms, c_paths = _batch_args(paths, geoms)
    out_h, out_w = out_size
    images = np.empty((n, out_h, out_w, 3), np.float32)
    statuses = np.empty((n,), np.int32)
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    lib.dtpu_load_batch(
        c_paths, geoms.ctypes.data_as(ctypes.c_void_p), n, out_w, out_h,
        mean32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return images, statuses


def load_batch_u8(paths: list[str], geoms: np.ndarray, out_size: tuple[int, int],
                  n_threads: int):
    """The uint8 batch of ``DATA.DEVICE_NORMALIZE``: decode, resample and
    flip, no normalization. ``(images [n, h, w, 3] uint8, statuses [n])``."""
    lib, n, geoms, c_paths = _batch_args(paths, geoms)
    out_h, out_w = out_size
    images = np.empty((n, out_h, out_w, 3), np.uint8)
    statuses = np.empty((n,), np.int32)
    lib.dtpu_load_batch_u8(
        c_paths, geoms.ctypes.data_as(ctypes.c_void_p), n, out_w, out_h, n_threads,
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return images, statuses


def has_mem_api() -> bool:
    """True when the loaded decoder has the in-memory entry points. ABI 4
    has them and ``_load`` checks the ABI, so this is ``available()``;
    the shards reader asks it by this name."""
    return available()


def mem_dims(data: bytes) -> tuple[int, int] | None:
    """``(width, height)`` of an in-memory encoded image, or None."""
    lib = _load()
    if lib is None or not data:
        return None
    w, h = ctypes.c_int32(), ctypes.c_int32()
    if lib.dtpu_mem_dims(data, len(data), ctypes.byref(w), ctypes.byref(h)):
        return None
    return w.value, h.value


def _mem_args(bufs: list[bytes], geoms: np.ndarray):
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decode unavailable: {_build_error}")
    n = len(bufs)
    geoms = np.ascontiguousarray(geoms, GEOM_DTYPE)
    if geoms.shape != (n,):
        raise ValueError(f"{geoms.shape[0]} geometries for {n} buffers")
    c_bufs = (ctypes.c_char_p * n)(*bufs)
    c_lens = (ctypes.c_int64 * n)(*[len(b) for b in bufs])
    return lib, n, geoms, c_bufs, c_lens


def load_batch_mem(bufs: list[bytes], geoms: np.ndarray, out_size: tuple[int, int],
                   mean: np.ndarray, std: np.ndarray, n_threads: int):
    """:func:`load_batch` over in-memory encoded buffers (shard records).
    An empty buffer fails at once with a nonzero status: the caller's mark
    for an image it decodes through PIL."""
    lib, n, geoms, c_bufs, c_lens = _mem_args(bufs, geoms)
    out_h, out_w = out_size
    images = np.empty((n, out_h, out_w, 3), np.float32)
    statuses = np.empty((n,), np.int32)
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    lib.dtpu_load_batch_mem(
        c_bufs, c_lens, geoms.ctypes.data_as(ctypes.c_void_p), n, out_w, out_h,
        mean32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return images, statuses


def load_batch_u8_mem(bufs: list[bytes], geoms: np.ndarray, out_size: tuple[int, int],
                      n_threads: int):
    """:func:`load_batch_u8` over in-memory encoded buffers."""
    lib, n, geoms, c_bufs, c_lens = _mem_args(bufs, geoms)
    out_h, out_w = out_size
    images = np.empty((n, out_h, out_w, 3), np.uint8)
    statuses = np.empty((n,), np.int32)
    lib.dtpu_load_batch_u8_mem(
        c_bufs, c_lens, geoms.ctypes.data_as(ctypes.c_void_p), n, out_w, out_h, n_threads,
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return images, statuses
