"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. Nothing
includes PyTorch's headers, so a build takes seconds. The library lands in
``distribuuuu_tpu_torch/_build/`` (listed in ``.gitignore``) under a name
keyed by a hash of the source, the ``csrc/`` headers it includes
(``#include "…"``, followed through the headers) and the flags, so an
edited source or header rebuilds and an unchanged one loads what is
there (the port's persistent compile cache: each load from ``_build/``
lands a ``kind="compile.cache"`` record ``"hit"``, each build a
``"miss"``, ``telemetry/runtime.on_build``). A missing ``nvcc`` or a
failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

from distribuuuu_tpu_torch.telemetry import runtime as telemetry_runtime

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers, spills and shared memory, in build_logs
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# seconds each source took to compile in this process (0.0 = loaded as built)
build_seconds: dict[str, float] = {}
# nvcc's output of each source compiled in this process (ptxas' -v report)
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from distribuuuu_tpu_torch/csrc at "
        "first use and there is no prebuilt fallback"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[str]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, directly
    or through another header, in the order first met."""
    todo, seen = [os.path.join(CSRC, f"{name}.cu")], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            todo += [os.path.join(CSRC, inc.decode()) for inc in _INCLUDE.findall(f.read())]
    return seen


def _target(name: str) -> tuple[str, str]:
    digest = hashlib.sha256()
    for path in sources(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    src = os.path.join(CSRC, f"{name}.cu")
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(*names: str) -> dict[str, ctypes.CDLL]:
    """Build (all at once, one ``nvcc`` a source) and load each named
    source; returns ``{name: CDLL}``. Raises on any failed build."""
    with _lock:
        todo = [n for n in names if n not in _loaded]
        procs = {}
        os.makedirs(BUILD_DIR, exist_ok=True)
        for n in todo:
            src, lib = _target(n)
            if os.path.exists(lib):
                build_seconds[n] = 0.0
                telemetry_runtime.on_build(n, hit=True)
                continue
            telemetry_runtime.on_build(n, hit=False)
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
            procs[n] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
            ), tmp, lib, time.perf_counter())
        errors = []
        for n, (proc, tmp, lib, t0) in procs.items():
            log, _ = proc.communicate()
            build_seconds[n] = time.perf_counter() - t0
            build_logs[n] = log.decode()
            if proc.returncode != 0:
                errors.append(f"{n}.cu (exit {proc.returncode}):\n{log.decode()}")
                continue
            os.replace(tmp, lib)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        for n in todo:
            _loaded[n] = ctypes.CDLL(_target(n)[1])
        return {n: _loaded[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built at first use."""
    lib = _loaded.get(name)
    return lib if lib is not None else build(name)[name]
