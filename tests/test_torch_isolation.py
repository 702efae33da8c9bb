"""The port stands alone: distribuuuu_tpu_torch, chip_smoke.py and
flash_fwd_sweep.py import neither JAX (jax, jaxlib, flax, optax, orbax,
and orbax's tensorstore and zstandard) nor anything of the JAX package
distribuuuu_tpu — checked both by
importing every module in a fresh interpreter and by scanning the
source — and load no file of it: the port's decoder is its own copy,
built into distribuuuu_tpu_torch/_build, never the JAX package's
_libdtpu_decode.so, for ImageFolder files and for shard records alike."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "distribuuuu_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard",
             "distribuuuu_tpu")


def _sources():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "flash_fwd_sweep.py")


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import distribuuuu_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke, flash_fwd_sweep\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(len(mods), bad)\n"
        "assert not bad, bad\n"
    ) % (FORBIDDEN,)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_mods = int(r.stdout.split()[0])
    assert n_mods >= 21, r.stdout


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {n}"


@pytest.mark.parametrize("module", ["asyncplane/__init__.py", "asyncplane/committer.py",
                                    "asyncplane/evalloop.py", "resilience/manifest.py",
                                    "resilience/supervisor.py", "utils/faults.py",
                                    "data/shards/__init__.py", "data/shards/format.py",
                                    "data/shards/order.py", "data/shards/reader.py",
                                    "data/shards/pack.py"])
def test_the_train_loop_modules_are_scanned(module):
    """The port's own copies of the JAX package's JAX-free train-loop and
    shards modules (``data/shards/order.py`` is numpy only in both) are
    among the scanned sources (so neither test above skips them)."""
    assert os.path.join(PKG, module) in set(_sources())


def test_the_port_loads_no_file_of_the_jax_package(tmp_path):
    """Build and run the port's decoder in a fresh interpreter, then look
    at every mapped file and every imported module: none lies under
    distribuuuu_tpu/."""
    code = (
        "import os, sys, numpy as np\n"
        "from PIL import Image\n"
        "from distribuuuu_tpu_torch import native\n"
        "from distribuuuu_tpu_torch.data.imagefolder import ImageFolderDataset\n"
        "d = os.path.join(sys.argv[1], 'train', 'x'); os.makedirs(d)\n"
        "Image.fromarray(np.zeros((40, 50, 3), np.uint8)).save(os.path.join(d, 'a.jpg'))\n"
        "assert native.available(), native.build_error()\n"
        "ds = ImageFolderDataset(sys.argv[1], 'train', 32, True, backend='native')\n"
        "assert ds.load_batch([0])[0].shape == (1, 32, 32, 3)\n"
        "from distribuuuu_tpu_torch.data.shards import ShardDataset, pack_imagefolder\n"
        "pack_imagefolder(sys.argv[1], os.path.join(sys.argv[1], 'packed'), ('train',))\n"
        "sd = ShardDataset(os.path.join(sys.argv[1], 'packed'), 'train', 32, True, "
        "backend='native')\n"
        "assert sd.load_batch([0])[0].shape == (1, 32, 32, 3)\n"
        "jax_pkg = os.path.join(os.getcwd(), 'distribuuuu_tpu') + os.sep\n"
        "maps = [l.split()[-1] for l in open('/proc/self/maps') if '/' in l]\n"
        "files = maps + [getattr(m, '__file__', None) or '' for m in list(sys.modules.values())]\n"
        "bad = sorted({f for f in files if os.path.realpath(f).startswith(jax_pkg)})\n"
        "print(native.library_path(), bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.join("distribuuuu_tpu_torch", "_build", "libdtpu_decode-") in r.stdout


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_source_names_no_library_of_the_jax_package(path):
    src = open(path).read()
    assert "_libdtpu_decode" not in src
