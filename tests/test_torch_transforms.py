"""The port's image transforms (distribuuuu_tpu_torch/data/transforms.py)
against the goldens and against the JAX package's.

* Against ``tests/data/golden_transforms.npz``, as
  tests/test_golden_transforms.py holds JAX's: the val and train
  pipelines within ±2 uint8 counts (``RESAMPLE_ATOL`` in normalized
  space), the RandomResizedCrop boxes, flips and native geometries
  exactly, and the port's native decoder's val output within its
  resampler's bound.
* Against JAX's on the same PIL images: ``val_transform`` and
  ``train_transform``, uint8 and float, byte for byte, and the geometry
  functions value for value.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
from PIL import Image

from distribuuuu_tpu.data import transforms as JT
from distribuuuu_tpu_torch.data import transforms as T

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_transforms.npz")
RESAMPLE_ATOL = 0.035  # ±2 uint8 counts in normalized space: 2/255 / min(std)
NATIVE_ATOL = 0.06  # the decoder's ±3 counts: 3/255 / min(std)
CASES = range(4)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("idx", CASES)
def test_val_pipeline_matches_golden(golden, idx):
    got = T.val_transform(Image.fromarray(golden[f"src_{idx}"]), 48, 32)
    np.testing.assert_allclose(got, golden[f"val_{idx}"], atol=RESAMPLE_ATOL)


@pytest.mark.parametrize("idx", CASES)
def test_train_pipeline_matches_golden(golden, idx):
    got = T.train_transform(Image.fromarray(golden[f"src_{idx}"]), 32,
                            np.random.default_rng(1000 + idx))
    np.testing.assert_allclose(got, golden[f"train_{idx}"], atol=RESAMPLE_ATOL)


def test_rrc_box_and_flip_stream_matches_golden(golden):
    sizes = [tuple(s) for s in golden["sizes"]]
    rng = np.random.default_rng(42)
    boxes, flips = [], []
    for w, h in sizes * 4:
        boxes.append(T.sample_rrc_box(w, h, rng))
        flips.append(1 if rng.random() < 0.5 else 0)
    np.testing.assert_array_equal(np.asarray(boxes, np.int64), golden["boxes"])
    np.testing.assert_array_equal(np.asarray(flips, np.int64), golden["flips"])


def test_train_geom_stream_matches_golden(golden):
    sizes = [tuple(s) for s in golden["sizes"]]
    rng = np.random.default_rng(42)
    geoms = [T.train_geom(w, h, 32, rng) for w, h in sizes * 4]
    np.testing.assert_array_equal(np.asarray(geoms, np.float64), golden["geoms"])


def test_native_val_path_matches_golden(tmp_path, golden):
    from distribuuuu_tpu_torch import native

    assert native.available(), native.build_error()
    for idx in CASES:
        src = golden[f"src_{idx}"]
        path = str(tmp_path / f"g{idx}.png")
        Image.fromarray(src).save(path, "PNG")  # lossless: only the resampler differs
        h, w = src.shape[:2]
        geom = np.asarray([T.val_geom(w, h, 48, 32) + (0,)], native.GEOM_DTYPE)
        images, status = native.load_batch([path], geom, (32, 32), T.IMAGENET_MEAN,
                                           T.IMAGENET_STD, 1)
        assert status[0] == 0
        np.testing.assert_allclose(images[0], golden[f"val_{idx}"], atol=NATIVE_ATOL)


def _image(seed: int, mode: str) -> Image.Image:
    rng = np.random.default_rng(seed)
    w, h = (int(v) for v in rng.integers(20, 90, 2))
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img = Image.fromarray(arr)
    return img.convert("L") if mode == "L" else img


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transforms_are_byte_identical_to_jax(seed, mode, normalize):
    img = _image(seed, mode)
    for crop, resize in ((32, 48), (24, 24), (16, 40)):
        got = T.val_transform(img, resize, crop, normalize=normalize)
        want = JT.val_transform(img, resize, crop, normalize=normalize)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for size in (32, 17):
        got = T.train_transform(img, size, np.random.default_rng(seed), normalize=normalize)
        want = JT.train_transform(img, size, np.random.default_rng(seed), normalize=normalize)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("w,h", [(500, 375), (375, 500), (300, 300), (37, 53), (4000, 60)])
def test_geometries_equal_jax(w, h):
    r1, r2 = np.random.default_rng(w * h), np.random.default_rng(w * h)
    for _ in range(20):
        assert T.train_geom(w, h, 224, r1) == JT.train_geom(w, h, 224, r2)
        assert T.sample_rrc_box(w, h, r1) == JT.sample_rrc_box(w, h, r2)
    assert T.val_geom(w, h, 256, 224) == JT.val_geom(w, h, 256, 224)
    assert T.compute_resize_dims(w, h, 256) == JT.compute_resize_dims(w, h, 256)
