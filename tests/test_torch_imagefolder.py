"""The port's real-image data path (distribuuuu_tpu_torch/data/
imagefolder.py, native/, data/loader.py) against the JAX package's, on
JPEG and PNG trees generated here from a numpy seed.

* ``scan_image_folder`` equals JAX's; ``ImageFolderDataset`` batches are
  byte-identical to JAX's for the same ``(RNG_SEED, epoch, index)``, for
  both splits, uint8 and float, through PIL and through the native
  decoder; the port's decoder library is byte-identical to JAX's binding
  on the same paths and geometries, and holds PIL's pixels within its
  resampler's bound.
* A grayscale JPEG, formats the decoder does not take (BMP, a PNG with
  alpha) falling back to PIL image by image, a truncated JPEG retried and
  then substituted, ``DATA.SKIP_CORRUPT False`` raising, and
  ``DATA.BACKEND native`` raising when the library cannot be built.
* The port's ``Loader`` at rank r of world w yields the same uint8
  batches, labels and masks as JAX's with ``data_process_groups`` at
  ``(r, w)``: train at epoch 1, and val with the sampler's repeats and
  the masked tail.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
from PIL import Image
from torch_port_util import few_threads, reset_port_cfg

from distribuuuu_tpu import native as jnative
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.data import imagefolder as jif
from distribuuuu_tpu.data import loader as jloader
from distribuuuu_tpu.data import transforms as JT
from distribuuuu_tpu.parallel import mesh as jmesh
from distribuuuu_tpu_torch import native
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data import imagefolder as tif
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.data import transforms as T
from distribuuuu_tpu_torch.parallel import dist as tdist

ATOL = 0.06  # the decoder against PIL: 3/255 / min(std) in normalized space
CLASSES = ("ant", "bee", "cat")


@pytest.fixture(autouse=True)
def _cfgs():
    reset_port_cfg()
    jcfg.defrost()
    saved = jcfg.clone()
    yield
    jcfg.merge_from_other_cfg(saved)
    reset_port_cfg()


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


def make_tree(root, n_train: int = 5, n_val: int = 2, seed: int = 0, exotic: bool = True):
    """``root/{train,val}/<class>/*``: seeded JPEGs of 40-90 px, one
    grayscale JPEG, and with ``exotic`` a BMP and an RGBA PNG in train."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for c, cls in enumerate(CLASSES):
            d = os.path.join(root, split, cls)
            os.makedirs(d)
            for i in range(n):
                w, h = (int(v) for v in rng.integers(40, 90, 2))
                arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8) // 2 + 40 * c
                img = Image.fromarray(arr.astype(np.uint8))
                if i == 1:
                    img = img.convert("L")
                img.save(os.path.join(d, f"{i:03d}.jpg"), "JPEG", quality=90)
    if exotic:
        d = os.path.join(root, "train", CLASSES[0])
        arr = rng.integers(0, 256, (50, 60, 4), dtype=np.uint8)
        Image.fromarray(arr[..., :3]).save(os.path.join(d, "900.bmp"), "BMP")
        Image.fromarray(arr, "RGBA").save(os.path.join(d, "901.png"), "PNG")
    return str(root)


def _pair(root, split, train, backend, raw_u8, seed=7):
    kw = dict(im_size=32 if train else 48, train=train, base_seed=seed,
              crop_size=None if train else 32, backend=backend, raw_u8=raw_u8)
    return (tif.ImageFolderDataset(root, split, **kw),
            jif.ImageFolderDataset(root, split, **kw))


def test_scan_equals_jax(tmp_path):
    root = make_tree(tmp_path)
    for split in ("train", "val"):
        got = tif.scan_image_folder(os.path.join(root, split))
        assert got == jif.scan_image_folder(os.path.join(root, split))
    assert len(got[0]) == 6 and got[1] == list(CLASSES)
    assert tif.IMG_EXTENSIONS == jif.IMG_EXTENSIONS
    with pytest.raises(FileNotFoundError, match="Dataset directory not found"):
        tif.scan_image_folder(str(tmp_path / "missing"))


@pytest.mark.parametrize("raw_u8", [True, False])
@pytest.mark.parametrize("backend", ["pil", "native"])
@pytest.mark.parametrize("train", [True, False])
def test_batches_byte_identical_to_jax(tmp_path, train, backend, raw_u8):
    root = make_tree(tmp_path)
    split = "train" if train else "val"
    port, ref = _pair(root, split, train, backend, raw_u8)
    assert port._use_native() == (backend == "native")
    for epoch in (0, 3):
        port.set_epoch_seed(epoch)
        ref.set_epoch_seed(epoch)
        idxs = np.arange(len(port))[::-1]
        (pi, pl), (ji, jl) = port.load_batch(idxs, n_threads=3), ref.load_batch(idxs, 3)
        assert pi.dtype == ji.dtype == (np.uint8 if raw_u8 else np.float32)
        assert pi.tobytes() == ji.tobytes() and np.array_equal(pl, jl)
        for i in (0, len(port) - 1):
            assert port[i][0].tobytes() == ref[i][0].tobytes()


@pytest.mark.parametrize("train", [True, False])
def test_native_holds_pil_within_the_resampler_bound(tmp_path, train):
    root = make_tree(tmp_path, exotic=False)
    split = "train" if train else "val"
    nat, _ = _pair(root, split, train, "native", False)
    pil, _ = _pair(root, split, train, "pil", False)
    idxs = np.arange(len(nat))
    (a, la), (b, lb) = nat.load_batch(idxs), pil.load_batch(idxs)
    assert np.array_equal(la, lb) and np.abs(a - b).max() < ATOL


def test_port_library_is_byte_identical_to_jax_binding(tmp_path):
    root = make_tree(tmp_path, exotic=False)
    assert native.available(), native.build_error()
    assert jnative.available(), jnative.build_error()
    assert os.path.dirname(native.library_path()).endswith(
        os.path.join("distribuuuu_tpu_torch", "_build"))
    samples, _ = tif.scan_image_folder(os.path.join(root, "train"))
    paths = [p for p, _ in samples]
    rng = np.random.default_rng(5)
    geoms = np.zeros((len(paths),), native.GEOM_DTYPE)
    for k, p in enumerate(paths):
        assert native.file_dims(p) == jnative.file_dims(p)
        geoms[k] = T.train_geom(*native.file_dims(p), 40, rng) + (0,)
    a, sa = native.load_batch_u8(paths, geoms, (40, 40), 4)
    b, sb = jnative.load_batch_u8(paths, geoms, (40, 40), 4)
    assert not sa.any() and not sb.any() and a.tobytes() == b.tobytes()
    a, sa = native.load_batch(paths, geoms, (40, 40), T.IMAGENET_MEAN, T.IMAGENET_STD, 2)
    b, sb = jnative.load_batch(paths, geoms, (40, 40), JT.IMAGENET_MEAN, JT.IMAGENET_STD, 2)
    assert a.tobytes() == b.tobytes()


def test_formats_the_decoder_does_not_take_fall_back_per_image(tmp_path):
    root = make_tree(tmp_path)
    port, _ = _pair(root, "train", True, "native", True)
    names = [os.path.basename(p) for p, _ in port.samples]
    exotic = [names.index("900.bmp"), names.index("901.png")]
    assert native.file_dims(port.samples[exotic[0]][0]) is None  # unknown magic
    images, _ = port.load_batch(np.arange(len(port)))
    for i in exotic:
        assert images[i].tobytes() == port[i][0].tobytes()  # PIL's own pixels


def _set_both(**kv):
    jcfg.defrost()
    for key, val in kv.items():
        for c in (jcfg, tcfg):
            node = c
            *head, leaf = key.split("__")
            for h in head:
                node = node[h]
            node[leaf] = val


def _data_cfg(root, backend="pil", **kw):
    _set_both(**{**dict(TRAIN__DATASET=root, TEST__DATASET=root, TRAIN__IM_SIZE=32,
                        TEST__IM_SIZE=48, TRAIN__BATCH_SIZE=4, TEST__BATCH_SIZE=4,
                        TRAIN__WORKERS=2, RNG_SEED=11, DATA__BACKEND=backend,
                        DATA__RETRY_BACKOFF_S=0.001), **kw})


def _ranked(monkeypatch, rank, world):
    monkeypatch.setattr(jax, "local_device_count", lambda *a, **k: 1)
    monkeypatch.setattr(jmesh, "data_process_groups", lambda mesh=None: (rank, world))
    monkeypatch.setattr(tdist, "get_rank", lambda: rank)
    monkeypatch.setattr(tdist, "get_world_size", lambda: world)


@pytest.mark.parametrize("backend", ["pil", "native"])
@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2), (2, 3)])
def test_loader_at_rank_equals_jax(tmp_path, monkeypatch, rank, world, backend):
    root = make_tree(tmp_path)
    _data_cfg(root, backend)
    _ranked(monkeypatch, rank, world)
    for train in (True, False):
        make = "construct_train_loader" if train else "construct_val_loader"
        tl, jl = getattr(tloader, make)(), getattr(jloader, make)()
        assert tl.backend == backend and tl.prefetch_depth == jl.prefetch_depth == 2
        tl.set_epoch(1)
        jl.set_epoch(1)
        assert len(tl) == len(jl) > 0
        masks = 0.0
        for tb, jb in zip(tl, jl, strict=True):
            for k in ("image", "label", "mask"):
                assert tb[k].dtype == jb[k].dtype and tb[k].tobytes() == jb[k].tobytes(), k
            masks += tb["mask"].sum()
        if not train:  # 6 val images: each rank counts ceil(6 / world), repeats included
            assert masks == -(-6 // world)


def test_val_shards_count_the_samplers_repeats(tmp_path, monkeypatch):
    """5 val images on 2 ranks: 3 a rank, the head repeated, 6 counted."""
    root = make_tree(tmp_path, n_val=2)
    os.remove(os.path.join(root, "val", CLASSES[2], "001.jpg"))
    _data_cfg(root)
    total = 0.0
    for rank in (0, 1):
        _ranked(monkeypatch, rank, 2)
        for tb, jb in zip(tloader.construct_val_loader(), jloader.construct_val_loader(),
                          strict=True):
            assert tb["mask"].tobytes() == jb["mask"].tobytes()
            total += tb["mask"].sum()
    assert total == 6


def _truncate(root) -> str:
    path = os.path.join(root, "train", CLASSES[1], "002.jpg")
    with open(path, "rb") as f:
        head = f.read(100)
    with open(path, "wb") as f:
        f.write(head)
    return path


@pytest.mark.parametrize("backend", ["pil", "native"])
def test_truncated_jpeg_is_retried_then_substituted_as_jax(tmp_path, monkeypatch, backend):
    root = make_tree(tmp_path, exotic=False)
    _truncate(root)
    _data_cfg(root, backend, TRAIN__BATCH_SIZE=15)
    _ranked(monkeypatch, 0, 1)
    tl, jl = tloader.construct_train_loader(), jloader.construct_train_loader()
    calls = {"n": 0}
    load = tl.dataset.load_batch

    def counted(*a, **k):
        calls["n"] += 1
        return load(*a, **k)

    monkeypatch.setattr(tl.dataset, "load_batch", counted)
    (tb,), (jb,) = list(tl), list(jl)
    assert calls["n"] == 1 + tcfg.DATA.RETRIES  # the batch decode, retried
    for k in ("image", "label", "mask"):
        assert tb[k].tobytes() == jb[k].tobytes(), k
    order = tl.sampler.indices()[:15]
    bad = list(order).index(7)  # sample 7: bee/002.jpg
    assert tb["image"][bad].tobytes() == tb["image"][0 if bad else 1].tobytes()


def test_skip_corrupt_false_raises(tmp_path, monkeypatch):
    root = make_tree(tmp_path, exotic=False)
    _truncate(root)
    _data_cfg(root, "pil", TRAIN__BATCH_SIZE=15, DATA__SKIP_CORRUPT=False)
    _ranked(monkeypatch, 0, 1)
    with pytest.raises(RuntimeError, match="SKIP_CORRUPT False"):
        list(tloader.construct_train_loader())


def test_native_backend_raises_when_the_library_cannot_build(tmp_path, monkeypatch):
    root = make_tree(tmp_path, exotic=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "_build", lambda path: "native build failed: no g++")
    _data_cfg(root, "native")
    _ranked(monkeypatch, 0, 1)
    with pytest.raises(RuntimeError, match="DATA.BACKEND=native.*no g\\+\\+"):
        tloader.construct_train_loader()
    tcfg.DATA.BACKEND = "auto"
    loader = tloader.construct_train_loader()
    assert loader.backend == "pil" and loader.prefetch_depth == tcfg.TRAIN.WORKERS
    assert next(iter(loader))["image"].dtype == np.uint8
