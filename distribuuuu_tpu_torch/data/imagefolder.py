"""ImageFolder dataset: ``root/split/class_name/*.jpg`` (counterpart of
distribuuuu_tpu/data/imagefolder.py).

torchvision ImageFolder semantics: the classes are the sorted
subdirectory names, labels their indices, and every file with an image
extension counts. Each sample's augmentation draws from its own generator,
``SeedSequence([RNG_SEED, epoch, index])``: the same on every rank and for
either decode backend. ``load_batch`` decodes a batch through the native
library (``native/``) with a per-image PIL fallback for what it cannot
read, or through PIL alone, as ``DATA.BACKEND`` says.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from distribuuuu_tpu_torch.data import transforms as T

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp",
)
BACKENDS = ("auto", "native", "pil")


def scan_image_folder(root: str):
    """``(samples, classes)``: samples ``[(path, class_idx)]``, classes sorted."""
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"Dataset directory not found: {root} (expected ImageFolder layout "
            "root/class_name/*.jpg; set MODEL.DUMMY_INPUT True to train without data)")
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"No class subdirectories under {root}")
    samples = []
    for idx, cls in enumerate(classes):
        for dirpath, _, filenames in sorted(os.walk(os.path.join(root, cls))):
            for fname in sorted(filenames):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    samples.append((os.path.join(dirpath, fname), idx))
    if not samples:
        raise FileNotFoundError(f"No images found under {root}")
    return samples, classes


class ImageFolderDataset:
    """``root/split``'s images through the train transforms
    (RandomResizedCrop to ``im_size`` + flip) or the val transforms
    (shorter side to ``im_size``, center crop to ``crop_size``); uint8
    under ``raw_u8`` (``DATA.DEVICE_NORMALIZE``), else normalized float32.
    ``backend``: ``auto`` takes the native decoder when it builds, else
    PIL; ``native`` raises when it cannot be built; ``pil`` never loads
    it."""

    def __init__(self, root: str, split: str, im_size: int, train: bool,
                 base_seed: int = 0, crop_size: int | None = None,
                 backend: str = "auto", raw_u8: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"DATA.BACKEND must be auto|native|pil, got {backend}")
        self.dir = os.path.join(root, split)
        self.samples, self.classes = scan_image_folder(self.dir)
        self.im_size = im_size
        self.crop_size = im_size if crop_size is None else crop_size
        self.train = train
        self.base_seed = base_seed
        self._epoch_seed = 0
        self.backend = backend
        self.raw_u8 = raw_u8

    def _use_native(self) -> bool:
        if self.backend == "pil":
            return False
        from distribuuuu_tpu_torch import native

        if native.available():
            return True
        if self.backend == "native":
            raise RuntimeError("DATA.BACKEND=native but the native decoder is unavailable: "
                               f"{native.build_error()}")
        return False

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.base_seed, self._epoch_seed, idx]))

    def set_epoch_seed(self, seed: int) -> None:
        """Fold the epoch into every sample's augmentation generator."""
        self._epoch_seed = seed

    def load_batch(self, idxs, n_threads: int = 4):
        """``(images [n, H, W, 3], labels [n] int32)`` of the samples
        ``idxs``: one call into the native decoder over ``n_threads``
        threads, with PIL redoing each image it could not take; or PIL
        image by image."""
        labels = np.asarray([self.samples[int(i)][1] for i in idxs], np.int32)
        out_dtype = np.uint8 if self.raw_u8 else np.float32
        if not self._use_native():
            return np.stack([self[int(i)][0] for i in idxs]).astype(out_dtype), labels

        from distribuuuu_tpu_torch import native

        out_size = self.im_size if self.train else self.crop_size
        geoms = np.zeros((len(idxs),), native.GEOM_DTYPE)
        paths, fallback = [], []
        for pos, idx in enumerate(int(i) for i in idxs):
            path = self.samples[idx][0]
            dims = native.file_dims(path)
            if dims is None:  # a format the decoder does not read: PIL
                paths.append("")  # fails in the decoder at once, no IO
                fallback.append(pos)
                continue
            paths.append(path)
            if self.train:
                g = T.train_geom(*dims, self.im_size, self._rng(idx))
            else:
                g = T.val_geom(*dims, self.im_size, self.crop_size)
            geoms[pos] = g + (0,)
        if self.raw_u8:
            images, statuses = native.load_batch_u8(paths, geoms, (out_size, out_size),
                                                    n_threads)
        else:
            images, statuses = native.load_batch(paths, geoms, (out_size, out_size),
                                                 T.IMAGENET_MEAN, T.IMAGENET_STD, n_threads)
        for pos in set(fallback) | set(np.nonzero(statuses)[0].tolist()):
            images[pos] = self[int(idxs[pos])][0]
        return images, labels

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, label = self.samples[idx]
        with Image.open(path) as img:
            img = img.convert("RGB")
            if self.train:
                arr = T.train_transform(img, self.im_size, self._rng(idx),
                                        normalize=not self.raw_u8)
            else:
                arr = T.val_transform(img, self.im_size, self.crop_size,
                                      normalize=not self.raw_u8)
        return arr, label
