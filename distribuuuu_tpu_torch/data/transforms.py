"""Image transforms with torchvision-matching semantics, on PIL + numpy
(the port's copy of distribuuuu_tpu/data/transforms.py), plus the
device-side normalization of the uint8 path.

Train: RandomResizedCrop(TRAIN.IM_SIZE) + RandomHorizontalFlip + Normalize.
Val: Resize(shorter side = TEST.IM_SIZE) + CenterCrop(TRAIN.IM_SIZE) +
Normalize. Mean/std are the ImageNet constants; output is NHWC.

``train_geom``/``val_geom`` reduce each pipeline to one resample geometry
for the native decoder (``native/``): output pixel (x, y) samples source
position ``box + (out0 + x + 0.5) · scale``. ``train_geom`` draws exactly
what ``train_transform`` draws, from the same generator, so the PIL and
native backends see the same augmentations.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from PIL import Image

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def sample_rrc_box(width: int, height: int, rng: np.random.Generator,
                   scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)) -> tuple[int, int, int, int]:
    """torchvision RandomResizedCrop box sampling: 10 attempts at area and
    ratio jitter, then a center crop at the closest valid ratio. Returns
    ``(j, i, w, h)``: left, top, width, height in source pixels. The only
    place train-augmentation randomness is drawn."""
    area = width * height
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = int(rng.integers(0, height - h + 1))
            j = int(rng.integers(0, width - w + 1))
            return j, i, w, h
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = height, int(round(height * ratio[1]))
    else:
        w, h = width, height
    i, j = (height - h) // 2, (width - w) // 2
    return j, i, w, h


def random_resized_crop(img: Image.Image, size: int, rng: np.random.Generator,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)) -> Image.Image:
    j, i, w, h = sample_rrc_box(img.size[0], img.size[1], rng, scale, ratio)
    return img.resize((size, size), Image.BILINEAR, box=(j, i, j + w, i + h))


def compute_resize_dims(width: int, height: int, size: int) -> tuple[int, int]:
    """torchvision Resize(int) target dims: shorter side to ``size``, keep aspect."""
    if width <= height:
        return size, int(round(size * height / width))
    return int(round(size * width / height)), size


def resize_shorter(img: Image.Image, size: int) -> Image.Image:
    """torchvision Resize(int): shorter side to ``size``, keep aspect."""
    new_w, new_h = compute_resize_dims(img.size[0], img.size[1], size)
    return img.resize((new_w, new_h), Image.BILINEAR)


def center_crop(img: Image.Image, size: int) -> Image.Image:
    width, height = img.size
    left = (width - size) // 2
    top = (height - size) // 2
    return img.crop((left, top, left + size, top + size))


def to_normalized_array(img: Image.Image) -> np.ndarray:
    """ToTensor + Normalize, NHWC float32."""
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:  # grayscale
        arr = np.stack([arr] * 3, axis=-1)
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def to_u8_array(img: Image.Image) -> np.ndarray:
    """Raw uint8 NHWC — the ``DATA.DEVICE_NORMALIZE`` host output."""
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:  # grayscale
        arr = np.stack([arr] * 3, axis=-1)
    return arr


_STATS: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def normalize_on_device(images_u8: torch.Tensor) -> torch.Tensor:
    """The device half of ``DATA.DEVICE_NORMALIZE``: uint8 NHWC →
    ``(x/255 − mean)/std`` in float32 on the tensor's device, in the
    order of ``to_normalized_array``. Mean and std are copied to each
    device once: a copy from pageable host memory per call would make
    the host wait for the stream."""
    dev = images_u8.device
    if dev not in _STATS:
        _STATS[dev] = (torch.as_tensor(IMAGENET_MEAN, device=dev),
                       torch.as_tensor(IMAGENET_STD, device=dev))
    mean, std = _STATS[dev]
    x = images_u8.to(torch.float32) / 255.0
    return (x - mean) / std


def train_transform(img: Image.Image, im_size: int, rng: np.random.Generator,
                    normalize: bool = True):
    img = random_resized_crop(img, im_size, rng)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return to_normalized_array(img) if normalize else to_u8_array(img)


def val_transform(img: Image.Image, resize_size: int, crop_size: int,
                  normalize: bool = True):
    img = resize_shorter(img, resize_size)
    img = center_crop(img, crop_size)
    return to_normalized_array(img) if normalize else to_u8_array(img)


def train_geom(width: int, height: int, im_size: int, rng: np.random.Generator):
    """``(box_x, box_y, scale_x, scale_y, out_x0, out_y0, flip)`` of the
    train pipeline: the crop box resized to ``im_size``², then the flip."""
    j, i, w, h = sample_rrc_box(width, height, rng)
    flip = 1 if rng.random() < 0.5 else 0
    return float(j), float(i), w / im_size, h / im_size, 0, 0, flip


def val_geom(width: int, height: int, resize_size: int, crop_size: int):
    """The val pipeline's geometry: the crop window of the virtual
    shorter-side resize (each output pixel depends only on its own source
    window, so resize-then-crop is crop-of-resize)."""
    new_w, new_h = compute_resize_dims(width, height, resize_size)
    left = (new_w - crop_size) // 2
    top = (new_h - crop_size) // 2
    return 0.0, 0.0, width / new_w, height / new_h, left, top, 0
