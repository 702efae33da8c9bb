"""Val image transforms with torchvision-matching semantics, on PIL + numpy
(the port's copy of the val half of distribuuuu_tpu/data/transforms.py),
plus the device-side normalization of the uint8 serving path.

Val: Resize(shorter side = TEST.IM_SIZE) + CenterCrop(TRAIN.IM_SIZE) +
Normalize with the ImageNet mean/std. Output is NHWC.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


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


def val_transform(img: Image.Image, resize_size: int, crop_size: int,
                  normalize: bool = True):
    img = resize_shorter(img, resize_size)
    img = center_crop(img, crop_size)
    return to_normalized_array(img) if normalize else to_u8_array(img)
