"""Image preprocessing/augmentation (python/paddle/v2/image.py analog); a copy
of ``paddle_tpu/data/image.py``.

The reference wraps cv2; this is pure numpy (no cv2 dependency): resize
(bilinear), center/random crop, horizontal flip, channel-mean normalize —
the standard ImageNet training pipeline pieces. All functions take HWC
float/uint8 arrays. PIL is imported only inside :func:`load_image_bytes`,
so the module imports where PIL is absent.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def resize_short(im: np.ndarray, size: int) -> np.ndarray:
    """Scale so the short edge equals ``size`` (image.py resize_short)."""
    h, w = im.shape[:2]
    if h <= w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    return _bilinear(im, nh, nw)


def _bilinear(im: np.ndarray, nh: int, nw: int) -> np.ndarray:
    h, w = im.shape[:2]
    ys = np.linspace(0, h - 1, nh)
    xs = np.linspace(0, w - 1, nw)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    im = im.astype(np.float32)
    if im.ndim == 2:
        im = im[..., None]
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def center_crop(im: np.ndarray, size: int) -> np.ndarray:
    h, w = im.shape[:2]
    y = max(0, (h - size) // 2)
    x = max(0, (w - size) // 2)
    return im[y:y + size, x:x + size]


def random_crop(im: np.ndarray, size: int,
                rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    rng = rng or np.random
    h, w = im.shape[:2]
    y = rng.randint(0, max(h - size, 0) + 1)
    x = rng.randint(0, max(w - size, 0) + 1)
    return im[y:y + size, x:x + size]


def left_right_flip(im: np.ndarray) -> np.ndarray:
    return im[:, ::-1]


def normalize(im: np.ndarray, mean: Sequence[float],
              std: Optional[Sequence[float]] = None) -> np.ndarray:
    out = im.astype(np.float32) - np.asarray(mean, np.float32)
    if std is not None:
        out = out / np.asarray(std, np.float32)
    return out


def simple_transform(im: np.ndarray, resize: int, crop: int, is_train: bool,
                     mean: Optional[Sequence[float]] = None,
                     rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """The canonical train/test pipeline (image.py simple_transform):
    resize-short -> random/center crop -> (train) flip -> normalize."""
    im = resize_short(im, resize)
    im = random_crop(im, crop, rng) if is_train else center_crop(im, crop)
    if is_train and (rng or np.random).rand() < 0.5:
        im = left_right_flip(im)
    if mean is not None:
        im = normalize(im, mean)
    return im


def to_chw(im: np.ndarray, order: Tuple[int, int, int] = (2, 0, 1)) -> np.ndarray:
    """HWC -> CHW (image.py to_chw) — the layout the reference's conv layers
    ate; the port's convs are NHWC-native, so use this only for exported
    compatibility paths."""
    return im.transpose(order)


def load_image_bytes(data: bytes, is_color: bool = True) -> np.ndarray:
    """Decode an encoded (PNG/JPEG/...) image from bytes -> HWC uint8
    (image.py load_image_bytes; PIL replaces the reference's cv2)."""
    import io

    from PIL import Image
    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB" if is_color else "L")
    arr = np.asarray(img)
    if not is_color:
        arr = arr[..., None]
    return arr


def load_image(path: str, is_color: bool = True) -> np.ndarray:
    """image.py load_image."""
    with open(path, "rb") as f:
        return load_image_bytes(f.read(), is_color)


def load_and_transform(path: str, resize: int, crop: int, is_train: bool,
                       is_color: bool = True,
                       mean: Optional[Sequence[float]] = None) -> np.ndarray:
    """image.py load_and_transform: decode + simple_transform."""
    return simple_transform(load_image(path, is_color), resize, crop,
                            is_train, mean=mean)


def batch_images_from_tar(tar_path: str, dataset_name: str,
                          img2label: dict, num_per_batch: int = 1024,
                          out_path: Optional[str] = None) -> str:
    """Pre-batch a tar of encoded images into pickled numpy batches
    (image.py batch_images_from_tar): each output batch file holds
    {'data': [raw bytes...], 'label': [...]}; returns the batch-list file."""
    import pickle
    import tarfile

    out_path = out_path or (tar_path + "_batch")
    import os
    os.makedirs(out_path, exist_ok=True)
    data, labels, names = [], [], []
    with tarfile.open(tar_path) as tf:
        for m in tf.getmembers():
            if m.name not in img2label:
                continue
            data.append(tf.extractfile(m).read())
            labels.append(img2label[m.name])
            if len(data) == num_per_batch:
                names.append(_dump_batch(out_path, dataset_name, len(names),
                                         data, labels))
                data, labels = [], []
    if data:
        names.append(_dump_batch(out_path, dataset_name, len(names), data,
                                 labels))
    listfile = f"{out_path}/{dataset_name}.batch_list"
    with open(listfile, "w") as f:
        f.write("\n".join(names))
    return listfile


def _dump_batch(out_path, name, idx, data, labels):
    import pickle
    fname = f"{out_path}/{name}_batch_{idx:04d}"
    with open(fname, "wb") as f:
        pickle.dump({"data": list(data), "label": list(labels)}, f)
    return fname
