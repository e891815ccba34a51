"""Image loading and augmentation of the port (counterpart of
``incubator_mxnet_tpu/image/image.py``; reference
python/mxnet/image/image.py, src/io/image_io.cc,
src/io/image_aug_default.cc).

Host-side: decode, resize and crop run through OpenCV (``cv2``,
imported when first needed) on numpy arrays and return HWC **host**
NDArrays (``ctx=mx.cpu()``; the port's default context is the card).
The augmenters draw from the same streams as the JAX package's —
Python's ``random`` for crops and flips, ``np.random`` for the colour
jitters' order and the PCA lighting — so a seed gives the same crops in
both packages.  ``ImageIter`` reads ``.rec`` files (with or without an
``.idx``), ``.lst`` files or an in-memory image list and emits NCHW
float32 host batches.
"""
from __future__ import annotations

import os
import random as pyrandom

import numpy as np

from ..base import MXNetError
from ..context import cpu
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "random_size_crop", "color_normalize",
           "Augmenter", "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "HorizontalFlipAug",
           "CastAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "ColorJitterAug",
           "LightingAug", "ColorNormalizeAug", "RandomGrayAug",
           "SequentialAug", "RandomOrderAug", "CreateAugmenter", "ImageIter"]


def _cv2():
    import cv2
    return cv2


def _np(img):
    return img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)


def _host(a):
    """A host NDArray holding a copy of ``a`` (float64 becomes float32,
    the JAX package's rule)."""
    return _nd.array(a, ctx=cpu())


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode an image byte buffer to an HWC uint8 NDArray (reference
    image.py:imdecode over src/io/image_io.cc)."""
    cv2 = _cv2()
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().astype(np.uint8).tobytes()
    img = cv2.imdecode(np.frombuffer(buf, np.uint8),
                       cv2.IMREAD_COLOR if flag else cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise MXNetError("Invalid image buffer")
    if flag and to_rgb:
        img = img[:, :, ::-1]
    if img.ndim == 2:
        img = img[:, :, None]
    arr = _host(np.ascontiguousarray(img).astype(np.uint8))
    if out is not None:
        out._write(arr._data.to(out._data.device))
        return out
    return arr


def imread(filename, flag=1, to_rgb=True):
    """Read and decode an image file (reference image.py:imread)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1):
    """Resize to exactly (w, h) (reference image.py:imresize)."""
    cv2 = _cv2()
    arr = _np(src)
    if arr.dtype not in (np.uint8, np.uint16, np.int16, np.float32,
                        np.float64):
        arr = arr.astype(np.float32)
    out = cv2.resize(arr, (w, h), interpolation=interp)
    if out.ndim == 2:
        out = out[:, :, None]
    return _host(out)


def resize_short(src, size, interp=2):
    """Resize so the shorter side equals `size`, preserving aspect
    (reference image.py:resize_short)."""
    arr = _np(src)
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(arr, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop [y0:y0+h, x0:x0+w], optionally resize to `size` (w,h)
    (reference image.py:fixed_crop)."""
    arr = _np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(arr, size[0], size[1], interp)
    return _host(np.ascontiguousarray(arr))


def random_crop(src, size, interp=2):
    """Random crop of `size` (w,h); returns (img, (x0,y0,w,h))
    (reference image.py:random_crop)."""
    arr = _np(src)
    h, w = arr.shape[:2]
    new_w, new_h = size
    if w < new_w or h < new_h:
        src2 = resize_short(arr, max(new_w, new_h), interp)
        arr = _np(src2)
        h, w = arr.shape[:2]
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    return fixed_crop(arr, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """Center crop of `size` (w,h); returns (img, (x0,y0,w,h))
    (reference image.py:center_crop)."""
    arr = _np(src)
    h, w = arr.shape[:2]
    new_w, new_h = size
    if w < new_w or h < new_h:
        src2 = resize_short(arr, max(new_w, new_h), interp)
        arr = _np(src2)
        h, w = arr.shape[:2]
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    return fixed_crop(arr, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    """Random crop by area fraction + aspect ratio then resize
    (reference image.py:random_size_crop)."""
    arr = _np(src)
    h, w = arr.shape[:2]
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(*area) * h * w
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * aspect)))
        new_h = int(round(np.sqrt(target_area / aspect)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            return fixed_crop(arr, x0, y0, new_w, new_h, size, interp), \
                (x0, y0, new_w, new_h)
    return center_crop(arr, size, interp)


def color_normalize(src, mean, std=None):
    """(src - mean) / std on HWC float input (reference
    image.py:color_normalize)."""
    arr = _np(src).astype(np.float32)
    mean = _np(mean) if mean is not None else None
    std = _np(std) if std is not None else None
    if mean is not None:
        arr = arr - mean
    if std is not None:
        arr = arr / std
    return _host(arr)


# ------------------------------------------------------------------ augmenters
class Augmenter:
    """Image augmenter base (reference image.py:Augmenter); dumps its
    params for serialization like the reference."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = \
            size, area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return _host(_np(src)[:, ::-1].copy())
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _host(_np(src).astype(self.typ))


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return _host(_np(src).astype(np.float32) * alpha)


class ContrastJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        arr = _np(src).astype(np.float32)
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        gray = (arr * self._coef).sum() * 3.0 / arr.size
        return _host(arr * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        arr = _np(src).astype(np.float32)
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        gray = (arr * self._coef).sum(axis=2, keepdims=True)
        return _host(arr * alpha + gray * (1.0 - alpha))


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        cv2 = _cv2()
        arr = _np(src).astype(np.uint8)
        hsv = cv2.cvtColor(arr, cv2.COLOR_RGB2HSV).astype(np.int32)
        shift = int(pyrandom.uniform(-self.hue, self.hue) * 180)
        hsv[..., 0] = (hsv[..., 0] + shift) % 180
        return _host(cv2.cvtColor(hsv.astype(np.uint8),
                                      cv2.COLOR_HSV2RGB))


class ColorJitterAug(Augmenter):
    def __init__(self, brightness=0, contrast=0, saturation=0):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self._augs = []
        if brightness:
            self._augs.append(BrightnessJitterAug(brightness))
        if contrast:
            self._augs.append(ContrastJitterAug(contrast))
        if saturation:
            self._augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        for aug in np.random.permutation(self._augs):
            src = aug(src)
        return src


class LightingAug(Augmenter):
    """AlexNet PCA lighting (reference image.py:LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, 3).astype(np.float32)
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return _host(_np(src).astype(np.float32) + rgb)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=list(np.ravel(mean)) if mean is not None
                         else None,
                         std=list(np.ravel(std)) if std is not None else None)
        self.mean = np.asarray(mean, np.float32) if mean is not None else None
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    _mat = np.array([[0.21, 0.21, 0.21],
                     [0.72, 0.72, 0.72],
                     [0.07, 0.07, 0.07]], np.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return _host(_np(src).astype(np.float32) @ self._mat)
        return src


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in np.random.permutation(self.ts):
            src = t(src)
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (reference image.py:CreateAugmenter,
    mirroring src/io/image_aug_default.cc's parameter set)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        mean = np.asarray(mean)
        assert mean.shape[0] in (1, 3)
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    elif std is not None:
        std = np.asarray(std)
        assert std.shape[0] in (1, 3)
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Python-side image iterator over .rec or .lst+raw files
    (reference image.py:ImageIter). Emits NCHW float batches via the
    augmenter chain; shuffle per epoch."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label", **kwargs):
        from .. import recordio as rio
        from ..io import DataDesc, DataBatch
        assert path_imgrec or path_imglist or imglist is not None, \
            "must supply path_imgrec, path_imglist or imglist"
        assert len(data_shape) == 3, "data_shape must be (C,H,W)"
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._DataBatch = DataBatch
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        label_shape = (batch_size,) if label_width == 1 \
            else (batch_size, label_width)
        self.provide_label = [DataDesc(label_name, label_shape)]
        self._shuffle = shuffle
        self.imgrec = None
        self.imglist = None
        self.seq = None
        if path_imgrec:
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx_path):
                self.imgrec = rio.MXIndexedRecordIO(idx_path, path_imgrec,
                                                    "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = rio.MXRecordIO(path_imgrec, "r")
                self.seq = None
        elif path_imglist:
            self.imglist = {}
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    label = np.array(parts[1:-1], np.float32)
                    self.imglist[int(parts[0])] = (label,
                                                   os.path.join(path_root,
                                                                parts[-1]))
            self.seq = list(self.imglist.keys())
        else:
            self.imglist = {}
            for i, (label, fname) in enumerate(imglist):
                self.imglist[i] = (np.array(label, np.float32, ndmin=1),
                                   os.path.join(path_root, fname))
            self.seq = list(self.imglist.keys())
        if aug_list is None:
            aug_list = CreateAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_resize", "rand_mirror",
                         "mean", "std", "brightness", "contrast",
                         "saturation", "hue", "pca_noise", "rand_gray",
                         "inter_method")})
        self.auglist = aug_list
        self.cur = 0
        self.reset()

    def reset(self):
        if self._shuffle and self.seq is not None:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        from .. import recordio as rio
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = rio.unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            with open(fname, "rb") as f:
                return label, f.read()
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = rio.unpack(s)
        return header.label, img

    def next(self):
        c, h, w = self.data_shape
        data = np.zeros((self.batch_size, c, h, w), np.float32)
        labels = np.zeros((self.batch_size, self.label_width), np.float32)
        i = 0
        pad = 0
        try:
            while i < self.batch_size:
                label, buf = self.next_sample()
                img = imdecode(buf)
                for aug in self.auglist:
                    img = aug(img)
                arr = img.asnumpy()
                data[i] = arr.transpose(2, 0, 1)
                lab = np.asarray(label, np.float32).ravel()
                labels[i, :len(lab[:self.label_width])] = \
                    lab[:self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
            pad = self.batch_size - i
        lab_out = labels[:, 0] if self.label_width == 1 else labels
        return self._DataBatch(data=[_host(data)],
                               label=[_host(lab_out)], pad=pad)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self
