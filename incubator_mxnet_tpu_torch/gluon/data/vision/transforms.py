"""Vision transforms of the port (counterpart of ``incubator_mxnet_tpu/
gluon/data/vision/transforms.py``; reference python/mxnet/gluon/data/
vision/transforms.py).

Callables over HWC uint8 or float host NDArrays; ``Compose`` chains
them.  The random ones draw from ``np.random`` exactly as the JAX
package's do, so a numpy seed gives the same crops, flips and jitters.
OpenCV is imported by the transforms that resize.
"""
from __future__ import annotations

import numpy as np

from ....ndarray import ndarray as _nd
from ....context import cpu
from ....ndarray.ndarray import NDArray

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting"]


def _host(a):
    """A host NDArray holding a copy of ``a`` (float64 becomes float32,
    the JAX package's rule)."""
    return _nd.array(a, ctx=cpu())


def _np(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


class Compose:
    """Chain transforms left to right (reference transforms.py:Compose)."""

    def __init__(self, transforms):
        self._transforms = list(transforms)

    def __call__(self, x):
        for t in self._transforms:
            x = t(x)
        return x


class Cast:
    def __init__(self, dtype="float32"):
        self._dtype = dtype

    def __call__(self, x):
        return _host(_np(x).astype(self._dtype))


class ToTensor:
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference
    transforms.py:ToTensor)."""

    def __call__(self, x):
        arr = _np(x).astype(np.float32) / 255.0
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)
        return _host(arr)


class Normalize:
    """(x - mean) / std per channel on CHW input (reference
    transforms.py:Normalize)."""

    def __init__(self, mean=0.0, std=1.0):
        self._mean = np.asarray(mean, np.float32)
        self._std = np.asarray(std, np.float32)

    def __call__(self, x):
        arr = _np(x).astype(np.float32)
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return _host((arr - mean) / std)


class Resize:
    """Resize HWC image to (w, h) or short-side size (reference
    transforms.py:Resize)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        self._size = size
        self._keep = keep_ratio
        self._interp = interpolation

    def __call__(self, x):
        import cv2
        arr = _np(x)
        if isinstance(self._size, int):
            if self._keep:
                h, w = arr.shape[:2]
                s = self._size / min(h, w)
                size = (int(round(w * s)), int(round(h * s)))
            else:
                size = (self._size, self._size)
        else:
            size = tuple(self._size)
        return _host(cv2.resize(arr, size,
                                    interpolation=self._interp))


class CenterCrop:
    def __init__(self, size, interpolation=1):
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._interp = interpolation

    def __call__(self, x):
        import cv2
        arr = _np(x)
        w, h = self._size
        ih, iw = arr.shape[:2]
        if ih < h or iw < w:
            arr = cv2.resize(arr, (max(w, iw), max(h, ih)),
                             interpolation=self._interp)
            ih, iw = arr.shape[:2]
        y, x0 = (ih - h) // 2, (iw - w) // 2
        return _host(arr[y:y + h, x0:x0 + w])


class RandomResizedCrop:
    """Random area+aspect crop resized to `size` (reference
    transforms.py:RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._interp = interpolation

    def __call__(self, x):
        import cv2
        arr = _np(x)
        ih, iw = arr.shape[:2]
        area = ih * iw
        for _ in range(10):
            target = np.random.uniform(*self._scale) * area
            aspect = np.random.uniform(*self._ratio)
            w = int(round(np.sqrt(target * aspect)))
            h = int(round(np.sqrt(target / aspect)))
            if np.random.rand() < 0.5:
                w, h = h, w
            if w <= iw and h <= ih:
                x0 = np.random.randint(0, iw - w + 1)
                y0 = np.random.randint(0, ih - h + 1)
                crop = arr[y0:y0 + h, x0:x0 + w]
                return _host(cv2.resize(crop, self._size,
                                            interpolation=self._interp))
        return CenterCrop(self._size, self._interp)(x)


class RandomFlipLeftRight:
    def __call__(self, x):
        arr = _np(x)
        if np.random.rand() < 0.5:
            arr = arr[:, ::-1].copy()
        return _host(arr)


class RandomFlipTopBottom:
    def __call__(self, x):
        arr = _np(x)
        if np.random.rand() < 0.5:
            arr = arr[::-1].copy()
        return _host(arr)


class RandomBrightness:
    def __init__(self, brightness):
        self._b = brightness

    def __call__(self, x):
        arr = _np(x).astype(np.float32)
        alpha = 1.0 + np.random.uniform(-self._b, self._b)
        return _host(arr * alpha)


class RandomContrast:
    def __init__(self, contrast):
        self._c = contrast

    def __call__(self, x):
        arr = _np(x).astype(np.float32)
        alpha = 1.0 + np.random.uniform(-self._c, self._c)
        gray = arr.mean()
        return _host(arr * alpha + gray * (1 - alpha))


class RandomSaturation:
    def __init__(self, saturation):
        self._s = saturation

    def __call__(self, x):
        arr = _np(x).astype(np.float32)
        alpha = 1.0 + np.random.uniform(-self._s, self._s)
        gray = arr.mean(axis=-1, keepdims=True)
        return _host(arr * alpha + gray * (1 - alpha))


class RandomHue:
    def __init__(self, hue):
        self._h = hue

    def __call__(self, x):
        import cv2
        arr = _np(x).astype(np.uint8)
        hsv = cv2.cvtColor(arr, cv2.COLOR_RGB2HSV).astype(np.int32)
        shift = int(np.random.uniform(-self._h, self._h) * 180)
        hsv[..., 0] = (hsv[..., 0] + shift) % 180
        out = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
        return _host(out)


class RandomColorJitter:
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def __call__(self, x):
        for t in np.random.permutation(self._ts):
            x = t(x)
        return x


class RandomLighting:
    """AlexNet-style PCA lighting noise (reference
    transforms.py:RandomLighting)."""

    _eigval = np.array([55.46, 4.794, 1.148], np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alpha):
        self._alpha = alpha

    def __call__(self, x):
        arr = _np(x).astype(np.float32)
        alpha = np.random.normal(0, self._alpha, 3).astype(np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return _host(arr + rgb)
