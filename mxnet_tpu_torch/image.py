"""Image pipeline, its detection half: the box-aware augmenters,
``CreateDetAugmenter`` and ``ImageDetIter``, the port of
``mxnet_tpu/image.py`` (``:553-823``) with the host helpers they call.

Everything here runs on the host in numpy, as in the JAX package: an
augmenter takes an (H, W, C) image and its (num_obj, 5) label of rows
``[cls_id, x1, y1, x2, y2]`` (coordinates normalized to [0, 1], cls_id -1
padding) and returns both. The random choices come from the same global
generators the JAX package draws from (``random`` for the augmenters,
``np.random`` for the PCA lighting noise), in the same order, so a seeded
run yields the same batches bit for bit. ``ImageDetIter``'s batches land
on ``mx.cpu()``, as ``NDArrayIter``'s do; ``Module`` moves them to its
context.

Neither cv2 nor PIL is needed for the detection path: without cv2,
``DetResizeAug`` takes nearest indices from ``np.linspace`` (the JAX
package's own choice, ``_cv2()``); ``_resize`` (the shorter-edge resize,
only with ``resize > 0``) needs one of them, and without both raises the
``ImportError`` of PIL, as the JAX package does.

The record iterators, ``imdecode`` and the classification iterator come
with the record-IO slice: ``ImageDetIter(path_imgrec=...)`` raises,
naming it.
"""
from __future__ import annotations

import random as pyrandom

import numpy as np

from .base import MXNetError
from .context import cpu
from .io import DataBatch, DataDesc, DataIter
from .ndarray import NDArray, array

__all__ = ["DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "DetResizeAug", "CreateDetAugmenter", "ImageDetIter",
           "ColorJitterAug", "LightingAug", "ColorNormalizeAug", "CastAug"]


def _cv2():
    try:
        import cv2
        return cv2
    except ImportError:
        return None


def _asnp(img):
    return img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)


def _resize_short_np(src, size, interp=2):
    img = _asnp(src)
    h, w = img.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return _resize(img, new_w, new_h, interp)


def _resize(img, w, h, interp=2):
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=interp)
    from PIL import Image
    return np.asarray(Image.fromarray(img.astype(np.uint8)).resize((w, h)))


def _color_normalize_np(src, mean, std=None):
    img = _asnp(src).astype(np.float32)
    img = img - _asnp(mean)
    if std is not None:
        img = img / _asnp(std)
    return img


# ------------------------------------------------------------- augmenters
def ColorJitterAug(brightness, contrast, saturation):
    coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)

    def aug(src):
        img = _asnp(src).astype(np.float32)
        if brightness > 0:
            alpha = 1.0 + pyrandom.uniform(-brightness, brightness)
            img = img * alpha
        if contrast > 0:
            alpha = 1.0 + pyrandom.uniform(-contrast, contrast)
            gray = (img * coef).sum(axis=2, keepdims=True)
            img = img * alpha + gray.mean() * (1 - alpha)
        if saturation > 0:
            alpha = 1.0 + pyrandom.uniform(-saturation, saturation)
            gray = (img * coef).sum(axis=2, keepdims=True)
            img = img * alpha + gray * (1 - alpha)
        return [img]
    return aug


def LightingAug(alphastd, eigval, eigvec):
    def aug(src):
        img = _asnp(src).astype(np.float32)
        alpha = np.random.normal(0, alphastd, size=(3,))
        rgb = np.dot(_asnp(eigvec) * alpha, _asnp(eigval))
        return [img + rgb]
    return aug


def ColorNormalizeAug(mean, std):
    def aug(src):
        return [_color_normalize_np(src, mean, std)]
    return aug


def CastAug():
    def aug(src):
        return [_asnp(src).astype(np.float32)]
    return aug


# ---------------------------------------------------------------------------
# detection-aware augmenters: (image, label) in, (image, label) out
# ---------------------------------------------------------------------------
def _det_valid(label):
    return label[:, 0] >= 0


def DetHorizontalFlipAug(p):
    """Mirror the image and its boxes together with probability p."""
    def aug(src, label):
        if pyrandom.random() < p:
            img = _asnp(src)[:, ::-1]
            lab = label.copy()
            v = _det_valid(lab)
            x1 = lab[:, 1].copy()
            lab[:, 1] = np.where(v, 1.0 - lab[:, 3], lab[:, 1])
            lab[:, 3] = np.where(v, 1.0 - x1, lab[:, 3])
            return img, lab
        return src, label
    return aug


def DetRandomCropAug(min_object_covered=0.3, aspect_ratio_range=(0.75, 1.33),
                     area_range=(0.3, 1.0), max_attempts=25):
    """Box-aware random crop: a sampled crop is taken only if it keeps at
    least one object's centre and covers at least ``min_object_covered``
    of each object it keeps; the other objects become padding rows."""
    def aug(src, label):
        img = _asnp(src)
        h, w = img.shape[:2]
        valid = _det_valid(label)
        if not valid.any():
            return src, label
        for _ in range(max_attempts):
            area = pyrandom.uniform(*area_range)
            aspect = pyrandom.uniform(*aspect_ratio_range)
            cw = min(1.0, np.sqrt(area * aspect))
            ch = min(1.0, np.sqrt(area / aspect))
            cx0 = pyrandom.uniform(0, 1.0 - cw)
            cy0 = pyrandom.uniform(0, 1.0 - ch)
            cx1, cy1 = cx0 + cw, cy0 + ch
            centers_x = (label[:, 1] + label[:, 3]) / 2
            centers_y = (label[:, 2] + label[:, 4]) / 2
            keep = valid & (centers_x > cx0) & (centers_x < cx1) & \
                (centers_y > cy0) & (centers_y < cy1)
            if not keep.any():
                continue
            ix1 = np.maximum(label[:, 1], cx0)
            iy1 = np.maximum(label[:, 2], cy0)
            ix2 = np.minimum(label[:, 3], cx1)
            iy2 = np.minimum(label[:, 4], cy1)
            inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0,
                                                          None)
            box_area = (label[:, 3] - label[:, 1]) * \
                (label[:, 4] - label[:, 2])
            cov = np.where(box_area > 0, inter / np.maximum(box_area, 1e-8),
                           0.0)
            if (cov[keep] < min_object_covered).any():
                continue
            px0, py0 = int(cx0 * w), int(cy0 * h)
            px1, py1 = max(px0 + 1, int(cx1 * w)), max(py0 + 1, int(cy1 * h))
            out = img[py0:py1, px0:px1]
            lab = label.copy()
            lab[:, 0] = np.where(keep, lab[:, 0], -1.0)
            for c, (lo, span) in ((1, (cx0, cw)), (3, (cx0, cw)),
                                  (2, (cy0, ch)), (4, (cy0, ch))):
                lab[:, c] = np.clip((lab[:, c] - lo) / span, 0.0, 1.0)
            return out, lab
        return src, label
    return aug


def DetRandomPadAug(aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 2.0),
                    max_attempts=25, fill=127):
    """Place the image on a larger canvas filled with ``fill``, shrinking
    the boxes to match."""
    def aug(src, label):
        img = _asnp(src)
        h, w = img.shape[:2]
        for _ in range(max_attempts):
            area = pyrandom.uniform(*area_range)
            aspect = pyrandom.uniform(*aspect_ratio_range)
            nw = np.sqrt(area * aspect)
            nh = np.sqrt(area / aspect)
            if nw < 1.0 or nh < 1.0:
                continue
            ph, pw = int(round(h * nh)), int(round(w * nw))
            y0 = pyrandom.randint(0, ph - h)
            x0 = pyrandom.randint(0, pw - w)
            canvas = np.full((ph, pw) + img.shape[2:], fill,
                             dtype=img.dtype)
            canvas[y0:y0 + h, x0:x0 + w] = img
            lab = label.copy()
            v = _det_valid(lab)
            lab[:, 1] = np.where(v, (lab[:, 1] * w + x0) / pw, lab[:, 1])
            lab[:, 3] = np.where(v, (lab[:, 3] * w + x0) / pw, lab[:, 3])
            lab[:, 2] = np.where(v, (lab[:, 2] * h + y0) / ph, lab[:, 2])
            lab[:, 4] = np.where(v, (lab[:, 4] * h + y0) / ph, lab[:, 4])
            return canvas, lab
        return src, label
    return aug


def DetResizeAug(size, interp=2):
    """Resize to (w, h) = size; the normalized boxes stay as they are.
    Without cv2: nearest rows and columns from ``np.linspace``."""
    def aug(src, label):
        img = _asnp(src)
        cv2 = _cv2()
        if cv2 is not None:
            out = cv2.resize(img, size, interpolation=interp)
        else:
            ys = (np.linspace(0, img.shape[0] - 1, size[1])).astype(int)
            xs = (np.linspace(0, img.shape[1] - 1, size[0])).astype(int)
            out = img[ys][:, xs]
        return out, label
    return aug


def _det_wrap(color_aug):
    """Lift an image-only augmenter to the (image, label) signature."""
    def aug(src, label):
        return color_aug(src)[0], label
    return aug


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None, brightness=0,
                       contrast=0, saturation=0, pca_noise=0,
                       min_object_covered=0.3,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.3, 3.0), max_attempts=25,
                       pad_val=127, inter_method=2):
    """The detection augmenter list for (C, H, W) ``data_shape``: an
    optional shorter-edge resize, a crop with probability ``rand_crop``
    (areas below 1 of ``area_range``), a pad with probability
    ``rand_pad`` (areas above 1), the resize to the data shape, a mirror,
    the cast to float32, colour jitter, PCA lighting and normalization."""
    auglist = []
    if resize > 0:
        def shorter_edge(src, label, _s=resize, _i=inter_method):
            return _resize_short_np(src, _s, _i), label
        auglist.append(shorter_edge)
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (min(area_range[0], 1.0),
                                 min(area_range[1], 1.0)), max_attempts)
        p = rand_crop

        def maybe_crop(src, label, _crop=crop, _p=p):
            if pyrandom.random() < _p:
                return _crop(src, label)
            return src, label
        auglist.append(maybe_crop)
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(area_range[0], 1.0),
                               max(area_range[1], 1.0)),
                              max_attempts, pad_val)
        p = rand_pad

        def maybe_pad(src, label, _pad=pad, _p=p):
            if pyrandom.random() < _p:
                return _pad(src, label)
            return src, label
        auglist.append(maybe_pad)
    auglist.append(DetResizeAug((data_shape[2], data_shape[1]),
                                inter_method))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(_det_wrap(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(_det_wrap(ColorJitterAug(brightness, contrast,
                                                saturation)))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(_det_wrap(LightingAug(pca_noise, eigval, eigvec)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(_det_wrap(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(DataIter):
    """Detection iterator over in-memory (images, labels): yields data (N,
    C, H, W) float32 and the padded label (N, max_objects, 5), rows -1
    past an image's objects, on ``mx.cpu()``; the last batch is padded
    (``pad``). ``path_imgrec`` (a RecordIO pack) comes with the record-IO
    slice and raises here."""

    def __init__(self, batch_size, data_shape, images=None, labels=None,
                 path_imgrec=None, shuffle=False, aug_list=None,
                 max_objects=None, data_name="data", label_name="label",
                 **kwargs):
        super().__init__(batch_size)
        self._data_shape = tuple(data_shape)
        if path_imgrec is not None:
            raise MXNetError(
                "ImageDetIter(path_imgrec=...): RecordIO packs are not "
                "ported yet (the record-IO slice, ROADMAP A7); pass "
                "images and labels")
        if images is None or labels is None:
            raise MXNetError("ImageDetIter needs images+labels or "
                             "path_imgrec")
        self._images = list(images)
        self._labels = [np.asarray(l, dtype=np.float32).reshape(-1, 5)
                        for l in labels]
        self._shuffle = shuffle
        self._aug = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape)
        self._max_obj = max_objects or max(
            (l.shape[0] for l in self._labels), default=1)
        self._order = list(range(len(self._images)))
        self._pos = 0
        self.data_name, self.label_name = data_name, label_name
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self._max_obj, 5))]

    def reset(self):
        self._pos = 0
        if self._shuffle:
            pyrandom.shuffle(self._order)

    def next(self):
        if self._pos >= len(self._order):
            raise StopIteration
        n = self.batch_size
        data = np.zeros((n,) + self._data_shape, dtype=np.float32)
        label = np.full((n, self._max_obj, 5), -1.0, dtype=np.float32)
        pad = 0
        for i in range(n):
            if self._pos >= len(self._order):
                pad += 1
                continue
            idx = self._order[self._pos]
            self._pos += 1
            img = self._images[idx]
            if isinstance(img, (bytes, bytearray)):
                raise MXNetError(
                    "ImageDetIter: encoded images need imdecode, which "
                    "comes with the record-IO slice (ROADMAP A7)")
            lab = self._labels[idx].copy()
            for aug in self._aug:
                img, lab = aug(img, lab)
            img = _asnp(img).astype(np.float32)
            data[i] = img.transpose(2, 0, 1)
            k = min(lab.shape[0], self._max_obj)
            label[i, :k] = lab[:k]
        return DataBatch([array(data, ctx=cpu())], [array(label, ctx=cpu())],
                         pad=pad)
