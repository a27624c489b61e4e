"""Image loading and bucketing for the port (counterpart of
``must3r_tpu/tools/image.py``): aspect buckets, centre crop + resize
with its pixel transforms, 0.5 / 0.5 normalisation, landscape storage, the
SLAM frame preprocessing and the training colour jitter.

PIL is imported only where an image file is read; resizing runs through
torch with OpenCV's semantics (as the JAX package's ``cv2.resize``), so the
rest needs neither PIL nor OpenCV.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# one dict per max dimension; keys are landscape aspect ratios, values
# [long, short] resolutions
RATIOS_RESOLUTIONS: Dict[int, Dict[float, Tuple[int, int]]] = {
    224: {1.0: (224, 224)},
    336: {1.0: (336, 336)},
    384: {4 / 3: (384, 288), 3 / 2: (384, 256), 2 / 1: (384, 192),
          3 / 1: (384, 128)},
    448: {1.0: (448, 448)},
    512: {4 / 3: (512, 384), 32 / 21: (512, 336), 16 / 9: (512, 288),
          2 / 1: (512, 256), 16 / 5: (512, 160)},
    768: {4 / 3: (768, 576), 3 / 2: (768, 512), 16 / 9: (768, 432),
          2 / 1: (768, 384), 16 / 5: (768, 240)},
}
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff",
                    ".webp", ".ppm", ".pgm")
IMG_MEAN = 0.5
IMG_STD = 0.5


def resolution_table(maxdim: int, patch_size: int = 16):
    """Bucket table for a max dimension (derived from the 512 ratios for
    sizes outside the reference table); a table passes through."""
    if isinstance(maxdim, dict):
        return maxdim
    if maxdim in RATIOS_RESOLUTIONS:
        return RATIOS_RESOLUTIONS[maxdim]
    if maxdim % patch_size:
        raise ValueError(f"image size {maxdim} is not a multiple of the "
                         f"patch size {patch_size}")
    out = {}
    for r in (1.0, *RATIOS_RESOLUTIONS[512].keys()):
        short = round(maxdim / r / patch_size) * patch_size
        if short >= patch_size:
            out[maxdim / short] = (maxdim, short)
    return out


def get_hw_resolution(h: int, w: int, maxdim: int,
                      patch_size: int = 16) -> Tuple[int, int]:
    """Bucket (H, W) for an image: nearest aspect ratio in the table;
    portrait images get the transposed bucket."""
    table = resolution_table(maxdim, patch_size)
    keys = np.array(list(table.keys()))
    landscape = w >= h
    ratio = w / h
    diff = np.abs(ratio - keys) if landscape else np.abs(ratio - 1.0 / keys)
    long_side, short_side = table[float(keys[np.argmin(diff)])]
    return (short_side, long_side) if landscape else (long_side, short_side)


def get_resize_function(maxdim, patch_size: int, h: int, w: int,
                        is_mask: bool = False):
    """Centre crop to the bucket's aspect, then resize to it (the offline
    and the training view pipelines). ``maxdim`` is a max dimension or a
    bucket table.

    Returns (fn, to_rescaled, to_orig): fn maps an [H, W(, C)] numpy array
    to the bucket shape; the 3x3 matrices map homogeneous pixel coordinates
    original -> rescaled and back. The resize has OpenCV's semantics, as
    the JAX package's ``cv2.resize``: nearest for masks, area averaging to
    shrink, bilinear to enlarge."""
    table = resolution_table(maxdim, patch_size)
    if (max(h, w), min(h, w)) in {tuple(v) for v in table.values()}:
        return (lambda x: x), np.eye(3), np.eye(3)
    th, tw = get_hw_resolution(h, w, table, patch_size)
    target = tw / th
    to_orig_crop, to_rescaled_crop = np.eye(3), np.eye(3)
    if abs(w / h - target) < np.finfo(np.float32).eps:
        crop_w, crop_h = w, h
    elif w / h < target:
        crop_w, crop_h = w, int(w / target)
        to_orig_crop[1, 2] = (h - crop_h) / 2.0
        to_rescaled_crop[1, 2] = -(h - crop_h) / 2.0
    else:
        crop_w, crop_h = int(h * target), h
        to_orig_crop[0, 2] = (w - crop_w) / 2.0
        to_rescaled_crop[0, 2] = -(w - crop_w) / 2.0
    to_orig_resize = np.diag([crop_w / tw, crop_h / th, 1.0])
    to_rescaled_resize = np.diag([tw / crop_w, th / crop_h, 1.0])

    def fn(img: np.ndarray) -> np.ndarray:
        y0 = (img.shape[0] - crop_h) // 2
        x0 = (img.shape[1] - crop_w) // 2
        return resize_image(img[y0:y0 + crop_h, x0:x0 + crop_w], (th, tw),
                            nearest=is_mask)

    return (fn, to_rescaled_resize @ to_rescaled_crop,
            to_orig_crop @ to_orig_resize)


def _area_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_out, n_in] weights of INTER_AREA along one axis: output pixel i
    averages the source span [i * s, (i + 1) * s), s = n_in / n_out, each
    source pixel weighted by the part of it the span covers."""
    s = n_in / n_out
    lo = torch.arange(n_out, dtype=torch.float64)[:, None] * s
    j = torch.arange(n_in, dtype=torch.float64)[None, :]
    cover = (torch.minimum(lo + s, j + 1) - torch.maximum(lo, j)).clamp_min(0)
    return cover / s


def resize_image(img: np.ndarray, hw: Tuple[int, int],
                 nearest: bool = False) -> np.ndarray:
    """cv2.resize semantics through torch: INTER_NEAREST (src = floor(dst *
    in / out)), INTER_AREA to shrink, INTER_LINEAR (half-pixel centres) to
    enlarge; uint8 rounds half up."""
    th, tw = hw
    if img.shape[:2] == (th, tw):
        return img
    t = torch.from_numpy(np.ascontiguousarray(img)).double()
    t = t[..., None] if img.ndim == 2 else t                   # H, W, C
    if not nearest and th < img.shape[0]:
        out = torch.einsum("yh,hwc,xw->yxc", _area_weights(t.shape[0], th),
                           t, _area_weights(t.shape[1], tw))
    else:
        mode = "nearest" if nearest else "bilinear"
        kw = {} if nearest else {"align_corners": False}
        out = F.interpolate(t.permute(2, 0, 1)[None], size=(th, tw),
                            mode=mode, **kw)[0].permute(1, 2, 0)
    out = out[..., 0] if img.ndim == 2 else out
    if img.dtype == np.uint8:
        return torch.floor(out + 0.5).clamp(0, 255).to(torch.uint8).numpy()
    return out.numpy().astype(img.dtype)


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """float [..., 3] in [0, 1] -> HSV with h in [0, 1)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc, minc = rgb.max(-1), rgb.min(-1)
    span = maxc - minc
    s = np.where(maxc > 0, span / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(span, 1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(span > 0, (h / 6.0) % 1.0, 0.0)
    return np.stack([h, s, maxc], -1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    choices = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return np.take_along_axis(choices, i[None, ..., None], axis=0)[0]


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.5, contrast: float = 0.5,
                 saturation: float = 0.5, hue: float = 0.1) -> np.ndarray:
    """torchvision ``ColorJitter(0.5, 0.5, 0.5, 0.1)`` in numpy: factors
    drawn uniformly, applied in a random order. uint8 in, uint8 out."""
    x = img.astype(np.float32) / 255.0

    def gray(x):
        return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]

    def adj_hue(x, d):
        hsv = _rgb_to_hsv(np.clip(x, 0.0, 1.0))
        hsv[..., 0] = (hsv[..., 0] + d) % 1.0
        return _hsv_to_rgb(hsv)

    ops = []
    if brightness > 0:
        ops.append((lambda x, f: x * f,
                    rng.uniform(max(0.0, 1 - brightness), 1 + brightness)))
    if contrast > 0:
        ops.append((lambda x, f: f * x + (1.0 - f) * gray(x).mean(),
                    rng.uniform(max(0.0, 1 - contrast), 1 + contrast)))
    if saturation > 0:
        ops.append((lambda x, f: f * x + (1.0 - f) * gray(x)[..., None],
                    rng.uniform(max(0.0, 1 - saturation), 1 + saturation)))
    if hue > 0:
        ops.append((adj_hue, rng.uniform(-hue, hue)))
    for k in rng.permutation(len(ops)):
        fn, f = ops[k]
        x = np.clip(fn(x, f), 0.0, 1.0)
    return (x * 255.0 + 0.5).astype(np.uint8)


def resolve_transform(name):
    """A transform spec -> callable ``(uint8 img, np.random.Generator) ->
    uint8 img`` applied before the normalisation; None = none."""
    if name is None or callable(name):
        return name
    key = str(name).lower().replace("+imgnorm", "")
    if key in ("", "imgnorm"):
        return None
    if key == "colorjitter":
        return color_jitter
    raise ValueError(f"unknown transform {name!r}")


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 normalised (mean = std = 0.5)."""
    return (img.astype(np.float32) / 255.0 - IMG_MEAN) / IMG_STD


def denormalize_image(img: np.ndarray) -> np.ndarray:
    return np.clip((img * IMG_STD + IMG_MEAN) * 255.0, 0, 255
                   ).astype(np.uint8)


def denormalize_images(imgs: torch.Tensor) -> torch.Tensor:
    """:func:`denormalize_image` of a tensor of images on its own device:
    the same operations in the tensor's dtype (float32: bitwise equal)."""
    return ((imgs * IMG_STD + IMG_MEAN) * 255.0).clamp(0, 255).to(
        torch.uint8)


def to_landscape(img: np.ndarray) -> Tuple[np.ndarray, bool]:
    """Store portrait images transposed (the network always sees W >= H;
    the head transposes predictions back). Returns (image, portrait)."""
    if img.shape[0] > img.shape[1]:
        return np.ascontiguousarray(np.swapaxes(img, 0, 1)), True
    return img, False


def preprocess_image(img: np.ndarray, maxdim: int, patch_size: int = 16):
    """Bucket, normalise and store landscape. Returns dict 'img' float32
    [Hb, Wb, 3] (landscape), 'true_shape' (H, W) of the bucketed image
    before transposition, 'portrait' bool."""
    h, w = img.shape[:2]
    out = normalize_image(get_resize_function(maxdim, patch_size, h, w)[0](
        img))
    true_shape = out.shape[:2]
    out, portrait = to_landscape(out)
    return {"img": out, "true_shape": true_shape, "portrait": portrait}


def preprocess_frame(img: np.ndarray, res: int, patch_size: int = 16,
                     square: bool = False, normalize: bool = True):
    """SLAM preprocessing (reference slam/model.py:99-120): resize the long
    side to ``res``, centre-crop each side down to a multiple of the patch
    size (or to a square for the 224-class models), store landscape.

    ``normalize=False`` keeps uint8 pixels, which the streaming engine
    uploads and normalises on the device. Returns dict 'img' [H, W, 3],
    'true_shape' (H, W) before transposition, 'portrait' bool."""
    h, w = img.shape[:2]
    scale = res / max(h, w)
    nh, nw = round(h * scale), round(w * scale)
    img = resize_image(img, (nh, nw))
    if square:
        ch = cw = min(nh, nw) // patch_size * patch_size
    else:
        ch = nh // patch_size * patch_size
        cw = nw // patch_size * patch_size
    y0 = (nh - ch) // 2
    x0 = (nw - cw) // 2
    img = img[y0:y0 + ch, x0:x0 + cw]
    if normalize and img.dtype == np.uint8:
        img = normalize_image(img)
    stored, portrait = to_landscape(img)
    return {"img": stored, "true_shape": (ch, cw), "portrait": portrait}


def load_image(path: str) -> np.ndarray:
    """Read an image file to RGB uint8 (EXIF-transposed)."""
    import PIL.Image
    import PIL.ImageOps

    with PIL.Image.open(path) as pil:
        return np.asarray(PIL.ImageOps.exif_transpose(pil).convert("RGB"))


def read_png(path: str, grayscale: bool = False):
    """A PNG's values as OpenCV's ``imread`` gives them for a one-channel
    file (uint8 or uint16 [H, W]; ``grayscale``: 8-bit luma), or None where
    the file is missing or unreadable."""
    import PIL.Image

    try:
        with PIL.Image.open(path) as pil:
            return np.asarray(pil.convert("L") if grayscale else pil)
    except OSError:
        return None


def load_images(paths: Sequence[str], maxdim: int, patch_size: int = 16,
                verbose: bool = False) -> List[dict]:
    """Load and preprocess a collection; each view also carries 'path'."""
    views = []
    for p in paths:
        view = preprocess_image(load_image(p), maxdim, patch_size)
        view["path"] = p
        views.append(view)
        if verbose:
            print(f"loaded {p} -> {view['img'].shape}")
    return views


def load_vggt_frames(paths: Sequence[str], width: int = 518,
                     patch_size: int = 14) -> List[np.ndarray]:
    """Frames for VGGT, as its published loader crops them: each image
    resized (bicubic) to ``width`` wide and a height of the nearest
    multiple of the patch that keeps its aspect, a taller result cropped
    to ``width`` about its centre; float32 [H, W, 3] in [0, 1]."""
    import PIL.Image

    frames = []
    for p in paths:
        img = load_image(p)
        h = int(round(img.shape[0] * width / img.shape[1] / patch_size)
                ) * patch_size
        img = np.asarray(PIL.Image.fromarray(img).resize(
            (width, h), PIL.Image.Resampling.BICUBIC))
        if h > width:
            top = (h - width) // 2
            img = img[top:top + width]
        frames.append(img.astype(np.float32) / 255.0)
    return frames


def list_images(folder: str) -> List[str]:
    """Sorted image files of a folder, by extension."""
    return [os.path.join(folder, name) for name in sorted(os.listdir(folder))
            if os.path.splitext(name)[1].lower() in IMAGE_EXTENSIONS]
