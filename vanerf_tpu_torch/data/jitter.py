"""torchvision-exact ColorJitter for the InterHand loader (port of
``vanerf_tpu/data/jitter.py``).

The reference jitters every source/target view with
``transforms.ColorJitter(brightness=(0.2, 2), contrast=(0.3, 2),
saturation=(0.2, 2), hue=(-0.5, 0.5))`` after ``torch.manual_seed(prob)``
with a per-item ``prob`` shared across views (ref ``src/dataset.py:113-120,
374, 455-459``).  This module reproduces torchvision bit for bit:

  * RNG draws match ``ColorJitter.get_params``: ``torch.randperm(4)`` for
    the op order, then one ``uniform_`` per factor in the fixed order
    brightness, contrast, saturation, hue.
  * The ops themselves go through PIL (``ImageEnhance`` / HSV), the
    backend torchvision's functional_pil uses for the PIL images the
    reference feeds it (``dataset.py:455-459``).  PIL is imported inside
    the function that applies them.
"""

from __future__ import annotations

import numpy as np
import torch

BRIGHTNESS = (0.2, 2.0)
CONTRAST = (0.3, 2.0)
SATURATION = (0.2, 2.0)
HUE = (-0.5, 0.5)


def jitter_params(seed: int):
    """Replicate ColorJitter.get_params draws after manual_seed(seed).

    Returns (fn_idx (4,), brightness, contrast, saturation, hue).
    """
    g = torch.Generator()
    g.manual_seed(int(seed))
    fn_idx = torch.randperm(4, generator=g).tolist()
    b = float(torch.empty(1).uniform_(*BRIGHTNESS, generator=g))
    c = float(torch.empty(1).uniform_(*CONTRAST, generator=g))
    s = float(torch.empty(1).uniform_(*SATURATION, generator=g))
    h = float(torch.empty(1).uniform_(*HUE, generator=g))
    return fn_idx, b, c, s, h


def apply_jitter(img_u8: np.ndarray, fn_idx, b, c, s, h) -> np.ndarray:
    """Apply the four jitter ops in ``fn_idx`` order via PIL.

    Mirrors torchvision ``_functional_pil``: brightness/contrast/saturation
    are ``ImageEnhance`` blends, hue is a uint8-wrapping HSV channel shift.

    Args:
      img_u8: (H, W, 3) uint8 RGB.
    Returns:
      (H, W, 3) uint8 RGB.
    """
    from PIL import Image, ImageEnhance

    img = Image.fromarray(img_u8)
    for i in fn_idx:
        if i == 0:
            img = ImageEnhance.Brightness(img).enhance(b)
        elif i == 1:
            img = ImageEnhance.Contrast(img).enhance(c)
        elif i == 2:
            img = ImageEnhance.Color(img).enhance(s)
        else:
            hch, sch, vch = img.convert("HSV").split()
            np_h = np.asarray(hch, dtype=np.uint8).copy()
            # torchvision does `np_h += np.uint8(hue_factor * 255)`, whose
            # negative-value wrap numpy 2.x now rejects — reproduce the
            # C-cast (truncate toward zero, modulo 256) explicitly.
            with np.errstate(over="ignore"):
                np_h += np.uint8(int(h * 255) % 256)
            hch = Image.fromarray(np_h, "L")
            img = Image.merge("HSV", (hch, sch, vch)).convert("RGB")
    return np.asarray(img)


def color_jitter_ref(img_u8: np.ndarray, seed: int) -> np.ndarray:
    """The full reference jitter: seed -> params -> ops.

    Calling this with the same per-item seed for every view reproduces the
    reference's shared-seed behavior (``torch.manual_seed(prob)`` before
    each view's jitter, ``dataset.py:455-459``).
    """
    fn_idx, b, c, s, h = jitter_params(seed)
    return apply_jitter(img_u8, fn_idx, b, c, s, h)
