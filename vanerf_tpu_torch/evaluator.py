"""Evaluation metrics: MSE / PSNR / SSIM (+ LPIPS when weights are
available), port of ``vanerf_tpu/evaluator.py``.

Parity target: ``Evaluator`` (reference ``src/evaluator.py:7-114``): PSNR on
the full image, SSIM on the mask-at-box bounding-rect crop, per-image
pred/gt/input PNG dumps.  LPIPS needs converted AlexNet weights
(``VANERF_LPIPS_NPZ``) and reports NaN otherwise; the report says which.
The PNGs are lossless 8-bit RGB, written by the small zlib encoder here
(no imaging library needed); :func:`read_png` reads them and other
writers' 8-bit RGB files back.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .losses import ssim as ssim_map


def bounding_rect(mask: np.ndarray):
    """(x, y, w, h) of the tight bounding box of a binary mask
    (cv2.boundingRect replacement)."""
    ys, xs = np.where(mask > 0)
    if len(xs) == 0:
        return 0, 0, mask.shape[1], mask.shape[0]
    x, y = xs.min(), ys.min()
    return int(x), int(y), int(xs.max() - x + 1), int(ys.max() - y + 1)


def compute_psnr(img_pred: np.ndarray, img_gt: np.ndarray) -> float:
    """-10 log10(mse) (evaluator.py:15-19)."""
    mse = np.mean((img_pred - img_gt) ** 2)
    return float(-10.0 * np.log(mse) / np.log(10.0))


def compute_ssim_crop(img_pred: np.ndarray, img_gt: np.ndarray,
                      mask_at_box: np.ndarray, device="cpu") -> float:
    """Mean SSIM over the mask bounding-rect crop (evaluator.py:21-45),
    7x7 box window (skimage's default for multichannel float images),
    computed on ``device``."""
    x, y, w, h = bounding_rect(mask_at_box)
    p = img_pred[y:y + h, x:x + w]
    g = img_gt[y:y + h, x:x + w]
    if min(p.shape[:2]) < 7:
        return float("nan")

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)[None]

    return float(ssim_map(T(p), T(g), win=7).mean())


# ---------------------------------------------------------------------------
# PNG (8-bit, lossless)
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img_u8: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG (every row filter type 0)."""
    img = np.ascontiguousarray(img_u8, np.uint8)
    h, w, c = img.shape
    assert c == 3, img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced RGB PNG (the evaluator's dumps, written here
    or by another writer with any of the five row filters) -> (H, W, 3)
    uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype != 2 or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB PNGs are "
                         "read")
    bpp = 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:                               # Sub
            cur = np.cumsum(line.reshape(w, bpp), 0).reshape(-1) & 255
        elif ftype == 2:                               # Up
            cur = (line + prior) & 255
        elif ftype in (3, 4):                          # Average, Paeth
            cur = np.zeros_like(line)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(w):
                sl = slice(x * bpp, (x + 1) * bpp)
                up = prior[sl]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - up_left
                    pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                                  np.abs(p - up_left))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, up_left))
                cur[sl] = (line[sl] + pred) & 255
                left, up_left = cur[sl], up
        else:
            raise ValueError(f"{path}: row filter {ftype}")
        out[y] = cur
        prior = cur.astype(np.int32)
    return out.reshape(h, w, bpp)


def _to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


class Evaluator:
    """Accumulates per-frame scores and dumps pred/gt/input images; the
    SSIM and LPIPS run on ``device`` (default: the card; pass "cpu" to ask
    for the CPU)."""

    def __init__(self, result_dir: Optional[str] = None, device=None):
        self.result_dir = result_dir
        self.device = resolve_device(device)
        self.lpips_fn = _try_load_lpips(self.device)

    def compute_score(self, rgb_pred: np.ndarray, rgb_gt: np.ndarray,
                      input_imgs: Optional[np.ndarray] = None,
                      mask_at_box: Optional[np.ndarray] = None,
                      human_idx: str = "0", frame_index: str = "0",
                      view_index: str = "0") -> Dict[str, float]:
        """All images are float (H, W, 3) in [0, 1], channels-last."""
        rgb_pred = np.asarray(rgb_pred)
        rgb_gt = np.asarray(rgb_gt)
        if mask_at_box is None:
            mask_at_box = np.ones(rgb_pred.shape[:2], np.uint8)
        mask_at_box = np.asarray(mask_at_box).squeeze()

        if self.result_dir is not None:
            self._save_images(rgb_pred, rgb_gt, input_imgs, mask_at_box,
                              human_idx, frame_index, view_index)

        mse = float(np.mean((rgb_pred - rgb_gt) ** 2))
        out = {
            "mse": mse,
            "psnr": compute_psnr(rgb_pred, rgb_gt),
            "ssim": compute_ssim_crop(rgb_pred, rgb_gt, mask_at_box,
                                      self.device),
        }
        if self.lpips_fn is not None and (
                min(bounding_rect(mask_at_box)[2:]) >= 32):
            x, y, w, h = bounding_rect(mask_at_box)
            # the reference computes LPIPS on PNG-saved and reloaded crops
            # (src/evaluator.py:47-64): quantize to uint8 first
            p8 = _png_roundtrip(rgb_pred[y:y + h, x:x + w])
            g8 = _png_roundtrip(rgb_gt[y:y + h, x:x + w])
            out["lpips"] = float(self.lpips_fn(p8, g8))
        else:
            # no weights, or a crop under 32 px, which AlexNet's stride-4
            # conv and two 3x3/2 pools reduce to nothing
            out["lpips"] = float("nan")
        return out

    def _save_images(self, pred, gt, inputs, mask_at_box, human_idx,
                     frame_index, view_index):
        human_dir = os.path.join(self.result_dir, str(human_idx))
        x, y, w, h = bounding_rect(mask_at_box)
        for sub, img in [("pred", pred[y:y + h, x:x + w]),
                         ("gt", gt[y:y + h, x:x + w])]:
            d = os.path.join(human_dir, sub)
            os.makedirs(d, exist_ok=True)
            suffix = "_gt" if sub == "gt" else ""
            write_png(os.path.join(d, f"frame{frame_index}_view{view_index}"
                                   f"{suffix}.png"), _to_u8(img))
        if inputs is not None:
            d = os.path.join(human_dir, "input")
            os.makedirs(d, exist_ok=True)
            for vi in range(inputs.shape[0]):
                write_png(os.path.join(
                    d, f"frame{frame_index}_t_0_view_{view_index}.png"),
                    _to_u8(inputs[vi][y:y + h, x:x + w]))


def _png_roundtrip(img: np.ndarray) -> np.ndarray:
    """uint8-quantize a float [0,1] image exactly as a PNG save+reload
    would (PNG is lossless, so the only effect is the uint8 cast)."""
    return _to_u8(img).astype(np.float32) / 255.0


def _try_load_lpips(device="cpu"):
    """LPIPS-Alex from converted weights on ``device``; None if
    unavailable."""
    path = os.environ.get("VANERF_LPIPS_NPZ", "")
    if not path or not os.path.exists(path):
        return None
    from .lpips import LPIPS
    return LPIPS(path).to(device)
