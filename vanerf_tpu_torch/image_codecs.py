"""Image encoders of the video path that need no imaging library: baseline
JPEG and GIF89a, in numpy.

The JAX package encodes the mp4's frames with PIL's JPEG at quality 90
(``vanerf_tpu/video.py:71``) and writes the GIF with ``imageio.mimsave``
(``render_dynamic.py:116``); the port keeps its own encoders beside the
zlib PNG writer of ``evaluator.py``:

* :func:`encode_jpeg` — baseline sequential JPEG (ITU T.81) in a JFIF
  file: JFIF's YCbCr, 4:2:0 chroma (PIL's default), the 8x8 DCT as one
  matrix product over every block, the IJG tables scaled to the quality as
  libjpeg scales them, the standard Huffman tables of Annex K.  Not
  libjpeg's bytes (its integer DCT and colour conversion round elsewhere),
  but as close to the image: tests hold it to PIL's own quality-90 JPEG by
  PSNR.
* :func:`encode_gif` / :func:`write_gif` — GIF89a, one 256-entry palette a
  frame (median cut), LZW coding, a delay a frame in centiseconds and an
  endless loop.
"""

from __future__ import annotations

import struct
from typing import Iterable

import numpy as np

# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

# ITU T.81 Annex K.1: the luminance and chrominance quantization tables at
# quality 50, in natural (row-major) order
_QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
_QUANT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64)

# Annex K.3: the standard Huffman tables, (code counts by length 1..16,
# symbols in code order)
_HUFF_DC_LUMA = (bytes.fromhex("00010501010101010100000000000000"),
                 bytes(range(12)))
_HUFF_DC_CHROMA = (bytes.fromhex("00030101010101010101010000000000"),
                   bytes(range(12)))
_HUFF_AC_LUMA = (bytes.fromhex("0002010303020403050504040000017d"),
                 bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_HUFF_AC_CHROMA = (bytes.fromhex("00020102040403040705040400010277"),
                   bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _zigzag() -> np.ndarray:
    """(64,) natural index of each zigzag position."""
    order = sorted(((y, x) for y in range(8) for x in range(8)),
                   key=lambda p: (p[0] + p[1],
                                  p[1] if (p[0] + p[1]) % 2 == 0 else p[0]))
    return np.array([y * 8 + x for y, x in order], np.int64)


_ZIGZAG = _zigzag()
# the orthonormal 8-point DCT-II: the 2-D transform of a block f is
# T f T^T, which is T.81's FDCT (A.3.3)
_DCT = np.array([[(np.sqrt(0.125) if u == 0 else 0.5)
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def quant_tables(quality: int):
    """(luma, chroma) (64,) tables in natural order, libjpeg's
    ``jpeg_set_quality(quality, force_baseline=TRUE)``."""
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality {quality}: 1..100")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_QUANT_LUMA, _QUANT_CHROMA))


def _huff_codes(table):
    """(256,) codes and (256,) lengths by symbol of a canonical table."""
    counts, symbols = table
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(h, w) plane, h and w multiples of 8 -> (h/8, w/8, 8, 8) blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _magnitude(v: np.ndarray):
    """T.81's (size category, appended bits) of signed coefficients."""
    size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    bits = np.where(v >= 0, v, v + (1 << size) - 1)
    return size, bits


def _code_tables(luma, chroma):
    """(2, 256) codes and lengths by (table, symbol): luma 0, chroma 1."""
    (c0, l0), (c1, l1) = _huff_codes(luma), _huff_codes(chroma)
    return np.stack([c0, c1]), np.stack([l0, l1])


def _entropy_code(coef: np.ndarray, comp: np.ndarray) -> bytes:
    """Huffman-code (n, 64) zigzag-ordered coefficients of n blocks in scan
    order (``comp``: each block's component, 0 = Y) with the standard
    tables into byte-stuffed scan data."""
    n = len(coef)
    dc_code, dc_len = _code_tables(_HUFF_DC_LUMA, _HUFF_DC_CHROMA)
    ac_code, ac_len = _code_tables(_HUFF_AC_LUMA, _HUFF_AC_CHROMA)
    table = np.minimum(comp, 1)                       # luma 0, chroma 1
    # DC: the difference to the previous block of the same component
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        sel = np.nonzero(comp == c)[0]
        dc = coef[sel, 0]
        diff[sel] = dc - np.concatenate([[0], dc[:-1]])
    size, bits = _magnitude(diff)
    keys = [np.arange(n) * 1024]
    vals = [(dc_code[table, size] << size) | bits]
    lens = [dc_len[table, size] + size]
    # AC: (run, size) symbols of the nonzero coefficients, 16 zeros a ZRL
    b, k = np.nonzero(coef[:, 1:])
    k = k + 1
    v = coef[b, k]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    zrl = run // 16
    size, bits = _magnitude(v)
    sym = (run % 16) * 16 + size
    tb = table[b]
    keys.append(b * 1024 + k * 8 + 4)
    vals.append((ac_code[tb, sym] << size) | bits)
    lens.append(ac_len[tb, sym] + size)
    zb = np.repeat(b, zrl)
    zk = np.repeat(k, zrl)
    zi = np.arange(len(zb)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
    keys.append(zb * 1024 + zk * 8 + zi)
    vals.append(ac_code[table[zb], 0xF0])
    lens.append(ac_len[table[zb], 0xF0])
    # EOB after the last nonzero coefficient, unless it is the 64th
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 1024 + 1023)
    vals.append(ac_code[table[eob], 0x00])
    lens.append(ac_len[table[eob], 0x00])

    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]
    # the bit stream, most significant bit first, padded with ones
    total = int(lens.sum())
    start = np.repeat(np.cumsum(lens) - lens, lens)
    shift = np.repeat(lens, lens) - 1 - (np.arange(total) - start)
    bitstream = (np.repeat(vals, lens) >> shift) & 1
    pad = -total % 8
    bitstream = np.concatenate([bitstream, np.ones(pad, np.int64)])
    data = np.packbits(bitstream.astype(np.uint8))
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()       # byte stuffing


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def encode_jpeg(img_u8: np.ndarray, quality: int = 90) -> bytes:
    """(H, W, 3) uint8 RGB -> a baseline JFIF JPEG (4:2:0 chroma)."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape} "
                         f"{img.dtype}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"JPEG size {w}x{h}")
    # edges replicated to whole 16x16 MCUs, as libjpeg pads
    ph, pw = -h % 16, -w % 16
    rgb = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    rgb = rgb.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    H2, W2 = rgb.shape[0] // 2, rgb.shape[1] // 2

    def down(p):                                      # 2x2 means
        return p.reshape(H2, 2, W2, 2).mean((1, 3))

    q_luma, q_chroma = quant_tables(quality)
    mh, mw = rgb.shape[0] // 16, rgb.shape[1] // 16
    # blocks in scan order: each MCU's four Y blocks, then Cb, then Cr
    yb = _blocks(y).reshape(mh, 2, mw, 2, 8, 8).transpose(0, 2, 1, 3, 4, 5)
    yb = yb.reshape(mh, mw, 4, 8, 8)
    cbb = _blocks(down(cb)).reshape(mh, mw, 1, 8, 8)
    crb = _blocks(down(cr)).reshape(mh, mw, 1, 8, 8)
    blocks = np.concatenate([yb, cbb, crb], 2).reshape(-1, 8, 8) - 128.0
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mh * mw)
    dct = (_DCT @ blocks @ _DCT.T).reshape(-1, 64)
    q = np.where((comp == 0)[:, None], q_luma, q_chroma)
    coef = np.round(dct / q).astype(np.int64)[:, _ZIGZAG]
    scan = _entropy_code(coef, comp)

    def dht(tc_th, table):
        return bytes([tc_th]) + table[0] + table[1]

    return b"".join([
        b"\xff\xd8",
        _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        _segment(0xDB, bytes([0]) + bytes(q_luma[_ZIGZAG].tolist())
                 + bytes([1]) + bytes(q_chroma[_ZIGZAG].tolist())),
        _segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                 + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])),
        _segment(0xC4, dht(0x00, _HUFF_DC_LUMA) + dht(0x10, _HUFF_AC_LUMA)
                 + dht(0x01, _HUFF_DC_CHROMA)
                 + dht(0x11, _HUFF_AC_CHROMA)),
        _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
        scan,
        b"\xff\xd9"])


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

def median_cut_palette(img_u8: np.ndarray, n_colors: int = 256):
    """(H, W, 3) uint8 -> ((K, 3) uint8 palette, K <= n_colors; (H, W)
    uint8 indices).  Median cut over the image's distinct colours weighted
    by their counts: the box with the largest weighted spread along one
    channel is split at that channel's weighted median until there are
    ``n_colors`` boxes; each box's colour is its weighted mean.  An image
    of at most ``n_colors`` colours keeps them exactly."""
    px = np.asarray(img_u8, np.uint8).reshape(-1, 3)
    key = (px[:, 0].astype(np.int64) << 16) | (px[:, 1].astype(np.int64)
                                               << 8) | px[:, 2]
    uniq, inverse, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
    colors = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], 1)
    if len(uniq) <= n_colors:
        return colors.astype(np.uint8), inverse.astype(np.uint8).reshape(
            img_u8.shape[:2])

    def spread(idx):
        c, wt = colors[idx], counts[idx]
        mean = (c * wt[:, None]).sum(0) / wt.sum()
        var = ((c - mean) ** 2 * wt[:, None]).sum(0)
        return var.max(), int(var.argmax())

    boxes = [np.arange(len(uniq))]
    scores = [spread(boxes[0])]
    while len(boxes) < n_colors:
        i = int(np.argmax([s for s, _ in scores]))
        if scores[i][0] <= 0:
            break
        idx, ch = boxes[i], scores[i][1]
        idx = idx[np.argsort(colors[idx, ch], kind="stable")]
        cum = np.cumsum(counts[idx])
        cut = int(np.searchsorted(cum, cum[-1] / 2.0))
        cut = min(max(cut, 1), len(idx) - 1)
        # never split inside a run of equal values of the channel
        v = colors[idx, ch]
        if v[cut] == v[cut - 1]:
            hi = int(np.searchsorted(v, v[cut], side="right"))
            lo = int(np.searchsorted(v, v[cut], side="left"))
            cut = hi if hi < len(idx) else lo
        lo_box, hi_box = idx[:cut], idx[cut:]
        boxes[i:i + 1] = [lo_box, hi_box]
        scores[i:i + 1] = [spread(lo_box), spread(hi_box)]
    label = np.empty(len(uniq), np.int64)
    palette = np.empty((len(boxes), 3), np.float64)
    for j, idx in enumerate(boxes):
        label[idx] = j
        wt = counts[idx]
        palette[j] = (colors[idx] * wt[:, None]).sum(0) / wt.sum()
    palette = np.clip(np.round(palette), 0, 255).astype(np.uint8)
    return palette, label[inverse].astype(np.uint8).reshape(
        img_u8.shape[:2])


def lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW of a flat index stream (codes packed least
    significant bit first; a clear code when the 4,096-entry table fills)."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    codes, widths = [clear], [min_code_size + 1]
    width, next_code, table = min_code_size + 1, eoi + 1, {}
    data = np.asarray(indices, np.int64).reshape(-1).tolist()
    prefix = data[0]
    for k in data[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        table[key] = next_code
        next_code += 1
        if next_code > (1 << width) and width < 12:
            width += 1
        if next_code == 4096:
            codes.append(clear)
            widths.append(width)
            width, next_code, table = min_code_size + 1, eoi + 1, {}
        prefix = k
    codes.append(prefix)
    widths.append(width)
    # the decoder adds an entry on reading that code: widen as it does
    next_code += 1
    if next_code > (1 << width) and width < 12:
        width += 1
    codes.append(eoi)
    widths.append(width)
    codes, widths = np.array(codes, np.int64), np.array(widths, np.int64)
    total = int(widths.sum())
    start = np.repeat(np.cumsum(widths) - widths, widths)
    bits = (np.repeat(codes, widths) >> (np.arange(total) - start)) & 1
    return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def encode_gif(frames: Iterable[np.ndarray], delay_cs: int = 10) -> bytes:
    """(H, W, 3) uint8 RGB frames -> an endlessly looping GIF89a, each
    frame with its own 256-entry palette and a delay of ``delay_cs``
    centiseconds."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0, 0, 0),
           # NETSCAPE2.0 application extension: loop forever
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w, 3):
            raise ValueError(f"frame {f.shape} {f.dtype}: expected ({h}, "
                             f"{w}, 3) uint8")
        palette, index = median_cut_palette(f)
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette
        out += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay_cs)
                + b"\x00\x00",                 # graphic control extension
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87),
                table.tobytes(), b"\x08",
                _sub_blocks(lzw_encode(index))]
    out.append(b"\x3b")
    return b"".join(out)


def write_gif(path: str, frames: Iterable[np.ndarray],
              delay_cs: int = 10) -> str:
    """Write :func:`encode_gif` of ``frames`` to ``path``; return it."""
    data = encode_gif(frames, delay_cs)
    with open(path, "wb") as f:
        f.write(data)
    return path
