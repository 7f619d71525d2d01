"""Minimal pure-Python MP4 writer (Motion-JPEG in ISO BMFF), port of
``vanerf_tpu/video.py``.

Parity target: the reference writes its free-viewpoint video as mp4 + GIF
(``src/model.py:190-207``, via ``cv2.VideoWriter``).  Without ffmpeg, cv2
or an imaging library the mp4 path is implemented directly: each frame is
JPEG-encoded (the port's own encoder, ``image_codecs.encode_jpeg``) and
muxed into an ISO base-media container with an ``mp4v``/MJPEG
(objectTypeIndication 0x6C) sample description — the same codec family
cv2's default writers use, playable by ffmpeg/VLC/QuickTime.  The box
tree is the JAX package's; the JPEG payloads, and so the sample sizes and
chunk offsets, differ.

Only what the video path needs is implemented: one video track, constant
frame rate, one sample per chunk.
"""

from __future__ import annotations

import struct
from typing import Iterable, List

import numpy as np

from .image_codecs import encode_jpeg


def _box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + btype + payload


def _full_box(btype: bytes, version: int, flags: int,
              payload: bytes) -> bytes:
    return _box(btype, struct.pack(">I", (version << 24) | flags) + payload)


def _descr(tag: int, payload: bytes) -> bytes:
    """MPEG-4 descriptor with (single-byte) expandable length."""
    assert len(payload) < 128
    return bytes([tag, len(payload)]) + payload


def _esds_mjpeg() -> bytes:
    dec_cfg = _descr(0x04, bytes([
        0x6C,               # objectTypeIndication: visual ISO 10918 (JPEG)
        0x11,               # streamType 4 (visual) << 2 | reserved 1
    ]) + b"\x00\xff\xff" + struct.pack(">II", 0, 0))  # bufsz, max/avg rate
    sl_cfg = _descr(0x06, b"\x02")
    es = _descr(0x03, struct.pack(">HB", 1, 0) + dec_cfg + sl_cfg)
    return _full_box(b"esds", 0, 0, es)


def _sample_entry_mp4v(width: int, height: int) -> bytes:
    p = b"\x00" * 6 + struct.pack(">H", 1)            # reserved, dref idx
    p += b"\x00" * 16                                 # pre_defined/reserved
    p += struct.pack(">HH", width, height)
    p += struct.pack(">II", 0x00480000, 0x00480000)   # 72 dpi
    p += b"\x00" * 4                                  # reserved
    p += struct.pack(">H", 1)                         # frame_count
    p += b"\x00" * 32                                 # compressorname
    p += struct.pack(">Hh", 0x0018, -1)               # depth, pre_defined
    p += _esds_mjpeg()
    return _box(b"mp4v", p)


_UNITY_MATRIX = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                            0x40000000)


def write_mjpeg_mp4(path: str, frames: Iterable[np.ndarray], fps: int = 10,
                    quality: int = 90) -> str:
    """Write uint8 RGB (H, W, 3) frames as an MJPEG .mp4.

    Returns the path written.
    """
    jpegs: List[bytes] = []
    width = height = None
    for f in frames:
        f = np.ascontiguousarray(np.asarray(f, dtype=np.uint8))
        if width is None:
            height, width = f.shape[:2]
        jpegs.append(encode_jpeg(f, quality))
    if not jpegs:
        raise ValueError("no frames")

    n = len(jpegs)
    timescale = int(fps)
    duration = n                                       # 1 tick per frame

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")

    # mdat starts right after ftyp; chunk offsets index into its payload
    mdat_payload = b"".join(jpegs)
    mdat = _box(b"mdat", mdat_payload)
    data_start = len(ftyp) + 8
    offsets = []
    off = data_start
    for j in jpegs:
        offsets.append(off)
        off += len(j)

    stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, 1))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
    stsz = _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n)
                     + b"".join(struct.pack(">I", len(j)) for j in jpegs))
    stco = _full_box(b"stco", 0, 0, struct.pack(">I", n)
                     + b"".join(struct.pack(">I", o) for o in offsets))
    stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1)
                     + _sample_entry_mp4v(width, height))
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)

    dref = _full_box(b"dref", 0, 0, struct.pack(">I", 1)
                     + _full_box(b"url ", 0, 1, b""))
    dinf = _box(b"dinf", dref)
    vmhd = _full_box(b"vmhd", 0, 1, b"\x00" * 8)
    minf = _box(b"minf", vmhd + dinf + stbl)

    mdhd = _full_box(b"mdhd", 0, 0, struct.pack(
        ">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0))
    hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I", 0) + b"vide"
                     + b"\x00" * 12 + b"VideoHandler\x00")
    mdia = _box(b"mdia", mdhd + hdlr + minf)

    tkhd = _full_box(b"tkhd", 0, 7, struct.pack(
        ">IIIII", 0, 0, 1, 0, duration) + b"\x00" * 8
        + struct.pack(">hhhh", 0, 0, 0, 0) + _UNITY_MATRIX
        + struct.pack(">II", width << 16, height << 16))
    trak = _box(b"trak", tkhd + mdia)

    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(
        ">IIII", 0, 0, timescale, duration)
        + struct.pack(">IH", 0x00010000, 0x0100) + b"\x00" * 10
        + _UNITY_MATRIX + b"\x00" * 24 + struct.pack(">I", 2))
    moov = _box(b"moov", mvhd + trak)

    with open(path, "wb") as fh:
        fh.write(ftyp + mdat + moov)
    return path


def parse_boxes(data: bytes, offset: int = 0, end: int | None = None):
    """Iterate top-level (type, payload_start, payload_end) box triples —
    used by tests to validate the container structure."""
    end = len(data) if end is None else end
    out = []
    while offset + 8 <= end:
        size, btype = struct.unpack(">I4s", data[offset:offset + 8])
        if size < 8:
            break
        out.append((btype, offset + 8, offset + size))
        offset += size
    return out
