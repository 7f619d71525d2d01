"""The port's video-path modules and the rest of its helpers against the
JAX package's, on the same numpy inputs: ``camera_path``, ``transforms``,
``mano/mesh``, ``data/densepose``, ``profiling``, ``native``, and the
encoders that take the place of PIL and imageio (``image_codecs``,
``video``).

Tolerances: ``get_360cameras``, the numpy transforms, ``edge_subdivide``,
``densepose_colors`` and the native library's results equal; the torch
transforms within rtol 1e-6 (``make_krt``'s product relative to the sum of
its terms' magnitudes); ``face_vertices`` / ``vertex_normals`` within
1e-6.  The JPEG, decoded by PIL: >= 38 dB PSNR on the 256^2 synthetic
fixture's source image and within 0.5 dB of PIL's own quality-90 JPEG of
it, its quantization and Huffman tables PIL's.  The GIF, decoded by PIL:
its frame count, 10 cs a frame, a mean absolute error <= 4 levels (a frame
of <= 256 colours exact).  The mp4: the JAX writer's box tree and sample
count, parsed by JAX's ``parse_boxes``.
"""

import io
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_helpers as h


# ---------------------------------------------------------------------------
# camera path, transforms, mesh, densepose, profiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_frames,rows", [(20, 4), (7, 3), (90, 4)])
def test_get_360cameras_equal_to_the_bit(n_frames, rows):
    from vanerf_tpu.camera_path import get_360cameras as jax_cams
    from vanerf_tpu_torch.camera_path import get_360cameras
    rs = np.random.RandomState(n_frames)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rs.randn(3, 3))[0]
    pose[:3, 3] = rs.randn(3)
    args = (pose[:rows], 7603.2, 10.0, 1.3, 256, 192, 5.0, 15.0, n_frames)
    got, want = get_360cameras(*args), jax_cams(*args)
    assert len(got) == len(want) == n_frames
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_numpy_transforms_equal():
    from vanerf_tpu import transforms as tj
    from vanerf_tpu_torch import transforms as tt
    rs = np.random.RandomState(0)
    pts = rs.randn(50, 3).astype(np.float32) + [0, 0, 4]
    f, c = (500.0, 510.0), (128.0, 96.0)
    R = np.linalg.qr(rs.randn(3, 3))[0].astype(np.float32)
    T = rs.randn(3).astype(np.float32)
    for name, args in (("cam2pixel", (pts, f, c)), ("pixel2cam", (pts, f, c)),
                       ("world2cam", (pts.T, R, T)),
                       ("cam2world", (pts.T, R, T[:, None]))):
        np.testing.assert_array_equal(getattr(tt, name)(*args),
                                      getattr(tj, name)(*args), err_msg=name)


def test_torch_transforms_match_jax():
    """At JAX's highest matmul precision (exact f32 products, as
    ``VANERF_PRECISION=highest`` runs the parity tests)."""
    import jax
    import jax.numpy as jnp
    from vanerf_tpu import transforms as tj
    from vanerf_tpu_torch import transforms as tt
    rs = np.random.RandomState(1)
    pts = (rs.randn(2, 40, 3) * 0.1).astype(np.float32)
    K = np.tile(np.array([[500, 0, 128], [0, 500, 96], [0, 0, 1]],
                         np.float32), (2, 1, 1))
    Rt = np.concatenate([np.linalg.qr(rs.randn(2, 3, 3))[0],
                         rs.randn(2, 3, 1) + [[[0], [0], [3]]]], -1) \
        .astype(np.float32)

    def close(a, b, name):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)

    with jax.default_matmul_precision("highest"):
        want = tj.make_krt(jnp.asarray(K), jnp.asarray(Rt))
        krt = tt.make_krt(torch.from_numpy(K), torch.from_numpy(Rt))
        xy_j, z_j = tj.project_points(jnp.asarray(pts),
                                      jnp.asarray(krt[0].numpy()))
    # KRT's entries cancel terms of ~500 (K) x ~3 (t): relative to the sum
    # of the terms' magnitudes, the error bound of a product
    k4, rt4 = krt[1].numpy(), krt[2].numpy()
    terms = np.abs(k4) @ np.abs(rt4)
    assert (np.abs(krt[0].numpy() - np.asarray(want[0])) <= 1e-6 * terms).all()
    for a, b in zip(krt[1:], want[1:]):
        close(a, b, "make_krt intrin / extrin")
    xy, z = tt.project_points(torch.from_numpy(pts), krt[0])
    close(xy, xy_j, "project_points xy")
    close(z, z_j, "project_points z")
    close(tt.normalize_pixel(xy, 256, 192),
          tj.normalize_pixel(xy_j, 256, 192), "normalize_pixel")
    close(tt.normalize_depth(z, 2.5, 3.5), tj.normalize_depth(z_j, 2.5, 3.5),
          "normalize_depth")


def test_edge_subdivide_and_normals_match_jax():
    import jax.numpy as jnp
    from vanerf_tpu.mano import mesh as mj
    from vanerf_tpu_torch.data.synthetic import two_hand_mesh
    from vanerf_tpu_torch.mano import mesh as mt
    verts, faces, _ = two_hand_mesh(0, 1)
    for a, b in zip(mt.edge_subdivide(verts, faces),
                    mj.edge_subdivide(verts, faces)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    v, f = mt.edge_subdivide(verts, faces)[:2]
    v = v.astype(np.float32)
    vb = np.stack([v, v * 1.5 + 0.1])
    np.testing.assert_allclose(
        mt.face_vertices(torch.from_numpy(vb), torch.from_numpy(f)).numpy(),
        np.asarray(mj.face_vertices(jnp.asarray(vb), jnp.asarray(f))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        mt.vertex_normals(torch.from_numpy(v), torch.from_numpy(f)).numpy(),
        np.asarray(mj.vertex_normals(jnp.asarray(v), jnp.asarray(f))),
        rtol=1e-6, atol=1e-6)


def test_densepose_colors_equal_jax():
    from vanerf_tpu.data import densepose as dj
    from vanerf_tpu_torch.data import densepose as dt
    for n in (779, 1558):
        got, want = dt.densepose_colors(n), dj.densepose_colors(n)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.float32
    for n in (778, 1000):
        with pytest.raises(ValueError):
            dt.densepose_colors(n)


def git_ignored(path: str) -> bool:
    """Whether ``.gitignore`` ignores the repository path ``path``: its
    last matching pattern, ``!`` negating (the forms the file uses: a
    pattern with a slash matches the whole path, one without it the last
    component)."""
    import fnmatch
    ignored = False
    with open(os.path.join(h.ROOT, ".gitignore")) as f:
        for line in f:
            pat = line.strip()
            if not pat or pat.startswith("#"):
                continue
            neg = pat.startswith("!")
            pat = pat.lstrip("!").strip("/")
            target = path if "/" in pat else os.path.basename(path)
            if fnmatch.fnmatchcase(target, pat):
                ignored = not neg
    return ignored


def test_densepose_asset_is_tracked():
    """The port's copy of ``v_color.npz`` is not ignored (its own exception
    to ``.gitignore``'s ``*.npz``), where a stray ``.npz`` is."""
    assert not git_ignored("vanerf_tpu_torch/data/assets/v_color.npz")
    assert not git_ignored("vanerf_tpu/data/assets/v_color.npz")
    assert git_ignored("vanerf_tpu_torch/data/other.npz")
    if os.path.isdir(os.path.join(h.ROOT, ".git")):
        proc = subprocess.run(["git", "check-ignore", "-q",
                               "vanerf_tpu_torch/data/assets/v_color.npz"],
                              cwd=h.ROOT)
        assert proc.returncode == 1


def test_nan_guard_raises_on_the_same_dicts():
    from vanerf_tpu.profiling import nan_guard as nj
    from vanerf_tpu_torch.profiling import nan_guard as nt
    for logs in ({"a": 1.0, "b": np.float32(2.0)},
                 {"a": torch.tensor(1.0), "b": float("nan")},
                 {"g": float("inf")}, {"g": torch.tensor(float("-inf"))},
                 {}):
        raised = []
        for fn in (nt, nj):
            try:
                fn(logs, step=3)
                raised.append(None)
            except FloatingPointError as e:
                raised.append(str(e))
        assert raised[0] == raised[1], logs


def test_profiling_trace_and_timed(tmp_path):
    """``trace`` writes the Chrome trace, with the block's span, and its
    counters beside it: the program's work counters and the kernels'
    launch counters (``timed``, which nothing read, is gone)."""
    from vanerf_tpu_torch.profiling import count, span, trace
    with trace(str(tmp_path / "prof"), "t.json"):
        with span("vanerf.test"):
            torch.ones(8).sum()
        count("samples", 2)
    with open(tmp_path / "prof" / "t.json") as f:
        text = f.read()
    assert '"traceEvents"' in text and '"vanerf.test"' in text
    with open(tmp_path / "prof" / "t.counters.json") as f:
        counts = json.load(f)
    assert counts["samples"] == 2 and counts["mesh_query"] == 0


# ---------------------------------------------------------------------------
# the native library
# ---------------------------------------------------------------------------

def native_snapshot() -> dict:
    d = os.path.join(h.ROOT, "native")
    return {n: (os.stat(os.path.join(d, n)).st_mtime_ns,
                os.stat(os.path.join(d, n)).st_size) for n in os.listdir(d)}


def test_native_equals_jax_native(tmp_path, monkeypatch):
    """One point set against the fixture's mesh and one raster of its
    projection, through the port's build of ``native/vanerf_geom.cpp``
    (compiled afresh into a build directory of its own here) and through
    the JAX package's library: equal; ``native/`` untouched."""
    from vanerf_tpu import native as nj
    from vanerf_tpu_torch import native as nt
    from vanerf_tpu_torch.data.synthetic import two_hand_mesh
    before = native_snapshot()
    monkeypatch.setattr(nt, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nt, "_LIB", None)
    assert nt.available() and nj.available()
    assert nt.library_path().parent == tmp_path / "build"
    assert nt.library_path().exists()
    verts, faces, _ = two_hand_mesh(0, 2)
    pts = h.two_hand_points(500)
    tri = verts[faces].astype(np.float32)
    for a, b in zip(nt.point_mesh_query_native(pts, tri),
                    nj.point_mesh_query_native(pts, tri)):
        np.testing.assert_array_equal(a, b)
    xy = ((verts[:, :2] - verts[:, :2].min(0)) / np.ptp(verts[:, :2], 0)
          * 30 + 1).astype(np.float32)
    z = (verts[:, 2] + 2).astype(np.float32)
    got = nt.rasterize_native(xy, z, faces, 32, 32)
    want = nj.rasterize_native(xy, z, faces, 32, 32)
    assert (got[0] >= 0).mean() > 0.3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        nt.rasterize_native(xy, z, faces + len(xy), 32, 32)
    assert native_snapshot() == before
    if os.path.isdir(os.path.join(h.ROOT, ".git")):
        status = subprocess.run(["git", "status", "--porcelain", "native/"],
                                cwd=h.ROOT, capture_output=True, text=True)
        assert status.returncode == 0 and status.stdout == ""


# ---------------------------------------------------------------------------
# JPEG, GIF, mp4
# ---------------------------------------------------------------------------

def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse))


def pil_decode(data: bytes) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def pil_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.fixture(scope="module")
def source_image():
    """The 256^2 synthetic fixture's source image, as uint8."""
    from vanerf_tpu_torch.data import make_synthetic_batch
    batch, _, _ = make_synthetic_batch(1, H=256, W=256, subdiv=3,
                                       device="cpu")
    return (np.clip(batch["src_img"][0], 0, 1) * 255).astype(np.uint8)


def segments(data: bytes) -> dict:
    """{marker: [payload, ...]} of a JPEG's header segments."""
    out, i = {}, 2
    while data[i + 1] != 0xDA:
        n, = struct.unpack(">H", data[i + 2:i + 4])
        out.setdefault(data[i + 1], []).append(data[i + 4:i + 2 + n])
        i += 2 + n
    return out


def test_jpeg_against_pil(source_image):
    from vanerf_tpu_torch.image_codecs import encode_jpeg
    data = encode_jpeg(source_image, 90)
    ref = pil_jpeg(source_image, 90)
    got, want = psnr(pil_decode(data), source_image), psnr(
        pil_decode(ref), source_image)
    print(f"PSNR: port {got:.2f} dB, PIL {want:.2f} dB")
    assert got >= 38.0 and abs(got - want) <= 0.5
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    mine, pils = segments(data), segments(ref)
    for marker in (0xDB, 0xC4, 0xC0):    # tables and frame header: PIL's
        assert b"".join(mine[marker]) == b"".join(pils[marker]), hex(marker)


@pytest.mark.parametrize("shape", [(32, 48), (17, 5), (1, 1), (40, 33)])
def test_jpeg_any_size_decodes(shape):
    """Sizes that are not whole 16x16 MCUs, and noise (long AC runs, the
    full coefficient range): PIL decodes each within 1 dB of its own JPEG
    of the same image."""
    from vanerf_tpu_torch.image_codecs import encode_jpeg
    rs = np.random.RandomState(shape[0])
    img = rs.randint(0, 256, shape + (3,), dtype=np.uint8)
    img[:shape[0] // 2] //= 8                  # a smooth half, a noisy half
    dec = pil_decode(encode_jpeg(img))
    assert dec.shape == img.shape
    if img.size > 3:
        assert psnr(dec, img) >= psnr(pil_decode(pil_jpeg(img)), img) - 1.0
    with pytest.raises(ValueError):
        encode_jpeg(img.astype(np.float32))


def gif_frames(data: bytes):
    from PIL import Image, ImageSequence
    im = Image.open(io.BytesIO(data))
    return im, [np.asarray(f.convert("RGB"))
                for f in ImageSequence.Iterator(im)]


def test_gif_against_pil(source_image):
    from vanerf_tpu_torch.image_codecs import encode_gif
    frames = [source_image, source_image[::-1].copy(),
              np.zeros_like(source_image)]
    im, dec = gif_frames(encode_gif(frames, delay_cs=10))
    assert len(dec) == 3
    assert im.info["duration"] == 100 and im.info["loop"] == 0
    maes = [np.abs(d.astype(int) - f).mean() for d, f in zip(dec, frames)]
    print(f"GIF mean absolute error by frame: {maes}")
    assert max(maes) <= 4.0


def test_gif_lzw_is_lossless():
    """Frames of at most 256 colours come back exactly: the LZW stream
    decodes to every index, through table resets (a 256^2 frame of random
    indices fills the 4,096-entry table many times) and every code
    width."""
    from vanerf_tpu_torch.image_codecs import encode_gif
    rs = np.random.RandomState(3)
    pal = rs.randint(0, 256, (256, 3), dtype=np.uint8)
    frames = [pal[rs.randint(0, 256, (256, 256))],
              pal[rs.randint(0, 3, (37, 29))],
              np.full((5, 7, 3), 200, np.uint8)]
    for f in frames:
        _, dec = gif_frames(encode_gif([f]))
        np.testing.assert_array_equal(dec[0], f)
    with pytest.raises(ValueError):
        encode_gif([])


def box_tree(data: bytes, parse_boxes, start: int = 0, end=None):
    containers = (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf")
    return [(t, box_tree(data, parse_boxes, s, e) if t in containers
             else None) for t, s, e in parse_boxes(data, start, end)]


def test_mp4_matches_jax_writer(tmp_path):
    from vanerf_tpu import video as vj
    from vanerf_tpu_torch import video as vt
    rs = np.random.RandomState(0)
    frames = [rs.randint(0, 255, (32, 48, 3), np.uint8) for _ in range(5)]
    got = open(vt.write_mjpeg_mp4(str(tmp_path / "p.mp4"), frames, fps=10),
               "rb").read()
    want = open(vj.write_mjpeg_mp4(str(tmp_path / "j.mp4"), frames, fps=10),
                "rb").read()
    assert box_tree(got, vj.parse_boxes) == box_tree(want, vj.parse_boxes)
    assert vt.parse_boxes(got) == vj.parse_boxes(got)
    # one JPEG sample a frame: stco offsets and stsz sizes tile mdat
    i = got.index(b"stsz")
    n, = struct.unpack(">I", got[i + 12:i + 16])
    sizes = struct.unpack(f">{n}I", got[i + 16:i + 16 + 4 * n])
    j = got.index(b"stco")
    offs = struct.unpack(f">{n}I", got[j + 12:j + 12 + 4 * n])
    assert n == 5 and got[j + 8:j + 12] == struct.pack(">I", 5)
    for f, o, s in zip(frames, offs, sizes):
        assert got[o:o + 2] == b"\xff\xd8" and got[o + s - 2:o + s] \
            == b"\xff\xd9"
        assert pil_decode(got[o:o + s]).shape == f.shape
    # everything but the samples and their sizes / offsets is JAX's
    moov = got[got.index(b"moov") - 4:]
    moov_j = want[want.index(b"moov") - 4:]
    strip = [b"stsz", b"stco"]
    for box in strip:
        for d in (moov, moov_j):
            k = d.index(box)
            size, = struct.unpack(">I", d[k - 4:k])
            d_new = d[:k + 4] + b"\x00" * (size - 8) + d[k - 4 + size:]
            if d is moov:
                moov = d_new
            else:
                moov_j = d_new
    assert moov == moov_j
    with pytest.raises(ValueError):
        vt.write_mjpeg_mp4(str(tmp_path / "e.mp4"), [])


def test_video_path_needs_no_imaging_library(tmp_path):
    """The encoders and the mp4 writer with PIL and imageio unimportable."""
    code = ("import sys; sys.modules['PIL'] = None; "
            "sys.modules['imageio'] = None; import numpy as np; "
            "from vanerf_tpu_torch import video, image_codecs; "
            "f = [np.zeros((16, 16, 3), np.uint8)] * 2; "
            f"video.write_mjpeg_mp4({str(tmp_path / 'v.mp4')!r}, f); "
            f"image_codecs.write_gif({str(tmp_path / 'v.gif')!r}, f)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=h.ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (tmp_path / "v.mp4").stat().st_size > 0
    assert (tmp_path / "v.gif").read_bytes()[:6] == b"GIF89a"
