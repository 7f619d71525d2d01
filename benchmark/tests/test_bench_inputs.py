"""The input generator: MANO-sized pairs, watertight and outward facing,
the same pool from the same seed, distinct requests, and the plain
rasterizer against a face-by-face sweep."""

import numpy as np
import pytest
import torch

from benchmark import inputs


def test_pair_has_manos_sizes():
    v, f, k, b = inputs.two_hands(np.random.default_rng(2 ** 40 + 3))
    assert v.shape == (1558, 3) and f.shape == (3108, 3) and k.shape == (42, 3)
    assert f.min() == 0 and f.max() == 1557
    assert (b[0] < v.min(0)).all() and (b[1] > v.max(0)).all()


@pytest.mark.parametrize("hand", [0, 1])
def test_each_sealed_hand_is_closed_and_outward(hand):
    v, f, _, _ = inputs.two_hands(np.random.default_rng(7))
    ff = f[hand * 1554:(hand + 1) * 1554]
    edges = {}
    for t in ff:
        for a, c in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            edges[(a, c)] = edges.get((a, c), 0) + 1
    assert max(edges.values()) == 1                     # oriented manifold
    assert all((c, a) in edges for a, c in edges)       # closed
    tri = v[ff].astype(np.float64)
    vol = np.einsum("ij,ij->i", tri[:, 0],
                    np.cross(tri[:, 1], tri[:, 2])).sum() / 6
    assert vol > 1e-5                                   # outward normals


def _small_pool(seed):
    return inputs.make_pool(seed, 3, 1, 24, 24, "cpu")


def test_same_seed_same_pool_other_seed_other_pool():
    a, b, c = _small_pool(2 ** 33 + 1), _small_pool(2 ** 33 + 1), \
        _small_pool(2 ** 33 + 2)
    for ra, rb in zip(a, b):
        for k in ra:
            np.testing.assert_array_equal(ra[k], rb[k])
    assert not np.array_equal(a[0]["verts"], c[0]["verts"])


def test_requests_in_a_pool_are_distinct():
    pool = inputs.make_pool(11, 6, 2, 16, 16, "cpu")
    keys = {(r["verts"].tobytes(), r["src_krt"].tobytes(),
             r["tar_rt"].tobytes()) for r in pool}
    assert len(keys) == len(pool)
    assert len({r["verts"].tobytes() for r in pool}) == len(pool)
    for r in pool:
        assert r["src_img"].shape == (2, 16, 16, 3)


def test_rasterizer_against_a_face_by_face_sweep():
    v, f, _, _ = inputs.two_hands(np.random.default_rng(3))
    K, Rt = inputs.ring_camera(5, 20, 20)
    vt, ft = torch.tensor(v), torch.tensor(f)
    face, bary = inputs.rasterize(vt, ft, torch.tensor(K), torch.tensor(Rt),
                                  20, 20, chunk=64)
    cam = v @ Rt[:3, :3].T + Rt[:3, 3]
    xy = np.stack([cam[:, 0] / cam[:, 2] * K[0, 0] + K[0, 2],
                   cam[:, 1] / cam[:, 2] * K[1, 1] + K[1, 2]], -1)
    for pix in range(0, 400, 7):
        px, py = pix % 20, pix // 20
        best, best_f = np.inf, -1
        for i, t in enumerate(f):
            (ax, ay), (bx, by), (cx, cy) = xy[t]
            area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
            if abs(area) <= 1e-9:
                continue
            l0 = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) / area
            l1 = ((ax - cx) * (py - cy) - (ay - cy) * (px - cx)) / area
            l2 = 1 - l0 - l1
            if min(l0, l1, l2) < -1e-6:
                continue
            z = l0 * cam[t[0], 2] + l1 * cam[t[1], 2] + l2 * cam[t[2], 2]
            if z < best - 1e-7:
                best, best_f = z, i
        if best_f >= 0:
            got = int(face[pix])
            assert got >= 0
            tri = cam[f[got]]
            b = bary[pix].numpy()
            assert abs(b @ tri[:, 2] - best) < 1e-5
        else:
            assert int(face[pix]) == -1
