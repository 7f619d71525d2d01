"""360-degree orbit camera path for free-viewpoint video, port of
``vanerf_tpu/camera_path.py``.

Parity target: ``get_360cameras`` (reference ``src/utils.py:63-134``) —
orbit around the subject's head pose with the same wobble schedule
(theta0/theta1 phase plan over the frame count), equal to the JAX
package's to the bit.  Pure numpy.
"""

from __future__ import annotations

import numpy as np


def _rodrigues_np(rvec: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]],
                 np.float32)
    return (np.eye(3) + np.sin(theta) * K
            + (1 - np.cos(theta)) * (K @ K)).astype(np.float32)


def get_360cameras(headpose: np.ndarray, focal: float, trans: float,
                   sc_factor: float, im_w: int, im_h: int, znear: float,
                   zfar: float, n_frames: int = 90):
    """Build the orbit camera list.

    Args:
      headpose: (4, 4) or (3, 4) subject pose (R | t).
    Returns:
      list of dicts with 'w2cs' (4,4), 'c2ws', 'intrinsics' (1,4,4),
      'im_w', 'im_h', 'znear', 'zfar'.
    """
    T_i = np.eye(4, dtype=np.float32)
    T_i[:3, :4] = np.asarray(headpose, np.float32)[:3, :4]
    T_i[:3, :3] = T_i[:3, :3].T
    T_i[:3, 3] = -T_i[:3, :3] @ T_i[:3, 3]

    cams = []
    theta0 = theta1 = 0.0
    for idx in range(n_frames):
        dR = _rodrigues_np(np.array([0.0, theta0, 0.0], np.float32))
        dt = np.array([0.0, 0.0, trans], np.float32)
        K = np.array([[focal, 0, im_w / 2], [0, focal, im_h / 2],
                      [0, 0, 1]], np.float32)

        extrin = np.eye(4, dtype=np.float32)
        extrin[:3, :3] = dR
        extrin[:3, 3] = dt
        extrinsic = (extrin @ T_i).copy()
        extrinsic[:3, 3] *= sc_factor

        intrin = np.eye(4, dtype=np.float32)
        intrin[:3, :3] = K

        # wobble phase schedule (utils.py:107-123)
        i = idx + 1e-4
        step = 5.0 * np.pi * 0.1 / n_frames
        if i <= n_frames / 10:
            theta0 += step
            theta1 += step
        elif i < n_frames * 3 / 10:
            theta0 -= step
        elif i < n_frames * 5 / 10:
            theta1 -= step
        elif i < n_frames * 7 / 10:
            theta0 += step
        elif i < n_frames * 9 / 10:
            theta1 += step
        else:
            theta0 -= step
            theta1 -= step
        theta0 += 2.0 * np.pi / n_frames

        cams.append({
            "w2cs": extrinsic,
            "c2ws": np.linalg.inv(extrinsic),
            "intrinsics": intrin[None],
            "im_w": im_w, "im_h": im_h,
            "znear": znear, "zfar": zfar,
        })
    return cams
