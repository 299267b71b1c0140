"""Quaternion / homogeneous-matrix algebra (numpy, float64); a copy of
cotr_tpu/geometry/transforms.py:

    quaternion_from_matrix, quaternion_matrix, quaternion_inverse,
    translation_matrix, translation_from_matrix

Conventions: quaternions are (w, x, y, z), rotation matrices act on column
vectors, homogeneous matrices are 4x4.
"""

from __future__ import annotations

import numpy as np


def translation_matrix(direction: np.ndarray) -> np.ndarray:
    m = np.identity(4)
    m[:3, 3] = direction[:3]
    return m


def translation_from_matrix(matrix: np.ndarray) -> np.ndarray:
    return np.array(matrix, copy=True)[:3, 3]


def quaternion_matrix(quaternion: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> 4x4 homogeneous rotation matrix."""
    q = np.asarray(quaternion, dtype=np.float64)
    n = np.dot(q, q)
    if n < np.finfo(np.float64).eps * 4.0:
        return np.identity(4)
    q = q * np.sqrt(2.0 / n)
    q = np.outer(q, q)
    w, x, y, z = 0, 1, 2, 3
    return np.array([
        [1.0 - q[y, y] - q[z, z], q[x, y] - q[z, w], q[x, z] + q[y, w], 0.0],
        [q[x, y] + q[z, w], 1.0 - q[x, x] - q[z, z], q[y, z] - q[x, w], 0.0],
        [q[x, z] - q[y, w], q[y, z] + q[x, w], 1.0 - q[x, x] - q[y, y], 0.0],
        [0.0, 0.0, 0.0, 1.0]])


def quaternion_from_matrix(matrix: np.ndarray) -> np.ndarray:
    """Rotation part of a 4x4 (or 3x3) matrix -> unit quaternion (w,x,y,z).

    Shepperd's numerically stable branch selection (same algorithm family as
    the vendored library's default isprecise=False path: symmetric K-matrix
    eigenvector)."""
    m = np.asarray(matrix, dtype=np.float64)[:4, :4]
    if m.shape[0] == 3:
        m4 = np.identity(4)
        m4[:3, :3] = m
        m = m4
    # K matrix method (robust for slightly non-orthonormal inputs)
    k = np.array([
        [m[0, 0] - m[1, 1] - m[2, 2], 0.0, 0.0, 0.0],
        [m[0, 1] + m[1, 0], m[1, 1] - m[0, 0] - m[2, 2], 0.0, 0.0],
        [m[0, 2] + m[2, 0], m[1, 2] + m[2, 1],
         m[2, 2] - m[0, 0] - m[1, 1], 0.0],
        [m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1],
         m[0, 0] + m[1, 1] + m[2, 2]],
    ]) / 3.0
    w, v = np.linalg.eigh(k)
    q = v[[3, 0, 1, 2], np.argmax(w)]
    if q[0] < 0.0:
        np.negative(q, q)
    return q


def quaternion_inverse(quaternion: np.ndarray) -> np.ndarray:
    q = np.array(quaternion, dtype=np.float64, copy=True)
    np.negative(q[1:], q[1:])
    return q / np.dot(q, q)


def quaternion_multiply(q1: np.ndarray, q0: np.ndarray) -> np.ndarray:
    w0, x0, y0, z0 = q0
    w1, x1, y1, z1 = q1
    return np.array([
        -x1 * x0 - y1 * y0 - z1 * z0 + w1 * w0,
        x1 * w0 + y1 * z0 - z1 * y0 + w1 * x0,
        -x1 * z0 + y1 * w0 + z1 * x0 + w1 * y0,
        x1 * y0 - y1 * x0 + z1 * w0 + w1 * z0])
