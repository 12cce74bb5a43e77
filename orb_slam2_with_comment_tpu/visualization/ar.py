"""Augmented-reality demo support (the reference's MonoAR / ViewerAR).

JAX rebuild of ``Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.cc``:

- :func:`fit_plane_ransac` — ``ViewerAR::DetectPlane`` (ViewerAR.cc:392-508)
  as a fully batched RANSAC: every 3-point hypothesis plane is fitted and
  scored in one vmapped pass (the reference loops 50 sequential
  iterations). Score = the ``max(0.2*N, 20)``-th smallest point-plane
  distance; inliers = distance < 1.4 * best score.
- :func:`plane_pose` — ``Plane::Recompute`` (ViewerAR.cc:516-585):
  all-inlier homogeneous least-squares refit (smallest eigenvector of the
  centered scatter matrix), normal sign fixed against the camera ray
  (XC·n <= 0), and the plane frame built by rotating +Y onto the normal
  (``ExpSO3(v*ang/sa) * ExpSO3(up*rang)``) with a random in-plane spin.
- :func:`cube_edges` / :func:`draw_ar` — ``DrawCube``/``DrawPlane``
  (ViewerAR.cc:336-376) replaced by projecting the cube wireframe and
  plane grid through the pinhole model and rasterizing lines on the frame
  overlay — headless, no Pangolin/OpenGL.

Everything device-side is shape-stable (fixed point capacity + validity
masks) so the whole detection runs as one jitted program.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.se3 import exp_so3

CUBE_EDGE_COLOR = (235, 60, 200)
GRID_COLOR = (120, 120, 120)


@partial(jax.jit, static_argnames=("iterations",))
def fit_plane_ransac(points: jax.Array, valid: jax.Array, key: jax.Array,
                     iterations: int = 50):
    """Batched 3-point RANSAC plane fit.

    points: [N, 3] float world points; valid: [N] bool. Returns
    ``(normal [3], d, inlier_mask [N], ok)`` for the plane n.x + d = 0.
    ``ok`` is False when fewer than 50 valid points exist
    (ViewerAR.cc:414-415).
    """
    N = points.shape[0]
    n_valid = jnp.sum(valid.astype(jnp.int32))
    # Sample 3 distinct valid indices per hypothesis: weight valid points
    # uniformly via Gumbel top-k over masked noise.
    g = jax.random.gumbel(key, (iterations, N))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(g, 3)                       # [I, 3]
    p = points[idx]                                    # [I, 3, 3]
    # Exact plane through 3 points: n = (p1-p0) x (p2-p0).
    nvec = jnp.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])   # [I, 3]
    nn = jnp.linalg.norm(nvec, axis=1, keepdims=True)
    nvec = nvec / jnp.maximum(nn, 1e-12)
    d = -jnp.sum(nvec * p[:, 0], axis=1)               # [I]
    dist = jnp.abs(points @ nvec.T + d[None, :]).T     # [I, N]
    dist = jnp.where(valid[None, :], dist, jnp.inf)
    # Score: the max(0.2*N, 20)-th smallest distance (ViewerAR.cc:473-474).
    nth = jnp.maximum((0.2 * n_valid).astype(jnp.int32), 20)
    nth = jnp.minimum(nth, jnp.maximum(n_valid - 1, 0))
    sorted_d = jnp.sort(dist, axis=1)                  # [I, N]
    score = jnp.take_along_axis(sorted_d, jnp.full((iterations, 1), nth),
                                axis=1)[:, 0]          # [I]
    degenerate = nn[:, 0] < 1e-9
    score = jnp.where(degenerate, jnp.inf, score)
    best = jnp.argmin(score)
    best_dist = score[best]
    th = 1.4 * best_dist                                # ViewerAR.cc:484
    inliers = (dist[best] < th) & valid
    ok = n_valid >= 50
    return nvec[best], d[best], inliers, ok


@jax.jit
def refit_plane(points: jax.Array, inliers: jax.Array):
    """All-inlier homogeneous LSQ refit (Plane::Recompute, ViewerAR.cc:520-547).

    Returns ``(normal [3] unit, origin [3])`` where origin is the inlier
    centroid. Equivalent to the reference's SVD of [X|1]: the plane normal
    is the smallest-eigenvalue eigenvector of the centered scatter matrix.
    """
    w = inliers.astype(points.dtype)
    n_in = jnp.maximum(jnp.sum(w), 1.0)
    o = jnp.sum(points * w[:, None], axis=0) / n_in
    centered = (points - o) * w[:, None]
    C = centered.T @ centered
    _, vecs = jnp.linalg.eigh(C)
    normal = vecs[:, 0]
    return normal / jnp.maximum(jnp.linalg.norm(normal), 1e-12), o


@jax.jit
def plane_pose(normal: jax.Array, origin: jax.Array, cam_center: jax.Array,
               rang: jax.Array):
    """Build the plane-to-world transform Tpw (ViewerAR.cc:551-579).

    Normal is flipped so that (cam_center - origin) . n <= 0, matching the
    reference's sign convention; the rotation maps the +Y axis onto the
    normal with an extra random in-plane rotation ``rang``.
    Returns ``(Rpw [3,3], origin [3])``.
    """
    xc = cam_center - origin
    flip = jnp.sum(xc * normal) > 0
    n = jnp.where(flip, -normal, normal)
    up = jnp.array([0.0, 1.0, 0.0], normal.dtype)
    v = jnp.cross(up, n)
    sa = jnp.linalg.norm(v)
    ca = jnp.dot(up, n)
    ang = jnp.arctan2(sa, ca)
    axis = jnp.where(sa > 1e-8, v * ang / jnp.maximum(sa, 1e-12),
                     jnp.zeros(3, normal.dtype))
    Rpw = exp_so3(axis) @ exp_so3(up * rang)
    return Rpw, origin


def detect_plane(points, valid, Rcw, tcw, key, iterations: int = 50):
    """Full DetectPlane pipeline: RANSAC -> inlier refit -> plane pose.

    Returns ``(Rpw, opw, inliers)`` or ``None`` when not enough points or
    RANSAC found nothing usable (ViewerAR.cc:414, 172-180).
    """
    points = jnp.asarray(points, jnp.float32)
    valid = jnp.asarray(valid, bool)
    k1, k2 = jax.random.split(jnp.asarray(key))
    nvec, d, inliers, ok = fit_plane_ransac(points, valid, k1, iterations)
    if not bool(ok):
        return None
    normal, origin = refit_plane(points, inliers)
    cam_center = -jnp.asarray(Rcw).T @ jnp.asarray(tcw)
    # Random in-plane spin in [-pi/2, pi/2) (ViewerAR.cc:512).
    rang = jax.random.uniform(k2, (), jnp.float32, -jnp.pi / 2, jnp.pi / 2)
    Rpw, opw = plane_pose(normal, origin, cam_center, rang)
    return np.asarray(Rpw), np.asarray(opw), np.asarray(inliers)


def cube_edges(size: float):
    """Wireframe of a cube of side ``size`` sitting on the plane (y in
    [-size, 0] in plane coords — the reference translates by -size/2 along
    the plane normal before glutWireCube, ViewerAR.cc:336-344)."""
    s = size / 2.0
    v = np.array([[x, y, z] for x in (-s, s) for y in (-size, 0.0)
                  for z in (-s, s)], np.float32)
    e = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
         (0, 4), (1, 5), (2, 6), (3, 7)]
    return v, e


def plane_grid(size: float, ndivs: int = 7):
    """Grid-line segment endpoints in plane coords (DrawPlane,
    ViewerAR.cc:352-376)."""
    half = ndivs * size / 2.0
    segs = []
    for i in range(ndivs + 1):
        c = -half + i * size
        segs.append(((-half, 0.0, c), (half, 0.0, c)))
        segs.append(((c, 0.0, -half), (c, 0.0, half)))
    return np.asarray(segs, np.float32)


def _draw_line(img: np.ndarray, x0, y0, x1, y1, color):
    h, w = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _project(cam, Rcw, tcw, Xw):
    Xc = Xw @ np.asarray(Rcw).T + np.asarray(tcw)[None, :]
    z = np.maximum(Xc[:, 2], 1e-6)
    u = float(cam.fx) * Xc[:, 0] / z + float(cam.cx)
    v = float(cam.fy) * Xc[:, 1] / z + float(cam.cy)
    return np.stack([u, v], axis=1), Xc[:, 2] > 1e-4


def draw_ar(img: np.ndarray, cam, Rcw, tcw, Rpw, opw,
            cube_size: float = 0.05, draw_grid: bool = True) -> np.ndarray:
    """Render the AR overlay: plane grid + virtual cube wireframe.

    img: grayscale [H, W] or RGB [H, W, 3] uint8. Returns RGB uint8.
    """
    g = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    out = np.repeat(g[:, :, None], 3, axis=2) if g.ndim == 2 else g.copy()
    Rpw = np.asarray(Rpw)
    opw = np.asarray(opw)

    def to_world(P):
        return P @ Rpw.T + opw[None, :]

    if draw_grid:
        segs = plane_grid(cube_size)
        pts = to_world(segs.reshape(-1, 3))
        uv, front = _project(cam, Rcw, tcw, pts)
        for i in range(0, len(uv), 2):
            if front[i] and front[i + 1]:
                _draw_line(out, uv[i, 0], uv[i, 1], uv[i + 1, 0],
                           uv[i + 1, 1], GRID_COLOR)
    v, e = cube_edges(cube_size)
    uv, front = _project(cam, Rcw, tcw, to_world(v))
    for a, b in e:
        if front[a] and front[b]:
            _draw_line(out, uv[a, 0], uv[a, 1], uv[b, 0], uv[b, 1],
                       CUBE_EDGE_COLOR)
    return out
