"""BAL (Bundle Adjustment in the Large) problems.

JAX analog of ``examples/bundle_adjuster.cc`` +
``examples/bal_problem.cc`` + ``examples/snavely_reprojection_error.h``:
loads BAL text files (or generates synthetic instances with the same
structure), builds one batched residual family — cameras (9), points (3),
one 2-D reprojection residual per observation — and solves it with the
Schur solvers.

The Snavely camera model matches snavely_reprojection_error.h:31-110:
9 parameters = angle-axis rotation (3), translation (3), focal length,
k1, k2 radial distortion; the camera looks down -z.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

import ceres_tpu as ct
from ceres_tpu.rotation import angle_axis_rotate_point


def snavely_reprojection_residual(camera, point, observed):
    """2-D reprojection error (snavely_reprojection_error.h:31-85)."""
    p = angle_axis_rotate_point(camera[:3], point) + camera[3:6]
    # BAL convention: camera looks down -z (bal_problem docs).
    xp = -p[0] / p[2]
    yp = -p[1] / p[2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (camera[7] + camera[8] * r2)
    focal = camera[6]
    predicted_x = focal * distortion * xp
    predicted_y = focal * distortion * yp
    return jnp.stack([predicted_x - observed[0], predicted_y - observed[1]])


@dataclasses.dataclass
class BALProblem:
    """In-memory BAL instance (examples/bal_problem.h)."""

    cameras: np.ndarray  # (C, 9)
    points: np.ndarray  # (P, 3)
    camera_index: np.ndarray  # (O,)
    point_index: np.ndarray  # (O,)
    observations: np.ndarray  # (O, 2)

    @property
    def num_cameras(self) -> int:
        return self.cameras.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_observations(self) -> int:
        return self.observations.shape[0]


def load_bal_file(path) -> BALProblem:
    """Parse the BAL text format (examples/bal_problem.cc ReadFile).

    Uses the native C++ reader (native/ceres_tpu_core.cpp) when built,
    with a pure-Python fallback."""
    from ceres_tpu.utils import native

    try:
        out = native.bal_load(path)
    except ValueError:
        raise
    if out is not None:
        cameras, points, cam_idx, pt_idx, obs = out
        return BALProblem(cameras, points, cam_idx, pt_idx, obs)
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    try:
        C, P, O = int(next(it)), int(next(it)), int(next(it))
    except StopIteration:
        raise ValueError(f"{path}: not a BAL file (missing header)")
    if len(tokens) != 3 + 4 * O + 9 * C + 3 * P:
        raise ValueError(
            f"{path}: truncated BAL file: expected "
            f"{3 + 4 * O + 9 * C + 3 * P} tokens, got {len(tokens)}"
        )
    cam_idx = np.empty(O, dtype=np.int64)
    pt_idx = np.empty(O, dtype=np.int64)
    obs = np.empty((O, 2))
    for o in range(O):
        cam_idx[o] = int(next(it))
        pt_idx[o] = int(next(it))
        obs[o, 0] = float(next(it))
        obs[o, 1] = float(next(it))
    rest = np.asarray([float(t) for t in it])
    cameras = rest[: 9 * C].reshape(C, 9)
    points = rest[9 * C : 9 * C + 3 * P].reshape(P, 3)
    return BALProblem(cameras, points, cam_idx, pt_idx, obs)


def synthesize_bal(
    num_cameras: int = 16,
    num_points: int = 22106,
    num_observations: int = 83718,
    noise: float = 1.0,
    perturb: float = 0.2,
    seed: int = 0,
) -> BALProblem:
    """Generate a synthetic BAL instance with problem-16-22106's shape.

    Cameras on a ring looking at a point cloud; observations are true
    projections plus pixel noise; the returned initial state is the
    ground truth perturbed (so the solver has real work to do) — the same
    role as bal_problem.cc Perturb().
    """
    rng = np.random.default_rng(seed)
    points = rng.standard_normal((num_points, 3)) * np.array([4.0, 4.0, 1.0])
    # Keep the cloud inside a ball of radius 6: cameras sit at |pos|~13.4,
    # so every point stays well in front of every camera (depth >= ~7).
    # Gaussian tails otherwise put a handful of the 22k points at depth
    # ~0, exploding the initial cost to 1e17 (real BAL data has no such
    # degenerate points).
    norms = np.linalg.norm(points, axis=1, keepdims=True)
    points *= np.minimum(1.0, 6.0 / np.maximum(norms, 1e-9))

    cameras = np.zeros((num_cameras, 9))
    for c in range(num_cameras):
        angle = 2 * np.pi * c / num_cameras
        # Camera at radius 12, looking roughly at the origin: BAL cameras
        # look down -z in camera frame, so build R mapping world->camera.
        pos = np.array([12.0 * np.cos(angle), 12.0 * np.sin(angle), 6.0])
        z_axis = pos / np.linalg.norm(pos)  # camera -z points to origin
        x_axis = np.cross([0.0, 0.0, 1.0], z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        R = np.stack([x_axis, y_axis, z_axis])  # world -> camera
        # angle-axis of R
        q = _rotation_matrix_to_angle_axis_np(R)
        cameras[c, :3] = q
        cameras[c, 3:6] = -R @ pos
        cameras[c, 6] = 500.0 + 10.0 * rng.standard_normal()
        cameras[c, 7] = 1e-7 * rng.standard_normal()
        cameras[c, 8] = 1e-13 * rng.standard_normal()

    # Per-point camera counts: base m everywhere, +1 for the first `extra`
    # points so the total matches num_observations exactly (the reference
    # instance has 83718 obs for 22106 points: mixed 3s and 4s).
    m = min(max(2, num_observations // num_points), num_cameras)
    extra = min(
        max(0, num_observations - m * num_points), num_points
    ) if m < num_cameras else 0
    # distinct random cameras per point, vectorized: top-k of a random
    # key matrix per row.
    keys = rng.random((num_points, num_cameras))
    seen = np.argsort(keys, axis=1)  # (P, C) random permutations
    counts = np.full(num_points, m, dtype=np.int64)
    counts[:extra] += 1
    pt_idx = np.repeat(np.arange(num_points, dtype=np.int64), counts)
    # Within-point column index 0..count-1, vectorized.
    ends = np.cumsum(counts)
    col = np.arange(ends[-1], dtype=np.int64) - np.repeat(
        ends - counts, counts
    )
    cam_idx = seen[pt_idx, col][:num_observations].astype(np.int64)
    pt_idx = pt_idx[:num_observations]

    # True projections + noise — pure numpy (data synthesis compiles no
    # device kernels).
    obs = _project_np(cameras[cam_idx], points[pt_idx])
    obs += noise * rng.standard_normal(obs.shape)

    # Perturb the initial state.
    cameras_init = cameras.copy()
    points_init = points + perturb * rng.standard_normal(points.shape)
    cameras_init[:, 3:6] += perturb * 0.1 * rng.standard_normal((num_cameras, 3))

    return BALProblem(cameras_init, points_init, cam_idx, pt_idx, obs)


def residuals_np(
    bal: BALProblem,
    cameras: Optional[np.ndarray] = None,
    points: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(O, 2) reprojection residuals in float64 numpy at ``cameras`` /
    ``points`` (default: the instance's own) — a reference independent of
    the JAX residual, for checking a solver's reported cost."""
    cameras = bal.cameras if cameras is None else np.asarray(cameras)
    points = bal.points if points is None else np.asarray(points)
    cams = cameras.astype(np.float64)[bal.camera_index]
    pts = points.astype(np.float64)[bal.point_index]
    return _project_np(cams, pts) - bal.observations


def cost_np(bal: BALProblem, cameras=None, points=None) -> float:
    """0.5 * ||residuals||^2 in float64 numpy (see :func:`residuals_np`)."""
    r = residuals_np(bal, cameras, points)
    return 0.5 * float(np.sum(r * r))


def solution(problem: ct.Problem, cam_ids, pt_ids):
    """(cameras, points) arrays read back from a solved problem."""
    cameras = np.stack([problem.parameter_block_value(i) for i in cam_ids])
    points = np.stack([problem.parameter_block_value(i) for i in pt_ids])
    return cameras, points


def _project_np(cams: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Vectorized numpy Snavely projection (matches
    snavely_reprojection_residual with observed = 0)."""
    aa = cams[:, :3]
    theta = np.linalg.norm(aa, axis=1, keepdims=True)
    small = theta[:, 0] < 1e-12
    k = np.where(theta > 1e-12, aa / np.maximum(theta, 1e-300), 0.0)
    ct_, st = np.cos(theta), np.sin(theta)
    kxp = np.cross(k, pts)
    kdp = np.sum(k * pts, axis=1, keepdims=True)
    pr = pts * ct_ + kxp * st + k * kdp * (1.0 - ct_)
    pr[small] = pts[small]
    pc = pr + cams[:, 3:6]
    xp = -pc[:, 0] / pc[:, 2]
    yp = -pc[:, 1] / pc[:, 2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (cams[:, 7] + cams[:, 8] * r2)
    f = cams[:, 6]
    return np.stack([f * distortion * xp, f * distortion * yp], axis=1)


def _rotation_matrix_to_angle_axis_np(R: np.ndarray) -> np.ndarray:
    """Pure-numpy conversion: data synthesis triggers no per-camera jit
    compiles."""
    # Rodrigues: theta from trace, axis from the skew part.
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-12:
        return np.zeros(3)
    axis = np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )
    n = np.linalg.norm(axis)
    if n < 1e-12:
        # theta ~ pi: axis from diagonal
        d = np.sqrt(np.clip((np.diag(R) + 1.0) / 2.0, 0.0, None))
        axis = d * np.sign(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
        )
        n = np.linalg.norm(axis)
        if n < 1e-12:
            axis = d
            n = np.linalg.norm(axis)
    return theta * axis / n


def build_problem(
    bal: BALProblem, loss: Optional[ct.loss.LossFunction] = None
) -> Tuple[ct.Problem, np.ndarray, np.ndarray]:
    """Build a ceres_tpu Problem; returns (problem, camera_ids, point_ids)."""
    p = ct.Problem()
    cam_ids = p.add_parameter_blocks(bal.cameras)
    pt_ids = p.add_parameter_blocks(bal.points)
    # Order observations lexicographically by point id (the reference's
    # reorder_program.cc LexicographicallyOrderResidualBlocks does the
    # same for Schur solvers): the point-side segment reductions then
    # read near-sequential rows instead of random-gathering.
    order = np.argsort(bal.point_index, kind="stable")
    p.add_residual_blocks(
        snavely_reprojection_residual,
        loss,
        [
            cam_ids[bal.camera_index[order]],
            pt_ids[bal.point_index[order]],
        ],
        data=bal.observations[order],
    )
    return p, cam_ids, pt_ids


def default_options(iterative: bool = True) -> ct.SolverOptions:
    """bundle_adjuster.cc defaults: ITERATIVE_SCHUR + SCHUR_JACOBI."""
    return ct.SolverOptions(
        linear_solver_type=(
            ct.LinearSolverType.ITERATIVE_SCHUR
            if iterative
            else ct.LinearSolverType.DENSE_SCHUR
        ),
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=50,
        eta=0.1,
    )
