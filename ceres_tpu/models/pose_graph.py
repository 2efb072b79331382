"""2-D and 3-D pose-graph SLAM.

JAX analog of ``examples/slam/pose_graph_2d/*`` and
``examples/slam/pose_graph_3d/*``: g2o-format parsing, the relative-pose
error terms (pose_graph_2d_error_term.h:52-105,
pose_graph_3d_error_term.h:40-130), angle-manifold / Eigen-quaternion
manifolds, and the first-pose gauge fix. All constraints of a graph form
one batched residual family.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

import ceres_tpu as ct

PI = np.pi


def normalize_angle(a):
    """Wrap to [-pi, pi) (slam/common/normalize_angle.h)."""
    return a - 2.0 * PI * jnp.floor((a + PI) / (2.0 * PI))


# ---------------------------------------------------------------------------
# 2-D
# ---------------------------------------------------------------------------


class AngleManifold(ct.manifold.Manifold):
    """SO(2) as a wrapped angle (pose_graph_2d/angle_manifold.h)."""

    @property
    def ambient_size(self) -> int:
        return 1

    @property
    def tangent_size(self) -> int:
        return 1

    def plus(self, x, delta):
        return normalize_angle(x + delta)

    def minus(self, y, x):
        return normalize_angle(y - x)


def pose_graph_2d_residual(pose_a, pose_b, data):
    """residual = sqrt_info @ [R(yaw_a)^T (p_b - p_a) - p_ab;
    normalize(yaw_b - yaw_a - yaw_ab)] (pose_graph_2d_error_term.h:73-93).

    pose = [x, y, yaw]; data = (p_ab (2,), yaw_ab (), sqrt_info (3,3)).
    """
    p_ab, yaw_ab, sqrt_info = data
    yaw_a = pose_a[2]
    c, s = jnp.cos(yaw_a), jnp.sin(yaw_a)
    RT = jnp.array([[c, s], [-s, c]])
    dp = RT @ (pose_b[:2] - pose_a[:2]) - p_ab
    dyaw = normalize_angle(pose_b[2] - pose_a[2] - yaw_ab)
    return sqrt_info @ jnp.concatenate([dp, dyaw[None]])


@dataclasses.dataclass
class Constraint2d:
    id_begin: int
    id_end: int
    x: float
    y: float
    yaw: float
    information: np.ndarray  # (3,3)


def read_g2o_2d(path) -> Tuple[Dict[int, np.ndarray], List[Constraint2d]]:
    """Parse 2-D g2o files (slam/pose_graph_2d/read_g2o wiring):
    VERTEX_SE2 / EDGE_SE2 lines."""
    poses: Dict[int, np.ndarray] = {}
    constraints: List[Constraint2d] = []
    for line in Path(path).read_text().splitlines():
        toks = line.split()
        if not toks:
            continue
        if toks[0] == "VERTEX_SE2":
            pid = int(toks[1])
            poses[pid] = np.asarray([float(t) for t in toks[2:5]])
        elif toks[0] == "EDGE_SE2":
            a, b = int(toks[1]), int(toks[2])
            x, y, yaw = (float(t) for t in toks[3:6])
            u = [float(t) for t in toks[6:12]]
            info = np.array(
                [
                    [u[0], u[1], u[2]],
                    [u[1], u[3], u[4]],
                    [u[2], u[4], u[5]],
                ]
            )
            constraints.append(Constraint2d(a, b, x, y, yaw, info))
    return poses, constraints


def build_problem_2d(
    poses: Dict[int, np.ndarray], constraints: List[Constraint2d]
) -> Tuple[ct.Problem, Dict[int, int]]:
    """pose_graph_2d.cc BuildOptimizationProblem: one batched family +
    first pose held constant (gauge freedom)."""
    p = ct.Problem()
    # Full pose [x, y, yaw] as one block with a product manifold
    # (Euclidean(2) x Angle) — the reference splits x/y/yaw into three
    # blocks; one block per pose batches better.
    man = ct.ProductManifold(
        ct.EuclideanManifold(2), AngleManifold()
    )
    pid_of = {}
    for vid in sorted(poses):
        pid_of[vid] = p.add_parameter_block(poses[vid], manifold=man)
    a_ids = np.asarray([pid_of[c.id_begin] for c in constraints])
    b_ids = np.asarray([pid_of[c.id_end] for c in constraints])
    p_ab = np.stack([[c.x, c.y] for c in constraints])
    yaw_ab = np.asarray([c.yaw for c in constraints])
    sqrt_info = np.stack(
        [np.linalg.cholesky(c.information).T for c in constraints]
    )
    p.add_residual_blocks(
        pose_graph_2d_residual,
        None,
        [a_ids, b_ids],
        data=(
            jnp.asarray(p_ab),
            jnp.asarray(yaw_ab),
            jnp.asarray(sqrt_info),
        ),
    )
    first = pid_of[min(poses)]
    p.set_parameter_block_constant(first)
    return p, pid_of


# ---------------------------------------------------------------------------
# 3-D
# ---------------------------------------------------------------------------


def _quat_conj(q):
    # Eigen storage order [x, y, z, w]
    return jnp.array([-q[0], -q[1], -q[2], q[3]])


def _quat_mul(a, b):
    """Hamilton product, Eigen [x,y,z,w] storage."""
    ax, ay, az, aw = a[0], a[1], a[2], a[3]
    bx, by, bz, bw = b[0], b[1], b[2], b[3]
    return jnp.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )


def _quat_rotate(q, v):
    """R(q) v for unit q, [x,y,z,w] storage."""
    u = q[:3]
    w = q[3]
    return v + 2.0 * jnp.cross(u, jnp.cross(u, v) + w * v)


def pose_graph_3d_residual(p_a, q_a, p_b, q_b, data):
    """pose_graph_3d_error_term.h:85-120: position + 2*Vec(dq) error,
    scaled by sqrt information. Quaternions in Eigen [x,y,z,w] order,
    matching EigenQuaternionManifold."""
    p_ab_meas, q_ab_meas, sqrt_info = data
    q_a_inv = _quat_conj(q_a)
    q_ab_est = _quat_mul(q_a_inv, q_b)
    p_ab_est = _quat_rotate(q_a_inv, p_b - p_a)
    delta_q = _quat_mul(q_ab_meas, _quat_conj(q_ab_est))
    err = jnp.concatenate([p_ab_est - p_ab_meas, 2.0 * delta_q[:3]])
    return sqrt_info @ err


@dataclasses.dataclass
class Constraint3d:
    id_begin: int
    id_end: int
    p: np.ndarray  # (3,)
    q: np.ndarray  # (4,) [x,y,z,w]
    information: np.ndarray  # (6,6)


def read_g2o_3d(path):
    """VERTEX_SE3:QUAT / EDGE_SE3:QUAT parsing
    (slam/pose_graph_3d/read_g2o.h + types.h)."""
    positions: Dict[int, np.ndarray] = {}
    quats: Dict[int, np.ndarray] = {}
    constraints: List[Constraint3d] = []
    for line in Path(path).read_text().splitlines():
        toks = line.split()
        if not toks:
            continue
        if toks[0] == "VERTEX_SE3:QUAT":
            vid = int(toks[1])
            vals = [float(t) for t in toks[2:9]]
            positions[vid] = np.asarray(vals[:3])
            q = np.asarray(vals[3:7])  # x y z w
            quats[vid] = q / np.linalg.norm(q)
        elif toks[0] == "EDGE_SE3:QUAT":
            a, b = int(toks[1]), int(toks[2])
            vals = [float(t) for t in toks[3:10]]
            upper = [float(t) for t in toks[10:31]]
            info = np.zeros((6, 6))
            idx = 0
            for i in range(6):
                for j in range(i, 6):
                    info[i, j] = info[j, i] = upper[idx]
                    idx += 1
            q = np.asarray(vals[3:7])
            constraints.append(
                Constraint3d(
                    a, b, np.asarray(vals[:3]), q / np.linalg.norm(q), info
                )
            )
    return positions, quats, constraints


def build_problem_3d(positions, quats, constraints):
    """pose_graph_3d.cc BuildOptimizationProblem: position blocks (3) +
    Eigen-quaternion blocks (4, quaternion manifold), batched family,
    first pose constant."""
    p = ct.Problem()
    qman = ct.EigenQuaternionManifold()
    pos_id, quat_id = {}, {}
    for vid in sorted(positions):
        pos_id[vid] = p.add_parameter_block(positions[vid])
        quat_id[vid] = p.add_parameter_block(quats[vid], manifold=qman)
    pa = np.asarray([pos_id[c.id_begin] for c in constraints])
    qa = np.asarray([quat_id[c.id_begin] for c in constraints])
    pb = np.asarray([pos_id[c.id_end] for c in constraints])
    qb = np.asarray([quat_id[c.id_end] for c in constraints])
    p_meas = np.stack([c.p for c in constraints])
    q_meas = np.stack([c.q for c in constraints])
    sqrt_info = np.stack(
        [np.linalg.cholesky(c.information).T for c in constraints]
    )
    p.add_residual_blocks(
        pose_graph_3d_residual,
        None,
        [pa, qa, pb, qb],
        data=(
            jnp.asarray(p_meas),
            jnp.asarray(q_meas),
            jnp.asarray(sqrt_info),
        ),
    )
    first = min(positions)
    p.set_parameter_block_constant(pos_id[first])
    p.set_parameter_block_constant(quat_id[first])
    return p, pos_id, quat_id


def synthesize_sphere(num_poses: int = 200, seed: int = 0):
    """Generate a noisy 3-D 'sphere'-style odometry+loop-closure graph
    (the shape of the canonical sphere.g2o benchmark)."""
    rng = np.random.default_rng(seed)
    # ground truth: spiral on a sphere
    t = np.linspace(0, 6 * np.pi, num_poses)
    z = np.linspace(-1, 1, num_poses)
    r = np.sqrt(1 - z * z)
    gt_p = np.stack([5 * r * np.cos(t), 5 * r * np.sin(t), 5 * z], axis=1)

    def yaw_quat(theta):
        return np.array([0.0, 0.0, np.sin(theta / 2), np.cos(theta / 2)])

    gt_q = np.stack([yaw_quat(th) for th in t])

    def q_conj(q):
        return np.array([-q[0], -q[1], -q[2], q[3]])

    def q_mul(a, b):
        x = np.empty(4)
        x[0] = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1]
        x[1] = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0]
        x[2] = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3]
        x[3] = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2]
        return x

    def q_rot(q, v):
        u, w = q[:3], q[3]
        return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)

    constraints = []
    info = np.eye(6)

    def rel(a, b, noise):
        qi = q_conj(gt_q[a])
        dp = q_rot(qi, gt_p[b] - gt_p[a]) + noise * rng.standard_normal(3)
        dq = q_mul(qi, gt_q[b])
        dq = dq / np.linalg.norm(dq)
        return dp, dq

    for i in range(num_poses - 1):
        dp, dq = rel(i, i + 1, 0.05)
        constraints.append(Constraint3d(i, i + 1, dp, dq, info))
    # loop closures every 25 poses
    for i in range(0, num_poses - 25, 25):
        dp, dq = rel(i, i + 25, 0.05)
        constraints.append(Constraint3d(i, i + 25, dp, dq, info))

    # noisy initial guess by integrating the odometry
    positions = {0: gt_p[0].copy()}
    quats = {0: gt_q[0].copy()}
    for i in range(num_poses - 1):
        c = constraints[i]
        positions[i + 1] = positions[i] + q_rot(quats[i], c.p)
        q = q_mul(quats[i], c.q)
        quats[i + 1] = q / np.linalg.norm(q)
    return positions, quats, constraints, (gt_p, gt_q)


def default_options() -> ct.SolverOptions:
    """pose_graph_3d.cc uses LM + SPARSE_NORMAL_CHOLESKY, which here is a
    host factorization per step; the default here is truncated CGNR with
    block-Jacobi on the device — same minima. Pass SPARSE_NORMAL_CHOLESKY
    explicitly for the direct solves.
    """
    return ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.CGNR,
        preconditioner_type=ct.PreconditionerType.JACOBI,
        max_num_iterations=200,
    )
