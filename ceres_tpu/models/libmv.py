"""libmv bundle adjustment problems (Blender motion tracking).

JAX analog of ``examples/libmv_bundle_adjuster.cc``: loads the
binary libmv problem format (in-tree instances
``data/libmv-ba-problems/problem_0{1,2,3}.bin``), builds the
OpenCV-intrinsics reprojection problem (shared 8-parameter intrinsics
block + per-camera angle-axis/translation + 3-D points) and solves it.

File format (libmv_bundle_adjuster.cc:260-460):
  1 byte endianness ('V' big / 'v' little), 1 byte space ('P' image /
  'N' normalized), 8 f32 intrinsics, [int n; (int image, 9 f32 R
  column-major, 3 f32 t)]*, [int n; (int track, 3 f32 X)]*,
  [int n; (int image, int track, f32 x, f32 y)]*.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

import ceres_tpu as ct
from ceres_tpu.rotation import angle_axis_rotate_point

# intrinsics offsets (libmv_bundle_adjuster.cc:130-140)
OFFSET_FOCAL_LENGTH = 0
OFFSET_PRINCIPAL_POINT_X = 1
OFFSET_PRINCIPAL_POINT_Y = 2
OFFSET_K1 = 3
OFFSET_K2 = 4
OFFSET_K3 = 5
OFFSET_P1 = 6
OFFSET_P2 = 7


@dataclasses.dataclass
class LibmvProblem:
    intrinsics: np.ndarray  # (8,)
    cameras_Rt: np.ndarray  # (C, 6) angle-axis + translation
    camera_image: np.ndarray  # (C,) original image numbers
    points: np.ndarray  # (P, 3)
    point_track: np.ndarray  # (P,)
    marker_cam: np.ndarray  # (M,) index into cameras_Rt
    marker_pt: np.ndarray  # (M,) index into points
    markers: np.ndarray  # (M, 2)
    is_image_space: bool


def load_libmv_file(path) -> LibmvProblem:
    data = Path(path).read_bytes()
    pos = 0
    endian_flag = data[0:1]
    if endian_flag == b"V":
        e = ">"
    elif endian_flag == b"v":
        e = "<"
    else:
        raise ValueError(f"{path}: unknown endian flag {endian_flag!r}")
    space_flag = data[1:2]
    if space_flag not in (b"P", b"N"):
        raise ValueError(f"{path}: unknown marker space {space_flag!r}")
    pos = 2

    def rd(fmt, count):
        nonlocal pos
        size = struct.calcsize(e + fmt * count)
        vals = struct.unpack_from(e + fmt * count, data, pos)
        pos += size
        return vals

    intrinsics = np.asarray(rd("f", 8))

    (ncam,) = rd("i", 1)
    cam_image, cams = [], {}
    for _ in range(ncam):
        (img,) = rd("i", 1)
        Rcol = np.asarray(rd("f", 9)).reshape(3, 3).T  # column-major
        t = np.asarray(rd("f", 3))
        cams[img] = (Rcol, t)
    from ceres_tpu.models.bal import _rotation_matrix_to_angle_axis_np

    images = sorted(cams)
    cam_idx_of_image = {img: i for i, img in enumerate(images)}
    Rt = np.zeros((len(images), 6))
    for i, img in enumerate(images):
        R, t = cams[img]
        Rt[i, :3] = _rotation_matrix_to_angle_axis_np(R)
        Rt[i, 3:] = t

    (npts,) = rd("i", 1)
    tracks, pts = [], {}
    for _ in range(npts):
        (track,) = rd("i", 1)
        X = np.asarray(rd("f", 3))
        pts[track] = X
    track_list = sorted(pts)
    pt_idx_of_track = {t: i for i, t in enumerate(track_list)}
    points = np.stack([pts[t] for t in track_list])

    (nmark,) = rd("i", 1)
    mc, mp, mxy = [], [], []
    for _ in range(nmark):
        (img,) = rd("i", 1)
        (track,) = rd("i", 1)
        x, y = rd("f", 2)
        if img in cam_idx_of_image and track in pt_idx_of_track:
            mc.append(cam_idx_of_image[img])
            mp.append(pt_idx_of_track[track])
            mxy.append((x, y))

    return LibmvProblem(
        intrinsics=intrinsics,
        cameras_Rt=Rt,
        camera_image=np.asarray(images),
        points=points,
        point_track=np.asarray(track_list),
        marker_cam=np.asarray(mc, dtype=np.int64),
        marker_pt=np.asarray(mp, dtype=np.int64),
        markers=np.asarray(mxy),
        is_image_space=space_flag == b"P",
    )


def reprojection_residual(intrinsics, R_t, X, observed):
    """OpenCVReprojectionError (libmv_bundle_adjuster.cc:446-508):
    x = R X + t, normalize, apply polynomial + tangential distortion."""
    x = angle_axis_rotate_point(R_t[:3], X) + R_t[3:6]
    xn = x[0] / x[2]
    yn = x[1] / x[2]
    f = intrinsics[OFFSET_FOCAL_LENGTH]
    cx = intrinsics[OFFSET_PRINCIPAL_POINT_X]
    cy = intrinsics[OFFSET_PRINCIPAL_POINT_Y]
    k1, k2, k3 = (
        intrinsics[OFFSET_K1],
        intrinsics[OFFSET_K2],
        intrinsics[OFFSET_K3],
    )
    p1, p2 = intrinsics[OFFSET_P1], intrinsics[OFFSET_P2]
    r2 = xn * xn + yn * yn
    r4 = r2 * r2
    r6 = r4 * r2
    r_coeff = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    xd = xn * r_coeff + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * r_coeff + 2.0 * p2 * xn * yn + p1 * (r2 + 2.0 * yn * yn)
    predicted_x = f * xd + cx
    predicted_y = f * yd + cy
    return jnp.stack(
        [predicted_x - observed[0], predicted_y - observed[1]]
    )


def build_problem(
    lp: LibmvProblem, refine_intrinsics: bool = False
) -> Tuple[ct.Problem, int, np.ndarray, np.ndarray]:
    """BuildProblem analog: shared intrinsics block (constant unless
    refine_intrinsics — the BUNDLE_NO_INTRINSICS vs focal/radial modes of
    libmv_bundle_adjuster.cc:520-560), per-camera R_t, points."""
    p = ct.Problem()
    intr = p.add_parameter_block(
        lp.intrinsics.astype(np.float64), constant=not refine_intrinsics
    )
    cam_ids = p.add_parameter_blocks(lp.cameras_Rt)
    pt_ids = p.add_parameter_blocks(lp.points.astype(np.float64))
    p.add_residual_blocks(
        reprojection_residual,
        None,
        [
            np.full(lp.marker_cam.shape[0], intr),
            cam_ids[lp.marker_cam],
            pt_ids[lp.marker_pt],
        ],
        data=jnp.asarray(lp.markers),
    )
    return p, intr, cam_ids, pt_ids


def default_options() -> ct.SolverOptions:
    """libmv_bundle_adjuster.cc EuclideanBundleCommonIntrinsics options."""
    return ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=100,
    )
