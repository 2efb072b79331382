"""Fields-of-Experts image denoising.

JAX analog of ``examples/denoising.cc`` +
``examples/fields_of_experts.{h,cc}`` + ``examples/pgm_image.h``: MAP
denoising with a quadratic data term

    sqrt(1/(2 sigma^2)) * (x_ij - noisy_ij)

and FoE regularizer terms ``rho(s) = alpha log(1 + s/2)`` over the dot
product of learned d x d filters with every image patch (Roth & Black,
IJCV 2009).

Structure: pixels are size-1 parameter blocks; each filter contributes
one residual family whose instances are all (H-d+1)x(W-d+1) patches with
d^2 block arguments — the whole regularizer evaluates as a few fused
gather+dot kernels (the reference builds H*W*num_filters individual
residual blocks, denoising.cc:170-185).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

import ceres_tpu as ct
from ceres_tpu.loss import LossFunction


class FieldsOfExpertsLoss(LossFunction):
    """rho(s) = alpha * log(1 + s/2) (fields_of_experts.cc:77-85)."""

    def __init__(self, alpha):
        self.alpha = jnp.asarray(alpha, dtype=jnp.float64)

    def tree_flatten(self):
        return (self.alpha,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux
        obj = cls.__new__(cls)
        obj.alpha = children[0]
        return obj

    def evaluate(self, s):
        s = jnp.asarray(s)
        c = 0.5
        total = 1.0 + s * c
        inv = 1.0 / total
        return (
            self.alpha * jnp.log(total),
            self.alpha * c * inv,
            -self.alpha * c * c * inv * inv,
        )


jax.tree_util.register_pytree_node(
    FieldsOfExpertsLoss,
    FieldsOfExpertsLoss.tree_flatten,
    FieldsOfExpertsLoss.tree_unflatten,
)


@dataclasses.dataclass
class FieldsOfExperts:
    """Loaded FoE model (fields_of_experts.cc:87-137)."""

    size: int  # filter side length d
    alphas: np.ndarray  # (num_filters,)
    filters: np.ndarray  # (num_filters, d*d), column-major patch order

    @property
    def num_filters(self) -> int:
        return self.alphas.shape[0]


def load_foe_file(path) -> FieldsOfExperts:
    """Parse the .foe text format (fields_of_experts.cc:89-122)."""
    tokens = Path(path).read_text().split()
    it = iter(tokens)
    size = int(next(it))
    num_filters = int(next(it))
    if size < 0 or num_filters < 0:
        raise ValueError(f"{path}: invalid FoE header")
    n = size * size
    alphas = np.asarray([float(next(it)) for _ in range(num_filters)])
    filters = np.asarray(
        [[float(next(it)) for _ in range(n)] for _ in range(num_filters)]
    )
    return FieldsOfExperts(size=size, alphas=alphas, filters=filters)


def read_pgm(path) -> np.ndarray:
    """Minimal PGM (P2/P5) reader (pgm_image.h analog)."""
    with open(path, "rb") as f:
        raw = f.read()
    # strip comments
    parts = []
    for line in raw.split(b"\n"):
        hash_at = line.find(b"#")
        parts.append(line[:hash_at] if hash_at >= 0 else line)
    magic_rest = b"\n".join(parts)
    toks = magic_rest.split()
    magic = toks[0]
    w, h, maxval = int(toks[1]), int(toks[2]), int(toks[3])
    if magic == b"P2":
        data = np.asarray([int(t) for t in toks[4 : 4 + w * h]])
    elif magic == b"P5":
        header_len = 0
        seen = 0
        i = 0
        while seen < 4:  # magic, w, h, maxval then single whitespace
            if raw[i : i + 1].isspace():
                while raw[i : i + 1].isspace():
                    i += 1
                continue
            if raw[i : i + 1] == b"#":
                while raw[i : i + 1] != b"\n":
                    i += 1
                continue
            while not raw[i : i + 1].isspace():
                i += 1
            seen += 1
        i += 1  # single whitespace after maxval
        data = np.frombuffer(raw[i : i + w * h], dtype=np.uint8)
    else:
        raise ValueError(f"{path}: unsupported PGM magic {magic}")
    return data.reshape(h, w).astype(np.float64)


def write_pgm(path, img: np.ndarray) -> None:
    img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def build_problem(
    noisy: np.ndarray, foe: FieldsOfExperts, sigma: float = 20.0
) -> Tuple[ct.Problem, np.ndarray]:
    """Create the MAP estimation problem (denoising.cc:150-190).

    Returns (problem, pixel_ids (H, W))."""
    H, W = noisy.shape
    d = foe.size
    p = ct.Problem()
    pix = p.add_parameter_blocks(noisy.reshape(-1, 1))
    pix2d = pix.reshape(H, W)

    # Data term: sqrt(a) (x - b), a = 1/(2 sigma^2) (denoising.cc:156-166).
    sqrt_a = np.sqrt(1.0 / (2.0 * sigma * sigma))

    def data_term(x, b):
        return sqrt_a * (x - b)

    p.add_residual_blocks(
        data_term, None, [pix], data=noisy.reshape(-1, 1)
    )

    # FoE terms: one family per filter over all patches. Patch pixel
    # order is column-major within the patch (fields_of_experts.cc uses
    # NewCostFunction per filter over GetXYBlocks patches).
    rows = np.arange(H - d + 1)
    cols = np.arange(W - d + 1)
    rr, cc = np.meshgrid(rows, cols, indexing="ij")
    rr, cc = rr.reshape(-1), cc.reshape(-1)
    patch_ids = []
    for dc in range(d):
        for dr in range(d):
            patch_ids.append(pix2d[rr + dr, cc + dc])

    for fi in range(foe.num_filters):
        filt = foe.filters[fi]

        def foe_term(*pixels, _filt=jnp.asarray(filt)):
            stackv = jnp.stack([px[0] for px in pixels])
            return jnp.dot(_filt, stackv)[None]

        p.add_residual_blocks(
            foe_term,
            FieldsOfExpertsLoss(foe.alphas[fi]),
            patch_ids,
        )
    return p, pix2d


def default_options() -> ct.SolverOptions:
    """denoising.cc flags: sparse_normal_cholesky/cgnr + jacobi, eta 1e-2."""
    return ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.CGNR,
        preconditioner_type=ct.PreconditionerType.JACOBI,
        eta=1e-2,
        max_num_iterations=100,
    )


def solution_image(problem: ct.Problem, pix2d: np.ndarray) -> np.ndarray:
    H, W = pix2d.shape
    out = np.empty((H, W))
    for r in range(H):
        for c in range(W):
            out[r, c] = problem.parameter_block_value(int(pix2d[r, c]))[0]
    return out
