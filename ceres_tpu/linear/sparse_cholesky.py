"""Sparse direct factorization backend (host CPU, native core).

JAX counterpart of the reference's sparse direct stack:
``sparse_cholesky.h:71-112`` (the Factorize-once/Solve-many interface),
``suitesparse.h:306`` (CHOLMOD wrapper) and the AMD fill-reducing
ordering applied in ``reorder_program.cc``. The device evaluates the
block Jacobian; the normal equations are assembled and factorized on
the host (where a sequential elimination is the right machine for the
job), invoked from inside the jitted step via ``jax.pure_callback``.
Symbolic analysis is cached per sparsity pattern, so repeated LM
iterations pay only the numeric refactorization — the same
analyze-once/refactor-many split CHOLMOD gives the reference.

SPARSE_NORMAL_CHOLESKY solves (J'J + D^2) y = rhs exactly;
``dynamic_sparsity`` (solver.h:365-383) drops numerically-zero entries
and re-analyzes every iteration.

Two execution modes:
- host-driven: the trust-region loop calls
  :func:`host_sparse_normal_solve` directly between jitted device
  computations (``trust_region._make_sparse_lm_step_fn``);
- in-graph: :func:`solve_sparse_normal_cholesky` embeds the host solve
  via ``jax.pure_callback`` so fully-jitted callers (dogleg precompute,
  mixed-precision refinement) still get the exact path.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ceres_tpu.linear.cg import CG_FAILURE, CG_FATAL_ERROR, CG_SUCCESS
from ceres_tpu.utils import native


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def nested_dissection_order(
    n: int, Ap: np.ndarray, Ai: np.ndarray, leaf: int = 128
) -> np.ndarray:
    """Nested-dissection elimination order (reorder_program.cc NESDIS
    analog): recursive bisection by BFS level-set separators, leaves in
    natural order. Pure host-side numpy/scipy — the ordering runs once
    per sparsity pattern.

    Returns ``perm`` with perm[k] = original column eliminated at step k
    (parts first, separator last at every level)."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    if n == 0:
        return np.zeros(0, dtype=np.int32)
    U = sp.csc_matrix(
        (np.ones(len(Ai), dtype=np.int8), Ai, Ap), shape=(n, n)
    )
    A = ((U + U.T) > 0).tocsr()
    A.setdiag(0)
    A.eliminate_zeros()

    # Explicit-stack recursion. A plain node-set recurses; a
    # ("sep", nodes) entry emits a separator AFTER both of its parts
    # (pushed above it on the LIFO stack) have been fully emitted.
    order: list = []
    stack: list = [np.arange(n, dtype=np.int64)]
    while stack:
        item = stack.pop()
        if isinstance(item, tuple):
            order.append(item[1])
            continue
        nodes = item
        if nodes.size == 0:
            continue
        if nodes.size <= leaf:
            order.append(nodes)
            continue
        S = A[nodes][:, nodes].tocsr()
        ncomp, labels = csgraph.connected_components(S, directed=False)
        if ncomp > 1:
            for c in range(ncomp):
                stack.append(nodes[labels == c])
            continue
        # pseudo-peripheral start: BFS from 0, restart from the farthest
        lvl = csgraph.breadth_first_order(
            S, 0, directed=False, return_predecessors=False
        )
        far = int(lvl[-1])
        dist = csgraph.shortest_path(
            S, method="BF", unweighted=True, indices=far
        )
        maxd = int(dist.max())
        if maxd < 2:
            order.append(nodes)  # near-clique: no useful separator
            continue
        mid = maxd // 2
        sep = nodes[dist == mid]
        left = nodes[dist < mid]
        right = nodes[dist > mid]
        stack.append(("sep", sep))
        stack.append(right)
        stack.append(left)
    perm = (
        np.concatenate(order) if order else np.zeros(0, np.int64)
    )
    return perm.astype(np.int32)


def _etree_postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder of the elimination tree (CSparse cs_post analog):
    children before parents, subtrees contiguous. ``parent[v]`` is the
    etree parent of v, or <0 / >=n for roots."""
    n = len(parent)
    first_child = np.full(n, -1, dtype=np.int64)
    next_sib = np.full(n, -1, dtype=np.int64)
    for v in range(n - 1, -1, -1):
        p = parent[v]
        if 0 <= p < n:
            next_sib[v] = first_child[p]
            first_child[p] = v
    post = np.empty(n, dtype=np.int32)
    k = 0
    for root in range(n):
        p = parent[root]
        if 0 <= p < n:
            continue
        # iterative DFS emitting postorder
        stack = [root]
        while stack:
            v = stack[-1]
            c = first_child[v]
            if c >= 0:
                first_child[v] = -1  # mark children as consumed
                while c >= 0:
                    stack.append(int(c))
                    c = next_sib[c]
                # reverse the just-pushed children so postorder follows
                # child order (cosmetic; any child order is valid)
            else:
                post[k] = v
                k += 1
                stack.pop()
    assert k == n, "etree postorder did not visit every node"
    return post


class SparseCholesky:
    """Simplicial LL' of a sparse SPD matrix with a fill-reducing
    ordering (sparse_cholesky.h:71-112 analog).

    ``Ap``/``Ai`` describe the UPPER-triangular CSC pattern (diagonal
    present, rows sorted). ``factorize(Ax)`` may be called repeatedly
    with new values on the same pattern. ``ordering`` selects AMD
    (native lazy-heap minimum degree), NESDIS (BFS-separator nested
    dissection, reorder_program.cc:114-613 analog) or NATURAL;
    ``use_postordering`` additionally post-orders the elimination tree
    (suitesparse.h use_postordering semantics)."""

    def __init__(self, n: int, Ap: np.ndarray, Ai: np.ndarray,
                 ordering: str = "AMD", use_postordering: bool = False,
                 precision: str = "double"):
        lib = native.get_lib()
        if lib is None:
            raise RuntimeError("native core unavailable")
        if precision not in ("double", "single"):
            raise ValueError(f"unknown precision {precision!r}")
        self._lib = lib
        self._handle = None
        self.precision = precision
        self.n = int(n)
        self.Ap = np.ascontiguousarray(Ap, dtype=np.int64)
        self.Ai = np.ascontiguousarray(Ai, dtype=np.int32)
        self.perm = np.empty(self.n, dtype=np.int32)
        if ordering == "AMD" and self.n > 0:
            rc = lib.mindeg_order(
                self.n, _i64p(self.Ap), _i32p(self.Ai), _i32p(self.perm)
            )
            if rc != 0:
                raise RuntimeError("mindeg_order failed")
        elif ordering == "NESDIS" and self.n > 0:
            self.perm = nested_dissection_order(self.n, self.Ap, self.Ai)
        else:  # NATURAL
            self.perm = np.arange(self.n, dtype=np.int32)
        self._build_symbolic()
        if use_postordering and self.n > 0:
            post = _etree_postorder(self.parent)
            if not np.array_equal(post, np.arange(self.n)):
                # Re-analyze with the postordered elimination order:
                # step k now eliminates original column perm[post[k]].
                self._lib.sparse_chol_symbolic_free(self._handle)
                self._handle = None
                self.perm = self.perm[post]
                self._build_symbolic()
        self._factorized = False

    def _build_symbolic(self):
        self.parent = np.empty(self.n, dtype=np.int32)
        self.Lp = np.empty(self.n + 1, dtype=np.int64)
        # Opaque native handle: keeps the permuted pattern + etree so
        # factorize() is numeric-only (cholmod_analyze/cholmod_factorize
        # split of suitesparse.h:306).
        self._handle = self._lib.sparse_chol_symbolic_new(
            self.n, _i64p(self.Ap), _i32p(self.Ai), _i32p(self.perm),
            _i32p(self.parent), _i64p(self.Lp),
        )
        if not self._handle:
            raise RuntimeError("sparse_chol_symbolic_new failed")
        self.nnz_L = int(self._lib.sparse_chol_symbolic_nnz(self._handle))
        self.Li = np.empty(self.nnz_L, dtype=np.int32)
        self.Lx = np.empty(
            self.nnz_L,
            dtype=np.float64 if self.precision == "double" else np.float32,
        )
        self._factorized = False

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            self._lib.sparse_chol_symbolic_free(h)
            self._handle = None

    def factorize(self, Ax: np.ndarray) -> int:
        """Numeric refactorization (no symbolic work). Returns 0 on
        success, k>0 when the pivot at (permuted) column k-1 is
        non-positive. Single precision factors through the f32 numeric
        core (RefinedSparseCholesky analog, sparse_cholesky.h:118)."""
        if self.precision == "single":
            Ax = np.ascontiguousarray(Ax, dtype=np.float32)
            rc = self._lib.sparse_chol_refactorize_f32(
                self._handle, _f32p(Ax), _i32p(self.Li), _f32p(self.Lx)
            )
        else:
            Ax = np.ascontiguousarray(Ax, dtype=np.float64)
            rc = self._lib.sparse_chol_refactorize(
                self._handle, _f64p(Ax), _i32p(self.Li), _f64p(self.Lx)
            )
        self._factorized = rc == 0
        return int(rc)

    def solve(self, b: np.ndarray) -> np.ndarray:
        """Solve A x = b (b: (n,) or (k, n)); always returns float64
        (a single-precision factor backsolves in f32 — its result is
        the refinement-loop correction, iterative_refiner.h)."""
        if not self._factorized:
            raise RuntimeError("factorize() has not succeeded")
        if self.precision == "single":
            b2 = np.ascontiguousarray(
                np.atleast_2d(np.asarray(b, dtype=np.float32))
            )
            x = np.empty_like(b2)
            self._lib.sparse_chol_solve_f32(
                self.n, _i64p(self.Lp), _i32p(self.Li), _f32p(self.Lx),
                _i32p(self.perm), b2.shape[0], _f32p(b2), _f32p(x),
            )
            x = x.astype(np.float64)
        else:
            b2 = np.ascontiguousarray(
                np.atleast_2d(np.asarray(b, dtype=np.float64))
            )
            x = np.empty_like(b2)
            self._lib.sparse_chol_solve(
                self.n, _i64p(self.Lp), _i32p(self.Li), _f64p(self.Lx),
                _i32p(self.perm), b2.shape[0], _f64p(b2), _f64p(x),
            )
        return x[0] if np.ndim(b) == 1 else x

    def refined_solve(
        self,
        H_upper,
        b: np.ndarray,
        num_refinement_iterations: int = 3,
    ) -> np.ndarray:
        """Factor-precision solve + double-precision iterative refinement
        (the RefinedSparseCholesky composition, sparse_cholesky.h:118 +
        iterative_refiner.{h,cc}): x_{k+1} = x_k + A^{-~1}(b - A x_k)
        with the residual computed from the double-precision ``H_upper``
        (scipy upper-CSC) and the correction from this factor. A fixed
        iteration count, like the reference's IterativeRefiner."""
        import scipy.sparse as sp

        b64 = np.asarray(b, dtype=np.float64)
        x = self.solve(b64)
        if num_refinement_iterations <= 0:
            return x
        Hfull = H_upper + sp.triu(H_upper, k=1, format="csc").T
        for _ in range(num_refinement_iterations):
            r = b64 - Hfull @ x
            x = x + self.solve(r)
        return x


def factor_solve_csc(
    chol_cache: dict,
    n: int,
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    rhs: np.ndarray,
    ordering: str = "AMD",
    use_postordering: bool = False,
    mixed_precision: bool = False,
    num_refinement_iterations: int = 3,
) -> Tuple[np.ndarray, int]:
    """Shared host factor+solve over an assembled upper-CSC SPD system.

    Caches the :class:`SparseCholesky` per (ordering, postordering,
    precision) in ``chol_cache`` (factor-once/refactor-many,
    sparse_cholesky.h:71-112). ``mixed_precision`` factors in f32 and
    wraps the backsolve in double-precision iterative refinement — the
    RefinedSparseCholesky composition (sparse_cholesky.h:118,
    iterative_refiner.{h,cc}). Falls back to SuperLU when the native
    core is unavailable. Returns (x, termination-code)."""
    key = (ordering, use_postordering, mixed_precision)
    chol = chol_cache.get(key)
    if chol is None:
        try:
            chol = SparseCholesky(
                n, indptr, indices,
                ordering=ordering, use_postordering=use_postordering,
                precision="single" if mixed_precision else "double",
            )
        except RuntimeError:
            chol = "scipy"
        chol_cache[key] = chol
    import scipy.sparse as sp

    if chol == "scipy":
        # Native core unavailable: SuperLU fallback (the reference's
        # Eigen fallback when CHOLMOD is absent).
        import scipy.sparse.linalg as spla

        H = sp.csc_matrix((data, indices, indptr), shape=(n, n))
        Hfull = H + sp.triu(H, k=1, format="csc").T
        x = spla.spsolve(Hfull, np.asarray(rhs, dtype=np.float64))
    else:
        rc = chol.factorize(data)
        if rc != 0 and mixed_precision:
            # The f32 factor can fail on systems a double factor handles
            # (condition past ~1/eps_f32: huge-radius LM steps on gauge-
            # deficient problems). Degrade THIS solve to the exact
            # double path instead of reporting failure — the reference's
            # layered failure handling never lets mixed precision make a
            # solvable system unsolvable (iterative_refiner.h contract).
            return factor_solve_csc(
                chol_cache, n, indptr, indices, data, rhs,
                ordering=ordering, use_postordering=use_postordering,
                mixed_precision=False,
            )
        if rc != 0:
            return np.zeros(n), int(CG_FAILURE)
        if mixed_precision:
            H = sp.csc_matrix((data, indices, indptr), shape=(n, n))
            x = chol.refined_solve(
                H,
                np.asarray(rhs, dtype=np.float64),
                num_refinement_iterations=num_refinement_iterations,
            )
        else:
            x = chol.solve(np.asarray(rhs, dtype=np.float64))
    if not np.all(np.isfinite(x)):
        return np.zeros(n), int(CG_FATAL_ERROR)
    return x, int(CG_SUCCESS)


# ---------------------------------------------------------------------------
# SPARSE_NORMAL_CHOLESKY host path
# ---------------------------------------------------------------------------

# pattern-key -> SparseCholesky (symbolic + workspace reuse across LM
# iterations; the pattern of J'J is fixed for a given Program).
_SYMBOLIC_CACHE: dict = {}
_CACHE_CAP = 32


def _assemble_normal_eqs(nt, dynamic, D, args):
    """Host: scipy CSC upper triangle of J'J + diag(D^2) from the
    per-family lists of (tangent_idx, jac) pairs — one list per family,
    one pair per argument; all arguments of a family share the same
    residual rows (crs_matrix.h-style assembly from block Jacobians,
    without densification)."""
    import scipy.sparse as sp

    rows_l, cols_l, vals_l = [], [], []
    row0 = 0
    for fam_pairs in args:
        nrows_f = 0
        for tj, Jj in fam_pairs:
            tj = np.asarray(tj)
            Jj = np.asarray(Jj, dtype=np.float64)
            B, r, T = Jj.shape
            nrows_f = B * r
            rows_f = row0 + np.arange(B * r).reshape(B, r)
            keep = tj < nt  # constant-block dummy columns
            rr = np.broadcast_to(rows_f[:, :, None], (B, r, T))
            cc = np.broadcast_to(tj[:, None, :], (B, r, T))
            kk = np.broadcast_to(keep[:, None, :], (B, r, T))
            rows_l.append(rr[kk])
            cols_l.append(cc[kk])
            vals_l.append(Jj[kk])
        row0 += nrows_f
    J = sp.csr_matrix(
        (
            np.concatenate(vals_l),
            (np.concatenate(rows_l), np.concatenate(cols_l)),
        ),
        shape=(row0, nt),
    )
    if dynamic:
        J.eliminate_zeros()
    H = (J.T @ J).tocsc()
    H = (H + sp.diags(np.asarray(D, dtype=np.float64) ** 2)).tocsc()
    H = sp.triu(H, format="csc")
    H.sort_indices()
    return H


def host_sparse_normal_solve(
    nt: int,
    dynamic: bool,
    D: np.ndarray,
    rhs: np.ndarray,
    args,
    ordering: str = "AMD",
    use_postordering: bool = False,
    mixed_precision: bool = False,
    num_refinement_iterations: int = 3,
) -> Tuple[np.ndarray, np.int32, np.int32]:
    """Assemble + factorize + solve on the host. ``args`` is one list
    per residual family, each holding that family's per-argument
    (tangent_idx, jacobian) pairs. ``mixed_precision`` takes the
    RefinedSparseCholesky route (f32 factor + f64 refinement). Returns
    (y, iterations, termination-code)."""
    H = _assemble_normal_eqs(nt, dynamic, D, args)
    # Key on the raw pattern bytes (not their hash): a hash collision
    # between two patterns would silently reuse the wrong symbolic
    # factorization (matters for dynamic_sparsity, where the pattern
    # changes every iteration).
    key = (H.shape[0], H.indptr.tobytes(), H.indices.tobytes())
    chol_cache = _SYMBOLIC_CACHE.get(key)
    if chol_cache is None:
        if len(_SYMBOLIC_CACHE) >= _CACHE_CAP:
            _SYMBOLIC_CACHE.clear()
        chol_cache = {}
        _SYMBOLIC_CACHE[key] = chol_cache
    y, term = factor_solve_csc(
        chol_cache,
        H.shape[0],
        H.indptr,
        H.indices,
        H.data,
        rhs,
        ordering=ordering,
        use_postordering=use_postordering,
        mixed_precision=mixed_precision,
        num_refinement_iterations=num_refinement_iterations,
    )
    return y, np.int32(1), np.int32(term)


def solve_sparse_normal_cholesky(ctx, D, rhs=None, dynamic=False):
    """jit-safe SPARSE_NORMAL_CHOLESKY: device block Jacobian ->
    host assembly + native simplicial Cholesky -> device step.
    Returns (y, lin_iters, termination) matching _base_linear_solve."""
    import jax
    import jax.numpy as jnp

    nt = ctx.num_tangent
    rhs_arr = ctx.gradient() if rhs is None else rhs
    flat = []
    fam_nargs = []
    for fi, fam in enumerate(ctx.families):
        fam_nargs.append(fam.num_args)
        for j in range(fam.num_args):
            flat.append(fam.tangent_idx[j])
            flat.append(ctx.jacs[fi][j])

    def _host(D_h, rhs_h, *flat_h):
        args, k = [], 0
        for na in fam_nargs:
            args.append(
                [(flat_h[k + 2 * j], flat_h[k + 2 * j + 1]) for j in range(na)]
            )
            k += 2 * na
        return host_sparse_normal_solve(nt, dynamic, D_h, rhs_h, args)

    out_dtype = rhs_arr.dtype
    y64, iters, term = jax.pure_callback(
        _host,
        (
            jax.ShapeDtypeStruct((nt,), jnp.float64),
            jax.ShapeDtypeStruct((), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32),
        ),
        D,
        rhs_arr,
        *flat,
        vmap_method="sequential",
    )
    return y64.astype(out_dtype), iters, term
