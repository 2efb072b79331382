"""Device-mesh parallelism for ceres_tpu.

JAX replacement for the reference's entire threading backend
(``internal/ceres/thread_pool.h``, ``parallel_for.h:70-155``,
``context_impl.h`` — SURVEY.md §2.8): instead of a thread pool fanning
residual blocks out to CPU workers with per-thread scratch and locks,
residual-family batches are sharded over a ``jax.sharding.Mesh`` axis and
every reduction the reference guards with locks (gradient accumulation,
J'J diagonals, the reduced Schur camera system) becomes an XLA collective
inserted automatically by GSPMD at the scatter-add/reduce points.

The analog of ``Solver::Options::num_threads`` is
``SolverOptions.mesh`` — pass a mesh and the solve shards.
"""

from ceres_tpu.parallel.sharding import (
    make_mesh,
    make_mesh_2d,
    pad_family,
    shard_program,
    replicate,
)

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "pad_family",
    "shard_program",
    "replicate",
]
