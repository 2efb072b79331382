"""Minimize 0.5 (10 - x)^2 with a hand-written analytic Jacobian —
analog of examples/helloworld_analytic_diff.cc (SizedCostFunction).

The JAX form of a user-supplied Jacobian is ``ct.analytic_cost``:
the hand-written derivative is attached as a ``jax.custom_jvp`` rule, so
the solver's fused batched-forward-mode pipeline consumes it
transparently (same batching, same manifold chain rule).
"""

import jax.numpy as jnp
import numpy as np

import ceres_tpu as ct


def residual(x):
    return 10.0 - x


def jacobian(x):
    # dr/dx = -1 (helloworld_analytic_diff.cc:55-76: jacobians[0][0] = -1)
    return (jnp.full((1, 1), -1.0, dtype=x.dtype),)


def main():
    p = ct.Problem()
    x0 = 0.5
    xb = p.add_parameter_block(np.array([x0]))
    p.add_residual_block(ct.analytic_cost(residual, jacobian), None, [xb])
    options = ct.SolverOptions(minimizer_progress_to_stdout=True)
    summary = ct.solve(options, p)
    print(summary.brief_report())
    print(f"x : {x0} -> {p.parameter_block_value(xb)[0]}")


if __name__ == "__main__":
    main()
