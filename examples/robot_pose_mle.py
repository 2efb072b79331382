"""1-D robot localization MLE — analog of examples/robot_pose_mle.cc.

A robot drives down a corridor taking noisy odometry steps and noisy
range readings to the far wall. The reference models each range reading
with a DynamicAutoDiffCostFunction over ALL previous pose blocks
(robot_pose_mle.cc:63-120). The batched formulation keeps the N
odometry values in ONE vector block: range residual i is a masked
cumulative sum — a single batched family instead of N variable-arity
cost functions (the framework's answer to dynamic-arity costs: reshape
into vector blocks; XLA needs static shapes).
"""

import argparse

import jax.numpy as jnp
import numpy as np

import ceres_tpu as ct


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--corridor_length", type=float, default=30.0)
    ap.add_argument("--pose_separation", type=float, default=0.5)
    ap.add_argument("--odometry_stddev", type=float, default=0.1)
    ap.add_argument("--range_stddev", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    num_steps = int(round(args.corridor_length / args.pose_separation))

    # Ground truth odometry and simulated noisy readings
    # (robot_pose_mle.cc SimulateRobot).
    true_odometry = np.full(num_steps, args.pose_separation)
    odometry_readings = true_odometry + rng.normal(
        0, args.odometry_stddev, num_steps
    )
    true_positions = np.cumsum(true_odometry)
    range_readings = (
        args.corridor_length
        - true_positions
        + rng.normal(0, args.range_stddev, num_steps)
    )

    p = ct.Problem()
    odom = p.add_parameter_block(odometry_readings.copy())

    o_std, r_std = args.odometry_stddev, args.range_stddev
    L = args.corridor_length
    obs_odo = jnp.asarray(odometry_readings)
    obs_rng = jnp.asarray(range_readings)
    #

    def odometry_residuals(o):
        # OdometryConstraint (robot_pose_mle.cc:166-183)
        return (o - obs_odo) / o_std

    def range_residuals(o):
        # RangeConstraint (robot_pose_mle.cc:185-220): range_i should be
        # corridor_length - sum(odometry[0..i])
        pos = jnp.cumsum(o)
        return (L - pos - obs_rng) / r_std

    p.add_residual_block(odometry_residuals, None, [odom])
    p.add_residual_block(range_residuals, None, [odom])

    s = ct.solve(ct.SolverOptions(max_num_iterations=100), p)
    print(s.brief_report())
    est = np.cumsum(p.parameter_block_value(odom))
    rmse_before = np.sqrt(
        np.mean((np.cumsum(odometry_readings) - true_positions) ** 2)
    )
    rmse_after = np.sqrt(np.mean((est - true_positions) ** 2))
    print(
        f"position RMSE: odometry-only {rmse_before:.4f} -> MLE {rmse_after:.4f}"
    )


if __name__ == "__main__":
    main()
