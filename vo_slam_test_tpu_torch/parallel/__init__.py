"""Multi-device solvers: observation-sharded Gauss-Newton terms."""

from .sharded import (
    ObsMesh,
    make_obs_mesh,
    shard_observations,
    sharded_ba_normal_equations,
    sharded_ba_schur_step,
    sharded_pose_gn_step,
)

__all__ = [
    "ObsMesh",
    "make_obs_mesh",
    "shard_observations",
    "sharded_pose_gn_step",
    "sharded_ba_normal_equations",
    "sharded_ba_schur_step",
]
