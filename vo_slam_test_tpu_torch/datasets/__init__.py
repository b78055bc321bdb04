"""Synthetic RGB-D renderer, TUM trajectory export and ATE."""

from .synthetic import SyntheticRGBD
from .tum import ate_rmse, write_trajectory_tum

__all__ = ["SyntheticRGBD", "ate_rmse", "write_trajectory_tum"]
