"""Datasets: the TUM RGB-D reader, the synthetic renderer, TUM trajectory
export and ATE."""

from .synthetic import SyntheticRGBD
from .tum import TumDataset, ate_rmse, read_associate, write_trajectory_tum

__all__ = ["TumDataset", "read_associate", "write_trajectory_tum", "SyntheticRGBD", "ate_rmse"]
