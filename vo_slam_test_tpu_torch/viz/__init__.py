from .drawer import MapSnapshot, snapshot_map, plot_map, plot_trajectories, save_metrics_csv

__all__ = ["MapSnapshot", "snapshot_map", "plot_map", "plot_trajectories", "save_metrics_csv"]
