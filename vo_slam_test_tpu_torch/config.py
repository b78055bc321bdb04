"""Configuration: the reference's YAML key set as a typed dataclass.

Same keys, defaults and OpenCV ``%YAML:1.0`` header handling as
``vo_slam_test_tpu/config.py``. PyYAML is imported only when a file is parsed,
so the tracker runs where it is not installed.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Any, Dict, Optional


def _load_opencv_yaml(path_or_text: str, is_text: bool = False) -> Dict[str, Any]:
    """Parse an OpenCV-style YAML file (``%YAML:1.0`` directive header)."""
    import yaml

    if is_text:
        text = path_or_text
    else:
        with open(path_or_text, "r") as f:
            text = f.read()
    # OpenCV writes a "%YAML:1.0" directive that PyYAML rejects; strip it.
    lines = [ln for ln in text.splitlines() if not ln.startswith("%YAML")]
    return yaml.safe_load(io.StringIO("\n".join(lines))) or {}


@dataclasses.dataclass
class SlamConfig:
    """Typed view over the reference's YAML key set (config/example.yaml)."""

    # dataset / io paths
    dataset_dir: str = ""
    keyframe_path: str = "keyframe_trajectory.txt"
    camera_path: str = "camera_trajectory.txt"
    vocabulary_in: str = ""
    vocabulary_out: str = ""

    # camera intrinsics (TUM fr1 defaults)
    camera_fx: float = 517.306408
    camera_fy: float = 516.469215
    camera_cx: float = 318.643040
    camera_cy: float = 255.313989
    camera_k1: float = 0.262383
    camera_k2: float = -0.953104
    camera_p1: float = -0.005358
    camera_p2: float = 0.002628
    camera_k3: float = 1.163314
    camera_depthScale: float = 5000.0
    camera_width: int = 640
    camera_height: int = 480
    camera_RGB: int = 1
    camera_fps: int = 30
    camera_bf: float = 40.0
    thDepth: float = 40.0

    # ORB parameters (FAST thresholds are hard-coded 20/7 in the reference)
    num_of_features: int = 1000
    scale_factor: float = 1.2
    level_pyramid: int = 8
    edge_threshold: int = 31
    ini_fast_threshold: int = 20
    min_fast_threshold: int = 7

    # runtime keys the reference requires but never documented
    max_lost: int = 10
    data_num: int = 0  # 0 = all frames

    # drawer / viewer parameters (kept for config compatibility)
    drawer_width: int = 1024
    drawer_height: int = 768
    drawer_fu: float = 500.0
    drawer_fv: float = 500.0
    drawer_u0: float = 512.0
    drawer_v0: float = 384.0
    drawer_viewpointX: float = 0.0
    drawer_viewpointY: float = -0.7
    drawer_viewpointZ: float = -1.8

    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_yaml(cls, path: str) -> "SlamConfig":
        return cls.from_dict(_load_opencv_yaml(path))

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "SlamConfig":
        fields = {f.name: f for f in dataclasses.fields(cls) if f.name != "extras"}
        kwargs: Dict[str, Any] = {}
        extras: Dict[str, Any] = {}
        for key, value in raw.items():
            if key in fields:
                ftype = fields[key].type
                if ftype in ("float", float):
                    value = float(value)
                elif ftype in ("int", int):
                    value = int(value)
                kwargs[key] = value
            else:
                extras[key] = value
        cfg = cls(**kwargs)
        cfg.extras = extras
        return cfg

    def get(self, key: str, default: Optional[Any] = None) -> Any:
        """Reference-style ``Config::get<T>(key)`` access."""
        if hasattr(self, key):
            return getattr(self, key)
        if key in self.extras:
            return self.extras[key]
        if default is not None:
            return default
        raise KeyError(f"config key not found: {key}")
