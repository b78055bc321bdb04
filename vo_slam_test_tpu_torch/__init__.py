"""vo_slam_test_tpu_torch — PyTorch/CUDA port of vo_slam_test_tpu for one NVIDIA H100.

The JAX package ``vo_slam_test_tpu`` is the reference; this package mirrors its
module paths and function names. Plain tensor code is PyTorch; every Pallas
TPU kernel on the ported path is a hand-written CUDA kernel for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.

Ported so far: frame-to-frame ORB tracking (``pipeline/tracking.py::
FusedTracker``) and ``pipeline/system.py::SlamSystem`` (the map, tracking
against the local map, the local-mapping chain with local BA, per frame or in
chunks), with every kernel they run; with a vocabulary (``bow/``) it adds BoW
tracking against the reference keyframe and relocalization (``solvers/
ransac.py``, ``solvers/epnp.py``) and loop closing (``pipeline/
loop_closing.py``, ``solvers/sim3.py``, ``solvers/pose_graph.py``), with
global BA after a closure on request (``solvers/global_ba.py``); the
host-synchronous ``FrameToFrameTracker`` with the host-quadtree
``OrbExtractor``; and the entry point ``python -m vo_slam_test_tpu_torch.run_slam``
with the TUM reader (``datasets/tum.py``, ``native/``), map save/load
(``slam_map/serialize.py``), the drawer and the HTML viewer (``viz/``); and
the multi-device solvers (``parallel/``, ``local_bundle_adjust_mesh``,
``global_bundle_adjust_mesh``) over shards placed on an ordered list of
devices.

Entry points run on the card unless the caller passes ``device="cpu"``; on a
CPU tensor every kernel wrapper runs its plain PyTorch version instead.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

# SLAM geometry is precision-sensitive (the counterpart of the JAX package's
# "highest" matmul precision): no TF32 in matmuls or convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card. Raises when there is none: nothing falls back
    to the CPU unless the caller asks for it explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to run "
                "the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
