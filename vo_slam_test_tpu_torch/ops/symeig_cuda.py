"""Wrapper of the small symmetric eigensolver (``csrc/symeig.cu``).

``symeig(A)`` launches the kernel for a CUDA tensor and runs the plain
version ``utils/linalg.py::symeig_jacobi`` for a CPU tensor; any other device
raises. Both do the same f64 parallel-order Jacobi, return the eigenvalues
ascending with eigenvectors whose first component of largest magnitude is
positive, NaN for a matrix with a non-finite entry, and read nothing back to
the host (``torch.linalg.eigh`` checks its status there, which a captured
graph cannot do). ``KERNEL.launches`` counts the launches.

This is a kernel of the port's own, not the port of a Pallas kernel: the JAX
package calls ``jnp.linalg.eigh`` and ``jnp.linalg.svd`` (XLA's library
calls) in EPnP and in Horn's alignment.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils import linalg
from . import _build

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
KERNEL = _build.Kernel("symeig", "symeig_f32_launch", _ARGS)


def symeig(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues [..., n] ascending, eigenvectors [..., n, n] as columns)
    of a batch of symmetric matrices [..., n, n], n <= 12, in ``A``'s dtype:
    f32 on the card (the plain version takes any float dtype). Only the
    symmetric part of ``A`` counts. Does not synchronize."""
    if A.device.type == "cpu":
        return linalg.symeig_jacobi(A)
    if A.device.type != "cuda":
        raise ValueError(f"symeig: unsupported device {A.device}")
    n = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != n or not 1 <= n <= linalg.SYMEIG_MAX_N:
        raise ValueError(f"symeig: need [..., n, n] with n <= {linalg.SYMEIG_MAX_N}, "
                         f"got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise ValueError(f"symeig: the kernel takes float32, got {A.dtype}")
    batch = A.shape[:-2]
    flat = A.reshape(-1, n, n).contiguous()
    b = flat.shape[0]
    vals = torch.empty((b, n), dtype=A.dtype, device=A.device)
    vecs = torch.empty((b, n, n), dtype=A.dtype, device=A.device)
    if b:
        if b > 2 ** 31 - 1:
            raise ValueError(f"symeig: batch {b} too large")
        KERNEL(flat.data_ptr(), vals.data_ptr(), vecs.data_ptr(), b, n, linalg.SYMEIG_SWEEPS,
               linalg.SYMEIG_TOL, torch.cuda.current_stream(A.device).cuda_stream)
    return vals.reshape(*batch, n), vecs.reshape(*batch, n, n)
