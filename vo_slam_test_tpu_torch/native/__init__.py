"""Native (C++) runtime components, consumed through ctypes: the threaded
RGB-D dataset loader (``dataloader.cpp``)."""

from .loader import NativeTumLoader, build_error, native_available

__all__ = ["NativeTumLoader", "build_error", "native_available"]
