"""Pinned host memory as the hand-written kernels see it.

A kernel reads a tensor in place from the card or, over the link, from
pinned host memory through the device address
`cudaHostGetDevicePointer` gives (the shim in `csrc/host_memory.cu`).
Every kernel wrapper that may take a host tensor checks it with
`check_memory` and passes `device_address`: a tensor in pageable host
memory raises, and nothing is ever copied to the card on the side.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import library


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = library("host_memory")
    lib.mapped_address.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_void_p)]
    lib.mapped_address.restype = ctypes.c_int
    return lib


def check_memory(name: str, t: torch.Tensor) -> None:
    """A kernel reads `t` in place only from the card or from pinned
    host memory: raise for anything else (never copy it over). Makes no
    CUDA call for a CPU tensor."""
    if t.device.type == "cpu" and not t.is_pinned():
        raise ValueError(f"{name} lies in pageable host memory: a CUDA "
                         f"kernel reads host memory in place only when it "
                         f"is pinned, and the port never copies it to the "
                         f"card instead (CPU tensors take the plain "
                         f"versions in kernels/ref.py)")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} lies on {t.device}")


def device_address(t: torch.Tensor) -> int:
    """The address a kernel uses for `t`: its own on the card, the
    mapped address of its pinned allocation (cudaHostGetDevicePointer,
    plus the view's offset) in host memory."""
    check_memory("tensor", t)
    if t.device.type == "cuda":
        return t.data_ptr()
    base = t.untyped_storage().data_ptr()
    dev = ctypes.c_void_p()
    err = _library().mapped_address(base, ctypes.byref(dev))
    if err != 0 or dev.value is None:
        raise RuntimeError(f"cudaHostGetDevicePointer failed: CUDA error "
                           f"{err}")
    return dev.value + (t.data_ptr() - base)
