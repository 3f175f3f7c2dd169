"""Legacy-code interop escape hatch: host-native physics called from the
model's tensors.

The port of `mpas_tpu.physics.legacy`. The reference documents calling
raw-pointer Fortran physics from Regent tasks (its fortran/examples.rg:
24-59) as its interop story for schemes that will never be ported.
mpas_tpu wraps the legacy routine (a C stand-in,
native/mesh_preprocess.cpp legacy_column_relaxation — any Fortran/C/C++
symbol loadable via ctypes works the same way) in `jax.pure_callback`. In
eager PyTorch no callback is needed: the tensor is copied to the host, the
raw-pointer code runs on it, and the result is copied back to the tensor's
device. This trades device-side work for zero porting cost — for
slow-cadence physics, never for per-step kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..parallel import native


def _fn():
    lib = native.load_library()
    if lib is None:
        return None
    try:
        f = lib.legacy_column_relaxation
    except AttributeError:
        # a library built from a source without this symbol: treat the
        # legacy path as unavailable rather than crashing callers/skipifs
        return None
    f.argtypes = [ctypes.POINTER(ctypes.c_double),
                  ctypes.POINTER(ctypes.c_double), ctypes.c_double,
                  ctypes.c_int64, ctypes.c_int64,
                  ctypes.POINTER(ctypes.c_double)]
    f.restype = None
    return f


def available() -> bool:
    return _fn() is not None


def _host_relaxation(theta, theta_ref, tau):
    """numpy -> raw pointers -> legacy C."""
    f = _fn()
    if f is None:
        raise RuntimeError("legacy_column_relaxation is unavailable: the "
                           "native library could not be built or loaded")
    theta = np.ascontiguousarray(theta, np.float64)
    theta_ref = np.ascontiguousarray(theta_ref, np.float64)
    K, C = theta.shape
    if theta_ref.shape != (K,):
        raise ValueError(f"theta_ref has shape {theta_ref.shape}, expected "
                         f"({K},)")
    out = np.empty_like(theta)
    dp = ctypes.POINTER(ctypes.c_double)
    f(theta.ctypes.data_as(dp), theta_ref.ctypes.data_as(dp),
      float(tau), K, C, out.ctypes.data_as(dp))
    return out


def legacy_relaxation_tend(theta, theta_ref, tau: float):
    """Newtonian relaxation tendency computed by the legacy raw-pointer
    routine: tend = -(theta - theta_ref[:, None]) / tau, on `theta`'s device
    and in its dtype (computed in float64 on the host).

    theta [K, C] (level-major, core/state.py), theta_ref [K]."""
    out = _host_relaxation(theta.detach().cpu().double().numpy(),
                           theta_ref.detach().cpu().double().numpy(), tau)
    return torch.from_numpy(out).to(theta.device, theta.dtype)
