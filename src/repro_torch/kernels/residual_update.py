"""K3: the fused FW residual update (paper eq. 10),

    R <- (1 - lam) * R + lam * (y - delta_t * z)

f32 compute, output in ``r``'s dtype. ``lam`` and ``delta_t`` are 0-d
tensors read by the kernel from device memory, never host floats, so the
step needs no sync to launch it.

Replaces the Pallas kernel ``residual_update`` at
``src/repro/kernels/residual_update/residual_update.py:45`` (entry at :30),
one to one. The solver's paths no longer launch it: the lasso's unfused
step runs eq. 10 inside ``kernels/step_tail``, with the rest of the step
after its argmax, and the fused chunks inside K4/K7. Its plain version is
the dense eq. 10 of both of their plain versions.

Bound on an H100: bytes, 4*m*4 + 8 of them (read r, y, z, write the
result), 12.8 KB at m = 800: a few nanoseconds at 3.35 TB/s, so the
kernel is bound by its launch. Design: one grid-stride elementwise pass,
rounding each op separately (no FMA contraction) so that it agrees
bit for bit with the plain version on the card. The result is a new
tensor; the state's residual is not updated in place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def residual_update_plain(r, y, z, lam, delta_t):
    """The plain PyTorch version (reference ``kernels/residual_update/ref.py``)."""
    out = (1.0 - lam) * r.float() + lam * (y.float() - delta_t * z.float())
    return out.to(r.dtype)


def residual_update(r: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                    lam: torch.Tensor, delta_t: torch.Tensor) -> torch.Tensor:
    """New ``(m,)`` residual. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (or raises)."""
    if r.dim() != 1 or y.shape != r.shape or z.shape != r.shape:
        raise ValueError(f"need r, y, z of one shape (m,), got {tuple(r.shape)}, {tuple(y.shape)}, {tuple(z.shape)}")
    if r.device.type == "cpu":
        return residual_update_plain(r, y, z, lam, delta_t)
    if y.dtype != r.dtype or z.dtype != r.dtype:
        raise TypeError("residual_update needs r, y and z of one dtype")
    lam = lam.float().reshape(())
    delta_t = delta_t.float().reshape(())
    dev = _build.require_cuda(r, y, z, lam, delta_t)
    out = torch.empty_like(r)
    if r.numel() == 0:
        return out
    fn = _build.function("residual_update", "residual_update_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(r.data_ptr(), y.data_ptr(), z.data_ptr(), lam.data_ptr(), delta_t.data_ptr(),
                 out.data_ptr(), r.numel(), _build.dtype_code(r), _build.stream(dev))
        residual_update.launches += 1
    _build.check("residual_update", err, "residual_update")
    return out


residual_update.launches = 0
