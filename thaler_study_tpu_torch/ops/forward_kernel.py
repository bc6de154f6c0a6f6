"""One layer of the GKR forward pass on the card, and its plain version.

Counterpart of the layer step of ``thaler_study_tpu/gkr/circuit.py:155``
``evaluate_device`` (``layer_step`` :166): per gate g, with labels b_g and
c_g into the previous layer's values and its type, mul_g ? cur[b_g] *
cur[c_g] : cur[b_g] + cur[c_g]. ``gkr/circuit.Circuit.evaluate_device``
calls :func:`forward_layer` once per layer. The CUDA source is
``csrc/forward.cu`` (one thread per gate); its note says what bounds it.
CPU tensors take :func:`forward_layer_plain`; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..fields import FArray

# launches of the CUDA kernel (not of the plain version), per field family
launches = {"goldilocks": 0, "mont32": 0}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("forward").ts_forward_launch
        vp = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, vp, vp, vp, vp, vp, ctypes.c_longlong, vp]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(cur: FArray, b: torch.Tensor, c: torch.Tensor, is_mul: torch.Tensor) -> None:
    g = b.shape[0] if b.dim() == 1 else -1
    if (cur.data.dim() != 1 or not cur.data.is_contiguous() or b.dtype != torch.int32 or c.dtype != torch.int32
            or is_mul.dtype != torch.bool or c.shape != (g,) or is_mul.shape != (g,) or g < 1
            or not all(x.is_contiguous() and x.device == cur.device for x in (b, c, is_mul))):
        raise ValueError("forward_layer takes a contiguous 1-D FArray, int32 labels b and c and a bool is_mul of one "
                         f"length on its device; got {cur.shape}, {b.dtype} {tuple(b.shape)}, {c.dtype} "
                         f"{tuple(c.shape)}, {is_mul.dtype} {tuple(is_mul.shape)}")


def forward_layer(cur: FArray, b: torch.Tensor, c: torch.Tensor, is_mul: torch.Tensor) -> FArray:
    """The layer's values from the previous layer's ``cur``: gate g is
    cur[b[g]] * cur[c[g]] where is_mul[g], else cur[b[g]] + cur[c[g]]. The
    labels must index ``cur`` (``Circuit.device_wiring`` checks them once
    per circuit). One launch on the card; CPU tensors take
    :func:`forward_layer_plain`."""
    _check(cur, b, c, is_mul)
    dev = cur.device
    if dev.type == "cpu":
        return forward_layer_plain(cur, b, c, is_mul)
    if dev.type != "cuda":
        raise ValueError(f"forward_layer runs on cpu or cuda, not {dev}")
    field = cur.field
    out = torch.empty(b.shape[0], dtype=cur.data.dtype, device=dev)
    mont32 = field.backend == "mont32"
    with torch.cuda.device(dev):
        rc = _kernel()(int(mont32), field.p if mont32 else 0, field.mont_pinv_neg if mont32 else 0,
                       cur.data.data_ptr(), b.data_ptr(), c.data_ptr(), is_mul.data_ptr(), out.data_ptr(),
                       b.shape[0], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"forward kernel launch failed: CUDA error {rc}")
    launches[field.backend] += 1
    return FArray(out, field)


def forward_layer_plain(cur: FArray, b: torch.Tensor, c: torch.Tensor, is_mul: torch.Tensor) -> FArray:
    """:func:`forward_layer` in plain torch ops (any device): two gathers,
    the product, the sum and a select."""
    lhs = FArray(torch.index_select(cur.data, 0, b), cur.field)
    rhs = FArray(torch.index_select(cur.data, 0, c), cur.field)
    return FArray(torch.where(is_mul, (lhs * rhs).data, (lhs + rhs).data), cur.field)
