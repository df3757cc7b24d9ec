"""Precision policies: window *storage* dtype vs scalar *compute* dtype
(port of ``repro.core.precision``), resolved to torch dtypes.

``storage`` is the dtype of the window tensors and the SPMV stream;
``compute`` the dtype of every scalar recurrence, dot payload and
convergence test (never below float32, never below ``b``'s dtype).  The
port's engine runs the default policy only -- windows and scalars both in
``b.dtype`` -- and rejects any other with ``NotImplementedError``
(ROADMAP A.7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

#: dtype spellings accepted for either side of a policy
_DTYPE_NAMES = {
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f16": "float16", "fp16": "float16", "float16": "float16",
    "f32": "float32", "fp32": "float32", "float32": "float32",
    "f64": "float64", "fp64": "float64", "float64": "float64",
}

#: the named storage ladder accepted by ``precision=``
PRECISION_MODES = ("f32", "bf16", "f16", "f64")


def _canon(name, *, side):
    if name is None:
        return None
    key = str(name).lower().removeprefix("torch.")
    key = {"<f4": "float32", "<f8": "float64"}.get(key, key)
    if key not in _DTYPE_NAMES:
        hint = ""
        if key == "tf32":
            hint = (" (tf32 is a matmul *compute* truncation on NVIDIA "
                    "hardware, not a storage dtype; use 'bf16' for "
                    "low-precision storage or 'f32')")
        raise ValueError(
            f"unknown precision {side} dtype {name!r}; expected one of "
            f"{sorted(set(_DTYPE_NAMES))}{hint}")
    return _DTYPE_NAMES[key]


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Normalized precision policy (hashable).

    ``storage`` / ``compute`` are canonical dtype names or ``None``; the
    default policy (both ``None``) resolves to ``(b.dtype, b.dtype)``.
    """

    storage: Optional[str] = None
    compute: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "storage", _canon(self.storage, side="storage"))
        object.__setattr__(self, "compute", _canon(self.compute, side="compute"))
        if self.compute in ("bfloat16", "float16"):
            raise ValueError(
                f"compute dtype must be float32 or float64, got {self.compute!r}")

    @property
    def is_default(self) -> bool:
        return self.storage is None and self.compute is None

    def resolve(self, b_dtype: torch.dtype) -> tuple[torch.dtype, torch.dtype]:
        """``(storage_dtype, compute_dtype)`` for a problem in ``b_dtype``."""
        if self.is_default:
            return b_dtype, b_dtype
        sdt = getattr(torch, self.storage) if self.storage else b_dtype
        return sdt, torch.promote_types(b_dtype, getattr(torch, self.compute or "float32"))


def as_precision_policy(precision) -> PrecisionPolicy:
    """Promote ``precision`` (None | storage name | ``"<storage>x<bits>"``
    compound | torch dtype | PrecisionPolicy) to a :class:`PrecisionPolicy`."""
    if precision is None:
        return PrecisionPolicy()
    if isinstance(precision, PrecisionPolicy):
        return precision
    if isinstance(precision, torch.dtype):
        return PrecisionPolicy(storage=str(precision))
    if isinstance(precision, str):
        name = precision.lower()
        if "x" in name and name not in _DTYPE_NAMES:
            stor, _, bits = name.rpartition("x")
            return PrecisionPolicy(storage=stor, compute=f"f{bits}")
        return PrecisionPolicy(storage=name)
    raise TypeError(
        f"cannot interpret {type(precision).__name__} as a precision "
        f"policy; pass one of {'|'.join(PRECISION_MODES)}, a compound like "
        "'bf16x32', a torch dtype, or a PrecisionPolicy")
