"""Turn the reference package's parameters, given as numpy or plain data,
into the port's objects and tensors (so both packages can be fed the
same inputs)."""
from __future__ import annotations

import numpy as np
import torch

from . import device as _device
from .core.platform import PlatformSpec
from .kernels.day_scan import ROW_KEYS, TABLE_KEYS


def platform_from_dict(d: dict) -> PlatformSpec:
    """A port `PlatformSpec` from the reference's `PlatformSpec.to_dict()`."""
    return PlatformSpec.from_dict(d)


def theta_from_numpy(theta: dict, device="cuda") -> dict:
    """A theta dict (names -> numbers or 0-dim arrays) as the engine's
    0-dim float32 tensors on `device`."""
    dev = _device.resolve(device)
    return {k: torch.tensor(float(np.float32(v)), dtype=torch.float32,
                            device=dev) for k, v in theta.items()}


def tables_from_numpy(tables: dict, device="cuda") -> dict:
    """The reference's batched day tables (`daysim.batch_tables` layout:
    (N, T, L) level tables, (N, T) step rows, (N, L) act_mult, const dict
    of (N,)) as the port's time-major day-scan tables on `device`:
    (T, L, N), (T, N), (L, N) and (N,) float32 tensors.  Entries the day
    scan does not read (per-stream pods) are dropped."""
    dev = _device.resolve(device)

    def put(a, perm=None):
        a = np.array(a, np.float32)          # a writable copy
        if perm is not None:
            a = np.transpose(a, perm)
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    out = {k: put(tables[k], (1, 2, 0)) for k in TABLE_KEYS}
    out.update({k: put(tables[k], (1, 0)) for k in ROW_KEYS})
    out["act_mult"] = put(tables["act_mult"], (1, 0))
    out["const"] = {k: put(v) for k, v in tables["const"].items()}
    return out
