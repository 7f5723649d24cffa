"""Production mesh construction on one card (the reference's
`launch/mesh.py`).

The reference's single pod is a 16 x 16 (data x model) grid of chips and
its multi-pod mesh 2 x 16 x 16 (pod x data x model).  The port runs on
one card, so every axis has width 1: the same axis names over one device
(`training.elastic.Mesh`), and every collective over them is the
identity.
"""
from __future__ import annotations

from .. import device as _device
from ..training.elastic import Mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    shape = (1, 1, 1) if multi_pod else (1, 1)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, _device.resolve(device))


def make_host_mesh(device="cuda") -> Mesh:
    """1 x 1 mesh on the one device (smoke tests)."""
    return Mesh((1, 1), ("data", "model"), _device.resolve(device))
