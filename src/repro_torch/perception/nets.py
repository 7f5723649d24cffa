"""Egocentric-primitive implementations (Table I) as small PyTorch nets.

The six nets of the reference's `perception/nets.py`, as functions of
`(params, input)`: the reference draws each net's weights inside the
call from a JAX key; here `init(name, generator)` draws them from a
seeded CPU `torch.Generator`, and a caller (a parity test) may pass any
weights of the same shapes (`param_shapes(name)`).  Inputs and weights
keep the reference's layouts (NHWC / NWC activations, HWIO / WIO
kernels); each convolution pads as XLA's "SAME" does, which at stride 2
puts the odd pad row on the high side.

  * VIO frontend  — TLIO-style IMU 1D-ResNet + greyscale feature frontend.
  * Hand tracking — UMETrack-style multi-view crop CNN -> 21 keypoints/hand.
  * Eye tracking  — VOG gaze CNN per eye.
  * VAD           — tiny conv speech detector.
  * ASR           — streaming Conformer-lite acoustic model + CTC.

`measured_flops()` is the frozen table of XLA's compiled FLOPs per call
(`core.workloads`, which sizes the taskgraphs); `torch_flops()` counts the
port's own products (convolutions and matrix products, by
`torch.utils.flop_counter.FlopCounterMode`) at the same shapes, to be
reported beside XLA's count, never in its place.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..core.workloads import measured_flops  # noqa: F401  (XLA's table)
from ..nn import core

D_ASR, HEADS_ASR, BLOCKS_ASR = 256, 4, 12

NETS = ("hand_tracker", "eye_tracker", "vio_imu_net", "vio_frontend", "vad",
        "asr_conformer")
# the frozen table's key of each net and the input of one invocation
# (the reference's nets.py:194-201)
FLOPS_INPUTS = {"hand_tracker": ("hand_tracker", (1, 2, 128, 128, 1)),
                "eye_tracker": ("eye_tracker", (1, 2, 96, 96, 1)),
                "vio_imu": ("vio_imu_net", (1, 200, 6)),
                "vio_frontend": ("vio_frontend", (1, 240, 320, 1)),
                "vad": ("vad", (1, 100, 40)),
                "asr_1s": ("asr_conformer", (1, 100, 80))}


def _conv_shape(cin, cout, k=3):
    """An HWIO kernel and its fan-in (the reference's `_conv`)."""
    return (k, k, cin, cout), k * k * cin


def _conv1d_shape(cin, cout, k=3):
    """A WIO kernel and its fan-in (the reference's `_conv1d`)."""
    return (k, cin, cout), k * cin


def _dense(din, dout, fan_in=None):
    return (din, dout), din if fan_in is None else fan_in


def param_shapes(name: str) -> dict:
    """Each weight of net `name` as (shape, fan_in), in the tree the net
    reads."""
    if name == "hand_tracker":
        widths = (1, 16, 32, 64, 96, 128)
        return {"convs": [_conv_shape(a, b) for a, b in zip(widths,
                                                             widths[1:])],
                "fc": _dense(128, 128), "out": _dense(128, 21 * 3)}
    if name == "eye_tracker":
        widths = (1, 12, 24, 48, 64)
        return {"convs": [_conv_shape(a, b) for a, b in zip(widths,
                                                             widths[1:])],
                "out": _dense(64, 4)}
    if name == "vio_imu_net":
        widths = (32, 64, 64, 128, 128)
        return {"convs": [_conv1d_shape(6, 32, k=7)]
                + [_conv1d_shape(a, b) for a, b in zip(widths, widths[1:])],
                "out": _dense(128, 6)}
    if name == "vio_frontend":
        widths = (1, 8, 16, 32)
        return {"convs": [_conv_shape(a, b) for a, b in zip(widths,
                                                             widths[1:])],
                "heat": _conv_shape(32, 1), "desc": _conv_shape(32, 32)}
    if name == "vad":
        return {"convs": [_conv1d_shape(40, 32), _conv1d_shape(32, 32)],
                "out": _dense(32, 1)}
    if name == "asr_conformer":
        d = D_ASR
        block = {"ff_in": _dense(d, 4 * d), "ff_out": _dense(4 * d, d, 4 * d),
                 "wq": _dense(d, d), "wk": _dense(d, d), "wv": _dense(d, d),
                 "conv": _conv1d_shape(d, d, k=9)}
        return {"subsample": [_conv1d_shape(80, d), _conv1d_shape(d, d)],
                "blocks": [dict(block) for _ in range(BLOCKS_ASR)],
                "out": _dense(d, 1024)}
    raise ValueError(f"unknown net {name!r}; the nets are {NETS}")


def _is_leaf(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def _leaf_map(fn, tree):
    """`fn(shape, fan_in)` over the (shape, fan_in) leaves of `tree`."""
    if _is_leaf(tree):
        return fn(*tree)
    if isinstance(tree, dict):
        return {k: _leaf_map(fn, v) for k, v in tree.items()}
    return [_leaf_map(fn, v) for v in tree]


def init(name: str, gen: torch.Generator, device="cuda",
         dtype=torch.float32) -> dict:
    """Net `name`'s weights, LeCun-normal over each contracting dimension
    as the reference's `core.dense_init`, drawn from the CPU generator
    `gen` in `param_shapes` order and moved to `device`."""
    return _leaf_map(lambda shape, fan_in: core.dense_init(
        gen, shape, dtype, fan_in=fan_in, device=device), param_shapes(name))


def _same_pad(size: int, k: int, stride: int) -> tuple:
    """XLA's SAME padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """NCHW x, HWIO w, SAME padding."""
    k = w.shape[0]
    (t, b_), (l_, r) = (_same_pad(x.shape[i], k, stride) for i in (2, 3))
    return F.conv2d(F.pad(x, (l_, r, t, b_)), w.permute(3, 2, 0, 1),
                    stride=stride)


def _conv1d(x, w, stride=1):
    """NCW x, WIO w, SAME padding."""
    lo, hi = _same_pad(x.shape[2], w.shape[0], stride)
    return F.conv1d(F.pad(x, (lo, hi)), w.permute(2, 1, 0), stride=stride)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def hand_tracker(params, crops):
    """crops: (B, 2 hands, 128, 128, 1) -> keypoints (B, 2, 21, 3)."""
    B = crops.shape[0]
    x = _nchw(crops.reshape(B * 2, 128, 128, 1))
    for w in params["convs"]:
        x = F.relu(_conv(x, w, stride=2))
    x = x.mean(dim=(2, 3))
    x = F.relu(x @ params["fc"])
    return (x @ params["out"]).reshape(B, 2, 21, 3)


def eye_tracker(params, eyes):
    """eyes: (B, 2, 96, 96, 1) -> gaze vector + pupil (B, 2, 4)."""
    B = eyes.shape[0]
    x = _nchw(eyes.reshape(B * 2, 96, 96, 1))
    for w in params["convs"]:
        x = F.relu(_conv(x, w, stride=2))
    return (x.mean(dim=(2, 3)) @ params["out"]).reshape(B, 2, 4)


def vio_imu_net(params, imu_window):
    """TLIO-style: (B, 200, 6) IMU -> displacement + covariance (B, 6)."""
    first, *rest = params["convs"]
    x = F.relu(_conv1d(imu_window.transpose(1, 2), first, stride=2))
    for w in rest:
        # the reference's rule: stride 2 where the width changes
        x = F.relu(_conv1d(x, w, stride=2 if w.shape[2] != x.shape[1]
                           else 1))
    return x.mean(dim=2) @ params["out"]


def vio_frontend(params, frame):
    """Visual feature frontend per greyscale frame (B, 240, 320, 1) ->
    corner heatmap (B, 30, 40, 1) and descriptors (B, 30, 40, 32)."""
    x = _nchw(frame)
    for w in params["convs"]:
        x = F.relu(_conv(x, w, stride=2))
    heat = _conv(x, params["heat"])
    desc = _conv(x, params["desc"])
    return heat.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)


def vad(params, mel):
    """(B, 100, 40) 1 s of mel frames -> speech probability (B, 1)."""
    x = mel.transpose(1, 2)
    for w in params["convs"]:
        x = F.relu(_conv1d(x, w, stride=2))
    return torch.sigmoid(x.mean(dim=2) @ params["out"])


def asr_conformer(params, mel):
    """Streaming Conformer-lite: (B, 100, 80) 1 s mel -> CTC logits
    (B, 25, 1024).  Conv subsample x4, then 12 blocks of half-FFN,
    self-attention and a convolution module (a full 9-tap convolution
    over all 256 channels, as the reference computes it)."""
    x = mel.transpose(1, 2)
    for w in params["subsample"]:
        x = F.relu(_conv1d(x, w, stride=2))
    x = x.transpose(1, 2)                               # (B, 25, 256)
    B, T, d = x.shape
    dh = d // HEADS_ASR
    for blk in params["blocks"]:
        h = F.silu(x @ blk["ff_in"])
        x = x + 0.5 * (h @ blk["ff_out"])
        q, k, v = ((x @ blk[n]).reshape(B, T, HEADS_ASR, dh)
                   for n in ("wq", "wk", "wv"))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / (d / HEADS_ASR) ** 0.5
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        x = x + o.reshape(B, T, d)
        x = x + F.silu(_conv1d(x.transpose(1, 2), blk["conv"])
                       .transpose(1, 2))
    return x @ params["out"]


NET_FNS = {"hand_tracker": hand_tracker, "eye_tracker": eye_tracker,
           "vio_imu_net": vio_imu_net, "vio_frontend": vio_frontend,
           "vad": vad, "asr_conformer": asr_conformer}


@functools.lru_cache(maxsize=1)
def torch_flops() -> dict[str, float]:
    """The port's FLOPs per invocation of each net at the frozen table's
    shapes: `FlopCounterMode` over one call on meta tensors, which counts
    the convolutions' and matrix products' multiply-adds (2 flops each)
    and nothing elementwise.  Keyed as `measured_flops()`."""
    from torch.utils.flop_counter import FlopCounterMode
    meta = torch.device("meta")
    out = {}
    for key, (name, shape) in FLOPS_INPUTS.items():
        params = _leaf_map(lambda s, _: torch.empty(s, device=meta),
                           param_shapes(name))
        counter = FlopCounterMode(display=False)
        with counter:
            NET_FNS[name](params, torch.empty(shape, device=meta))
        out[key] = float(counter.get_total_flops())
    return out
