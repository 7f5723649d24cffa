"""Fixture sources for the port's lint (`repro_torch.analysis`): for each
rule one module it must flag (`bad`) and one it must leave alone
(`good`), written as files by `write`.  R004 (unit suffixes) is
framework-free: its pair is the reference's own fixtures, read from
tests/fixtures/analysis/."""
from pathlib import Path

REF_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "analysis"

SOURCES = {
    ("R001", "bad"): '''\
"""R001 fixture: per-call rebuild hazards the analyzer must flag."""
import ctypes
import functools
import subprocess

import torch
from torch import nn


class Head(nn.Module):
    def forward(self, x, mask):
        lib = ctypes.CDLL("libhead.so")      # library load per call
        if (x > 0).any():                    # branch on a tensor's value
            x = x + 1.0
        while mask.sum() > 0:                # loop on a tensor's value
            mask = mask[1:]
        outs = []
        for w in self.ws:
            g = torch.func.grad(self.loss)(w)    # transform rebuilt per step
            outs.append(g)
        return x, lib, outs


def build_each(names):
    for n in names:
        subprocess.run(["nvcc", "-o", n + ".so", n + ".cu"])  # build per item


@functools.lru_cache(maxsize=4)
def kernel(name, flags=[]):                  # unhashable cached default
    return ctypes.CDLL(name)
''',
    ("R001", "good"): '''\
"""R001 fixture: build-once idioms that must NOT fire."""
import ctypes
import functools

import torch
from torch import nn


@functools.lru_cache(maxsize=1)
def _lib():
    # cached builder: the library loads once per process
    return ctypes.CDLL("libhead.so")


class Head(nn.Module):
    def forward(self, x, n_steps: int, window=None):
        lib = _lib()
        if window is not None and n_steps > 2:    # host values only
            x = torch.where(x > 0, x + 1.0, x)   # the select stays on device
        if x.shape[0] > 1 and x.dtype == torch.float32:   # metadata
            x = x * 2.0
        vg = torch.func.vmap(torch.func.grad(lambda w: (w * w).sum()))
        for _ in range(n_steps):
            x = vg(x)                            # built once, before the loop
        return x, lib


@functools.lru_cache(maxsize=4)
def kernel(name, flags=()):                  # hashable default
    return ctypes.CDLL(name)
''',
    ("R002", "bad"): '''\
"""R002 fixture: host syncs inside hot functions."""
import numpy as np
import torch
from torch import nn

STATS = {"calls": 0}


class Net(nn.Module):
    def forward(self, x, buf):
        y = np.asarray(x)                    # copy to the host
        v = x.sum().item()                   # device sync
        s = float(x.max())                   # scalarizes a tensor
        c = x.cpu()                          # copy to the host
        print(x)                             # host I/O of a tensor
        torch.cuda.synchronize()             # explicit sync
        w = torch.tensor([1.0, 2.0], device=x.device)   # host data pushed
        nz = torch.nonzero(x)                # size read back from the device
        buf[0] = 0.0                         # host scalar copied in
        STATS["calls"] += 1                  # module state per call
        return y, v, s, c, w, nz
''',
    ("R002", "good"): '''\
"""R002 fixture: host work in the right places — must NOT fire."""
import functools

import numpy as np
import torch
from torch import nn

TABLE = [1.0, 2.0, 4.0]


@functools.lru_cache(maxsize=4)
def table(n: int, device: str):
    # cached builder body runs once per key: its push is setup, not per call
    return torch.as_tensor(np.asarray(TABLE[:n], np.float32), device=device)


class Net(nn.Module):
    def forward(self, x, n: int = 2):
        consts = table(n, str(x.device))     # built once per key
        scale = float(len(TABLE))            # a host constant
        k = int(x.shape[0])                  # metadata, not data
        return x * consts[0] * scale + k


def cold_report(x):
    # never reachable from a hot root — host sync is its job
    return float(np.asarray(x.cpu()).sum())
''',
    ("R003", "bad"): '''\
"""R003 fixture: RNG discipline violations."""
import numpy as np
import torch


def legacy_noise(n):
    return np.random.rand(n)                 # global numpy RNG state


def global_seed(n):
    torch.manual_seed(0)                     # global RNG state
    return torch.randn(n)                    # no generator=


def cuda_draws(n):
    gen = torch.Generator(device="cuda")     # a device generator
    return torch.rand(n, generator=gen, device="cuda")


def init_(w):
    return w.normal_(0.0, 0.02)              # in-place draw, global generator


def same_seed_every_step(xs):
    out = []
    for x in xs:
        g = torch.Generator().manual_seed(1)     # constant seed in a loop
        out.append(x + torch.randn(2, generator=g))
    return out


def reseeded(n):
    g = torch.Generator()
    g.manual_seed(7)
    a = torch.rand(n, generator=g)
    g.manual_seed(7)                         # same seed again: `a` repeats
    return a + torch.rand(n, generator=g)
''',
    ("R003", "good"): '''\
"""R003 fixture: explicit CPU generators — must NOT fire."""
import numpy as np
import torch


def host_generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def draws(seed, n, device="cpu"):
    gen = host_generator(seed)
    u = torch.rand(n, generator=gen)
    z = torch.randn(n, generator=gen)
    return (u + z).to(device)


def per_step(seed, xs):
    gen = torch.Generator().manual_seed(seed)    # seeded once, outside
    return [x + torch.randn(2, generator=gen) for x in xs]


def typed_rng(rng: np.random.Generator) -> np.random.Generator:
    # type annotations naming numpy RNG classes are not RNG calls
    return rng


def init_(w, gen):
    return w.normal_(0.0, 0.02, generator=gen)
''',
    ("R005", "bad"): '''\
"""R005 fixture: cache-key hygiene violations."""
import functools

import torch

_PIPELINES = {}


def remember(t, shape):
    _PIPELINES[[1, 2]] = t                       # list literal key
    hit = _PIPELINES.get(torch.as_tensor(shape))     # tensor-valued key
    key = (id(t), t.data_ptr())
    _PIPELINES[key] = t      # identity and address outlive the tensor
    _PIPELINES[t.numpy().tobytes()] = t          # raw bytes as key
    return hit


@functools.lru_cache(maxsize=4)
def cached_sum(xs: torch.Tensor):                # tensor parameter
    return xs.sum()
''',
    ("R005", "good"): '''\
"""R005 fixture: hygienic cache keys — must NOT fire."""
import functools

_ASSEMBLIES = {}


def remember(t, shape, dtype):
    key = ("rows", tuple(shape), str(dtype))
    _ASSEMBLIES[key] = t
    return _ASSEMBLIES.get(key)


@functools.lru_cache(maxsize=4)
def cached_sig(sig: tuple):
    return len(sig)
''',
    ("R006", "bad"): '''\
"""R006 fixture: per-step allocation and float64 drift in hot functions."""
import torch
from torch import nn


class Scan(nn.Module):
    def forward(self, xs):
        carry = xs[:1]
        trace = []
        for x in xs:
            carry = torch.cat([carry, x[None]])      # growing alloc per step
            trace.append(x * 2.0)                    # a tensor per step
        return carry, torch.stack(trace)


def upcast(x):
    y = x.double()                               # float64 in a hot body
    return y.to(torch.float64)


batched_upcast = torch.func.vmap(upcast)
''',
    ("R006", "good"): '''\
"""R006 fixture: pre-sized buffers, float32 — must NOT fire."""
import torch
from torch import nn


class Scan(nn.Module):
    def forward(self, xs):
        out = torch.empty_like(xs)
        carry = torch.zeros_like(xs[0])
        for i in range(xs.shape[0]):
            carry = carry + xs[i]
            out[i] = carry                           # a pre-sized buffer
        return out.to(torch.float32)
''',
}


def source(rule: str, kind: str) -> str:
    """The fixture source of `rule`'s `kind` ("bad" or "good")."""
    if rule == "R004":
        return (REF_FIXTURES / f"r004_{kind}.py").read_text()
    return SOURCES[(rule, kind)]


def write(directory: Path, rule: str, kind: str) -> Path:
    """Write the fixture to `directory/<rule>_<kind>.py`; returns its path."""
    path = Path(directory) / f"{rule.lower()}_{kind}.py"
    path.write_text(source(rule, kind))
    return path
