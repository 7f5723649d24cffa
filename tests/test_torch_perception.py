"""Port parity of the perception nets: each of the six nets of
`repro_torch.perception.nets` against the reference's
(`repro.perception.nets`) on the reference's own weights, drawn here with
its key splits and `repro.nn.core.dense_init`, in float32 at rtol 1e-5 /
atol 1e-5 of the output's largest magnitude (at least 1e-5); odd
spatial sizes, where XLA's SAME padding puts the odd row
on the high side; and `torch_flops()` against the products worked out
from the shapes and against the frozen XLA counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import core as j_core
from repro.perception import nets as j_nets
from repro_torch.perception import nets

RTOL = ATOL = 1e-5              # ATOL relative to the largest |output|
# the Conformer's 12 residual blocks grow its logits to ~500 (one float32
# ulp there is 3e-5) and its float32 sums drift: the reference lies 2.3e-5
# of its largest logit from the port's float64 run, the port's float32
# 1.1e-5 (1 x 100 x 80); both are held at 3e-5 of it
ATOL_ASR = 3e-5


def _w(ks, i, shape, fan_in=None):
    """The reference's weight `dense_init(ks[i], shape, float32, fan_in)`
    as a CPU tensor."""
    return torch.from_numpy(np.array(j_core.dense_init(
        ks[i], shape, jnp.float32, fan_in=fan_in)))


def _conv_ws(ks, widths, k=3, first=0, dims=2):
    """The reference's `_conv` / `_conv1d` kernels of a stack of widths,
    keys ks[first], ks[first + 1], ..."""
    out = []
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        shape = (k, k, a, b) if dims == 2 else (k, a, b)
        out.append(_w(ks, first + i, shape, fan_in=k ** dims * a))
    return out


def ref_params(name: str, key) -> dict:
    """Net `name`'s weights as the reference draws them from `key`, in
    the port's tree."""
    if name == "hand_tracker":
        ks = jax.random.split(key, 8)
        return {"convs": _conv_ws(ks, (1, 16, 32, 64, 96, 128)),
                "fc": _w(ks, 5, (128, 128)), "out": _w(ks, 6, (128, 63))}
    if name == "eye_tracker":
        ks = jax.random.split(key, 6)
        return {"convs": _conv_ws(ks, (1, 12, 24, 48, 64)),
                "out": _w(ks, 4, (64, 4))}
    if name == "vio_imu_net":
        ks = jax.random.split(key, 8)
        return {"convs": [_w(ks, 0, (7, 6, 32), fan_in=42)]
                + _conv_ws(ks, (32, 64, 64, 128, 128), first=1, dims=1),
                "out": _w(ks, 6, (128, 6))}
    if name == "vio_frontend":
        ks = jax.random.split(key, 5)
        return {"convs": _conv_ws(ks, (1, 8, 16, 32)),
                "heat": _w(ks, 3, (3, 3, 32, 1), fan_in=288),
                "desc": _w(ks, 4, (3, 3, 32, 32), fan_in=288)}
    if name == "vad":
        ks = jax.random.split(key, 3)
        return {"convs": _conv_ws(ks, (40, 32, 32), dims=1),
                "out": _w(ks, 2, (32, 1))}
    assert name == "asr_conformer"
    ks = jax.random.split(key, 64)
    d = 256
    blocks = []
    for blk in range(12):
        ki = 2 + 5 * blk        # the reference's ki (its conv key is the
        blocks.append({         # next block's ff_in key)
            "ff_in": _w(ks, ki, (d, 4 * d)),
            "ff_out": _w(ks, ki + 1, (4 * d, d), fan_in=4 * d),
            "wq": _w(ks, ki + 2, (d, d)), "wk": _w(ks, ki + 3, (d, d)),
            "wv": _w(ks, ki + 4, (d, d)),
            "conv": _w(ks, ki + 5, (9, d, d), fan_in=9 * d)})
    return {"subsample": _conv_ws(ks, (80, d, d), dims=1), "blocks": blocks,
            "out": _w(ks, 63, (d, 1024))}


# (net, input shape): the frozen table's shapes at batch 2, and odd sizes
CASES = [("hand_tracker", (2, 2, 128, 128, 1)),
         ("eye_tracker", (2, 2, 96, 96, 1)),
         ("vio_imu_net", (2, 200, 6)),
         ("vio_imu_net", (1, 199, 6)),
         ("vio_frontend", (1, 240, 320, 1)),
         ("vio_frontend", (2, 61, 83, 1)),
         ("vad", (2, 100, 40)),
         ("vad", (1, 101, 40)),
         ("asr_conformer", (1, 100, 80)),
         ("asr_conformer", (2, 37, 80))]


def _leaves(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in _leaves(v)]
    if isinstance(t, list):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _double(t):
    if isinstance(t, dict):
        return {k: _double(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_double(v) for v in t]
    return t.double()


def _shapes(name):
    out = []
    nets._leaf_map(lambda shape, _: out.append(shape),
                   nets.param_shapes(name))
    return out


@pytest.mark.parametrize("name,shape", CASES)
def test_net_matches_reference(name, shape):
    key = jax.random.PRNGKey(len(shape) + shape[1])
    x = np.random.default_rng(shape[1]).standard_normal(shape) \
        .astype(np.float32)
    params = ref_params(name, key)
    assert [tuple(p.shape) for p in _leaves(params)] == _shapes(name)
    want = getattr(j_nets, name)(key, jnp.asarray(x))
    got = nets.NET_FNS[name](params, torch.from_numpy(x))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    atol = ATOL_ASR if name == "asr_conformer" else ATOL
    exact = nets.NET_FNS[name](_double(params), torch.from_numpy(x).double())
    exact = exact if isinstance(exact, tuple) else (exact,)
    for g, w, e in zip(got, want, exact, strict=True):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = atol * max(1.0, np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=scale,
                                   err_msg=name)
        # the port's function in float64 against the reference's float32
        np.testing.assert_allclose(e.numpy(), w, rtol=RTOL, atol=scale,
                                   err_msg=f"{name} in float64")


@pytest.mark.parametrize("size,stride,want", [
    (240, 2, (0, 1)), (61, 2, (1, 1)), (83, 2, (1, 1)), (128, 2, (0, 1)),
    (7, 1, (1, 1)), (200, 2, (2, 3))])
def test_same_padding_is_xlas(size, stride, want):
    """SAME: the output ceil(size / stride), the odd pad row on the high
    side (kernel 3; 7 for the IMU net's first layer at 200)."""
    k = 7 if size == 200 else 3
    assert nets._same_pad(size, k, stride) == want


def test_init_draws_the_shapes_from_a_seed():
    for name in nets.NETS:
        a = nets.init(name, torch.Generator().manual_seed(0), "cpu")
        b = nets.init(name, torch.Generator().manual_seed(0), "cpu")
        assert [tuple(t.shape) for t in _leaves(a)] == _shapes(name)
        assert all(torch.equal(u, v) for u, v in zip(_leaves(a),
                                                     _leaves(b)))

    class CardGenerator:            # what an init reads: its device
        device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="CPU torch.Generator"):
        nets.init("vad", CardGenerator(), "cpu")


def _conv_products(n, out_len, k, cin, cout, dims):
    return 2.0 * n * out_len * k ** dims * cin * cout


def test_torch_flops_are_the_products_of_the_shapes():
    """conv + matmul multiply-adds (2 flops each) of one call at the
    frozen table's shapes; XLA's counts, which add the elementwise work
    and the reference's in-call weight draws, are at least as large."""
    def conv_stack(n, size, widths, k=3, dims=2):
        total = 0.0
        for a, b in zip(widths, widths[1:]):
            size = -(-size // 2)
            total += _conv_products(n, size ** dims, k, a, b, dims)
        return total, size

    hand, _ = conv_stack(2, 128, (1, 16, 32, 64, 96, 128))
    hand += 2 * 2 * (128 * 128 + 128 * 63)
    eye, _ = conv_stack(2, 96, (1, 12, 24, 48, 64))
    eye += 2 * 2 * 64 * 4
    imu = _conv_products(1, 100, 7, 6, 32, 1)
    length = 100
    for a, b in ((32, 64), (64, 64), (64, 128), (128, 128)):
        length = -(-length // 2) if a != b else length
        imu += _conv_products(1, length, 3, a, b, 1)
    imu += 2 * 128 * 6
    front = 0.0
    h, w = 240, 320
    for a, b in ((1, 8), (8, 16), (16, 32)):
        h, w = -(-h // 2), -(-w // 2)
        front += _conv_products(1, h * w, 3, a, b, 2)
    front += _conv_products(1, h * w, 3, 32, 33, 2)      # heat + desc
    vad = _conv_products(1, 50, 3, 40, 32, 1) \
        + _conv_products(1, 25, 3, 32, 32, 1) + 2 * 32
    d, T = 256, 25
    block = 2 * T * (2 * d * 4 * d + 3 * d * d) + 2 * 2 * T * T * d \
        + _conv_products(1, T, 9, d, d, 1)
    asr = _conv_products(1, 50, 3, 80, d, 1) \
        + _conv_products(1, 25, 3, d, d, 1) + 12 * block + 2 * T * d * 1024
    want = {"hand_tracker": hand, "eye_tracker": eye, "vio_imu": imu,
            "vio_frontend": front, "vad": vad, "asr_1s": asr}
    got = nets.torch_flops()
    assert got == want
    xla = nets.measured_flops()
    assert set(got) == set(xla)
    assert all(got[k] <= xla[k] for k in got)
