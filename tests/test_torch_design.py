"""Port parity: the design core (`core/design.py`: `Knob` /
`DesignSpace`, the discrete relaxations and their straight-through
gradients, the standard spaces, projected Adam) of `repro_torch`
against the JAX reference `repro`, on the same inputs, on the CPU.

Relaxations and their gradients are held at rtol 1e-6, one Adam step
at rtol 1e-6.  The port's sampler draws from a `torch.Generator` (the
reference's threefry keys cannot be reproduced), so it is tested by its
bounds, shape and determinism."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aria2 as j_aria2
from repro.core import daysim as j_daysim
from repro.core import design as j_design
from repro_torch.core import aria2 as t_aria2
from repro_torch.core import daysim as t_daysim
from repro_torch.core import design as t_design

CPU = "cpu"
RTOL = 1e-6


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _spaces():
    return {
        "device": (j_design.device_space(j_aria2.aria2_platform()),
                   t_design.device_space(t_aria2.aria2_platform())),
        "policy": (j_design.policy_space(), t_design.policy_space()),
    }


@pytest.mark.parametrize("name", ["device", "policy"])
def test_standard_spaces_equal_reference(name):
    j_sp, t_sp = _spaces()[name]
    assert t_sp.to_dict() == j_sp.to_dict()
    assert t_sp.names() == j_sp.names()
    assert t_design.DesignSpace.from_dict(t_sp.to_dict()) == t_sp
    mid_j, mid_t = j_sp.midpoint(), t_sp.midpoint(CPU)
    for k in j_sp.names():
        np.testing.assert_array_equal(_np(mid_t[k]), np.asarray(mid_j[k]))


def test_space_api_and_errors_match_reference():
    t_sp = t_design.device_space(t_aria2.aria2_platform())
    j_sp = j_design.device_space(j_aria2.aria2_platform())
    assert t_sp.knob("placement_logits").tag == t_design.DISCRETE
    assert vars(t_sp.knob("log2_compression")) \
        == vars(j_sp.knob("log2_compression"))
    assert t_sp.subset(["brightness", "upload_duty"]).to_dict() \
        == j_sp.subset(["brightness", "upload_duty"]).to_dict()
    with pytest.raises(KeyError, match="unknown knob"):
        t_sp.knob("nope")
    with pytest.raises(ValueError, match="lo < hi"):
        t_design.Knob("bad", 2.0, 1.0)
    with pytest.raises(ValueError, match="tag must be"):
        t_design.Knob("bad", 0.0, 1.0, "fuzzy")
    with pytest.raises(ValueError, match="duplicate"):
        t_design.DesignSpace((t_design.Knob("x", 0, 1),
                              t_design.Knob("x", 0, 1)))
    pt = t_sp.midpoint(CPU)
    assert t_sp.validate(pt) is pt
    with pytest.raises(ValueError, match="keys mismatch"):
        t_sp.validate({"x": 1.0})
    bad = dict(pt, placement_logits=torch.zeros(3))
    with pytest.raises(ValueError, match="trailing shape"):
        t_sp.validate(bad)


def test_clip_matches_reference():
    j_sp, t_sp = _spaces()["device"]
    rng = np.random.RandomState(0)
    wild = {k.name: rng.uniform(-50.0, 50.0, (5,) + k.shape)
            .astype(np.float32) for k in j_sp.knobs}
    got = t_sp.clip({k: torch.as_tensor(v) for k, v in wild.items()})
    want = j_sp.clip({k: jnp.asarray(v) for k, v in wild.items()})
    for k in j_sp.names():
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


def test_uniform_sample_bounds_shape_determinism():
    t_sp = t_design.device_space(t_aria2.aria2_platform())
    a = t_sp.uniform_sample(3, 64, CPU)
    b = t_sp.uniform_sample(3, 64, CPU)
    c = t_sp.uniform_sample(4, 64, CPU)
    for k in t_sp.knobs:
        x = _np(a[k.name])
        assert x.shape == (64,) + k.shape and x.dtype == np.float32
        assert x.min() >= k.lo and x.max() <= k.hi
        # spread over the box, not one corner
        assert x.max() - x.min() > 0.5 * (k.hi - k.lo)
        np.testing.assert_array_equal(x, _np(b[k.name]))
        assert not np.array_equal(x, _np(c[k.name]))
    gen = torch.Generator().manual_seed(3)
    d = t_sp.uniform_sample(gen, 64, CPU)
    for k in t_sp.names():
        np.testing.assert_array_equal(_np(d[k]), _np(a[k]))


def test_policy_point_equals_reference():
    for name in ("battery_saver", "thermal_governor"):
        want = j_design.policy_point(j_daysim.get_policy(name))
        got = t_design.policy_point(t_daysim.get_policy(name), CPU)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


def _relax_inputs():
    rng = np.random.RandomState(1)
    return {
        "placement_logits": rng.uniform(-4, 4, (6, 4)).astype(np.float32),
        "log2_compression": rng.uniform(0, 7, 6).astype(np.float32),
        "log2_fps_scale": rng.uniform(0, 5, 6).astype(np.float32),
        "upload_duty": rng.uniform(0.1, 1, 6).astype(np.float32),
        "brightness": rng.uniform(0, 1, 6).astype(np.float32),
        "mcs_logits": rng.uniform(-3, 3, (6, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("tau", [1.0, 0.3])
def test_device_vec_and_relaxations_match_reference(tau):
    x = _relax_inputs()
    want = j_design.device_vec({k: jnp.asarray(v) for k, v in x.items()},
                               tau)
    got = t_design.device_vec({k: torch.as_tensor(v) for k, v in x.items()},
                              tau)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)

    # gradients of a weighted sum of every relaxed leaf
    wts = {k: np.random.RandomState(2).normal(size=np.shape(v))
           .astype(np.float32) for k, v in want.items()}

    def j_obj(p):
        v = j_design.device_vec(p, tau)
        return sum(jnp.sum(v[k] * wts[k]) for k in v)

    gj = jax.grad(j_obj)({k: jnp.asarray(v) for k, v in x.items()})
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
    v = t_design.device_vec(pt, tau)
    obj = sum(torch.sum(v[k] * torch.as_tensor(wts[k])) for k in v)
    gt = torch.autograd.grad(obj, list(pt.values()))
    for k, g in zip(pt, gt):
        np.testing.assert_allclose(_np(g), np.asarray(gj[k]), rtol=RTOL,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("op", ["ste_gt", "ste_lt"])
@pytest.mark.parametrize("beta", [2.0, 60.0, 0.0])
def test_ste_forward_exact_and_gradients_match_reference(op, beta):
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, 32).astype(np.float32)
    th = rng.uniform(-1, 1, 32).astype(np.float32)
    x[:4] = th[:4]                      # ties: the hard forward is 0
    jf, tf = getattr(j_design, op), getattr(t_design, op)
    wj = jf(jnp.asarray(x), jnp.asarray(th), beta)
    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(th, requires_grad=True)
    wt = tf(xt, tt, beta)
    hard = (x > th) if op == "ste_gt" else (x < th)
    np.testing.assert_array_equal(_np(wt), hard.astype(np.float32))
    np.testing.assert_array_equal(_np(wt), np.asarray(wj))
    # the beta=None path: the hard comparison alone, nothing for autograd
    plain = tf(torch.as_tensor(x), torch.as_tensor(th))
    np.testing.assert_array_equal(_np(plain), hard.astype(np.float32))
    assert not plain.requires_grad
    w = np.linspace(-1, 1, 32).astype(np.float32)
    gj = jax.grad(lambda a, b: jnp.sum(jf(a, b, beta) * w), (0, 1))(
        jnp.asarray(x), jnp.asarray(th))
    gt = torch.autograd.grad(torch.sum(wt * torch.as_tensor(w)), (xt, tt))
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL,
                                   atol=1e-7)


def test_take_linear_and_soft_indicator_match_reference():
    """One float level per table row, as the reference maps
    `take_linear` over combos."""
    rng = np.random.RandomState(4)
    tab = rng.uniform(0, 100, (5, 4)).astype(np.float32)
    idx = np.asarray([0.0, 1.0, 2.5, 3.0, 0.25], np.float32)
    j_take = jax.vmap(j_design.take_linear)
    gj = jax.grad(lambda t, i: jnp.sum(j_take(t, i)), (0, 1))(
        jnp.asarray(tab), jnp.asarray(idx))
    tt = torch.tensor(tab, requires_grad=True)
    it = torch.tensor(idx, requires_grad=True)
    got = t_design.take_linear(tt, it)
    np.testing.assert_allclose(
        _np(got), np.asarray(j_take(jnp.asarray(tab), jnp.asarray(idx))),
        rtol=RTOL)
    for a, b in zip(torch.autograd.grad(got.sum(), (tt, it)), gj):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL)
    # a 0-dim level broadcasts over the rows (the differentiable day's
    # four level tables at one step)
    one = t_design.take_linear(tt, torch.tensor(2.5))
    np.testing.assert_allclose(
        _np(one), np.asarray(jax.vmap(j_design.take_linear, (0, None))(
            jnp.asarray(tab), jnp.asarray(2.5))), rtol=RTOL)
    s = rng.uniform(0, 0.1, 16).astype(np.float32)
    np.testing.assert_allclose(
        _np(t_design.soft_indicator(torch.as_tensor(s), 0.03, 80.0)),
        np.asarray(j_design.soft_indicator(jnp.asarray(s), 0.03, 80.0)),
        rtol=RTOL)


def test_take_linear_and_ste_forward_exact():
    """The port of tests/test_design_grad.py's check of the same name."""
    tab = torch.tensor([10.0, 20.0, 50.0])
    for i in range(3):
        assert float(t_design.take_linear(tab, torch.tensor(float(i)))) \
            == float(tab[i])
    assert float(t_design.take_linear(tab, torch.tensor(0.5))) == 15.0
    # STE forward is the exact hard comparison...
    assert float(t_design.ste_gt(torch.tensor(1.0), 0.5, 4.0)) == 1.0
    assert float(t_design.ste_gt(torch.tensor(0.2), 0.5, 4.0)) == 0.0
    # ...with a live surrogate gradient on both operands
    t = torch.tensor(0.5, requires_grad=True)
    (g,) = torch.autograd.grad(
        t_design.ste_gt(torch.tensor(0.6), t, 4.0), (t,))
    assert float(g) < 0.0


def test_adam_update_matches_reference():
    rng = np.random.RandomState(5)
    pt = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=3).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in pt.items()} for _ in range(3)]
    jp = {k: jnp.asarray(v) for k, v in pt.items()}
    js = j_design.adam_init(jp)
    tp = {k: torch.as_tensor(v) for k, v in pt.items()}
    ts = t_design.adam_init(tp)
    for g in grads:
        jp, js = j_design.adam_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, js, 0.05)
        tp, ts = t_design.adam_update(
            tp, {k: torch.as_tensor(v) for k, v in g.items()}, ts, 0.05)
        for k in pt:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                       rtol=RTOL, atol=1e-7)
            np.testing.assert_allclose(_np(ts["v"][k]),
                                       np.asarray(js["v"][k]), rtol=RTOL)
    assert ts["t"] == int(js["t"]) == 3
