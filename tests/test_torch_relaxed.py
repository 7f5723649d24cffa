"""Port parity: the relaxed engines (`scenarios.evaluate_relaxed`,
`offload.pods_relaxed`, `dse.sensitivity_map`) of `repro_torch`
against the JAX reference `repro`, on the same inputs, on the CPU, and
float64 central differences through the relaxed engine and the
differentiable day (mirroring tests/_fd_x64_check.py, in-process: the
port's float width is the inputs' dtype).

Tolerances: relaxed outputs against JAX at rtol 1e-6, the sensitivity
map at rtol 1e-5 (the reference's own for a vjp row against a per-point
grad), autograd against central differences at 1e-4 relative (the
reference's TOL).  At binary placements and one-hot MCS weights the
relaxed engine equals the port's `evaluate` bit for bit
(tests/test_design_grad.py's contract)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dse as j_dse
from repro.core import offload as j_offload
from repro.core import scenarios as j_scen
from repro_torch.core import aria2 as t_aria2
from repro_torch.core import daysim as t_daysim
from repro_torch.core import dse as t_dse
from repro_torch.core import offload as t_offload
from repro_torch.core import scenarios as t_scen

CPU = "cpu"
PLATFORMS = ["aria2", "aria2_display", "rayban_cam"]
FD_TOL = 1e-4


def _np(x):
    return x.detach().cpu().numpy()


def _soft_vec(n: int, seed: int, n_prim: int = 4) -> dict:
    rng = np.random.RandomState(seed)
    return {
        "placement": rng.uniform(0.05, 0.95, (n, n_prim)),
        "compression": rng.uniform(1.0, 64.0, n),
        "fps_scale": rng.uniform(0.7, 16.0, n),
        "upload_duty": rng.uniform(0.1, 1.0, n),
        "brightness": rng.uniform(0.0, 1.0, n),
        "mcs_weights": rng.dirichlet(np.ones(3), n),
    }


def _grid(plat):
    return t_scen.ScenarioSet.grid(
        placements=t_scen.all_placements(plat.supported_primitives()),
        compressions=(2.0, 16.0), fps_scales=(1.0, 4.0),
        mcs_tiers=(0, 1, 2), upload_duties=(0.4,), brightnesses=(0.5,),
        primitives=plat.primitives)


@pytest.mark.parametrize("platform", PLATFORMS)
def test_relaxed_engine_matches_reference(platform):
    """Soft placements and mixed MCS weights (fps below 1 included, so
    the fps floor's tie and both of its sides are crossed): outputs and
    the gradient of every knob leaf at rtol 1e-6."""
    j_plat, t_plat = j_dse._plat(platform), t_dse._plat(platform)
    x = {k: v.astype(np.float32) for k, v in _soft_vec(12, 0).items()}
    x["fps_scale"][:2] = 1.0
    want = j_scen.evaluate_relaxed(j_plat,
                                   {k: jnp.asarray(v) for k, v in x.items()})
    vec = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
    got = t_scen.evaluate_relaxed(t_plat, vec)
    for k in ("loads", "total", "pd_loss", "mbps"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    w = np.linspace(0.5, 1.5, 12).astype(np.float32)
    gj = jax.grad(lambda v: jnp.sum(
        j_scen.total_mw_relaxed(j_plat, v) * w))(
            {k: jnp.asarray(v) for k, v in x.items()})
    gt = torch.autograd.grad(torch.sum(got["total"] * torch.as_tensor(w)),
                             list(vec.values()), allow_unused=True,
                             materialize_grads=True)
    for k, g in zip(vec, gt):
        np.testing.assert_allclose(_np(g), np.asarray(gj[k]), rtol=1e-6,
                                   atol=1e-3, err_msg=k)


@pytest.mark.parametrize("platform", PLATFORMS)
def test_relaxed_engine_equals_hard_engine_bitwise(platform):
    plat = t_dse._plat(platform)
    sset = _grid(plat)
    rep = t_scen.evaluate(plat, sset, device=CPU)
    out = t_scen.evaluate_relaxed(plat, t_scen.relax_vec(sset, CPU))
    assert torch.equal(rep.total_mw, out["total"])
    assert torch.equal(rep.offloaded_mbps, out["mbps"])
    assert torch.equal(rep.loads_mw, out["loads"])
    assert torch.equal(rep.pd_loss_mw, out["pd_loss"])
    # and the same rows through the reference's relax_vec
    jv = j_scen.relax_vec(j_scen.ScenarioSet.grid(
        placements=j_scen.all_placements(
            j_dse._plat(platform).supported_primitives()),
        compressions=(2.0, 16.0), fps_scales=(1.0, 4.0),
        mcs_tiers=(0, 1, 2), upload_duties=(0.4,), brightnesses=(0.5,),
        primitives=plat.primitives))
    for k, v in t_scen.relax_vec(sset, CPU).items():
        np.testing.assert_array_equal(_np(v), np.asarray(jv[k]))


def test_relaxed_vec_validation():
    plat = t_aria2.aria2_platform()
    vec = t_scen.relax_vec(t_scen.ScenarioSet.grid(
        placements=((),), compressions=(8.0,), fps_scales=(1.0,)), CPU)
    bad = dict(vec)
    bad.pop("mcs_weights")
    with pytest.raises(ValueError, match="missing knobs"):
        t_scen.evaluate_relaxed(plat, bad)
    bad = dict(vec)
    bad["placement"] = bad["placement"][:, :2]
    with pytest.raises(ValueError, match="placement last dim"):
        t_scen.evaluate_relaxed(plat, bad)
    bad = dict(vec)
    bad["mcs_weights"] = bad["mcs_weights"][:, :2]
    with pytest.raises(ValueError, match="mcs_weights last dim"):
        t_scen.evaluate_relaxed(plat, bad)


@pytest.mark.parametrize("n_users,duty", [(1e6, 0.35), (2.5e5, 1.0)])
def test_pods_relaxed_matches_reference(n_users, duty):
    x = {k: v.astype(np.float32) for k, v in _soft_vec(10, 1).items()}
    x["fps_scale"][:2] = 1.0
    want = j_offload.pods_relaxed({k: jnp.asarray(v) for k, v in x.items()},
                                  n_users=n_users, duty=duty)
    vec = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
    got = t_offload.pods_relaxed(vec, n_users=n_users, duty=duty)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    gj = jax.grad(lambda v: jnp.sum(j_offload.pods_relaxed(
        v, n_users=n_users, duty=duty)))(
            {k: jnp.asarray(v) for k, v in x.items()})
    gt = torch.autograd.grad(got.sum(), [vec["placement"],
                                         vec["fps_scale"],
                                         vec["upload_duty"]])
    for k, g in zip(("placement", "fps_scale", "upload_duty"), gt):
        np.testing.assert_allclose(_np(g), np.asarray(gj[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="duty"):
        t_offload.pods_relaxed(vec, duty=1.5)


@pytest.mark.parametrize("platform", ["aria2", "aria2_display"])
def test_sensitivity_map_matches_reference(platform):
    """The full 768-point (aria2) grid in one reverse pass, against the
    reference's vjp."""
    want = j_dse.sensitivity_map(platform)
    got = t_dse.sensitivity_map(platform, device=CPU)
    assert len(got["sset"]) == len(want["sset"])
    np.testing.assert_array_equal(got["sset"].row_matrix(),
                                  want["sset"].row_matrix())
    np.testing.assert_allclose(got["total_mw"], want["total_mw"],
                               rtol=1e-6)
    assert set(got["d_mw_d"]) == set(want["d_mw_d"])
    for k, g in want["d_mw_d"].items():
        np.testing.assert_allclose(got["d_mw_d"][k], g, rtol=1e-5,
                                   atol=1e-3, err_msg=k)
    assert t_dse.sensitivity_rows(got, top=3) \
        == j_dse.sensitivity_rows(want, top=3)


# ---------------------------------------------------------------------------
# float64 central differences (tests/_fd_x64_check.py, in-process)
# ---------------------------------------------------------------------------

def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-12)


def test_engine_gradients_match_finite_differences_f64():
    plat = t_aria2.aria2_platform()
    n = 6
    vec = {k: torch.as_tensor(v) for k, v in _soft_vec(6, 0).items()}
    assert vec["compression"].dtype == torch.float64

    def total(v, th=None):
        return float(torch.sum(t_scen.total_mw_relaxed(plat, v, th)))

    leaves = {k: v.clone().requires_grad_() for k, v in vec.items()}
    grads = dict(zip(leaves, torch.autograd.grad(
        torch.sum(t_scen.total_mw_relaxed(plat, leaves)),
        list(leaves.values()), allow_unused=True, materialize_grads=True)))
    for knob in ("compression", "fps_scale", "upload_duty", "brightness"):
        for i in (0, n - 1):
            eps = 1e-5 * max(1.0, float(vec[knob][i]))
            e = torch.zeros(n, dtype=torch.float64)
            e[i] = eps
            fd = (total({**vec, knob: vec[knob] + e})
                  - total({**vec, knob: vec[knob] - e})) / (2 * eps)
            g = float(grads[knob][i])
            assert _rel(g, fd) < FD_TOL, (knob, i, g, fd)
    # placement probabilities (the multilinear duty interpolation path)
    for i, j in ((0, 0), (2, 3)):
        eps = 1e-6
        e = torch.zeros((n, 4), dtype=torch.float64)
        e[i, j] = eps
        fd = (total({**vec, "placement": vec["placement"] + e})
              - total({**vec, "placement": vec["placement"] - e})) \
            / (2 * eps)
        g = float(grads["placement"][i, j])
        assert _rel(g, fd) < FD_TOL, ("placement", i, j, g, fd)
    # a theta coefficient through the same relaxed engine
    k = "wifi_mw_per_mbps"
    v0 = float(t_aria2.THETA0[k])
    x = torch.tensor(v0, dtype=torch.float64, requires_grad=True)
    (gt,) = torch.autograd.grad(
        torch.sum(t_scen.total_mw_relaxed(plat, vec, {k: x})), (x,))
    h = 1e-4 * v0
    fd = (total(vec, {k: torch.tensor(v0 + h, dtype=torch.float64)})
          - total(vec, {k: torch.tensor(v0 - h, dtype=torch.float64)})) \
        / (2 * h)
    assert _rel(float(gt), fd) < FD_TOL, (k, float(gt), fd)


def _day_fd(policy, schedule, ste_beta_c, ste_beta_soc, knobs,
            expect_throttle):
    f = t_daysim.relaxed_day_fn(
        "aria2_display", schedule, policy, t_daysim.DEFAULT_DESIGNS[0],
        dt_s=240.0, ste_beta_c=ste_beta_c, ste_beta_soc=ste_beta_soc,
        device=CPU, dtype=torch.float64)

    def obj(pt):
        return float(f(pt)["soft_tte_h"])

    pt0 = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
           for k, v in knobs.items()}
    out = f(pt0)
    if expect_throttle:
        assert float(out["throttled_frac"]) > 0.0, \
            "day must exercise the throttle path"
    grads = torch.autograd.grad(out["soft_tte_h"], list(pt0.values()))
    for (k, v0), g in zip(knobs.items(), grads):
        eps = 3e-6 * max(1.0, abs(v0))
        plus = {kk: torch.tensor(v0 + eps if kk == k else vv,
                                 dtype=torch.float64)
                for kk, vv in knobs.items()}
        minus = {kk: torch.tensor(v0 - eps if kk == k else vv,
                                  dtype=torch.float64)
                 for kk, vv in knobs.items()}
        fd = (obj(plus) - obj(minus)) / (2 * eps)
        assert _rel(float(g), fd) < FD_TOL, (k, float(g), fd)


def test_day_gradients_match_finite_differences_smooth_f64():
    _day_fd("none", "commuter", t_daysim.STE_BETA_C, t_daysim.STE_BETA_SOC,
            {"log2_fps_scale": 1.2, "log2_compression": 3.7,
             "upload_duty": 0.6}, expect_throttle=False)


def test_day_gradients_match_finite_differences_throttled_f64():
    """field_day + battery_saver: throttle levels engage; with the STE
    sharpness at 0 the surrogate term vanishes and the gradient must
    equal the exact fixed-level-sequence derivative."""
    _day_fd("battery_saver", "field_day", 0.0, 0.0,
            {"log2_fps_scale": 0.8, "log2_compression": 4.2},
            expect_throttle=True)
