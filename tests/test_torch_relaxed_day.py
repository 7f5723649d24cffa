"""Port parity: the differentiable day (`daysim.relaxed_day_fn`) and the
optimizers on it (`dse.gradient_descend`, `dse.optimize_policy`) of
`repro_torch` against the JAX reference `repro`, on the same inputs, on
the CPU, at the reference tests' own small sizes (dt_s 120, a few Adam
steps).

Tolerances: the day's discrete outputs (`tte_h`, `throttled_frac`)
exactly, traces at rtol 1e-6 / atol 1e-4 (tests/test_kernels.py),
scalar objectives at rtol 1e-6, gradients at rtol 1e-4; Adam
trajectories from the reference's own sampled starts at rtol 1e-4.  The
port's sampler cannot reproduce the reference's threefry draws, so the
reference's starts are fed to the port (`starts=`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import daysim as j_daysim
from repro.core import design as j_design
from repro.core import dse as j_dse
from repro.core import scenarios as j_scen
from repro_torch.core import daysim as t_daysim
from repro_torch.core import design as t_design
from repro_torch.core import dse as t_dse
from repro_torch.core import scenarios as t_scen

CPU = "cpu"
DT = 120.0
EXACT = ("tte_h", "throttled_frac")
SCALARS = ("soft_tte_h", "peak_skin_c", "pod_hours", "end_soc",
           "end_soc_puck")
# (schedule, policy, the point's knobs): the STE trip path and the design
# knobs' path through the relaxed engine's tables
CASES = {
    "policy": ("field_day", "battery_saver", None),
    "design": ("commuter", "thermal_governor",
               {"log2_fps_scale": 1.2, "log2_compression": 3.7,
                "upload_duty": 0.6,
                "placement_logits": [-2.0, 1.0, 0.5, -6.0]}),
}


def _np(x):
    return x.detach().cpu().numpy()


def _points(case):
    schedule, policy, knobs = CASES[case]
    if knobs is None:
        jp = j_design.policy_point(j_daysim.get_policy(policy))
        tp = t_design.policy_point(t_daysim.get_policy(policy), CPU)
    else:
        jp = {k: jnp.asarray(v, jnp.float32) for k, v in knobs.items()}
        tp = {k: torch.tensor(v, dtype=torch.float32)
              for k, v in knobs.items()}
    return schedule, policy, jp, tp


@pytest.mark.parametrize("case", list(CASES))
def test_relaxed_day_matches_reference(case):
    schedule, policy, jp, tp = _points(case)
    args = ("aria2_display", schedule, policy, t_daysim.DEFAULT_DESIGNS[0])
    jf = j_daysim.relaxed_day_fn(*args, dt_s=DT)
    tf = t_daysim.relaxed_day_fn(*args, dt_s=DT, device=CPU)
    want = jf(jp)
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    got = tf(tp)
    assert set(got) == set(want)
    for k in EXACT:
        assert float(got[k]) == float(want[k]), k
    for k in SCALARS:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-6, err_msg=k)
    for k in ("t_skin", "soc"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-4, err_msg=k)
    gj = jax.grad(lambda p: jf(p)["soft_tte_h"])(jp)
    gt = torch.autograd.grad(got["soft_tte_h"], list(tp.values()))
    for k, g in zip(tp, gt):
        np.testing.assert_allclose(_np(g), np.asarray(gj[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    if case == "policy":
        # tests/test_design_grad.py: raising soc_trip (throttling
        # earlier) raises the smooth time-to-empty on this day
        assert float(gt[list(tp).index("soc_trip")]) > 0.0


def test_relaxed_day_forward_is_the_hard_integrator():
    """At the design's saturated logits (sigmoid(-6) = 0.25 % off the
    binary placement) the time-to-empty is simulate's; at an exactly
    binary placement every trace is simulate's, bit for bit, on the CPU
    (the relaxed rows compose brightness x its throttle multiplier in
    float32, as the reference does: one ulp off the hard row on four of
    this day's rows, which the CPU's totals absorb; the card's may not,
    tests/test_torch_kernels_cuda.py); and the eager integrator on
    simulate's own tables is simulate's full trace."""
    args = ("aria2_display", t_daysim.DEFAULT_DESIGNS[0], "field_day",
            "battery_saver")
    tr = t_daysim.simulate(*args, dt_s=DT, device=CPU)
    f = t_daysim.relaxed_day_fn(args[0], args[2], args[3], args[1],
                                dt_s=DT, device=CPU)
    pt = t_design.policy_point(t_daysim.get_policy("battery_saver"), CPU)
    out = f(pt)
    assert float(out["tte_h"]) == pytest.approx(
        tr.summary["time_to_empty_h"], abs=1e-6)
    assert float(out["throttled_frac"]) == pytest.approx(
        float(np.mean(tr.level > 0)), abs=1e-7)
    binary = f({**pt, "placement_logits": torch.full((4,), -200.0)})
    np.testing.assert_array_equal(_np(binary["t_skin"]), tr.t_skin_c)
    np.testing.assert_array_equal(_np(binary["soc"]), tr.soc)
    assert float(binary["peak_skin_c"]) == np.float32(
        tr.summary["peak_skin_c"])
    tb = t_daysim.compiled_tables(*args, dt_s=DT, device=CPU)
    one = {k: torch.as_tensor(np.asarray(v)) for k, v in tb.items()
           if k not in ("const", "step_pods_stream")}
    one["const"] = {k: torch.as_tensor(v) for k, v in tb["const"].items()}
    eager = t_daysim._integrate_one(one)
    ref = t_daysim.scan_integrate(tb, device=CPU)
    for k, v in ref.items():
        np.testing.assert_array_equal(_np(eager[k]), v, err_msg=k)
    # no step dead (a docked day that charges): tte is the whole day
    docked = t_daysim.relaxed_day_fn("aria2_display", "commuter_dock",
                                     "none", t_daysim.DEFAULT_DESIGNS[0],
                                     dt_s=DT, device=CPU)({})
    assert float(docked["tte_h"]) == pytest.approx(
        t_daysim.get_schedule("commuter_dock").n_steps(DT) * DT / 3600.0)


def test_gradient_descend_converges_and_respects_init():
    """The port of tests/test_design_grad.py's check of the same name."""
    sp = t_design.DesignSpace((t_design.Knob("x", -2.0, 2.0),
                               t_design.Knob("y", -1.0, 3.0)))

    def loss(p):
        return (p["x"] - 0.7) ** 2 + (p["y"] - 1.3) ** 2

    res = t_dse.gradient_descend(sp, loss, n_restarts=4, steps=120,
                                 lr=0.1, seed=1, device=CPU)
    assert res.best_loss < 1e-4
    assert float(res.best_point["x"]) == pytest.approx(0.7, abs=0.01)
    # bounds bind when the optimum is outside the box
    res2 = t_dse.gradient_descend(
        sp, lambda p: (p["x"] - 5.0) ** 2, n_restarts=2, steps=80,
        lr=0.2, device=CPU)
    assert float(res2.best_point["x"]) == pytest.approx(2.0, abs=1e-3)
    # init seeds restart 0 (already optimal -> stays optimal)
    res3 = t_dse.gradient_descend(
        sp, loss, n_restarts=2, steps=1, lr=1e-6,
        init={"x": torch.tensor(0.7), "y": torch.tensor(1.3)}, device=CPU)
    assert res3.best_loss < 1e-9
    assert len(res3.restart_points()) == 2


def test_gradient_descend_follows_reference_trajectory():
    """Device-knob descent on the relaxed engine's total (mW / 1000),
    from the reference's own sampled starts: the best-seen points and
    losses of every restart at rtol 1e-4."""
    j_plat, t_plat = j_dse._plat("aria2_display"), \
        t_dse._plat("aria2_display")
    j_sp = j_design.device_space(j_plat)
    t_sp = t_design.device_space(t_plat)
    starts = j_sp.uniform_sample(jax.random.key(3), 4)

    def j_loss(p):
        v = {k: x[None] for k, x in j_design.device_vec(p).items()}
        return j_scen.total_mw_relaxed(j_plat, v)[0] / 1000.0

    def t_loss(p):
        v = {k: x[None] for k, x in t_design.device_vec(p).items()}
        return t_scen.total_mw_relaxed(t_plat, v)[0] / 1000.0

    want = j_dse.gradient_descend(j_sp, j_loss, n_restarts=4, steps=12,
                                  lr=0.1, seed=3)
    got = t_dse.gradient_descend(
        t_sp, t_loss, steps=12, lr=0.1,
        starts={k: np.asarray(v) for k, v in starts.items()}, device=CPU)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    for k in t_sp.names():
        np.testing.assert_allclose(got.points[k], want.points[k],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert got.best_loss == pytest.approx(want.best_loss, rel=1e-4)


def test_optimize_policy_matches_reference():
    """The example's call at the reference tests' size (dt_s 120, 3
    restarts, 3 Adam steps) from the reference's starts: the hardened
    winner, its hard time-to-empty and peak, the baseline and the cap."""
    sp = j_design.policy_space()
    starts = sp.uniform_sample(jax.random.key(0), 3)
    args = ("aria2_display", j_daysim.DEFAULT_DESIGNS[0], "field_day",
            "battery_saver")
    want = j_dse.optimize_policy(*args, n_restarts=3, steps=3, dt_s=DT)
    got = t_dse.optimize_policy(
        *args, n_restarts=3, steps=3, dt_s=DT,
        starts={k: np.asarray(v) for k, v in starts.items()}, device=CPU)
    assert set(got) == set(want)
    for k, v in want["point"].items():
        assert got["point"][k] == pytest.approx(v, rel=1e-4, abs=1e-5), k
    assert got["tte_h"] == want["tte_h"]
    assert got["baseline"] == want["baseline"]
    assert got["peak_cap_c"] == want["peak_cap_c"]
    assert got["peak_skin_c"] == pytest.approx(want["peak_skin_c"],
                                               rel=1e-6)
    assert (got["feasible"], got["restarts"], got["steps"]) \
        == (want["feasible"], want["restarts"], want["steps"])
    assert got["gain_h"] == pytest.approx(want["gain_h"], abs=1e-9)
    with pytest.raises(TypeError, match="unknown day kwargs"):
        t_dse.optimize_policy(*args, steps=1, device=CPU, bogus=1.0)
    with pytest.raises(ValueError, match="needs throttle actions"):
        t_dse.optimize_policy(*args[:3], "none", steps=1, device=CPU)
