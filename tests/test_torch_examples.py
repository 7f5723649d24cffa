"""The port's examples (`examples/torch_*.py`) against the reference's
(`examples/*.py`) on the CPU.

Each port example's `main(["--device", "cpu", <cuts>])` returns its
printed figures by name.  Where the reference script runs in a few
seconds and has no size to cut, the script itself runs (`runpy`, stdout
captured) and its globals give the figures; the two stdouts must print
the same lines with the numbers masked.  Otherwise the test calls the
reference functions that the script calls, at the same cut.  Discrete
figures must be equal; continuous ones use the reference's tolerances:
1e-6 relative for scenario totals (`tests/test_platform_api.py`), the
day reports' tolerances of `torch_day_reports`, 1e-6 for fleet curves
and dollars (`tests/test_fleet.py`), 1e-3 for the calibration ensemble
(the reference's vmapped-vs-sequential tolerance).

Where the reference draws with threefry (populations, optimizer and
calibration starts, LM weights), its draws are fed to the port, since
the port's seeded generators cannot reproduce them.
"""
import dataclasses
import importlib.util
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_fleet import assert_matches_jax
from torch_day_reports import assert_reports_match

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
CPU = ["--device", "cpu"]
NUMBER = re.compile(r"[-+]?\$?\d[\d,]*(\.\d+)?(e[-+]?\d+)?%?")


def port_example(name: str):
    """The module `examples/torch_<name>.py`."""
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(name: str, capsys, argv=()) -> tuple:
    """Run `examples/<name>.py` as a script; returns (its globals, its
    stdout)."""
    capsys.readouterr()
    old = sys.argv
    sys.argv = [str(EXAMPLES / f"{name}.py"), *argv]
    try:
        g = runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = old
    return g, capsys.readouterr().out


def run_port(name: str, capsys, argv=(), **kw) -> tuple:
    """The port example's `main` on the CPU; returns (its figures, its
    stdout)."""
    capsys.readouterr()
    out = port_example(name).main([*CPU, *argv], **kw)
    return out, capsys.readouterr().out


def masked(text: str) -> list:
    """The lines of `text` with every number replaced by '#'."""
    return [NUMBER.sub("#", line) for line in text.splitlines()]


def close(got, want, rtol=1e-6, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def test_every_example_has_a_port_with_a_device_flag():
    """Ten reference examples, ten ports; each imports neither jax nor the
    reference package and takes --device."""
    refs = sorted(p.stem for p in EXAMPLES.glob("*.py")
                  if not p.stem.startswith("torch_"))
    assert len(refs) == 10
    for name in refs:
        src = (EXAMPLES / f"torch_{name}.py").read_text()
        assert "--device" in src and "def main(argv=None" in src, name
        imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src,
                             re.MULTILINE)
        assert not [m for m in imports
                    if m.split(".")[0] in ("jax", "repro")], (name, imports)


def test_quickstart(capsys):
    g, ref_out = run_reference("quickstart", capsys)
    out, port_out = run_port("quickstart", capsys)
    assert masked(port_out) == masked(ref_out)
    close(out["full_offload_mw"], g["p0"])
    close(out["full_on_device_mw"], g["p1"])
    close(out["top2_share"], g["top2"])
    assert list(out["delta_pct"]) == list(g["PRIMITIVES"])
    for (c, mw, mbps), r in zip(out["sweep"], g["sweep"]):
        assert c == r["compression"]
        close((mw, mbps), (r["total_mw"], r["offload_mbps"]))
    want = [(r["theta"], r["elasticity"])
            for r in g["dse"].sensitivity()[:4]]
    assert [t for t, _ in out["sensitivity"]] == [t for t, _ in want]
    close([e for _, e in out["sensitivity"]], [e for _, e in want],
          rtol=1e-5)


def test_end_to_end_system(capsys):
    g, ref_out = run_reference("end_to_end_system", capsys)
    out, port_out = run_port("end_to_end_system", capsys)
    assert masked(port_out) == masked(ref_out)
    offload = g["offload"]
    for sc in (g["FULL_OFFLOAD"], g["FULL_ON_DEVICE"]):
        s = offload.offload_summary(sc)
        got = out["scenarios"][s["scenario"]]
        close((got["device_mw"], got["uplink_mbps"]),
              (s["device_mw"], s["uplink_mbps"]))
        fleet = offload.size_fleet(sc, n_users=1e6, duty=0.35)
        assert [p[:2] for p in got["pods"]] == \
            [(r["stream"], r["arch"]) for r in fleet]
        close([p[2] or 0.0 for p in got["pods"]],
              [r.get("pods") or 0.0 for r in fleet])
    want = offload.fleet_grid(g["sset"], n_users=1e6, duty=0.35)
    assert [r[0] for r in out["grid"]] == [r["scenario"] for r in want]
    close([r[1:] for r in out["grid"]],
          [(r["device_mw"], r["uplink_mbps"], r["backend_pods"])
           for r in want])


def test_joint_codesign(capsys):
    g, ref_out = run_reference("joint_codesign", capsys)
    out, port_out = run_port("joint_codesign", capsys)
    assert masked(port_out) == masked(ref_out)
    rep = g["rep"]
    assert out["n_points"] == len(rep)
    np.testing.assert_array_equal(out["front_mask"], rep.front_mask)
    close(out["device_mw"], rep.device_mw)
    close(out["backend_pods"], rep.backend_pods)
    assert out["device_optimum"] == g["opt"]["index"]
    close(out["pod_budgets"], g["budgets"])
    dse = g["dse"]
    assert out["under_pod_budget"] == [
        (lambda r: None if r is None else r["index"])(
            dse.co_optimize(rep, pod_budget=float(b))[
                "min_power_under_pod_budget"]) for b in g["budgets"]]


def test_wearable_dse(capsys):
    g, ref_out = run_reference("wearable_dse", capsys)
    out, port_out = run_port("wearable_dse", capsys)
    assert masked(port_out) == masked(ref_out)
    assert out["n_points"] == len(g["pts"])
    assert [f[:2] for f in out["front"]] == \
        [(p["on_device"], p["compression"]) for p in g["front"]]
    close([f[2:] for f in out["front"]],
          [(p["total_mw"], p["offload_mbps"]) for p in g["front"]])
    close(out["grid_total_mw"], g["totals"])
    assert out["grid_best"] == g["best"]
    for row, want in zip(out["scaling"],
                         g["scaling"].project(g["aria2"].build_system(
                             g["aria2"].FULL_ON_DEVICE))):
        assert row[0] == want["node"]
        close(row[1], want["total_mw"])


def test_what_if(capsys):
    from repro.core import daysim as j_daysim
    from repro.serving.twin import DesignTwin as JTwin
    out, _ = run_port("what_if", capsys)
    twin = JTwin(dt_s=60.0)
    assert_reports_match(out["base"], twin.query())
    gov = j_daysim.get_policy("thermal_governor")
    for trip, got in out["governor"].items():
        pol = dataclasses.replace(gov, name=f"gov@{trip:.0f}",
                                  temp_trip_c=trip, temp_clear_c=trip - 2.5)
        assert_reports_match(got, twin.what_if(policy=pol))
    cell = j_daysim.BATTERIES["default"]
    for frac in (0.8, 1.0, 1.2):
        twin.submit(policy=gov, battery=dataclasses.replace(
            cell, name=f"pack_x{frac:.1f}",
            capacity_mwh=cell.capacity_mwh * frac))
    want = {wi.overrides["battery"].name: wi.report for wi in twin.run()}
    assert list(out["battery"]) == list(want)
    for name, got in out["battery"].items():
        assert_reports_match(got, want[name])
    st = twin.stats
    assert (out["stats"]["queries"], out["stats"]["batches"]) == \
        (st.queries, st.batches)
    # the port has no compile cache: its traces and executable hits read 0
    assert (out["stats"]["traces"], out["stats"]["exec_hits"]) == (0, 0)


def test_all_day(capsys):
    from repro.core import daysim as j_daysim
    from repro.core import dse as j_dse
    out, _ = run_port("all_day", capsys)
    rep = j_dse.day_pareto()
    assert_reports_match(out["report"], rep)
    assert out["steady_winner"] == int(np.argmin(rep.steady_mw))
    assert out["survivors"] == int(rep.survives().sum())
    for k in ("day_winner", "field_none_best", "field_best"):
        i = out[k]
        assert rep.combos[i] == out["report"].combos[i]
    tr = j_daysim.simulate("rayban_cam", j_daysim.DEFAULT_DESIGNS[0],
                           "desk_day", "battery_saver")
    for k, v in tr.summary.items():
        if isinstance(v, (bool, np.bool_, int, np.integer, str)):
            assert out["simulate"][k] == v, k
        else:
            close(out["simulate"][k], v, rtol=1e-6, atol=1e-4, what=k)
    close(out["need_mwh"], j_daysim.battery_for("rayban_cam").capacity_mwh
          * tr.summary["day_hours"] / tr.summary["time_to_empty_h"],
          rtol=1e-5)


# the gradient example cut for the CPU: 2 restarts x 2 Adam steps at
# dt_s 120, the ensemble 3 restarts x 20 steps
GRAD_CUT = ["--restarts", "2", "--steps", "2", "--dt-s", "120",
            "--ensemble-restarts", "3", "--ensemble-steps", "20"]


def test_gradient_codesign(capsys, monkeypatch):
    from repro.core import calibrate as j_cal
    from repro.core import daysim as j_daysim
    from repro.core import design as j_design
    from repro.core import dse as j_dse
    from repro_torch.core import calibrate, dse
    starts = j_design.policy_space().uniform_sample(jax.random.key(0), 2)
    real_opt = dse.optimize_policy
    monkeypatch.setattr(dse, "optimize_policy", lambda *a, **kw: real_opt(
        *a, starts={k: np.asarray(v) for k, v in starts.items()}, **kw))
    z0s = j_cal.restart_starts(3)
    monkeypatch.setattr(calibrate, "restart_starts",
                        lambda n, seed=0, spread=1.2, device="cuda":
                        torch.as_tensor(np.array(z0s), device=device))
    out, _ = run_port("gradient_codesign", capsys, GRAD_CUT)

    sm = j_dse.sensitivity_map("aria2")
    close(out["sensitivity_map"]["total_mw"], sm["total_mw"])
    got_rows = out["sensitivity_rows"]
    want_rows = j_dse.sensitivity_rows(sm, top=3)
    assert [r["scenario"] for r in got_rows] == \
        [r["scenario"] for r in want_rows]
    for a, b in zip(got_rows, want_rows):
        close(list(a["d_mw_d_placement"].values()),
              list(b["d_mw_d_placement"].values()), rtol=1e-5, atol=1e-3)

    want = j_dse.optimize_policy("aria2_display",
                                 j_daysim.DEFAULT_DESIGNS[0], "field_day",
                                 "battery_saver", n_restarts=2, steps=2,
                                 dt_s=120.0)
    got = out["optimize_policy"]
    assert got["tte_h"] == want["tte_h"]
    assert got["baseline"] == want["baseline"]
    for k, v in want["point"].items():
        assert got["point"][k] == pytest.approx(v, rel=1e-4, abs=1e-5), k
    assert got["gain_h"] == pytest.approx(want["gain_h"], abs=1e-9)

    ens = j_cal.fit_ensemble(n_restarts=3, steps=20)
    close(out["ensemble"]["losses"], ens["losses"], rtol=1e-3)
    assert int(np.argmin(out["ensemble"]["losses"])) == \
        int(np.argmin(ens["losses"]))
    for k, p in ens["posterior"].items():
        close(out["ensemble"]["posterior"][k]["best"], p["best"], rtol=1e-3,
              what=k)


# the fleet example cut for the CPU
FLEET_USERS, FLEET_MC_USERS, FLEET_DRAWS, FLEET_DT = 1024, 256, 2, 120.0


def test_fleet_capacity(capsys, monkeypatch):
    """The reference's populations (and Monte Carlo draws) fed to the
    port's sampler; the curves, plans, survival and costs against the
    reference's calls on them."""
    from repro.core import fleet as j_fleet
    from repro.core import montecarlo as j_mc
    from repro.core.autoscale import AutoscalerSpec as JSpec
    from repro_torch.core import fleet, montecarlo
    jkeys = dict(zip((int(s) for s in montecarlo.draw_keys(0, FLEET_DRAWS)),
                     j_mc.draw_keys(0, FLEET_DRAWS)))

    def sample(spec, n, key):
        jspec = j_fleet.PopulationSpec.from_dict(spec.to_dict())
        jpop = j_fleet.sample_population(jspec, n, jkeys.get(int(key),
                                                             int(key)))
        return fleet.Population(spec, *(np.asarray(getattr(jpop, f))
                                        for f in ("archetype", "tz_hours",
                                                  "ambient_offset_c",
                                                  "fade")))

    monkeypatch.setattr(fleet, "sample_population", sample)
    out, _ = run_port("fleet_capacity", capsys, [
        "--users", str(FLEET_USERS), "--mc-users", str(FLEET_MC_USERS),
        "--draws", str(FLEET_DRAWS), "--dt-s", str(FLEET_DT)])

    kw = dict(dt_s=FLEET_DT, fleet_size=1e6)
    jpop = j_fleet.sample_population(j_fleet.DEFAULT_POPULATION,
                                     FLEET_USERS, key=0)
    rep = j_fleet.fleet_day(jpop, **kw)
    assert_matches_jax(out["report"], rep)
    plan, want_plan = out["plan"], rep.capacity_plan()
    for k in ("peak_pods", "trough_pods", "savings_usd"):
        close(plan[k], want_plan[k], what=k)
    single = dataclasses.replace(j_fleet.DEFAULT_POPULATION,
                                 name="single_tz", tz_hours=(0.0,),
                                 tz_weights=None)
    rep1 = j_fleet.fleet_day(single, FLEET_USERS, key=0, **kw)
    got1 = out["single_tz"]
    np.testing.assert_array_equal(got1.survives(), rep1.survives())
    # one timezone stacks every user into the same bins: a bin sums ~1000
    # float32 demands, which two summation orders put ~sqrt(N) ulp apart
    # (3.4e-6 read at 1024 users)
    for k in ("curve", "stream_curve"):
        close(getattr(got1, k), getattr(rep1, k), rtol=1e-5, what=k)
    for a, b in zip(out["by_archetype"], rep.by_archetype()):
        assert (a["archetype"], a["users"], a["shutdowns"]) == \
            (b["archetype"], b["users"], b["shutdowns"])
        close((a["survival_rate"], a["tte_p5_h"], a["tte_p50_h"],
               a["mean_fade"]), (b["survival_rate"], b["tte_p5_h"],
                                 b["tte_p50_h"], b["mean_fade"]))
    dist = j_mc.fleet_distribution(
        j_fleet.DEFAULT_POPULATION, FLEET_MC_USERS, n_draws=FLEET_DRAWS,
        key=0, autoscaler=JSpec(), **kw)
    got_dist = out["distribution"]
    assert np.array_equal(got_dist.survival_draws, dist.survival_draws)
    assert np.array_equal(got_dist.tte_draws, dist.tte_draws)
    assert out["survival"] == dist.survival_rate()
    # curves and dollars of 256-user draws: sums in another order, as above
    for k in ("curve_draws", "usd_draws", "dynamic_usd_draws",
              "dropped_stream_h_draws"):
        close(getattr(got_dist, k), getattr(dist, k), rtol=1e-5, what=k)
    got_sub, ref_sub = out["parity"]
    np.testing.assert_array_equal(got_sub.survives(), ref_sub.survives())


@pytest.fixture(scope="module")
def reference_lm_weights():
    """The reference examples' weights (`model.init(PRNGKey(0), cfg)` of
    each smoke config), as numpy trees."""
    from repro.models import registry as j_registry

    def weights(arch):
        cfg, model = j_registry.get(arch, smoke=True)
        return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0),
                                                   cfg))
    return weights


def _port_params(tree, arch):
    from repro_torch import convert
    from repro_torch.models import registry
    cfg, _ = registry.get(arch, smoke=True)
    return convert.lm_params_from_numpy(tree, cfg, "cpu")


def test_serve_backend(capsys, reference_lm_weights):
    """granite-3-2b's smoke config (Dh 8) on the reference's weights: every
    request's tokens and the server's counts equal."""
    g, ref_out = run_reference("serve_backend", capsys)
    out, port_out = run_port("serve_backend", capsys, params=_port_params(
        reference_lm_weights("granite-3-2b"), "granite-3-2b"))
    assert masked(port_out) == masked(ref_out)
    assert out["tokens"] == {r.rid: [int(t) for t in r.out_tokens]
                             for r in g["done"]}
    srv = g["srv"]
    assert (out["prefills"], out["decode_steps"], out["tokens_out"]) == \
        (srv.stats.prefills, srv.stats.decode_steps, srv.stats.tokens_out)


TRAIN_STEPS = 3         # the LM example's 200 steps, cut for the CPU


def test_train_backend_lm(capsys, reference_lm_weights):
    """olmo-1b's smoke config (Dh 16) from the reference's weights, int8
    gradients and checkpoints: the losses of the first steps."""
    g, _ = run_reference("train_backend_lm", capsys,
                         ["--steps", str(TRAIN_STEPS)])
    out, _ = run_port("train_backend_lm", capsys,
                      ["--steps", str(TRAIN_STEPS)],
                      params=_port_params(reference_lm_weights("olmo-1b"),
                                          "olmo-1b"))
    assert len(out["losses"]) == TRAIN_STEPS
    close(out["losses"], g["losses"], rtol=1e-4)
