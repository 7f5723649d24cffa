"""Port parity of the launch tools on one card (`repro_torch.launch`:
mesh, specs, sweep, dryrun, perf) against the reference's
(`repro.launch`).  The specs' shapes and dtypes equal the reference's
ShapeDtypeStructs (and its shardings' per-device shapes on a 1 x 1 mesh);
the analytical roofline equals the reference's on every cell once the
reference's mesh tables are set to one device and its constants to the
port's Hopper values; `roofline_grid`'s sources, the sweep's resume and
a measured cell on the CPU at a smoke config."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch import mesh as j_mesh, specs as j_specs, sweep as j_sweep
from repro.models import registry as j_reg
from repro.nn.sharding import AxisEnv
from repro_torch.configs import base as t_base
from repro_torch.launch import (dryrun, mesh as t_mesh, perf, specs as t_specs,
                                sweep as t_sweep)
from repro_torch.models import registry as t_reg

ARCHS = t_reg.arch_names()


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _flat(node, path=""):
    """{path: leaf} of a nested dict / tuple tree."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: node}


def _same(port, ref, shard=None):
    """Port meta tensors and reference ShapeDtypeStructs (or, with
    `shard`, the reference shardings' per-device shapes) leaf for leaf."""
    p, r = _flat(port), _flat(ref)
    assert set(p) == set(r)
    for k in p:
        want = r[k].shape if shard is None else \
            _flat(shard)[k].shard_shape(r[k].shape)
        assert tuple(p[k].shape) == tuple(want), k
        assert p[k].device.type == "meta", k
        assert _name(p[k].dtype) == str(np.dtype(r[k].dtype)), k


@pytest.fixture(scope="module")
def env():
    return AxisEnv(j_mesh.make_host_mesh())


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, env):
    tcfg, tmodel = t_reg.get(arch)
    jcfg, jmodel = j_reg.get(arch)
    _same(t_specs.param_struct(tcfg, tmodel),
          j_specs.param_struct(jcfg, jmodel))
    for name, tshape in t_base.SHAPES.items():
        jshape = j_base.SHAPES[name]
        if not j_base.shape_applicable(jcfg, jshape)[0]:
            continue
        got = t_specs.input_specs(tcfg, tshape, tmodel)
        want = j_specs.input_specs(jcfg, jshape, jmodel)
        _same(got, want)
        if tshape.kind == "decode":
            _same(t_specs.cache_specs(tcfg, tshape, got["cache"]),
                  want["cache"],
                  j_specs.cache_specs(jcfg, jshape, env, want["cache"]))
            tok = t_specs.token_spec(tshape)
            assert tuple(tok.shape) == j_specs.token_spec(jshape, env) \
                .shard_shape(want["token"].shape)
            assert _name(tok.dtype) == str(np.dtype(want["token"].dtype))
        else:
            _same(t_specs.batch_specs(tcfg, tshape), want,
                  j_specs.batch_specs(jcfg, jshape, env))


def test_mesh_is_one_device_with_the_reference_axes():
    for multi in (False, True):
        m = t_mesh.make_production_mesh(multi_pod=multi, device="cpu")
        assert m.axis_names == (("pod", "data", "model") if multi
                                else ("data", "model"))
        assert int(np.prod(m.shape)) == 1 and m.device.type == "cpu"
    h = t_mesh.make_host_mesh(device="cpu")
    assert (h.shape, h.axis_names) == ((1, 1), ("data", "model"))


# the reference's tables at one device, with the port's Hopper constants
ONE_CARD = {"PEAK_FLOPS": t_sweep.PEAK_FLOPS, "HBM_BW": t_sweep.HBM_BW,
            "N_MODEL": 1, "N_DATA": 1, "MESH_DEVICES": {"single": 1},
            "MESH_PODS": {"single": 1}}


@pytest.mark.parametrize("arch", ARCHS)
def test_analytical_terms_match_reference_with_its_constants(arch,
                                                             monkeypatch):
    """The port's one-card formulas are the reference's at one device:
    with its mesh tables set to one card (and the port's constants), the
    reference gives the port's compute, memory and (zero) collective
    terms and the same dominant term on every cell of `arch`."""
    for k, v in ONE_CARD.items():
        monkeypatch.setattr(j_sweep, k, v)
    t_tab = t_sweep.CellTable.build([arch])
    j_tab = j_sweep.CellTable.build([arch], meshes=("single",))
    assert t_tab.keys == tuple(k[:2] for k in j_tab.keys)
    assert len(t_tab) == len(t_base.SHAPES)
    for c in t_tab.cols:
        np.testing.assert_array_equal(t_tab.cols[c], j_tab.cols[c], c)
    got, want = (t_sweep.analytical_terms(t_tab),
                 j_sweep.analytical_terms(j_tab))
    for k in ("compute_s", "memory_s", "collective_s", "bound_s"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    assert (got["dominant"] == want["dominant"]).all()
    assert (got["applicable"] == want["applicable"]).all()
    one = t_sweep.analytical_cell(arch, "train_4k")
    assert one["compute_s"] == want["compute_s"][t_tab.keys.index(
        (arch, "train_4k"))]


def test_one_card_has_no_collective_term():
    terms = t_sweep.analytical_terms(t_sweep.CellTable.build())
    app = terms["applicable"]
    assert len(terms["compute_s"]) == 40 and app.sum() == 33
    assert (terms["collective_s"][app] == 0).all()
    assert (terms["dominant"][app] != "collective_s").all()
    # the Hopper constants chip_smoke.py's bounds use
    assert (t_sweep.PEAK_FLOPS, t_sweep.HBM_BW) == (989e12, 3.35e12)
    assert t_sweep.RESULTS.parts[-2:] == ("results", "torch_cells")


def _write(d, arch, shape, rec):
    t_sweep.cell_path(d, arch, shape).write_text(json.dumps(rec))


def test_roofline_grid_sources(tmp_path):
    table = t_sweep.CellTable.build(["olmo-1b", "mamba2-2.7b"])
    terms = {"compute_s": 2.0, "memory_s": 3.0, "collective_s": 0.0}
    _write(tmp_path, "olmo-1b", "train_4k",
           {"ok": True, "terms": terms, "batch": 8, "step_s": 6.0,
            "achieved_fraction": 0.5,
            "reduced": ["global_batch 256 -> 8: ..."]})
    _write(tmp_path, "olmo-1b", "decode_32k", {"ok": False, "error": "x"})
    t_sweep.cell_path(tmp_path, "mamba2-2.7b", "prefill_32k") \
        .write_text("{not json")
    rows = {(r["arch"], r["shape"]): r
            for r in t_sweep.roofline_grid(tmp_path, table)}
    assert len(rows) == 8
    ana = t_sweep.analytical_terms(table)
    for key, r in rows.items():
        i = table.keys.index(key)
        assert r["batch"] == t_base.SHAPES[key[1]].global_batch
        if not ana["applicable"][i]:
            continue
        # every applicable row's terms are the analytical ones at the full
        # global batch, measured or not
        assert r["bound_s"] == float(ana["bound_s"][i])
        assert r["dominant"] == str(ana["dominant"][i])
    r = rows[("olmo-1b", "train_4k")]
    assert r["source"] == "dryrun" and r["batch"] == 256
    assert r["measured"] == {
        "batch": 8, "reduced": ["global_batch 256 -> 8: ..."],
        **terms, "bound_s": 3.0, "dominant": "memory_s", "step_s": 6.0,
        "achieved_fraction": 0.5}
    assert rows[("olmo-1b", "long_500k")] == {
        "arch": "olmo-1b", "shape": "long_500k", "batch": 1,
        "source": "skip"}
    for key in (("olmo-1b", "decode_32k"), ("mamba2-2.7b", "prefill_32k"),
                ("mamba2-2.7b", "long_500k")):
        assert rows[key]["source"] == "analytical"
        assert "measured" not in rows[key]


def test_sweep_resumes_without_rework(tmp_path, monkeypatch):
    calls = []

    def fake(arch, shape, out_dir, *, force=False, device="cuda"):
        calls.append((arch, shape))
        rec = {"arch": arch, "shape": shape, "mesh": "single"}
        if shape == "long_500k" and arch == "olmo-1b":
            rec.update(ok=False, skipped=True, reason="quadratic")
        elif shape == "decode_32k" and len(calls) <= 8:
            rec.update(ok=False, error="flaky")
        else:
            rec.update(ok=True)
        _write(out_dir, arch, shape, rec)
        return rec

    monkeypatch.setattr(dryrun, "run_cell", fake)
    archs = ["olmo-1b", "zamba2-1.2b"]
    cells = t_sweep.all_cells(archs)
    assert t_sweep.pending_cells(cells, tmp_path) == cells
    res = t_sweep.run_sweep(tmp_path, archs=archs, device="cpu")
    assert (res["scheduled"], res["ok"], res["skipped"], res["failed"]) == \
        (8, 5, 1, 2)
    assert len(calls) == 8
    failed = [c for c in cells if c[1] == "decode_32k"]
    assert t_sweep.pending_cells(cells, tmp_path) == failed
    assert t_sweep.pending_cells(cells, tmp_path, retry_failed=False) == []
    res = t_sweep.run_sweep(tmp_path, archs=archs, retry_failed=False,
                            device="cpu")
    assert res["scheduled"] == 0 and len(calls) == 8
    res = t_sweep.run_sweep(tmp_path, archs=archs, device="cpu")
    assert (res["scheduled"], res["ok"]) == (2, 2) and len(calls) == 10
    assert t_sweep.pending_cells(cells, tmp_path) == []
    t_sweep.cell_path(tmp_path, "olmo-1b", "train_4k").write_text("{")
    assert t_sweep.pending_cells(cells, tmp_path) == [("olmo-1b", "train_4k")]
    assert t_sweep.cell_status(tmp_path, "olmo-1b", "long_500k") == "skipped"


REF_FIELDS = ("arch", "shape", "mesh", "ok", "n_devices", "memory",
              "model_flops_total", "model_flops_per_dev",
              "useful_flops_ratio", "terms", "dominant", "roofline_fraction")


def test_run_cell_on_the_cpu_writes_the_reference_fields(tmp_path):
    cfg, _ = t_reg.get("olmo-1b", smoke=True)
    rec = dryrun.run_cell("olmo-1b", "decode_32k", tmp_path, cfg=cfg,
                          device="cpu", limit=2e8)
    on_disk = json.loads(t_sweep.cell_path(tmp_path, "olmo-1b",
                                           "decode_32k").read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert rec["ok"], rec.get("traceback")
    assert set(REF_FIELDS) | {"reduced", "batch", "step_ms",
                              "flops_per_dev"} <= set(rec)
    B = rec["batch"]
    assert B < 128 and B & (B - 1) == 0
    assert rec["reduced"] == [
        f"global_batch 128 -> {B}: the largest power of two whose "
        f"analytical memory ({dryrun.resident_bytes(cfg, 'decode', B, 32768) / 1e9:.1f}"
        f" GB) fits in 0.2 GB"]
    assert dryrun.resident_bytes(cfg, "decode", 2 * B, 32768) > 2e8
    assert rec["model_flops_total"] == 2.0 * cfg.n_active_params * B
    assert rec["terms"]["collective_s"] == 0.0
    assert rec["terms"]["compute_s"] == rec["flops_per_dev"] / 989e12
    assert rec["flops_per_dev"] >= rec["model_flops_total"] * 0.5
    assert rec["memory"]["peak_bytes"] is None     # no card: not measured
    assert len(rec["step_ms"]) == dryrun.STEPS
    # resumable: an existing artifact is read, not measured again
    assert dryrun.run_cell("olmo-1b", "decode_32k", tmp_path, cfg=cfg,
                           device="cpu") == on_disk


def test_run_cell_skips_what_does_not_fit(tmp_path):
    cfg, _ = t_reg.get("olmo-1b", smoke=True)
    rec = dryrun.run_cell("olmo-1b", "long_500k", tmp_path, cfg=cfg,
                          device="cpu")
    assert rec["skipped"] and "sub-quadratic" in rec["reason"]
    rec = dryrun.run_cell("olmo-1b", "train_4k", tmp_path, cfg=cfg,
                          device="cpu", limit=1e6)
    assert rec["skipped"] and "does not fit" in rec["reason"]
    full, _ = t_reg.get("dbrx-132b")
    for name, shape in t_base.SHAPES.items():
        assert dryrun.fitted_batch(dryrun._serving(full, shape), shape) \
            is None, name


def test_batch_cut_is_the_largest_power_of_two_that_fits():
    cfg, _ = t_reg.get("olmo-1b")
    shape = t_base.SHAPES["train_4k"]
    b = dryrun.fitted_batch(cfg, shape)
    assert dryrun.resident_bytes(cfg, "train", b, 4096) <= dryrun.MEM_LIMIT
    assert dryrun.resident_bytes(cfg, "train", 2 * b, 4096) > \
        dryrun.MEM_LIMIT
    assert dryrun.fitted_batch(cfg, shape, limit=1e20) == 256


def _at_chunk(cfg, chunk):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk=chunk))


def test_count_flops_counts_the_plain_path_on_meta():
    """The meta count equals the same plain step counted on the CPU with
    the SSD at the kernels' tile (the smoke configs' chunk is 8)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import ssd_scan as ss
    cfg, model = t_reg.get("zamba2-1.2b", smoke=True)
    shape = dataclasses.replace(t_base.SHAPES["prefill_32k"], seq_len=64,
                                global_batch=2)
    params = model.init(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.zeros((2, 64), dtype=torch.int32)
    counter = FlopCounterMode(display=False)
    with counter:
        model.forward(params, _at_chunk(cfg, ss.TILE), tokens)
    assert dryrun.count_flops(cfg, model, shape) == \
        counter.get_total_flops() > 0
    # an SSM stack's count from two shallow ones equals the full count
    cfg, model = t_reg.get("mamba2-2.7b", smoke=True)
    deep = dataclasses.replace(cfg, n_layers=5)
    params = model.init(torch.Generator().manual_seed(0), deep, "cpu")
    counter = FlopCounterMode(display=False)
    with counter:
        model.forward(params, _at_chunk(deep, ss.TILE), tokens)
    assert dryrun.count_flops(deep, model, shape) == \
        counter.get_total_flops() > 0


@pytest.mark.parametrize("chunk", (8, 32, 128))
def test_count_flops_counts_the_ssd_at_the_kernels_tile(chunk):
    """The card runs the SSD at its 64-row tile whatever chunk the config
    asks, so the count does too: the same at every chunk, though the
    plain path at another chunk does other products inside each chunk."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import ssd_scan as ss
    cfg, model = t_reg.get("mamba2-2.7b", smoke=True)
    shape = dataclasses.replace(t_base.SHAPES["prefill_32k"], seq_len=256,
                                global_batch=1)
    at_tile = dryrun.count_flops(_at_chunk(cfg, ss.TILE), model, shape)
    assert dryrun.count_flops(_at_chunk(cfg, chunk), model, shape) == \
        at_tile > 0
    cfg = _at_chunk(cfg, chunk)
    params = model.init(torch.Generator().manual_seed(0), cfg, "cpu")
    counter = FlopCounterMode(display=False)
    with counter:
        model.forward(params, cfg, torch.zeros((1, 256), dtype=torch.int32))
    assert counter.get_total_flops() != at_tile


def test_variants_apply_and_mark_the_mesh_knobs(tmp_path, monkeypatch):
    """Only knobs the port reads on one card are variants: no mesh knob,
    remat policy, plain-attention tile or SSD chunk (the SSD kernels run
    their own tile) is among them, and the artifact records its
    variant and overrides."""
    assert perf.VARIANTS == {"baseline": {}, "ce256": {"ce_chunk": 256}}
    cfg, _ = t_reg.get("mamba2-2.7b")
    assert perf.apply_variant(cfg, perf.VARIANTS["baseline"]) == cfg
    got = perf.apply_variant(cfg, perf.VARIANTS["ce256"])
    assert got.ce_chunk == 256 and got.ssm == cfg.ssm
    seen = []

    def fake(arch, shape, out_dir, *, force=False, cfg=None, tag="single",
             device="cuda"):
        seen.append((tag, cfg))
        rec = {"arch": arch, "shape": shape, "mesh": tag, "ok": True}
        t_sweep.cell_path(out_dir, arch, shape, tag).write_text(
            json.dumps(rec))
        return rec

    monkeypatch.setattr(dryrun, "run_cell", fake)
    rec = perf.run_variant("mamba2-2.7b", "train_4k", "ce256",
                           perf.VARIANTS["ce256"], out_dir=tmp_path)
    assert (rec["variant"], rec["overrides"]) == ("ce256",
                                                  {"ce_chunk": "256"})
    tag, got = seen[0]
    assert tag == "ce256" and got.ce_chunk == 256
    assert json.loads(t_sweep.cell_path(tmp_path, "mamba2-2.7b", "train_4k",
                                        "ce256").read_text()) == rec
