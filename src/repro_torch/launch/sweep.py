"""Resumable measured-cell sweep + the batched analytical roofline, for
one NVIDIA H100 (the reference's `launch/sweep.py`).

* ``run_sweep`` / CLI — fill ``results/torch_cells/`` with cells measured
  on the card (`launch.dryrun.run_cell`), one after another in the
  process that holds the card.  Resumable: cells whose artifact already
  parses as ok/skipped are never redone; failed or corrupt artifacts are
  retried (disable with ``retry_failed=False``).

* ``CellTable`` / ``analytical_terms`` — a struct-of-arrays ANALYTICAL
  roofline: first-order FLOPs / HBM terms for every (arch x shape) cell
  in ONE numpy pass over config-derived columns.  ``analytical_cell`` is
  the per-cell loop path.

* ``roofline_grid`` lists both: every row carries the analytical terms
  at the cell's full global batch, and where a measured artifact exists
  (``source: "dryrun"``) its own terms beside them under ``measured``,
  at the batch it ran (``batch``, ``reduced``).

Analytical model (first-order, one card; the reference's formulas with
its mesh at one device):
  compute_s    = mult * n_active * tokens / PEAK_FLOPS
                 (mult = 6 train, 2 prefill/decode; tokens = batch for
                 decode, batch*seq otherwise)
  memory_s     = (weight + activation + cache traffic) / HBM_BW
                 weights stream once per step (f32 train incl. grad +
                 optimizer traffic, bf16 serving), activations ~8
                 d_model-sized touches per layer (16 with backward),
                 KV-cache / SSM-state traffic for decode/prefill.
  collective_s = 0: one card has no peer to talk to.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch_cells"

# NVIDIA H100 SXM (per card; the data sheet's dense rates at 700 W): the
# constants chip_smoke.py's bounds use
PEAK_FLOPS = 989e12          # bf16 FLOP/s, tensor cores, dense
HBM_BW = 3.35e12             # bytes/s, HBM3

DONE_STATES = ("ok", "skipped")


# ---------------------------------------------------------------------------
# sweep bookkeeping (pure file inspection)
# ---------------------------------------------------------------------------

def all_cells(archs=None, shapes=None) -> list[tuple]:
    """The full (arch, shape) grid, registry x shape order."""
    if archs is None or shapes is None:
        from ..configs.base import SHAPES
        from ..models import registry
        archs = registry.arch_names() if archs is None else archs
        shapes = list(SHAPES) if shapes is None else shapes
    return [(a, s) for a in archs for s in shapes]


def cell_path(out_dir, arch: str, shape: str, tag: str = "single") -> Path:
    """A cell's artifact; `tag` names a perf variant ("single" else)."""
    return Path(out_dir) / f"{arch}__{shape}__{tag}.json"


def cell_status(out_dir, arch: str, shape: str, tag: str = "single") -> str:
    """missing | corrupt | failed | ok | skipped for one cell artifact."""
    f = cell_path(out_dir, arch, shape, tag)
    if not f.exists():
        return "missing"
    try:
        r = json.loads(f.read_text())
    except (json.JSONDecodeError, OSError):
        return "corrupt"
    if r.get("skipped"):
        return "skipped"
    return "ok" if r.get("ok") else "failed"


def pending_cells(cells=None, out_dir=RESULTS,
                  retry_failed: bool = True) -> list[tuple]:
    """Cells `run_sweep` would still execute (the resume set)."""
    cells = all_cells() if cells is None else cells
    redo = {"missing", "corrupt"} | ({"failed"} if retry_failed else set())
    return [c for c in cells if cell_status(out_dir, *c) in redo]


def run_sweep(out_dir=RESULTS, force: bool = False, retry_failed: bool = True,
              archs=None, shapes=None, progress=None, device="cuda") -> dict:
    """Fill the artifact directory, one measured cell after another on
    `device`, resumable.

    Returns {"scheduled", "ok", "skipped", "failed", "statuses"} where
    statuses maps each executed cell to its outcome.  A no-op resume
    (everything already done) measures nothing.
    """
    from . import dryrun
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cells = all_cells(archs, shapes)
    todo = cells if force else pending_cells(cells, out_dir, retry_failed)
    statuses: dict[tuple, str] = {}
    t0 = time.time()
    for cell in todo:
        try:
            rec = dryrun.run_cell(*cell, out_dir, force=True, device=device)
            st = ("skipped" if rec.get("skipped") else "ok" if rec.get("ok")
                  else "failed: " + rec.get("error", "?")[:200])
        except Exception as e:  # noqa: BLE001 — keep sweeping
            st = f"failed: {type(e).__name__}: {e}"
        statuses[cell] = st
        if progress:
            progress(f"[{time.time() - t0:7.1f}s {len(statuses)}/{len(todo)}]"
                     f" {'__'.join(cell):45s} {st}")
    counts = {k: sum(1 for v in statuses.values() if v.startswith(k))
              for k in ("ok", "skipped", "failed")}
    return {"scheduled": len(todo), **counts, "statuses": statuses}


# ---------------------------------------------------------------------------
# batched analytical roofline (struct-of-arrays over arch x shape)
# ---------------------------------------------------------------------------

_COLS = ("n_active", "n_params", "d_model", "n_layers_eff", "seq", "batch",
         "kind", "applicable", "param_dtype_bytes", "cache_per_token",
         "state_bytes_per_seq")


def _cache_terms(cfg) -> tuple:
    """(KV-cache bytes per token, SSM-state bytes per sequence), bf16."""
    layers_eff = cfg.n_layers + cfg.dec_layers
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    if cfg.family == "ssm":
        return 0.0, cfg.n_layers * cfg.ssm.d_inner * cfg.ssm.d_state * 2.0
    if cfg.family == "hybrid":
        # shared attn block rides on top of the per-layer SSM state
        return 2 * kv_dim * 2.0, \
            cfg.n_layers * cfg.ssm.d_inner * cfg.ssm.d_state * 2.0
    return 2 * kv_dim * 2.0 * layers_eff, 0.0


def cell_row(cfg, shp) -> tuple:
    """One cell's columns (`_COLS` order) for config `cfg` at shape
    `shp`."""
    from ..configs.base import shape_applicable
    ok, _ = shape_applicable(cfg, shp)
    cache_tok, state = _cache_terms(cfg)
    return (float(cfg.n_active_params), float(cfg.n_params),
            float(cfg.d_model), float(cfg.n_layers + cfg.dec_layers),
            float(shp.seq_len), float(shp.global_batch),
            {"train": 0.0, "prefill": 1.0, "decode": 2.0}[shp.kind],
            float(ok), 4.0 if shp.kind == "train" else 2.0,
            cache_tok, state)


@dataclass(frozen=True)
class CellTable:
    """Struct-of-arrays view of the (arch x shape) grid.

    Built once from the configs (the only per-arch Python loop), then
    `analytical_terms` evaluates the whole grid in one numpy pass."""
    keys: tuple                     # ((arch, shape), ...) len N
    cols: dict                      # name -> (N,) float64 array

    def __len__(self) -> int:
        return len(self.keys)

    @classmethod
    def of(cls, cells) -> "CellTable":
        """A table of explicit cells: ((key, cfg, ShapeConfig), ...) (a
        measured cell's own config and cut batch)."""
        keys, rows = [], []
        for key, cfg, shp in cells:
            keys.append(key)
            rows.append(cell_row(cfg, shp))
        arr = np.asarray(rows, np.float64).reshape(len(rows), len(_COLS))
        return cls(tuple(keys), {c: arr[:, i] for i, c in enumerate(_COLS)})

    @classmethod
    def build(cls, archs=None, shapes=None) -> "CellTable":
        from ..configs.base import SHAPES
        from ..models import registry
        archs = registry.arch_names() if archs is None else list(archs)
        shape_names = list(SHAPES) if shapes is None else list(shapes)
        cfgs = {a: registry.get(a)[0] for a in archs}
        return cls.of([((a, s), cfgs[a], SHAPES[s]) for a in archs
                       for s in shape_names])


def analytical_terms(table: CellTable) -> dict:
    """The whole grid's roofline terms in one vectorized numpy pass.

    Returns (N,) arrays: compute_s / memory_s / collective_s / bound_s,
    plus `dominant` (str array) and the `applicable` mask.  Inapplicable
    cells (long_500k on quadratic archs) carry NaN terms.
    """
    c = table.cols
    train = c["kind"] == 0.0
    decode = c["kind"] == 2.0
    tokens = np.where(decode, c["batch"], c["batch"] * c["seq"])
    mult = np.where(train, 6.0, 2.0)
    compute_s = mult * c["n_active"] * tokens / PEAK_FLOPS

    param_bytes = c["n_params"] * c["param_dtype_bytes"]
    weight = param_bytes * np.where(train, 3.0, 1.0)
    act = tokens * c["d_model"] * c["n_layers_eff"] * 2.0 \
        * np.where(train, 16.0, 8.0)
    cache = (c["cache_per_token"] * c["seq"] + c["state_bytes_per_seq"]) \
        * c["batch"] * (~train)
    memory_s = (weight + act + cache) / HBM_BW

    app = c["applicable"] > 0.5
    nan = np.where(app, 1.0, np.nan)
    terms = {"compute_s": compute_s * nan, "memory_s": memory_s * nan,
             "collective_s": np.zeros_like(compute_s) * nan}
    stacked = np.stack([terms["compute_s"], terms["memory_s"]])
    bound = np.max(stacked, axis=0)
    names = np.array(["compute_s", "memory_s"])
    dom = names[np.argmax(np.where(np.isnan(stacked), -np.inf, stacked),
                          axis=0)]
    return {**terms, "bound_s": bound, "dominant": dom, "applicable": app}


def analytical_cell(arch: str, shape: str) -> dict:
    """Per-cell analytical roofline: a 1-row table per call."""
    t = CellTable.build([arch], [shape])
    terms = analytical_terms(t)
    return {k: (v[0] if isinstance(v, np.ndarray) else v)
            for k, v in terms.items()}


def roofline_grid(results_dir=None, table: CellTable | None = None) -> list:
    """One row per grid cell at its full global batch (`batch`):
    analytical terms for every applicable cell (source="analytical";
    inapplicable cells carry source="skip" and no terms).  Where an ok
    measured artifact exists (source="dryrun") its own terms, at the
    batch it ran, stand beside them under `measured` with that batch,
    its `reduced` list, its step time and the share of its bound the
    step reached; they never replace the full-batch terms."""
    d = Path(results_dir) if results_dir else RESULTS
    table = table or CellTable.build()
    terms = analytical_terms(table)
    rows = []
    for i, (arch, shape) in enumerate(table.keys):
        row = {"arch": arch, "shape": shape,
               "batch": int(table.cols["batch"][i])}
        if not terms["applicable"][i]:
            rows.append({**row, "source": "skip"})
            continue
        row.update({"source": "analytical",
                    **{k: float(terms[k][i]) for k in
                       ("compute_s", "memory_s", "collective_s", "bound_s")},
                    "dominant": str(terms["dominant"][i])})
        f = cell_path(d, arch, shape)
        rec = None
        if f.exists():
            try:
                rec = json.loads(f.read_text())
            except (json.JSONDecodeError, OSError):
                rec = None
        if rec and rec.get("ok") and rec.get("terms"):
            t = rec["terms"]
            row.update({"source": "dryrun", "measured": {
                "batch": rec.get("batch"), "reduced": rec.get("reduced", []),
                **{k: t[k] for k in ("compute_s", "memory_s",
                                     "collective_s")},
                "bound_s": max(t.values()), "dominant": max(t, key=t.get),
                "step_s": rec.get("step_s"),
                "achieved_fraction": rec.get("achieved_fraction")}})
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-retry-failed", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    archs = None if args.arch == "all" else [args.arch]
    shapes = None if args.shape == "all" else [args.shape]
    res = run_sweep(Path(args.out), force=args.force,
                    retry_failed=not args.no_retry_failed, archs=archs,
                    shapes=shapes, progress=lambda s: print(s, flush=True),
                    device=args.device)
    print(f"scheduled={res['scheduled']} ok={res['ok']} "
          f"skipped={res['skipped']} failed={res['failed']}", flush=True)
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
