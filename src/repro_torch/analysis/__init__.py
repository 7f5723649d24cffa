"""repro_torch.analysis — reprolint for the PyTorch port.

An AST-based lint pass (stdlib only) that mechanically enforces the
eager-torch invariants the port's correctness and host time rest on.
A lightweight intra-package call graph tells rules which functions run
per call on device tensors (the hot set: the port's per-call device
paths, every torch transform's body, autograd Functions and module
forwards), so "no host sync" is checked where it matters and nowhere
else.  ``chip_smoke.py`` holds the hot set to the synchronizing
operations torch itself reports on the card.

Rules
-----
==== =====================================================================
R001 per-call rebuild hazards: kernel builds / library loads per call or
     in a loop outside an lru_cache'd builder, torch.func transforms
     built in a hot loop, Python control flow on tensor values, cached
     builders with unhashable defaults
R002 host syncs / host side effects inside the hot set (``.item()``,
     ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
     ``float()``/``int()``/``bool()`` and numpy of a tensor,
     ``torch.cuda.synchronize``, ``print`` of a tensor, module globals)
R003 RNG discipline: draws on an explicit CPU ``torch.Generator``; no
     ``np.random.*``, no global seeds or generator-less draws, no CUDA
     generator, no constant seed in a loop or re-used in one function
R004 unit-suffix dimensional analysis over ``_mw/_mwh/_h/_s/_c/_mbps/
     _pods`` names; units derive through ``*`` and ``/``
R005 cache-key hygiene for ``_ROW_CACHE``/``_PIPELINES``/
     ``_ASSEMBLIES``/``lru_cache`` keys (no tensors, ``id()``,
     ``data_ptr()`` or raw bytes)
R006 per-step allocation (cat/stack/list-append of tensors in a hot
     loop) and float64 drift inside the float32 device pipeline
==== =====================================================================

CLI
---
::

    python -m repro_torch.analysis [paths ...]  # default: src/repro_torch
        --format {text,json,github}             # default text
        --baseline PATH | --no-baseline         # default: the port's
                                                # analysis/baseline.json
        --write-baseline PATH                   # grandfather current set
        --rules R002,R003                       # subset of rules
        --fix-suggestions                       # R003/R004 rewrites
        --list-rules

Exit status is non-zero iff there are *new* findings — not suppressed
by an inline ``# repro: ignore[R00x]: reason`` comment and not present
in the port's baseline.  The tier-1 self-scan test
(tests/test_torch_analysis.py) pins src/repro_torch to zero new findings.
"""
from .engine import AnalysisResult, analyze, collect_files  # noqa: F401
from .findings import Finding, load_baseline, write_baseline  # noqa: F401
from .rules import RULES  # noqa: F401
