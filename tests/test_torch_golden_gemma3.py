"""The port's plain path on the CPU against the golden gemma3-4b logits
the card is held to (`src/repro_torch/data/golden_gemma3.json`, written
from the JAX reference by `tests/torch_golden_gemma3.py`): full width, 6
layers (five windowed local layers and one global), one 1152-token
prompt, float32, seeded weights.  Passing also proves the file is current
and the numpy weight stream unchanged."""
import json

import numpy as np
import torch

import torch_golden_gemma3 as golden_gemma3
import torch_golden_lm
from repro_torch import convert
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.nn import core

GOLDEN = json.loads(golden_gemma3.GOLDEN.read_text())


def test_golden_records_its_settings():
    assert GOLDEN["arch"] == golden_gemma3.ARCH
    assert GOLDEN["n_layers"] == golden_gemma3.N_LAYERS
    assert GOLDEN["cut"] == golden_gemma3.CUT
    assert np.asarray(GOLDEN["tokens"]).shape == (golden_gemma3.BATCH,
                                                  golden_gemma3.SEQ)
    assert GOLDEN["atol_rel_to_spread"] == torch_golden_lm.ATOL_REL
    assert GOLDEN["top1_rtol"] == golden_gemma3.TOP1_RTOL
    cfg = golden_gemma3.port_config()
    assert golden_gemma3.SEQ > cfg.window            # local layers mask
    assert golden_gemma3.SEQ <= 2048                 # the reference's sdpa


def test_port_matches_gemma3_golden():
    cfg = golden_gemma3.port_config()
    tree = convert.lm_params_numpy(cfg, GOLDEN["seed"])
    assert convert.params_checksum(tree) == GOLDEN["params_sha256"]
    params = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    del tree
    h, _ = steps.make_prefill_step(cfg, transformer)(
        params, {"tokens": torch.as_tensor(GOLDEN["tokens"])})
    logits = core.unembed_logits(params["embed"]["table"], h)
    assert torch.isfinite(logits).all()
    assert abs(torch_golden_lm.spread(logits.numpy()) / GOLDEN["spread"]
               - 1) < 1e-5
    torch_golden_lm.check(logits.numpy(), GOLDEN)
