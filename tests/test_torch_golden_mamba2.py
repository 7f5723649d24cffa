"""The port's plain path on the CPU against the golden mamba2-2.7b tuned
logits the card is held to (`src/repro_torch/data/golden_mamba2.json`,
written from the JAX reference by `tests/torch_golden_mamba2.py`): SSD
chunk 128, full width, 4 layers, float32, seeded weights, a 300-token
prompt.  Passing also proves the file is current and the numpy weight
stream unchanged."""
import json

import numpy as np
import torch

import torch_golden_lm
import torch_golden_mamba2
from repro_torch import convert
from repro_torch.launch import steps
from repro_torch.models import mamba_lm
from repro_torch.nn import core

GOLDEN = json.loads(torch_golden_mamba2.GOLDEN.read_text())


def test_golden_records_its_settings():
    assert GOLDEN["arch"] == torch_golden_mamba2.ARCH
    assert (GOLDEN["config"], GOLDEN["chunk"]) == ("tuned", 128)
    assert GOLDEN["n_layers"] == torch_golden_mamba2.N_LAYERS
    assert GOLDEN["cut"] == torch_golden_mamba2.CUT
    assert np.asarray(GOLDEN["tokens"]).shape == (torch_golden_mamba2.BATCH,
                                                  torch_golden_mamba2.SEQ)
    assert GOLDEN["atol_rel_to_spread"] == torch_golden_mamba2.ATOL_REL
    cfg = torch_golden_mamba2.port_config()
    assert cfg.ssm.chunk == 128 and cfg.pure_dp and cfg.d_model == 2560


def test_port_matches_mamba2_tuned_golden():
    cfg = torch_golden_mamba2.port_config()
    tree = convert.lm_params_numpy(cfg, GOLDEN["seed"])
    assert convert.params_checksum(tree) == GOLDEN["params_sha256"]
    params = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    del tree
    h = steps.make_prefill_step(cfg, mamba_lm)(
        params, {"tokens": torch.as_tensor(GOLDEN["tokens"])})
    logits = core.unembed_logits(params["embed"]["table"], h)
    assert torch.isfinite(logits).all()
    assert abs(torch_golden_lm.spread(logits.numpy()) / GOLDEN["spread"]
               - 1) < 1e-5
    torch_golden_lm.check(logits.numpy(), GOLDEN)
