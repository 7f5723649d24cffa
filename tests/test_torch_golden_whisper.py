"""The port's plain path on the CPU against the golden whisper-medium
logits the card is held to (`src/repro_torch/data/golden_whisper.json`,
written from the JAX reference by `tests/torch_golden_whisper.py`): full
width, 4 encoder + 4 decoder layers, one 448-token request against 1500
seeded frames, float32, seeded weights.  Passing also proves the file is
current and the numpy weight and frame streams unchanged."""
import json

import numpy as np
import torch

import torch_golden_lm
import torch_golden_whisper as golden_whisper
from repro_torch import convert
from repro_torch.launch import steps
from repro_torch.models import whisper
from repro_torch.nn import core

GOLDEN = json.loads(golden_whisper.GOLDEN.read_text())


def test_golden_records_its_settings():
    assert GOLDEN["arch"] == golden_whisper.ARCH
    assert (GOLDEN["n_layers"], GOLDEN["dec_layers"]) == \
        (golden_whisper.N_LAYERS, golden_whisper.DEC_LAYERS)
    assert GOLDEN["cut"] == golden_whisper.CUT
    assert np.asarray(GOLDEN["tokens"]).shape == (golden_whisper.BATCH,
                                                  golden_whisper.SEQ)
    assert GOLDEN["atol_rel_to_spread"] == torch_golden_lm.ATOL_REL
    cfg = golden_whisper.port_config()
    assert GOLDEN["frames_sha256"] == golden_whisper.frames_sha256(
        golden_whisper.frames(cfg, GOLDEN["frames_seed"]))
    assert max(golden_whisper.SEQ, cfg.audio_frames) <= 2048   # sdpa


def test_port_matches_whisper_golden():
    cfg = golden_whisper.port_config()
    tree = convert.lm_params_numpy(cfg, GOLDEN["seed"])
    assert convert.params_checksum(tree) == GOLDEN["params_sha256"]
    params = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    del tree
    frames = torch.from_numpy(golden_whisper.frames(cfg,
                                                    GOLDEN["frames_seed"]))
    h, _ = steps.make_prefill_step(cfg, whisper)(
        params, {"tokens": torch.as_tensor(GOLDEN["tokens"]),
                 "frames": frames})
    logits = core.unembed_logits(params["embed"]["table"], h)
    assert torch.isfinite(logits).all()
    assert abs(torch_golden_lm.spread(logits.numpy()) / GOLDEN["spread"]
               - 1) < 1e-5
    torch_golden_lm.check(logits.numpy(), GOLDEN)
