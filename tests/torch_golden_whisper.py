"""Write the golden whisper-medium logits the port is held to on the card.

Runs the JAX reference's prefill step (`repro.launch.steps.
make_prefill_step`, encdec branch: `whisper.prefill`, the decoder's last
position) on the CPU for whisper-medium at full width (D 1024, 16 heads
of 64, d_ff 4096, vocab 51 865, 1500 audio frames) with the depth cut to
4 encoder + 4 decoder layers, in float32, on weights made by
`repro_torch.convert.lm_params_numpy` from a seed, and writes
`src/repro_torch/data/golden_whisper.json` in the format of
`tests/torch_golden_lm.py` (settings, weight checksum, logits at a fixed
sample of vocab ids, the top-8 ids and logits, the spread of the
non-top-1 logits).

One request: 448 decoder tokens (Whisper's text context, n_text_ctx,
arXiv:2212.04356) against 1500 frames of stub embeddings, standard normal
float32 from numpy's generator seeded `FRAMES_SEED` (`frames`; the file
records the frames' sha256, since they are too many to store).  Both
lengths are at most 2048, so the reference takes `sdpa` everywhere.
Tolerance: atol `ATOL_REL` x spread, the other goldens' ratio.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden_whisper.py

(~1 min and ~4 GB on the CPU.)
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np

import torch_golden_lm
from torch_golden_lm import ATOL_REL, N_SAMPLE, TOPK, spread

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "data" / "golden_whisper.json")
ARCH = "whisper-medium"
N_LAYERS = DEC_LAYERS = 4
CUT = ("full width; depth 24 + 24 -> 4 encoder + 4 decoder layers, so the "
       "reference's CPU run stays in minutes")
SEED = 0
FRAMES_SEED = 2
BATCH, SEQ = 1, 448


def port_config():
    """The golden's configuration in the port: whisper-medium cut to
    4 + 4 layers, float32 weights and compute."""
    import torch
    from repro_torch.configs import whisper_medium
    return dataclasses.replace(whisper_medium.config(), n_layers=N_LAYERS,
                               dec_layers=DEC_LAYERS,
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)


def frames(cfg, seed: int = FRAMES_SEED) -> np.ndarray:
    """(BATCH, audio_frames, D) standard normal float32 stub embeddings."""
    return np.random.default_rng(seed).standard_normal(
        (BATCH, cfg.audio_frames, cfg.d_model), dtype=np.float32)


def frames_sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, "<f4").tobytes()) \
        .hexdigest()


def main() -> None:
    import jax
    import jax.numpy as jnp
    from repro.launch import steps
    from repro.models import registry
    from repro.nn import core
    from repro_torch import convert

    tcfg = port_config()
    jcfg, model = registry.get(ARCH)
    jcfg = dataclasses.replace(jcfg, n_layers=N_LAYERS,
                               dec_layers=DEC_LAYERS,
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    tree = convert.lm_params_numpy(tcfg, SEED)
    checksum = convert.params_checksum(tree)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, jcfg.vocab, (BATCH, SEQ))
    fr = frames(tcfg)
    step = jax.jit(steps.make_prefill_step(jcfg, model, None))
    h, _ = step(params, {"tokens": jnp.asarray(tokens, jnp.int32),
                         "frames": jnp.asarray(fr)})
    logits = np.asarray(core.unembed_logits(params["embed"]["table"], h),
                        np.float32)
    ids = np.sort(rng.choice(jcfg.vocab, N_SAMPLE, replace=False))
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :TOPK]
    GOLDEN.write_text(json.dumps({
        "source": "repro.launch.steps.make_prefill_step (JAX, CPU, "
                  "float32) written by tests/torch_golden_whisper.py",
        "arch": ARCH, "n_layers": N_LAYERS, "dec_layers": DEC_LAYERS,
        "cut": CUT, "compute_dtype": "float32", "seed": SEED,
        "params_sha256": checksum,
        "frames_seed": FRAMES_SEED, "frames_sha256": frames_sha256(fr),
        "tokens": tokens.tolist(),
        "sample_ids": ids.tolist(),
        "logits_at_sample": logits[:, ids].tolist(),
        "top8_ids": top.tolist(),
        "top8_logits": np.take_along_axis(logits, top, -1).tolist(),
        "spread": spread(logits),
        "atol_rel_to_spread": ATOL_REL}) + "\n")
    print(f"wrote {GOLDEN}: spread {spread(logits):.3f}, top-1 "
          f"{top[:, 0].tolist()} ({logits.max(-1).tolist()}), last token "
          f"{tokens[:, -1].tolist()}, tol {ATOL_REL * spread(logits):.4g}; "
          f"check "
          f"{torch_golden_lm.check(logits, json.loads(GOLDEN.read_text()))}")


if __name__ == "__main__":
    main()
