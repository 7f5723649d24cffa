"""Write the golden mamba2-2.7b (tuned: SSD chunk 128) logits the port is
held to on the card.

Runs the JAX reference's prefill step (`repro.launch.steps.
make_prefill_step`, ssm branch: forward, last position) on the CPU for
`mamba2_2p7b.tuned()` at full width with the depth cut to 4 layers, in
float32, on weights made by `repro_torch.convert.lm_params_numpy` from a
seed, and writes `src/repro_torch/data/golden_mamba2.json` in the format
of `torch_golden_lm.py` (settings, the weights' checksum, logits at a
sample of vocab ids, each row's top-8, the non-top-1 spread).  The
prompt is 300 tokens: two whole chunks of 128 and a ragged tail, so the
chunk's state passing and the dt = 0 pad both count.

The tolerance is `ATOL_REL` x the spread of the non-top-1 logits, as for
zamba2-1.2b; `chip_smoke.py` holds the card's float32 prefill (the SSD
kernels at their 64-row tile) to it and checks that the bf16 prefill
misses it, and `tests/test_torch_golden_mamba2.py` holds the port's CPU
path (the plain SSD at chunk 128).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden_mamba2.py
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from repro_torch.golden import spread

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "data" / "golden_mamba2.json")
ARCH = "mamba2-2.7b"
N_LAYERS = 4
CUT = ("mamba2_2p7b.tuned() (SSD chunk 128) at full width; depth 64 -> 4 "
       "layers, so the reference's CPU run stays in about a minute and "
       "2 GB")
SEED = 0
BATCH, SEQ = 2, 300
N_SAMPLE, TOPK = 256, 8
ATOL_REL = 5e-5


def port_config():
    """The golden's configuration in the port: mamba2-2.7b tuned, cut to
    `N_LAYERS` layers, float32 weights and compute."""
    import torch
    from repro_torch.configs import mamba2_2p7b
    return dataclasses.replace(mamba2_2p7b.tuned(), n_layers=N_LAYERS,
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)


def main() -> None:
    import jax
    import jax.numpy as jnp
    from repro.configs import mamba2_2p7b
    from repro.launch import steps
    from repro.models import registry
    from repro.nn import core
    from repro_torch import convert

    tcfg = port_config()
    _, model = registry.get(ARCH)
    jcfg = dataclasses.replace(mamba2_2p7b.tuned(), n_layers=N_LAYERS,
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    assert jcfg.ssm.chunk == tcfg.ssm.chunk == 128
    tree = convert.lm_params_numpy(tcfg, SEED)
    params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, jcfg.vocab, (BATCH, SEQ))
    step = jax.jit(steps.make_prefill_step(jcfg, model, None))
    h = step(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    logits = np.asarray(core.unembed_logits(params["embed"]["table"], h),
                        np.float32)
    ids = np.sort(rng.choice(jcfg.vocab, N_SAMPLE, replace=False))
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :TOPK]
    GOLDEN.write_text(json.dumps({
        "source": "repro.launch.steps.make_prefill_step (JAX, CPU, "
                  "float32) written by tests/torch_golden_mamba2.py",
        "arch": ARCH, "config": "tuned", "chunk": jcfg.ssm.chunk,
        "n_layers": N_LAYERS, "cut": CUT, "compute_dtype": "float32",
        "seed": SEED, "params_sha256": convert.params_checksum(tree),
        "tokens": tokens.tolist(),
        "sample_ids": ids.tolist(),
        "logits_at_sample": logits[:, ids].tolist(),
        "top8_ids": top.tolist(),
        "top8_logits": np.take_along_axis(logits, top, -1).tolist(),
        "spread": spread(logits),
        "atol_rel_to_spread": ATOL_REL}) + "\n")
    print(f"wrote {GOLDEN}: spread {spread(logits):.3f}, "
          f"top-1 {top[:, 0].tolist()}, top-1 logits {logits.max(-1).tolist()}")


if __name__ == "__main__":
    main()
