"""Write the golden gemma3-4b logits the port is held to on the card.

Runs the JAX reference's prefill step (`repro.launch.steps.
make_prefill_step`, dense branch: `transformer.prefill`, last position)
on the CPU for gemma3-4b at full width (D 2560, 8 heads / 4 KV heads of
256, d_ff 10 240, vocab 262 144) with the depth cut to 6 layers, in
float32, on weights made by `repro_torch.convert.lm_params_numpy` from a
seed, and writes `src/repro_torch/data/golden_gemma3.json` in the format
of `tests/torch_golden_lm.py` (settings, weight checksum, logits at a
fixed sample of vocab ids, each row's top-8 ids and logits, and the
spread of the non-top-1 logits).

Six layers are one 5:1 period: five local layers (window 1024, RoPE base
1e4) and one global layer (no window, base 1e6).  One prompt of 1152
tokens: past the window, so the local layers mask keys, and at most 2048,
so the reference takes `sdpa` (not `chunked_attention`).  Tolerance:
atol `ATOL_REL` x spread, the zamba2 golden's (2.2e-3 at a spread of
44.6), for every logit but the row's top-1, which is held to `TOP1_RTOL`
of its own value; `torch_golden_lm.check` applies both.  The top-1 is
the row's own token: with embeddings scaled by sqrt(2560) its logit is
~2234 and lies along the hidden state, so float32 rounding moves it by a
few 1e-6 of itself (the port's float32 prefill on the CPU: 5.4e-3, 2.4e-6
relative; every other logit within 3.8e-4).  The bf16 control misses
both (0.83 on the other logits, 2.5e-3 relative on the top-1, CPU).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden_gemma3.py

(~2 min and ~12 GB on the CPU: the seeded weights are 1.24 B float32
parameters, held once as numpy and once by JAX.)
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

import torch_golden_lm
from torch_golden_lm import ATOL_REL, N_SAMPLE, TOPK, spread

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "data" / "golden_gemma3.json")
ARCH = "gemma3-4b"
N_LAYERS = 6
CUT = ("full width; depth 34 -> 6 layers: one 5:1 period (five windowed "
       "local layers, one global), so both kinds of layer run while the "
       "reference's CPU run stays in minutes")
SEED = 0
BATCH, SEQ = 1, 1152
TOP1_RTOL = 1e-5


def port_config():
    """The golden's configuration in the port: gemma3-4b cut to
    `N_LAYERS` layers, float32 weights and compute."""
    import torch
    from repro_torch.configs import gemma3_4b
    return dataclasses.replace(gemma3_4b.config(), n_layers=N_LAYERS,
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)


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
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    tree = convert.lm_params_numpy(tcfg, SEED)
    checksum = convert.params_checksum(tree)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, jcfg.vocab, (BATCH, SEQ))
    step = jax.jit(steps.make_prefill_step(jcfg, model, None))
    h, _ = step(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    logits = np.asarray(core.unembed_logits(params["embed"]["table"], h),
                        np.float32)
    ids = np.sort(rng.choice(jcfg.vocab, N_SAMPLE, replace=False))
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :TOPK]
    GOLDEN.write_text(json.dumps({
        "source": "repro.launch.steps.make_prefill_step (JAX, CPU, "
                  "float32) written by tests/torch_golden_gemma3.py",
        "arch": ARCH, "n_layers": N_LAYERS, "cut": CUT,
        "compute_dtype": "float32", "seed": SEED,
        "params_sha256": checksum,
        "tokens": tokens.tolist(),
        "sample_ids": ids.tolist(),
        "logits_at_sample": logits[:, ids].tolist(),
        "top8_ids": top.tolist(),
        "top8_logits": np.take_along_axis(logits, top, -1).tolist(),
        "spread": spread(logits),
        "atol_rel_to_spread": ATOL_REL, "top1_rtol": TOP1_RTOL}) + "\n")
    print(f"wrote {GOLDEN}: spread {spread(logits):.3f}, top-1 "
          f"{top[:, 0].tolist()} ({logits.max(-1).tolist()}), tol "
          f"{ATOL_REL * spread(logits):.4g}; check "
          f"{torch_golden_lm.check(logits, json.loads(GOLDEN.read_text()))}")


if __name__ == "__main__":
    main()
