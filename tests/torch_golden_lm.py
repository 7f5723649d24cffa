"""Write the golden zamba2-1.2b logits the port is held to on the card.

Runs the JAX reference's prefill step (`repro.launch.steps.
make_prefill_step`, hybrid branch: forward, last position) on the CPU
for zamba2-1.2b at full width with the depth cut to 8 layers, in
float32, on weights made by `repro_torch.convert.lm_params_numpy` from a
seed, and writes `src/repro_torch/data/golden_zamba2.json`:

  * the settings (arch, cut and its reason, seed, batch, tokens);
  * `params_sha256`, the checksum of the seeded weights, so a changed
    numpy stream fails as itself and not as a parity failure;
  * the last position's logits at a fixed sample of vocab ids, each row's
    top-8 ids and logits, and `spread`: the smallest over rows of the
    standard deviation of a row's logits with its top-1 left out.

The top-1 logit says little: with the tied embedding it is the row's own
last token (about 550 against about 170 for the next), whatever the
layers do.  So the tolerance is set against the spread of the other
logits (about 40): atol `ATOL_REL` x spread, 2.0e-3.  The port's float32
error is 2.7e-4 on the CPU and 3.1e-4 on an H100; the same path in
bfloat16 is off by 1.3-2.0 and swaps two of the top-8 (CPU), so the
tolerance tells the two precisions apart.

`chip_smoke.py` and `tests/test_torch_golden_lm.py` read the file as
data and hold the port to it: logits at the sampled and top-8 ids within
that tolerance, and at each of the 8 top ranks the golden's id, or an
id whose logit ties the golden's at that rank within twice the
tolerance.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden_lm.py
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from repro_torch.golden import golden_errors, rank_miss, spread

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "data" / "golden_zamba2.json")
ARCH = "zamba2-1.2b"
N_LAYERS = 8
CUT = ("full width; depth 38 -> 8 mamba layers: one shared-block call "
       "after layer 6, then 2 trailing layers, so both branches of the "
       "backbone run while the reference's CPU run stays in minutes")
SEED = 0
BATCH, SEQ = 2, 128
N_SAMPLE, TOPK = 256, 8
ATOL_REL = 5e-5


def port_config():
    """The golden's configuration in the port: zamba2-1.2b cut to
    `N_LAYERS` layers, float32 weights and compute."""
    import torch
    from repro_torch.configs import zamba2_1p2b
    return dataclasses.replace(zamba2_1p2b.config(), n_layers=N_LAYERS,
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)


def check(logits, golden: dict) -> tuple:
    """Hold (B, V) logits to the golden; returns (max abs error at the
    sampled and top-8 ids, tolerance).  Raises AssertionError."""
    tol = golden["atol_rel_to_spread"] * golden["spread"]
    err, rel1 = golden_errors(logits, golden)
    assert err <= tol, f"logits off by {err} > {tol}"
    if "top1_rtol" in golden:
        assert rel1 <= golden["top1_rtol"], \
            f"top-1 logit off by {rel1} relative > {golden['top1_rtol']}"
    miss = rank_miss(logits, golden, tol)
    assert miss is None, f"(row, rank) {miss}: not the golden's top-8 id"
    return err, tol


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
                  "float32) written by tests/torch_golden_lm.py",
        "arch": ARCH, "n_layers": N_LAYERS, "cut": CUT,
        "compute_dtype": "float32", "seed": SEED,
        "params_sha256": convert.params_checksum(tree),
        "tokens": tokens.tolist(),
        "sample_ids": ids.tolist(),
        "logits_at_sample": logits[:, ids].tolist(),
        "top8_ids": top.tolist(),
        "top8_logits": np.take_along_axis(logits, top, -1).tolist(),
        "spread": spread(logits),
        "atol_rel_to_spread": ATOL_REL}) + "\n")
    print(f"wrote {GOLDEN}: spread {spread(logits):.3f}, "
          f"top-1 {top[:, 0].tolist()}")


if __name__ == "__main__":
    main()
