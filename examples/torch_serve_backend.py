"""Serving example on the PyTorch port: batched requests through the
continuous-batching server.  The server feeds each prompt token by
token through the model's plain `decode_step` (as the reference's does),
so on the card this path launches no hand-written kernel.  The port of
`examples/serve_backend.py`; it prints the same lines.  Its weights are
drawn from a seeded CPU `torch.Generator` (the reference's threefry
draws cannot be reproduced); `main(params=...)` serves given weights
instead.

    PYTHONPATH=src python examples/torch_serve_backend.py --device cpu \\
        [--arch gemma3-4b]
"""
import argparse

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.serving.engine import Request, Server


def main(argv=None, params=None) -> dict:
    """Run the example (weights `params`, or seeded ones); returns its
    printed figures by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=registry.arch_names())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, model = registry.get(args.arch, smoke=True)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0), cfg,
                            args.device)
    srv = Server(cfg, model, params, batch_slots=4, max_len=64, eos=-1)

    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(2, cfg.vocab, size=rng.integers(4, 12))
        srv.submit(Request(rid, prompt.astype(np.int32), max_new_tokens=8))

    done = srv.run()
    for r in done:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    print(f"\nstats: {srv.stats.prefills} prefills, "
          f"{srv.stats.decode_steps} decode steps, "
          f"{srv.stats.tokens_out} tokens out")
    return {"tokens": {r.rid: list(r.out_tokens) for r in done},
            "prompts": {r.rid: len(r.prompt) for r in done},
            "prefills": srv.stats.prefills,
            "decode_steps": srv.stats.decode_steps,
            "tokens_out": srv.stats.tokens_out}


if __name__ == "__main__":
    main()
