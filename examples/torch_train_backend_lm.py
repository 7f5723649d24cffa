"""End to end on the PyTorch port: train a backend contextual-AI
LM for a few hundred steps on the synthetic egocentric pipeline, with
checkpoint/restart and int8 gradient compression, through the flash
(and, for the SSD family, the SSD-scan) kernels and their backward
kernels on the card.  The port of `examples/train_backend_lm.py`; it
prints the same lines.  Its weights are drawn from a seeded CPU
`torch.Generator` (the reference's threefry draws cannot be reproduced);
`main(params=...)` starts from given weights instead.

    PYTHONPATH=src python examples/torch_train_backend_lm.py --device cpu \\
        --steps 20 [--arch granite-3-2b]
"""
import argparse
import tempfile

from repro_torch.launch.train import train
from repro_torch.models import registry


def main(argv=None, params=None) -> dict:
    """Run the example (from weights `params`, or seeded ones); returns
    its printed figures by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b",
                    choices=registry.arch_names())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as d:
        _, losses = train(
            args.arch, smoke=True, steps=args.steps, batch=8, seq=64,
            ckpt_dir=d, ckpt_every=50, compress_grads=True, log_every=20,
            device=args.device, params=params)
    print(f"\n{args.arch}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps (int8-compressed grads, async ckpt)")
    return {"losses": losses}


if __name__ == "__main__":
    main()
