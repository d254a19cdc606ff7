"""The JAX package's nine demos on the port, each run as

    python -m cyclistsocialforce_tpu_torch.demos.demo_<name> [--device cpu]

with the JAX demo's arguments plus `--device` (the card by default; a
machine without one is told to pass `--device cpu`, nothing falls back).
matplotlib is imported only where a demo draws."""

import torch


def add_device_argument(parser):
    parser.add_argument("--device", default="cuda",
                        help="where the crowd lives: cuda (default) or cpu")


def device_of(args) -> torch.device:
    """The demo's device; without a card, `--device cuda` stops the demo
    with a message instead of running elsewhere."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run the demo with --device cpu")
    return dev
