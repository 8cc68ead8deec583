"""The port's programs; each runs on the card unless ``--device cpu`` is
given."""


def require_device(name: str) -> str:
    """``name`` when that device is there; with no card for a CUDA device,
    exit non-zero with a message that names ``--device cpu``."""
    import torch

    if torch.device(name).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device for --device {name}: the programs "
                         f"run on the card; pass --device cpu to solve on "
                         f"the CPU")
    return name
