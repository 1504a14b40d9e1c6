"""The port's programs (the JAX package's ``cli``): each takes
``--device``, ``cuda`` by default and never swapped for another."""


def device_arg(ap):
    """Add ``--device`` (default ``cuda``) to an argument parser."""
    ap.add_argument("--device", default="cuda",
                    help="torch device to compute on (default: cuda)")


def checked_device(name):
    """``torch.device(name)``, refused when it names a card that is not
    there: the program fails rather than run elsewhere."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device here (use "
                           "--device cpu to run on the CPU)")
    return device
