"""Training loop, sampling chain and checkpoints. ``python -m afford_motion_torch.train`` is
the training entry (``entry.py``); :func:`main` is the same call for Python
callers."""


def main(argv=None, device=None):
    """Train with the given config overrides; see ``entry.py``."""
    from .entry import main as entry_main

    return entry_main(argv, device)
