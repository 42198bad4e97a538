"""The JAX package's ``examples/`` on the port, one module each.

Each example keeps its script's asserts, exposes ``main(device=None)`` (the
card unless the caller passes ``device="cpu"``) and runs as
``python -m homomorph_tpu_torch.examples.<name> [--device cuda|cpu]``.
"""

import argparse


def run(main, doc: str) -> None:
    """Command-line entry of an example: ``--device`` (default ``cuda``)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    main(ap.parse_args().device)
