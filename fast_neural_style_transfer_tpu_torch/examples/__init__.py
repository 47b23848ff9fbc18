"""The JAX package's ``examples/`` on the port's API, each runnable as

    python -m fast_neural_style_transfer_tpu_torch.examples.<name> [output_dir] [--device cpu]

(``quickstart``, ``multistyle``, ``serving``, ``adain``). They run on the
card unless ``--device cpu`` is given."""

import argparse


def parse_args(argv, default_out: str, doc: str):
    """(output_dir, device) from an example's command line."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("output_dir", nargs="?", default=default_out)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return args.output_dir, args.device
