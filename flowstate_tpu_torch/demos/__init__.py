"""The demos, one script each, run as a module, e.g.
``python -m flowstate_tpu_torch.demos.mcmc_demo [--smoke] [--device cpu]``;
their notebook forms are in ``notebooks/``
(``python -m flowstate_tpu_torch.tools.make_notebooks``).  Each writes
under ``demo_results/`` of the working directory."""

import argparse


def cli_args(argv=None) -> dict:
    """``smoke`` and ``device`` of a demo's ``main`` from its command line."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--smoke", action="store_true",
                        help="a small run that exercises the same path")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return {"smoke": args.smoke, "device": args.device}
