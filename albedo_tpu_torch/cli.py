"""CLI entry point: ``python -m albedo_tpu_torch.cli <job> [options]``.

Port of ``albedo_tpu/cli.py`` for the jobs this package has (``train_als``).
``--device`` picks where the job runs: ``cuda`` (the default) runs the CUDA
kernels and fails when there is no card; ``cpu`` runs their plain PyTorch
versions.
"""

from __future__ import annotations

import argparse
import sys

EXIT_OK = 0
EXIT_USAGE = 2


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """The job and its options from the command line (``argv``; default
    ``sys.argv[1:]``)."""
    from albedo_tpu_torch.builders.jobs import JOBS

    parser = argparse.ArgumentParser(prog="albedo-tpu-torch")
    parser.add_argument("job", choices=sorted(JOBS), help="job to run")
    parser.add_argument("--small", action="store_true", help="laptop-scale run")
    parser.add_argument(
        "--now", type=float, default=None,
        help="epoch seconds for date features (default: wall clock)",
    )
    parser.add_argument(
        "--solver", choices=("cholesky", "cg"), default="cholesky",
        help="ALS normal-equation solver: exact Cholesky (MLlib parity, "
        "default) or matrix-free warm-started CG (fast path)",
    )
    parser.add_argument(
        "--cg-steps", type=int, default=3, help="CG steps per half-sweep (--solver cg)"
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the job runs: cuda (hand-written kernels; fails without "
        "a card) or cpu (their plain PyTorch versions)",
    )
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    from albedo_tpu_torch.builders.jobs import JOBS

    args = parse_args(argv)
    rc = JOBS[args.job](args)
    return int(rc) if isinstance(rc, int) else EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
