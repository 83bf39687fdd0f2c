"""End-to-end driver: train a ~130M-param model for a few hundred steps
on the dedup'd synthetic stream, with checkpointing.

The port of ``examples/train_e2e.py``, a thin wrapper over
``repro_torch.launch.train`` with the JAX example's arguments.  The
checkpoints go to ``--ckpt-dir``, or to a temporary directory removed at
the end; every other argument passes through to the driver.

    PYTHONPATH=src python -m repro_torch.examples.train_e2e [--steps 200] \\
        [--ckpt-dir DIR] [--device cpu] [--smoke]
"""

from __future__ import annotations

import argparse
import sys
import tempfile

from ..launch import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", default=None)
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--steps") for a in rest):
        rest += ["--steps", "200"]
    with tempfile.TemporaryDirectory() as tmp:
        return train.run(
            ["--arch", "mamba2-130m", "--batch", "8", "--seq", "512",
             "--ckpt-dir", args.ckpt_dir or tmp, "--ckpt-every", "50"] + rest
        )


if __name__ == "__main__":
    main()
