"""Run a cell with the control in the program's place, to show it fails.

    python3 amqbench/control.py --workload <cell> --seed <n> --seconds <s>

The control is the family's plain reference (``amqbench/reference``) one
fingerprint bit short of the configuration's precision: the remainders
narrow by one bit, so the filter answers yes on twice the fingerprints
a fresh key can collide with, and its planes hold other remainders.  The
window drives it as it drives the program, and the same check judges
it: every run of the control must come out not correct.  The
benchmark's own runs never run it.  Prints what ``run.py`` prints.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (puts the checkout on sys.path)


def main(argv=None) -> int:
    args = run.parse(argv)
    import torch

    from amqbench.harness import cell as runner
    from amqbench.harness import spec
    from amqbench.harness.engine import Control

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    result, lines = runner.run(cell, args.seed, args.seconds, False, "cuda", T_START,
                               engine=Control(cell.config, "cuda"))
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
