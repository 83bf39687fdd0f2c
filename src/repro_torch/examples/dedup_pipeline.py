"""Streaming dataset dedup with a cascade filter (the paper's Webtable
workload), feeding a real training batch stream.

The port of ``examples/dedup_pipeline.py``.  On the card the pipeline's
cascade takes the kernel path (``kernels.dispatch.backend_for``).

    PYTHONPATH=src python -m repro_torch.examples.dedup_pipeline [--device cpu]
"""

from __future__ import annotations

import argparse

from .. import filters
from ..core.quotient_filter import resolve_device
from ..data.pipeline import DedupPipeline, PipelineConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    pipe = DedupPipeline(
        PipelineConfig(
            seq_len=512, batch_size=4, duplicate_fraction=0.35,
            dedup_ram_q=12, dedup_p=30, dedup_fanout=4, dedup_levels=4,
        ),
        device=resolve_device(args.device),
    )
    for i, batch in enumerate(pipe.batches(10, docs_per_step=512)):
        s = pipe.state
        print(
            f"batch {i}: tokens {tuple(batch['tokens'].shape)} | "
            f"corpus seen={s.docs_seen} "
            f"kept={s.docs_kept} dropped(dup)={s.docs_dropped} "
            f"({100 * s.docs_dropped / max(s.docs_seen, 1):.1f}% dup rate)"
        )
    fs = filters.stats(pipe.filter_cfg, pipe.filter_state)
    out = {
        "docs_seen": pipe.state.docs_seen, "docs_kept": pipe.state.docs_kept,
        "docs_dropped": pipe.state.docs_dropped, "digests": int(fs["n"]),
        "levels": int(fs["nonempty_levels"]), "merges": int(fs["merges"]),
        "size_bytes": fs["size_bytes"],
    }
    print(
        f"cascade filter: {out['digests']:,} digests across "
        f"{out['levels']} levels, {out['merges']} merges, "
        f"{out['size_bytes']/1024:.0f} KiB modeled"
    )
    return out


if __name__ == "__main__":
    main()
