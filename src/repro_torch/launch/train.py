"""End-to-end training driver.

The port of ``repro.launch.train``.  Wires together: dedup data pipeline
(the paper's technique in the data plane) -> train step -> checkpointing
(incl. filter state) -> fault-tolerant supervision.  The model, the
optimizer state and the pipeline's filter live on the card unless
``--device`` says otherwise; the device also picks the pipeline's filter
backend (``kernels.dispatch.backend_for``), so on the card the dedup
cascade launches the QF kernels.  The step is ``make_train_step``'s plain
function; it reads nothing on the host, and the loop reads the loss only
for its print every 5 steps.  The process is the monitor's one host and
beats its heartbeat after each step, so a run may outlast the heartbeat
timeout (the reference's driver beats none and halts 30 s into a run).

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --smoke --steps 4 --batch 2 --seq 64 --device cpu
"""

from __future__ import annotations

import argparse
import pickle
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config, make_smoke
from ..core.quotient_filter import resolve_device
from ..data.pipeline import DedupPipeline, PipelineConfig
from ..train import optimizer as optim
from ..train import train_step as ts
from ..train.checkpoint import CheckpointManager
from ..train.fault_tolerance import ClusterMonitor, FTConfig, TrainSupervisor


def run(argv=None) -> dict:
    """Train as the command line ``argv`` says; returns the last printed
    step's numbers and the pipeline's counters."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = make_smoke(cfg)
    ocfg = optim.OptConfig(
        lr=args.lr,
        total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10),
        compress_grads=args.compress_grads,
    )

    pipe = DedupPipeline(
        PipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
            seed=args.seed,
        ),
        device=device,
    )
    state = ts.init_state(cfg, ocfg, args.seed, device)
    step_fn = ts.make_train_step(cfg, ocfg, microbatches=args.microbatches)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and args.resume:
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, state, device=device)
            extra = ckpt.restore_extra(latest)
            if extra is not None:
                pipe.restore(pickle.loads(extra["pipeline"].tobytes()))
            start_step = latest
            print(f"[train] resumed from step {latest}")

    # one process drives one host
    monitor = ClusterMonitor(["host0"], FTConfig())
    sup = TrainSupervisor(
        monitor, FTConfig(), hosts_per_replica=1, current_dp=1,
        on_restore=lambda dp: None,
    )

    frames = None
    if cfg.is_encoder_decoder:
        rng = np.random.default_rng(0)
        frames = torch.as_tensor(
            rng.normal(size=(args.batch, cfg.encoder_seq, cfg.d_model)), device=device
        ).to(getattr(torch, cfg.act_dtype))

    it = pipe.batches(args.steps - start_step)
    report = {"resumed_from": start_step}
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = next(it)
        if frames is not None:
            batch = dict(batch, frames=frames)

        def do_step():
            nonlocal state
            state, metrics = step_fn(state, batch)
            monitor.heartbeat("host0")  # this process is the one host, alive while it steps
            return metrics

        metrics = sup.run_step(do_step)
        if metrics is None:
            continue
        if step % 5 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            tput = (step - start_step + 1) * args.batch * args.seq / (
                time.time() - t_start
            )
            report.update(step=step, loss=loss, lr=float(metrics["lr"]),
                          grad_norm=float(metrics["grad_norm"]), tokens_per_s=tput)
            print(
                f"[train] step={step} loss={loss:.4f} "
                f"lr={report['lr']:.2e} "
                f"gnorm={report['grad_norm']:.2f} "
                f"tok/s={tput:.0f} dedup_dropped={pipe.state.docs_dropped}",
                flush=True,
            )
        if ckpt and (step + 1) % args.ckpt_every == 0:
            snap = np.frombuffer(pickle.dumps(pipe.snapshot()), np.uint8)
            ckpt.save(step + 1, state, {"pipeline": snap}, background=True)
    if ckpt:
        ckpt.wait()
    print(
        f"[train] done: {args.steps} steps; corpus seen={pipe.state.docs_seen} "
        f"kept={pipe.state.docs_kept} dropped(dup)={pipe.state.docs_dropped}"
    )
    report.update(steps=args.steps, docs_seen=pipe.state.docs_seen,
                  docs_kept=pipe.state.docs_kept, docs_dropped=pipe.state.docs_dropped)
    return report


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
