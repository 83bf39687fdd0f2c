"""Serving: batched prefill + decode with the AMQ prefix cache.

The port of ``repro.launch.serve``: a quotient filter in front of the
(simulated remote) prefix-KV store answers "is this prefix cached?"
without paying the remote round trip for misses.  The model and the
filter run on the card unless ``--device`` says otherwise; on the card
the prefix cache takes the QF kernels (``kernels.dispatch.backend_for``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --smoke \\
      --requests 16 --gen 8 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config, make_smoke
from ..core.quotient_filter import resolve_device
from ..kernels import dispatch
from ..models import model
from ..serve.prefix_cache import PrefixCacheFilter
from ..serve.serve_step import sample_greedy


def make_requests(cfg, requests: int, prompt_len: int, seed: int) -> tuple:
    """The served prompts and an encoder-decoder's frames, drawn as the
    reference draws them, from one generator in its order: the prompts,
    half the requests repeating earlier ones (cache hits), then the frames
    (requests, encoder_seq, d_model) float64 (None for a decoder)."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (requests, prompt_len))
    prompts[requests // 2 :] = prompts[: requests - requests // 2]
    frames = None
    if cfg.is_encoder_decoder:
        frames = rng.normal(size=(requests, cfg.encoder_seq, cfg.d_model))
    return prompts, frames


def serve(cfg, params, prompts: np.ndarray, gen: int, device=None, frames=None):
    """Check the prompts against a fresh prefix cache, then prefill them
    (with ``frames``, cast to the activations' dtype, for an
    encoder-decoder) and decode ``gen`` greedy tokens a request.

    Returns (hits, tokens, prefix_cache): the hit mask (numpy bool),
    the generated tokens (B, gen) int32 on ``device``, and the
    ``PrefixCacheFilter`` after the batch's inserts."""
    device = resolve_device(device)
    pcache = PrefixCacheFilter(q=16, r=14, backend=dispatch.backend_for(device), device=device)
    B = prompts.shape[0]
    hits = pcache.check_and_insert(prompts)
    print(f"[serve] prefix-cache hits: {int(hits.sum())}/{B} "
          f"(repeats should hit)")

    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int32, device=device)}
    if frames is not None:
        batch["frames"] = torch.as_tensor(frames, device=device).to(getattr(torch, cfg.act_dtype))
    t0 = time.time()
    logits, cache = model.prefill(params, cfg, batch)
    tok = sample_greedy(logits)[:, None]
    out = [tok]
    for _ in range(gen - 1):
        logits, cache = model.decode_step(params, cfg, cache, tok)
        tok = sample_greedy(logits)[:, None]
        out.append(tok)
    tokens = torch.cat(out, dim=1)
    sample = tokens[0, :8].cpu().numpy()  # waits for the last step
    dt = time.time() - t0
    print(f"[serve] generated {B}x{gen} tokens in {dt:.2f}s "
          f"({B*gen/dt:.1f} tok/s); sample: {sample}")
    return hits, tokens, pcache


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for tests)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = make_smoke(cfg)
    device = resolve_device(args.device)
    params = model.init(cfg, args.seed, device)
    prompts, frames = make_requests(cfg, args.requests, args.prompt_len, args.seed)
    serve(cfg, params, prompts, args.gen, device, frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
