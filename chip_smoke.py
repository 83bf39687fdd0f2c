#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card and check it.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each timed, any failure fatal (a traceback and exit code 1):

1. build    nvcc builds the eight CUDA sources from ``src/repro_torch/csrc``
            (ten kernels: ``qf_build.cu`` holds ``qf_build_planes``, the
            probe scan ``qf_positions`` and the migration's
            ``qf_build_span``); each is launched once on a small filter
            against its plain version, and the quotient-filter kernels on
            small cases that reach every branch of their kernels
            (``build_cases``, ``probe_cases``, ``span_cases``, and
            ``scan_cases``: a cluster over 100 scan tiles, overflow,
            ``n = 0``, sizes at a tile and one row either side; the
            decode's ``DECODE_CASES`` at ``decode_sizes`` and two over
            100 tiles);
            ``fingerprint`` on every (q, r) it takes, three seeds, int32 and
            int64 keys and both output types (``fingerprint_grid``);
            ``fuse_probe`` on small frozen filters of four cell widths at
            five seeds (``fuse_cases``).
2. kernels  each kernel against its plain PyTorch version on the card, bit
            for bit, at the main path's shapes (a q = 24 build of 12.6 M
            fingerprints, 2**22 probes and the fingerprints of their keys,
            the 7-structure cascade of phase 3 taken mid-stream, with its
            RAM structure Q0 partly full; the probe positions of a q = 25
            build's 33,555,456-row stream; a migration chunk of 61,440 and a
            drain of 12,582,912 fingerprints appended to a q = 25 table;
            the decode of the benchmark's ingest tables at load 0.75: q = 29,
            the cascade's Q0 at q = 23 and its level 4 at q = 28),
            timed with CUDA events beside the
            plain version, a library call where one computes the same
            function, and the kernel's bound.  The probes' plain version is
            the exact decode-and-search lookup, not a copy of the kernel's
            walk.
3. main     the paper's 1:4 SSD experiment (``benchmarks/bench_ssd.py``) with
            its 2**13 scale-down undone: 50,331,648 keys into
            ``buffered_qf(ram_q=24, disk_q=27, p=39)`` and
            ``cascade(ram_q=24, p=39, fanout=2, levels=6)`` under
            ``backend="pallas"``.  After 63 of the 64 batches (RAM tier
            partly full) and after the last, 2**21 probes of inserted keys
            (no false negative allowed) and 2**21 fresh keys (false-positive
            rate at most twice the union bound); every kernel must have
            launched (``fingerprint`` hashes every insert and probe).  Probe
            times are the median of several calls by CUDA events after the
            answered call.  The probes account their I/O on a copy of the
            state, so the ingest's own I/O schedule stays apart for phase 7.
4. backends the same stream under ``backend="reference"`` (the plain PyTorch
            path): planes, ``n``, ``overflow``, hits and I/O counters equal at
            both checkpoints.
5. bloom    the same 50,331,648 keys into bench_ssd's Bloom geometry with its
            scale-down undone (k = 12, m = n * 12 / ln 2 = 871,358,627 bits):
            ``bloom``, ``blocked_bloom`` (32 KiB blocks) and the counting
            ``blocked_bloom``, all under ``backend="pallas"``; 2**22 probes,
            half inserted keys (no false negative) and half fresh keys
            (false-positive rate at most twice (1 - e**(-k n / m))**k); the
            counting filter then deletes the first 8 batches and must still
            hold every key of the other 56.  Both Bloom kernels must have
            launched; each is then held against its plain version at these
            shapes.
6. bloom backends  the same ingest and deletes under ``backend="reference"``:
            cells, ``n`` and hits equal to phase 5's states.
7. baselines the paper's Bloom baselines of bench_ssd (EBF, BBF, FBF) at the
            same geometry, and the modeled SSD throughput of all five
            structures of its Table 1(b): insert, uniform lookup and
            successful lookup ops/s from each ``IOLog`` and the paper's SSD
            constants, with the cascade's and the buffered QF's insert
            speed-up over the best Bloom variant (the paper: 8.6-11x).
8. frozen   the same 50,331,648 keys into
            ``cascade(ram_q=24, p=39, fanout=2, levels=3, frozen_below=1)``
            under ``backend="pallas"``: bench_ssd's 1:4 experiment with the
            cold tier demoted as ``bench_xor_fuse.py`` does it.  Level 1
            is a binary-fuse table with 14-bit cells (levels=3: a frozen
            level 3 would need 2**15 segments); batch 48's merge-down
            peels 37,748,736 fingerprints into it.  At both checkpoints no
            false negative, and an fp rate at most twice the bound (the QF
            union bound plus 2**-fp_bits per non-empty frozen level: the
            first fp check of the QF side that can fail).  Each freeze's
            rounds, seed attempts and host reads are printed.  Then the
            ``xor_fuse`` family on its own: ``make(keys=...)`` at full load
            on the first ``XF_KEYS`` keys, ``grow``, and ``merge`` with a
            filter of the next ``XF_KEYS``; no overflow, no false negative,
            fp rate at most twice 2**-14.  ``fuse_probe`` and ``fingerprint``
            must have launched; ``fuse_probe`` is then held against its plain
            version (``fuse_hash`` and three gathers) on 2**22 queries, and
            the kernel path's ``ops.contains``, ``ops.cascade_lookup`` and
            ``ops.fuse_lookup`` run once more under
            ``torch.cuda.set_sync_debug_mode("error")``: no host sync.
9. frozen backends  the frozen cascade's stream under ``backend="reference"``:
            every level (fuse tables, runs, ``n``, ``n_unique``,
            ``fuse_seed``, ``overflow``; QF planes), the I/O counters and the
            hits equal to phase 8's at both checkpoints.  Phases 4 and 9 so
            hold the fingerprint kernel, which hashes the pallas side's keys,
            to the plain chain of the reference side on every key.
10. inram   Table 1(a) (``benchmarks/bench_inram.py``) at q = 26: ``qf`` and
            ``bloom`` at r = k = 6, 9, 12, filled to 75%, their insert,
            uniform-lookup and successful-lookup rates and the QF/BF ratios
            (see ``drive_inram``).
11. resize  the resize slice at full width (``blocking_steps``,
            ``p99_experiment``): ``qf`` q = 24 at capacity through
            ``auto_grow`` and ``shrink``; phase 3's ``buffered_qf`` ``grow``
            (disk_q 27 -> 28); ``auto_grow`` of a one-level cascade over the
            64 batches, then ``resize(fanout=4)``; phase 8's frozen cascade
            after its batch-48 freeze ``resize(levels=2)`` (a re-peel); each
            step with no false negative, an fp rate at most twice the bound,
            no overflow, its I/O counters and seconds, and again under
            ``backend="reference"`` with equal states and hits.  The two
            restructures (``begin_restructure`` of the ``buffered_qf`` and of
            the grown cascade, fresh batches inserted while they migrate,
            ``finish``) must answer as their blocking counterparts.  Then
            ``benchmarks/bench_incremental.py`` scaled by 2**8 to q = 24:
            per-call p99 of ``auto_grow`` against ``auto_scale`` over the
            growth window and their ratio (the repo's bar is 5; recorded,
            not gated), ``finish`` seconds, the settled table equal to the
            blocking grow's bit for bit, the same under ``"reference"``;
            and one migrating insert under ``set_sync_debug_mode("error")``.
            ``qf_build_span``, ``qf_positions`` and ``qf_build_planes`` (and
            the probes) must have launched in this phase, and the steps of a
            blocking growth call are timed (``bulk_breakdown``).  Phases 3,
            8 and 10 also require ``qf_positions`` to have launched: no
            kernel-path build calls ``torch.cummax``.
12. steady  ``benchmarks/bench_steady_state.py`` scaled by 2**8 (q = 24,
            r = 14, batches of 2,048, settle chunk 131,072, steady buffer
            q = 18 opening at 0.25 load, ``buffered_qf`` ram_q 19, the two
            cascades ram_q 19, fanout 4, levels 3, one frozen below 1): its
            op stream (inserts, probes, a rare delete) replayed three times
            on each family under ``"pallas"`` from a copy of the prefilled
            state, each call's minimum kept; every inserted key (but the
            deleted) must hit, the steady filter must settle more often than
            the stream deletes, launch ``qf_build_span``, ``qf_positions``,
            ``qf_build_planes``, ``qf_probe`` and ``fingerprint``, end a
            ``"reference"`` replay with the same state, and make at most one
            host sync an insert (``set_sync_debug_mode("warn")``); the
            replay's drain appends through ``qf_build_span``'s plain
            version, and the kernel is held against it on a tick, a
            pressure tick and ``settle_all``'s span.  Insert
            p50/p99/max and ``p99ratio_*`` against the bench's bar of 0.20
            are recorded, not gated.
13. consumers  ``DedupPipeline`` with a ``steady_qf`` filter at q = 24,
            p = 39, fed 65,536 digests a ``_dedup`` call past 1.1 of the
            table's capacity (auto_scale shrinks the empty filter first and
            grows it back, the last growth toward q = 25); snapshots taken
            mid-settle at q = 24 and mid-migration restore into fresh
            pipelines leaf for leaf and drop a replay of every digest fed
            before them; ``batches()`` drop the corpus' duplicates at its
            rate.  Then a ``steady_qf`` ``PrefixCacheFilter(q=24, r=15)``
            prefilled to 0.7 load: request batches of 4,096 prompts (new,
            earlier and repeated ones) through ``check_and_insert`` (no
            cached prompt misses, later copies hit), then ``evict``.  The
            pipeline (whose filter takes the kernel path on the card) must
            launch the five QF kernels, the cache all but ``qf_build_span``.
14. sharded phase 3's 50,331,648 keys (64 batches) into
            ``sharded_qf(q=27, r=12, n_shards=8)``: p = 39 as in bench_ssd,
            eight shards of local q = 24, r = 15, shard ``s`` on
            ``cuda:(s % device_count)``.  After batches 63 and 64 every
            shard's ``extract`` stream, its quotients offset by
            ``s << 24``, must equal the stream of a flat
            ``qf(q=27, r=12, backend="pallas")`` fed the same keys, bit for
            bit, and the hits on phase 3's 2**21 inserted and 2**21 fresh
            keys the flat filter's (no false negative, an fp rate at most
            twice the union bound); so must ``grow`` (q = 28) against the
            flat ``grow``, ``shrink`` (4 shards, q = 26, r = 13) against a
            flat ``qf(q=26, r=13)`` of the same keys, and ``merge`` with a
            second sharded filter of 2**23 further keys against the flat
            merge.  ``fingerprint``, ``qf_positions``, ``qf_build_planes``
            and ``qf_probe`` must have launched on the sharded path (counted
            before the flat QFs run); one insert and one ``contains`` run
            under ``set_sync_debug_mode("error")``; an insert batch and a
            ``contains`` are split into their steps by CUDA events (route
            and bucket, exchange, the shards' local work, the answers' way
            back); an ``n_shards = 1`` filter under ``device=None`` takes a
            batch; and ``sharded_qf(q=24, r=29, n_shards=8)`` (a local
            remainder of 32 bits) must refuse an insert on the card.
15. ssd_large  Table 1(b) at 1:24 (``bench_ssd._experiment(24, "large")``),
            ratio-true at RAM_Q = 22 (at 24 the Bloom variants would need
            5.2 G cells, past the 32-bit double hash and int32 cell
            indices): the bench's draws from ``default_rng(24)``, 75,497,472
            keys in 64 batches of 1,179,648 into
            ``buffered_qf(ram_q=22, disk_q=28, p=37)`` and
            ``cascade(ram_q=22, p=37, fanout=2, levels=6)`` under
            ``"pallas"``, and into the EBF, BBF and FBF at k = 12 and
            m = n * 12 / ln 2 = 1,307,037,941 cells (``ssd_experiment``).
            The modeled insert, uniform- and successful-lookup ops/s of the
            five from their ``IOLog``s, ``vs_best_bf`` with and without the
            FBF, ``cf/bqf`` beside the paper's 1.26, the measured ingest;
            2**21 inserted keys (no false negative) and 2**21 fresh keys (an
            fp rate at most twice the union bound, and none at all at p =
            37 >= 32) through the two QF structures, whose answers must
            equal the plain path's on the same state; the inputs of the last
            build at q = 28 (the BQF's last flush) are recorded, and
            ``ops.build_sorted`` on them must equal the plain
            ``build_sorted`` bit for bit.  The QF kernels must have launched.
16. figures the paper's other figures, scaled up (``figures``), each
            structure held against the plain path on the card: Figs 1/2
            (``bench_fprate``) at q = 19, the largest q at which every r of
            the bench collides (the fingerprint is a bijection of the key
            at q + r >= 32), 2**22 member-free probes; each build equals the
            plain insert leaf for leaf and each hit mask the plain probe's,
            each fp count lies within 6 sigma of the rate it should meet
            (for a QF the analytic one times about 1 - 2**(q + r - 32),
            computed exactly from the members' distinct fingerprints; for a
            Bloom filter the analytic one), and each empirical/analytic
            ratio is at most 2; Fig 6 (``bench_occupancy``) at q = 24, the
            QF and the Bloom filter filled to 30, 60 and 90% in batches of
            2**21 and probed with 2**22 keys by CUDA events, each hit mask
            equal to the plain probe's; Fig 4 (``bench_clusters``) at q =
            24, each build equal to the plain one, cluster mean under the
            bound; Fig 9 (``bench_fanout``) through the ``CascadeFilter``
            shim on the card at RAM_Q = 20, p = 36, 40,960,000 keys, each
            level's probe equal to the plain one, the bench's trade-off
            held; then one ``BufferedQuotientFilter`` and one deamortized
            ``CascadeFilter`` at ram_q = 12 on the card and on the CPU,
            equal in every leaf, ``IOLog`` and hit.  Figs 1/2 and 6 must
            launch the Bloom and QF kernels, Fig 4 the QF build and
            ``fingerprint``, Fig 9 and each shim's card run (counted alone)
            the QF build, probe and ``fingerprint``.
17. serve   the LLM serving path (``serve_phase``): the five GQA decoder
            archs (qwen3-8b, deepseek-7b, gemma-7b, starcoder2-15b,
            qwen2-vl-7b) under ``make_smoke`` (float32), params made on the
            CPU and copied to the card, whose prefill and 8 greedy decode
            steps must match the CPU port's (logits and K/V within 1e-4 of
            the largest value, greedy tokens, ``kpos`` and ``pos`` equal);
            then ``qwen3-8b`` at full width (36 layers, d_model 4,096, 32/8
            heads, vocab 151,936, bf16, 8,190,735,360 params) from a seeded
            CUDA generator, served by ``repro_torch.launch.serve.serve`` at
            its defaults (16 requests of 64 tokens, 16 generated)
            in front of its prefix cache, whose hits and state must equal a
            CPU cache's fed the same prompts, with every repeat a hit and
            ``fingerprint``, ``qf_positions``, ``qf_build_planes`` and
            ``qf_probe`` launched on the path; the prefill's last logits and
            one decode step against ``forward`` over the whole sequence at
            16 x 64 (the step run under ``set_sync_debug_mode("error")``)
            and over a 2 x 4,096 prefill on the chunked attention path
            (``forward`` over 4,097 takes the naive one), max |d| / max
            |logit| under 0.125 (bf16); prefill ms at both shapes and
            decode ms a step and tokens/s at B = 16, beside their bounds,
            the aten operations of a decode step and the card's busy share
            of it (``torch.profiler``), and the phase's peak memory.
18. serve_moe  the MoE + MLA serving path (``serve_moe_phase``), after
            phase 17's weights are freed: deepseek-v2-lite-16b and
            grok-1-314b under ``make_smoke`` on the card against the CPU as
            in phase 17; then ``deepseek-v2-lite-16b`` at full width and
            depth (27 layers, the first dense, MLA with kv_lora_rank 512,
            64 routed experts top-6 and 2 shared, bf16, 15,706,484,224
            params), its readings at ``init``'s scale reported, then its
            leaves brought to their true fan-in (``at_true_fan_in``;
            ``init``, as the JAX package's, takes a stacked leaf's fan-in
            from its layer axis), in bf16 through phase 17's path:
            ``serve`` at its defaults in front of the prefix cache (hits
            and state against a CPU cache's, the four QF kernels
            launched), one decode step under the sync debug mode, the
            timings beside bounds that count the active parameters and the
            experts a decode step's tokens pick, and decode against
            ``forward`` at 16 x 64 and over a chunked 2 x 4,096 prefill,
            routed as ``forward`` routed, under 0.125, and routed freely,
            reported with the (layer, row) routing decisions that differ
            (bf16 rounding flips near-tied routing).  Every decode check
            runs at a capacity factor of E / top_k + 1 (no pair dropped;
            serving and timing keep the config's 1.25).  Then
            ``grok-1-314b`` at full width cut to 2 of its 64 layers (633 GB
            do not fit 80 GB) the same way at ``init``'s scale, at 16 x 64,
            its free routing held too where no decision differs.
19. serve_recurrent  the SSM / RG-LRU / encoder-decoder serving path
            (``serve_recurrent_phase``): mamba2-130m, recurrentgemma-9b and
            whisper-large-v3 under ``make_smoke`` on the card against the
            CPU as in phase 17 (whisper with frames); then each at full
            width and depth in bf16 (128,983,488; 9,396,408,320; and
            1,608,360,960 params, 631,232,000 of them whisper's encoder),
            its readings at ``init``'s scale reported, then its leaves
            brought to their true fan-in and driven through phase 17's
            path: ``serve`` at its defaults (whisper's frames drawn after
            the prompts) in front of the prefix cache, the four QF kernels
            launched; decode against ``forward`` under 0.125 at 16 x 64
            (the step under the sync debug mode) and over a chunked
            2 x 4,096 prefill (whisper 2 x 3,584; RecurrentGemma's
            2,048-slot attention ring wraps); timings beside bounds that
            count the SSM and RG-LRU layers' fixed state, the window, the
            cross K/V and the encoder; each model's peak memory.
20. train   the training path (``train_phase``): qwen3-8b,
            deepseek-v2-lite-16b, mamba2-130m, recurrentgemma-9b (at its
            true fan-in) and whisper-large-v3 under ``make_smoke``
            (float32), two ``make_train_step`` steps on the card against
            the CPU port, each from the CPU's state (loss within 1e-4,
            grad_norm and moments within 1e-3, ``lr`` and ``step`` exact,
            the params within 2 lr, and within 1e-6 + 1e-5 |p| where the
            first moment is well set); then ``launch/train.py``'s ``main``
            at examples/train_e2e.py's configuration, mamba2-130m at full
            width and depth in bf16, 8 x 512: 12 steps with a checkpoint
            every 4, then ``--steps 16 --resume``; the restored leaves
            equal, bit for bit, the leaves saved at step 12, the resumed
            pipeline's counters the snapshot's, every loss finite, one
            step under ``set_sync_debug_mode("error")``, the dedup
            cascade's ``fingerprint``, ``qf_positions``,
            ``qf_build_planes`` and ``cascade_probe`` launched in each run
            and held against their plain versions (its last q = 16 build,
            and ``contains`` of every digest drawn and as many fresh
            keys); then qwen3-8b at full width cut to 4 of its 36 layers
            (2.0 B params), bf16, 2 microbatches and int8 error-feedback
            compression, 3 steps at 4 x 1,024 (the second under the sync
            debug mode), the first step's loss within 1e-2 of a float32
            cross entropy of ``forward``'s logits.  Each run's ms a step,
            tokens/s, bound, aten operations and busy share of a step,
            and peak memory.
21. tools   the launch tools and the static analysis (``tools_phase``):
            ``launch/dryrun.py`` over every (arch x shape) cell on the
            ``meta`` device on the 1 x 1 card and, placed (each cell in a
            worker with its own ``fake`` process group), on the 16 x 16
            mesh for the 13 cells whose placement was repaired
            (``TOOLS_REPAIRED``) and every decode cell, and on the
            2 x 16 x 16 mesh for ``TOOLS_MULTI_POD``,
            in ``TOOLS_JOBS`` worker processes, one line a cell and the
            grid's wall time;
            a cell that errs, or a placed cell with no collective, fails
            the phase, each placed cell's collectives by kind and roofline
            terms reported; then for real on the card, at full width and the
            shape's own batch and length, every decode cell that the 1 x 1
            dry run puts under ``TOOLS_HEADROOM`` of 80 GiB, Mamba2-130M's
            ``decode_32k`` and ``long_500k`` and RecurrentGemma-9B's
            ``long_500k`` among them (``real_cells``): the dry run's
            argument bytes against the growth of the bytes requested of the
            caching allocator as the params, cache and inputs are built
            (within 512 bytes a tensor; ``memory_allocated``'s growth, at
            least that, reported), the cache then holding the shape's
            whole context (``full_context``), the step's ms (median after
            the first) at or above the roofline's ``step_time`` (the bytes
            the step must move, ``roofline.step_bytes``), its peak against
            the dry run's estimate; the op audit's families on the card
            (``tools_audit``): each ``device`` op under sync-debug
            ``"error"``, the counts against the manifest's ``cuda``
            section, every synchronizing call's site (``path::function``)
            a deliberate read of ``trace_audit.KNOWN_SYNC_SITES`` and each
            op's sites and counts equal to the section's,
            ``fingerprint``, ``qf_positions``, ``qf_build_planes``,
            ``qf_probe`` and ``cascade_probe`` launched and each held
            against its plain version on the largest inputs the audit gave
            it; ``spec_check`` and the lint, both exit 0.
22. examples the four examples of ``repro_torch.examples``
            (``examples_phase``): ``quickstart``, ``dedup_pipeline`` and
            ``serve_prefix_cache`` through their ``main`` on the card, the
            launch counts at 0 before quickstart, whose pallas section must
            launch ``fingerprint``, ``qf_positions``, ``qf_build_planes`` and
            ``qf_probe`` and answer as the plain path on the same keys; each
            one's integers (QF ``n`` after the delete, flushes, levels,
            merges, ``auto_grow``'s q and n, documents seen, kept and
            dropped, remote probes and hits) equal to a run on the CPU;
            then ``train_e2e`` (Mamba2-130M at full width, 8 x 512) for 2
            steps; each example's numbers and wall seconds.
23. mesh    placement across a device mesh (``mesh_phase``): a
            world-size-1 NCCL group opened with a ``file://`` store and a
            1 x 1 ("data", "model") ``DeviceMesh`` over it; a (1, 2) mesh
            refused (``check_devices``); qwen3-8b at full width and depth
            in bf16 (phase 17's weights) prefilled at 16 x 64 and decoded
            greedily, unplaced and on params and a cache placed by their
            specs (``model.place``, ``serve_step.place_cache``) under the
            mesh's rules: logits within 2**-8 of the largest (exact
            equality reported), greedy tokens and cache positions equal;
            phase 20's qwen3-8b step at 4 layers (2 microbatches, int8
            error feedback, 4 x 1,024) unplaced and by ``jit_train_step``
            on the mesh, the loss within 1e-3, ``lr`` and ``step`` equal;
            the placed params saved and restored onto the mesh bit for
            bit; ms a decode step at B = 16 and a train step, placed and
            unplaced.  Then deepseek-v2-lite-16b the same way (its decode
            at full depth, its step at 2 layers, each (layer, token)
            routing decision equal), its unplaced decode and step each run
            twice with the default kernels and required equal bit for bit
            (the MoE combine and the dispatch's gradient sum in a fixed
            order); mamba2-130m, recurrentgemma-9b and whisper-large-v3
            (its frames placed with the prompts) decoded at full width and
            depth at their true fan-in, placed against unplaced; and
            phase 20's mamba2-130m step at full depth, 8 x 512, placed
            against unplaced, its params saved and restored.  The group
            is torn down at the end.
24. report  one JSON line of per-kernel results (nine rows), then the
            card's name and power limit, then the result line.

The whole run must stay within 1200 s of command time on one H100.

The last line of standard output is the result,
``{"ok": true, "device": {"platform": "gpu", ...}}``; nothing is printed
in its place when the card or the package is missing.
"""

from __future__ import annotations

import contextlib
import json
import math
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
try:
    from repro_torch import filters
    from repro_torch import sharding as llm_sharding
    from repro_torch.core import bf_variants, bloom, cost_model
    from repro_torch.core import BufferedQuotientFilter, CascadeFilter
    from repro_torch.core import fuse_filter as fuse
    from repro_torch.core import quotient_filter as qf
    from repro_torch.core import sharded_filter
    from repro_torch.data.pipeline import DedupPipeline, PipelineConfig
    from repro_torch.filters import bloom_filter, incremental_resize, qf_filter, sharded
    from repro_torch.filters import steady
    from repro_torch.filters.cascade import CascadeConfig
    from repro_torch.serve.prefix_cache import PrefixCacheFilter
    from repro_torch.kernels import bloom_block, cascade_probe, cuda_lib, qf_build
    from repro_torch.kernels import fingerprint, fuse_probe, ops, qf_decode, qf_probe
    from repro_torch.configs import ARCHS, get_config, make_smoke
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    from repro_torch.models import model as llm
    from repro_torch.models import moe as llm_moe
    from repro_torch.models import schema as llm_schema
    from repro_torch.models import transformer as llm_transformer
    from repro_torch.serve import serve_step
    from repro_torch.train import optimizer as llm_optim
    from repro_torch.train import train_step as llm_train
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.analysis import spec_check, trace_audit
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.analysis.trace_audit import OpCount
    from repro_torch.examples import dedup_pipeline as ex_dedup
    from repro_torch.examples import quickstart as ex_quickstart
    from repro_torch.examples import serve_prefix_cache as ex_cache
    from repro_torch.examples import train_e2e as ex_train
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.roofline import (
        decode_bound_ms, expert_params, llm_params, moe_layers, prefill_bound_ms,
        train_bound_ms,
    )

    H100_BYTES_PER_S = roofline.HBM_BW  # HBM3 rate of the H100 SXM data sheet
    H100_BF16_FLOPS = roofline.PEAK_FLOPS  # dense bf16 tensor-core peak, the same sheet
except ModuleNotFoundError as e:  # run outside the repository
    if not (e.name or "").startswith("repro_torch"):
        raise
    filters = None

# main path: bench_ssd.py's 1:4 experiment at the paper's scale
RAM_Q = 24
P_BITS = 39
RATIO = 4
BATCHES = 64
MID_BATCHES = BATCHES - 1  # the mid-stream checkpoint: RAM tiers partly full
PROBES = 1 << 21
PARITY_PROBES = 1 << 22
PROBE_REPS = 5  # timed probe calls per probe set; their median is reported
SEED = RATIO  # bench_ssd seeds its generator with the ratio

# bench_ssd's Bloom geometry: k = 12, m = n * k / ln 2, 32 KiB BBF blocks
BLOOM_K = 12
BLOCK_BITS = 4096 * 8 * 8
DELETED_BATCHES = 8  # the counting filter deletes the first 8 batches
PAPER_LOOKUPS = 2048  # bench_ssd's lookup sets

# the frozen tier: at ram_q = 24 a frozen level 3 would need 2**15 fuse
# segments or more, which the 32-bit start mix refuses, so levels = 3
FROZEN_LEVELS = 3
FROZEN_BELOW = 1  # bench_xor_fuse.py's value: level 1 frozen at load 0.75
XF_KEYS = 1 << 23  # the standalone xor_fuse filter, built at full load
XF_FP_BITS = 14  # level 1's cell width (cost_model.fuse_fp_bits_for(13))

# phase inram: bench_inram.py's Table 1(a) with its container scale undone as
# far as int32 positions allow (q = 26; the paper has 2**31 buckets)
INRAM_Q = 26
INRAM_CASES = ((1 / 64, 6), (1 / 512, 9), (1 / 4096, 12))  # (fp rate, r)
INRAM_INSERT_BATCH = 1 << 22  # bench_inram's 2**14, times 2**8
INRAM_LOOKUP_BATCH = 1 << 24  # its 2**16, times 2**8
TIMED_REPS = 5  # timed calls per measurement; their median is reported

# phase resize: bench_incremental.py's experiment with its geometry scaled
# by 2**8 to the main path's q = 24
INC_Q = RAM_Q
INC_CHUNK = 61440  # 240 * 2**8: the growth window stays about 205 batches
INC_BATCH = 2048  # 8 * 2**8
INC_BUF_Q = 20  # 12 + 8
INC_REPS = 4  # replays per variant; each call's minimum is kept
INC_CHECK_EVERY = 16  # calls between no-false-negative checks
RESTRUCTURE_BATCHES = 8  # fresh batches inserted while a restructure migrates

# phase steady: bench_steady_state.py with its geometry scaled by 2**8
# (Q 16 -> 24, P 30 -> 38, every batch, chunk and buffer 2**8 larger)
STEADY_Q = 24
STEADY_P = 38
STEADY_BATCH = 2048  # 8 * 2**8 keys an op
STEADY_CHUNK = 131072  # 512 * 2**8: the steady settle chunk
STEADY_BUF_Q = 18  # 10 + 8
STEADY_RAM_Q = 19  # 11 + 8: buffered_qf's RAM QF and the cascades' Q0
STEADY_PREFILL_CHUNK = 262144  # 1024 * 2**8
STEADY_N_OPS = 192  # ops a replay, as the bench
STEADY_REPS = 3  # replays; each call keeps its minimum
STEADY_PREFILL = 0.7  # warm-start load of the flat table
STEADY_SEED = 11
STEADY_BAR = 0.20  # the bench's ceiling on p99ratio_steady_insert
STEADY_SYNC_INSERTS = 40  # steady inserts run under the sync debug mode

# phase consumers: the dedup pipeline and the prefix cache at q = 24
CONSUMER_Q = 24
CONSUMER_P = 39
CONSUMER_CHUNK = 262144  # PipelineConfig's 1024 * 2**8
CONSUMER_DIGESTS = 65536  # 256 * 2**8 digests a _dedup call
CONSUMER_FILL = 1.1  # digests fed, over the q = 24 table's capacity
CACHE_R = 15
CACHE_PREFILL = 0.7
CACHE_BATCH = 4096  # prompts a request batch
CACHE_PROMPT = 24  # tokens a prompt
CACHE_REQUESTS = 16
CACHE_EVICTED = 2  # request batches whose new prompts are evicted

# phase sharded: phase 3's stream into a quotient-prefix sharded QF of
# p = 39 bits, eight shards of local q = 24 held equal to one flat q = 27 QF
SHARD_Q = 27
SHARDS = 8
SHARD_MERGE_KEYS = 1 << 23  # the second filter of the merge
SHARD_MERGE_BATCH = 1 << 20
SHARD_SOLO_KEYS = 1 << 20  # the n_shards = 1 filter under device=None
SHARD_REFUSED = dict(q=24, r=29, n_shards=8)  # local r = 29 + 3 = 32

# phase ssd_large: bench_ssd's 1:24 experiment, ratio-true at RAM_Q = 22 (at
# 24, 1:24 needs 5.2 G Bloom cells: past the 32-bit double hash and int32
# cell indices); p = RAM_Q + 15, as bench_ssd's 26 at its RAM_Q = 11
LARGE_RATIO = 24
LARGE_RAM_Q = 22
PAPER_CF_OVER_BQF = 1.26  # bench_ssd's "paper large" insert crossover

# phase figures: bench_fprate (Figs 1/2), bench_clusters (Fig 4),
# bench_occupancy (Fig 6) and bench_fanout (Fig 9), scaled up.  The
# fingerprint's top 32 bits are a bijection of the 32-bit key, so at
# q + r >= 32 no two keys collide: q = 19 is the largest q at which every r
# of bench_fprate (up to 12) still sees false positives.
FP_Q = 19  # bench_fprate's 14, times 2**5 in keys
FP_PROBES = 1 << 22  # its 400,000, scaled; the members among them removed
CLUSTER_Q = 24  # bench_clusters' 16, times 2**8
OCC_Q = 24  # bench_occupancy's 16, times 2**8
OCC_BATCH = 1 << 21  # its 2**13
OCC_PROBES = 1 << 22  # its 2**14
FANOUT_RAM_Q = 20  # bench_fanout's 10, 26 and 40,000, times 2**10 in keys
FANOUT_P = 36  # RAM_Q + 16, as the bench's 26 at its RAM_Q = 10
FANOUT_N = 40_960_000
FANOUT_STEP = 524_288  # its 512
FANOUT_LOOKUPS = 1 << 21  # its 2048
FANOUT_SAMPLE = 1 << 20  # inserted keys probed for false negatives
SHIM_Q = 12  # the shims' RAM QF, run on the card and on the CPU
SHIM_P = 30
SHIM_BATCH = 1024
SHIM_BATCHES = 40

# phase serve: the LLM serving path (launch/serve.py's defaults)
SERVE_ARCH = "qwen3-8b"  # served at full width, bf16
SERVE_SMOKE_ARCHS = ("qwen3-8b", "deepseek-7b", "gemma-7b", "starcoder2-15b", "qwen2-vl-7b")
SERVE_MOE_SMOKE_ARCHS = ("deepseek-v2-lite-16b", "grok-1-314b")  # phase serve_moe
SERVE_SMOKE_STEPS = 8  # greedy decode steps, card against CPU
SERVE_REQUESTS, SERVE_PROMPT_LEN, SERVE_GEN = 16, 64, 16
SERVE_LONG = (2, 4096)  # a prefill on the chunked attention path: S > 2048, S % 512 == 0
SERVE_DECODE_STEPS = 16  # timed decode steps
SERVE_REPS = 3  # timed prefills; their median is reported
SERVE_PROFILED_STEPS = 2  # decode steps under torch.profiler, for the device's busy share
SERVE_RTOL = 1e-4  # float32 logits and K/V, card against CPU (tests/test_torch_models.py)
SERVE_BF16_BOUND = 0.125  # bf16 decode against the full forward, max|d| / max|logit| (PERF.md §2)
SERVE_MOE_ARCH = "deepseek-v2-lite-16b"  # phase 18, at full width and depth, bf16
SERVE_MOE_PARAMS = 15_706_484_224  # its schema's count
SERVE_GROK_LAYERS = 2  # grok-1-314b at full width, 2 of its 64 layers
SERVE_RECURRENT_SMOKE_ARCHS = ("mamba2-130m", "recurrentgemma-9b", "whisper-large-v3")
SERVE_RECURRENT_PARAMS = {  # phase 19, each at full width and depth: its schema's count
    "mamba2-130m": 128_983_488,
    "recurrentgemma-9b": 9_396_408_320,
    "whisper-large-v3": 1_608_360_960,
}
SERVE_WHISPER_ENCODER_PARAMS = 631_232_000
SERVE_WHISPER_LONG = (2, 3584)  # chunked prefill whose forward over S + 1 fits max_seq 4,096

# phase train: the training path (launch/train.py, train/, model.loss_fn)
TRAIN_SMOKE_ARCHS = ("qwen3-8b", "deepseek-v2-lite-16b", "mamba2-130m", "recurrentgemma-9b",
                     "whisper-large-v3")  # one of each family
TRAIN_SMOKE_STEPS = 2  # make_train_step steps, card against CPU (float32)
TRAIN_RTOL = 1e-4  # the step's loss, card against CPU (tests/test_torch_train.py)
TRAIN_GRAD_RTOL = 1e-3  # grad_norm and the moments, each leaf
TRAIN_ARCH = "mamba2-130m"  # examples/train_e2e.py's model, at full width and depth
TRAIN_BATCH, TRAIN_SEQ = 8, 512  # examples/train_e2e.py's batch
TRAIN_STEPS, TRAIN_RESUMED_STEPS, TRAIN_CKPT_EVERY = 12, 16, 4
TRAIN_SYNC_CALL = 3  # the driver's step call run under the sync debug mode
TRAIN_MB_ARCH, TRAIN_MB_LAYERS = "qwen3-8b", 4  # full width, 36 -> 4 layers (2.0 B params)
TRAIN_MB_SHAPE = (4, 1024)  # (B, S)
TRAIN_MB_STEPS, TRAIN_MICROBATCHES = 3, 2
TRAIN_BF16_LOSS_RTOL = 1e-2  # bf16 step loss against a float32 cross entropy of forward
DEDUP_Q = 16  # PipelineConfig.dedup_ram_q: the dedup cascade's Q0 builds

# 21. tools: the dry-run grid, cells run for real, the op audit on the card
TOOLS_MESHES = ("1x1", "16x16")
# the 16 x 16 cells that run placed: those whose placement failed before the
# head views, the microbatch split and the SSD's views were repaired, and
# every decode cell (the whole placed grid added 105-175 s to the phase on
# the card's host; it is a CLI run, PERF.md)
TOOLS_REPAIRED = (("qwen3-8b", "prefill_32k"), ("qwen3-8b", "train_4k"),
                  ("starcoder2-15b", "prefill_32k"), ("starcoder2-15b", "train_4k"),
                  ("grok-1-314b", "prefill_32k"), ("qwen2-vl-7b", "prefill_32k"),
                  ("whisper-large-v3", "prefill_32k"), ("deepseek-v2-lite-16b", "train_4k"),
                  ("grok-1-314b", "train_4k"), ("qwen2-vl-7b", "train_4k"),
                  ("recurrentgemma-9b", "train_4k"), ("whisper-large-v3", "train_4k"),
                  ("mamba2-130m", "train_4k"))
TOOLS_MULTI_POD = ("qwen3-8b", "decode_32k")  # the one cell placed on 2 x 16 x 16
TOOLS_JOBS = 6  # dry-run worker processes; the card's host has 8 cores
TOOLS_HEADROOM = 0.8  # a decode cell runs if args + step estimate <= 80% of 80 GiB
TOOLS_STEPS = 8  # timed decode steps a real cell
TOOLS_AUDIT_KERNELS = ("fingerprint", "qf_positions", "qf_build_planes", "qf_probe",
                       "cascade_probe")
ALLOC_ROUND = 512  # the caching allocator rounds a request up to 512 bytes

# phase examples: the four examples of repro_torch.examples
EXAMPLE_KERNELS = ("fingerprint", "qf_positions", "qf_build_planes", "qf_probe")
EXAMPLE_INTS = {  # each example's integers, held equal on the card and the CPU
    "quickstart": ("qf_n_after_delete", "bqf_flushes", "cf_levels", "cf_merges",
                   "auto_grow_q", "auto_grow_n"),
    "dedup_pipeline": ("docs_seen", "docs_kept", "docs_dropped", "digests", "levels",
                       "merges"),
    "serve_prefix_cache": ("remote_probes_naive", "remote_probes_with_filter"),
}
TRAIN_E2E_STEPS = 2  # phase 20 trains train_e2e's configuration at length

# phase mesh: placement on a 1 x 1 ("data", "model") mesh over an NCCL group
MESH_ARCH = "qwen3-8b"  # full width and depth for the decode, as phase 17
MESH_DECODE_SHAPE = (16, 64)  # the prefill; decode at B = 16
MESH_DECODE_STEPS = 8  # timed greedy steps, placed and unplaced
MESH_LOGIT_BOUND = 2.0 ** -8  # bf16 placed logits against unplaced, max|d| / max|ref|
MESH_LOSS_RTOL = 1e-3  # the placed train step's loss against the unplaced step's
MESH_REFUSED = (1, 2)  # a mesh of two devices on one card
MESH_MOE_ARCH = "deepseek-v2-lite-16b"  # MoE + MLA: full width and depth for the decode
MESH_MOE_TRAIN_LAYERS = 2  # the dense first layer and one MoE unit (1.08 B params)
MESH_STATE_ARCHS = SERVE_RECURRENT_SMOKE_ARCHS  # phase 19's archs: full width and depth, decode
MESH_FAN_IN_ARCHS = (MESH_MOE_ARCH,) + MESH_STATE_ARCHS  # decoded at their true fan-in
MESH_COMBINE_ITERS = 20  # timed calls of each MoE combine


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(got, want, chunk: int = 1 << 26) -> int:
    """Largest absolute difference over paired outputs, as integers.

    Taken over flat chunks, so that a plane of a billion cells needs no
    int64 copy of its own size.
    """
    worst = 0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        a, b = a.reshape(-1), b.reshape(-1)
        for i in range(0, a.numel(), chunk):
            d = a[i : i + chunk].to(torch.int64) - b[i : i + chunk].to(torch.int64)
            worst = max(worst, int(d.abs().max()))
    return worst


def uint32_keys(rng, n, device, lo=0):
    """The benches' ``keys_u32``: uniform uint32 keys in [lo, 2**32) from
    ``rng``, on ``device``."""
    keys = rng.integers(lo, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    return torch.from_numpy(keys.view(np.int32)).to(device)


def sorted_stream(cfg, keys):
    fq, fr = qf.fingerprints(cfg, keys)
    return qf._pad_sort(fq, fr, torch.ones_like(fq, dtype=torch.bool))


def kernel_row(name, source, replaces, err, ms, plain_ms, bound_bytes, library_ms):
    return {
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/csrc/{source}",
        "replaces": replaces,
        "max_abs_err": err,
        "bit_exact": err == 0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": roofline.kernel_roofline(bound_bytes).t_memory * 1e3,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }


def walk_spans(planes, fq, fr):
    """The slots each probe's cluster walk (``csrc/qf_walk.cuh``) reads.

    The paper's Fig. 3 walk, one step of every live query at a time:
    back to the cluster's start, count the occupied buckets up to the
    quotient, forward to that run, compare remainders.  Returns
    ``(present, first, last, run)``: the walk's answer, each query's span
    of slots (``first == last == fq`` where the bucket is empty; ``last``
    stops at the last slot, where a walk of an overflowed state would run
    off the planes), and the slot where its run starts, the first whose
    remainder it compares (``first`` where the bucket is empty, the
    number of slots where the walk ran off the planes before it).  It
    serves only the bound's byte and sector counts.
    """
    rem, occ, shf, con = planes
    t = rem.shape[0]
    dev = fq.device
    fq = fq.to(torch.int64)
    B = fq.shape[0]
    present = torch.zeros(B, dtype=torch.bool, device=dev)
    live = torch.arange(B, device=dev)[(fq >= 0) & (fq < t)]
    live = live[occ[fq[live]]]

    b = fq.clone()  # 1. back to the last unshifted slot
    a = live
    while a.numel():
        a = a[(b[a] > 0) & shf[b[a]]]
        b[a] -= 1
    R = torch.zeros(B, dtype=torch.int64, device=dev)  # 2. occupied in [b, fq]
    j = b.clone()
    a = live
    while a.numel():
        R[a] += occ[j[a]]
        a = a[j[a] < fq[a]]
        j[a] += 1
    s = b.clone()  # 3. forward to the start of the R-th run
    c = torch.ones(B, dtype=torch.int64, device=dev)
    off = torch.zeros(B, dtype=torch.bool, device=dev)
    a = live[R[live] > 1]
    while a.numel():
        s[a] += 1
        end = s[a] >= t
        off[a[end]] = True
        a = a[~end]
        sa = s[a]
        c[a] += ((occ[sa] | shf[sa]) & ~con[sa]).to(torch.int64)
        a = a[c[a] < R[a]]
    run = s.clone()
    fr32 = fr.to(torch.int32)  # 4. compare remainders along the run
    a = live[~off[live]]
    while a.numel():
        hit = rem[s[a]] == fr32[a]
        present[a[hit]] = True
        a = a[~hit]
        s[a] += 1
        a = a[s[a] < t]
        a = a[con[s[a]]]
    return present, b, s.clamp(max=t - 1), run


def walked_bytes(planes, fq, fr) -> int:
    """Bytes the cluster walks of these queries must read, each slot once.

    The three metadata planes over the union of the walked spans, plus
    the ``occ`` byte of each distinct empty bucket probed.  The ``rem``
    bytes of the runs compared are left out, so this is a lower bound.
    """
    occ = planes[1]
    t = occ.shape[0]
    _, first, last, _ = walk_spans(planes, fq, fr)
    fq = fq.to(torch.int64)
    walked = occ[fq]
    one = torch.ones(int(walked.sum()), dtype=torch.int32, device=fq.device)
    diff = torch.zeros(t + 1, dtype=torch.int32, device=fq.device)
    diff.index_add_(0, first[walked], one)
    diff.index_add_(0, last[walked] + 1, -one)
    covered = int((torch.cumsum(diff, 0)[:t] > 0).sum())
    empty_buckets = int(torch.unique(fq[~walked]).numel())
    return 3 * covered + empty_buckets


def i32(x):
    """int64 fingerprints as the kernels take them: the low 32 bits, int32."""
    return x.to(torch.int32)


def canonical_queries(cfg, keys):
    """Keys hashed once in the cascade's canonical split, as int32 (fq, fr, r)."""
    qc, rc = fuse.canonical_split(cfg.p)
    canon = qf.QFConfig(q=qc, r=rc, slack=0, seed=cfg.seed)
    fq, fr = qf.fingerprints(canon, keys)
    return i32(fq), i32(fr), rc


# ---------------------------------------------------------------------------
# phases 1 and 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def bloom_probe_cases(rng, cells, device):
    """Small ``bloom_probe`` inputs that reach every branch of its kernel.

    At k = 3, 4, 12 and 13 (ragged and whole groups), 300 rows (not a
    multiple of the 256-thread block), half of them drawn from set cells
    (every group read) and half uniform (an early stop); and the k = 12
    rows once more as a contiguous view that starts 4 bytes past an
    allocation (so off every 8- and 16-byte boundary).
    """
    ncells = cells.shape[0]
    set_cells = torch.nonzero(cells).flatten().cpu().numpy()
    out = []
    for k in (3, 4, 12, 13):
        rows = np.concatenate([
            rng.choice(set_cells, (150, k)), rng.integers(0, ncells, (150, k))
        ])
        idx = torch.from_numpy(rows.astype(np.int32)).to(device)
        out.append(idx)
        if k == 12:
            out.append(torch.cat([idx.new_zeros(1), idx.flatten()])[1:].view(idx.shape))
    return out


def cascade_case(planes, nn, cfg, device):
    """32 levels over one small table: live (its count), stale (its planes,
    count 0) and empty (zero planes, count 0) in turn, the last one live."""
    empty = tuple(torch.zeros_like(p) for p in planes)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    kinds = [("live", "stale", "empty")[lvl % 3] for lvl in range(31)] + ["live"]
    level_planes = [empty if k == "empty" else planes for k in kinds]
    level_n = [nn if k == "live" else zero for k in kinds]
    return level_planes, level_n, [cfg.r] * 32


def build_cases(device):
    """Small ``qf_build_planes`` inputs that reach every branch of its kernel.

    Returns ``(label, args)`` pairs.  A q = 13 table at load 0.95 with a
    run of 40 items at bucket 4070, so that a cluster and a run cross the
    first 4096-slot tile's end, on 9216 slots (not a multiple of 4096);
    the same items with fewer valid and with none valid; and items
    packed at the end of a table with 16 slots of slack, the last ones
    dropped past the last slot.
    """
    rng = np.random.default_rng(5)
    out = []

    def stream(cfg, fq):
        fq = np.sort(fq)
        fr = rng.integers(0, 1 << cfg.r, fq.shape[0])
        o = np.lexsort((fr, fq))
        fq = torch.from_numpy(fq[o]).to(device)
        fr = torch.from_numpy(fr[o]).to(device)
        nn, _, pos, _ = qf.probe_positions(cfg, fq, fq.shape[0])
        return i32(pos), i32(fq), i32(fr), nn

    cfg = qf.QFConfig(q=13, r=10)
    fq = np.concatenate([rng.integers(0, cfg.m, int(0.95 * cfg.m) - 40), [4070] * 40])
    pos, fq, fr, nn = stream(cfg, fq)
    t = cfg.total_slots
    out.append(("load 0.95, across a tile's end", (pos, fq, fr, nn, t)))
    out.append(("fewer valid than items", (pos, fq, fr, nn - 1000, t)))
    out.append(("none valid", (pos, fq, fr, nn * 0, t)))
    cfg = qf.QFConfig(q=13, r=10, slack=16)
    pos, fq, fr, nn = stream(cfg, rng.integers(cfg.m - 700, cfg.m, 760))
    out.append(("items dropped past the last slot", (pos, fq, fr, nn, cfg.total_slots)))
    return out


def span_args(cfg, fq, fr, start, span, k, device):
    """A partly built table and the next span's ``qf_build_span`` inputs.

    The table holds the sorted stream's first ``start`` items (appended by
    ``ops.build_span``); the span is the next ``span`` items, padded with
    sentinels past the stream's end, the first ``k`` valid.  Returns
    ``(args, planes)``: ``args`` the wrapper's
    ``(fq, fr, k, n, overflow, last_pos, last_fq)`` as ``ops.build_span``
    hands them over, ``planes`` the table's four planes.
    """
    st = qf.empty(cfg, device)
    lp = torch.full((), -1, dtype=torch.int32, device=device)
    lf = lp.clone()
    if start:
        st, lp, lf = ops.build_span(cfg, st, fq[:start], fr[:start], start, lp, lf)
    def pad(x, v):
        return torch.cat([x[start : start + span], x.new_full((span,), v)])[:span]

    seg_q, seg_r = pad(fq, qf.INT32_MAX), pad(fr, qf.UINT32_MAX)
    kk = torch.full((), k, dtype=torch.int32, device=device)
    args = (seg_q, seg_r, kk, st.n, st.overflow, lp, lf)
    return args, (st.rem, st.occ, st.shf, st.con)


def span_cases(device):
    """Small ``qf_build_span`` inputs that reach every branch of its kernel.

    Returns ``(label, args, planes, want)``: ``args`` and ``planes`` as
    ``span_args`` gives them, and ``want`` the planes, ``n`` and
    ``overflow`` that ``quotient_filter.build_sorted`` gives for the
    stream's items up to the span's last valid one, which the append must
    equal.  On a q = 13 table at load 0.95 with a run of 40 items at
    bucket 4070: a span of 1,000 right after 3,000 appended items; a span
    that starts inside a
    run (its first quotient is the carried ``last_fq``); ``k = 0``; ``k``
    the whole span (1,001 items, not a multiple of the 256-thread block);
    and a span of 4,096 from item 0.  On a q = 15 table whose 20,000 items
    share bucket 100: a span of two scan tiles and one row that starts
    inside that one cluster, so its scan and its carry cross tiles.  On a table with 16 slots of slack packed at its end: the last
    items dropped past the last slot.
    """
    rng = np.random.default_rng(7)

    def stream(cfg, fq):
        fq = np.sort(fq)
        fr = rng.integers(0, 1 << cfg.r, fq.shape[0])
        o = np.lexsort((fr, fq))
        return (torch.from_numpy(a[o]).to(device) for a in (fq, fr))

    out = []

    def case(label, cfg, fq, fr, start, span, k):
        args, planes = span_args(cfg, fq, fr, start, span, k, device)
        n = start + k
        want = qf.build_sorted(cfg, fq[:n], fr[:n], n)
        out.append((label, args, planes, (want.rem, want.occ, want.shf, want.con,
                                          want.n, want.overflow)))

    cfg = qf.QFConfig(q=13, r=10)
    fq, fr = stream(cfg, np.concatenate(
        [rng.integers(0, cfg.m, int(0.95 * cfg.m) - 40), [4070] * 40]
    ))
    inside = int(torch.nonzero(fq[1:] == fq[:-1])[200]) + 1  # fq[i] == fq[i - 1]
    run = int(torch.nonzero(fq == 4070)[20])  # the middle of the run of 40
    case("right after 3000 appended items", cfg, fq, fr, 3000, 1000, 1000)
    case("first quotient continues last_fq", cfg, fq, fr, inside, 700, 700)
    case("inside the run of 40 across a tile's end", cfg, fq, fr, run, 300, 300)
    case("k = 0", cfg, fq, fr, 5000, 512, 0)
    case("k the whole span", cfg, fq, fr, 2000, 1001, 1001)
    case("from item 0, fewer valid than the span", cfg, fq, fr, 0, 4096, 3333)
    cfg = qf.QFConfig(q=15, r=10)
    fq, fr = stream(cfg, np.full(20000, 100))
    span = 2 * qf_build.SCAN_TILE + 1
    case("one cluster across tiles, from inside it", cfg, fq, fr, 1500, span, span)
    cfg = qf.QFConfig(q=13, r=10, slack=16)
    fq, fr = stream(cfg, rng.integers(cfg.m - 700, cfg.m, 760))
    case("items dropped past the last slot", cfg, fq, fr, 300, 460, 460)
    return out


def scan_cases(device):
    """Small ``qf_positions`` inputs that reach every branch of its scan.

    Returns ``(label, (fq, n, total))``, ``fq`` sorted.  The scan works in
    tiles of ``qf_build.SCAN_TILE`` rows and looks back over 32 tiles at a
    time: one cluster over 100 tiles (every row's quotient 7), so each tile
    but the first takes its prefix from a look-back that may cross several
    windows; a stream packed at the end of its slots (overflow); none
    valid; fewer valid than rows; sizes of a tile and one row either side;
    one row.
    """
    rng = np.random.default_rng(9)
    tile = qf_build.SCAN_TILE

    def uniform(rows, buckets):
        return torch.from_numpy(np.sort(rng.integers(0, buckets, rows))).to(device)

    big = torch.full((100 * tile + 7,), 7, dtype=torch.int64, device=device)
    packed = uniform(3000, 100) + 1000
    out = [
        ("one cluster over 100 tiles", (big, big.shape[0], 101 * tile)),
        ("overflow past the last slot", (packed, 3000, 2500)),
        ("n = 0", (uniform(5000, 6000), 0, 7024)),
        ("fewer valid than rows", (uniform(9000, 9000), 6000, 10024)),
        ("tile - 1", (uniform(tile - 1, 2 * tile), tile - 1, 2 * tile + 1024)),
        ("tile", (uniform(tile, tile), tile, tile + 1024)),
        ("tile + 1", (uniform(tile + 1, tile), tile + 1, tile + 1024)),
        ("one row", (uniform(1, 16), 1, 16)),
    ]
    return [
        (label, (i32(fq), torch.tensor(n, dtype=torch.int32, device=device), t))
        for label, (fq, n, t) in out
    ]


def probe_cases(device, build_args):
    """Small ``qf_probe`` inputs that reach every branch of its kernels.

    Returns ``(label, planes, fq, fr)``.  On the load-0.95 table of
    ``build_cases`` (9216 slots, clusters across 32-slot words): its
    items (in their sorted order) and uniform keys, shuffled; 1000 of
    them twice over (duplicates; 2000 queries, not a multiple of the
    256-thread block); quotients below 0 and at or past the last slot;
    no query.  On a q = 12 table with a run of 600 slots, walks of many
    words, forward from bucket 1000 and back from 1500.  The first table
    again, each plane a view one element past a 16-byte boundary (the
    pack's unaligned loads).  On a q = 14 table, 300 uniform queries:
    sparse, so the wrapper walks the byte planes.  And a state whose
    ``overflow`` flag is set on 34 slots (a ragged last word), where
    walks run off the end of the planes.
    """
    rng = np.random.default_rng(6)
    pos, fq, fr, nn, t = build_args
    planes = qf_build.qf_build_planes(pos, fq, fr, nn, t)
    n = int(nn)
    fq_u = torch.from_numpy(rng.integers(0, t, n)).to(device)
    fr_u = torch.from_numpy(rng.integers(0, 1 << 10, n)).to(device)
    perm = torch.from_numpy(rng.permutation(2 * n)).to(device)
    mq, mr = torch.cat([fq[:n], i32(fq_u)])[perm], torch.cat([fr[:n], i32(fr_u)])[perm]
    edge = torch.tensor(
        [-1, -(2**31), t, t + 100, 2**31 - 1, 0, t - 1], dtype=torch.int32, device=device
    )
    out = [
        ("unsorted members and uniform", planes, mq, mr),
        ("duplicates", planes, mq[:1000].repeat(2), mr[:1000].repeat(2)),
        ("quotients off the planes", planes, edge, edge),
        ("no query", planes, mq[:0], mr[:0]),
    ]
    # a run of 600 at bucket 1000 on a q = 12 table: walks across many
    # 32-slot words, forward from bucket 1000 and back from 1500
    cfg = qf.QFConfig(q=12, r=10)
    lq = np.sort(np.concatenate([rng.integers(0, cfg.m, 1500), [1000] * 600]))
    lr = rng.integers(0, 1 << 10, lq.shape[0])
    lr[lq == 1000] = np.arange(600)
    o = np.lexsort((lr, lq))
    lq, lr = (torch.from_numpy(a[o]).to(device) for a in (lq, lr))
    nn, _, lpos, _ = qf.probe_positions(cfg, lq, lq.shape[0])
    long_run = qf_build.qf_build_planes(i32(lpos), i32(lq), i32(lr), nn, cfg.total_slots)
    fwd = torch.full((300,), 1000, dtype=torch.int32, device=device)
    back = torch.full((300,), 1500, dtype=torch.int32, device=device)
    tail = torch.arange(300, 600, dtype=torch.int32, device=device)
    out.append(("a run of 600, forward", long_run, fwd, tail))
    out.append(("a run of 600, back", long_run, back, tail))
    shifted = tuple(torch.cat([x[:1], x])[1:] for x in planes)
    out.append(("planes off a 16-byte boundary", shifted, mq, mr))
    cfg = qf.QFConfig(q=14, r=10)
    keys = uint32_keys(rng, int(0.75 * cfg.m), device)
    state = qf.insert(cfg, qf.empty(cfg, device), keys)
    wide = (state.rem, state.occ, state.shf, state.con)
    q14, r14 = qf.fingerprints(cfg, torch.cat([keys[:150], uint32_keys(rng, 150, device)]))
    out.append(("sparse queries", wide, i32(q14), i32(r14)))
    cfg = qf.QFConfig(q=5, r=8, slack=2)
    keys = uint32_keys(rng, 60, device)
    state = qf.insert(cfg, qf.empty(cfg, device), keys)
    if not bool(state.overflow):
        raise AssertionError("the overflow case's state did not overflow")
    q5, r5 = qf.fingerprints(cfg, torch.cat([keys, uint32_keys(rng, 60, device)]))
    out.append(("overflowed state", (state.rem, state.occ, state.shf, state.con),
                i32(q5), i32(r5)))
    return out


def fingerprint_grid(device) -> None:
    """``fingerprint`` against its plain version on 1,004 int32 keys (half
    with the high bit set, and the edges) and 1,003 int64 keys (their high
    words set), for every (q, r) with 1 <= q <= 30 and 1 <= r <= 32, seeds
    0, 5 and 2**31 - 1, into int32 and into int64: 23,040 launches."""
    rng = np.random.default_rng(3)
    k32 = np.concatenate([rng.integers(-(2**31), 2**31, 1000),
                          [0, -1, 2**31 - 1, -(2**31)]])
    k64 = np.concatenate([rng.integers(-(2**62), 2**62, 1000),
                          [2**32, -1, 2**40 + 5]])
    keysets = [torch.from_numpy(k32.astype(np.int32)).to(device),
               torch.from_numpy(k64.astype(np.int64)).to(device)]
    cases, bad = [], []
    for seed in (0, 5, 2**31 - 1):
        for q in range(1, 31):
            for r in range(1, 33):
                for keys in keysets:
                    want = fingerprint.fingerprint_plain(keys, q, r, seed, torch.int64)
                    for dtype in (torch.int32, torch.int64):
                        got = fingerprint.fingerprint(keys, q, r, seed, dtype)
                        same = [torch.equal(g, w.to(dtype)) for g, w in zip(got, want)]
                        cases.append((seed, q, r, keys.dtype, dtype))
                        bad.append(not all(same))
    if any(bad):
        raise AssertionError(
            f"fingerprint disagrees with its plain version at (seed, q, r, key "
            f"dtype, out dtype) {cases[bad.index(True)]}"
        )


def fuse_cases(device) -> list:
    """Small ``fuse_probe`` inputs: a frozen filter of 180 keys at p = 39
    (its peel runs on the card too) for each cell width 1, 8, 14 and 28,
    probed with its keys and 180 others at its own seed (a tensor; its keys
    must all hit) and at seeds 0, 5 and 2**31 - 1 (host ints) and 12345 (a
    tensor).  Returns ``(label, got, want)`` checks."""
    keys = uint32_keys(np.random.default_rng(1), 360, device)
    out = []
    for fp_bits in (1, 8, 14, 28):
        fcfg = fuse.make_config(180, p=P_BITS, fp_bits=fp_bits)
        fstate = fuse.freeze_keys(fcfg, keys[:180])
        fq, fr = map(i32, fuse.key_fingerprints(fcfg, keys))
        geometry = (fcfg.segment_length, fcfg.segment_count, fp_bits)
        other = torch.full((), 12345, dtype=torch.int32, device=device)
        for seed in (fstate.fuse_seed, 0, 5, 2**31 - 1, other):
            args = (fstate.table, fq, fr, seed, *geometry)
            got = fuse_probe.fuse_probe(*args)
            label = f"fuse_probe (fp_bits {fp_bits}, seed {int(seed)})"
            out.append((label, (got,), (fuse_probe.fuse_probe_plain(*args),)))
            if seed is fstate.fuse_seed and not bool(got[:180].all()):
                raise AssertionError(f"{label}: a key of the small frozen filter "
                                     "was lost")
    return out


# qf_decode's edge cases (``decode_case``), each at every size of
# ``decode_sizes``; the CPU tests hold its plain version to the JAX package
# on them
DECODE_CASES = ("empty", "load 0.75", "a cluster across a tile edge",
                "a whole-table cluster", "overflowed", "run_id 0 and past the last bucket")


def decode_sizes() -> dict:
    """Table sizes at the decode's tile edges, and one of several tiles."""
    tile = qf_decode.DECODE_TILE
    return {"tile - 1": tile - 1, "tile": tile, "tile + 1": tile + 1,
            "3 tiles + 5": 3 * tile + 5}


def planes_of(fq, total: int):
    """The planes the build's plain versions write for sorted int64
    quotients, every row valid, with uniform 32-bit remainders; rows whose
    position falls past the last slot are dropped."""
    g = torch.Generator(device=fq.device).manual_seed(fq.shape[0])
    fr = torch.randint(-(2**31), 2**31 - 1, fq.shape, generator=g, device=fq.device,
                       dtype=torch.int32)
    n = torch.tensor(fq.shape[0], dtype=torch.int32, device=fq.device)
    pos, _ = qf_build.positions_plain(i32(fq), n, total)
    return qf_build.build_planes_plain(pos, i32(fq), fr, n, total)


def decode_case(label: str, total: int, device):
    """``(rem, occ, shf, con)`` of ``total`` slots for one of ``DECODE_CASES``.

    ``load 0.75`` draws uniform quotients; the tile-edge cluster puts 500
    rows on one bucket 250 slots before a tile edge (a chunk edge where the
    table has one tile) over a half-loaded table; the whole-table cluster
    gives row i the quotient i // 2, one cluster over every slot; the
    overflowed table heaps 400 rows 100 slots before its end; the last case
    is random planes, not a built table: slot 0 a continuation before any
    run start (run id 0), and more run starts than occupied buckets.
    """
    rng = np.random.default_rng([DECODE_CASES.index(label), total])

    def quotients(*parts):
        return planes_of(torch.from_numpy(np.sort(np.concatenate(parts))).to(device), total)

    def uniform(k, hi):
        return rng.integers(0, hi, k)

    if label == "empty":
        return planes_of(torch.zeros(0, dtype=torch.int64, device=device), total)
    if label == "load 0.75":
        return quotients(uniform(3 * total // 4, total - total // 8))
    if label == "a cluster across a tile edge":
        tile, chunk = qf_decode.DECODE_TILE, qf_decode.DECODE_CHUNK
        step = tile if total - 400 >= tile else chunk
        edge = (total - 400) // step * step
        return quotients(uniform(total // 2, total - 600), np.full(500, edge - 250))
    if label == "a whole-table cluster":
        return quotients(np.arange(total) // 2)
    if label == "overflowed":
        return quotients(uniform(total // 2, total), np.full(400, total - 100))
    if label == "run_id 0 and past the last bucket":
        occ = rng.random(total) < 0.05
        shf = rng.random(total) < 0.7
        con = shf & (rng.random(total) < 0.6)
        occ[0], shf[0], con[0] = False, True, True
        rem = rng.integers(-(2**31), 2**31, total).astype(np.int32)
        return tuple(torch.from_numpy(a).to(device) for a in (rem, occ, shf, con))
    raise ValueError(f"no decode case {label!r}")


def launch_check(device) -> None:
    """Launch each kernel once on a small filter and hold it to its plain version.

    This also loads every library and module before anything is timed.
    """
    cfg = qf.QFConfig(q=8, r=12)
    fq, fr = sorted_stream(cfg, uint32_keys(np.random.default_rng(0), 180, device))
    nn, _, pos, _ = qf.probe_positions(cfg, fq, 180)
    fq, fr = i32(fq), i32(fr)
    args = (i32(pos), fq, fr, nn, cfg.total_slots)
    planes = qf_build.qf_build_planes(*args)
    qargs = (*planes, fq, fr)
    # the same table twice, one level read in the split (q, r) = (4, 16);
    # then 32 levels, empty and stale ones among the live
    split = (fq >> 4, (fq & 15) << 12 | fr, 16)
    cases = [
        ([planes, planes], [nn, nn], [cfg.r, cfg.r]),
        cascade_case(planes, nn, cfg, device),
    ]
    bidx = torch.cat([i32(fq) & 255, torch.full((9,), 2**31 - 1, device=device)])
    bidx = bidx.to(torch.int32)
    bcells = bloom_block.bloom_count(bidx, 256)
    pcases = bloom_probe_cases(np.random.default_rng(2), bcells > 1, device)
    checks = [
        (f"bloom_probe ({c.dtype}, k = {p.shape[1]})",
         (bloom_block.bloom_probe(c, p),), (bloom_block.bloom_probe_plain(c, p),))
        for c in ((bcells > 1).to(torch.uint8), (bcells - 1).to(torch.int16))
        for p in pcases
    ]
    chits = [cascade_probe.cascade_probe(*c, *split) for c in cases]
    checks += [
        (f"cascade_probe (L = {len(c[0])})", (h,),
         (cascade_probe.cascade_probe_plain(*c, *split),))
        for c, h in zip(cases, chits)
    ]
    checks += [
        ("bloom_count", (bcells,), (bloom_block.bloom_count_plain(bidx, 256),)),
        ("qf_build_planes", planes, qf_build.build_planes_plain(*args)),
        ("qf_probe", (qf_probe.qf_probe(*qargs),), (qf_probe.probe_plain(*qargs),)),
    ]
    bcases = build_cases(device)
    checks += [
        (f"qf_build_planes ({label})", qf_build.qf_build_planes(*a),
         qf_build.build_planes_plain(*a))
        for label, a in bcases
    ]
    for label, p, q, r in probe_cases(device, bcases[0][1]):
        want = (qf_probe.probe_plain(*p, q, r),)
        checks.append((f"qf_probe ({label})", (qf_probe.qf_probe(*p, q, r),), want))
        # each walk, whichever the wrapper picks for this case
        bits = qf_probe.pack_bits(*p[1:])
        checks.append((f"qf_probe's bit walk ({label})",
                       (qf_probe.walk(*p, q, r, bits),), want))
        checks.append((f"qf_probe's byte walk ({label})", (qf_probe.walk(*p, q, r),), want))
    checks += fuse_cases(device)
    for label, args, planes, want in span_cases(device):
        got = tuple(p.clone() for p in planes)
        plain = tuple(p.clone() for p in planes)
        got += qf_build.qf_build_span(*args, *got)
        plain += qf_build.build_span_plain(*args, *plain)
        checks.append((f"qf_build_span ({label})", got, plain))
        checks.append((f"qf_build_span ({label}) against build_sorted", got[:6], want))
    for label, args in scan_cases(device):
        checks.append((f"qf_positions ({label})", qf_build.qf_positions(*args),
                       qf_build.positions_plain(*args)))
    # the edge cases, and two over 100 tiles, whose look-backs cross windows
    many = 100 * qf_decode.DECODE_TILE + 7
    decodes = [(c, n, t) for c in DECODE_CASES for n, t in decode_sizes().items()]
    decodes += [(c, "100 tiles + 7", many) for c in ("load 0.75", "a whole-table cluster")]
    for case, size, total in decodes:
        planes = decode_case(case, total, device)
        checks.append((f"qf_decode ({case}, {size})", qf_decode.qf_decode(*planes),
                       qf_decode.decode_plain(*planes)))
    torch.cuda.synchronize()
    for name, got, want in checks:
        if max_abs_err(got, want) != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    fingerprint_grid(device)
    # of the 32 levels, 0, 3, ..., 30 and 31 are live: every key hits them all
    live = sum(1 << lvl for lvl in range(0, 31, 3)) | 1 << 31
    if not bool((chits[1][:180] == live - 2**32).all()):
        raise AssertionError("cascade_probe: a live level missed, or a dead one hit")


def check_build(device):
    """qf_build_planes at a q = 24 build of 0.75 * 2**24 fingerprints."""
    cfg = qf.QFConfig(q=RAM_Q, r=P_BITS - RAM_Q)
    keys = uint32_keys(np.random.default_rng(SEED), cfg.capacity, device)
    fq, fr = sorted_stream(cfg, keys)
    nn, valid, pos, _ = qf.probe_positions(cfg, fq, cfg.capacity)
    t = cfg.total_slots
    pos, fq, fr = i32(pos), i32(fq), i32(fr)
    args = (pos, fq, fr, nn, t)
    got = qf_build.qf_build_planes(*args)
    err = max_abs_err(got, qf_build.build_planes_plain(*args))
    ms = cuda_ms(lambda: qf_build.qf_build_planes(*args), 10)
    plain_ms = cuda_ms(lambda: qf_build.build_planes_plain(*args), 5)

    # the library's scatter of the same planes: index_put_ into zeroed planes
    slot = torch.where(valid & (pos < t), pos, t)
    bucket = torch.where(valid, fq, t)
    first = torch.arange(fq.shape[0], device=device) > 0
    values = (fr, pos != fq, first & (torch.roll(fq, 1) == fq))
    true = torch.ones((), dtype=torch.bool, device=device)

    def library():
        rem = torch.zeros(t + 1, dtype=torch.int32, device=device)
        occ, shf, con = (
            torch.zeros(t + 1, dtype=torch.bool, device=device) for _ in range(3)
        )
        rem.index_put_((slot,), values[0])
        occ.index_put_((bucket,), true)
        shf.index_put_((slot,), values[1])
        con.index_put_((slot,), values[2])

    library_ms = cuda_ms(library, 10)
    bound_bytes = 3 * 4 * fq.shape[0] + 4 + 7 * t  # pos/fq/fr, n read; planes written
    row = kernel_row(
        "qf_build_planes", "qf_build.cu", "src/repro/kernels/qf_build.py:88",
        err, ms, plain_ms, bound_bytes, library_ms,
    )
    return row, (cfg, got, keys)


def q25_stream(device):
    """What a q = 25 build takes on the main path: a full q = 24 table's
    12,582,912 fingerprints at (25, 14), sorted, then sentinels up to the
    33,555,456 slots of q = 25 (the stream ``grow`` hands ``build_sorted``).
    Returns ``(cfg, fq, fr, n)``, the streams int64."""
    cfg = qf.QFConfig(q=RAM_Q + 1, r=P_BITS - RAM_Q - 1)
    n = qf.QFConfig(q=RAM_Q, r=1).capacity
    fq, fr = sorted_stream(cfg, uint32_keys(np.random.default_rng(SEED), n, device))
    pad = cfg.total_slots - n
    fq = torch.cat([fq, fq.new_full((pad,), qf.INT32_MAX)])
    fr = torch.cat([fr, fr.new_full((pad,), qf.UINT32_MAX)])
    return cfg, fq, fr, n


def check_positions(device, stream):
    """qf_positions over ``q25_stream``, narrowed to int32 as
    ``ops.build_sorted`` hands it over.  Held to its plain version after the first launch and again after the timed
    ones (each launch re-arms the look-back's scratch for the next).  The
    library call is ``torch.cummax`` over the int64 differences, the plain
    path's scan."""
    cfg, fq, _, n = stream
    t = cfg.total_slots
    nn = torch.tensor(n, dtype=torch.int32, device=device)
    fq32 = i32(fq)
    want = qf_build.positions_plain(fq32, nn, t)
    err = max_abs_err(qf_build.qf_positions(fq32, nn, t), want)
    ms = cuda_ms(lambda: qf_build.qf_positions(fq32, nn, t), 20)
    err = max(err, max_abs_err(qf_build.qf_positions(fq32, nn, t), want))
    plain_ms = cuda_ms(lambda: qf_build.positions_plain(fq32, nn, t), 3)
    idx = torch.arange(fq.shape[0], device=device)
    d = torch.where(idx < nn, fq - idx, -qf.INT32_MAX)
    library_ms = cuda_ms(lambda: torch.cummax(d, 0), 3)
    rows = fq.shape[0]
    # the valid rows' fq read (rows past n are not), every row's pos
    # written, n read and overflow written
    bound = n * 4 + rows * 4 + 4 + 1
    log(
        f"  qf_positions of {rows} rows ({n} valid): {ms:.5f} ms, plain "
        f"{plain_ms:.5f} ms, torch.cummax {library_ms:.5f} ms, bound "
        f"{bound / H100_BYTES_PER_S * 1e3:.6f} ms"
    )
    return kernel_row(
        "qf_positions", "qf_build.cu", "src/repro/kernels/ops.py:55",
        err, ms, plain_ms, bound, library_ms,
    )


def check_span(device, stream):
    """qf_build_span at the main path's shapes into a q = 25 table, on the
    int64 streams ``incremental_resize`` hands it: the drain of a full
    q = 24 table's 12,582,912 fingerprints (``finish``'s span, from an
    empty table) and one migration chunk of ``INC_CHUNK`` appended half way
    through it.  The row is the chunk, the per-insert launch; the drain is
    logged and kept beside it.  Held to its plain version (planes and the
    four scalars) after the first launch and after the timed ones, and the
    drain to ``ops.build_sorted`` of the whole stream.  The library call is
    the plain path's ``torch.cummax`` of the span's differences and the
    same four ``index_put_``, on precomputed indices."""
    cfg, sfq, sfr, n = stream
    fq, fr = sfq[:n], sfr[:n]
    t = cfg.total_slots
    err, times = 0, {}
    for label, start, span in (("drain", 0, n), ("chunk", n // 2, INC_CHUNK)):
        args, planes = span_args(cfg, fq, fr, start, span, span, device)
        sq, sr, k, _, _, lp, lf = args
        got = tuple(p.clone() for p in planes)
        plain = tuple(p.clone() for p in planes)
        out = qf_build.qf_build_span(*args, *got)
        want = qf_build.build_span_plain(*args, *plain)
        err = max(err, max_abs_err(got + out, plain + want))
        if label == "drain":
            st = ops.build_sorted(cfg, sfq, sfr, n)
            err = max(err, max_abs_err(got + out[:2], (*st[:4], st.n, st.overflow)))
            del st
        # appending the same span again writes the same bytes: time in place
        ms = cuda_ms(lambda: qf_build.qf_build_span(*args, *got), 20)
        err = max(err, max_abs_err(got + qf_build.qf_build_span(*args, *got),
                                   plain + want))
        plain_ms = cuda_ms(lambda: qf_build.build_span_plain(*args, *plain), 3)
        idx = torch.arange(span, device=device)
        d = torch.where(idx < k, sq - idx, -qf.INT32_MAX)
        pos = idx + torch.maximum(lp + 1, torch.cummax(d, 0).values)
        keep = pos < t  # every item of these spans is valid
        slot = pos[keep]
        bucket = sq
        prev = torch.cat([lf.reshape(1), i32(sq[:-1])])
        values = (i32(sr[keep]), (pos != sq)[keep], (i32(sq) == prev)[keep])
        true = torch.ones((), dtype=torch.bool, device=device)
        rem, occ, shf, con = plain

        def library():
            torch.cummax(d, 0)
            rem.index_put_((slot,), values[0])
            occ.index_put_((bucket,), true)
            shf.index_put_((slot,), values[1])
            con.index_put_((slot,), values[2])

        library_ms = cuda_ms(library, 5)
        # fq/fr read (8 + 8 bytes an item), rem/shf/con of each kept item
        # (6), the occ byte of each distinct bucket, the five scalars read
        # and the four written
        buckets = int(torch.unique_consecutive(sq).numel())
        bound = span * 16 + int(keep.sum()) * 6 + buckets + 17 + 13
        times[label] = (ms, plain_ms, bound, library_ms)
        log(
            f"  qf_build_span {label} of {span} items into {t} slots: {ms:.5f} ms, "
            f"plain {plain_ms:.5f} ms, torch.cummax and four index_put_ "
            f"{library_ms:.5f} ms, bound {bound / H100_BYTES_PER_S * 1e3:.6f} ms"
        )
        del got, plain, planes, rem, occ, shf, con, args, d, pos, slot, values
    ms, plain_ms, bound, library_ms = times["chunk"]
    row = kernel_row(
        "qf_build_span", "qf_build.cu", "src/repro/kernels/qf_build.py:88",
        err, ms, plain_ms, bound, library_ms,
    )
    ms, plain_ms, bound, library_ms = times["drain"]
    row["drain"] = {"ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound / H100_BYTES_PER_S * 1e3, "library_ms": library_ms}
    return row


def decode_configs() -> dict:
    """The tables the benchmark's ingest cells decode (``amqbench/configs``):
    the flat QF's, and the cascade's Q0 and deepest level."""
    cascade = CascadeConfig(ram_q=23, p=38, fanout=2, levels=5)
    return {"q = 29": qf.QFConfig(q=29, r=12, slack=2048),
            "q = 23": cascade.q0_cfg, "q = 28": cascade.level_cfg(4)}


def loaded_table(cfg, device):
    """``cfg``'s table at load 0.75 (its capacity) from uniform fingerprints,
    built on the kernel path."""
    g = torch.Generator(device=device).manual_seed(SEED)
    n = cfg.capacity
    fq = torch.randint(0, cfg.m, (n,), generator=g, device=device)
    fr = torch.randint(0, 1 << cfg.r, (n,), generator=g, device=device)
    fq, fr = qf._pad_sort(fq, fr, torch.ones(n, dtype=torch.bool, device=device))
    return ops.build_sorted(cfg, fq, fr, n)


def check_decode(device):
    """qf_decode at the main path's shapes (``decode_configs``), each table
    at load 0.75: held to its plain version after the first launch and again
    after the timed ones, its launch count grown.  The row is q = 29, the
    flat QF cell's table; every table is logged.  No library call computes
    the decode."""
    row = None
    for label, cfg in decode_configs().items():
        planes = tuple(loaded_table(cfg, device)[:4])
        before = qf_decode.qf_decode.launches
        want = qf_decode.decode_plain(*planes)
        err = max_abs_err(qf_decode.qf_decode(*planes), want)
        ms = cuda_ms(lambda: qf_decode.qf_decode(*planes), 10)
        err = max(err, max_abs_err(qf_decode.qf_decode(*planes), want))
        del want
        plain_ms = cuda_ms(lambda: qf_decode.decode_plain(*planes), 3)
        if qf_decode.qf_decode.launches <= before:
            raise AssertionError(f"qf_decode at {label}: no launch counted")
        torch.cuda.synchronize()
        t = cfg.total_slots
        occupied = int(planes[1].sum())
        bound = 7 * t + 16 * t  # the planes read, both streams written
        scratch = 8 * occupied + 2 * 8 * -(-t // 32)  # buckets, bit words: out and back
        log(f"  qf_decode at {label} ({t} slots, load 0.75, {occupied} buckets "
            f"occupied): {ms:.5f} ms, plain {plain_ms:.5f} ms, bound "
            f"{bound / H100_BYTES_PER_S * 1e3:.6f} ms, with the scratch "
            f"{(bound + scratch) / H100_BYTES_PER_S * 1e3:.6f} ms, error {err}")
        if row is None:
            row = kernel_row(
                "qf_decode", "qf_decode.cu", "src/repro/core/quotient_filter.py:169",
                err, ms, plain_ms, bound, None,
            )
        elif err:
            row["max_abs_err"], row["bit_exact"] = max(err, row["max_abs_err"]), False
        row[f"ms at {label}"] = ms
        row[f"plain ms at {label}"] = plain_ms
        del planes
        torch.cuda.empty_cache()
    return row


def check_probe(device, built):
    """qf_probe: 2**22 probes, half inserted keys and half uniform, on q = 24."""
    cfg, planes, keys = built
    rng = np.random.default_rng(SEED + 1)
    half = PARITY_PROBES // 2
    hits = keys[torch.from_numpy(rng.integers(0, keys.shape[0], half)).to(device)]
    probes = torch.cat([hits, uint32_keys(rng, half, device)])
    fq, fr = qf.fingerprints(cfg, probes)
    fq, fr = i32(fq), i32(fr)
    got = qf_probe.qf_probe(*planes, fq, fr)
    err = max_abs_err([got], [qf_probe.probe_plain(*planes, fq, fr)])
    if not bool(got[:half].all()):
        raise AssertionError("qf_probe: an inserted key was not found")
    ms = cuda_ms(lambda: qf_probe.qf_probe(*planes, fq, fr), 20)
    plain_ms = cuda_ms(lambda: qf_probe.probe_plain(*planes, fq, fr), 2)
    pack_ms = cuda_ms(lambda: qf_probe.pack_bits(*planes[1:]), 20)
    bits = qf_probe.pack_bits(*planes[1:])
    walk_ms = cuda_ms(lambda: qf_probe.walk(*planes, fq, fr, bits), 20)
    # fq/fr read (4 + 4 bytes), present written (1), and the walked slots
    bound_bytes = walked_bytes(planes, fq, fr) + PARITY_PROBES * (4 + 4 + 1)
    meta, rem = walk_sectors(planes, fq, fr)
    empty = int((~planes[1][fq.to(torch.int64)]).sum())
    log(
        f"  qf_probe: {ms:.5f} ms a call of {PARITY_PROBES} queries: pack "
        f"{pack_ms:.5f} ms ({bits.numel() * 4} bytes of bit planes), walk "
        f"{walk_ms:.5f} ms"
    )
    log(
        f"  qf_probe gathers: on the byte planes about {meta + rem + empty} "
        f"sectors (walk_sectors: {meta} metadata, {rem} rem of the runs, and "
        f"{empty} occ of empty buckets); on the bit planes, which stay in L2, "
        f"the {rem} rem sectors come from the card's memory: "
        f"{rem / walk_ms / 1e6:.4f} G sectors/s over the walk"
    )
    row = kernel_row(
        "qf_probe", "qf_probe.cu", "src/repro/kernels/qf_probe.py:158",
        err, ms, plain_ms, bound_bytes, None,
    )
    return row, probes


def check_fingerprint(cfg, keys):
    """fingerprint of ``check_probe``'s 2**22 keys at p = 39 in the q = 24
    split (24, 15), into int32 (the probes' pairs; the row) and into int64
    (the inserts' pairs; logged)."""
    args = (keys, cfg.q, cfg.r, cfg.seed)
    err, times = 0, {}
    for dtype in (torch.int64, torch.int32):
        got = fingerprint.fingerprint(*args, dtype)
        err = max(err, max_abs_err(got, fingerprint.fingerprint_plain(*args, dtype)))
        ms = cuda_ms(lambda: fingerprint.fingerprint(*args, dtype), 20)
        plain_ms = cuda_ms(lambda: fingerprint.fingerprint_plain(*args, dtype), 5)
        times[dtype] = (ms, plain_ms)
        bound = keys.shape[0] * (4 + 2 * got[0].element_size())
        log(f"  fingerprint of {keys.shape[0]} int32 keys into {dtype}: {ms:.5f} ms, "
            f"plain {plain_ms:.5f} ms, bound {bound / H100_BYTES_PER_S * 1e3:.6f} ms")
    ms, plain_ms = times[torch.int32]
    # a 4-byte key read, two 4-byte words written
    return kernel_row(
        "fingerprint", "fingerprint.cu", "src/repro/core/fingerprint.py:76",
        err, ms, plain_ms, keys.shape[0] * 12, None,
    )


def walk_sectors(planes, fq, fr) -> tuple:
    """32-byte sectors the cluster walks of these queries touch, counted per
    query whose bucket is occupied: the sectors of its walked span in each
    of the three metadata planes (an upper estimate: not every plane is
    read over the whole span), and those of its run in ``rem``, which is
    read there only.  Returns ``(metadata sectors, rem sectors)``."""
    occ = planes[1]
    t = occ.shape[0]
    walked = occ[fq.to(torch.int64)]
    _, first, last, run = walk_spans(planes, fq, fr)
    first, last, run = first[walked], last[walked], run[walked]
    meta = (last >> 5) - (first >> 5) + 1  # one-byte planes occ, shf, con
    rem = torch.where(run < t, (last >> 3) - (run.clamp(max=t - 1) >> 3) + 1, 0)
    return int(3 * meta.sum()), int(rem.sum())


def check_cascade(device, cfg, state, inserted):
    """cascade_probe over the main path's 7-structure cascade, 2**22 probes."""
    cfgs = [cfg.q0_cfg] + [cfg.level_cfg(i) for i in range(cfg.levels)]
    structs = (state.q0, *state.levels)
    planes = [(s.rem, s.occ, s.shf, s.con) for s in structs]
    counts = [s.n for s in structs]
    widths = [c.r for c in cfgs]
    rng = np.random.default_rng(SEED + 2)
    half = PARITY_PROBES // 2
    pick = torch.from_numpy(rng.integers(0, inserted.shape[0], half)).to(device)
    probes = torch.cat([inserted[pick], uint32_keys(rng, half, device)])
    fq, fr, rc = canonical_queries(cfg, probes)
    args = (planes, counts, widths, fq, fr, rc)
    got = cascade_probe.cascade_probe(*args)
    err = max_abs_err([got], [cascade_probe.cascade_probe_plain(*args)])
    if not bool((got[:half] != 0).all()):
        raise AssertionError("cascade_probe: an inserted key was not found")
    ms = cuda_ms(lambda: cascade_probe.cascade_probe(*args), 10)
    plain_ms = cuda_ms(lambda: cascade_probe.cascade_probe_plain(*args), 1)
    # fq/fr read once (4 + 4 bytes), hit written (4), each level's 4-byte
    # count, and per live structure the slots its walks cover, each at its
    # own split of the fingerprint; a level whose count is 0 is not read
    f = (fq.to(torch.int64) << rc) | (fr.to(torch.int64) & 0xFFFFFFFF)
    occupied = [int(n) for n in counts]
    walk_bytes, every_level_bytes, occ_reads, sectors = 0, 0, 0, 0
    for p, r, n in zip(planes, widths, occupied):
        lq, lr = f >> r, f & ((1 << r) - 1)
        b = walked_bytes(p, lq, lr)
        every_level_bytes += b
        if n > 0:
            walk_bytes += b
            occ_reads += PARITY_PROBES
            sectors += sum(walk_sectors(p, lq, lr))
    bound_bytes = walk_bytes + 4 * len(planes) + PARITY_PROBES * (4 + 4 + 4)
    old_bound = every_level_bytes + PARITY_PROBES * (4 + 4 + 4)
    log(f"  cascade_probe checked on a cascade holding {occupied} fingerprints")
    log(
        f"  cascade_probe bound {bound_bytes / H100_BYTES_PER_S * 1e3:.6f} ms "
        f"over the {sum(n > 0 for n in occupied)} live levels (reading every "
        f"level: {old_bound / H100_BYTES_PER_S * 1e3:.6f} ms)"
    )
    dead_reads = PARITY_PROBES * len(planes) - occ_reads
    log(
        f"  cascade_probe gathers: {occ_reads} occ sectors of live levels, about "
        f"{sectors} walk sectors, {dead_reads} occ sectors of empty levels not "
        f"read; {(occ_reads + sectors) / ms / 1e6:.4f} G sectors/s, "
        f"{(occ_reads + sectors) * 32 / ms / 1e9:.4f} TB/s of sectors"
    )
    return kernel_row(
        "cascade_probe", "cascade_probe.cu", "src/repro/kernels/cascade_probe.py:150",
        err, ms, plain_ms, bound_bytes, None,
    )


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path, under each backend
# ---------------------------------------------------------------------------


def specs(backend: str) -> dict:
    disk_q = RAM_Q + 3  # bench_ssd: RAM_Q + max(2, ceil(log2(ratio * 1.8)))
    return {
        "buffered_qf": dict(ram_q=RAM_Q, disk_q=disk_q, p=P_BITS, backend=backend),
        "cascade": dict(ram_q=RAM_Q, p=P_BITS, fanout=2, levels=6, backend=backend),
    }


def timed_probe(cfg, state, probes):
    """``filters.probe`` once for its answer and state, then ``PROBE_REPS``
    more calls on the same input, each timed by CUDA events; median ms."""
    new_state, hit = filters.probe(cfg, state, probes)
    times = []
    for _ in range(PROBE_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        filters.probe(cfg, state, probes)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return new_state, hit, statistics.median(times)


def drive(name, spec, keys, checkpoints, on_batch=None):
    """Ingest ``keys`` in ``BATCHES`` batches through the façade, probing on the way.

    ``checkpoints`` maps a number of batches ingested to the key sets
    probed right after them.  The probes' I/O is accounted on the probed
    state, not on the one the ingest goes on with.  ``on_batch(b,
    seconds)`` is called after each insert.  Returns the config, the
    ingest wall time, per checkpoint ``(probed state, hits, probe ms)``,
    and the state after the last batch.  ``on_batch(b, seconds, state)``
    sees each batch's state.
    """
    cfg, state = filters.make(name, **spec)
    step = keys.shape[0] // BATCHES
    ingest_s, out = 0.0, {}
    for b in range(BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = filters.insert(cfg, state, keys[b * step : (b + 1) * step])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ingest_s += seconds
        if on_batch is not None:
            on_batch(b, seconds, state)
        if b + 1 in checkpoints:
            probed, hits, probe_ms = state, [], []
            for probes in checkpoints[b + 1]:
                probed, hit, ms = timed_probe(cfg, probed, probes)
                hits.append(hit)
                probe_ms.append(ms)
            out[b + 1] = (probed, hits, probe_ms)
    return cfg, ingest_s, out, state


def union_bound(cfg, state) -> float:
    """The fp-rate bound: a sum over the non-empty structures of
    n / 2**q * 2**-r for a QF and 2**-fp_bits for a frozen level."""
    if hasattr(cfg, "q0_cfg"):
        parts = [(cfg.q0_cfg, state.q0)] + [
            (cfg.fuse_cfg(i) if cfg.is_frozen(i) else cfg.level_cfg(i), s)
            for i, s in enumerate(state.levels)
        ]
    elif hasattr(cfg, "core"):
        parts = [(cfg.core, state)]
    else:
        parts = [(cfg.ram, state.ram), (cfg.disk, state.disk)]

    def rate(c, s):
        if isinstance(c, fuse.FuseConfig):
            return 2.0**-c.fp_bits
        return int(s.n) / 2**c.q * 2.0**-c.r

    return sum(rate(c, s) for c, s in parts if int(s.n) > 0)


def fresh_keys(rng, inserted_sorted, n, device):
    """``n`` uniform uint32 keys none of which was inserted."""
    out = []
    while sum(k.shape[0] for k in out) < n:
        cand = uint32_keys(rng, n, device).to(torch.int64) & 0xFFFFFFFF
        pos = torch.searchsorted(inserted_sorted, cand).clamp(
            max=inserted_sorted.shape[0] - 1
        )
        out.append(cand[inserted_sorted[pos] != cand])
    return torch.cat(out)[:n]


# ---------------------------------------------------------------------------
# phases 5 to 7: the Bloom families and the paper's Bloom baselines
# ---------------------------------------------------------------------------


def bloom_m_bits(n_total: int) -> int:
    """bench_ssd's Bloom size: n * k / ln 2 bits."""
    return int(n_total * BLOOM_K / np.log(2))


def bloom_specs(n_total: int, backend: str) -> dict:
    """The three Bloom structures of phase 5, as (family, spec) by label."""
    base = dict(m_bits=bloom_m_bits(n_total), k=BLOOM_K, backend=backend)
    blocked = dict(base, block_bits=BLOCK_BITS)
    return {
        "bloom": ("bloom", base),
        "blocked_bloom": ("blocked_bloom", blocked),
        "counting blocked_bloom": ("blocked_bloom", dict(blocked, counting=True)),
    }


def bloom_fp_bound(n: int, cells: int) -> float:
    """The classic Bloom false-positive rate (1 - e**(-k n / m))**k."""
    return (1 - math.exp(-BLOOM_K * n / cells)) ** BLOOM_K


def drive_bloom(backend: str, keys, probes):
    """Ingest ``keys`` into the three Bloom structures, probe them once,
    then delete the first ``DELETED_BATCHES`` batches from the counting one.

    Returns per label ``(cfg, state, hits, probe ms, ingest s)`` and the
    counting structure's state after the deletes.
    """
    out = {}
    for label, (name, spec) in bloom_specs(keys.shape[0], backend).items():
        cfg, ingest_s, probed, state = drive(name, spec, keys, {BATCHES: (probes,)})
        _, (hit,), (ms,) = probed[BATCHES]
        out[label] = (cfg, state, hit, ms, ingest_s)
    cfg, state = out["counting blocked_bloom"][:2]
    step = keys.shape[0] // BATCHES
    for b in range(DELETED_BATCHES):
        state = filters.delete(cfg, state, keys[b * step : (b + 1) * step])
    return out, state


def check_deleted(cfg, state, keys) -> None:
    """Every key of the batches not deleted still hits, and ``n`` counts them."""
    step = keys.shape[0] // BATCHES
    for b in range(DELETED_BATCHES, BATCHES):
        batch = keys[b * step : (b + 1) * step]
        if not bool(filters.contains(cfg, state, batch).all()):
            raise AssertionError(f"counting blocked_bloom lost a key of batch {b}")
    want = (BATCHES - DELETED_BATCHES) * step
    if int(state.n) != want:
        raise AssertionError(f"counting blocked_bloom: n = {int(state.n)} != {want}")


def check_bloom_count(keys):
    """bloom_count on one batch's indices into the classic Bloom plane.

    The batch's last sixteenth is masked (``k=`` shorter than the
    batch), so its indices are INT32_MAX and must count nothing.
    """
    cfg = bloom_filter.BloomFilterConfig(m_bits=bloom_m_bits(keys.shape[0]), k=BLOOM_K)
    batch = keys[: keys.shape[0] // BATCHES]
    valid_keys = batch.shape[0] * 15 // 16
    idx = bloom_filter._masked(bloom_filter._indices(cfg, batch), batch, valid_keys)
    idx = idx.reshape(-1)
    ncells = cfg.m_bits
    got = bloom_block.bloom_count(idx, ncells)
    err = max_abs_err([got], [bloom_block.bloom_count_plain(idx, ncells)])
    if int(got.sum()) != valid_keys * BLOOM_K:
        raise AssertionError("bloom_count: masked indices were counted")
    del got
    ms = cuda_ms(lambda: bloom_block.bloom_count(idx, ncells), 10)
    plain_ms = cuda_ms(lambda: bloom_block.bloom_count_plain(idx, ncells), 3)
    valid = idx[idx != 2**31 - 1]
    library_ms = cuda_ms(lambda: torch.bincount(valid, minlength=ncells), 3)
    log(
        f"  bloom_count checked: {idx.numel()} indices ({valid.numel()} valid) "
        f"into {ncells} cells"
    )
    bound_bytes = 4 * idx.numel() + 4 * ncells  # indices read, counts written
    return kernel_row(
        "bloom_count", "bloom_count.cu", "src/repro/kernels/bloom_block.py:160",
        err, ms, plain_ms, bound_bytes, library_ms,
    )


def check_bloom_probe(structs, probes):
    """bloom_probe on the ingested plain and counting ``blocked_bloom`` states.

    The row carries the plain (uint8) state's times and bound; the
    counting (int16) state's are logged beside them.  A query reads its
    indices and cells only up to its first empty cell, so the bound
    counts the reads these queries need.
    """
    err, times = 0, {}
    group = bloom_block.probe_group()
    for label in ("blocked_bloom", "counting blocked_bloom"):
        cfg, state = structs[label][:2]
        idx = bloom_filter._indices(cfg, probes)
        cells = state.cells
        got = bloom_block.bloom_probe(cells, idx)
        err = max(err, max_abs_err([got], [bloom_block.bloom_probe_plain(cells, idx)]))
        if not bool(got[: probes.shape[0] // 2].all()):
            raise AssertionError(f"bloom_probe: {label} lost an inserted key")
        ms = cuda_ms(lambda: bloom_block.bloom_probe(cells, idx), 20)
        plain_ms = cuda_ms(lambda: bloom_block.bloom_probe_plain(cells, idx), 3)
        # a query stops at its first empty cell: the indices and cells read
        # up to there, in the cells' width, and one byte out
        needed = bloom.first_zero_probes(cells[idx.to(torch.int64)] != 0)
        reads = int(needed.sum())
        bound = reads * (4 + cells.element_size()) + idx.shape[0]
        times[label] = (ms, plain_ms, bound)
        # the kernel reads whole groups: each cell read a random 32-byte sector
        k = idx.shape[1]
        gathers = int(torch.clamp((needed + group - 1) // group * group, max=k).sum())
        log(
            f"  bloom_probe on {label} ({cells.dtype}): {ms:.5f} ms, plain "
            f"{plain_ms:.5f} ms, bound {bound / H100_BYTES_PER_S * 1e3:.6f} ms; "
            f"{gathers} cell sectors gathered in groups of {group} ({reads} "
            f"up to the first empty cell), {gathers / ms / 1e6:.4f} G sectors/s, "
            f"{gathers * 32 / ms / 1e9:.4f} TB/s of sectors"
        )
    ms, plain_ms, bound = times["blocked_bloom"]
    return kernel_row(
        "bloom_probe", "bloom_probe.cu", "src/repro/kernels/bloom_block.py:96",
        err, ms, plain_ms, bound, None,
    )


def baseline_makers(n_total: int, device, ratio: int = RATIO) -> dict:
    """bench_ssd's ``_mk_structs`` Bloom baselines at ``ratio``."""
    m_bits = bloom_m_bits(n_total)
    ram_bits = m_bits // ratio
    cfg = bloom.BloomConfig(m_bits=m_bits, k=BLOOM_K)
    return {
        "ebf": lambda: bf_variants.ElevatorBloomFilter(
            cfg, buffer_capacity_bits=ram_bits // 64, device=device
        ),
        "bbf": lambda: bf_variants.BufferedBloomFilter(
            cfg, ram_bytes=ram_bits // 8, block_bytes=4096 * 8, page_bytes=512,
            device=device,
        ),
        "fbf": lambda: bf_variants.ForestBloomFilter(
            bits_per_element=BLOOM_K / np.log(2), ram_bytes=ram_bits // 8,
            total_elements=n_total, device=device,
        ),
    }


def baseline_io(struct, keys, lookups, step):
    """Ingest a structure as bench_ssd does, ``step`` keys a batch (the
    last may be shorter), then its two lookup sets.

    Returns ``((ingest, uniform lookups, hit lookups) logs, ingest s,
    (uniform hits, hits))``; the ingest s is the sum of the insert calls'
    wall times, the card synchronised around each.
    """
    ingest_s = 0.0
    for i in range(0, keys.shape[0], step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        struct.insert(keys[i : i + step])
        torch.cuda.synchronize()
        ingest_s += time.perf_counter() - t0
    ingest = struct.io.snapshot()
    uniform, hits = lookups
    uniform_hit = struct.lookup(uniform)
    mid = struct.io.snapshot()
    hit = struct.lookup(hits)
    if not bool(hit.all()):
        raise AssertionError(f"{type(struct).__name__}: false negative")
    logs = (ingest, mid.delta(ingest), struct.io.snapshot().delta(mid))
    return logs, ingest_s, (uniform_hit, hit)


def qf_io(cfg, state, lookups):
    """The same logs for a QF structure of phase 3, from its ``IOCounters``."""
    uniform, hits = lookups
    ingest = filters.to_iolog(state.io)
    state, _ = filters.probe(cfg, state, uniform)
    mid = filters.to_iolog(state.io)
    state, hit = filters.probe(cfg, state, hits)
    if not bool(hit.all()):
        raise AssertionError(f"{type(cfg).__name__}: false negative")
    return ingest, mid.delta(ingest), filters.to_iolog(state.io).delta(mid)


def modeled_ops(n_total: int, logs) -> dict:
    """bench_ssd's modeled ops/s on the paper's SSD from the three logs."""
    ingest, uniform, hits = logs
    rate = lambda n, io: cost_model.modeled_throughput(n, io, cost_model.PAPER_SSD)
    return {
        "insert": rate(n_total, ingest),
        "lookup_uniform": rate(PAPER_LOOKUPS, uniform),
        "lookup_hit": rate(PAPER_LOOKUPS, hits),
    }


def differing_fields(a, b) -> list:
    """Names of the state fields that differ between two states."""
    la, lb = list(filters._leaves(a)), list(filters._leaves(b))
    if len(la) != len(lb):
        return ["<structure>"]
    return [na for (na, x), (_, y) in zip(la, lb) if not torch.equal(x, y)]


# ---------------------------------------------------------------------------
# phases 8 and 9: the frozen tier
# ---------------------------------------------------------------------------


def frozen_spec(backend: str) -> dict:
    return dict(
        ram_q=RAM_Q, p=P_BITS, fanout=2, levels=FROZEN_LEVELS,
        frozen_below=FROZEN_BELOW, backend=backend,
    )


def peel_delta(before: dict) -> dict:
    return {k: fuse.peel_counts[k] - before[k] for k in before}


def freeze_watch():
    """A ``drive`` callback that records each insert batch that ran a peel:
    its batch, wall seconds, and the peel's attempts, rounds, host reads;
    and the state right after each such batch, by batch."""
    freezes, after, last = [], {}, dict(fuse.peel_counts)

    def on_batch(b, seconds, state):
        d = peel_delta(last)
        if d["freezes"]:
            freezes.append(dict(batch=b + 1, seconds=seconds, **d))
            after[b + 1] = state
        last.update(fuse.peel_counts)

    return freezes, after, on_batch


def drive_frozen(backend, keys, checkpoints):
    """Phase 3's stream into the frozen cascade; ``drive``'s results, the
    freezes it ran and the state right after each."""
    freezes, after, on_batch = freeze_watch()
    cfg, ingest_s, out, final = drive(
        "cascade", frozen_spec(backend), keys, checkpoints, on_batch
    )
    return cfg, ingest_s, out, final, freezes, after


def timed_host(fn):
    """``fn()`` with the card synchronised around it: (result, wall s, peel delta)."""
    before = dict(fuse.peel_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, peel_delta(before)


def check_xor_fuse(label, cfg, state, members, fresh) -> str:
    """No overflow, no false negative, fp rate at most twice 2**-fp_bits."""
    st = filters.stats(cfg, state)
    if bool(st["overflow"]):
        raise AssertionError(f"{label}: overflow (no seed peeled, or over capacity)")
    if not bool(filters.contains(cfg, state, members).all()):
        raise AssertionError(f"{label}: false negative")
    fp_rate = float(filters.contains(cfg, state, fresh).float().mean())
    bound = 2.0**-cfg.fp_bits
    if fp_rate > 2 * bound:
        raise AssertionError(f"{label}: fp rate {fp_rate} > 2 x {bound}")
    return (
        f"n {int(st['n'])}, n_unique {int(st['n_unique'])}, capacity "
        f"{cfg.capacity}, {st['slots']} cells, {st['bits_per_key']:.4f} bits/key; "
        f"fp rate {fp_rate:.4e} (2**-{cfg.fp_bits} = {bound:.4e})"
    )


def drive_xor_fuse(keys, fresh):
    """The ``xor_fuse`` family on its own under ``backend="pallas"``: a
    full-load ``make(keys=...)`` of the first ``XF_KEYS`` keys, ``grow``,
    and ``merge`` with a filter of the next ``XF_KEYS`` keys."""
    spec = dict(p=P_BITS, fp_bits=XF_FP_BITS, backend="pallas")
    first, second = keys[:XF_KEYS], keys[XF_KEYS : 2 * XF_KEYS]
    (cfg, state), s, d = timed_host(
        lambda: filters.make("xor_fuse", keys=first, **spec)
    )
    log(
        f"  xor_fuse make(keys=2**{XF_KEYS.bit_length() - 1}) at full load: "
        f"{s:.3f} s, {d}"
    )
    log(f"    {check_xor_fuse('xor_fuse', cfg, state, first, fresh)}")
    (gcfg, grown), s, d = timed_host(lambda: filters.grow(cfg, state))
    log(f"  grow to capacity {gcfg.capacity}: {s:.3f} s, {d}")
    ocfg, other = filters.make(
        "xor_fuse", keys=second, capacity=gcfg.capacity, **spec
    )
    if ocfg != gcfg:
        raise AssertionError(f"xor_fuse: {ocfg} != {gcfg}")
    merged, s, d = timed_host(lambda: filters.merge(gcfg, grown, other))
    log(f"  merge with the next {XF_KEYS} keys, at full load: {s:.3f} s, {d}")
    both = keys[: 2 * XF_KEYS]
    log(f"    {check_xor_fuse('merged xor_fuse', gcfg, merged, both, fresh)}")


def check_fuse(device, cfg, state, keys):
    """fuse_probe on level 1 of the frozen cascade, 2**22 queries: half
    keys of the 48 batches it holds, half uniform keys.  Its plain version
    is the route of the kernel before it took the hash: ``fuse_hash`` in
    PyTorch, then the three gathers."""
    fc, level = cfg.fuse_cfg(FROZEN_BELOW), state.levels[FROZEN_BELOW]
    held = keys.shape[0] // BATCHES * 48
    rng = np.random.default_rng(SEED + 4)
    half = PARITY_PROBES // 2
    pick = torch.from_numpy(rng.integers(0, held, half)).to(device)
    probes = torch.cat([keys[pick], uint32_keys(rng, half, device)])
    fq, fr, _ = canonical_queries(cfg, probes)
    args = (level.table, fq, fr, level.fuse_seed, fc.segment_length,
            fc.segment_count, fc.fp_bits)
    got = fuse_probe.fuse_probe(*args)
    err = max_abs_err([got], [fuse_probe.fuse_probe_plain(*args)])
    if not bool(got[:half].all()):
        raise AssertionError("fuse_probe: an inserted key was not found")
    ms = cuda_ms(lambda: fuse_probe.fuse_probe(*args), 20)
    plain_ms = cuda_ms(lambda: fuse_probe.fuse_probe_plain(*args), 5)
    # the hash alone, as the frozen lookups ran it in PyTorch before
    hash_ms = cuda_ms(lambda: fuse.fuse_hash(fc, fq, fr, level.fuse_seed), 5)
    log(
        f"  fuse_probe of {PARITY_PROBES} queries, hash included: {ms:.5f} ms; "
        f"fuse_hash alone in PyTorch {hash_ms:.5f} ms, plain (hash and "
        f"gathers) {plain_ms:.5f} ms; {3 * PARITY_PROBES} random cell sectors"
    )
    log(
        f"  fuse_probe checked on level 1's {level.table.numel()} cells "
        f"({int(level.n)} fingerprints); {int(got[half:].sum())} of {half} "
        "uniform keys hit"
    )
    # fingerprint pair read (2 x 4 bytes), three int32 cells gathered, one
    # byte written
    bound_bytes = PARITY_PROBES * (8 + 12 + 1)
    return kernel_row(
        "fuse_probe", "fuse_probe.cu", "src/repro/kernels/fuse_probe.py:109",
        err, ms, plain_ms, bound_bytes, None,
    )


def check_no_sync(cfg, state, keys) -> None:
    """The kernel-path probes of ``keys`` on the frozen cascade ``state``:
    ``ops.contains`` on its Q0, ``ops.cascade_lookup`` over its stack and
    ``ops.fuse_lookup`` on level 1, each run once more under
    ``torch.cuda.set_sync_debug_mode("error")``, where a host sync raises."""
    qf_ix = [i for i in range(cfg.levels) if not cfg.is_frozen(i)]
    fz_ix = [i for i in range(cfg.levels) if cfg.is_frozen(i)]
    fc, level = cfg.fuse_cfg(FROZEN_BELOW), state.levels[FROZEN_BELOW]
    fq, fr = fingerprint.fingerprint(keys, *fc.canon, fc.seed, torch.int32)
    calls = {
        "ops.contains": lambda: ops.contains(cfg.q0_cfg, state.q0, keys),
        "ops.cascade_lookup": lambda: ops.cascade_lookup(
            (cfg.q0_cfg,) + tuple(cfg.level_cfg(i) for i in qf_ix),
            (state.q0,) + tuple(state.levels[i] for i in qf_ix),
            tuple(cfg.fuse_cfg(i) for i in fz_ix),
            tuple(state.levels[i] for i in fz_ix),
            keys,
        ),
        "ops.fuse_lookup": lambda: ops.fuse_lookup(fc, level, fq, fr),
    }
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    log(f"  no host sync in {', '.join(calls)} (sync debug mode \"error\")")


# ---------------------------------------------------------------------------
# phase inram: Table 1(a)
# ---------------------------------------------------------------------------


def median_ms(fn, reps: int = TIMED_REPS) -> float:
    """Median milliseconds of ``reps`` calls of ``fn``, each timed by CUDA
    events, after one untimed call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def members(inserted_sorted, probes):
    """Which probes are among the inserted keys (sorted as uint32 in int64)."""
    cand = probes.to(torch.int64) & 0xFFFFFFFF
    last = inserted_sorted.shape[0] - 1
    pos = torch.searchsorted(inserted_sorted, cand).clamp(max=last)
    return inserted_sorted[pos] == cand


def drive_inram(device):
    """``benchmarks/bench_inram.py`` (Table 1(a)) at q = ``INRAM_Q``.

    For r = 6, 9 and 12: a ``qf(q, r, slack=2048)`` and a ``bloom`` with
    k = r and m = n k / ln 2, both under ``backend="pallas"``, both filled
    with the same n = 0.75 * 2**q keys drawn as the bench draws them
    (``default_rng(0)``: the fill, an insert batch, uniform lookups from
    [2**31, 2**32)); the bench's batch sizes are 2**8 times its own, as
    q is 2**8 times its 2**18 buckets.  The reduction from the paper's
    2**31 buckets to 2**26 is forced: the kernel path holds slot positions
    in int32, and both packages cap q at 30.  Timed by CUDA events (median
    of ``TIMED_REPS`` calls): an insert of the batch into the filled
    filter, a lookup of the uniform keys and one of ``INRAM_LOOKUP_BATCH``
    inserted keys.  Checked: no false negative; over the uniform keys that
    were not inserted, an fp rate at most twice the QF union bound
    0.75 * 2**-r or the Bloom bound (1 - e**(-k n / m))**k; no overflow.
    Returns one result dict per r; the QF/BF ratios are printed, not gated.
    """
    rng = np.random.default_rng(0)
    n = int((1 << INRAM_Q) * 0.75)
    out = []
    for fp, r in INRAM_CASES:
        keys = uint32_keys(rng, n, device)
        k = max(1, round(-np.log2(fp)))
        m_bits = int(n * k / np.log(2))
        cfg, qst = filters.make("qf", q=INRAM_Q, r=r, slack=2048, backend="pallas")
        (qst), fill_s, _ = timed_host(lambda: filters.insert(cfg, qst, keys))
        bcfg, bst = filters.make("bloom", m_bits=m_bits, k=k, backend="pallas")
        for i in range(0, n, INRAM_INSERT_BATCH):
            bst = filters.insert(bcfg, bst, keys[i : i + INRAM_INSERT_BATCH])
        batch = uint32_keys(rng, INRAM_INSERT_BATCH, device)
        uni = rng.integers(2**31, 2**32, INRAM_LOOKUP_BATCH, dtype=np.int64)
        uniform = torch.from_numpy(uni.astype(np.uint32).view(np.int32)).to(device)
        hits = keys[:INRAM_LOOKUP_BATCH]
        fresh = ~members(torch.sort(keys.to(torch.int64) & 0xFFFFFFFF).values, uniform)
        res = {"r": r, "k": k, "n": n, "m_bits": m_bits, "qf_fill_s": fill_s}
        bounds = {"qf": 0.75 * 2.0**-r, "bf": (1 - math.exp(-k * n / m_bits)) ** k}
        for name, c, st in (("qf", cfg, qst), ("bf", bcfg, bst)):
            ins_ms = median_ms(lambda: filters.insert(c, st, batch))
            uni_ms = median_ms(lambda: filters.contains(c, st, uniform))
            hit_ms = median_ms(lambda: filters.contains(c, st, hits))
            if not bool(filters.contains(c, st, hits).all()):
                raise AssertionError(f"inram {name} r={r}: false negative")
            fp_rate = float(filters.contains(c, st, uniform)[fresh].float().mean())
            if fp_rate > 2 * bounds[name]:
                raise AssertionError(
                    f"inram {name} r={r}: fp {fp_rate} > 2 x {bounds[name]}"
                )
            res[name] = {
                "insert_ops_per_s": INRAM_INSERT_BATCH / ins_ms * 1e3,
                "lookup_uniform_ops_per_s": INRAM_LOOKUP_BATCH / uni_ms * 1e3,
                "lookup_success_ops_per_s": INRAM_LOOKUP_BATCH / hit_ms * 1e3,
                "insert_ms": ins_ms, "lookup_uniform_ms": uni_ms,
                "lookup_success_ms": hit_ms, "fp_rate": fp_rate,
                "fp_bound": bounds[name],
            }
        if bool(filters.stats(cfg, qst)["overflow"]):
            raise AssertionError(f"inram qf r={r}: overflow")
        res["qf_over_bf"] = {
            what: res["qf"][f"{what}_ops_per_s"] / res["bf"][f"{what}_ops_per_s"]
            for what in ("insert", "lookup_uniform", "lookup_success")
        }
        res["uniform_fresh"] = int(fresh.sum())
        log(f"phase inram r={r}: {json.dumps(res)}")
        out.append(res)
        del qst, bst, keys, hits, uniform, batch
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase resize: blocking and incremental resizing at the main path's width
# ---------------------------------------------------------------------------


def check_resized(label, cfg, state, inserted, fresh, seconds):
    """No false negative over every inserted key, an fp rate on ``fresh``
    at most twice the bound, no overflow; logs the step."""
    if not bool(filters.contains(cfg, state, inserted).all()):
        raise AssertionError(f"resize {label}: false negative")
    fp_rate = float(filters.contains(cfg, state, fresh).float().mean())
    bound = union_bound(cfg, state)
    if fp_rate > 2 * bound:
        raise AssertionError(f"resize {label}: fp rate {fp_rate} > 2 x {bound}")
    st = filters.stats(cfg, state)
    if bool(st["overflow"]):
        raise AssertionError(f"resize {label}: overflow")
    io = ""
    if hasattr(state, "io"):
        io = f"; io {json.dumps({k: float(v) for k, v in state.io._asdict().items()})}"
    shape = {k: v for k, v in cfg._asdict().items() if k in (
        "q", "r", "disk_q", "levels", "fanout", "frozen_below")}
    counts = st["level_counts"].tolist() if "level_counts" in st else int(st["n"])
    log(
        f"  {cfg.backend} {label}: {seconds:.5f} s; now {json.dumps(shape)}, "
        f"n {counts}; {inserted.shape[0]} inserted keys hit; fp rate "
        f"{fp_rate:.4e} (bound {bound:.4e}){io}"
    )


def restructure(label, cfg, state, blocking, batches, **target):
    """``begin_restructure`` of ``(cfg, state)`` toward ``target``, the
    ``batches`` inserted while it migrates (and into the blocking
    counterpart ``(cfg, state)`` too), then ``finish``.  Returns the
    finished pair, the blocking pair with the batches, and the seconds of
    ``finish`` (those of begin and of the inserts are logged)."""
    (mcfg, ms), begin_s, _ = timed_host(lambda: incremental_resize.begin_restructure(
        cfg, state, chunk=INC_CHUNK, buf_q=INC_BUF_Q, **target
    ))
    bcfg, bst = blocking
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        ms = filters.insert(mcfg, ms, b)
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    for b in batches:
        bst = filters.insert(bcfg, bst, b)
    (fcfg, fst), finish_s, _ = timed_host(lambda: incremental_resize.finish(mcfg, ms))
    if fcfg != bcfg:
        raise AssertionError(f"{label}: restructured to {fcfg}, blocking {bcfg}")
    log(
        f"  {cfg.backend} {label} restructure: begin {begin_s:.5f} s, "
        f"{len(batches)} migrating inserts {insert_s:.5f} s, finish {finish_s:.5f} s"
    )
    return (fcfg, fst), (bcfg, bst), finish_s


def same_membership(label, a, b, probes) -> None:
    """Two ``(cfg, state)`` pairs answer every probe alike."""
    if not torch.equal(filters.contains(*a, probes), filters.contains(*b, probes)):
        raise AssertionError(f"{label}: membership differs from the blocking resize")


def blocking_steps(backend, keys, fresh, buffered, frozen48):
    """Phase resize (a): the blocking steps, and (b)'s two restructures.

    Yields ``(label, cfg, state, seconds, inserted keys)`` after each step,
    states on the card.  ``buffered`` is phase 3's (or 4's) final
    ``buffered_qf`` pair, ``frozen48`` phase 8's (or 9's) frozen cascade
    right after its batch-48 freeze.
    """
    step = keys.shape[0] // BATCHES
    cfg, st = filters.make("qf", q=RAM_Q, r=P_BITS - RAM_Q, backend=backend)
    cap = cfg.core.capacity
    st = filters.insert(cfg, st, keys[:cap])
    inserted = keys[: cap + step]
    nxt = keys[cap : cap + step]
    (cfg, st), s, _ = timed_host(lambda: filters.auto_grow(cfg, st, nxt))
    yield "qf auto_grow", cfg, st, s, inserted
    (cfg, st), s, _ = timed_host(lambda: filters.shrink(cfg, st))
    yield "qf shrink", cfg, st, s, inserted
    del st

    bcfg, bst = buffered
    (gcfg, gst), s, _ = timed_host(lambda: filters.grow(bcfg, bst))
    yield "buffered_qf grow", gcfg, gst, s, keys
    extra = [
        uint32_keys(np.random.default_rng(SEED + 5 + b), INC_BATCH, keys.device)
        for b in range(RESTRUCTURE_BATCHES)
    ]
    everything = torch.cat([keys] + extra)
    (fcfg, fst), (gcfg, gst), s = restructure(
        "buffered_qf", bcfg, bst, (gcfg, gst), extra, disk_q=RAM_Q + 4
    )
    if backend == "pallas":  # the reference's states are held equal to these
        same_membership(
            "buffered_qf", (fcfg, fst), (gcfg, gst), torch.cat([everything, fresh])
        )
    yield "buffered_qf restructure(disk_q+1)", fcfg, fst, s, everything
    del fst, gst, bst, buffered

    ccfg, cst = filters.make(
        "cascade", ram_q=RAM_Q, p=P_BITS, fanout=2, levels=1, backend=backend
    )
    grow_s = []
    for b in range(BATCHES):
        levels = ccfg.levels
        (ccfg, cst), s, _ = timed_host(
            lambda: filters.auto_grow(ccfg, cst, keys[b * step : (b + 1) * step])
        )
        if ccfg.levels != levels:
            grow_s.append((b + 1, ccfg.levels, s))
    log(f"  {backend} cascade auto_grow: (batch, levels, s of that call) {grow_s}")
    yield "cascade auto_grow", ccfg, cst, sum(g[2] for g in grow_s), keys
    (rcfg, rst), s, _ = timed_host(lambda: filters.resize(ccfg, cst, fanout=4))
    yield "cascade resize(fanout=4)", rcfg, rst, s, keys
    (fcfg, fst), (rcfg, rst), s = restructure(
        "cascade", ccfg, cst, (rcfg, rst), extra, fanout=4
    )
    if backend == "pallas":
        same_membership(
            "cascade", (fcfg, fst), (rcfg, rst), torch.cat([everything, fresh])
        )
    yield "cascade restructure(fanout=4)", fcfg, fst, s, everything
    del fst, rst, cst

    zcfg, zst = frozen48
    (zcfg, zst), s, d = timed_host(lambda: filters.resize(zcfg, zst, levels=2))
    log(f"  {backend} frozen cascade resize(levels=2) peel: {json.dumps(d)}")
    yield "frozen cascade resize(levels=2)", zcfg, zst, s, keys[: 48 * step]


def drive_calls(cfg, st, stream, step, stop_after_growth=None, check=None):
    """bench_incremental's ``_drive``: each call's wall latency (the card
    synchronised after it) and whether it lies in the growth window.
    ``check(i, cfg, state)`` runs after every ``INC_CHECK_EVERY``-th call,
    outside the timing."""
    lats, growth, tail = [], [], None
    for i, batch in enumerate(stream):
        was = incremental_resize.is_migrating(cfg)
        q_before = getattr(cfg, "q", None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfg, st = step(cfg, st, batch)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)
        now = incremental_resize.is_migrating(cfg)
        grew = not was and not now and getattr(cfg, "q", None) != q_before
        growth.append(was or now or grew)
        if check is not None and (i + 1) % INC_CHECK_EVERY == 0:
            check(i, cfg, st)
        if stop_after_growth is not None and grew and tail is None:
            tail = stop_after_growth
        if tail is not None:
            tail -= 1
            if tail <= 0:
                break
    return np.asarray(lats), np.asarray(growth), cfg, st


def p99_experiment(backend, keys, reps, checked):
    """Phase resize (b): ``benchmarks/bench_incremental.py`` at q = ``INC_Q``.

    A ``qf(q, r=P_BITS - q)`` filled with phase 3's first capacity -
    ``INC_BATCH`` keys takes the bench's stream (``default_rng(7)``,
    batches of ``INC_BATCH`` keys from [2**31, 2**32)) through
    ``auto_grow`` (blocking) and ``auto_scale`` (incremental, chunk
    ``INC_CHUNK``, buffer q ``INC_BUF_Q``), ``reps`` replays each, each
    call's minimum kept.  With ``checked``, the first incremental replay
    checks every ``INC_CHECK_EVERY`` calls that no inserted key is missed,
    and the settled table that none is missed at the end.  One more
    blocking run takes the whole stream; its table must equal the settled
    incremental one bit for bit.  Returns the numbers and both final pairs.
    """
    cap = qf.QFConfig(q=INC_Q, r=1).capacity
    fill = keys[: cap - INC_BATCH]
    rng = np.random.default_rng(7)
    n_batches = cap // INC_CHUNK + 16
    stream = [
        torch.from_numpy(
            rng.integers(2**31, 2**32, INC_BATCH, dtype=np.int64).astype(np.uint32)
            .view(np.int32)
        ).to(fill.device)
        for _ in range(n_batches)
    ]
    spec = dict(q=INC_Q, r=P_BITS - INC_Q, backend=backend)

    def filled():
        cfg, st = filters.make("qf", **spec)
        st = filters.insert(cfg, st, fill)
        torch.cuda.synchronize()
        return cfg, st

    blocking = lambda c, s, b: filters.auto_grow(c, s, b)
    incremental = lambda c, s, b: filters.auto_scale(
        c, s, b, chunk=INC_CHUNK, buf_q=INC_BUF_Q
    )

    def check(i, cfg, st):
        inserted = torch.cat([fill] + stream[: i + 1])
        if not bool(filters.contains(cfg, st, inserted).all()):
            raise AssertionError(f"incremental call {i}: false negative")

    def min_of_reps(step, stop=None, checked=False):
        best = win = final = None
        for rep in range(reps):
            lats, growth, cfg, st = drive_calls(
                *filled(), stream, step, stop, check if checked and rep == 0 else None
            )
            if best is None:
                best, win = lats, growth
            else:
                n = min(len(best), len(lats))
                if not (win[:n] == growth[:n]).all():
                    raise AssertionError("replays diverged")
                best, win = np.minimum(best[:n], lats[:n]), win[:n]
            final = (cfg, st)
        return best, win, final

    lat_b, win_b, _ = min_of_reps(blocking, stop=3)
    lat_i, win_i, inc = min_of_reps(incremental, checked=checked)
    if not (win_b.any() and win_i.any()):
        raise AssertionError("the experiment never grew")
    inc = filters.settle(*inc)
    _, _, cfg, st = drive_calls(*filled(), stream, blocking)
    blk = (cfg, st)
    diff = differing_fields(inc[1], blk[1])
    if inc[0] != blk[0] or diff:
        raise AssertionError(f"settled incremental table != blocking grow: {diff}")
    if checked:
        check(len(stream) - 1, *inc)
    # finish alone, on a migration half drained (second call timed)
    finish_s = []
    for _ in range(2):
        mcfg, ms = incremental_resize.begin(*filled(), chunk=INC_CHUNK, buf_q=INC_BUF_Q)
        for b in stream[: n_batches // 2]:
            ms = filters.insert(mcfg, ms, b)
        _, s, _ = timed_host(lambda: incremental_resize.finish(mcfg, ms))
        finish_s.append(s)
    p99_b = float(np.percentile(lat_b[win_b], 99))
    p99_i = float(np.percentile(lat_i[win_i], 99))
    res = {
        "backend": backend,
        "replays": reps,
        "p99_blocking_s": p99_b,
        "p99_incremental_s": p99_i,
        "ratio": p99_b / p99_i,
        "bar": 5,
        "p50_blocking_s": float(np.percentile(lat_b[win_b], 50)),
        "p50_incremental_s": float(np.percentile(lat_i[win_i], 50)),
        "max_blocking_s": float(lat_b[win_b].max()),
        "max_incremental_s": float(lat_i[win_i].max()),
        "window_blocking": int(win_b.sum()),
        "window_incremental": int(win_i.sum()),
        "finish_s": finish_s[-1],
        "calls": len(stream),
    }
    log(f"  p99 experiment: {json.dumps(res)}")
    return res, inc, blk, stream


def bulk_breakdown(keys) -> dict:
    """Where a blocking growth call's time goes: the steps of ``grow`` and
    of the insert after it, on a ``qf`` at q = ``INC_Q`` filled to its
    capacity, each the median of ``TIMED_REPS`` calls by CUDA events."""
    cfg, st = filters.make("qf", q=INC_Q, r=P_BITS - INC_Q, backend="pallas")
    cap = cfg.core.capacity
    st = filters.insert(cfg, st, keys[:cap])
    batch = keys[cap : cap + INC_BATCH]
    core = cfg.core
    wide = core._replace(q=core.q + 1, r=core.r - 1)
    qs, rs, n = ops.extract(core, st)
    wq, wr = qf._requotient(qs, rs, core, wide)
    pad = wide.total_slots - wq.shape[0]
    wq = torch.cat([wq, wq.new_full((pad,), qf.INT32_MAX)])
    wr = torch.cat([wr, wr.new_full((pad,), qf.UINT32_MAX)])
    gcfg, grown = filters.grow(cfg, st)
    fq, fr = fingerprint.fingerprint(batch, wide.q, wide.r, wide.seed, torch.int64)
    allq, allr = torch.cat([wq, fq]), torch.cat([wr, fr])
    valid = torch.cat([
        torch.arange(wq.shape[0], device=wq.device) < n,
        torch.ones_like(fq, dtype=torch.bool),
    ])
    t = wide.total_slots
    nn = n.to(torch.int32)
    wq32, wr32 = i32(wq), i32(wr)
    pos, _ = qf_build.qf_positions(wq32, nn, t)
    idx = torch.arange(wq.shape[0], device=wq.device)
    d = torch.where(idx < nn, wq - idx, -qf.INT32_MAX)
    out = {
        "extract q": median_ms(lambda: ops.extract(core, st)),
        "requotient and pad": median_ms(lambda: qf._requotient(qs, rs, core, wide)),
        "build q+1": median_ms(lambda: ops.build_sorted(wide, wq, wr, n)),
        "of which narrowing fq and fr": median_ms(lambda: (i32(wq), i32(wr))),
        "of which qf_positions": median_ms(lambda: qf_build.qf_positions(wq32, nn, t)),
        "of which qf_build_planes": median_ms(
            lambda: qf_build.qf_build_planes(pos, wq32, wr32, nn, t)
        ),
        "torch.cummax of the same stream (not on the path)": median_ms(
            lambda: torch.cummax(d, 0)
        ),
        "grow": median_ms(lambda: filters.grow(cfg, st)),
        "extract q+1": median_ms(lambda: ops.extract(wide, grown)),
        "sort q+1 and a batch": median_ms(lambda: qf._pad_sort(allq, allr, valid)),
        "insert a batch at q+1": median_ms(lambda: filters.insert(gcfg, grown, batch)),
    }
    log(f"  blocking growth call's steps at q = {INC_Q} (ms): {json.dumps(out)}")
    return out


def check_migrating_no_sync(keys) -> None:
    """One migrating ``incremental_resize.insert`` (a chunk moved, a batch
    into the side buffer) under ``torch.cuda.set_sync_debug_mode("error")``."""
    cfg, st = filters.make("qf", q=INC_Q, r=P_BITS - INC_Q, backend="pallas")
    cap = cfg.core.capacity
    st = filters.insert(cfg, st, keys[:cap])
    mcfg, ms = incremental_resize.begin(cfg, st, chunk=INC_CHUNK, buf_q=INC_BUF_Q)
    batch = keys[cap : cap + INC_BATCH]
    ms = filters.insert(mcfg, ms, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ms = filters.insert(mcfg, ms, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("  no host sync in a migrating incremental_resize.insert "
        "(sync debug mode \"error\")")


# ---------------------------------------------------------------------------
# phase steady: bench_steady_state at full width
# ---------------------------------------------------------------------------


def steady_families(backend: str) -> dict:
    """bench_steady_state's ``FAMILIES``, scaled: label -> (family, spec)."""
    q, p, rq = STEADY_Q, STEADY_P, STEADY_RAM_Q
    fams = {
        "flat": ("qf", dict(q=q, r=p - q)),
        "steady": ("steady_qf", dict(
            q=q, r=p - q, buf_q=STEADY_BUF_Q, chunk=STEADY_CHUNK, settle_load=0.25
        )),
        "buffered": ("buffered_qf", dict(ram_q=rq, disk_q=q, p=p)),
        "cascade": ("cascade", dict(ram_q=rq, p=p, fanout=4, levels=3)),
        "cascade_frozen": ("cascade", dict(
            ram_q=rq, p=p, fanout=4, levels=3, frozen_below=1
        )),
    }
    return {k: (n, dict(spec, backend=backend)) for k, (n, spec) in fams.items()}


def op_kind(i: int) -> str:
    """bench_steady_state's ``_op_kind``: mostly inserts, probes
    interleaved, a rare delete."""
    if i % 48 == 13:
        return "delete"
    if i % 4 == 3:
        return "probe"
    return "insert"


def steady_stream(device):
    """The bench's prefill and op stream, drawn from ``default_rng(11)`` in
    its order (delete ops take keys of the prefill)."""
    rng = np.random.default_rng(STEADY_SEED)
    cap = qf.QFConfig(q=STEADY_Q, r=1).capacity
    prefill = rng.integers(0, 2**32, int(cap * STEADY_PREFILL), dtype=np.int64)
    prefill = prefill.astype(np.uint32)
    ops = []
    for i in range(STEADY_N_OPS):
        kind = op_kind(i)
        if kind == "delete":
            keys = prefill[rng.integers(0, prefill.shape[0], size=STEADY_BATCH)]
        else:
            keys = rng.integers(2**31, 2**32, STEADY_BATCH, dtype=np.int64)
            keys = keys.astype(np.uint32)
        ops.append((kind, torch.from_numpy(keys.view(np.int32)).to(device)))
    return torch.from_numpy(prefill.view(np.int32)).to(device), ops


def clone_state(state):
    """A copy of a state's every tensor (an insert may write its argument's
    planes in place, as the steady family's drain does); other leaves as
    they are."""
    if torch.is_tensor(state):
        return state.clone()
    if not isinstance(state, (list, tuple)):
        return state
    parts = [clone_state(v) for v in state]
    return type(state)(*parts) if hasattr(state, "_fields") else type(state)(parts)


def steady_prefilled(name, spec, prefill):
    """The bench's ``_prefilled``: chunked prefill; the steady filter then
    settles, so every replay starts idle."""
    cfg, st = filters.make(name, **spec)
    for i in range(0, prefill.shape[0], STEADY_PREFILL_CHUNK):
        st = filters.insert(cfg, st, prefill[i : i + STEADY_PREFILL_CHUNK])
    if name == "steady_qf":
        st = steady.settle_all(cfg, st)
    torch.cuda.synchronize()
    return cfg, st


def steady_replay(cfg, st0, ops, can_delete):
    """The bench's ``_drive``: each op's wall latency, the card synchronised
    after it, on a copy of ``st0``."""
    st = clone_state(st0)
    lats, is_insert = [], []
    for kind, keys in ops:
        if kind == "delete" and not can_delete:
            kind = "probe"  # a frozen cold tier ages out through merges
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "insert":
            st = filters.insert(cfg, st, keys)
        elif kind == "probe":
            filters.contains(cfg, st, keys)
        else:
            st = filters.delete(cfg, st, keys)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)
        is_insert.append(kind == "insert")
    return np.asarray(lats), np.asarray(is_insert), st


def steady_min_of_reps(cfg, st0, ops, can_delete):
    best = mask = st = None
    for _ in range(STEADY_REPS):
        lats, m, st = steady_replay(cfg, st0, ops, can_delete)
        if best is None:
            best, mask = lats, m
        else:
            if not (mask == m).all():
                raise AssertionError("steady replay diverged")
            best = np.minimum(best, lats)
    return best[mask], st


@contextlib.contextmanager
def plain_span_append():
    """Route ``ops.build_span``'s ``qf_build_span`` call to the kernel's plain
    version, so that a replay under ``"reference"`` appends its drain ticks
    without the kernel (a ``"reference"`` filter on the card still appends
    through ``ops``, which picks the kernel by the tensors' device)."""
    real = ops.qf_build_span
    ops.qf_build_span = qf_build.build_span_plain
    try:
        yield
    finally:
        ops.qf_build_span = real


def recorded_spans(fn) -> list:
    """Run ``fn`` and return a copy of the inputs of every ``qf_build_span``
    launch it made through ``ops`` (taken before the launch writes them)."""
    calls = []
    real = ops.qf_build_span

    def record(*args):
        calls.append(clone_state(args))
        return real(*args)

    ops.qf_build_span = record
    try:
        fn()
    finally:
        ops.qf_build_span = real
    return calls


def steady_full(cfg, st0, ops):
    """A copy of ``st0`` whose buffer is one batch short of the watermark,
    and the stream's first insert batch."""
    inserts = [k for kind, k in ops if kind == "insert"]
    full = clone_state(st0)
    for keys in inserts[: steady._watermark(cfg) // STEADY_BATCH - 1]:
        full = filters.insert(cfg, full, keys)
    return full, inserts[0]


def check_steady_spans(cfg, full) -> dict:
    """``qf_build_span`` on the spans the steady drain hands it at q =
    ``STEADY_Q``, held bit for bit against its plain version on the same
    card tensors: a tick of one chunk right after an open, the pressure
    tick after it, and ``settle_all``'s span of the rest (carries, ``n``
    and ``overflow`` taken over from the tick before).  The inputs are
    recorded from ``steady._drain`` itself; planes, ``n``, ``overflow``
    and the carries are compared."""
    opened = steady._open_settle(cfg, clone_state(full), True)
    states = [opened]
    steps = (
        ("tick", lambda: states.append(steady._drain(cfg, states[-1], 1))),
        ("pressure tick", lambda: states.append(
            steady._drain(cfg, states[-1], cfg.pressure))),
        ("settle_all", lambda: states.append(steady.settle_all(cfg, states[-1]))),
    )
    out = {}
    for label, step in steps:
        (args,) = recorded_spans(step)
        span, planes = args[:7], args[7:]
        got = tuple(p.clone() for p in planes)
        plain = tuple(p.clone() for p in planes)
        res = qf_build.qf_build_span(*span, *got)
        want = qf_build.build_span_plain(*span, *plain)
        err = max_abs_err(got + res, plain + want)
        out[label] = {"rows": int(span[0].shape[0]), "valid": int(span[2]),
                      "max_abs_err": err}
        if err:
            raise AssertionError(f"steady {label}: qf_build_span differs from "
                                 f"its plain version by {err}")
        del args, span, planes, got, plain, res, want
    del states
    torch.cuda.empty_cache()
    return out


def check_steady_syncs(cfg, st0, ops) -> list:
    """Host syncs of each of the stream's first steady inserts (an open, its
    ticks), counted under ``torch.cuda.set_sync_debug_mode("warn")``; each
    must make at most one."""
    st = clone_state(st0)
    syncs = []
    for keys in [k for kind, k in ops if kind == "insert"][:STEADY_SYNC_INSERTS]:
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                st = filters.insert(cfg, st, keys)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    torch.cuda.synchronize()
    opened = int(st.io.settles) - int(st0.io.settles)
    if max(syncs) > 1 or opened < 1:
        raise AssertionError(f"steady insert syncs {syncs}, settles opened {opened}")
    return syncs


def steady_breakdown(cfg, st0, ops) -> dict:
    """Where a steady insert's time goes at q = ``STEADY_Q``: its steps by
    CUDA events (median of ``TIMED_REPS`` calls; a tick writes the same
    slots each call), the host's issue time of a tick, and whole inserts
    of each kind by the host clock (median of ``TIMED_REPS``, each on a
    copy)."""
    full, batch = steady_full(cfg, st0, ops)
    opening = filters.insert(cfg, clone_state(full), batch)  # opened, one tick
    opened = steady._open_settle(cfg, clone_state(full), True)
    idle = (full.cursor >= full.src_n) & (full.bcursor >= full.bsrc_n)
    flags = [full.buf.n, idle.to(torch.int32), full.clean.to(torch.int32)]

    def host_issue_ms(fn):
        times = []
        for _ in range(TIMED_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    def insert_ms(state):
        times = []
        for _ in range(TIMED_REPS):
            st = clone_state(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            filters.insert(cfg, st, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out = {
        "insert, buffer only (host clock)": insert_ms(st0),
        "insert that opens a settle (host clock)": insert_ms(full),
        "insert with a tick (host clock)": insert_ms(opening),
        "buffer insert at buf_q": median_ms(lambda: qf_filter.insert_keys(
            cfg.buf, cfg.backend, full.buf, batch)),
        "open a settle": median_ms(lambda: steady._open_settle(cfg, full, True)),
        "tick of one chunk": median_ms(lambda: steady._drain(cfg, opened, 1)),
        "tick of one chunk, host issue": host_issue_ms(
            lambda: steady._drain(cfg, opened, 1)),
        "tick of pressure chunks": median_ms(
            lambda: steady._drain(cfg, opened, cfg.pressure)),
        "the insert's host read": median_ms(lambda: torch.stack(flags).tolist()),
        "settle_all": median_ms(lambda: steady.settle_all(cfg, opened)),
    }
    return out


def steady_experiment(device, kernels):
    """Phase steady: ``benchmarks/bench_steady_state.py`` at q = ``STEADY_Q``.

    Every family under ``"pallas"`` takes the bench's prefill and replays its
    op stream ``STEADY_REPS`` times, each call's minimum kept; after the
    replays every inserted key (but those deleted) must hit.  The steady
    family must settle more often than the stream deletes (the bench's
    assertion), launch the QF kernels, make at most one host sync an
    insert, and end a replay under ``"reference"``, whose drain appends
    through ``qf_build_span``'s plain version (``plain_span_append``), with
    the same state; its tick, pressure tick and ``settle_all`` spans are
    held against the plain version (``check_steady_spans``).
    Returns the report (insert p50/p99/max and p99 ratios, recorded, not
    gated) and the steady path's launches.
    """
    prefill, ops = steady_stream(device)
    inserted = torch.cat([prefill] + [k for kind, k in ops if kind == "insert"])
    deleted = torch.cat([k for kind, k in ops if kind == "delete"])
    n_deletes = sum(op_kind(i) == "delete" for i in range(STEADY_N_OPS))
    lats, out, launches = {}, {}, None
    for label, (name, spec) in steady_families("pallas").items():
        if label == "steady":
            for k in kernels.values():
                k.launches = 0
        (cfg, st0), prefill_s, _ = timed_host(lambda: steady_prefilled(name, spec, prefill))
        can_delete = filters.supports(cfg, "delete")
        lats[label], st = steady_min_of_reps(cfg, st0, ops, can_delete)
        present = inserted[~torch.isin(inserted, deleted)] if can_delete else inserted
        if not bool(filters.contains(cfg, st, present).all()):
            raise AssertionError(f"steady {label}: an inserted key is missed")
        s = filters.stats(cfg, st)
        if bool(s["overflow"]):
            raise AssertionError(f"steady {label}: overflow")
        log(f"  {label}: prefill {prefill_s:.3f} s, n {int(s['n'])}")
        if label == "steady":
            launches = {n: k.launches for n, k in kernels.items()}
            settles = int(s["settles"])
            if settles <= n_deletes:
                raise AssertionError(
                    f"steady settled {settles}x for {n_deletes} deletes: the "
                    "watermark never tripped"
                )
            ref_cfg = cfg._replace(backend="reference")
            with plain_span_append():
                _, _, ref_st = steady_replay(ref_cfg, st0, ops, can_delete)
            diff = differing_fields(st, ref_st)
            if diff:
                raise AssertionError(f"steady: reference replay differs in {diff}")
            del ref_st
            syncs = check_steady_syncs(cfg, st0, ops)
            out["steady_span_checks"] = check_steady_spans(
                cfg, steady_full(cfg, st0, ops)[0])
            out["steady_insert_ms"] = steady_breakdown(cfg, st0, ops)
            out["steady_settles"] = settles
            out["steady_deletes"] = n_deletes
            out["steady_syncs_per_insert"] = max(syncs)
            log(f"  steady: {settles} settles for {n_deletes} deletes; reference "
                f"replay (plain span append) equal; host syncs of its first "
                f"{len(syncs)} inserts {syncs}; qf_build_span equal to its plain "
                f"version on {json.dumps(out['steady_span_checks'])}")
        del st0, st
        torch.cuda.empty_cache()
    p99_flat = float(np.percentile(lats["flat"], 99))
    for label, a in lats.items():
        out[label] = {
            "insert_p50_s": float(np.percentile(a, 50)),
            "insert_p99_s": float(np.percentile(a, 99)),
            "insert_max_s": float(a.max()),
            "inserts": int(a.shape[0]),
        }
        if label != "flat":
            out[f"p99ratio_{label}_insert"] = out[label]["insert_p99_s"] / p99_flat
            out[f"{label}_max_under_flat_p99"] = bool(a.max() < p99_flat)
    out["bar_p99ratio_steady"] = STEADY_BAR
    return out, launches


# ---------------------------------------------------------------------------
# phase consumers: the dedup pipeline and the prefix cache at q = 24
# ---------------------------------------------------------------------------


def equal_leaves(cfg, state, leaves) -> bool:
    return all(
        a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(filters.to_numpy(cfg, state), leaves, strict=True)
    )


def restored_pipeline(pcfg, snap, ingested):
    """A fresh pipeline restored from ``snap``: leaves equal to the
    snapshot's, and every digest of ``ingested`` dropped on replay."""
    fresh = DedupPipeline(pcfg)
    fresh.restore(snap)
    if not equal_leaves(fresh.filter_cfg, fresh.filter_state, snap["filter_leaves"]):
        raise AssertionError("restored pipeline: leaves differ from the snapshot")
    for ids in ingested:
        if fresh._dedup(ids).any():
            raise AssertionError("restored pipeline kept an ingested digest")
    return fresh


def dedup_breakdown(pipe, rng) -> dict:
    """Where a ``_dedup`` call's time goes: its probe, the host's
    first-occurrence pass and its ``auto_scale`` insert (on a copy of the
    filter), each the median of ``TIMED_REPS`` host-clock calls on fresh
    digests."""
    cfg, st = pipe.filter_cfg, pipe.filter_state
    times = {"contains and copy back": [], "np.unique": [], "auto_scale insert": []}
    for _ in range(TIMED_REPS):
        ids = rng.integers(0, 2**32, CONSUMER_DIGESTS, dtype=np.uint64).astype(np.uint32)
        keys = pipe._keys(ids)
        copy = clone_state(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        filters.contains(cfg, st, keys).cpu()
        t1 = time.perf_counter()
        np.unique(ids, return_index=True)
        t2 = time.perf_counter()
        filters.auto_scale(cfg, copy, keys, k=ids.shape[0], chunk=CONSUMER_CHUNK)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
            times[name].append(dt * 1e3)
    return {name: statistics.median(v) for name, v in times.items()}


def drive_pipeline(device):
    """Phase consumers (a): a ``steady_qf`` dedup pipeline fed numpy digests
    past its q = ``CONSUMER_Q`` table's capacity.  ``auto_scale``'s low
    watermark shrinks the empty filter on the first call, as far as that
    call's digests fit the halved table at its ``shrink_load`` (q = 18 at
    ``CONSUMER_Q`` = 24 and 65,536 digests a call), so the feed grows it
    back one migration a doubling, the last toward q + 1.  Snapshots taken mid-settle at q and
    mid-migration to q + 1 restore into fresh pipelines; then
    ``batches()`` of its corpus."""
    pcfg = PipelineConfig(
        dedup_family="steady_qf", dedup_ram_q=CONSUMER_Q, dedup_p=CONSUMER_P,
        dedup_chunk=CONSUMER_CHUNK,
    )
    pipe = DedupPipeline(pcfg)
    cap = qf.QFConfig(q=CONSUMER_Q, r=1).capacity
    rng = np.random.default_rng(SEED + 20)
    ingested, secs, snaps, kinds, growths = [], [], {}, [], []
    for call in range(-(-int(CONSUMER_FILL * cap) // CONSUMER_DIGESTS)):
        ids = rng.integers(0, 2**32, CONSUMER_DIGESTS, dtype=np.uint64).astype(np.uint32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe._dedup(ids)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        ingested.append(ids)
        fcfg, st = pipe.filter_cfg, pipe.filter_state
        if incremental_resize.is_migrating(fcfg):
            if kinds[-1] != "migrating":
                growths.append((call, fcfg.dst.q))
            kinds.append("migrating")
            continue
        settling = (st.cursor < st.src_n) | (st.bcursor < st.bsrc_n)
        kinds.append("settling" if bool(settling) else "idle")
        if kinds[-1] == "settling" and fcfg.q == CONSUMER_Q and "mid-settle" not in snaps:
            snaps["mid-settle"] = (pipe.snapshot(), len(ingested))
            steps = dedup_breakdown(pipe, rng)
    if growths[-1][1] != CONSUMER_Q + 1 or kinds[-1] != "migrating" or not snaps:
        raise AssertionError(f"the feed ended {kinds[-1]} after growths {growths}; "
                             f"snapshots {list(snaps)}")
    snaps["mid-migration"] = (pipe.snapshot(), len(ingested))
    restore_s = {}
    for when, (snap, n) in snaps.items():
        fresh, s, _ = timed_host(lambda: restored_pipeline(pcfg, snap, ingested[:n]))
        restore_s[when] = s
        del fresh
        torch.cuda.empty_cache()
    del snaps
    n_stored = int(filters.stats(pipe.filter_cfg, pipe.filter_state)["n"])
    # batches() from the corpus: its duplicates must drop, fresh documents
    # only at the rate of a digest already stored (and of false positives,
    # n / 2**p, negligible here)
    t0 = time.perf_counter()
    batches = list(pipe.batches(8, docs_per_step=4096))
    batches_s = time.perf_counter() - t0
    for b in batches:
        for k in ("tokens", "targets"):
            t = b[k]
            if t.dtype != torch.int32 or t.device.type != device.type or t.shape != (
                pcfg.batch_size, pcfg.seq_len
            ):
                raise AssertionError(f"batch {k}: {t.dtype} {t.device} {tuple(t.shape)}")
    seen, dropped = pipe.state.docs_seen, pipe.state.docs_dropped
    rate = dropped / seen
    frac = pcfg.duplicate_fraction
    expected = frac + (1 - frac) * (n_stored / 2**32)
    sigma = math.sqrt(expected * (1 - expected) / seen)
    if abs(rate - expected) > 5 * sigma:
        raise AssertionError(f"drop rate {rate} against {expected} +- 5 x {sigma}")
    last = growths[-1][0]
    return {
        "digests_fed": len(ingested) * CONSUMER_DIGESTS,
        "table_capacity": cap,
        "growths (call, to q)": growths,
        "dedup_s_p50": float(np.percentile(secs, 50)),
        "dedup_s_p99": float(np.percentile(secs, 99)),
        "dedup_s_max": float(max(secs)),
        "dedup_s_first_call": secs[0],
        "dedup_s_growth_to_q+1": secs[last],
        "dedup_s_p50_by_kind": {
            k: float(np.median([x for x, c in zip(secs, kinds) if c == k]))
            for k in ("idle", "settling", "migrating")
        },
        "calls": {k: kinds.count(k) for k in ("idle", "settling", "migrating")},
        "a _dedup call's steps mid-settle at q (ms)": steps,
        "restore_and_replay_s": restore_s,
        "batches": len(batches),
        "batches_s": batches_s,
        "docs_seen": seen,
        "drop_rate": rate,
        "expected_drop_rate": expected,
    }


def drive_prefix_cache(device):
    """Phase consumers (b): a ``steady_qf`` prefix cache at q = ``CONSUMER_Q``,
    prefilled to 0.7 load, then request batches with repeated prompts
    (earlier batches' and the batch's own) through ``check_and_insert``,
    then ``evict``."""
    pc = PrefixCacheFilter(
        q=CONSUMER_Q, r=CACHE_R, family="steady_qf", backend="pallas"
    )
    rng = np.random.default_rng(SEED + 30)
    cap = pc.cfg.table.capacity
    prefill = uint32_keys(rng, int(CACHE_PREFILL * cap), device)
    for i in range(0, prefill.shape[0], 1 << 20):
        pc.state = filters.insert(pc.cfg, pc.state, prefill[i : i + (1 << 20)])
    prompts, secs, digest_s = [], [], []
    n_new = extra_hits = 0
    for b in range(CACHE_REQUESTS):
        fresh = rng.integers(0, 32000, (CACHE_BATCH // 2, CACHE_PROMPT), dtype=np.int32)
        ids = np.arange(len(prompts), len(prompts) + fresh.shape[0])
        prompts.extend(fresh)
        old = rng.integers(0, ids[0], CACHE_BATCH // 4) if ids[0] else ids[: CACHE_BATCH // 4]
        dups = rng.choice(ids, CACHE_BATCH - ids.shape[0] - old.shape[0])
        rows = rng.permutation(np.concatenate([ids, old, dups]))
        batch = np.stack([prompts[i] for i in rows])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hit = pc.check_and_insert(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        pc._digest(batch)
        digest_s.append(time.perf_counter() - t0)
        _, first = np.unique(rows, return_index=True)
        want = rows < ids[0]  # prompts of earlier batches
        later = np.ones(rows.shape[0], bool)
        later[first] = False  # every copy after a prompt's first
        want |= later
        if not hit[want].all():
            raise AssertionError(f"request batch {b}: a cached prompt missed")
        n_new += int((~want).sum())
        extra_hits += int((hit & ~want).sum())
    # a new prompt hits when its 32-bit digest is already stored, or at the
    # QF's fp rate n / 2**p
    n = int(filters.stats(pc.cfg, pc.state)["n"])
    budget = 2 * (n / 2**32 + n / 2 ** (CONSUMER_Q + CACHE_R)) * n_new + 10
    if extra_hits > budget:
        raise AssertionError(f"{extra_hits} new prompts hit; budget {budget}")
    evicted = np.stack(prompts[: CACHE_EVICTED * (CACHE_BATCH // 2)])
    kept = np.stack(prompts[CACHE_EVICTED * (CACHE_BATCH // 2) :])
    _, evict_s, _ = timed_host(lambda: pc.evict(evicted))
    if not bool(filters.contains(pc.cfg, pc.state, pc._digest(kept)).all()):
        raise AssertionError("evict: a prompt that was not evicted misses")
    return {
        "requests": CACHE_REQUESTS,
        "prompts_a_request": CACHE_BATCH,
        "request_s_p50": float(np.percentile(secs, 50)),
        "request_s_max": float(max(secs)),
        "digest_s_p50": float(np.percentile(digest_s, 50)),
        "new_prompts": n_new,
        "new_prompts_hit": extra_hits,
        "hit_budget": budget,
        "evict_s": evict_s,
        "n": int(filters.stats(pc.cfg, pc.state)["n"]),
    }


# ---------------------------------------------------------------------------
# phase sharded: the quotient-prefix sharded QF against one flat QF
# ---------------------------------------------------------------------------


def sharded_stream(cfg, state):
    """Every shard's sorted fingerprints, quotients offset by ``s << local q``:
    the stream a flat QF of the same keys holds."""
    local = cfg.core.local_cfg
    dev = state[0].rem.device
    qs, rs = [], []
    for s, st in enumerate(state):
        fq, fr, n = qf.extract(local, st)
        n = int(n)
        qs.append(fq[:n].to(dev) + (s << local.q))
        rs.append(fr[:n].to(dev))
    return torch.cat(qs), torch.cat(rs)


def flat_stream(cfg, state):
    fq, fr, n = qf.extract(cfg.core, state)
    n = int(n)
    return fq[:n], fr[:n]


def check_sharded(label, scfg, sst, fcfg, fst, inserted, fresh) -> dict:
    """The sharded filter holds the flat QF's stream bit for bit and
    answers as it does on ``inserted`` and ``fresh`` keys: no false
    negative, an fp rate at most twice the union bound, no overflow.
    Returns the probe times of both (median of ``PROBE_REPS`` calls by
    CUDA events, ms) and the fp rate."""
    if (scfg.q, scfg.r) != (fcfg.q, fcfg.r):
        raise AssertionError(f"sharded {label}: {scfg} against {fcfg}")
    for a, b in zip(sharded_stream(scfg, sst), flat_stream(fcfg, fst)):
        if not torch.equal(a, b):
            raise AssertionError(f"sharded {label}: stream differs from the flat qf's")
    probes = torch.cat([inserted, fresh])
    hit = filters.contains(scfg, sst, probes)
    if not torch.equal(hit, filters.contains(fcfg, fst, probes)):
        raise AssertionError(f"sharded {label}: hits differ from the flat qf's")
    if not bool(hit[: inserted.shape[0]].all()):
        raise AssertionError(f"sharded {label}: false negative among inserted keys")
    fp_rate = float(hit[inserted.shape[0] :].float().mean())
    bound = union_bound(fcfg, fst)
    if fp_rate > 2 * bound:
        raise AssertionError(f"sharded {label}: fp rate {fp_rate} > 2 x {bound}")
    if bool(filters.stats(scfg, sst)["overflow"]):
        raise AssertionError(f"sharded {label}: overflow")
    return {
        "probe_ms": median_ms(lambda: filters.contains(scfg, sst, probes), PROBE_REPS),
        "flat_probe_ms": median_ms(
            lambda: filters.contains(fcfg, fst, probes), PROBE_REPS
        ),
        "probes": probes.shape[0],
        "fp_rate": fp_rate,
        "union_bound": bound,
    }


def ingest(cfg, state, keys, batch, checkpoints=None):
    """``keys`` in batches of ``batch`` through the façade: the state, the
    wall s around the insert calls and the state after each checkpoint."""
    seconds, kept = 0.0, {}
    for b in range(keys.shape[0] // batch):
        state, s, _ = timed_host(
            lambda: filters.insert(cfg, state, keys[b * batch : (b + 1) * batch])
        )
        seconds += s
        if checkpoints and b + 1 in checkpoints:
            kept[b + 1] = state
    return state, seconds, kept


def sharded_breakdown(cfg, state, batch, probes) -> dict:
    """An insert of ``batch`` and a ``contains`` of ``probes`` split into
    their steps (route and bucket, exchange, the shards' local work, for
    ``contains`` the answers' way back) and whole: median ms of
    ``TIMED_REPS`` calls by CUDA events, each step on the previous step's
    output."""
    core, sf = cfg.core, sharded_filter
    devices = sf.devices_of(state)

    def route(keys):
        return sf.route_and_bucket(core, state, keys, sharded._fingerprints)

    def exchange(buckets, width):
        return [sf.exchange([b[i] for b in buckets], devices) for i in range(width)]

    ib, pb = route(batch), route(probes)
    ir, pr = exchange(ib, 3), exchange(pb, 2)
    hits = sf.lookup_local(core, state, pr, sharded._lookup)
    steps = {
        "insert": {
            "route_and_bucket": lambda: route(batch),
            "exchange": lambda: exchange(ib, 3),
            "local": lambda: sf.insert_local(core, state, ir, sharded._insert_fingerprints),
            "whole": lambda: filters.insert(cfg, state, batch),
        },
        "contains": {
            "route_and_bucket": lambda: route(probes),
            "exchange": lambda: exchange(pb, 2),
            "local": lambda: sf.lookup_local(core, state, pr, sharded._lookup),
            "answers": lambda: sf.answers(hits, pb, devices),
            "whole": lambda: filters.contains(cfg, state, probes),
        },
    }
    return {
        op: {name: median_ms(fn) for name, fn in fns.items()}
        for op, fns in steps.items()
    }


def check_sharded_no_sync(cfg, state, keys) -> None:
    """One sharded insert and one ``contains``, each run once more under
    ``torch.cuda.set_sync_debug_mode("error")``, where a host sync raises."""
    for call in (lambda: filters.insert(cfg, state, keys),
                 lambda: filters.contains(cfg, state, keys)):
        call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def drive_sharded(device, keys, checkpoints, kernels):
    """Phase sharded: phase 3's keys into ``sharded_qf(q=SHARD_Q, n_shards=
    SHARDS)`` (shard ``s`` on ``cuda:(s % device_count)``), then ``grow``,
    ``shrink`` and ``merge``, each held equal to a flat ``qf`` of the same
    keys under ``backend="pallas"``.  The sharded path runs with the
    launch counts at 0 and its counts are read before the flat QFs run.
    Returns the report and the sharded path's launches."""
    r = P_BITS - SHARD_Q
    count = torch.cuda.device_count()
    devices = [torch.device("cuda", s % count) for s in range(SHARDS)]
    if count == 1:
        devices = [device] * SHARDS
    spec = dict(q=SHARD_Q, r=r, n_shards=SHARDS)
    step = keys.shape[0] // BATCHES
    # phase 3's generator went on to its probes' fresh keys
    more = uint32_keys(np.random.default_rng(SEED + 40), SHARD_MERGE_KEYS, device)
    report = {}

    for k in kernels.values():
        k.launches = 0
    scfg, sst = filters.make("sharded_qf", device=devices, **spec)
    report["devices"] = [str(d) for d in sharded_filter.devices_of(sst)]
    sst, report["ingest_s"], s_at = ingest(scfg, sst, keys, step, checkpoints)
    (gcfg, gst), report["grow_s"], _ = timed_host(lambda: filters.grow(scfg, sst))
    (hcfg, hst), report["shrink_s"], _ = timed_host(lambda: filters.shrink(scfg, sst))
    _, other = filters.make("sharded_qf", device=devices, **spec)
    other, _, _ = ingest(scfg, other, more, SHARD_MERGE_BATCH)
    merged, report["merge_s"], _ = timed_host(lambda: filters.merge(scfg, sst, other))
    filters.contains(scfg, sst, torch.cat(checkpoints[BATCHES]))
    launches = {n: k.launches for n, k in kernels.items()}
    del other

    fcfg, fst = filters.make("qf", device=device, q=SHARD_Q, r=r, backend="pallas")
    fst, report["flat_ingest_s"], f_at = ingest(fcfg, fst, keys, step, checkpoints)
    for b, (inserted, fresh) in checkpoints.items():
        report[f"after_{b}"] = check_sharded(
            f"after {b} batches", scfg, s_at[b], fcfg, f_at[b], inserted, fresh
        )
    del s_at, f_at
    inserted, fresh = checkpoints[BATCHES]
    (fg_cfg, fg), report["flat_grow_s"], _ = timed_host(lambda: filters.grow(fcfg, fst))
    report["grow"] = check_sharded("grow", gcfg, gst, fg_cfg, fg, inserted, fresh)
    del gst, fg
    hf_cfg, hf = filters.make(
        "qf", device=device, q=SHARD_Q - 1, r=r + 1, backend="pallas"
    )
    hf, _, _ = ingest(hf_cfg, hf, keys, step)
    if (hcfg.n_shards, hcfg.core.local_cfg) != (SHARDS // 2, scfg.core.local_cfg):
        raise AssertionError(f"sharded shrink: {hcfg}")
    report["shrink"] = check_sharded("shrink", hcfg, hst, hf_cfg, hf, inserted, fresh)
    del hst, hf
    ocfg, ofst = filters.make("qf", device=device, q=SHARD_Q, r=r, backend="pallas")
    ofst, _, _ = ingest(ocfg, ofst, more, SHARD_MERGE_BATCH)
    fm, report["flat_merge_s"], _ = timed_host(lambda: filters.merge(fcfg, fst, ofst))
    # the probes' fresh keys drawn among neither key set
    fresh = fresh[~members(torch.sort(more.to(torch.int64) & 0xFFFFFFFF).values, fresh)]
    report["merge"] = check_sharded(
        "merge", scfg, merged, fcfg, fm, more[:PROBES], fresh
    )
    del ofst, fm, merged
    report["ingest_keys_per_s"] = keys.shape[0] / report["ingest_s"]
    report["flat_ingest_keys_per_s"] = keys.shape[0] / report["flat_ingest_s"]
    report["steps_ms"] = sharded_breakdown(
        scfg, sst, keys[:step], torch.cat(checkpoints[BATCHES])
    )
    check_sharded_no_sync(scfg, sst, keys[:step])
    del fst

    # one shard under device=None: the reference's rule on one card
    solo_cfg, solo = filters.make("sharded_qf", q=SHARD_Q - 3, r=r + 3, n_shards=1)
    solo = filters.insert(solo_cfg, solo, keys[:SHARD_SOLO_KEYS])
    if not bool(filters.contains(solo_cfg, solo, keys[:SHARD_SOLO_KEYS]).all()):
        raise AssertionError("sharded n_shards=1: false negative")
    report["solo_devices"] = [str(s.rem.device) for s in solo]
    # a local remainder of 32 bits, which the plain path keeps, is refused
    # on the card by the kernel path's r <= 31 limit
    rcfg, rst = filters.make("sharded_qf", device=devices, **SHARD_REFUSED)
    try:
        filters.insert(rcfg, rst, keys[:step])
    except ValueError as e:
        report["refused"] = str(e)
    else:
        raise AssertionError("sharded: a local remainder of 32 bits was not refused")
    return report, launches


# ---------------------------------------------------------------------------
# phases ssd_large and figures: the kernel path against the plain one
# ---------------------------------------------------------------------------


def leaves(state) -> list:
    """A state's tensors, depth first."""
    if state is None:
        return []
    if torch.is_tensor(state):
        return [state]
    return [t for v in state for t in leaves(v)]


def against_plain(label, cfg, state, probes, hit) -> None:
    """The kernel path's answers ``hit`` for ``probes`` on ``state`` against
    the plain path's (``cfg`` under ``"reference"``) on the same state."""
    want = filters.contains(cfg._replace(backend="reference"), state, probes)
    if not torch.equal(hit, want):
        raise AssertionError(
            f"{label}: the kernels' hits differ from the plain path's on "
            f"{int((hit != want).sum())} of {probes.shape[0]} keys"
        )


def built_as_plain(label, cfg, empty, keys, state) -> None:
    """``state``, the kernel path's insert of ``keys`` into a copy of
    ``empty``, against the plain insert of the same keys into ``empty``,
    leaf for leaf."""
    want = filters.insert(cfg._replace(backend="reference"), empty, keys)
    err = max_abs_err(leaves(state), leaves(want))
    if err:
        raise AssertionError(f"{label}: the kernels' build differs from the plain one by {err}")


def sigmas(count: int, trials: int, rate: float) -> float:
    """How many binomial sigmas ``count`` of ``trials`` lies from ``rate``
    (0 when the count is the certain one)."""
    sd = math.sqrt(trials * rate * (1 - rate))
    off = count - trials * rate
    return off / sd if sd else (0.0 if off == 0 else math.copysign(math.inf, off))


def qf_fp_expected(core, keys) -> float:
    """The fp rate a uniform member-free probe meets in a QF holding
    ``keys``.  The fingerprint's top 32 bits are a bijection of the 32-bit
    key, so of the 2**32 - n non-members exactly D * 2**(32 - p) - n share
    the p-bit prefix of one of the D distinct member fingerprints, and at
    p >= 32 none does."""
    p = core.q + core.r
    if p >= 32:
        return 0.0
    fq, fr = qf.fingerprints(core, keys)
    d = torch.unique((fq.to(torch.int64) << core.r) | fr.to(torch.int64)).numel()
    n = torch.unique(keys).numel()
    return (d * 2 ** (32 - p) - n) / (2**32 - n)


@contextlib.contextmanager
def last_build_at(q: int):
    """Yield a list that, after the block, holds a copy of the inputs of
    the last ``ops.build_sorted`` call at ``q`` made inside it (taken
    before the build reads them)."""
    last = []
    real = ops.build_sorted

    def record(cfg, *args):
        if cfg.q == q:
            last[:] = [(cfg,) + tuple(a.clone() if torch.is_tensor(a) else a for a in args)]
        return real(cfg, *args)

    ops.build_sorted = record
    try:
        yield last
    finally:
        ops.build_sorted = real


def check_deep_build(label, recorded) -> dict:
    """``ops.build_sorted`` (``qf_positions``, then ``qf_build_planes``) on
    the recorded inputs of a build, bit for bit against the plain
    ``quotient_filter.build_sorted`` on the same card tensors."""
    if not recorded:
        raise AssertionError(f"{label}: no build was recorded")
    cfg, fq, fr, n = recorded.pop()
    err = max_abs_err(leaves(ops.build_sorted(cfg, fq, fr, n)),
                      leaves(qf.build_sorted(cfg, fq, fr, n)))
    if err:
        raise AssertionError(f"{label}: ops.build_sorted differs from build_sorted by {err}")
    return {"q": cfg.q, "rows": fq.shape[0], "n": int(n), "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase ssd_large: Table 1(b) at 1:24
# ---------------------------------------------------------------------------


class Functional:
    """bench_ssd's ``_Functional``: a façade filter behind the
    insert/lookup/io surface of the Bloom baselines."""

    def __init__(self, name, device, **spec):
        self.cfg, self.state = filters.make(name, device=device, **spec)

    def insert(self, keys) -> None:
        self.state = filters.insert(self.cfg, self.state, keys)

    def lookup(self, keys):
        self.state, hit = filters.probe(self.cfg, self.state, keys)
        return hit

    @property
    def io(self):
        return filters.to_iolog(self.state.io)


def ssd_makers(ratio: int, ram_q: int, n_total: int, device) -> dict:
    """bench_ssd's ``_mk_structs`` at ``ram_q`` (p = ram_q + 15), the QF
    structures under ``"pallas"``: one maker by name."""
    p = ram_q + 15
    return {
        "cf": lambda: Functional(
            "cascade", device, ram_q=ram_q, p=p, fanout=2, levels=6, backend="pallas"
        ),
        "bqf": lambda: Functional(
            "buffered_qf", device, ram_q=ram_q, disk_q=ssd_disk_q(ratio, ram_q), p=p,
            backend="pallas",
        ),
        **baseline_makers(n_total, device, ratio),
    }


def ssd_disk_q(ratio: int, ram_q: int) -> int:
    """bench_ssd's disk QF: room for ``ratio`` RAM loads with 1.8x slack."""
    return ram_q + max(2, int(np.ceil(np.log2(ratio * 1.8))))


def ssd_experiment(ratio: int, ram_q: int, n_checks: int, device):
    """bench_ssd's ``_experiment(ratio, ...)`` at ``ram_q``.

    The bench's draws (``default_rng(ratio)``: ``ratio`` RAM capacities
    of keys, 2048 uniform lookups from [2**31, 2**32), 2048 picks of
    inserted keys), its five structures and its batches of
    ``max(256, n / 64)``.  Then ``n_checks`` more picks of inserted keys
    (no false negative) and ``n_checks`` fresh keys through the two QF
    structures, which account no I/O: their answers equal the plain
    path's on the same state, the fp rate is at most twice the union bound
    and exactly 0 at p >= 32 (the fingerprint is a bijection of the key
    there), and nothing overflowed.  Returns ``(report, logs, hits)``: the
    report's modeled ops/s on the paper's SSD, ``vs_best_bf`` with and
    without the FBF, ``cf/bqf`` beside the paper's 1.26 and the measured
    ingest; per structure the bench's three ``IOLog``s and the two
    lookups' hits.
    """
    rng = np.random.default_rng(ratio)
    n_total = ratio * qf.QFConfig(q=ram_q, r=1).capacity
    keys = uint32_keys(rng, n_total, device)
    pick = torch.from_numpy(rng.integers(0, n_total, PAPER_LOOKUPS)).to(device)
    lookups = (uint32_keys(rng, PAPER_LOOKUPS, device, lo=2**31), keys[pick])
    sample = keys[torch.from_numpy(rng.integers(0, n_total, n_checks)).to(device)]
    inserted_sorted = torch.sort(keys.to(torch.int64) & 0xFFFFFFFF).values
    fresh = fresh_keys(rng, inserted_sorted, n_checks, device)
    del inserted_sorted
    step = max(256, n_total // 64)
    logs, hits, keys_per_s, checks = {}, {}, {}, {}
    for name, make in ssd_makers(ratio, ram_q, n_total, device).items():
        struct = make()
        logs[name], ingest_s, hits[name] = baseline_io(struct, keys, lookups, step)
        keys_per_s[name] = n_total / ingest_s
        if isinstance(struct, Functional):
            cfg, state = struct.cfg, struct.state
            label = f"ssd 1:{ratio} {name}"
            sample_hit = filters.contains(cfg, state, sample)
            fresh_hit = filters.contains(cfg, state, fresh)
            against_plain(f"{label} members", cfg, state, sample, sample_hit)
            against_plain(f"{label} fresh keys", cfg, state, fresh, fresh_hit)
            if not bool(sample_hit.all()):
                raise AssertionError(f"{label}: false negative")
            fps = int(fresh_hit.sum())
            fp_rate = fps / fresh.shape[0]
            bound = union_bound(cfg, state)
            if fp_rate > 2 * bound:
                raise AssertionError(f"{label}: fp {fp_rate} > 2 x {bound}")
            if ram_q + 15 >= 32 and fps:
                raise AssertionError(f"{label}: {fps} false positives at p >= 32")
            if bool(filters.stats(cfg, state)["overflow"]):
                raise AssertionError(f"{label}: overflow")
            checks[name] = {"fp_rate": fp_rate, "union_bound": bound,
                            "hits_equal_plain": sample.shape[0] + fresh.shape[0]}
        del struct
        torch.cuda.empty_cache()
    modeled = {name: modeled_ops(n_total, lg) for name, lg in logs.items()}
    ins = {name: m["insert"] for name, m in modeled.items()}
    best = {
        "with_fbf": max(("ebf", "bbf", "fbf"), key=ins.get),
        "without_fbf": max(("ebf", "bbf"), key=ins.get),
    }
    report = {
        "ratio": ratio, "ram_q": ram_q, "p": ram_q + 15, "keys": n_total,
        "batch": step, "bloom_cells": bloom_m_bits(n_total),
        "modeled_ops_per_s": modeled,
        "best_bf": best,
        "vs_best_bf": {
            variant: {n: ins[n] / ins[bf] for n in ("cf", "bqf")}
            for variant, bf in best.items()
        },
        "cf_over_bqf": ins["cf"] / ins["bqf"],
        "paper_cf_over_bqf": PAPER_CF_OVER_BQF,
        "card_ingest_keys_per_s": keys_per_s,
        "checks": checks,
        "logs": {n: [vars(x) for x in lg] for n, lg in logs.items()},
    }
    return report, logs, hits


# ---------------------------------------------------------------------------
# phase figures: Figs 1/2, 4, 6 and 9
# ---------------------------------------------------------------------------


def fp_row(label, hit, expected: float, analytic: float, bits_per_element: float):
    """A filter's fp count on member-free probes (``hit``) beside its
    analytic rate and the rate it should meet (``expected``), which it
    must meet within 6 sigma."""
    fps, trials = int(hit.sum()), hit.shape[0]
    z = sigmas(fps, trials, expected)
    if not abs(z) <= 6:
        raise AssertionError(f"{label}: {fps} false positives of {trials}, "
                             f"{z} sigma from the rate {expected}")
    empirical = fps / trials
    return {
        "false_positives": fps, "empirical": empirical, "analytic": analytic,
        "ratio": empirical / analytic, "expected": expected, "sigmas": z,
        "bits_per_element": bits_per_element,
    }


def fprate_experiment(q: int, n_probes: int, device) -> dict:
    """``benchmarks/bench_fprate.py`` (Figs 1/2) at ``q``.

    Its draws (``default_rng(7)``: n = 0.75 * 2**q keys, then ``n_probes``
    from [2**31, 2**32), here with the inserted keys among them removed),
    ``qf(q, r, slack=2048)`` for r = 4, 6, 8, 10, 12 against
    1 - e**(-n / 2**(q + r)) and ``bloom(m = n * bits, k = optimal_k)``
    for bits = 6, 9, 12, 15 against (1 - e**(-k n / m))**k, all under
    ``"pallas"``.  Each structure is held against the plain path: its
    build against the plain insert of the same keys, leaf for leaf, and
    its answers to the members and the probes against the plain probe of
    the same state.  Checked besides: no false negative, no overflow, each
    empirical/analytic ratio at most 2, and each fp count within 6 sigma
    of the rate it should meet: ``qf_fp_expected`` for a QF (below the
    analytic rate by the factor 1 - 2**(q + r - 32)), the analytic rate for
    a Bloom filter.
    """
    rng = np.random.default_rng(7)
    n = int((1 << q) * 0.75)
    keys = uint32_keys(rng, n, device)
    probes = uint32_keys(rng, n_probes, device, lo=2**31)
    probes = probes[~members(torch.sort(keys.to(torch.int64) & 0xFFFFFFFF).values, probes)]
    out = {"q": q, "n": n, "probes": probes.shape[0], "qf": {}, "bloom": {}}

    def held(label, name, **spec):
        """A structure holding ``keys`` and its hits for the probes, both
        held against the plain path."""
        cfg, empty = filters.make(name, device=device, backend="pallas", **spec)
        st = filters.insert(cfg, clone_state(empty), keys)
        built_as_plain(label, cfg, empty, keys, st)
        member_hit = filters.contains(cfg, st, keys)
        hit = filters.contains(cfg, st, probes)
        against_plain(f"{label} members", cfg, st, keys, member_hit)
        against_plain(f"{label} probes", cfg, st, probes, hit)
        if not bool(member_hit.all()):
            raise AssertionError(f"{label}: false negative")
        if name == "qf" and bool(filters.stats(cfg, st)["overflow"]):
            raise AssertionError(f"{label}: overflow")
        return cfg, hit

    for r in (4, 6, 8, 10, 12):
        label = f"fprate qf r={r}"
        cfg, hit = held(label, "qf", q=q, r=r, slack=2048)
        analytic = 1 - math.exp(-n / 2 ** (q + r))
        expected = qf_fp_expected(cfg.core, keys)
        out["qf"][r] = fp_row(label, hit, expected, analytic, (r + 3) / 0.75)
    for bits in (6, 9, 12, 15):
        label = f"fprate bloom {bits} bits"
        k = bloom.optimal_k(bits)
        m_bits = n * bits
        _, hit = held(label, "bloom", m_bits=m_bits, k=k)
        analytic = (1 - math.exp(-k * n / m_bits)) ** k
        out["bloom"][bits] = fp_row(label, hit, analytic, analytic, float(bits))
    for kind in ("qf", "bloom"):
        for x, row in out[kind].items():
            if row["ratio"] > 2:
                raise AssertionError(f"fprate {kind} {x}: ratio {row['ratio']} > 2")
    return out


def cluster_lengths(nonempty):
    """The lengths of the runs of set slots, as bench_clusters finds them."""
    x = torch.nn.functional.pad(nonempty.to(torch.int8), (1, 1))
    edges = x[1:] - x[:-1]
    return (edges == -1).nonzero().squeeze(1) - (edges == 1).nonzero().squeeze(1)


def clusters_experiment(q: int, device):
    """``benchmarks/bench_clusters.py`` (Fig 4) at ``q``.

    Its draws (``default_rng(4)``, one batch of alpha * 2**q keys a load)
    into ``qf(q, r=10, slack=4096, max_load=alpha)`` under ``"pallas"``
    for alpha = 0.5, 0.75, 0.9, each build held against the plain insert
    of the same keys, leaf for leaf; the cluster lengths are the runs of
    ``occ | shf``, found on the device.  Checked: mean under
    1 / (1 - alpha e**(1 - alpha)), no overflow.  Returns the report by
    alpha and the lengths (numpy) by alpha.
    """
    rng = np.random.default_rng(4)
    report, lengths = {}, {}
    for alpha in (0.5, 0.75, 0.9):
        cfg, empty = filters.make(
            "qf", device=device, q=q, r=10, slack=4096, max_load=alpha, backend="pallas"
        )
        n = int((1 << q) * alpha)
        keys = uint32_keys(rng, n, device)
        st = filters.insert(cfg, clone_state(empty), keys)
        built_as_plain(f"clusters alpha={alpha}", cfg, empty, keys, st)
        if bool(filters.stats(cfg, st)["overflow"]):
            raise AssertionError(f"clusters alpha={alpha}: overflow")
        got = cluster_lengths(st.occ | st.shf).cpu().numpy()
        mean = float(got.mean())
        bound = 1.0 / (1 - alpha * math.exp(1 - alpha))
        if not mean < bound:
            raise AssertionError(f"clusters alpha={alpha}: mean {mean} >= {bound}")
        report[alpha] = {
            "keys": n, "clusters": int(got.shape[0]), "mean": mean,
            "p99": float(np.percentile(got, 99)), "max": int(got.max()),
            "analytic_mean_bound": bound,
        }
        lengths[alpha] = got
    return report, lengths


def occupancy_experiment(q: int, batch: int, n_probes: int, device):
    """``benchmarks/bench_occupancy.py`` (Fig 6) at ``q``.

    Its draws (``default_rng(5)``: ``n_probes`` from [2**31, 2**32) first,
    then the fill) into ``qf(q, r=10, slack=4096, max_load=0.95)`` and
    ``bloom(k=9, m = 2**q * 0.95 * 9 / ln 2)`` under ``"pallas"``, in
    batches of at most ``batch`` keys to 30%, 60% and 90% of 2**q; at each
    step both answer the probes, timed by ``median_ms``, and their answers
    equal the plain path's on the same state.  Returns the report (q/s of
    both, the QF's lookup_90/30), the fill schedule (batch sizes) and the
    hits (QF, Bloom) by step.
    """
    rng = np.random.default_rng(5)
    cfg, st = filters.make(
        "qf", device=device, q=q, r=10, slack=4096, max_load=0.95, backend="pallas"
    )
    k = 9
    m_bits = int((1 << q) * 0.95 * k / np.log(2))
    bcfg, bits = filters.make("bloom", device=device, m_bits=m_bits, k=k, backend="pallas")
    probes = uint32_keys(rng, n_probes, device, lo=2**31)
    report, schedule, hits = {"q": q, "probes": n_probes}, [], {}
    for pct in (30, 60, 90):
        target = int((1 << q) * pct / 100)
        while int(st.n) < target:
            keys = uint32_keys(rng, min(batch, target - int(st.n)), device)
            st = filters.insert(cfg, st, keys)
            bits = filters.insert(bcfg, bits, keys)
            schedule.append(keys.shape[0])
        hits[pct] = (filters.contains(cfg, st, probes), filters.contains(bcfg, bits, probes))
        against_plain(f"occupancy qf {pct}%", cfg, st, probes, hits[pct][0])
        against_plain(f"occupancy bloom {pct}%", bcfg, bits, probes, hits[pct][1])
        qf_ms = median_ms(lambda: filters.contains(cfg, st, probes))
        bf_ms = median_ms(lambda: filters.contains(bcfg, bits, probes))
        report[pct] = {
            "qf_ms": qf_ms, "bf_ms": bf_ms, "qf_lookup_per_s": n_probes / qf_ms * 1e3,
            "bf_lookup_per_s": n_probes / bf_ms * 1e3,
        }
    if bool(filters.stats(cfg, st)["overflow"]):
        raise AssertionError("occupancy qf: overflow")
    report["qf_lookup_90/30"] = report[90]["qf_ms"] / report[30]["qf_ms"]
    return report, schedule, hits


def fanout_experiment(ram_q: int, p: int, n: int, step: int, n_lookups: int,
                      n_sample: int, device):
    """``benchmarks/bench_fanout.py`` (Fig 9) through the ``CascadeFilter`` shim.

    For fanout 2, 4 and 16, each from ``default_rng(9)``: ``n`` keys
    inserted ``step`` at a time (the last batch may be shorter), then
    ``n_lookups`` uniform lookups from [2**31, 2**32); modeled insert and
    lookup ops/s on the paper's SSD, the non-empty levels and the
    measured ingest.  Checked: every non-empty level's kernel probe of the
    lookups equals the plain probe of the same level, no false negative on
    ``n_sample`` inserted keys (after the lookups' log is taken), and the
    bench's trade-off: lookup(16) >= lookup(2) and insert(2) >= insert(16).
    Returns the
    report by fanout and, by fanout, the ingest and lookup logs and the
    lookups' hits.
    """
    rate = lambda count, io: cost_model.modeled_throughput(
        count, io, cost_model.PAPER_SSD
    )
    report, logs, hits = {}, {}, {}
    for fanout in (2, 4, 16):
        rng = np.random.default_rng(9)
        cf = CascadeFilter(ram_q=ram_q, p=p, fanout=fanout, device=device)
        keys = uint32_keys(rng, n, device)

        def run():
            for i in range(0, n, step):
                cf.insert(keys[i : i + step])

        ingest_s = timed_host(run)[1]
        ingest = cf.io.snapshot()
        probes = uint32_keys(rng, n_lookups, device, lo=2**31)
        hits[fanout] = cf.lookup(probes)
        lookup = cf.io.delta(ingest)
        logs[fanout] = (ingest, lookup)
        levels_as_plain(f"fanout {fanout}", cf, probes)
        if not bool(cf.lookup(keys[:: max(1, n // n_sample)]).all()):
            raise AssertionError(f"fanout {fanout}: false negative")
        report[fanout] = {
            "insert_ops_per_s": rate(n, ingest),
            "lookup_ops_per_s": rate(n_lookups, lookup),
            "levels": cf.n_nonempty_levels(),
            "level_qs": [c.q for c, s in cf.levels if int(s.n) > 0],
            "card_insert_keys_per_s": n / ingest_s,
        }
        del cf, keys
        torch.cuda.empty_cache()
    lo, hi = report[2], report[16]
    if not (hi["lookup_ops_per_s"] >= lo["lookup_ops_per_s"]
            and lo["insert_ops_per_s"] >= hi["insert_ops_per_s"]):
        raise AssertionError(f"fanout: the trade-off does not hold: {report}")
    return report, logs, hits


def levels_as_plain(label, cf, keys) -> None:
    """Each non-empty level of a ``CascadeFilter``: its probe of ``keys`` by
    the shim's path against the plain ``quotient_filter.contains`` of the
    same level."""
    for cfg, state in [(cf.q0_cfg, cf.q0)] + cf.levels:
        if int(state.n) == 0:
            continue
        got = qf_filter.contains_keys(cfg, cf._backend, state, keys)
        if not torch.equal(got, qf.contains(cfg, state, keys)):
            raise AssertionError(f"{label}: the level at q = {cfg.q} differs from "
                                 "its plain probe")


SHIMS = {
    "BufferedQuotientFilter": lambda device: BufferedQuotientFilter(
        qf.QFConfig(q=SHIM_Q, r=SHIM_P - SHIM_Q),
        qf.QFConfig(q=SHIM_Q + 4, r=SHIM_P - SHIM_Q - 4),
        device=device,
    ),
    "CascadeFilter": lambda device: CascadeFilter(
        ram_q=SHIM_Q, p=SHIM_P, fanout=4, deamortize=True, device=device
    ),
}


def shim_run(shim, batches, probes) -> dict:
    """``batches`` into one of ``SHIMS``: every leaf (on the CPU), the
    ``IOLog`` after each batch, the count, the non-empty levels and the
    hits of ``probes``."""
    ios = []
    for b in batches:
        shim.insert(b.to(shim.device))
        ios.append(vars(shim.io.snapshot()))
    hit = shim.lookup(probes.to(shim.device)).cpu()
    if isinstance(shim, BufferedQuotientFilter):
        states, levels = [shim.ram, shim.disk], None
    else:
        states, levels = [shim.q0] + [s for _, s in shim.levels], shim.n_nonempty_levels()
    return {
        "leaves": [t.cpu() for s in states for t in s],
        "ios": ios,
        "hit": hit,
        "counts": (shim.count, levels),
    }


def check_shims(device, kernels, needed) -> dict:
    """Each of ``SHIMS`` on ``device`` and on the CPU: equal leaves,
    ``IOLog``s after every batch, counts and hits, and no false negative.
    Each card run, counted alone, must launch every kernel in ``needed``."""
    rng = np.random.default_rng(SEED + 50)
    keys = uint32_keys(rng, SHIM_BATCH * SHIM_BATCHES, "cpu")
    members_probed = keys[::8]
    probes = torch.cat([members_probed, uint32_keys(rng, SHIM_BATCH * 4, "cpu")])
    batches = keys.split(SHIM_BATCH)
    out = {"keys": keys.shape[0]}
    for name, make in SHIMS.items():
        card, launched = counted(
            kernels, needed, f"{name} shim on the card",
            lambda: shim_run(make(device), batches, probes),
        )
        cpu = shim_run(make("cpu"), batches, probes)
        if not (len(card["leaves"]) == len(cpu["leaves"]) and all(
            torch.equal(x, y) for x, y in zip(card["leaves"], cpu["leaves"])
        )):
            raise AssertionError(f"{name}: the card's leaves differ from the CPU's")
        if not torch.equal(card["hit"], cpu["hit"]):
            raise AssertionError(f"{name}: the card's hits differ from the CPU's")
        for what in ("ios", "counts"):
            if card[what] != cpu[what]:
                raise AssertionError(f"{name}: the card's {what} differ from the CPU's")
        if not bool(card["hit"][: members_probed.shape[0]].all()):
            raise AssertionError(f"{name}: false negative")
        count, levels = card["counts"]
        out[name] = {"count": count, "levels": levels, "io": card["ios"][-1],
                     "launches": {n: launched[n] for n in needed}}
    return out


def counted(kernels, needed, label, fn):
    """``fn()`` with every launch count set to 0 before it; each kernel in
    ``needed`` must have launched.  Returns the result and the counts."""
    for k in kernels.values():
        k.launches = 0
    out = fn()
    counts = {n: k.launches for n, k in kernels.items()}
    missing = [n for n in needed if counts[n] <= 0]
    if missing:
        raise AssertionError(f"{missing} not launched on the {label} path")
    log(f"  {label} launches: {counts}")
    return out, counts


def figures(device, kernels) -> dict:
    """Phase figures: Figs 1/2, 6, 4 and 9 at their scaled sizes, and the
    shims on the card against the CPU, each with its kernels' launches."""
    qf_path = ("qf_positions", "qf_build_planes", "qf_probe", "fingerprint")
    bloom_path = qf_path + ("bloom_count", "bloom_probe")
    out = {}
    out["fig_1_2_fprate"], _ = counted(
        kernels, bloom_path, "fprate", lambda: fprate_experiment(FP_Q, FP_PROBES, device)
    )
    (out["fig_6_occupancy"], schedule, _), _ = counted(
        kernels, bloom_path, "occupancy",
        lambda: occupancy_experiment(OCC_Q, OCC_BATCH, OCC_PROBES, device),
    )
    out["fig_6_occupancy"]["batches"] = len(schedule)
    (out["fig_4_clusters"], _), _ = counted(
        kernels, ("qf_positions", "qf_build_planes", "fingerprint"), "clusters",
        lambda: clusters_experiment(CLUSTER_Q, device),
    )

    (out["fig_9_fanout"], _, _), _ = counted(
        kernels, qf_path, "fanout",
        lambda: fanout_experiment(FANOUT_RAM_Q, FANOUT_P, FANOUT_N, FANOUT_STEP,
                                  FANOUT_LOOKUPS, FANOUT_SAMPLE, device),
    )
    out["shims_card_vs_cpu"] = check_shims(device, kernels, qf_path)
    return out


# ---------------------------------------------------------------------------
# phase serve: the LLM serving path in front of the prefix cache
# ---------------------------------------------------------------------------


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return float((got - want).abs().max() / want.abs().max())


def greedy(params, cfg, batch, steps: int, rules=None):
    """Prefill ``batch`` (tokens, and frames for an encoder-decoder), then
    ``steps`` greedy decode steps: every step's logits (the prefill's last
    first), the greedy tokens and the cache.  With ``rules`` (of a mesh
    with a ``DeviceMesh``: placed params and batch) all of it runs under
    them, the cache placed by ``serve_step.place_cache`` after the
    prefill, the logits and tokens gathered whole."""
    with llm_sharding.use_rules(rules):
        logits, cache = llm.prefill(params, cfg, batch)
    if rules is not None:
        cache = serve_step.place_cache(cache, cfg, rules)
    out = [logits]
    tok = serve_step.sample_greedy(logits)[:, None]
    toks = [tok]
    with llm_sharding.use_rules(rules):
        for _ in range(steps):
            logits, cache = llm.decode_step(params, cfg, cache, tok)
            tok = serve_step.sample_greedy(logits)[:, None]
            out.append(logits)
            toks.append(tok)
    return ([llm_sharding.whole(t) for t in out],
            torch.cat([llm_sharding.whole(t) for t in toks], dim=1), cache)


def check_cache_equal(label, got, want, path=()) -> float:
    """K/V within ``SERVE_RTOL`` (the largest error is returned); ``kpos``
    and ``pos`` exact."""
    worst = 0.0
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            worst = max(worst, check_cache_equal(label, g, w, path + (key,)))
        elif key in ("kpos", "pos"):
            if not torch.equal(g.cpu(), w.cpu()):
                raise AssertionError(f"{label}: {'/'.join(path + (key,))} differs")
        else:
            err = rel_err(g.cpu(), w.cpu())
            if not err < SERVE_RTOL:
                raise AssertionError(f"{label}: {'/'.join(path + (key,))} off by {err}")
            worst = max(worst, err)
    return worst


def smoke_card_vs_cpu(device, names) -> dict:
    """Each arch of ``names`` under ``make_smoke`` (float32): params made once
    on the CPU and copied to the card; the prefill (of frames too, for an
    encoder-decoder) and ``SERVE_SMOKE_STEPS`` greedy decode steps on the
    card against the CPU port.  A model with RG-LRU layers takes its
    leaves at their true fan-in, as ``tests/test_torch_recurrent.py``
    does: at ``init``'s scale (a smoke stacked leaf's fan-in is 1) its
    gates saturate, a_t comes within float32 rounding of 1, and
    sqrt(1 - a_t^2) turns a last-bit difference into about 2e-4 of the
    state in eight steps."""
    out = {}
    for name in names:
        cfg = make_smoke(get_config(name))
        params = llm.init(cfg, SEED, device="cpu")
        if "rec" in llm_transformer.layer_kinds(cfg):
            at_true_fan_in(params, cfg)
        on_card = llm_schema.tree_map(lambda t: t.to(device), params)
        rng = np.random.default_rng(SEED + 60)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32))}
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.from_numpy(
                rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        c_logits, c_toks, c_cache = greedy(params, cfg, batch, SERVE_SMOKE_STEPS)
        g_logits, g_toks, g_cache = greedy(
            on_card, cfg, {k: t.to(device) for k, t in batch.items()}, SERVE_SMOKE_STEPS)
        if not torch.equal(g_toks.cpu(), c_toks):
            raise AssertionError(f"{name}: the card's greedy tokens differ from the CPU's")
        errs = [rel_err(g.cpu(), c) for g, c in zip(g_logits, c_logits)]
        if not max(errs) < SERVE_RTOL:
            raise AssertionError(f"{name}: the card's logits are off by {max(errs)}")
        kv_err = check_cache_equal(name, g_cache, c_cache)
        out[name] = {"logits_rel_err": max(errs), "kv_rel_err": kv_err,
                     "pos": int(g_cache["pos"])}
    return out


@contextlib.contextmanager
def recorded_picks(cfg, passes: int):
    """The experts each ``moe.route`` call picks (B, S, top_k), in call
    (layer) order, while the block runs ``passes`` passes of ``cfg``'s
    model: one call a MoE layer a pass, or the block fails."""
    picks, route = [], llm_moe.route

    def recording(p, x, cfg):
        out = route(p, x, cfg)
        picks.append(out[2])
        return out

    llm_moe.route = recording
    try:
        yield picks
    finally:
        llm_moe.route = route
    if len(picks) != passes * moe_layers(cfg):
        raise AssertionError(f"{cfg.name}: {len(picks)} routings recorded in {passes} passes "
                             f"of {moe_layers(cfg)} MoE layers")


@contextlib.contextmanager
def forced_picks(cfg, picks, positions: slice):
    """One pass of ``cfg``'s model routed as ``forward`` routed: each
    ``moe.route`` call runs the router and takes its experts from ``picks``
    (forward's, in layer order) at ``positions``, weighted by its own
    probabilities renormalised as ``route`` does."""
    route, left = llm_moe.route, list(picks)

    def forcing(p, x, cfg):
        probs, _, _ = route(p, x, cfg)
        idx = left.pop(0)[:, positions]
        w = probs.gather(-1, idx)
        return probs, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx

    llm_moe.route = forcing
    try:
        yield
    finally:
        llm_moe.route = route
    if left:
        raise AssertionError(f"{cfg.name}: {len(left)} of forward's routings left unused")


def decode_readings(params, cfg, batch, nxt, sync_check=False) -> dict:
    """Prefill ``batch`` (its tokens, and frames for an encoder-decoder) and
    decode ``nxt``; their logits against ``forward`` over the whole
    sequence (``forward`` takes the naive attention path at S + 1; a
    prefill of S > 2048, a multiple of 512, the chunked one), as
    max |d| / max |logit|.  For a MoE model also the (layer, row) routing
    decisions that differ between ``forward`` and the prefill, and between
    ``forward`` and the step at the decoded position, and the same prefill
    and step again routed as ``forward`` routed (``forced_*``)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    with recorded_picks(cfg, 1) as full_picks:
        full, _, _ = llm.forward(params, cfg, dict(batch, tokens=torch.cat([tokens, nxt], dim=1)))
    want_last, want_step = full[:, S - 1].clone(), full[:, S].clone()
    del full
    with recorded_picks(cfg, 2) as picks:
        last, cache = llm.prefill(params, cfg, batch)
        if sync_check:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                step, cache = llm.decode_step(params, cfg, cache, nxt)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            step, cache = llm.decode_step(params, cfg, cache, nxt)
    out = {
        "prefill_rel_err": rel_err(last, want_last),
        "decode_rel_err": rel_err(step, want_step),
        "decode_mean_rel_err": float((step.float() - want_step.float()).abs().mean()
                                     / want_step.float().abs().max()),
        "pos": int(cache["pos"]),
    }
    if not cfg.is_moe:
        return out
    n = len(full_picks)
    out["routing_decisions_differing"] = sum(
        int((f[:, S].sort(-1).values != d[:, 0].sort(-1).values).any(-1).sum())
        for f, d in zip(full_picks, picks[n:])
    )
    out["routing_decisions"] = n * tokens.shape[0]
    out["prefill_routing_decisions_differing"] = sum(
        int((f[:, :S].sort(-1).values != p.sort(-1).values).any(-1).sum())
        for f, p in zip(full_picks, picks[:n])
    )
    with forced_picks(cfg, full_picks, slice(0, S)):
        last, cache = llm.prefill(params, cfg, batch)
    with forced_picks(cfg, full_picks, slice(S, S + 1)):
        step, cache = llm.decode_step(params, cfg, cache, nxt)
    out["forced_prefill_rel_err"] = rel_err(last, want_last)
    out["forced_decode_rel_err"] = rel_err(step, want_step)
    log(f"  {cfg.name} ({cfg.act_dtype}) at {tuple(tokens.shape)}: "
        f"{out['routing_decisions_differing']} of {out['routing_decisions']} (layer, row) "
        "routing decisions of the decoded position differ from forward's, "
        f"{out['prefill_routing_decisions_differing']} of the prefill's {n * tokens.numel()}; "
        f"decode off by {out['decode_rel_err']}, prefill by {out['prefill_rel_err']}; "
        f"routed as forward, {out['forced_decode_rel_err']} and {out['forced_prefill_rel_err']}")
    return out


def decode_against_forward(params, cfg, batch, nxt, sync_check=False) -> dict:
    """``decode_readings`` held to ``SERVE_BF16_BOUND`` where decode and
    forward route alike: a dense model's, a MoE model's routed as forward
    routed, and its own too where no routing decision differs."""
    out = decode_readings(params, cfg, batch, nxt, sync_check)
    tokens = batch["tokens"]
    held = ["prefill_rel_err", "decode_rel_err"]
    if cfg.is_moe:
        alike = out["routing_decisions_differing"] + out["prefill_routing_decisions_differing"] == 0
        held = [f"forced_{k}" for k in held] + (held if alike else [])
    for key in held:
        if not out[key] < SERVE_BF16_BOUND:
            raise AssertionError(
                f"{cfg.name} at {tuple(tokens.shape)}: {key} {out[key]} >= {SERVE_BF16_BOUND}"
            )
    S = tokens.shape[1]
    if out["pos"] != S + 1:
        raise AssertionError(f"decode left pos at {out['pos']}, not {S + 1}")
    return out


def timed_serving(params, cfg, batch, steps: int) -> dict:
    """Prefill ms (median of ``SERVE_REPS`` by CUDA events) and decode ms a
    step (``steps`` greedy steps after two untimed ones), beside their
    bounds; for a MoE model the decode bound reads the experts that one
    more step's tokens pick, counted outside the timed window."""
    B, S = batch["tokens"].shape
    prefill_ms = median_ms(lambda: llm.prefill(params, cfg, batch), SERVE_REPS)
    logits, cache = llm.prefill(params, cfg, batch)
    tok = serve_step.sample_greedy(logits)[:, None]

    def step():
        nonlocal tok, cache
        logits, cache = llm.decode_step(params, cfg, cache, tok)
        tok = serve_step.sample_greedy(logits)[:, None]

    decode_ms = cuda_ms(step, steps, warmup=2)
    ops, busy = decode_profile(step, SERVE_PROFILED_STEPS)
    with recorded_picks(cfg, 1) as picks:
        step()
    picked = sum(int(torch.unique(t).numel()) for t in picks)
    bound_ms, flops, bound_by = prefill_bound_ms(cfg, B, S)
    cached = S + 2 + (steps - 1) / 2  # cached positions a row, the timed steps' mean
    d_bound = decode_bound_ms(cfg, B, cached, picked)
    out = {
        "prefill_ms": prefill_ms, "prefill_bound_ms": bound_ms, "prefill_bound_by": bound_by,
        "prefill_tflops": flops / prefill_ms / 1e9,
        "decode_ms_a_step": decode_ms, "decode_bound_ms": d_bound,
        "decode_tokens_per_s": B / decode_ms * 1e3,
        "decode_bound_tokens_per_s": B / d_bound * 1e3,
        "decode_ops_a_step": ops,
        "decode_device_busy_share": busy,
    }
    if picks:
        out["decode_experts_picked_a_layer"] = picked / len(picks)
    return out


def decode_profile(step, steps: int) -> tuple:
    """The aten operations of one ``step()`` (each a launch or a view), and
    the share of ``steps`` steps' wall time in which the card ran a kernel
    (``torch.profiler``'s kernel intervals over the host clock around
    them); None where the profiler saw no kernel."""
    with OpCount() as count:
        step()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.profiler.DeviceType.CUDA)
    return count.n, (busy_us / wall_us if busy_us else None)


def full_width_params(cfg, device) -> tuple:
    """``cfg``'s params from a seeded CUDA generator, their count held against
    the schema's.  Returns (params, {params, weights' bytes, init s})."""
    t0 = time.perf_counter()
    params = llm.init(cfg, SEED, device)
    torch.cuda.synchronize()
    leaves = [t for _, t in llm_schema.tree_items(params)]
    n = sum(t.numel() for t in leaves)
    if n != llm_params(cfg):
        raise AssertionError(f"{n} params, the schema has {llm_params(cfg)}")
    return params, {"params": n, "weights_bytes": sum(t.numel() * t.element_size() for t in leaves),
                    "init_s": time.perf_counter() - t0}


def served(cfg, params, requests, device, kernels) -> dict:
    """``launch/serve.py``'s ``serve`` at its defaults on ``requests``
    (``make_requests``' prompts and frames) under ``counted`` (the four QF
    kernels), its prefix cache's hits and state against a CPU cache's."""
    prompts, frames = requests
    t0 = time.perf_counter()
    (hits, tokens, pcache), launched = counted(
        kernels, ("fingerprint", "qf_positions", "qf_build_planes", "qf_probe"), "serve",
        lambda: serve_launch.serve(cfg, params, prompts, SERVE_GEN, device, frames),
    )
    serve_s = time.perf_counter() - t0
    B = SERVE_REQUESTS
    if not hits[B // 2 :].all():
        raise AssertionError("a repeated prompt missed the prefix cache")
    cpu_cache = PrefixCacheFilter(q=16, r=14, device="cpu")
    if not np.array_equal(cpu_cache.check_and_insert(prompts), hits):
        raise AssertionError("the card's prefix-cache hits differ from the CPU's")
    card_state = filters.to_numpy(pcache.cfg, pcache.state)
    cpu_state = filters.to_numpy(cpu_cache.cfg, cpu_cache.state)
    if pcache.cfg._replace(backend="reference") != cpu_cache.cfg or not (
        len(card_state) == len(cpu_state)
        and all(np.array_equal(a, b) for a, b in zip(card_state, cpu_state))
    ):
        raise AssertionError("the card's prefix cache differs from the CPU's")
    if tokens.shape != (B, SERVE_GEN) or not bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all()
    ):
        raise AssertionError(f"served tokens {tuple(tokens.shape)} out of range")
    return {"requests": B, "prompt_len": SERVE_PROMPT_LEN, "gen": SERVE_GEN,
            "hits": int(hits.sum()), "wall_s": serve_s,
            "launches": {k: launched[k] for k in
                         ("fingerprint", "qf_positions", "qf_build_planes", "qf_probe")}}


def check_inputs(cfg, requests, device, long=SERVE_LONG) -> tuple:
    """The decode checks' inputs: the served requests (16 x 64, and their
    frames cast to the activations' dtype) and a next token a row, and a
    ``long`` (B, S) batch (frames drawn after its tokens) with its next
    token.  Returns (short, nxt, long_batch, long_nxt)."""
    rng = np.random.default_rng(SEED + 61)
    act = getattr(torch, cfg.act_dtype)
    prompts, frames = requests
    short = {"tokens": torch.as_tensor(prompts, dtype=torch.int32, device=device)}
    if frames is not None:
        short["frames"] = torch.as_tensor(frames, device=device).to(act)
    nxt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (prompts.shape[0], 1)).astype(np.int32)
    ).to(device)
    LB, LS = long
    long_seq = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (LB, LS + 1)).astype(np.int32)
    ).to(device)
    long_batch = {"tokens": long_seq[:, :LS]}
    if cfg.is_encoder_decoder:
        long_batch["frames"] = torch.from_numpy(
            rng.normal(size=(LB, cfg.encoder_seq, cfg.d_model))).to(device=device, dtype=act)
    return short, nxt, long_batch, long_seq[:, LS:]


def serve_phase(device, kernels) -> dict:
    """Phase serve: the five GQA archs at smoke size on the card against the
    CPU; then ``SERVE_ARCH`` at full width from a seeded CUDA generator,
    served by ``launch/serve.py``'s ``serve`` at its defaults in
    front of the prefix cache (its state against a CPU cache's, the QF
    kernels' launches counted), decode against the full forward at 16 x 64
    and over a chunked 2 x 4,096 prefill, one decode step under the sync
    debug mode, and the prefill and decode times beside their bounds."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    out = {"smoke_card_vs_cpu": smoke_card_vs_cpu(device, SERVE_SMOKE_ARCHS)}
    cfg = get_config(SERVE_ARCH)
    params, made = full_width_params(cfg, device)
    out.update(made)
    requests = serve_launch.make_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT_LEN, SEED)
    out["serve"] = served(cfg, params, requests, device, kernels)
    short, nxt, long_batch, long_nxt = check_inputs(cfg, requests, device)
    out["decode_vs_forward_16x64"] = decode_against_forward(
        params, cfg, short, nxt, sync_check=True
    )
    log("  no host sync in a full-width decode step (sync debug mode \"error\")")
    LB, LS = SERVE_LONG
    out[f"decode_vs_forward_{LB}x{LS}"] = decode_against_forward(
        params, cfg, long_batch, long_nxt
    )
    torch.cuda.empty_cache()
    out["timing_16x64"] = timed_serving(params, cfg, short, SERVE_DECODE_STEPS)
    out[f"timing_{LB}x{LS}"] = timed_serving(params, cfg, long_batch, SERVE_DECODE_STEPS)
    return out


def at_true_fan_in(params, cfg) -> None:
    """Scale in place each leaf that ``init`` draws at 1/sqrt(fan_in) to the
    fan-in of its product.  The schema, as the JAX package's, takes
    ``fan_in`` from a leaf's first axis: a stacked leaf's is the layer axis,
    so its values come out sqrt(fan-in / n_layers) times too large.  The
    fan-in is the leaf's first axis that is neither ``layers`` nor
    ``experts``: the one its product sums over."""
    for path, p in llm_schema.tree_items(llm.schema(cfg)):
        if p.init != "fan_in" or p.scale is not None:
            continue
        fan_in = next(n for n, a in zip(p.shape, p.axes) if a not in ("layers", "experts"))
        leaf = params
        for key in path:
            leaf = leaf[key]
        leaf.mul_(math.sqrt(p.shape[0] / fan_in))


def serve_moe_phase(device, kernels) -> dict:
    """Phase serve_moe: the MoE archs at smoke size on the card against the
    CPU; then, in bf16, ``SERVE_MOE_ARCH`` at full width and depth and
    grok-1-314b at full width and ``SERVE_GROK_LAYERS`` layers.

    DeepSeek is served by ``launch/serve.py`` at its defaults in front of
    the prefix cache (its state against a CPU cache's, the QF kernels
    counted).  Each model's ``decode_against_forward`` at 16 x 64 (the step
    under the sync debug mode) and, for DeepSeek, over a chunked 2 x 4,096
    prefill, at a capacity factor of E / top_k + 1 (at least S slots an
    expert: no pair dropped, so forward and decode see the same tokens);
    serving and timing keep the config's.  DeepSeek's leaves are first
    brought to their true fan-in (``at_true_fan_in``; its readings at
    ``init``'s scale are reported): at ``init``'s scale its queries and
    latent keys are about nine and four times too large, MLA, which has
    no q-norm, scores keys almost one-hot, and bf16 decode misses forward
    even routed alike.  Grok's scores pass a softcap; it runs at
    ``init``'s scale.  Then the prefill and decode times beside their
    bounds, and each model's peak memory."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"smoke_card_vs_cpu": smoke_card_vs_cpu(device, SERVE_MOE_SMOKE_ARCHS)}
    LB, LS = SERVE_LONG
    for cfg, full_depth in (
        (get_config(SERVE_MOE_ARCH), True),
        (get_config("grok-1-314b").replace(n_layers=SERVE_GROK_LAYERS), False),
    ):
        no_drop = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k + 1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, report = full_width_params(cfg, device)
        requests = serve_launch.make_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT_LEN, SEED)
        short, nxt, long_batch, long_nxt = check_inputs(cfg, requests, device)
        if full_depth:
            if report["params"] != SERVE_MOE_PARAMS:
                raise AssertionError(
                    f"{cfg.name}: {report['params']} params, not {SERVE_MOE_PARAMS}"
                )
            report["init_scale_16x64"] = decode_readings(params, no_drop, short, nxt)
            at_true_fan_in(params, cfg)
            report["serve"] = served(cfg, params, requests, device, kernels)
        report["decode_vs_forward_16x64"] = decode_against_forward(
            params, no_drop, short, nxt, sync_check=True
        )
        log(f"  no host sync in a full-width {cfg.name} decode step (sync debug mode \"error\")")
        if full_depth:
            report[f"decode_vs_forward_{LB}x{LS}"] = decode_against_forward(
                params, no_drop, long_batch, long_nxt
            )
        torch.cuda.empty_cache()
        report["timing_16x64"] = timed_serving(params, cfg, short, SERVE_DECODE_STEPS)
        if full_depth:
            report[f"timing_{LB}x{LS}"] = timed_serving(
                params, cfg, long_batch, SERVE_DECODE_STEPS
            )
        del params
        report["peak_bytes"] = torch.cuda.max_memory_allocated()
        out[f"{cfg.name}_{cfg.n_layers}_layers"] = report
    torch.cuda.empty_cache()
    return out


def serve_recurrent_phase(device, kernels) -> dict:
    """Phase serve_recurrent: the SSM, RG-LRU and encoder-decoder archs of
    ``SERVE_RECURRENT_SMOKE_ARCHS`` at smoke size on the card against the
    CPU; then each at full width and depth in bf16 from a seeded CUDA
    generator, its param count (and whisper's encoder's) held against the
    schema's.  Each model's ``decode_readings`` at ``init``'s scale are
    reported; then its leaves are brought to their true fan-in
    (``at_true_fan_in``: ``init`` scales a stacked leaf by its layer axis,
    mamba2's ``in_proj`` 5.7x, the RG-LRU gates 18.5x, whisper's ``wq``
    6.3x too large) and it is served by ``launch/serve.py``'s ``serve``
    at its defaults in front of the prefix cache (its state against a CPU
    cache's, the four QF kernels counted), decoded against ``forward`` at
    16 x 64 (the step under the sync debug mode) and over a chunked long
    prefill (2 x 4,096; whisper 2 x 3,584, whose forward over S + 1 must
    fit its 4,096 positions), and timed beside its bounds; its peak
    memory last.  RecurrentGemma's long prefill wraps its 2,048-slot
    attention ring."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"smoke_card_vs_cpu": smoke_card_vs_cpu(device, SERVE_RECURRENT_SMOKE_ARCHS)}
    for name in SERVE_RECURRENT_SMOKE_ARCHS:
        cfg = get_config(name)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, report = full_width_params(cfg, device)
        if report["params"] != SERVE_RECURRENT_PARAMS[name]:
            raise AssertionError(
                f"{name}: {report['params']} params, not {SERVE_RECURRENT_PARAMS[name]}"
            )
        if cfg.is_encoder_decoder:
            report["encoder_params"] = sum(
                t.numel() for _, t in llm_schema.tree_items(params["encoder"]))
            if report["encoder_params"] != SERVE_WHISPER_ENCODER_PARAMS:
                raise AssertionError(f"{name}: the encoder holds {report['encoder_params']}")
        requests = serve_launch.make_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT_LEN, SEED)
        long = SERVE_WHISPER_LONG if cfg.is_encoder_decoder else SERVE_LONG
        short, nxt, long_batch, long_nxt = check_inputs(cfg, requests, device, long)
        report["init_scale_16x64"] = decode_readings(params, cfg, short, nxt)
        at_true_fan_in(params, cfg)
        report["serve"] = served(cfg, params, requests, device, kernels)
        report["decode_vs_forward_16x64"] = decode_against_forward(
            params, cfg, short, nxt, sync_check=True
        )
        log(f"  no host sync in a full-width {name} decode step (sync debug mode \"error\")")
        LB, LS = long
        report[f"decode_vs_forward_{LB}x{LS}"] = decode_against_forward(
            params, cfg, long_batch, long_nxt
        )
        torch.cuda.empty_cache()
        report["timing_16x64"] = timed_serving(params, cfg, short, SERVE_DECODE_STEPS)
        report[f"timing_{LB}x{LS}"] = timed_serving(params, cfg, long_batch, SERVE_DECODE_STEPS)
        del params, short, long_batch
        report["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"  {name}: {json.dumps(report)}")
        out[name] = report
    torch.cuda.empty_cache()
    return out

# ---------------------------------------------------------------------------
# phase train: the training path
# ---------------------------------------------------------------------------


def on_device(tree, device):
    return llm_schema.tree_unflatten(tree, [t.to(device) for t in llm_schema.tree_leaves(tree)])


def train_batch(cfg, B: int, S: int, seed: int, device, masked: bool = True) -> dict:
    """Tokens and targets (B, S) from ``default_rng(seed)`` (three targets
    masked with -1 when ``masked``), and frames for an encoder-decoder."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "targets")}
    if masked:
        batch["targets"][0, :3] = -1
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_params_close(label, got, want, mu, lr: float) -> float:
    """One AdamW step's params, run from one state on the card and on the
    CPU: every element within 2 lr (1% slack) + PTOL, since an update is
    about lr * sign(m) and an element whose moment is near 0 may take the
    other sign; where the CPU's new first moment ``mu`` is well above its
    error (|mu| > 2 TRAIN_GRAD_RTOL max |mu| and > (1 - b1) 1e-4) within
    PTOL = 1e-6 + 1e-5 |p|.  Returns the largest |d| over those elements."""
    worst = 0.0
    for (path, g), w, m in zip(llm_schema.tree_items(got), llm_schema.tree_leaves(want),
                               llm_schema.tree_leaves(mu)):
        g, w, m = g.float().cpu(), w.float(), m.float().abs()
        d, tol = (g - w).abs(), 1e-6 + 1e-5 * w.abs()
        if not bool((d <= 2.02 * lr + tol).all()):
            raise AssertionError(f"{label}: {'/'.join(path)} moved past 2 lr")
        well = m > max(2 * TRAIN_GRAD_RTOL * float(m.max()), 0.1 * 1e-4)
        if not bool((d[well] <= tol[well]).all()):
            raise AssertionError(f"{label}: {'/'.join(path)} off by {float((d - tol)[well].max())}")
        worst = max(worst, float(d[well].max()) if bool(well.any()) else 0.0)
    return worst


def train_smoke_card_vs_cpu(device, names) -> dict:
    """Each arch of ``names`` under ``make_smoke`` (float32): ``make_train_step``
    steps on the card against the same steps on the CPU port, each step
    from the CPU's state before it (params made on the CPU; an RG-LRU
    model's at their true fan-in).  The loss within ``TRAIN_RTOL``,
    grad_norm and the moments within ``TRAIN_GRAD_RTOL``, the params by
    ``train_params_close``, ``lr`` and ``step`` exact."""
    out, ocfg = {}, llm_optim.OptConfig()
    for name in names:
        cfg = make_smoke(get_config(name))
        params = llm.init(cfg, SEED, device="cpu")
        if "rec" in llm_transformer.layer_kinds(cfg):
            at_true_fan_in(params, cfg)
        state = llm_train.TrainState(params, llm_optim.init(params, ocfg))
        step = llm_train.make_train_step(cfg, ocfg)
        report = {"loss_rel_err": 0.0, "grad_norm_rel_err": 0.0, "moment_rel_err": 0.0,
                  "param_abs_err": 0.0}
        for i in range(TRAIN_SMOKE_STEPS):
            batch = train_batch(cfg, 2, 24, SEED + 70 + i, "cpu")
            want, wm = step(state, batch)
            got, gm = step(on_device(state, device), on_device(batch, device))
            errs = {"loss_rel_err": rel_err(gm["loss"].cpu(), wm["loss"]),
                    "grad_norm_rel_err": rel_err(gm["grad_norm"].cpu(), wm["grad_norm"])}
            if not (errs["loss_rel_err"] < TRAIN_RTOL and errs["grad_norm_rel_err"] < TRAIN_GRAD_RTOL):
                raise AssertionError(f"{name} step {i + 1}: {errs}")
            if not (torch.equal(gm["lr"].cpu(), wm["lr"])
                    and torch.equal(got.opt.step.cpu(), want.opt.step)):
                raise AssertionError(f"{name} step {i + 1}: lr or step differs")
            errs["moment_rel_err"] = max(
                rel_err(g.cpu(), w) for g, w in zip(
                    llm_schema.tree_leaves((got.opt.mu, got.opt.nu)),
                    llm_schema.tree_leaves((want.opt.mu, want.opt.nu))))
            if not errs["moment_rel_err"] < 2 * TRAIN_GRAD_RTOL:
                raise AssertionError(f"{name} step {i + 1}: moments off by {errs['moment_rel_err']}")
            errs["param_abs_err"] = train_params_close(
                f"{name} step {i + 1}", got.params, want.params, want.opt.mu, float(wm["lr"]))
            report = {k: max(v, errs[k]) for k, v in report.items()}
            state = want
        out[name] = report
    return out


def state_bytes(state) -> tuple:
    """(the whole state's bytes, the params' bytes)."""
    size = lambda tree: sum(t.numel() * t.element_size() for t in llm_schema.tree_leaves(tree))
    return size(state), size(state.params)


def train_readings(cfg, B: int, S: int, times: list, sizes: tuple, profile_step) -> dict:
    """ms a step (the median of ``times``, CUDA-event ms of the steps after
    the first), tokens/s, the bound, and ``profile_step``'s aten operations
    and the card's busy share (``decode_profile``, one step)."""
    ms = statistics.median(times)
    bound, bound_by = train_bound_ms(cfg, B, S, sizes)
    ops, busy = decode_profile(profile_step, 1)
    return {"ms_a_step": ms, "tokens_per_s": B * S / ms * 1e3, "bound_ms": bound,
            "bound_by": bound_by, "aten_ops_a_step": ops, "device_busy_share": busy,
            "state_bytes": sizes[0]}


@contextlib.contextmanager
def recorded_training():
    """Yield a record of what ``launch/train.py``'s ``main`` runs inside
    the block: each step call's CUDA events and loss (call
    ``TRAIN_SYNC_CALL`` under the sync debug mode "error"), the last call's
    step, state and batch, a copy of the state each save takes and the
    counters of the pipeline snapshot it writes, what each restore
    returns, and each pipeline made, with its counters after a restore."""
    rec = {"calls": [], "saved": {}, "snapshots": {}, "restored": [], "pipes": [],
           "pipe_restored": []}
    real_step, real_mgr, real_pipe = (llm_train.make_train_step, train_launch.CheckpointManager,
                                      train_launch.DedupPipeline)

    def make_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def timed(state, batch):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            sync_check = len(rec["calls"]) + 1 == TRAIN_SYNC_CALL
            if sync_check:
                torch.cuda.set_sync_debug_mode("error")
            try:
                start.record()
                new, metrics = step(state, batch)
                end.record()
            finally:
                if sync_check:
                    torch.cuda.set_sync_debug_mode("default")
            rec["calls"].append((start, end, metrics["loss"]))
            rec["last"] = (step, state, batch)
            return new, metrics

        return timed

    class Manager(real_mgr):
        def save(self, step, state, extra=None, **kwargs):
            rec["saved"] = {step: [t.detach().clone() for t in llm_schema.tree_leaves(state)]}
            snap = pickle.loads(extra["pipeline"].tobytes())
            rec["snapshots"][step] = (snap["docs_seen"], snap["docs_kept"], snap["docs_dropped"])
            return super().save(step, state, extra, **kwargs)

        def restore(self, *args, **kwargs):
            rec["restored"].append(super().restore(*args, **kwargs))
            return rec["restored"][-1]

    class Pipeline(real_pipe):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            rec["pipes"].append(self)

        def restore(self, snap):
            super().restore(snap)
            rec["pipe_restored"].append(
                (self.state.docs_seen, self.state.docs_kept, self.state.docs_dropped))

    llm_train.make_train_step = make_step
    train_launch.CheckpointManager, train_launch.DedupPipeline = Manager, Pipeline
    try:
        yield rec
    finally:
        llm_train.make_train_step = real_step
        train_launch.CheckpointManager, train_launch.DedupPipeline = real_mgr, real_pipe


def counters(pipe) -> tuple:
    return pipe.state.docs_seen, pipe.state.docs_kept, pipe.state.docs_dropped


def check_dedup_kernels(pipe, recorded, device) -> dict:
    """The dedup cascade's kernels at this phase's shapes: its last Q0
    build's inputs through ``ops.build_sorted`` against the plain build
    (``check_deep_build``), and ``contains`` of every digest the corpus
    drew plus as many fresh keys against the plain path (every drawn digest
    must hit: each was inserted or dropped as seen)."""
    originals = np.asarray(pipe.corpus._originals, np.uint32)
    fresh = np.random.default_rng(SEED + 90).integers(0, 2**32, originals.size, dtype=np.uint64)
    probes = pipe._keys(np.concatenate([originals, fresh.astype(np.uint32)]))
    hit = filters.contains(pipe.filter_cfg, pipe.filter_state, probes)
    against_plain("train dedup", pipe.filter_cfg, pipe.filter_state, probes, hit)
    if not bool(hit[: originals.size].all()):
        raise AssertionError("a digest the pipeline drew misses its dedup filter")
    return {"build": check_deep_build(f"train dedup q = {DEDUP_Q}", recorded),
            "probes": int(probes.shape[0]), "drawn_hits": int(originals.size),
            "fresh_hits": int(hit[originals.size :].sum())}


def bitwise_equal(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def train_main_run(device, kernels) -> dict:
    """``launch/train.py``'s ``main`` at examples/train_e2e.py's
    configuration (``TRAIN_ARCH`` at full width and depth, bf16, B x S =
    ``TRAIN_BATCH`` x ``TRAIN_SEQ``): ``TRAIN_STEPS`` steps with a
    checkpoint every ``TRAIN_CKPT_EVERY``, then a run to
    ``TRAIN_RESUMED_STEPS`` from ``--resume``.  Each run's launches of the
    dedup kernels are counted (``counted``); the restored leaves must equal
    the leaves saved at the last step of the first run bit for bit, the
    resumed pipeline's counters the snapshot's, every loss be finite; one
    step runs under the sync debug mode.  Then the dedup kernels against
    their plain versions, and the step's readings."""
    needed = ("fingerprint", "qf_positions", "qf_build_planes", "cascade_probe")
    out = {}
    with tempfile.TemporaryDirectory() as ckpt, recorded_training() as rec, \
            last_build_at(DEDUP_Q) as deep:
        base = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--ckpt-dir", ckpt, "--ckpt-every", str(TRAIN_CKPT_EVERY)]
        for label, argv in (("run", ["--steps", str(TRAIN_STEPS)]),
                            ("resumed", ["--steps", str(TRAIN_RESUMED_STEPS), "--resume"])):
            t0 = time.perf_counter()
            rc, launched = counted(kernels, needed, f"train {label}",
                                   lambda: train_launch.main(base + argv))
            torch.cuda.synchronize()
            if rc != 0:
                raise AssertionError(f"train {label}: main returned {rc}")
            out[label] = {"wall_s": time.perf_counter() - t0, "counters": counters(rec["pipes"][-1]),
                          "launches": {n: launched[n] for n in needed}}
            if label == "run":
                saved, out["run"]["calls"] = rec["saved"].get(TRAIN_STEPS), len(rec["calls"])
        out["dedup_kernels"] = check_dedup_kernels(rec["pipes"][-1], deep, device)
    first = rec["pipes"][0]
    if saved is None or len(rec["restored"]) != 1:
        raise AssertionError("no checkpoint at the first run's last step, or no restore")
    restored = llm_schema.tree_leaves(rec["restored"][0])
    if len(restored) != len(saved) or not all(bitwise_equal(a, b) for a, b in zip(restored, saved)):
        raise AssertionError("a restored leaf differs from the leaf saved at the first run's end")
    if not (rec["pipe_restored"] == [rec["snapshots"][TRAIN_STEPS]] == [counters(first)]):
        raise AssertionError(f"the resumed pipeline's counters {rec['pipe_restored']} are not "
                             f"the snapshot's {rec['snapshots'].get(TRAIN_STEPS)}")
    if not out["resumed"]["counters"][0] > counters(first)[0]:
        raise AssertionError("the resumed pipeline read no further document")
    losses = torch.stack([loss for _, _, loss in rec["calls"]]).float().cpu()
    if len(losses) != TRAIN_RESUMED_STEPS or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{len(losses)} steps, losses {losses.tolist()}")
    log(f"  no host sync in a full-width {TRAIN_ARCH} train step (sync debug mode \"error\")")
    times = [s.elapsed_time(e) for s, e, _ in rec["calls"][1:TRAIN_STEPS]]
    step, state, batch = rec.pop("last")
    cfg = get_config(TRAIN_ARCH)
    out.update(
        params=sum(t.numel() for t in llm_schema.tree_leaves(state.params)),
        losses=[round(float(x), 4) for x in losses],
        restored_leaves=len(restored),
        readings=train_readings(cfg, TRAIN_BATCH, TRAIN_SEQ, times, state_bytes(state),
                                lambda: step(state, batch)),
    )
    return out


def train_microbatch_run(device) -> dict:
    """``TRAIN_MB_ARCH`` at full width and ``TRAIN_MB_LAYERS`` layers, bf16,
    through ``init_state`` / ``make_train_step`` with ``TRAIN_MICROBATCHES``
    microbatches and int8 error-feedback compression: ``TRAIN_MB_STEPS``
    steps at ``TRAIN_MB_SHAPE``, the second under the sync debug mode.  The
    first step's loss against a float32 cross entropy of ``forward``'s
    full logits at the same params and batch (within
    ``TRAIN_BF16_LOSS_RTOL``), every loss finite, then the readings."""
    cfg = get_config(TRAIN_MB_ARCH).replace(n_layers=TRAIN_MB_LAYERS)
    ocfg = llm_optim.OptConfig(compress_grads=True)
    B, S = TRAIN_MB_SHAPE
    state = llm_train.init_state(cfg, ocfg, SEED, device)
    step = llm_train.make_train_step(cfg, ocfg, microbatches=TRAIN_MICROBATCHES)
    batches = [train_batch(cfg, B, S, SEED + 80 + i, device, masked=False)
               for i in range(TRAIN_MB_STEPS)]
    with torch.no_grad():
        logits, _, _ = llm.forward(state.params, cfg, batches[0], remat=False)
        want = torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, cfg.vocab_size), batches[0]["targets"].reshape(-1).long())
    del logits
    torch.cuda.empty_cache()
    times, losses = [], []
    for i, batch in enumerate(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if i == 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            state, metrics = step(state, batch)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        times.append((start, end))
        losses.append(metrics["loss"])
    log(f"  no host sync in a {TRAIN_MB_ARCH} microbatched, compressed train step "
        "(sync debug mode \"error\")")
    losses = torch.stack(losses).float().cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{TRAIN_MB_ARCH}: losses {losses.tolist()}")
    loss_err = rel_err(losses[0], want.cpu())
    if not loss_err < TRAIN_BF16_LOSS_RTOL:
        raise AssertionError(f"{TRAIN_MB_ARCH}: the first step's loss is off by {loss_err}")

    def profiled():  # each call's state replaces the last: two states live at most
        nonlocal state
        state, _ = step(state, batches[-1])

    report = {"params": sum(t.numel() for t in llm_schema.tree_leaves(state.params)),
              "losses": [round(float(x), 4) for x in losses], "float32_xent": float(want),
              "loss_rel_err": loss_err}
    report["readings"] = train_readings(cfg, B, S, [s.elapsed_time(e) for s, e in times[1:]],
                                        state_bytes(state), profiled)
    return report


def train_phase(device, kernels) -> dict:
    """Phase train: ``TRAIN_SMOKE_ARCHS`` card against CPU, then the
    driver at full width (``train_main_run``), then the microbatched,
    compressed step (``train_microbatch_run``); each full-width run's peak
    memory."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"smoke_card_vs_cpu": train_smoke_card_vs_cpu(device, TRAIN_SMOKE_ARCHS)}
    for name, run in ((TRAIN_ARCH, lambda: train_main_run(device, kernels)),
                      (f"{TRAIN_MB_ARCH}_{TRAIN_MB_LAYERS}_layers",
                       lambda: train_microbatch_run(device))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out[name] = run()
        out[name]["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"  {name}: {json.dumps(out[name])}")
    torch.cuda.empty_cache()
    return out


def tools_cells() -> list:
    """Every (arch x shape) cell on the 1 x 1 card; on the 16 x 16 mesh,
    placed, the ``TOOLS_REPAIRED`` cells and every decode cell; on the
    2 x 16 x 16 mesh ``TOOLS_MULTI_POD``.  The train cells first (the
    longest)."""
    order = {"train": 0, "prefill": 1, "decode": 2}
    cells = []
    for a in ARCHS:
        for s in SHAPES:
            placed = (a, s) in TOOLS_REPAIRED or SHAPES[s].kind == "decode"
            meshes = TOOLS_MESHES if placed else TOOLS_MESHES[:1]
            if (a, s) == TOOLS_MULTI_POD:
                meshes += ("2x16x16",)
            cells.append(dryrun.Cell(a, s, meshes))
    return sorted(cells, key=lambda c: order[SHAPES[c.shape].kind])


def dry_grid() -> tuple:
    """``dryrun`` over ``tools_cells`` in ``TOOLS_JOBS`` processes (each
    placed cell in a worker with its own ``fake`` group); one line a cell.
    A cell that errs fails the phase, as does a placed cell whose
    collectives are none: every config is cut over the mesh.  Returns
    ({(arch, shape, mesh): result}, wall seconds)."""
    t0 = time.perf_counter()
    results = {}
    for _, res in dryrun.run_grid(tools_cells(), TOOLS_JOBS):
        for r in res:
            log("  " + dryrun.summary(r))
            if r["status"] == "error":
                raise AssertionError(f"dry run of {r['arch']} {r['shape']} on {r['mesh']}: "
                                     f"{r['error']}")
            if r["status"] == "ok" and r["mesh"] in dryrun.PLACED and not (
                    r["collectives"]["total"] > 0):
                raise AssertionError(f"dry run of {r['arch']} {r['shape']} on {r['mesh']}: "
                                     "placed, and no collective")
            results[(r["arch"], r["shape"], r["mesh"])] = r
    if dist.is_initialized():
        raise AssertionError("the dry run left this process a process group")
    return results, time.perf_counter() - t0


def placed_report(dry) -> dict:
    """The placed cells' seconds, collectives by kind and roofline terms."""
    return {f"{a} {s} {m}": {"seconds": r["seconds"], "collectives": r["collectives"],
                             "calls": r["collective_calls"]["total"],
                             **{k: r["roofline"][k] for k in ("t_compute_s", "t_memory_s",
                                                              "t_collective_s", "bound")}}
            for (a, s, m), r in sorted(dry.items())
            if m in dryrun.PLACED and r["status"] == "ok"}


def grown_bytes(build) -> tuple:
    """``build()``, and the growth it caused of the bytes the caching
    allocator was asked for (``requested_bytes``) and of those it handed
    out (``memory_allocated``: each block rounded to 512 bytes, and a
    large block left whole when what a split would leave is under 1 MiB)."""
    torch.cuda.synchronize()
    asked = torch.cuda.memory_stats()["requested_bytes.all.current"]
    before = torch.cuda.memory_allocated()
    out = build()
    torch.cuda.synchronize()
    return (out, torch.cuda.memory_stats()["requested_bytes.all.current"] - asked,
            torch.cuda.memory_allocated() - before)


def held_bytes(label, grown: tuple, want: int, tensors: int) -> int:
    """The bytes asked of the allocator must be the dry run's, each of
    ``tensors`` requests rounded up by less than ``ALLOC_ROUND``; the bytes
    it handed out at least those.  Returns the allocator's slack."""
    asked, allocated = grown
    if not 0 <= asked - want < ALLOC_ROUND * tensors or allocated < asked:
        raise AssertionError(f"{label}: {asked} bytes requested ({allocated} allocated), "
                             f"the dry run says {want} ({tensors} tensors)")
    return allocated - want


def fitting_cells(dry) -> list:
    """Each decode cell whose 1 x 1 dry run (argument bytes plus the step's
    estimate) fits ``TOOLS_HEADROOM`` of the card; Mamba2-130M's
    ``decode_32k`` and ``long_500k`` and RecurrentGemma-9B's ``long_500k``
    must be among them."""
    cells = [(arch, shape) for (arch, shape, mesh), r in sorted(dry.items())
             if mesh == "1x1" and r["status"] == "ok" and SHAPES[shape].kind == "decode"
             and r["memory"]["argument_bytes"] + r["memory"]["step_bytes_estimate"]
             <= TOOLS_HEADROOM * dryrun.DEVICE_BYTES]
    missing = {("mamba2-130m", "decode_32k"), ("mamba2-130m", "long_500k"),
               ("recurrentgemma-9b", "long_500k")} - set(cells)
    if missing:
        raise AssertionError(f"{sorted(missing)} do not fit the card by the dry run")
    return cells


def full_context(cache, ctx: int) -> None:
    """Make ``cache`` hold ``ctx`` positions a row, as a prefill of ``ctx``
    tokens leaves it (its K/V stay zeros): ``pos`` at ``ctx``, and slot j
    of each self-attention ring at the latest position p < ctx with
    p % ring == j.  A decode step then reads the positions that
    ``roofline.decode_bytes`` counts at ``ctx`` cached."""
    cache["pos"].fill_(ctx)
    stack = [cache]
    while stack:
        node = stack.pop()
        for key, sub in node.items():
            if key in ("attn", "self"):
                kpos = sub["kpos"]
                ring = kpos.shape[-1]
                slots = torch.arange(ring, device=kpos.device)
                kpos.copy_((ctx - ring + (slots - ctx) % ring).expand(kpos.shape))
            elif isinstance(sub, dict) and key != "cross":
                stack.append(sub)


def real_cells(device, dry) -> dict:
    """Each of ``fitting_cells`` on the card at full width and its shape's
    batch and length: params from a seed (built once an arch), the cache
    and one token a row, each held against the dry run's bytes; one
    decode step for the peak, then ``TOOLS_STEPS`` timed."""
    out = {}
    cells = fitting_cells(dry)
    for arch in dict.fromkeys(a for a, _ in cells):
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        params, *grown = grown_bytes(lambda: llm.init(cfg, SEED, device=device))
        n_params = len(llm_schema.tree_leaves(params))
        for shape in (s for a, s in cells if a == arch):
            spec, dr = SHAPES[shape], dry[(arch, shape, "1x1")]
            want = dr["memory"]["argument_bytes_by_kind"]
            label = f"{arch} {shape}"
            slack = held_bytes(label + " params", grown, want["params"], n_params)
            gen = torch.Generator(device=device)
            gen.manual_seed(SEED)
            (cache, tokens), *grown_c = grown_bytes(lambda: (
                llm.init_cache(cfg, spec.batch, spec.seq, cfg.act_dtype, device=device),
                torch.randint(0, cfg.vocab_size, (spec.batch, 1), generator=gen,
                              device=device, dtype=torch.int32)))
            n_cache = len(llm_schema.tree_leaves(cache)) + 1
            slack += held_bytes(label + " cache and tokens", grown_c,
                                want["cache"] + want["batch"], n_cache)
            full_context(cache, spec.seq)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with torch.no_grad():
                logits, cache = llm.decode_step(params, cfg, cache, tokens)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            if logits.shape != (spec.batch, cfg.vocab_size) or not bool(
                    torch.isfinite(logits).all()):
                raise AssertionError(f"{label}: logits {tuple(logits.shape)} not finite")
            times = []
            with torch.no_grad():
                for _ in range(TOOLS_STEPS):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    logits, cache = llm.decode_step(params, cfg, cache, tokens)
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
            ms = statistics.median(times)
            bound = dr["roofline"]["step_time_lb_s"] * 1e3
            if ms < bound:
                raise AssertionError(f"{label}: {ms} ms a step, under its roofline {bound} ms")
            out[label] = {
                "argument_bytes": dr["memory"]["argument_bytes"],
                "requested_bytes": grown[0] + grown_c[0],
                "allocated_bytes": grown[1] + grown_c[1], "allocator_slack": slack,
                "tensors": n_params + n_cache,
                "ms_a_step": ms, "roofline_step_ms": bound, "over_roofline": ms / bound,
                "bound": dr["roofline"]["bound"],
                "peak_bytes": peak, "peak_estimate": dr["memory"]["step_bytes_estimate"],
                "peak_over_estimate": peak / dr["memory"]["step_bytes_estimate"]
                if dr["memory"]["step_bytes_estimate"] else None,
            }
            log(f"  real {label}: {json.dumps(out[label])}")
            del cache, tokens, logits
        del params
    torch.cuda.empty_cache()
    return out


def _size(args) -> int:
    return sum(t.numel() for t in args if torch.is_tensor(t))


@contextlib.contextmanager
def largest_kernel_calls(names):
    """Yield a dict that, after the block, holds a copy of the inputs of
    the largest call of each kernel of ``names`` that ``ops`` made inside
    it, taken before the call."""
    calls, patched = {}, []

    def recorder(name, real):
        def record(*args):
            if name not in calls or _size(args) > _size(calls[name]):
                with _disable_current_modes():  # the copy is not the audit's
                    calls[name] = clone_state(args)
            return real(*args)
        return record

    for name in names:
        real = getattr(ops, name)
        setattr(ops, name, recorder(name, real))
        patched.append((name, real))
    try:
        yield calls
    finally:
        for name, real in patched:
            setattr(ops, name, real)


def tools_audit(kernels) -> dict:
    """The op audit's families on the card (``trace_audit.collect(device=
    "cuda")``: a ``device`` op runs again under sync-debug ``"error"``)
    against the manifest's ``cuda`` section, with the launch counts at 0
    before; the five kernels it must reach, each then held against its
    plain version on the largest inputs the audit gave it."""
    plain = {"fingerprint": fingerprint.fingerprint_plain,
             "qf_positions": qf_build.positions_plain,
             "qf_build_planes": qf_build.build_planes_plain,
             "qf_probe": qf_probe.probe_plain,
             "cascade_probe": cascade_probe.cascade_probe_plain}
    for k in kernels.values():
        k.launches = 0
    with largest_kernel_calls(TOOLS_AUDIT_KERNELS) as calls:
        current = trace_audit.collect(device="cuda")
    launches = {n: kernels[n].launches for n in TOOLS_AUDIT_KERNELS}
    if set(calls) != set(TOOLS_AUDIT_KERNELS):
        raise AssertionError(f"the audit's calls of {sorted(set(TOOLS_AUDIT_KERNELS) - set(calls))}"
                             " were not recorded")
    problems = trace_audit.errors(current)
    if problems:
        raise AssertionError(f"op audit on the card failed: {problems}")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"{missing} not launched by the op audit's families")
    manifest = trace_audit.load_manifest(device="cuda")
    if manifest is None:
        raise AssertionError("trace_manifest.json has no cuda section")
    lines, ok = trace_audit.diff(current, manifest)
    for line in lines:
        log(f"  audit: {line}")
    if not ok:
        raise AssertionError(f"op audit on the card failed: {lines}")
    errs = {}
    for name, args in calls.items():
        got, want = kernels[name](*clone_state(args)), plain[name](*clone_state(args))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs[name] = max_abs_err(got, want)
        if errs[name]:
            raise AssertionError(f"{name} at the audit's shapes is off by {errs[name]}")
    entries = [(f"{fam}.{op}", e, manifest["families"][fam][op])
               for fam, ops_ in current["families"].items() for op, e in ops_.items()]
    for label, e, committed in entries:
        if e["status"] not in ("device", "host"):
            continue
        sites = e.get("sync_sites", {})
        unknown = sorted(set(sites) - set(trace_audit.KNOWN_SYNC_SITES))
        if unknown:
            raise AssertionError(f"{label}: syncs at {unknown}, no deliberate read "
                                 "(trace_audit.KNOWN_SYNC_SITES)")
        if sites != committed.get("sync_sites", {}):
            raise AssertionError(f"{label}: syncs {sites} where the cuda "
                                 f"section pins {committed.get('sync_sites', {})}")
    statuses = [e["status"] for _, e, _ in entries]
    return {"launches": launches, "max_abs_err": errs,
            "device_ops": statuses.count("device"), "host_ops": statuses.count("host"),
            "ops": len(statuses), "syncs": sum(e.get("syncs", 0) for _, e, _ in entries)}


def tools_phase(device, kernels) -> dict:
    """Phase 21: the dry-run grid, the cells run for real, the op audit on
    the card, ``spec_check`` and the lint."""
    dry, grid_s = dry_grid()
    placed = placed_report(dry)
    log(f"  dry-run grid: {len(dry)} (cell, mesh) results, {len(placed)} placed, in "
        f"{grid_s:.1f} s")
    report = {"grid_s": grid_s, "grid_results": len(dry), "placed": placed}
    report["real"] = real_cells(device, dry)
    report["audit"] = tools_audit(kernels)
    for name in ("spec", "lint"):
        rc = analysis_main([name])
        if rc != 0:
            raise AssertionError(f"python -m repro_torch.analysis {name} exited {rc}")
    return report


def examples_phase(device, kernels) -> dict:
    """Phase 22: the four examples' ``main``s on ``device``, each one's
    numbers and wall seconds.  Quickstart runs with the launch counts at 0
    before it, and its pallas section must launch ``EXAMPLE_KERNELS``; that
    section's hits are then held against the plain path's on the same
    keys.  The three filter examples' integers (``EXAMPLE_INTS``) must
    equal a run on the CPU, which the tier-1 tests hold to the JAX
    package; ``train_e2e`` runs ``TRAIN_E2E_STEPS`` steps, each loss
    finite."""
    argv = ["--device", device.type]
    report = {}
    mains = {"quickstart": ex_quickstart.main, "dedup_pipeline": ex_dedup.main,
             "serve_prefix_cache": ex_cache.main}
    for name, run in mains.items():
        t0 = time.perf_counter()
        if name == "quickstart":
            out, counts = counted(kernels, EXAMPLE_KERNELS, "quickstart",
                                  lambda: run(argv))
        else:
            out, counts = run(argv), None
        seconds = time.perf_counter() - t0
        cpu = run(["--device", "cpu"])
        differ = [k for k in EXAMPLE_INTS[name] if out[k] != cpu[k]]
        if differ:
            raise AssertionError(f"example {name}: {differ} differ from the CPU's: "
                                 f"{ {k: (out[k], cpu[k]) for k in differ} }")
        report[name] = {"numbers": out, "seconds": seconds, "launches": counts}
        log(f"  example {name} ({card_line()}): {json.dumps(report[name])}")
    q = report["quickstart"]["numbers"]
    flags = ("qf_all_present", "cf_all_present", "pallas_all_present",
             "auto_grow_all_present")
    if not all(q[f] for f in flags) or q["auto_grow_overflow"]:
        raise AssertionError(f"example quickstart: {q}")
    keys = ex_quickstart.uint32_keys(np.random.default_rng(0), 50_000, device)
    if not torch.equal(ex_quickstart.pallas_hits(keys),
                       ex_quickstart.pallas_hits(keys, "reference")):
        raise AssertionError("example quickstart: the pallas section's hits differ "
                             "from the plain path's")
    t0 = time.perf_counter()
    out = ex_train.main(argv + ["--steps", str(TRAIN_E2E_STEPS)])
    seconds = time.perf_counter() - t0
    if out["steps"] != TRAIN_E2E_STEPS or not math.isfinite(out["loss"]):
        raise AssertionError(f"example train_e2e: {out}")
    report["train_e2e"] = {"numbers": out, "seconds": seconds}
    log(f"  example train_e2e ({card_line()}): {json.dumps(report['train_e2e'])}")
    return report


def decode_ms(params, cfg, cache, tok, rules=None) -> float:
    """ms a greedy decode step (``MESH_DECODE_STEPS`` after two untimed),
    under ``rules`` when given; the cache advances in place."""
    state = {"cache": cache, "tok": tok}

    def step():
        with llm_sharding.use_rules(rules):
            logits, state["cache"] = llm.decode_step(params, cfg, state["cache"], state["tok"])
            state["tok"] = serve_step.sample_greedy(logits)[:, None]

    return cuda_ms(step, MESH_DECODE_STEPS, warmup=2)


@contextlib.contextmanager
def gather_backward():
    """The MoE dispatch's row gather with ``gather``'s own backward while the
    block runs: each token's k gradient rows added by ``scatter_add``'s
    atomics in no fixed order, as before ``moe._Take`` summed them by
    ``moe._fold``.  For reading what the fixed order repairs."""
    take = llm_moe._Take.apply
    llm_moe._Take.apply = lambda x, st, pairs: llm_moe._take(x, st)
    try:
        yield
    finally:
        llm_moe._Take.apply = take


def scatter_add_combine(ye, meta, S: int):
    """The MoE combine as one ``scatter_add_``: each pair's weighted output
    added onto its token by atomics in no fixed order (the combine before
    ``moe._combine`` summed in expert order)."""
    slot, st, sw, keep = meta
    B, E, C, d = ye.shape
    yf = ye.reshape(B, E * C, d)
    idx = torch.clamp(slot, max=E * C - 1)[..., None].expand(-1, -1, d)
    contrib = torch.where(keep[..., None], yf.gather(1, idx) * sw[..., None].to(yf.dtype), 0)
    return ye.new_zeros((B, S, d)).scatter_add_(1, st[..., None].expand(-1, -1, d), contrib)


def combine_cost(device, name=MESH_MOE_ARCH) -> dict:
    """ms of ``name``'s MoE combine in bf16 (``MESH_COMBINE_ITERS`` calls by
    CUDA events) at its decode's 16 x 64 prefill and at phase 20's
    microbatch of ``TRAIN_MB_SHAPE``, each at the config's capacity: the
    fixed-order ``moe._combine`` against ``scatter_add_combine``, on the
    same seeded routing and expert outputs.  Their results must agree
    within k bf16 roundings, k 2^-8 of the largest (each adds a token's k
    contributions, rounding after each add, in another order)."""
    cfg = get_config(name)
    E, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    rng = np.random.default_rng(SEED + 95)
    out = {}
    for label, (B, S) in (("prefill", MESH_DECODE_SHAPE),
                          ("train_microbatch", (TRAIN_MB_SHAPE[0] // TRAIN_MICROBATCHES,
                                                TRAIN_MB_SHAPE[1]))):
        C = llm_moe.expert_capacity(cfg, S)
        top_idx = torch.from_numpy(np.argsort(rng.random((B, S, E)), axis=-1)[..., :k].copy())
        top_w = torch.from_numpy(rng.random((B, S, k)).astype(np.float32))
        x = torch.zeros((B, S, 1), dtype=torch.bfloat16, device=device)
        _, meta = llm_moe._dispatch(x, top_idx.to(device), top_w.to(device), E, C)
        ye = torch.from_numpy(rng.normal(size=(B, E, C, d)).astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
        fixed, atomic = llm_moe._combine(ye, meta, S), scatter_add_combine(ye, meta, S)
        err = rel_err(fixed.float(), atomic.float())
        if not err <= k * 2.0**-8:
            raise AssertionError(f"the fixed-order combine is off the scatter_add one by {err}")
        fixed_ms = cuda_ms(lambda: llm_moe._combine(ye, meta, S), MESH_COMBINE_ITERS)
        atomic_ms = cuda_ms(lambda: scatter_add_combine(ye, meta, S), MESH_COMBINE_ITERS)
        out[label] = {"shape": [B, S, E, C, d], "fixed_ms": fixed_ms, "scatter_add_ms": atomic_ms,
                      "fixed_over_scatter_add": fixed_ms / atomic_ms, "rel_err": err}
    log(f"  {name} combine ({card_line()}): {json.dumps(out)}")
    return out


def picks_differing(got, want) -> int:
    """(layer, token) routing decisions that differ between two recordings."""
    return sum(int((llm_sharding.whole(g) != w).any(-1).sum()) for g, w in zip(got, want))


def mesh_decode(mesh, device, name=MESH_ARCH) -> dict:
    """``name`` at full width and depth in bf16 (the seeded weights of phase
    17; of phase 18 or 19 at their true fan-in for the archs of
    ``MESH_FAN_IN_ARCHS``): a 16 x 64 prefill (with its frames, drawn after
    the prompts, for an encoder-decoder) and a greedy step, twice unplaced
    and then on params placed by ``model.place`` and a cache by
    ``place_cache``, all with the default kernels.  The two unplaced runs
    against each other (``unplaced_repeat``): for a MoE arch they must be
    equal bit for bit and route alike, or the phase fails.  The placed
    logits within ``MESH_LOGIT_BOUND`` of the unplaced (whether equal
    reported), the greedy tokens and the cache's ``kpos`` and ``pos``
    equal, and for a MoE arch every (layer, token) routing decision equal
    (by ``recorded_picks``).  Then ms a decode step at B = 16, each side."""
    cfg = get_config(name)
    params, made = full_width_params(cfg, device)
    if name in MESH_FAN_IN_ARCHS:
        at_true_fan_in(params, cfg)
    rules = llm_sharding.ShardingRules.for_config(mesh, cfg, decode=True)
    B, S = MESH_DECODE_SHAPE
    rng = np.random.default_rng(SEED + 90)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(device)}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))).to(
            device=device, dtype=getattr(torch, cfg.act_dtype))
    bspec = llm_train.batch_pspecs(cfg, rules, batch)
    routed = recorded_picks if cfg.is_moe else (lambda cfg, passes: contextlib.nullcontext([]))
    with torch.no_grad():
        with routed(cfg, 2) as want_picks:
            want, want_toks, want_cache = greedy(params, cfg, batch, 1)
        with routed(cfg, 2) as again_picks:
            again = greedy(params, cfg, batch, 1)[0]
        repeat = {"rel_err": max(rel_err(g, w) for g, w in zip(again, want)),
                  "picks_differ": picks_differing(again_picks, want_picks)}
        del again, again_picks
        if cfg.is_moe and (repeat["rel_err"] != 0.0 or repeat["picks_differ"]):
            raise AssertionError(f"{name}: the unplaced decode differs from itself run to run: "
                                 f"{repeat}")
        placed = llm.place(params, cfg, rules)
        with routed(cfg, 2) as got_picks:
            got, got_toks, got_cache = greedy(
                placed, cfg, llm_sharding.place(batch, bspec, mesh), 1, rules)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        picks_differ = picks_differing(got_picks, want_picks)
        if not max(errs) <= MESH_LOGIT_BOUND:
            raise AssertionError(f"placed decode logits off by {errs} "
                                 f"({picks_differ} routing decisions differ)")
        if picks_differ:
            raise AssertionError(f"{picks_differ} placed routing decisions differ")
        if not torch.equal(got_toks, want_toks):
            raise AssertionError("placed greedy tokens differ from the unplaced")
        for (path, w), g in zip(llm_schema.tree_items(want_cache),
                                llm_schema.tree_leaves(got_cache)):
            if path[-1] in ("kpos", "pos") and not torch.equal(llm_sharding.whole(g), w):
                raise AssertionError(f"placed cache {'/'.join(path)} differs")
        plain_ms = decode_ms(params, cfg, want_cache, want_toks[:, -1:])
        placed_ms = decode_ms(placed, cfg, got_cache,
                              llm_sharding.place(got_toks[:, -1:], bspec["tokens"], mesh), rules)
    out = {"params": made["params"], "prefill_rel_err": errs[0], "decode_rel_err": errs[1],
           "logits_equal": all(torch.equal(g, w) for g, w in zip(got, want)),
           "unplaced_repeat": repeat,
           "decode_ms_unplaced": plain_ms, "decode_ms_placed": placed_ms,
           "placed_over_unplaced": placed_ms / plain_ms}
    if cfg.is_moe:
        out["routings"] = len(got_picks)
        out["picks_differ"] = picks_differ
    log(f"  {name} decode at B = {B} ({card_line()}): {json.dumps(out)}")
    return out


def mesh_train(mesh, device, directory, name=TRAIN_MB_ARCH, layers=TRAIN_MB_LAYERS,
               shape=TRAIN_MB_SHAPE, microbatches=TRAIN_MICROBATCHES, compress=True,
               repeat=False) -> dict:
    """A step of ``name`` (``layers`` layers, full depth with ``None``) on a
    ``shape`` batch, by default phase 20's microbatched, compressed step,
    unplaced by ``make_train_step`` and placed by ``jit_train_step`` on
    ``mesh``, from one seeded state: the placed loss within
    ``MESH_LOSS_RTOL``, ``step`` and ``lr`` equal, ms a step (the second
    step of each, by CUDA events).  With ``repeat`` the unplaced two steps
    run twice from the state, with the default kernels: their first losses
    and gradient norms and the params after them must be equal bit for
    bit; then twice with ``gather_backward``, how far apart reported.
    Then, given a ``directory``, the placed params saved and restored onto
    the mesh, bit for bit and placed by their specs."""
    cfg = get_config(name) if layers is None else get_config(name).replace(n_layers=layers)
    ocfg = llm_optim.OptConfig(compress_grads=compress)
    B, S = shape
    batch = train_batch(cfg, B, S, SEED + 80, device, masked=False)

    def two_steps(step, state):
        state, first = step(state, batch)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        return state, first, start.elapsed_time(end)

    # each state goes straight into two_steps: two states live at most, as in phase 20
    plain = llm_train.make_train_step(cfg, ocfg, microbatches=microbatches)
    want_state, want, plain_ms = two_steps(plain, llm_train.init_state(cfg, ocfg, SEED, device))
    out = {}
    if repeat:
        again_state, again, _ = two_steps(plain, llm_train.init_state(cfg, ocfg, SEED, device))
        differ = [p for (p, a), b in zip(llm_schema.tree_items(again_state.params),
                                         llm_schema.tree_leaves(want_state.params))
                  if not bitwise_equal(a, b)]
        out["unplaced_repeat"] = {
            "loss_equal": bool(torch.equal(again["loss"], want["loss"])),
            "grad_norm_equal": bool(torch.equal(again["grad_norm"], want["grad_norm"])),
            "params_differ": len(differ)}
        del again_state
        if not (out["unplaced_repeat"]["loss_equal"] and out["unplaced_repeat"]["grad_norm_equal"]
                and not differ):
            raise AssertionError(f"{name}: the unplaced step differs from itself run to run: "
                                 f"{out['unplaced_repeat']}, params {differ[:4]}")
        # the same twice with gather's own backward in the dispatch: reported
        with gather_backward():
            runs = [two_steps(plain, llm_train.init_state(cfg, ocfg, SEED, device))
                    for _ in range(2)]
        (a_state, a, a_ms), (b_state, b, _) = runs
        out["gather_backward_repeat"] = {
            "loss_equal": bool(torch.equal(a["loss"], b["loss"])),
            "grad_norm_rel_err": rel_err(b["grad_norm"], a["grad_norm"]),
            "params_differ": sum(not bitwise_equal(x, y) for x, y in zip(
                llm_schema.tree_leaves(a_state.params), llm_schema.tree_leaves(b_state.params))),
            "params": len(llm_schema.tree_leaves(a_state.params)),
            "train_ms": a_ms}
        del runs, a_state, b_state
    del want_state
    torch.cuda.empty_cache()
    step, rules = llm_train.jit_train_step(cfg, ocfg, mesh, microbatches=microbatches,
                                           donate=False)
    sspec = llm_train.state_pspecs(cfg, ocfg, rules)
    state, got, placed_ms = two_steps(
        step, llm_sharding.place(llm_train.init_state(cfg, ocfg, SEED, device), sspec, mesh))
    loss_err = rel_err(got["loss"], want["loss"])
    if not loss_err <= MESH_LOSS_RTOL:
        raise AssertionError(f"placed train step's loss off by {loss_err}")
    if not (torch.equal(got["lr"], want["lr"])
            and torch.equal(llm_sharding.whole(state.opt.step), torch.full_like(
                state.opt.step.to_local(), 2))):
        raise AssertionError("placed train step's lr or step differs")
    out.update({"params": llm_params(cfg), "loss_unplaced": float(want["loss"]),
                "loss_placed": float(got["loss"]), "loss_rel_err": loss_err,
                "train_ms_unplaced": plain_ms, "train_ms_placed": placed_ms,
                "placed_over_unplaced": placed_ms / plain_ms})
    label = f"  {name} at {cfg.n_layers} layers, a train step at {B} x {S} ({card_line()})"
    if directory is None:
        log(f"{label}: {json.dumps(out)}")
        return out
    t0 = time.perf_counter()
    mgr = CheckpointManager(str(directory))
    mgr.save(1, state.params)
    saved_s = time.perf_counter() - t0
    got_params = mgr.restore(1, llm.abstract(cfg), shardings=(mesh, sspec.params))
    restore_s = time.perf_counter() - t0 - saved_s
    for a, b, spec in zip(llm_schema.tree_leaves(got_params), llm_schema.tree_leaves(state.params),
                          llm_schema.tree_leaves(sspec.params, is_leaf=lambda x: type(x) is tuple)):
        if not (bitwise_equal(a.to_local(), b.to_local())
                and tuple(a.placements) == llm_sharding.placements(mesh, spec)):
            raise AssertionError("the restored params differ from the saved")
    out.update(saved_bytes=sum(t.numel() * t.element_size()
                               for t in llm_schema.tree_leaves(state.params)),
               save_s=saved_s, restore_s=restore_s)
    log(f"{label}: {json.dumps(out)}")
    return out


def mesh_phase(device) -> dict:
    """Phase 23: a world-size-1 NCCL group (a ``file://`` store in a
    temporary directory) and a 1 x 1 ("data", "model") mesh over it; a
    (1, 2) mesh refused; ``mesh_decode`` and ``mesh_train`` on it for the
    dense ``MESH_ARCH`` (its params saved and restored), for the MoE + MLA
    ``MESH_MOE_ARCH`` (``MESH_MOE_TRAIN_LAYERS`` layers for the step, run
    twice unplaced for ``unplaced_repeat``), then ``mesh_decode`` of each
    of ``MESH_STATE_ARCHS`` and phase 20's ``TRAIN_ARCH`` step at full
    depth on ``TRAIN_BATCH`` x ``TRAIN_SEQ`` (its params saved and
    restored).  The group is torn down before this returns, so no later
    phase sees it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(torch.cuda.current_device() if device.index is None else device.index)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh = llm_sharding.make_mesh((1, 1), ("data", "model"), device)
            if mesh.device_mesh is None or mesh.device_mesh.device_type != device.type:
                raise AssertionError(f"no {device.type} DeviceMesh: {mesh}")
            try:
                llm_sharding.make_mesh(MESH_REFUSED, ("data", "model"), device)
            except ValueError as e:
                refused = str(e)
            else:
                raise AssertionError(f"a {MESH_REFUSED} mesh on one card was not refused")
            out = {"refused": refused, "decode": mesh_decode(mesh, device)}
            torch.cuda.empty_cache()
            out["train"] = mesh_train(mesh, device, Path(tmp) / "ckpt")
            torch.cuda.empty_cache()
            out["moe_decode"] = mesh_decode(mesh, device, MESH_MOE_ARCH)
            torch.cuda.empty_cache()
            out["moe_train"] = mesh_train(mesh, device, None, MESH_MOE_ARCH,
                                          MESH_MOE_TRAIN_LAYERS, repeat=True)
            torch.cuda.empty_cache()
            out["moe_combine"] = combine_cost(device)
            for name in MESH_STATE_ARCHS:
                torch.cuda.empty_cache()
                out[f"{name}_decode"] = mesh_decode(mesh, device, name)
            torch.cuda.empty_cache()
            out["state_train"] = mesh_train(
                mesh, device, Path(tmp) / "ckpt_state", TRAIN_ARCH, None,
                (TRAIN_BATCH, TRAIN_SEQ), 1, False)
        finally:
            dist.destroy_process_group()
    if dist.is_initialized():
        raise AssertionError("the mesh phase left its process group up")
    torch.cuda.empty_cache()
    return out


def main(device: str = "cuda") -> int:
    if filters is None:
        print("chip_smoke.py: src/repro_torch is missing", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device(device)
    qf_kernels = {
        "qf_positions": qf_build.qf_positions,
        "qf_build_planes": qf_build.qf_build_planes,
        "qf_probe": qf_probe.qf_probe,
        "cascade_probe": cascade_probe.cascade_probe,
        "fingerprint": fingerprint.fingerprint,
        "qf_decode": qf_decode.qf_decode,
    }
    bloom_kernels = {
        "bloom_count": bloom_block.bloom_count,
        "bloom_probe": bloom_block.bloom_probe,
    }
    frozen_kernels = {
        "qf_positions": qf_build.qf_positions,
        "qf_build_planes": qf_build.qf_build_planes,
        "cascade_probe": cascade_probe.cascade_probe,
        "fuse_probe": fuse_probe.fuse_probe,
        "fingerprint": fingerprint.fingerprint,
    }
    inram_kernels = {
        n: k for n, k in {**qf_kernels, **bloom_kernels}.items() if n != "cascade_probe"
    }
    resize_kernels = {
        **qf_kernels,
        "qf_build_span": qf_build.qf_build_span,
        "fuse_probe": fuse_probe.fuse_probe,
    }
    kernels = {**qf_kernels, **bloom_kernels, **frozen_kernels, **resize_kernels}
    phase_s = {}
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    logs = cuda_lib.build()
    build_s = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  nvcc {name}: {line.strip()}")
    launch_check(device)
    phase_s["build"] = time.perf_counter() - t0
    log(
        f"phase build: {len(logs)} kernels built in {build_s:.3f} s; each "
        "launched on small cases and equal to its plain version"
    )

    # 2. kernels (build and probe; the cascade probe runs on phase 3's state)
    t0 = time.perf_counter()
    rows = {}
    rows["qf_build_planes"], built = check_build(device)
    stream = q25_stream(device)
    rows["qf_positions"] = check_positions(device, stream)
    rows["qf_build_span"] = check_span(device, stream)
    del stream
    rows["qf_decode"] = check_decode(device)
    rows["qf_probe"], probe_keys = check_probe(device, built)
    rows["fingerprint"] = check_fingerprint(built[0], probe_keys)
    del built, probe_keys
    phase_s["kernels"] = time.perf_counter() - t0

    # 3. main path at the paper's scale
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    n_total = RATIO * qf.QFConfig(q=RAM_Q, r=1).capacity
    mid_total = n_total // BATCHES * MID_BATCHES
    keys = uint32_keys(rng, n_total, device)
    inserted_sorted = torch.sort(keys.to(torch.int64) & 0xFFFFFFFF).values
    sample = keys[torch.from_numpy(rng.integers(0, n_total, PROBES)).to(device)]
    fresh = fresh_keys(rng, inserted_sorted, PROBES, device)
    del inserted_sorted
    mid_pick = torch.from_numpy(rng.integers(0, mid_total, PROBES)).to(device)
    mid_sample = keys[mid_pick]
    checkpoints = {MID_BATCHES: (mid_sample, fresh), BATCHES: (sample, fresh)}
    # bench_ssd's lookup sets for the modeled SSD numbers of phase 7
    rng_paper = np.random.default_rng(SEED + 3)
    uniform = rng_paper.integers(2**31, 2**32, PAPER_LOOKUPS).astype(np.uint32)
    pick = torch.from_numpy(rng_paper.integers(0, n_total, PAPER_LOOKUPS))
    paper_lookups = (
        torch.from_numpy(uniform.view(np.int32)).to(device),
        keys[pick.to(device)],
    )
    paper_logs = {}
    for k in kernels.values():
        k.launches = 0
    results = {}
    for name, spec in specs("pallas").items():
        cfg, ingest_s, out, final = drive(name, spec, keys, checkpoints)
        results[name] = (cfg, out)
        paper_logs[name] = qf_io(cfg, final, paper_lookups)
        if name == "buffered_qf":  # phase resize grows it
            buffered = {"pallas": (cfg, final)}
        del final
        log(
            f"phase main {name}: {n_total} keys ingested at "
            f"{n_total / ingest_s:.0f} keys/s ({ingest_s:.3f} s of wall time "
            "around the insert calls)"
        )
        for batches, (state, (hit, fp_hit), probe_ms) in out.items():
            fp_rate = float(fp_hit.float().mean())
            bound = union_bound(cfg, state)
            st = filters.stats(cfg, state)
            overflow = bool(st["overflow"])
            log(
                f"  after {batches} batches: probes {PROBES / probe_ms[0] * 1e3:.0f} "
                f"q/s (inserted), {PROBES / probe_ms[1] * 1e3:.0f} q/s (fresh), "
                f"median of {PROBE_REPS} calls by CUDA events; fp rate "
                f"{fp_rate:.3e} (union bound {bound:.3e}); overflow {overflow}"
            )
            stats = {
                k: v.tolist() if torch.is_tensor(v) else v for k, v in st.items()
            }
            log(f"  stats: {json.dumps(stats)}")
            log(f"  iolog: {vars(filters.to_iolog(state.io))}")
            if not bool(hit.all()):
                raise AssertionError(f"{name}: false negative among inserted keys")
            if fp_rate > 2 * bound:
                raise AssertionError(f"{name}: fp rate {fp_rate} > 2 x {bound}")
            if overflow:
                raise AssertionError(f"{name}: overflow")
    launches = {n: k.launches for n, k in qf_kernels.items()}
    log(f"  main-path launches: {launches}")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{n} was not launched on the main path")
    phase_s["main"] = time.perf_counter() - t0

    # the fused cascade probe at the main path's size, on the mid-stream
    # state, where Q0 and a disk level both hold fingerprints
    t0 = time.perf_counter()
    cfg, out = results["cascade"]
    rows["cascade_probe"] = check_cascade(
        device, cfg, out[MID_BATCHES][0], keys[:mid_total]
    )
    del cfg, out
    phase_s["kernels"] += time.perf_counter() - t0

    # 4. the reference backend on the same stream
    t0 = time.perf_counter()
    for name, spec in specs("reference").items():
        r_cfg, ingest_s, out, r_final = drive(name, spec, keys, checkpoints)
        if name == "buffered_qf":
            buffered["reference"] = (r_cfg, r_final)
        del r_final
        _, k_out = results.pop(name)
        for batches, (state, hits, probe_ms) in out.items():
            k_state, k_hits, _ = k_out[batches]
            diff = differing_fields(k_state, state)
            same_hits = all(torch.equal(a, b) for a, b in zip(hits, k_hits))
            if diff or not same_hits:
                raise AssertionError(
                    f"{name} after {batches} batches: backends differ in "
                    f"{diff or 'hits'}"
                )
        log(
            f"phase backends {name}: reference equals pallas after "
            f"{MID_BATCHES} and {BATCHES} batches (planes, n, overflow, io, "
            f"hits); reference ingest {n_total / ingest_s:.0f} keys/s, probes "
            f"{PROBES / probe_ms[0] * 1e3:.0f} q/s (inserted, {BATCHES} batches)"
        )
        del k_out, out, state, k_state, hits, k_hits
        torch.cuda.empty_cache()
    phase_s["backends"] = time.perf_counter() - t0

    # 5. the Bloom families at bench_ssd's geometry, through both kernels
    t0 = time.perf_counter()
    probes = torch.cat([sample, fresh])  # half inserted keys, half fresh
    for k in kernels.values():
        k.launches = 0
    blooms, deleted = drive_bloom("pallas", keys, probes)
    check_deleted(blooms["counting blocked_bloom"][0], deleted, keys)
    bloom_launches = {n: k.launches for n, k in bloom_kernels.items()}
    log(f"  bloom-path launches: {bloom_launches}")
    for n, c in bloom_launches.items():
        if c <= 0:
            raise AssertionError(f"{n} was not launched on the Bloom path")
    launches.update(bloom_launches)
    for label, (cfg, state, hit, ms, ingest_s) in blooms.items():
        cells = state.cells.numel()
        fp_rate = float(hit[PROBES:].float().mean())
        bound = bloom_fp_bound(n_total, cells)
        st = filters.stats(cfg, state)
        stats = {k: v.tolist() if torch.is_tensor(v) else v for k, v in st.items()}
        log(
            f"phase bloom {label}: {n_total} keys into {cells} cells at "
            f"{n_total / ingest_s:.0f} keys/s ({ingest_s:.3f} s of wall time "
            f"around the insert calls); {2 * PROBES} probes in {ms:.5f} ms, "
            f"{2 * PROBES / ms * 1e3:.0f} q/s (median of {PROBE_REPS} calls by "
            f"CUDA events); fp rate {fp_rate:.4e} (2 x bound {2 * bound:.4e}); "
            f"stats {json.dumps(stats)}"
        )
        if not bool(hit[:PROBES].all()):
            raise AssertionError(f"{label}: false negative among inserted keys")
        if fp_rate > 2 * bound:
            raise AssertionError(f"{label}: fp rate {fp_rate} > 2 x {bound}")
    log(
        f"  counting blocked_bloom: the first {DELETED_BATCHES} batches deleted; "
        f"every key of the other {BATCHES - DELETED_BATCHES} still hits, "
        f"n = {int(deleted.n)}"
    )
    phase_s["bloom"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows["bloom_count"] = check_bloom_count(keys)
    rows["bloom_probe"] = check_bloom_probe(blooms, probes)
    phase_s["kernels"] += time.perf_counter() - t0

    # 6. the Bloom families under the reference backend
    t0 = time.perf_counter()
    ref_blooms, ref_deleted = drive_bloom("reference", keys, probes)
    for label in blooms:
        _, k_state, k_hit, *_ = blooms[label]
        _, r_state, r_hit, *_ = ref_blooms[label]
        diff = differing_fields(k_state, r_state)
        if diff or not torch.equal(k_hit, r_hit):
            raise AssertionError(f"{label}: backends differ in {diff or 'hits'}")
    diff = differing_fields(deleted, ref_deleted)
    if diff:
        raise AssertionError(f"counting blocked_bloom deletes: backends differ: {diff}")
    log(
        "phase bloom backends: reference equals pallas (cells, n, hits) for "
        f"{', '.join(blooms)}, and after the deletes; reference ingest "
        + ", ".join(f"{lb} {n_total / r[4]:.0f} keys/s" for lb, r in ref_blooms.items())
    )
    del blooms, deleted, ref_blooms, ref_deleted, k_state, r_state
    torch.cuda.empty_cache()
    phase_s["bloom_backends"] = time.perf_counter() - t0

    # 7. the paper's Bloom baselines, and the modeled SSD numbers of all five
    t0 = time.perf_counter()
    names = {"cascade": "cf", "buffered_qf": "bqf"}
    modeled = {names[n]: modeled_ops(n_total, logs) for n, logs in paper_logs.items()}
    card_keys_per_s = {}
    for name, make in baseline_makers(n_total, device).items():
        logs, ingest_s, _ = baseline_io(make(), keys, paper_lookups, n_total // BATCHES)
        modeled[name] = modeled_ops(n_total, logs)
        card_keys_per_s[name] = n_total / ingest_s
        log(f"  {name}: ingest log {vars(logs[0])}")
        torch.cuda.empty_cache()
    bfs = ("ebf", "bbf", "fbf")
    best_bf = max(modeled[n]["insert"] for n in bfs)
    vs_best_bf = {n: modeled[n]["insert"] / best_bf for n in ("cf", "bqf")}
    vs_each_bf = {
        n: {b: modeled[n]["insert"] / modeled[b]["insert"] for b in bfs}
        for n in ("cf", "bqf")
    }
    log(
        "baselines: "
        + json.dumps(
            {
                "modeled_ops_per_s": modeled,
                "vs_best_bf": vs_best_bf,
                "vs_each_bf": vs_each_bf,
                "card_ingest_keys_per_s": card_keys_per_s,
            }
        )
    )
    phase_s["baselines"] = time.perf_counter() - t0

    # 8. the frozen tier: the same stream into a cascade with level 1 frozen,
    # then the xor_fuse family on its own
    t0 = time.perf_counter()
    for k in kernels.values():
        k.launches = 0
    cfg, ingest_s, f_out, f_final, freezes, f_after = drive_frozen(
        "pallas", keys, checkpoints
    )
    frozen48 = {"pallas": (cfg, f_after[48])}  # phase resize re-shapes it
    fc = cfg.fuse_cfg(FROZEN_BELOW)
    qf_bytes = cfg.level_cfg(FROZEN_BELOW).size_bytes
    log(
        f"phase frozen cascade(levels={FROZEN_LEVELS}, frozen_below={FROZEN_BELOW}): "
        f"{n_total} keys ingested at {n_total / ingest_s:.0f} keys/s "
        f"({ingest_s:.3f} s of wall time around the insert calls); level 1 "
        f"frozen: table {fc.size_bytes} B ({fc.fp_bits}-bit cells, "
        f"{fc.segment_count} segments of {fc.segment_length}) + run {fc.run_bytes} B, "
        f"against {qf_bytes} B for the QF level it replaces "
        f"({1 - fc.size_bytes / qf_bytes:.4f} saved on the probe tier)"
    )
    for f in freezes:
        log(f"  freeze after batch {f['batch']}: {json.dumps(f)}")
    if not freezes:
        raise AssertionError("frozen cascade: no merge-down peeled a frozen level")
    for batches, (state, (hit, fp_hit), probe_ms) in f_out.items():
        fp_rate = float(fp_hit.float().mean())
        bound = union_bound(cfg, state)
        st = filters.stats(cfg, state)
        log(
            f"  after {batches} batches: probes {PROBES / probe_ms[0] * 1e3:.0f} "
            f"q/s (inserted), {PROBES / probe_ms[1] * 1e3:.0f} q/s (fresh), median "
            f"of {PROBE_REPS} calls by CUDA events ({probe_ms[0]:.5f} and "
            f"{probe_ms[1]:.5f} ms); fp rate {fp_rate:.4e} (bound {bound:.4e}); "
            f"level counts {st['level_counts'].tolist()}; "
            f"overflow {bool(st['overflow'])}"
        )
        log(f"  iolog: {vars(filters.to_iolog(state.io))}")
        if not bool(hit.all()):
            raise AssertionError("frozen cascade: false negative among inserted keys")
        if fp_rate > 2 * bound:
            raise AssertionError(f"frozen cascade: fp rate {fp_rate} > 2 x {bound}")
        if bool(st["overflow"]):
            raise AssertionError("frozen cascade: overflow")
    drive_xor_fuse(keys, fresh)
    frozen_launches = {n: k.launches for n, k in frozen_kernels.items()}
    log(f"  frozen-path launches: {frozen_launches}")
    for n, c in frozen_launches.items():
        if c <= 0:
            raise AssertionError(f"{n} was not launched on the frozen path")
    launches["fuse_probe"] = frozen_launches["fuse_probe"]
    phase_s["frozen"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows["fuse_probe"] = check_fuse(device, cfg, f_final, keys)
    check_no_sync(cfg, f_final, sample)
    del f_final
    phase_s["kernels"] += time.perf_counter() - t0

    # 9. the frozen cascade under the reference backend
    t0 = time.perf_counter()
    r_cfg, ingest_s, r_out, _, r_freezes, r_after = drive_frozen(
        "reference", keys, checkpoints
    )
    frozen48["reference"] = (r_cfg, r_after[48])
    del f_after, r_after
    for batches, (state, hits, probe_ms) in r_out.items():
        k_state, k_hits, _ = f_out[batches]
        diff = differing_fields(k_state, state)
        same_hits = all(torch.equal(a, b) for a, b in zip(hits, k_hits))
        if diff or not same_hits:
            raise AssertionError(
                f"frozen cascade after {batches} batches: backends differ in "
                f"{diff or 'hits'}"
            )
    strip = lambda fs: [{k: v for k, v in f.items() if k != "seconds"} for f in fs]
    if strip(r_freezes) != strip(freezes):
        raise AssertionError(
            f"frozen cascade: the backends peeled differently: {r_freezes}"
        )
    log(
        f"phase frozen backends: reference equals pallas after {MID_BATCHES} and "
        f"{BATCHES} batches (fuse tables, runs, n, n_unique, fuse_seed, overflow, "
        f"QF planes, io, hits) and ran the same peels; reference ingest "
        f"{n_total / ingest_s:.0f} keys/s, probes {PROBES / probe_ms[0] * 1e3:.0f} "
        f"q/s (inserted, {BATCHES} batches)"
    )
    del f_out, r_out, state, k_state, hits, k_hits
    torch.cuda.empty_cache()
    phase_s["frozen_backends"] = time.perf_counter() - t0

    # 10. Table 1(a): the in-RAM QF against the Bloom filter
    t0 = time.perf_counter()
    for k in kernels.values():
        k.launches = 0
    inram = drive_inram(device)
    inram_launches = {n: k.launches for n, k in inram_kernels.items()}
    log(f"  inram-path launches: {inram_launches}")
    for n, c in inram_launches.items():
        if c <= 0:
            raise AssertionError(f"{n} was not launched on the inram path")
    log("inram: " + json.dumps({
        f"r={res['r']}": {"qf_over_bf": res["qf_over_bf"], "paper": {
            "insert": "1.3-2.5", "lookup": "0.6-0.7"}} for res in inram
    }))
    phase_s["inram"] = time.perf_counter() - t0

    # 11. resizing: blocking steps and restructures under both backends,
    # then bench_incremental's experiment
    t0 = time.perf_counter()
    for k in kernels.values():
        k.launches = 0
    probe_set = torch.cat([keys[:PROBES], fresh])
    steps = {
        b: blocking_steps(b, keys, fresh, buffered[b], frozen48[b])
        for b in ("pallas", "reference")
    }
    del buffered, frozen48
    for (label, kc, ks, sec, inserted), (_, rc, rs, _, _) in zip(
        steps["pallas"], steps["reference"]
    ):
        check_resized(label, kc, ks, inserted, fresh, sec)
        diff = differing_fields(ks, rs)
        if rc._replace(backend="pallas") != kc or diff:
            raise AssertionError(f"resize {label}: backends differ in {diff or 'cfg'}")
        if not torch.equal(filters.contains(kc, ks, probe_set),
                           filters.contains(rc, rs, probe_set)):
            raise AssertionError(f"resize {label}: backends differ in hits")
        del ks, rs
        torch.cuda.empty_cache()
    del steps
    log("phase resize: every blocking step and restructure held; reference "
        "equals pallas in planes, fuse tables, n, overflow, io and hits")
    p99, inc, blk, _ = p99_experiment("pallas", keys, INC_REPS, checked=True)
    r_p99, r_inc, r_blk, _ = p99_experiment("reference", keys, 1, checked=False)
    for label, a, b in (("incremental", inc, r_inc), ("blocking", blk, r_blk)):
        diff = differing_fields(a[1], b[1])
        if b[0]._replace(backend="pallas") != a[0] or diff:
            raise AssertionError(f"p99 {label}: backends differ in {diff or 'cfg'}")
        if not torch.equal(filters.contains(*a, probe_set),
                           filters.contains(*b, probe_set)):
            raise AssertionError(f"p99 {label}: backends differ in hits")
    del inc, blk, r_inc, r_blk
    torch.cuda.empty_cache()
    log(
        f"phase resize p99 (bench_incremental at q = {INC_Q}): blocking "
        f"{p99['p99_blocking_s']:.6f} s, incremental {p99['p99_incremental_s']:.6f} s, "
        f"ratio {p99['ratio']:.3f} against the repo's bar of 5 (recorded, not "
        f"gated); finish {p99['finish_s']:.5f} s; the reference backend's "
        "settled and blocking tables equal these"
    )
    resize_launches = {n: k.launches for n, k in resize_kernels.items()}
    log(f"  resize-path launches: {resize_launches}")
    for n, c in resize_launches.items():
        if c <= 0:
            raise AssertionError(f"{n} was not launched on the resize path")
    launches["qf_build_span"] = resize_launches["qf_build_span"]
    check_migrating_no_sync(keys)
    bulk_breakdown(keys)
    phase_s["resize"] = time.perf_counter() - t0

    # 12. steady: bench_steady_state at full width
    t0 = time.perf_counter()
    peaks = {"phases 1-11": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    steady_report, steady_launches = steady_experiment(device, kernels)
    log(f"  steady-path launches: {steady_launches}")
    for n in ("qf_build_span", "qf_build_planes", "qf_positions", "qf_probe",
              "fingerprint"):
        if steady_launches[n] <= 0:
            raise AssertionError(f"{n} was not launched on the steady path")
    log(f"phase steady (bench_steady_state at q = {STEADY_Q}): "
        + json.dumps(steady_report))
    peaks["steady"] = torch.cuda.max_memory_allocated()
    phase_s["steady"] = time.perf_counter() - t0

    # 13. consumers: the dedup pipeline and the prefix cache at q = 24
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    qf_path = ("qf_positions", "qf_build_planes", "qf_probe", "fingerprint")
    for label, drive_consumer, needed in (
        ("pipeline", drive_pipeline, ("qf_build_span",) + qf_path),
        # its few thousand prompts a request never reach the buffer's
        # watermark, so no drain tick appends
        ("prefix cache", drive_prefix_cache, qf_path),
    ):
        for k in kernels.values():
            k.launches = 0
        report = drive_consumer(device)
        consumer_launches = {n: k.launches for n, k in kernels.items()}
        log(f"phase consumers {label}: {json.dumps(report)}")
        log(f"  {label}-path launches: {consumer_launches}")
        for n in needed:
            if consumer_launches[n] <= 0:
                raise AssertionError(f"{n} was not launched on the {label} path")
    peaks["consumers"] = torch.cuda.max_memory_allocated()
    phase_s["consumers"] = time.perf_counter() - t0

    # 14. sharded: phase 3's stream into eight quotient-prefix shards
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    shard_report, shard_launches = drive_sharded(device, keys, checkpoints, kernels)
    log(f"phase sharded: {json.dumps(shard_report)}")
    log(f"  sharded-path launches: {shard_launches}")
    for n in ("fingerprint", "qf_positions", "qf_build_planes", "qf_probe"):
        if shard_launches[n] <= 0:
            raise AssertionError(f"{n} was not launched on the sharded path")
    log("  no host sync in a sharded insert and contains (sync debug mode \"error\")")
    peaks["sharded"] = torch.cuda.max_memory_allocated()
    phase_s["sharded"] = time.perf_counter() - t0
    del keys, checkpoints, sample, fresh, mid_pick, mid_sample, probes, probe_set
    del paper_lookups
    torch.cuda.empty_cache()

    # 15. ssd_large: Table 1(b) at 1:24, bench_ssd's "large" ratio
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    deep_q = ssd_disk_q(LARGE_RATIO, LARGE_RAM_Q)  # the BQF's disk, the CF's last level
    with last_build_at(deep_q) as deep:
        (large, _, _), _ = counted(
            kernels, tuple(qf_kernels), "ssd_large",
            lambda: ssd_experiment(LARGE_RATIO, LARGE_RAM_Q, PROBES, device),
        )
    large["deep_build_check"] = check_deep_build(f"ssd_large q = {deep_q}", deep)
    log(f"phase ssd_large (bench_ssd 1:{LARGE_RATIO} at RAM_Q = {LARGE_RAM_Q}): "
        + json.dumps(large))
    peaks["ssd_large"] = torch.cuda.max_memory_allocated()
    phase_s["ssd_large"] = time.perf_counter() - t0

    # 16. figures: Figs 1/2, 6, 4 and 9, and the shims on the card and the CPU
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    log(f"phase figures: {json.dumps(figures(device, kernels))}")
    peaks["figures"] = torch.cuda.max_memory_allocated()
    phase_s["figures"] = time.perf_counter() - t0

    # 17. serve: the LLM serving path in front of the prefix cache
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serve_report = serve_phase(device, kernels)
    peaks["serve"] = torch.cuda.max_memory_allocated()
    log(f"phase serve ({card_line()}): " + json.dumps(serve_report))
    phase_s["serve"] = time.perf_counter() - t0

    # 18. serve_moe: the MoE + MLA serving path (phase 17's weights are freed)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    moe_report = serve_moe_phase(device, kernels)
    peaks["serve_moe"] = max(r.get("peak_bytes", 0) for r in moe_report.values())
    log(f"phase serve_moe ({card_line()}): " + json.dumps(moe_report))
    phase_s["serve_moe"] = time.perf_counter() - t0

    # 19. serve_recurrent: the SSM, RG-LRU and encoder-decoder serving path
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    recurrent_report = serve_recurrent_phase(device, kernels)
    peaks["serve_recurrent"] = max(r.get("peak_bytes", 0) for r in recurrent_report.values())
    log(f"phase serve_recurrent ({card_line()}): " + json.dumps(recurrent_report))
    phase_s["serve_recurrent"] = time.perf_counter() - t0

    # 20. train: the training path, full width, behind the dedup pipeline
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_report = train_phase(device, kernels)
    peaks["train"] = max(r["peak_bytes"] for k, r in train_report.items() if "peak_bytes" in r)
    log(f"phase train ({card_line()}): " + json.dumps(train_report))
    phase_s["train"] = time.perf_counter() - t0

    # 21. tools: the dry-run grid, cells run for real, the op audit on the card
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tools_report = tools_phase(device, kernels)
    peaks["tools"] = torch.cuda.max_memory_allocated()
    log(f"phase tools ({card_line()}): " + json.dumps(tools_report))
    phase_s["tools"] = time.perf_counter() - t0

    # 22. examples: the four examples of repro_torch.examples
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    examples_report = examples_phase(device, kernels)
    peaks["examples"] = torch.cuda.max_memory_allocated()
    log(f"phase examples ({card_line()}): " + json.dumps(
        {n: {"seconds": r["seconds"]} for n, r in examples_report.items()}))
    phase_s["examples"] = time.perf_counter() - t0

    # 23. mesh: placement on a 1 x 1 mesh over an NCCL group
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh_report = mesh_phase(device)
    peaks["mesh"] = torch.cuda.max_memory_allocated()
    log(f"phase mesh ({card_line()}): " + json.dumps(mesh_report))
    phase_s["mesh"] = time.perf_counter() - t0

    # 24. report
    for n, row in rows.items():
        row["launches"] = launches[n]
        if row["max_abs_err"] != 0:
            raise AssertionError(f"{n} disagrees with its plain version")
    log("phase seconds: " + json.dumps({k: round(v, 3) for k, v in phase_s.items()}))
    log(f"peak device memory allocated (bytes): {json.dumps(peaks)}")
    log(json.dumps({"kernels": list(rows.values())}))
    log(card_line())
    device_info = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    log(json.dumps({"ok": True, "device": device_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
