"""Smoke test of the PyTorch port on one CUDA card: build, check, serve.

    python3 chip_smoke.py            # one card, no arguments
    python3 chip_smoke.py --phases build,kernels    # a part, while developing
    python3 chip_smoke.py --phases build,stream,b3
    python3 chip_smoke.py --phases build,spec
    python3 chip_smoke.py --phases build,spec2
    python3 chip_smoke.py --phases build,kernels,options
    python3 chip_smoke.py --phases build,tools
    python3 chip_smoke.py --phases build,variants
    python3 chip_smoke.py --phases build,emotion
    python3 chip_smoke.py --phases build,parallel
    python3 chip_smoke.py --phases build,tp_serve

Phases:
 1. the card's name and power limit (nvidia-smi);
 2. build: every kernel source in eamg_tpu_torch/csrc (one nvcc per
    source, all in parallel);
 3. kernels: hold each kernel against its plain PyTorch version on the
    card, in f32 and bf16, at the shapes the main paths give it (the solo
    path's, the engine's: 8 rows, ragged lengths, and the batched decode's:
    B 8, MHA, 128 prefill rows, 8324 logits), and time the kernel,
    the plain version and one PyTorch library call computing the same
    function (a yardstick only: the port never calls it), each as replays
    of a CUDA graph so that the host's issue rate stays out; K1 at the
    solo prefill warm and cold, at the batch's and at K1_SHAPES (T 64 and
    511 with valid_len < T, Dh 48); K3 at every K3_T over the flagship's
    cache, with its plan (by head at the solo shape) and over spans with
    every cluster size, at a t a row at B 8 and at K3_SHAPES (M 50, 16384,
    Dh 48, g 2 and 8), timed cold (and warm) beside SDPA; rows 8 and 11
    (flash_decode_fold_sp and _fold3_sp, one kernel: K3's over the fused
    cache) at the engine's step (8 rows, ragged t, a free slot) with their
    plan and over spans with every cluster size, at FOLD_SP_SHAPES (Dh 48,
    M 16384, t past the cache, t 0 over a zeroed row) and at the batched
    decode's MHA shape, timed cold (and warm) beside the masked SDPA; the
    bf16 error of K1, K3 and rows 8 and 11 against the f32 plain version
    no larger than the plain bf16 version's own; the FFN
    kernel at rows 1, 8, 16 and 128, cold, in the served kernels="xla"
    rounding order and in the Pallas one, and at one gelu shape; K4's two
    entry points (the threshold, and the sampler's top-k mask in the same
    launch) bit-equal to their plain versions at every K4_V (rows longer
    than a block keeps in registers among them), B 1 and 8, k 1, 50 and V,
    on rows with ties, +-inf, NaN, signed zeros, constant and all-but-k
    -inf rows, on the rows the grammar leaves (1, 2, 49, 50, 51 and 128
    finite values, the rest -1e30 or -1.3e30, V 8892 and 8579, two
    temperatures), and on 256 seeded rows, timed cold and warm beside the
    library's topk (and topk and the three ops), and the sampler's top-k
    on f32 logits traced as one launch; the stream-reduce probe one launch
    a call, two calls bit-equal, at STREAM_SHAPES, its read rate with the
    L2 left dirty and clean, past the L2 at 67 MB; the
    scalar-t cluster kernel of flash_decode and flash_decode_vmem at every
    BENCH_T with the cluster size it picks and the others, at a ragged and
    a long cache (M 60000), timed at t 300 and 510 beside SDPA on keys
    0..t; the one-launch fold kernels at t 300 and at the whole cache (t
    510) against the library call on the slice 0..t and the masked one on
    the whole cache, the cluster kernel of flash_decode_fold, _fold2 and
    _fold3 with the cluster size the card picks for the shape and with the
    other one (the resident clusters of each logged), fold2 bit-equal
    across rows 1, 2, 4, 8 and fold bit-equal to fold2, the bf16 error of
    the cluster kernels beside the plain bf16 version's own; then the
    bit-identity of a row alone and inside a batch of 8, for K1, K3, the
    fold kernels, the scalar-t kernel, the FFN kernel in both orders and
    the library's matrix product; then the phases of the cluster fold
    kernel, of the FFN kernel, of the scalar-t kernel, of K3, of rows 8
    and 11 and of K1,
    from builds of their sources that stamp the time at each phase
    boundary, beside empty launches of their grids; last, the kernels at
    the spec phase's shapes on demo_ckpt_a's and demo_ckpt_b3's widths
    (K2 at rows 4, 5 and 9, K3 at B 4, K4's top-k mask at rows 1, 4, 5
    and 9), each against its plain version and timed cold beside it;
 4. teacher: teacher-forced f32 logits of the flagship demo_ckpt_a on the
    card (kernels) against the same run on the host (plain versions), for
    the solo decode and for the ragged decode; then its bf16 logits as
    served (kernels="xla"), card against host, through the solo decode;
    then the uncached loop (generate_full) at temperature 0.7 and
    repetition penalty 1.3: its filtered logits bit-equal to those made
    with tensor divisors (fault C2);
 5. solo: capture the solo decode's CUDA graph in "global" mode (any
    host sync in a step, from any thread, fails it) at the served key,
    then serve POST /generate on demo_ckpt_a in bf16 over HTTP, one
    request at a time: two WAV requests with one seed (their bytes must be
    equal) and one MIDI request, with the launch counts taken over exactly
    this phase (the decode must have replayed graphs and issued no decode
    attention launch from Python); the WAV of seed 7 again from a server
    whose decode issues every step from the host (eager=True): the same
    bytes; then one more request under torch.profiler, in whose
    trace K3 shows one kernel launch a call and a layer and decode step,
    and no kernel of its old split design, and K4 one kernel launch a
    call (its device time a launch and the launches a token logged); each
    trace logs the device kernels and the host's launch calls
    (HOST_LAUNCH_APIS, graph launches among them) a token;
 6. coalesce: the same server started as `serve --coalesce --slots 8`
    after its warm-up (which captures the engine's and the detached
    decode's graphs): one
    lone request (decoded detached, on the engine's own shape), then a
    burst of ten concurrent requests on eight slots, one of them the lone
    request's seed again (its bytes must be equal), with the launch counts
    taken over exactly this phase; the stream-reduce probe and the other
    fold variant run once over the engine's live cache (no served path
    launches these two, so their "launches" are 0 and these launches are
    reported as "probe_launches"); then one more burst under
    torch.profiler, in whose trace the engine's fold shows one kernel
    launch a call and a layer and decode step, and no kernel of its old
    split design, and K4 one kernel launch a call, as in the solo trace;
    then the lone request and the burst once more on an eager server: the
    seed-21 bytes must be the graphs'; last, four requests at once through
    `serve --coalesce window`, with launch counts of their own (each path
    replaying graphs, none issuing decode attention from Python) and
    replies of hundreds of tokens;
 7. stream: the page's default request, POST /generate?stream=1 with WAV,
    read as its events arrive (the time to the first tokens event logged
    beside the request's total): to the solo server after its warm-up
    (which captures the stream's chunk graph), twice with one seed (the
    same events, the chunks from replayed graphs, no decode attention
    issued from Python), meta then tokens then done, the done event's MIDI
    the concatenated deltas'; a three-sentence sections=1 request
    streamed and not; one stream traced; the eager loop's stream of the
    seed equal; then to `serve --coalesce`: an engine row whose deltas
    equal submit()'s for the seed, sections streamed through the engine,
    a stream closed after its first delta (the library's and a dropped
    HTTP connection) that leaves its slot free in /stats;
 8. b3: `serve --coalesce` on demo_ckpt_b3 (d192 h4, Dh 48, MHA, V 8579;
    B3 serves solo): two WAV requests of one seed (equal bytes, and the
    eager loop's), a MIDI request and a stream, decoded from replayed
    graphs with K1, K2, K3 and K4 launched at its shapes; one request
    traced; then `cli generate` on B3 twice (equal bytes);
 9. spec: the page's decode options, solo, on demo_ckpt_a and then on
    demo_ckpt_b3 (`serve` loads each demo's medusa_heads.pkl; its warm-up
    captures the Medusa verify chunk's graph, a first lookup and a first
    beams request capture theirs): medusa=1 (a WAV of seed 7 twice, a MIDI
    of seed 11, its stream twice: equal bytes and events, the stream's
    tokens the one-shot's), lookup=1 and beams=4 (a WAV twice each), the
    counts at 0 before each option and read after it: K1, K2 and K4
    launched and the verify chunks replayed from graphs (no K3: the verify
    step's attention is plain products), or for beams K3 launched from
    replays only; each reply equal to an eager server's (every step issued
    from the host); the kernels called at the spec shapes (K2 rows 4, 5
    and 9, K4 rows 1, 4, 5 and 9, K3 at B 4); then `serve --coalesce` on A:
    a medusa request beside six plain ones decodes solo and gives the solo
    server's bytes; greedy medusa, lookup, draft (A drafting for itself)
    and tree verification on an f32 copy of A (TF32 off) against the
    plain greedy decode, token for token (a
    parting allowed only where the plain step's top-2 margin is under
    GREEDY_MARGIN); then, on each served demo, tokens a verify step and
    decode rates of medusa and lookup, sampled (SPEC_SEEDS) and greedy,
    beside the plain solo decode of the same prompt, beams' ms a step at
    K 4, and one traced decode of each (host launch calls and device
    kernels a token, the device's idle share);
 10. spec2: the rest of speculation. Draft speculation at full width:
    demo_ckpt_a drafting for itself (bf16, gamma 4, max_len 256), greedy
    against the plain greedy decode (a parting only where the plain
    step's top-2 margin is under BF16_GREEDY_MARGIN), sampled over two
    seeds (the graphs' tokens the eager loop's), tokens a verify and the
    rate beside the plain solo decode; then a pair trained here a few
    steps each on the same synthetic rows and seed (`cli train --preset
    large2 --corrected`, the target, and `--preset mini --corrected
    --scheme b2`, the draft: one vocabulary), the same checks and rates.
    Medusa rows in the engine: the solo server's replies to four
    medusa=1 requests (one streamed), then `serve --coalesce --slots 8
    --engine-medusa` (its warm-up captures the plain and the Medusa chunk
    graphs) beside a default engine of its budget: six plain requests at
    once with no live Medusa row give the default engine's bytes; in a
    burst of ten (the four Medusa and the six plain) every Medusa reply
    is the solo server's (the stream's tokens and MIDI too), the plain
    rows' equality with the default engine is logged, the aggregate
    rates of both engines are logged, and GET /profile answers 200 with a
    trace file; an engine on an f32 copy of A (greedy, TF32 off): its
    Medusa row equals the solo greedy Medusa decode and every row the
    plain greedy decode, or parts at a near tie (GREEDY_MARGIN). Then
    `medusa-measure --tree` on both demos; `train-medusa` on
    demo_ckpt_b3 cut to 512 rows x 1 epoch, its first three head steps
    on an f32 copy card against host (HEAD_LOSS_RTOL), the loss falling,
    and the written heads serving a medusa=1 request. K1-K4 and row 8
    launched over the phase;
 11. options: grammar=1 and the history options of the page. Solo on
    demo_ckpt_a and demo_ckpt_b3 (each option's graph captured by a
    request before the counted ones): a grammar WAV of seed 7 twice, a
    MIDI of seed 11, its stream, beams=4 with grammar, and repetition and
    presence penalties with no_repeat_ngram=3 and grammar together; each
    reply valid, its ids breaking no rule of the scheme's FSM and ending
    with its END token within budget, the same seed the same bytes, K1,
    K2, K3 and K4 launched and the decode replayed from graphs, and every
    reply equal to an eager server's. Then `serve --coalesce --slots 8
    --engine-top-p row --engine-ngram 3 --engine-grammar` on A: a burst of
    ten (three plain, three grammar, two with penalties, two with the
    n-gram ban, one of them streamed), every option row admitted to the
    engine, each reply equal to the same request sent alone, the plain
    ones (and ten plain requests at once) equal to a default engine's,
    the plain burst's aggregate rate on both; four requests with
    penalties and grammar at once through `serve --coalesce window
    --engine-grammar`, grouped, each equal to the same request alone; the
    solo decode of A plain, with grammar and with penalties and the n-gram
    ban: rates over three seeds, one trace each (device kernels and host
    launch calls a token, idle share, launches of K1, K2, K3, K4, row 8);
 12. batch: the batched offline decode of `python -m eamg_tpu_torch.bench`
    on the large2 model (d512 h8 MHA L6 V8324, bf16, random weights from a
    seed) at full width and depth, batch 8, 511 positions, once per
    attn_impl with the launch counts zeroed before each, the eager loop's
    tokens beside it (equal): the kernel the attn_impl names must have
    launched once per layer and step (the graphs run whole blocks of
    decode/graphs.py::BLOCK steps) and no other attention kernel at all, the
    next generation by replays only; fold's and fold2's rates at least 0.8
    of sp's (best of three generations each); teacher-forced f32 logits of
    each attn_impl on the card against the plain versions on the host; one
    generation of the default attn_impl under torch.profiler; then
    `cli generate --wav` on demo_ckpt_a twice with one seed (MThd,
    RIFF....WAVE, equal bytes).
 13. train: `cli train --preset large2 --corrected --synthetic 256
    --epochs 1 --save-every 8 --log-every 4 --seed 0` (d512 h8 L6, Scheme
    B2, V 8324, T 511, micro-batch 16, the chunked CE of 73, f32, 16 steps):
    finite losses, the last logged below the first, `latest`, `ep1` and
    `final` written; the same run rebuilt from its parts on the card, each
    step between CUDA events, its params after 16 steps against `cli
    train`'s (same seed: bit-equal or not, logged); its first 3 steps again
    on the host from the card's initial weights and the same batches (the
    host's own init_params of the key logged beside the card's, in ulps):
    each loss within 1e-5 relative, step 1's gradient within 1e-5 x max|g|,
    and after 3 steps all but 0.1% of the parameters within 1e-5 and every
    one within 2 x the summed learning rate (Adam's step is ~g / |g| where
    |g| nears its epsilon of 1e-8, so a gradient of rounding residue, such
    as the K rows of in_b, zero in exact arithmetic, moves by up to the
    rate; the count past 1e-5 is logged); resumed at step
    8 from a checkpoint written by save_checkpoint (optimizer state and
    step): each later loss within 1e-6 relative of the uninterrupted run's
    (bit-equal or not, logged), and `cli train --resume .../latest`;
    `--pack`, `--attn-block 128` and `--preset paper`, about 4 steps each,
    finite, the paper recipe's clip firing at least once (its global norms
    logged), the first loss with attn_block 128 within 1e-5 relative of the
    dense one; then `train-demo-a --geometry flagship --kv-heads 2 --rows
    768 --heldout-rows 64 --epochs 2` (the flagship's own recipe at full
    width, bf16, 96 steps): held-out perplexity each epoch through the
    port's forward (K1, K2), obedience through Generator (K1-K4 from
    graphs), train_metrics.json, and `serve --checkpoint` of its output
    answering two same-seed WAV requests with equal bytes; K1-K4 launched
    over the phase (counted on the kernels line under "train"). Timings,
    recorded only, for the large2 run and for the flagship recipe rebuilt
    from its parts: ms a step (the median of steps 4-16, event-timed),
    target tokens a second (non-PAD), torch.cuda.max_memory_allocated, and
    the device's idle share over 4 steps under torch.profiler. TF32 stays
    off (the script sets it so; the trainer leaves PyTorch's default).

 14. tools: the SoundFont rung of the served render: `serve` on
    demo_ckpt_a with EAMG_SOUNDFONT set to tests/sf2_fixture.py's font
    and EAMG_NO_FLUIDSYNTH=1: two same-seed WAV requests give equal bytes,
    the same request under EAMG_NO_SF2=1 (the additive synth) other
    bytes, and the served bytes are Sf2Renderer's on the card for the
    request's song (render_wav of both logged); the renderer on the card
    against the host on the fixture song (within SF2_ATOL) and on the
    served song (logged), its band-energy correlation with the committed
    C++-twin golden above 0.7; `serve --random-demo` (solo: two same-seed
    WAVs equal, a MIDI) and `serve --random-demo --coalesce` (a lone
    request, then four at once with its seed again: equal bytes), the
    path's kernels launched; then `ablate` at the CLI's defaults (the
    "- KV cache" row's PPL the "full" row's), `section-eval --prompts 10`
    on the flagship, `feed-bench --rows FEED_ROWS` and `emotion`, their
    output logged with the card's name and power limit; K1-K4 and row 8
    launched over the phase.
 15. variants: the model variants and converters. (a) JAX's
    benchmarks.py scenario 8 through the port's library: the large2
    geometry (d512 h8 L6, V 8324, causal, bf16, random weights from key
    0) as bf16, int8 weights, GQA-2 and int8 + GQA-2, each a batch-8
    decode to 511 (temperature 1, top-k 50, no EOS) timed over three
    seeds after a capturing run; q and s made on the card equal to the
    host's; same-seed tokens from graphs equal to the eager loop's; K1, K3
    and K4 launched, K2 on the float FFNs only (an int8 FFN is JAX's
    `_linear` route). (b) `cli train --preset large2 --corrected --scheme
    a --experts 8 --moe-every 2 --synthetic 256 --epochs 1` (16 f32
    steps, checkpoints every 8; Scheme A, since B2 has no control tokens
    to serve and B3 serves solo only): finite logged losses, MoE in
    layers 1, 3 and 5; the run rebuilt from its parts, each step between
    CUDA events, its logged losses the CLI's; the first step's loss card
    against host (1e-5 relative) and its gradient (1e-5 x max|g|) with the
    host taking the card's relu kinks (a pre-activation within rounding
    of 0 falls on either side: the kinks that differ, at most 1e-6 of all,
    and the gradient without them, logged); its checkpoint served solo (a
    WAV twice with one seed, equal bytes, a MIDI, three more seeds) and by
    `serve --coalesce --slots 8` (the four seeds alone, then at once: each
    row its lone request's bytes; beside the solo server's, logged: the
    16-step model's logits are near uniform, and the top-k boundary's
    margin, logged, is within the rounding by which two programs
    differ); the batch-1 decode rate to 511 of the MoE model beside a
    dense one of its config.
    (c) `convert-gqa` of demo_ckpt_b3 to 2 and 1 KV heads, each served
    solo, and K1 and K3 against their plain versions at H 4, Hkv 2 and 1,
    Dh 48 in f32 and bf16. (d) `export-pt` then `convert-pt` of
    demo_ckpt_b3: every parameter B3's cast to f32; `export-pt` refusing
    demo_ckpt_a (GQA); `cli generate` on the converted checkpoint. (e)
    `gqa-recover` at the CLI's defaults on demo_ckpt_b3 (2000 rows, 200
    steps), its JSON logged. K1-K4 and row 8 launched over the phase.
 16. emotion: the emotion classifier's training, on XLA in the JAX package
    and plain PyTorch here (no kernel of its own). (a) `distill-emotion`,
    the shipped recipe (d256 L4 h4, hidden 768, max_length 64, 1200 rows a
    label, pool max, cue suppression 0.3, seed 2026) cut from 12 epochs to
    2: steps, ms a step (the median from step 20, CUDA events), rows/s,
    the host's encode seconds an epoch, peak memory (beside what earlier
    phases left allocated) and metrics.json (every
    accuracy in [0, 1]; the neural eval accuracy beside the lexicon's,
    logged); step 1 at this width on the
    card against the host (TF32 off): the loss within 1e-5 relative and
    the gradient within 1e-5 x max|g|, the host taking the card's relu
    kinks and max-pool positions. (b) `distill-emotion --pool cls
    --pretrain-epochs 1 --epochs 2 --n-per-label 200` (cut; one epoch is
    refused, as JAX refuses it): the masked NLL below log V and ms a step
    of MLM and of the classifier. (c) `finetune-emotion` on the shipped
    f16 classifier at JAX's defaults, one epoch over FINETUNE_ROWS eval
    rows written to a TSV: ms a step, the step-1 loss card against host
    (1e-5 relative), the final loss (JAX's f16 Adam sends the f16 heads to inf and NaN in
    the first step, and the port follows it), params.pkl f32 exactly in
    the merged q and v; the same through the library on an f32 copy of
    the base, its losses finite. (d) `export-emotion-hf` then
    `convert-distilbert` of the shipped classifier: every leaf back; `--push`
    without huggingface_hub fails with JAX's RuntimeError (the module is
    kept from importing: no upload is tried). (e) (a)'s checkpoint served:
    its classifier card against host within 1e-5 on EMOTION_TEXTS, then one
    request through pipeline_from_checkpoint on demo_ckpt_a (seed 7): a WAV,
    the label and classify ms; K1-K4 launched over the request.

 17. parallel: the parallel modes on torch.distributed at world size 1 (the
    card host has one card; larger worlds are held to JAX on the CPU by
    tests/test_torch_mesh.py and its siblings), inside a world-1 NCCL group
    made and left within the phase. (a) the mesh trainer (a 1 x 1 mesh, tp
    and fsdp on) beside the plain trainer, PARALLEL_STEPS steps each, in
    turns (plain, mesh, mesh, plain), on the flagship recipe (bf16, GQA-2)
    and on large2 f32 (TF32 off): losses, every param and both moments
    bit-equal, ms a step of each between CUDA events in this call; (b)
    PipelineTrainer with 1 stage and 2 micro-batches on large2: its loss
    within PP_LOSS_TOL of the plain trainer's; (c) forward_seq_parallel at n
    1, T 511, f32, against forward (its kernels): SEQ_PAR_TOL; (d)
    moe_mlp_ep at n 1 against moe_mlp_dense at flagship width (d512, FF
    2048, 8 experts), drop-free: EP_TOL; (e) generate_kv on demo_ckpt_a's
    params sharded for a model group of 1 (tp=) against the unsharded
    decode, sampled, same seed: the same tokens; its launches are the
    phase's (K1-K4); then K1, K2 and K3 at the tp-2 shard shapes of
    demo_ckpt_a (H 4, Hkv 1, FF 1024, bf16 and f32) against their plain
    versions; (f) `cli train --mesh-data 2` on one card exits 2 with JAX's
    "mesh 2x1 > 1 devices", and `--mesh-data 1 --fsdp` trains; (g) `python
    -m eamg_tpu_torch.parallel.dryrun --world 1` (its main, in this process:
    a world of 1 runs where it is called) prints its line and leaves its
    group.
 18. tp_serve: serving on tensor-parallel params and Orbax checkpoints,
    inside a world-1 NCCL group made and left within the phase (larger
    groups are held to JAX on the CPU by tests/test_torch_sharded_engine.py).
    (a) the continuous engine (8 slots, chunk 128) on demo_ckpt_a's params
    sharded for a model group of 1 (Generator(tp=)), its graphs captured by
    a warm-up request and replayed, against the default engine on the
    unsharded params: a burst of TP_BURST staggered requests with fixed
    seeds gives the same token streams on both; the launches of K1, K2,
    row 8 and K4 over the TP burst (counted on the kernels line under
    "tp_serve"), row 8 from replays only; (b) generate_kv_ragged(tp=) on
    the same blocks against the unsharded ragged decode, 8 rows: the same
    tokens; (c) rows 8 and 11 at the engine step's shape (q [8, 1, .], M
    511, t FOLD_T) at the rank shapes of demo_ckpt_a on groups of 2 and 4
    (TP_RANK_SHAPES: H 4 Hkv 1, H 2 Hkv 1), bf16 and f32, against their
    plain versions; (d) demo_ckpt_a written as an Orbax directory by the
    port (utils/orbax_io.py) into a temporary directory and read back
    bit-equal (the seconds to write and to restore logged), then
    pipeline_from_checkpoint on it answering one request (seed 7) with the
    WAV bytes demo_ckpt_a's pickle directory gives.

Prints a JSON "kernels" line, the card line, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero without that
line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import socket
import subprocess
import sys
import threading
import time
import traceback
import urllib.request

PEAK_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core rate
              "float32": 67e12}      # CUDA cores
REPLACES = {
    "flash_attention": "eamg_tpu/ops/attention.py:114",
    "fused_ffn": "eamg_tpu/ops/ffn.py:61",
    "flash_decode_sp": "eamg_tpu/ops/decode_attention.py:259",
    "kth_value": "eamg_tpu/ops/topk.py:149",
    "flash_decode": "eamg_tpu/ops/decode_attention.py:88",
    "flash_decode_vmem": "eamg_tpu/ops/decode_attention.py:153",
    "flash_decode_fold": "eamg_tpu/ops/decode_fold.py:116",
    "flash_decode_fold_sp": "eamg_tpu/ops/decode_fold.py:239",
    "flash_decode_fold2": "eamg_tpu/ops/decode_fold.py:335",
    "flash_decode_fold3": "eamg_tpu/ops/decode_fold.py:420",
    "flash_decode_fold3_sp": "eamg_tpu/ops/decode_fold.py:540",
    "stream_reduce": "eamg_tpu/ops/decode_fold.py:565",
}
SOURCES = {
    "flash_attention": "eamg_tpu_torch/csrc/attention.cu",
    "fused_ffn": "eamg_tpu_torch/csrc/ffn.cu",
    "flash_decode_sp": "eamg_tpu_torch/csrc/decode_attention.cu",
    "kth_value": "eamg_tpu_torch/csrc/topk.cu",
    "flash_decode": "eamg_tpu_torch/csrc/decode_attention.cu",
    "flash_decode_vmem": "eamg_tpu_torch/csrc/decode_attention.cu",
    "flash_decode_fold": "eamg_tpu_torch/csrc/decode_fold.cu",
    "flash_decode_fold_sp": "eamg_tpu_torch/csrc/decode_fold.cu",
    "flash_decode_fold2": "eamg_tpu_torch/csrc/decode_fold.cu",
    "flash_decode_fold3": "eamg_tpu_torch/csrc/decode_fold.cu",
    "flash_decode_fold3_sp": "eamg_tpu_torch/csrc/decode_fold.cu",
    "stream_reduce": "eamg_tpu_torch/csrc/stream_reduce.cu",
}
# flash_decode and flash_decode_vmem: one cluster kernel with a rounding
# flag (csrc/decode_attention.cu)
SCALAR_T_KERNELS = ("flash_decode", "flash_decode_vmem")
# The dtype each kernel sees on the main paths (bf16 model, f32 head and
# sampling): the kernels line reports each kernel's record at this dtype.
MAIN_DTYPE = {name: "float32" if name == "kth_value" else "bfloat16"
              for name in REPLACES}
# The attention kernels that only the batched offline decode launches, and
# the shape their records on the kernels line are taken at.
BATCH_KERNELS = ("flash_decode", "flash_decode_vmem", "flash_decode_fold",
                 "flash_decode_fold2", "flash_decode_fold3")
# The path whose launch count is a kernel's "launches". K3 is counted on
# the solo path (the batch path runs it too); the five kernels above and
# flash_decode_fold3_sp (the engine calls flash_decode_fold_sp, which
# launches the same kernel) run on the batch path only, each in the
# generation that names it; the stream-reduce probe runs on no path, so
# its count is 0.
MAIN_PHASE = {"flash_attention": "coalesce", "fused_ffn": "coalesce",
              "kth_value": "coalesce", "flash_decode_sp": "solo",
              "flash_decode_fold_sp": "coalesce",
              "flash_decode_fold3_sp": "batch",
              "stream_reduce": "coalesce",
              **{name: "batch" for name in BATCH_KERNELS}}
# K4's two entry points: the threshold and the sampler's fused top-k mask
# (one kernel); a kernel's launches are those of all its wrappers
KERNEL_WRAPPERS = {"kth_value": ("kth_value", "top_k_mask")}
# what each served path must have launched (its f32 sampling takes K4 as
# the fused mask); "fold_decode" stands for the fold kernel that the ragged
# decode and the engine call
PATH_KERNELS = {"solo": ("flash_attention", "fused_ffn", "flash_decode_sp",
                         "top_k_mask"),
                "coalesce": ("flash_attention", "fused_ffn", "top_k_mask",
                             "fold_decode"),
                "window": ("flash_attention", "fused_ffn", "top_k_mask",
                           "fold_decode")}
ENGINE_SLOTS = 8
# K4 on the card: the flagship's vocabulary, B3's (no multiple of 4: no
# 16-byte loads), the Scheme-B2 one, and rows longer than a block keeps in
# registers (16384 keys), with and without 16-byte loads
K4_V = (8892, 8579, 8324, 60000, 65537)
K4_RANDOM_ROWS = 256
# the stream-reduce probe beyond the engine's cache: (kv shape, rows): W no
# multiple of the 16-byte vector in bf16 (36) or in either dtype (37), a
# trailing batch row left unread, and 67 MB in bf16, past the 50 MB L2 (the
# read rate the fold kernels are held to)
STREAM_SHAPES = (((5, 37, 36), 2), ((3, 7, 37), 1), ((5, 16, 36), 2),
                 ((64, 511, 1024), 4))
# newest valid position per engine row in the kernel checks: a free slot,
# a fresh prompt, both sides of a split boundary, mid-song, the last slot
FOLD_T = (0, 15, 63, 64, 300, 510, 200, 127)
# the batched offline decode: batch, heads (MHA), and the scalar positions
# at which the two scalar-t kernels are checked (both sides of a 256-key
# block boundary among them); kernels are timed at BENCH_TIMED_T
BENCH_B, BENCH_H = 8, 8
BENCH_T = (0, 100, 255, 256, 300, 510)
BENCH_TIMED_T = 300
# the one-launch fold kernels are timed at the whole cache as well
BENCH_LAST_T = 510
# K1 beyond its served shapes: (B, H, Hkv, T, Dh, valid_len per row,
# causal): the longer prompt buckets with valid_len < T (T 64; T 511, the
# bucket capped at max_len, two 128-key tiles and a ragged third), the
# batch with per-row lengths, Dh 48 (demo_ckpt_b3's head) causal and not
K1_SHAPES = ((1, 8, 2, 64, 64, (50,), True),
             (2, 8, 2, 511, 64, (300, 511), True),
             (1, 8, 8, 511, 64, (200,), False),
             (2, 4, 4, 64, 48, (64, 41), True),
             (1, 8, 2, 16, 48, (11,), False))
# K3: the newest positions of a decode step over the flagship's 511-slot
# cache (both sides of a 128-key block and the last slot), and per row at B
# 8 (a free slot, a fresh prompt, both sides of a key block, mid-song, the
# last slot)
K3_T = (0, 15, 127, 128, 300, 510)
K3_ROWS_T = (0, 15, 127, 128, 300, 510, 200, 64)
# K3 beyond: (B, H, Hkv, M, Dh, t per row): a ragged cache, a long one,
# Dh 48, and g 2 and 8
K3_SHAPES = ((2, 8, 2, 50, 64, (0, 49)),
             (1, 8, 2, 16384, 64, (16383,)),
             (2, 4, 4, 511, 48, (300, 17)),
             (2, 8, 4, 200, 32, (199, 127)),
             (1, 8, 1, 511, 128, (510,)))
# rows 8 and 11 beyond the engine's step: (B, H, Hkv, M, Dh, t per row, a
# row zeroed or None): Dh 48 MHA at M 256 (demo_ckpt_b3's cache) and GQA-2,
# a GQA cache too long to go by head (M 16384: over spans, clusters of 16),
# t past the cache beside t 0 over a zeroed row
FOLD_SP_SHAPES = ((2, 4, 4, 256, 48, (255, 17), None),
                  (2, 4, 2, 256, 48, (100, 255), None),
                  (2, 8, 2, 16384, 64, (16383, 700), None),
                  (2, 8, 2, 511, 64, (700, 0), 1))
# the cluster kernel of rows 7, 9 and 10: a row's bits must not depend on
# `rows` or on the batch, and they are held to what the kernels they
# replaced read (one bf16 step at |o| < 2 and 5e-3 of max|want| of the f32
# plain version in bf16, 2e-6 in f32)
CLUSTER_KERNELS = ("flash_decode_fold", "flash_decode_fold2",
                   "flash_decode_fold3")
CLUSTER_TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -7}
CLUSTER_REL_TOL = 5e-3
# the cluster kernel at demo_ckpt_b3's heads: (B, H, M, t per row), Dh 48,
# MHA, M 256 (its cache), the last slot, an early one, t 0 and mid-song (B
# a multiple of flash_decode_fold2's rows)
FOLD48_SHAPE = (4, 4, 256, (255, 17, 0, 130))
# max |kernel - plain| allowed. f32: both sides accumulate in f32, in other
# orders. bf16: the plain attention rounds scores and probabilities to
# bf16 (the JAX model's XLA path), the kernels keep them in f32, so they
# differ by about one bf16 step of the largest output (2^-8 at |o| ~ 1;
# earlier card runs read 1.6e-2 for K1, 3.9e-3 for K3). top-k: exact.
TOL = {("flash_attention", "float32"): 1e-4,
       ("flash_attention", "bfloat16"): 3e-2,
       ("fused_ffn", "float32"): 1e-4,
       ("fused_ffn", "bfloat16"): 3e-2,
       ("fused_ffn_rows16", "float32"): 1e-4,
       ("fused_ffn_rows16", "bfloat16"): 3e-2,
       ("flash_decode_sp", "float32"): 1e-4,
       ("flash_decode_sp", "bfloat16"): 1e-2,
       ("fused_ffn_rows8", "float32"): 1e-4,
       ("fused_ffn_rows8", "bfloat16"): 3e-2,
       # K2 at a shape no path gives it: exact gelu, f32 biases, D 1536 in
       # three panels, FF 192: 12 blocks, each with 128 rows of W2 too many
       # to stage
       ("fused_ffn_gelu", "float32"): 1e-4,
       ("fused_ffn_gelu", "bfloat16"): 3e-2,
       # and a wide FF 32832 on D 64: more slices than the card keeps
       # blocks (a block takes several), h rows too long to stage, most
       # blocks with no row of W2
       ("fused_ffn_wide", "float32"): 1e-4,
       ("fused_ffn_wide", "bfloat16"): 3e-2,
       ("kth_value", "float32"): 0.0,
       ("kth_value", "bfloat16"): 0.0,
       ("kth_value_b8", "float32"): 0.0,
       ("kth_value_b8", "bfloat16"): 0.0,
       # rows 8 and 11, K3's kernel over the fused cache, as K3: f32 scores
       # and p rounded against 128-key blocks, against the plain version's
       # scores and normalised p rounded to bf16 in the bf16 run
       ("flash_decode_fold_sp", "float32"): 1e-4,
       ("flash_decode_fold_sp", "bfloat16"): 1e-2,
       ("flash_decode_fold3_sp", "float32"): 1e-4,
       ("flash_decode_fold3_sp", "bfloat16"): 1e-2,
       # and at FOLD_SP_SHAPES and over spans with every cluster size: as at
       # the engine's step
       ("flash_decode_fold_sp_shapes", "float32"): 1e-4,
       ("flash_decode_fold_sp_shapes", "bfloat16"): 1e-2,
       # the one-launch kernels of the batched decode, at 8 x 8 heads and
       # six positions: f32 as the others. bf16: the two scalar-t kernels
       # against the head-major plain version (scores rounded to bf16
       # there, f32 here) and the three fold kernels against the plain
       # version that rounds the probabilities where they do (but its
       # scores to bf16 too): one bf16 step of an output of size 2..4,
       # 2^-6 = 1.6e-2; outputs of that size occur at the small t among the
       # 3072 checked values a position
       **{(name + tag, "float32"): 1e-4 for name in BATCH_KERNELS
          for tag in ("", "_gqa")},
       **{(name + tag, "bfloat16"): 1.6e-2 for name in BATCH_KERNELS
          for tag in ("", "_gqa")},
       **{(name + tag, dt): tol for name in CLUSTER_KERNELS
          for tag in ("", "_gqa", "_dh48")
          for dt, tol in CLUSTER_TOL.items()},
       # the kernels the batched decode shares with the served paths, at
       # the shapes that path gives them (B 8, MHA; 128 prefill rows; the
       # Scheme-B2 vocabulary): each as at its served shape
       ("flash_attention_batch", "float32"): 1e-4,
       ("flash_attention_batch", "bfloat16"): 3e-2,
       # K1 and K3 at the further shapes of K1_SHAPES and K3_SHAPES: as at
       # their served shapes
       ("flash_attention_shapes", "float32"): 1e-4,
       ("flash_attention_shapes", "bfloat16"): 3e-2,
       ("flash_decode_sp_shapes", "float32"): 1e-4,
       ("flash_decode_sp_shapes", "bfloat16"): 1e-2,
       ("fused_ffn_rows128", "float32"): 1e-4,
       ("fused_ffn_rows128", "bfloat16"): 3e-2,
       ("kth_value_batch", "float32"): 0.0,
       ("kth_value_batch", "bfloat16"): 0.0,
       # K4's fused top-k mask against the sampler's three ops: exact
       ("top_k_mask", "float32"): 0.0,
       ("top_k_mask", "bfloat16"): 0.0,
       ("flash_decode_sp_batch", "float32"): 1e-4,
       ("flash_decode_sp_batch", "bfloat16"): 1e-2,
       ("flash_decode_fold_sp_batch", "float32"): 1e-4,
       ("flash_decode_fold_sp_batch", "bfloat16"): 1e-2,
       ("flash_decode_fold3_sp_batch", "float32"): 1e-4,
       ("flash_decode_fold3_sp_batch", "bfloat16"): 1e-2,
       # the spec paths' shapes (spec_kernel_checks): K2 at the verify and
       # beams rows, K3 at the beams' batch, K4's mask at their rows, each
       # held as at its served shape
       ("fused_ffn_spec", "float32"): 1e-4,
       ("fused_ffn_spec", "bfloat16"): 3e-2,
       ("flash_decode_sp_spec", "float32"): 1e-4,
       ("flash_decode_sp_spec", "bfloat16"): 1e-2,
       ("kth_value_spec", "float32"): 0.0,
       # sums of 4 * 511 values of size ~1 in another order; the bf16
       # output (|sum| up to ~150) is rounded to 2^-8 relative
       ("stream_reduce", "float32"): 1e-3,
       ("stream_reduce", "bfloat16"): 1.0}
# bf16 attention kernels against the plain version run in f32 on the same
# (upcast) inputs: max |err| / max |want|, per decode position for K3. The
# kernels compute in f32 and round only the output (2^-9 relative), so a
# dropped or mis-rescaled key block shows even where outputs are small.
REL_TOL_F32 = 1e-2
TF_TOL = 5e-3   # teacher-forced f32 logits of demo_ckpt_a, card vs host
# the same in bf16 as served (kernels="xla"): one bf16 rounding that falls
# the other way in a sum of another order moves these logits by up to ~1,
# and JAX's own two executions of the model (compiled and op by op) differ
# by up to 1.38 and agree on 43 to 45 of 48 argmaxes on the CPU
# (tests/test_torch_bf16.py); a wrong kernel moves them by far more
BF16_TF_TOL = 2.0
BF16_ARGMAX_MIN = 0.75
# the same for the large2 model of the batched decode: random weights give
# max |logit| under 3, and a sound run reads deltas of a few 1e-6 (f32 sums
# in other orders over 6 layers), so the limit sits well under what a wrong
# attention would move
BATCH_TF_TOL = 1e-4
# the batched decode with attn_impl "fold" and "fold2" against "sp" in one
# run, best rates: their kernel must not set the pace of a step
FOLD_RATE_MIN = 0.8
FOLD_RATED = ("fold", "fold2")


def log(*a):
    print(*a, flush=True)


def k4_rows(torch, g, V: int, k: int):
    """[8, V] f32 rows from ``g`` that a k-th-largest search can get wrong:
    ties at the k-th largest; +inf, -inf and NaN; a constant row; all but k
    values at -inf; signed zeros among a few values; tiny values rounded
    to few distinct ones; a wide spread; small integers (ties everywhere)."""
    x = torch.randn(8, V, generator=g) * 3
    kth = x[0].topk(k).values[-1]
    x[0, torch.randperm(V, generator=g)[:10]] = kth
    pos = torch.randperm(V, generator=g)[:7]
    x[1, pos[:3]], x[1, pos[3:6]], x[1, pos[6]] = (float("inf"),
                                                   float("-inf"),
                                                   float("nan"))
    x[2] = 0.5
    keep = torch.randperm(V, generator=g)[:k]
    x[3] = float("-inf")
    x[3, keep] = torch.randn(k, generator=g)
    x[4] = torch.where(torch.rand(V, generator=g) < 0.5, 0.0, -0.0)
    x[4, torch.randperm(V, generator=g)[:20]] = torch.randn(20, generator=g)
    x[5] = (x[5] * 1e-3).to(torch.bfloat16).float()
    x[6] = x[6] * 30
    x[7] = torch.randint(-5, 6, (V,), generator=g).float()
    return x


# rows as the grammar leaves them (decode/grammar.py: masked logits are
# replaced by -1e30): n finite values, the rest at -1e30, or -1e30 times a
# repetition penalty of 1.3 for tokens already seen; top-k 50 keeps every
# -1e30 while fewer than 50 are finite (the 50th largest is -1e30)
K4_GRAMMAR_FINITE = (1, 2, 49, 50, 51, 128)
K4_GRAMMAR_V = (8892, 8579)
K4_GRAMMAR_TEMPS = (1.0, 0.8)


def k4_grammar_rows(torch, g, V: int, temp: float):
    """[2 * len(K4_GRAMMAR_FINITE), V] f32 rows a sampler sees after the
    grammar's mask and the temperature: for each count n of finite values,
    one row with every other entry at -1e30 and one where a few of them are
    -1.3e30 (penalized), each divided by ``temp``."""
    rows = []
    for n in K4_GRAMMAR_FINITE:
        for penalized in (False, True):
            x = torch.full((V,), -1e30)
            keep = torch.randperm(V, generator=g)[:n]
            x[keep] = torch.randn(n, generator=g) * 3
            if penalized:
                masked = torch.nonzero(x == -1e30)[:, 0]
                x[masked[torch.randperm(masked.numel(),
                                        generator=g)[:40]]] = -1e30 * 1.3
            rows.append(x / temp)
    return torch.stack(rows)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def _hold_device(torch, us: float) -> None:
    """Keep the device busy for about ``us`` microseconds, so that the host
    can enqueue what follows before the device gets to it."""
    khz = torch.cuda.get_device_properties(0).clock_rate
    torch.cuda._sleep(int(us * khz / 1000))


def _graphed(torch, fn):
    """fn() captured as a CUDA graph -> the graph's replay: the kernels
    that fn launches, back to back, with no host between them. Timing fn()
    itself would time the host wherever it issues slower than the device
    runs: a wrapper takes the host longer to call than its kernel takes,
    a plain version is a dozen such calls, and the host's speed varies
    between machines and between runs on one machine."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # thread_local: a serving thread of this process may call the
    # allocator while this thread captures
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    return graph.replay


def time_ms(torch, fn, iters: int = 50, cold: bool = False,
            hold_us: float = 1000.0) -> float:
    """Device time of fn() by CUDA events around replays of its graph (see
    :func:`_graphed`): the mean over iters replays back to back, or with
    ``cold`` the median over replays that each find the 50 MB L2 flushed
    (the flush is left out of the time), as the decode loop finds a
    layer's weights."""
    if cold:
        return time_cold_ms(torch, {"fn": fn}, iters, hold_us)["fn"]
    replay = _graphed(torch, fn)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    _hold_device(torch, 20.0 * iters)
    e0.record()
    for _ in range(iters):
        replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def time_cold_ms(torch, fns: dict, iters: int = 50,
                 hold_us: float = 1000.0, read_flush: bool = False) -> dict:
    """Median device time of each of ``fns`` (as graphs, see
    :func:`_graphed`) with the L2 flushed before every replay; the device
    is held meanwhile so that the replay is enqueued before it is due.
    The functions take turns, in an order that alternates from round to
    round, so that a drift of the card's clocks or of its neighbours falls
    on all of them alike: two kernels are compared only within one such
    call. The flush writes 384 MB, so the L2 is left full of lines to write
    back, as after a step that wrote; with ``read_flush`` it reads them
    instead and leaves it clean (the read rate of a kernel alone)."""
    flush = torch.empty(96 << 18, dtype=torch.float32, device="cuda")
    names = list(fns)
    replays = {name: _graphed(torch, fns[name]) for name in names}
    evs = {name: [] for name in names}
    for i in range(iters):
        for name in names if i % 2 == 0 else reversed(names):
            flush.sum() if read_flush else flush.zero_()
            _hold_device(torch, hold_us)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            replays[name]()
            e1.record()
            evs[name].append((e0, e1))
        torch.cuda.synchronize()
    out = {}
    for name, pairs in evs.items():
        times = sorted(a.elapsed_time(b) for a, b in pairs)
        out[name] = times[len(times) // 2]
    return out


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_checks(torch, ckpt_params) -> dict:
    """Phase 3. Returns {kernel: {dtype: record}}."""
    import ctypes

    import torch.nn.functional as F

    from eamg_tpu_torch.ops import (_build, attention, decode_attention,
                                    decode_fold, ffn, topk)

    dev = "cuda"
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, dt, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dt).to(dev)

    results = {}
    margins = {}   # cluster kernel: [(its rel. error, the plain bf16's)]

    def record(name, dt, err, k_ms, p_ms, lib_ms, n_b, flops, extra="",
               more=None):
        tol = TOL[(name, dt)]
        b_ms, b_by = bound_ms(n_b, flops, dt)
        ok = err <= tol
        log(f"[check] {name:16s} {dt:9s} max|err| {err:.3e} (tol {tol:.0e})"
            f" kernel {k_ms:.4f} ms plain {p_ms:.4f} ms library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} bound "
            f"{b_ms:.5f} ms ({b_by}, {b_ms / k_ms:.1%} of the kernel's "
            f"time) {extra}{'' if ok else '  FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {dt}: max|err| {err} > {tol}")
        results.setdefault(name, {})[dt] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, **(more or {}))

    def hold(name, dt, got, want, extra=""):
        """A kernel at a further shape of a path against its plain version:
        checked like the others; its record stays the main shape's."""
        tol = TOL[(name, dt)]
        err = (got.float() - want.float()).abs().max().item()
        if tol == 0.0 and not torch.equal(got.float().view(torch.int32),
                                          want.float().view(torch.int32)):
            err = float("inf")
        ok = torch.isfinite(got.float()).all().item() and err <= tol
        log(f"[check] {name:16s} {dt:9s} max|err| {err:.3e} (tol {tol:.0e}) "
            f"{extra}{'' if ok else '  FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {dt}: max|err| {err} > {tol}")

    def sdpa(q, k, v, causal):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)

    def rel_err(got, want32):
        return ((got.float() - want32).abs().max()
                / want32.abs().max().clamp_min(1e-30)).item()

    def rel_f32(name, got, want32, where="", tol=REL_TOL_F32, plain=None,
                enforce=True):
        """bf16 kernel output against the plain version in f32 on the
        upcast inputs: max|err| / max|want|, held to ``tol`` (with
        ``enforce``). ``plain``: the plain version's bf16 output on the same
        inputs, whose own error is logged beside the kernel's."""
        rel = rel_err(got, want32)
        own = ""
        if plain is not None:
            p_rel = rel_err(plain, want32)
            margins.setdefault(name, []).append((rel, p_rel))
            own = f", the plain bf16 version's own {p_rel:.3e}"
        log(f"[check] {name:16s} bfloat16  vs f32 plain{where}: max|err| / "
            f"max|want| {rel:.3e} (tol {tol:.0e}, max|want| "
            f"{want32.abs().max().item():.3e}{own})")
        if enforce and not rel <= tol:
            raise AssertionError(f"{name} bf16 vs f32 plain{where}: {rel} > "
                                 f"{tol}")

    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        # K1: prefill of one prompt bucket, B1 H8 Hkv2 Dh64 T16, causal;
        # timed warm (the record) and cold, beside SDPA, in one loop each
        B, H, Hkv, T, Dh = 1, 8, 2, 16, 64
        q = randn(B, H, T, Dh, dt=dt)
        k = randn(B, Hkv, T, Dh, dt=dt)
        v = randn(B, Hkv, T, Dh, dt=dt)
        vl = torch.full((B,), T, dtype=torch.int32, device=dev)
        got = attention.flash_attention(q, k, v, vl, causal=True)
        want = attention.attention_plain(q, k, v, vl, causal=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if dt is torch.bfloat16:
            rel_f32("flash_attention", got, attention.attention_plain(
                q.float(), k.float(), v.float(), vl, causal=True),
                plain=want)
        pairs = B * H * T * (T + 1) // 2
        k1_fns = {"kernel": lambda: attention.flash_attention(
                      q, k, v, vl, causal=True),
                  "plain": lambda: attention.attention_plain(
                      q, k, v, vl, causal=True),
                  "library": lambda: sdpa(q, k, v, True)}
        warm = {name: time_ms(torch, fn) for name, fn in k1_fns.items()}
        cold = time_cold_ms(torch, k1_fns)
        record("flash_attention", dt_name, err, warm["kernel"],
               warm["plain"], warm["library"], nbytes(q, k, v, q, vl),
               4 * pairs * Dh,
               extra=f"B {B} H {H} Hkv {Hkv} T {T} Dh {Dh} causal, warm; "
                     f"cold: kernel {cold['kernel']:.4f} ms, plain "
                     f"{cold['plain']:.4f}, library {cold['library']:.4f}; "
                     f"{attention.WARPS} warps a block",
               more={"warm": True, "ms_cold": cold["kernel"],
                     "plain_ms_cold": cold["plain"],
                     "library_ms_cold": cold["library"],
                     "warps": attention.WARPS})

        # K1 in the batched decode's prefill: B 8, MHA (one query head per
        # KV head), the 3-token prompt in its 16-slot bucket
        qa = randn(BENCH_B, BENCH_H, T, Dh, dt=dt)
        ka = randn(BENCH_B, BENCH_H, T, Dh, dt=dt)
        va = randn(BENCH_B, BENCH_H, T, Dh, dt=dt)
        vl3 = torch.full((BENCH_B,), 3, dtype=torch.int32, device=dev)
        got = attention.flash_attention(qa, ka, va, vl3, causal=True)
        want = attention.attention_plain(qa, ka, va, vl3, causal=True)
        torch.cuda.synchronize()
        hold("flash_attention_batch", dt_name, got, want,
             extra=f"q {tuple(qa.shape)} MHA, valid_len 3, causal")
        if dt is torch.bfloat16:
            rel_f32("flash_attention", got, attention.attention_plain(
                qa.float(), ka.float(), va.float(), vl3, causal=True),
                where=" at the batch shape", plain=want)
        # K1 at the longer prompt buckets (T 64 and the capped 511, with
        # valid_len < T, per-row lengths at B 2), at Dh 48 (demo_ckpt_b3's
        # head), causal and not, from a generator of their own
        ga = torch.Generator().manual_seed(64)
        for (Ba, Ha, Hkva, Ta, Dha, vls, causal) in K1_SHAPES:
            qx, kx, vx = (torch.randn(Ba, hh, Ta, Dha, generator=ga).to(dt)
                          .to(dev) for hh in (Ha, Hkva, Hkva))
            vlx = torch.tensor(vls, dtype=torch.int32, device=dev)
            got = attention.flash_attention(qx, kx, vx, vlx, causal=causal)
            want = attention.attention_plain(qx, kx, vx, vlx, causal=causal)
            torch.cuda.synchronize()
            where = (f"B {Ba} H {Ha} Hkv {Hkva} T {Ta} Dh {Dha} valid_len "
                     f"{vls} causal {causal}")
            hold("flash_attention_shapes", dt_name, got, want, extra=where)
            if dt is torch.bfloat16:
                rel_f32("flash_attention", got, attention.attention_plain(
                    qx.float(), kx.float(), vx.float(), vlx, causal=causal),
                    where=" at " + where, plain=want)
            del qx, kx, vx

        # K2: the flagship's layer-0 FFN (the large2 model's has the same
        # D 512, FF 2048 and relu): rows 1 (solo decode), 8 (engine and
        # batched decode), 16 (solo prefill), 128 (batched prefill, 8 x 16),
        # each timed cold with its plain version and the library call, in
        # the served models' rounding order (kernels="xla"), and checked
        # and timed in the Pallas kernel's order beside it
        mlp = {n: w.to(dt).to(dev) for n, w in
               ckpt_params["layers"][0]["mlp"].items()}
        D, FF = mlp["w2"].shape
        if (D, FF) != (512, 2048):
            raise AssertionError(f"FFN {D} x {FF} is not large2's")
        for rows in (1, ENGINE_SLOTS, 16, BENCH_B * 16):
            x = randn(rows, D, dt=dt)
            args = (x, mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"])
            outs = {order: (ffn.fused_ffn(*args, activation="relu",
                                          order=order),
                            ffn.ffn_plain(*args, activation="relu",
                                          order=order))
                    for order in ffn.ORDER}
            torch.cuda.synchronize()
            err = {order: (got.float() - want.float()).abs().max().item()
                   for order, (got, want) in outs.items()}

            def lib(a=args):
                return F.linear(torch.relu(F.linear(a[0], a[1], a[2])),
                                a[3], a[4])

            ms = time_cold_ms(torch, {
                **{order: (lambda a=args, o=order: ffn.fused_ffn(
                    *a, activation="relu", order=o)) for order in ffn.ORDER},
                "plain": lambda a=args: ffn.ffn_plain(*a, activation="relu",
                                                      order="xla"),
                "library": lib})
            name = "fused_ffn" if rows == 1 else f"fused_ffn_rows{rows}"
            hold(name, dt_name, *outs["pallas"],
                 extra=f"rows {rows} in the Pallas order, cold "
                       f"{ms['pallas']:.4f} ms")
            record(name, dt_name, err["xla"], ms["xla"], ms["plain"],
                   ms["library"], nbytes(*args, x), 4 * rows * D * FF,
                   extra=f"rows {rows}, D {D}, FF {FF}, cold, the "
                         f"kernels=\"xla\" order",
                   more={"order": "xla", "pallas_order_ms": ms["pallas"],
                         "pallas_order_max_abs_err": err["pallas"]})
        # a shape no path gives K2, from a generator of its own (the draws
        # of the checks after it stay those of earlier runs)
        gg = torch.Generator().manual_seed(1536)
        Dg, FFg, rg = 1536, 192, 5

        def gdraw(*shape, scale=1.0, dtype=dt):
            return (torch.randn(*shape, generator=gg) * scale).to(dtype).to(
                dev)

        gargs = (gdraw(rg, Dg), gdraw(FFg, Dg, scale=Dg ** -0.5),
                 gdraw(FFg, scale=0.1, dtype=torch.float32),
                 gdraw(Dg, FFg, scale=FFg ** -0.5),
                 gdraw(Dg, scale=0.1, dtype=torch.float32))
        plan = ffn.ffn_plan(Dg, FFg)
        for order in ffn.ORDER:
            got = ffn.fused_ffn(*gargs, activation="gelu", order=order)
            torch.cuda.synchronize()
            hold("fused_ffn_gelu", dt_name, got,
                 ffn.ffn_plain(*gargs, activation="gelu", order=order),
                 extra=f"rows {rg}, D {Dg} ({Dg // plan.panel} panels), FF "
                       f"{FFg} ({len(plan.slices)} blocks), exact gelu, "
                       f"biases in f32, the {order} order")
        Dw, FFw = 64, 32832
        wargs = (gdraw(3, Dw), gdraw(FFw, Dw, scale=Dw ** -0.5),
                 gdraw(FFw, scale=0.1), gdraw(Dw, FFw, scale=FFw ** -0.5),
                 gdraw(Dw, scale=0.1))
        for order in ffn.ORDER:
            got = ffn.fused_ffn(*wargs, activation="relu", order=order)
            torch.cuda.synchronize()
            hold("fused_ffn_wide", dt_name, got,
                 ffn.ffn_plain(*wargs, activation="relu", order=order),
                 extra=f"rows 3, D {Dw}, FF {FFw}, the {order} order")

        # K3: one decode step over the flagship's 511-slot cache, at every
        # K3_T; at the positions of an engine batch of 8 (one t a row);
        # at the further shapes of K3_SHAPES and with every cluster size;
        # timed cold at t 300 beside the plain version and SDPA on keys
        # 0..t, in one loop
        M = 511
        kc = randn(1, Hkv, M, Dh, dt=dt)
        vc = randn(1, Hkv, M, Dh, dt=dt)
        q1 = randn(1, H, 1, Dh, dt=dt)
        worst = 0.0
        by_head, C_sp = decode_attention.sp_plan(M, Dh, H // Hkv,
                                                 kc.element_size(), lambda: 0)
        split = [c for c in (1, 2, 4, 8, 16) if by_head or c != C_sp]
        for t in K3_T:
            tt = torch.full((1,), t, dtype=torch.int32, device=dev)
            got = decode_attention.flash_decode_sp(q1, kc, vc, tt)
            want = decode_attention.decode_attention_plain(q1, kc, vc, tt)
            torch.cuda.synchronize()
            worst = max(worst, (got.float() - want.float()).abs().max()
                        .item())
            if dt is torch.bfloat16:
                rel_f32("flash_decode_sp", got,
                        decode_attention.decode_attention_plain(
                            q1.float(), kc.float(), vc.float(), tt),
                        where=f" at t {t}", plain=want)
            for c in split:
                hold("flash_decode_sp_shapes", dt_name,
                     decode_attention._flash_decode_sp(q1, kc, vc, tt, C=c),
                     want, extra=f"over spans of the keys, C {c}, at t {t}")
        gk = torch.Generator().manual_seed(8)
        kr8, vr8 = (torch.randn(BENCH_B, Hkv, M, Dh, generator=gk).to(dt)
                    .to(dev) for _ in range(2))
        qr8 = torch.randn(BENCH_B, H, 1, Dh, generator=gk).to(dt).to(dev)
        tr8 = torch.tensor(K3_ROWS_T, dtype=torch.int32, device=dev)
        got = decode_attention.flash_decode_sp(qr8, kr8, vr8, tr8)
        want = decode_attention.decode_attention_plain(qr8, kr8, vr8, tr8)
        torch.cuda.synchronize()
        hold("flash_decode_sp_shapes", dt_name, got, want,
             extra=f"B {BENCH_B} H {H} Hkv {Hkv} M {M}, t {K3_ROWS_T}")
        if dt is torch.bfloat16:
            rel_f32("flash_decode_sp", got,
                    decode_attention.decode_attention_plain(
                        qr8.float(), kr8.float(), vr8.float(), tr8),
                    where=f" at B {BENCH_B}, t {K3_ROWS_T}", plain=want)
        del kr8, vr8
        for (Bs, Hs, Hkvs, Ms, Dhs, ts) in K3_SHAPES:
            qs_, ks_, vs_ = (torch.randn(Bs, hh, m, Dhs, generator=gk).to(dt)
                             .to(dev) for hh, m in ((Hs, 1), (Hkvs, Ms),
                                                    (Hkvs, Ms)))
            tt = torch.tensor(ts, dtype=torch.int32, device=dev)
            got = decode_attention.flash_decode_sp(qs_, ks_, vs_, tt)
            want = decode_attention.decode_attention_plain(qs_, ks_, vs_, tt)
            torch.cuda.synchronize()
            where = f"B {Bs} H {Hs} Hkv {Hkvs} M {Ms} Dh {Dhs} t {ts}"
            hold("flash_decode_sp_shapes", dt_name, got, want, extra=where)
            if dt is torch.bfloat16:
                rel_f32("flash_decode_sp", got,
                        decode_attention.decode_attention_plain(
                            qs_.float(), ks_.float(), vs_.float(), tt),
                        where=" at " + where, plain=want)
            del qs_, ks_, vs_
        t = 300   # timed mid-song
        tt = torch.full((1,), t, dtype=torch.int32, device=dev)
        kv_live = 2 * (t + 1) * Hkv * Dh * kc.element_size()
        ms = time_cold_ms(torch, {
            "kernel": lambda: decode_attention.flash_decode_sp(q1, kc, vc,
                                                               tt),
            "plain": lambda: decode_attention.decode_attention_plain(
                q1, kc, vc, tt),
            "library": lambda: sdpa(q1, kc[:, :, :t + 1], vc[:, :, :t + 1],
                                    False),
            **{c: (lambda c=c: decode_attention._flash_decode_sp(
                q1, kc, vc, tt, C=c)) for c in split}})
        others = {c: ms[c] for c in split}
        warm = {name: time_ms(torch, fn) for name, fn in (
            ("kernel", lambda: decode_attention.flash_decode_sp(q1, kc, vc,
                                                                tt)),
            ("library", lambda: sdpa(q1, kc[:, :, :t + 1],
                                     vc[:, :, :t + 1], False)))}
        record("flash_decode_sp", dt_name, worst, ms["kernel"], ms["plain"],
               ms["library"], nbytes(q1, q1, tt) + kv_live,
               4 * H * (t + 1) * Dh,
               extra=f"B 1 H {H} Hkv {Hkv} M {M}, "
                     f"{'by head' if by_head else 'over spans'}, C {C_sp}, "
                     f"err over t in {K3_T}, timed cold at t {t}; over "
                     "spans: " + ", ".join(
                         f"C {c} {v_:.4f}" for c, v_ in others.items())
                     + f"; warm: kernel {warm['kernel']:.4f} ms, library "
                       f"{warm['library']:.4f}",
               more={"C": C_sp, "by_head": by_head, "split_C_ms": others,
                     "ms_warm": warm["kernel"],
                     "library_ms_warm": warm["library"]})

        # the shared memory of K3's kernel by head, as the wrapper computes
        # it to pick the plan, against the kernel's own layout
        heads_lib = _build.library("decode_attention")
        heads_lib.eamg_decode_heads_smem.argtypes = [
            _build.I, _build.I, _build.I, ctypes.POINTER(ctypes.c_longlong)]
        for Mx, Dhx in ((511, 64), (50, 48), (1000, 128), (16384, 16)):
            n = ctypes.c_longlong(0)
            _build.check(heads_lib.eamg_decode_heads_smem(
                Mx, Dhx, _build.DTYPE_CODE[dt], ctypes.byref(n)),
                "heads smem")
            mine = decode_attention.heads_smem(Mx, Dhx, kc.element_size())
            if n.value != mine:
                raise AssertionError(f"heads_smem({Mx}, {Dhx}) {mine}, the "
                                     f"kernel's {n.value}")

        # K4, its two entry points (the threshold, and the sampler's top-k
        # mask in the same launch) bit-equal to their plain versions at
        # every K4_V (the flagship's, B3's and the Scheme-B2 vocabulary, and
        # rows longer than a block keeps in registers), at B 1 and 8 and k
        # 1, 50 and V, on the rows of k4_rows; then on K4_RANDOM_ROWS seeded
        # rows at once
        gt = torch.Generator().manual_seed(4)
        checked = 0
        for V in K4_V:
            for k in (1, 50, V):
                rows8 = k4_rows(torch, gt, V, k).to(dt).to(dev)
                for part in (rows8, *rows8.split(1)):
                    for entry in ("kth_value", "top_k_mask"):
                        got = getattr(topk, entry)(part, k)
                        want = getattr(topk, entry + "_plain")(part, k)
                        if not torch.equal(got.float().view(torch.int32),
                                           want.float().view(torch.int32)) \
                                or got.dtype != want.dtype:
                            raise AssertionError(
                                f"{entry} {dt_name} V {V} k {k} rows "
                                f"{tuple(part.shape)}: not bit-equal")
                        checked += 1
        xr = (torch.randn(K4_RANDOM_ROWS, 8892, generator=gt)
              * torch.rand(K4_RANDOM_ROWS, 1, generator=gt) * 10).to(dt).to(dev)
        for entry in ("kth_value", "top_k_mask"):
            hold(entry if entry == "top_k_mask" else "kth_value_batch",
                 dt_name, getattr(topk, entry)(xr, 50),
                 getattr(topk, entry + "_plain")(xr, 50),
                 extra=f"{entry}: {K4_RANDOM_ROWS} seeded rows of 8892, k 50,"
                       " bit-equal")
        log(f"[check] kth_value / top_k_mask {dt_name}: bit-equal to their "
            f"plain versions in {checked} calls (V {K4_V}, k 1, 50, V, B 8 "
            "and each row alone: ties at the threshold, +-inf and NaN, a "
            "constant row, all but k at -inf, signed zeros, integers)")
        # the rows the grammar leaves (most of the row tied at -1e30): the
        # whole batch and each row alone, k 50
        grammar_checked = 0
        for V in K4_GRAMMAR_V:
            for temp in K4_GRAMMAR_TEMPS:
                rows = k4_grammar_rows(torch, gt, V, temp).to(dt).to(dev)
                for part in (rows, *rows.split(1)):
                    for entry in ("kth_value", "top_k_mask"):
                        got = getattr(topk, entry)(part, 50)
                        want = getattr(topk, entry + "_plain")(part, 50)
                        if not torch.equal(got.float().view(torch.int32),
                                           want.float().view(torch.int32)) \
                                or got.dtype != want.dtype:
                            raise AssertionError(
                                f"{entry} {dt_name} V {V} grammar rows, "
                                f"temperature {temp}, rows "
                                f"{tuple(part.shape)}: not bit-equal")
                        grammar_checked += 1
        log(f"[check] kth_value / top_k_mask {dt_name}: bit-equal to their "
            f"plain versions on the grammar's rows in {grammar_checked} "
            f"calls (V {K4_GRAMMAR_V}, finite values {K4_GRAMMAR_FINITE}, "
            "the rest -1e30 or -1.3e30, temperatures "
            f"{K4_GRAMMAR_TEMPS}, k 50, the batch and each row alone)")
        # timed: one row (solo) and one per engine slot, over the flagship
        # vocabulary, k 50, cold (the record) and warm, beside the plain
        # versions and the library's topk (and topk and the three ops for
        # the mask)
        V = 8892
        for nb in (1, ENGINE_SLOTS):
            logits = randn(nb, V, dt=dt, scale=3.0)
            logits[0, 100:110] = logits[0, 5]          # ties
            # both entry points against their plain versions on the timed
            # logits: max|err|, inf where the bits or the dtypes differ
            err = {}
            for entry in ("kth_value", "top_k_mask"):
                got = getattr(topk, entry)(logits, 50)
                want = getattr(topk, entry + "_plain")(logits, 50)
                err[entry] = (got.float() - want.float()).abs().max().item()
                if got.dtype != want.dtype or not torch.equal(
                        got.float().view(torch.int32),
                        want.float().view(torch.int32)):
                    err[entry] = float("inf")
            if err["top_k_mask"] > TOL[("top_k_mask", dt_name)]:
                raise AssertionError(f"top_k_mask {dt_name} [{nb}, {V}]: "
                                     f"max|err| {err['top_k_mask']}")
            fns = {"kernel": lambda x=logits: topk.kth_value(x, 50),
                   "plain": lambda x=logits: topk.kth_value_plain(x, 50),
                   "library": lambda x=logits: torch.topk(
                       x, 50).values[..., -1:],
                   "mask": lambda x=logits: topk.top_k_mask(x, 50),
                   "mask_plain": lambda x=logits: topk.top_k_mask_plain(x, 50),
                   "mask_library": lambda x=logits: topk._masked(
                       x, torch.topk(x, 50).values[..., -1:], -1e10)}
            cold = time_cold_ms(torch, fns)
            warm = {n: time_ms(torch, fns[n]) for n in
                    ("kernel", "library", "mask", "mask_library")}
            m_b, _ = bound_ms(2 * nbytes(logits), 8 * V * nb, dt_name)
            record("kth_value" if nb == 1 else f"kth_value_b{nb}", dt_name,
                   err["kth_value"], cold["kernel"], cold["plain"],
                   cold["library"], nbytes(logits) + 4 * nb, 8 * V * nb,
                   extra=f"B {nb}, k 50, cold; warm: kernel "
                         f"{warm['kernel']:.4f} ms, library "
                         f"{warm['library']:.4f}; the fused mask cold "
                         f"{cold['mask']:.4f} ms (max|err| "
                         f"{err['top_k_mask']:.3e}; warm {warm['mask']:.4f}, "
                         f"bound {m_b:.5f}), plain {cold['mask_plain']:.4f},"
                         f" topk and the three ops {cold['mask_library']:.4f}"
                         f" (warm {warm['mask_library']:.4f})",
                   more={"mask_max_abs_err": err["top_k_mask"],
                         "ms_warm": warm["kernel"],
                         "library_ms_warm": warm["library"],
                         "mask_ms": cold["mask"], "mask_ms_warm": warm["mask"],
                         "mask_plain_ms": cold["mask_plain"],
                         "mask_library_ms": cold["mask_library"],
                         "mask_library_ms_warm": warm["mask_library"],
                         "mask_bound_ms": m_b})
        if dt is torch.float32:
            # the sampler's top-k on f32 logits is one launch of K4: no
            # compare, where or add after it. In the same session, the
            # three ops on a threshold, whose kernels the served traces
            # must not show right after K4 (SAMPLER_OPS names them)
            from eamg_tpu_torch.decode import sampling

            thr = topk.kth_value_plain(logits, 50)
            ran = _device_kernels(torch, lambda: (
                sampling.apply_top_k(logits, 50),
                topk._masked(logits, thr, -1e10)))
            log(f"[check] apply_top_k on f32 [{ENGINE_SLOTS}, {V}], then the "
                f"three ops on its threshold: device kernels in order {ran}")
            if "topk_reg_kernel" not in ran[0] \
                    or not _is_sampler_ops(ran[1:]):
                raise AssertionError(f"apply_top_k and the three ops ran "
                                     f"{ran}, not one K4 launch and "
                                     f"{SAMPLER_OPS}")

        # K4 in the batched decode: 8 rows over the Scheme-B2 vocabulary
        logits = randn(BENCH_B, 8324, dt=dt, scale=3.0)
        logits[3, 100:110] = logits[3, 5]          # ties
        got = topk.kth_value(logits, 50)
        torch.cuda.synchronize()
        hold("kth_value_batch", dt_name, got,
             topk.kth_value_plain(logits, 50),
             extra=f"logits {tuple(logits.shape)}, k 50, bit-equal")

        # rows 8 and 11 (one kernel, K3's built for the fused layout): one
        # engine step, 8 rows over the flagship's fused position-major
        # cache, ragged lengths, with the plan the wrappers pick, over spans
        # with every cluster size, and at FOLD_SP_SHAPES; timed cold (and
        # warm) beside the plain version and the masked SDPA
        B, D, KVD = ENGINE_SLOTS, H * Dh, Hkv * Dh
        kvc = randn(B, M, 2 * KVD, dt=dt)
        kvc[0] = 0                                  # a free slot: zeros
        qf = randn(B, 1, D, dt=dt)
        tf = torch.tensor(FOLD_T, dtype=torch.int32, device=dev)
        live = sum(t + 1 for t in FOLD_T)
        kv_live = 2 * live * KVD * kvc.element_size()
        want = decode_fold.decode_attention_pm_plain(qf, kvc, tf, H)
        want32 = decode_fold.decode_attention_pm_plain(
            qf.float(), kvc.float(), tf, H)
        # the library yardstick: SDPA on a head-major copy of the cache
        # (made outside the timed call), the lengths as a boolean mask
        kh = kvc[..., :KVD].reshape(B, M, Hkv, Dh).transpose(1, 2)
        vh = kvc[..., KVD:].reshape(B, M, Hkv, Dh).transpose(1, 2)
        kh, vh = kh.contiguous(), vh.contiguous()
        qh = qf.reshape(B, H, 1, Dh)
        keep = (torch.arange(M, device=dev)[None, :]
                <= tf[:, None])[:, None, None, :]

        def sdpa_ragged():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep,
                                                  enable_gqa=True)

        lib = sdpa_ragged().reshape(B, 1, D)
        lib_err = (lib.float() - want32).abs().max().item()
        sp_by_head, sp_C = decode_fold.sp_plan(M, Dh, H // Hkv, dt)
        sp_split = [c for c in (1, 2, 4, 8, 16) if sp_by_head or c != sp_C]
        fold_ms = time_cold_ms(torch, {
            "flash_decode_fold_sp": lambda: decode_fold.flash_decode_fold_sp(
                qf, kvc, tf, H),
            "flash_decode_fold3_sp": lambda: decode_fold.flash_decode_fold3_sp(
                qf, kvc, tf, H),
            "plain": lambda: decode_fold.decode_attention_pm_plain(
                qf, kvc, tf, H),
            "library": sdpa_ragged,
            **{c: (lambda c=c: decode_fold._fold_sp(
                "flash_decode_fold_sp", qf, kvc, tf, H, C=c))
               for c in sp_split}})
        fold_warm = {n: time_ms(torch, fn) for n, fn in (
            ("kernel", lambda: decode_fold.flash_decode_fold_sp(qf, kvc, tf,
                                                                H)),
            ("library", sdpa_ragged))}
        p_ms, lib_ms = fold_ms["plain"], fold_ms["library"]
        sp_others = {c: fold_ms[c] for c in sp_split}
        for name in ("flash_decode_fold_sp", "flash_decode_fold3_sp"):
            fn = getattr(decode_fold, name)
            got = fn(qf, kvc, tf, H)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all() or \
                    got[0].abs().max().item() != 0.0:
                raise AssertionError(f"{name}: a free slot (t 0 over zeros) "
                                     "must give zeros")
            err = (got.float() - want.float()).abs().max().item()
            if dt is torch.bfloat16:
                for b, t in enumerate(FOLD_T):
                    if b:   # row 0 is all zeros
                        rel_f32(name, got[b], want32[b], where=f" at t {t}",
                                plain=want[b])
            # a strided q: the head of a fused QKV projection
            qkv = torch.cat([qf, randn(B, 1, 2 * KVD, dt=dt)], dim=-1)
            if not torch.equal(fn(qkv[..., :D], kvc, tf, H), got):
                raise AssertionError(f"{name}: strided q differs")
            for c in sp_split:
                alt = decode_fold._fold_sp(name, qf, kvc, tf, H, C=c)
                torch.cuda.synchronize()
                hold("flash_decode_fold_sp_shapes", dt_name, alt, want,
                     extra=f"{name} over spans of the keys, C {c}")
                if dt is torch.bfloat16:
                    for b, t in enumerate(FOLD_T):
                        if b:
                            rel_f32(name, alt[b], want32[b], plain=want[b],
                                    where=f" over spans, C {c}, at t {t}")
            record(name, dt_name, err, fold_ms[name],
                   p_ms, lib_ms, nbytes(qf, qf, tf) + kv_live,
                   4 * H * live * Dh,
                   extra=f"B {B}, M {M}, t {FOLD_T}, "
                         f"{'by head' if sp_by_head else 'over spans'}, C "
                         f"{sp_C}; over spans: " + ", ".join(
                             f"C {c} {v_:.4f}" for c, v_ in sp_others.items())
                         + f"; warm: kernel {fold_warm['kernel']:.4f} ms, "
                           f"library {fold_warm['library']:.4f}; library "
                           f"max|err| vs f32 plain {lib_err:.1e}",
                   more={"by_head": sp_by_head, "C": sp_C,
                         "split_C_ms": sp_others,
                         "ms_warm": fold_warm["kernel"],
                         "library_ms_warm": fold_warm["library"]})
        # rows 8 and 11 beyond the engine's step, from a generator of their
        # own: FOLD_SP_SHAPES (Dh 48, a cache too long to go by head, t past
        # the cache beside t 0 over a zeroed row)
        gf = torch.Generator().manual_seed(48)
        for (Bs, Hs, Hkvs, Ms, Dhs, ts, zero) in FOLD_SP_SHAPES:
            qs_ = torch.randn(Bs, 1, Hs * Dhs, generator=gf).to(dt).to(dev)
            kvs_ = torch.randn(Bs, Ms, 2 * Hkvs * Dhs, generator=gf).to(dt)\
                .to(dev)
            if zero is not None:
                kvs_[zero] = 0
            tt = torch.tensor(ts, dtype=torch.int32, device=dev)
            want_ = decode_fold.decode_attention_pm_plain(qs_, kvs_, tt, Hs)
            where = (f"B {Bs} H {Hs} Hkv {Hkvs} M {Ms} Dh {Dhs} t {ts} ("
                     + ("by head" if decode_fold.sp_plan(
                         Ms, Dhs, Hs // Hkvs, dt)[0] else "over spans") + ")")
            for name in ("flash_decode_fold_sp", "flash_decode_fold3_sp"):
                got = getattr(decode_fold, name)(qs_, kvs_, tt, Hs)
                torch.cuda.synchronize()
                hold("flash_decode_fold_sp_shapes", dt_name, got, want_,
                     extra=f"{name} at {where}")
                if zero is not None and got[zero].abs().max().item() != 0.0:
                    raise AssertionError(f"{name}: t 0 over a zeroed row must "
                                         "give zeros")
                if dt is torch.bfloat16:
                    rel_f32(name, got, decode_fold.decode_attention_pm_plain(
                        qs_.float(), kvs_.float(), tt, Hs), where=" at " + where,
                        plain=want_)
            del qs_, kvs_

        # stream reduce, the read-rate probe over one layer's engine cache:
        # one launch a call (the wrapper's count), two calls
        # bit-equal, the error against the plain version; then at shapes
        # whose lines do not start on 16 bytes or leave a trailing batch row
        # unread, and past the L2 (kv [64, 511, 1024], 67 MB in bf16), each
        # timed cold with the L2 left dirty (as every record) and clean
        rows = 4
        kvs = randn(B, M, 2 * KVD, dt=dt)
        got = decode_fold.stream_reduce(kvs, rows)
        before = _build.launch_counts().get("stream_reduce", 0)
        again = decode_fold.stream_reduce(kvs, rows)
        calls = _build.launch_counts().get("stream_reduce", 0) - before
        want = decode_fold.stream_reduce_plain(kvs, rows)
        torch.cuda.synchronize()
        if calls != 1:
            raise AssertionError(f"stream_reduce: {calls} launches a call")
        if not torch.equal(got, again):
            raise AssertionError("stream_reduce: two calls differ")
        err = (got.float() - want.float()).abs().max().item()
        fns = {"kernel": lambda: decode_fold.stream_reduce(kvs, rows),
               "plain": lambda: decode_fold.stream_reduce_plain(kvs, rows),
               "library": lambda: kvs[B - rows:].sum(dim=(0, 1),
                                                     dtype=torch.float32)}
        cold = time_cold_ms(torch, fns)
        clean = time_cold_ms(torch, {"kernel": fns["kernel"]},
                             read_flush=True)["kernel"]
        warm = time_ms(torch, fns["kernel"])
        nb_ = nbytes(kvs)
        record("stream_reduce", dt_name, err, cold["kernel"], cold["plain"],
               cold["library"], nb_ + 2 * KVD * kvs.element_size(),
               kvs.numel(),
               extra=f"kv {tuple(kvs.shape)}, rows {rows}: one launch a "
                     f"call, two calls bit-equal; reads "
                     f"{nb_ / cold['kernel'] / 1e6:.1f} GB/s cold, "
                     f"{nb_ / clean / 1e6:.1f} with a clean L2 ({clean:.4f} "
                     f"ms), warm {warm:.4f} ms (the plain and library "
                     "versions read the last group only)",
               more={"gb_per_s": nb_ / cold["kernel"] / 1e6,
                     "ms_clean_l2": clean, "gb_per_s_clean_l2":
                     nb_ / clean / 1e6, "ms_warm": warm})
        gs = torch.Generator().manual_seed(12)
        for shape, r in STREAM_SHAPES:
            kx = torch.randn(*shape, generator=gs).to(dt).to(dev)
            got = decode_fold.stream_reduce(kx, r)
            again = decode_fold.stream_reduce(kx, r)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"stream_reduce {shape}: two calls "
                                     "differ")
            extra = f"kv {shape}, rows {r}, two calls bit-equal"
            if nbytes(kx) > 50 << 20:
                t_d = time_cold_ms(torch, {"k": lambda: decode_fold
                                           .stream_reduce(kx, r)})["k"]
                t_c = time_cold_ms(torch, {"k": lambda: decode_fold
                                           .stream_reduce(kx, r)},
                                   read_flush=True)["k"]
                b_ms, _ = bound_ms(nbytes(kx), kx.numel(), dt_name)
                extra += (f"; cold {t_d:.4f} ms, {nbytes(kx) / t_d / 1e6:.1f}"
                          f" GB/s; with a clean L2 {t_c:.4f} ms, "
                          f"{nbytes(kx) / t_c / 1e6:.1f} GB/s; bound "
                          f"{b_ms:.4f} ms")
                results.setdefault("stream_reduce_large", {})[dt_name] = {
                    "shape": list(shape), "ms": t_d, "ms_clean_l2": t_c,
                    "bound_ms": b_ms, "gb_per_s": nbytes(kx) / t_d / 1e6,
                    "gb_per_s_clean_l2": nbytes(kx) / t_c / 1e6}
            hold("stream_reduce", dt_name, got,
                 decode_fold.stream_reduce_plain(kx, r), extra=extra)
            del kx

        # the batched offline decode's two scalar-t kernels, one cluster
        # kernel with a rounding flag: B 8, MHA H 8, over a head-major cache
        # of 511 slots, at every BENCH_T; with the cluster size the wrapper
        # picks (decode_attention.cluster_size) and with the other
        # sizes; their bf16 error against the f32 plain version beside the
        # plain bf16 version's own
        Bb, Hb = BENCH_B, BENCH_H
        kb = randn(Bb, Hb, M, Dh, dt=dt)
        vb = randn(Bb, Hb, M, Dh, dt=dt)
        qb = randn(Bb, Hb, 1, Dh, dt=dt)
        scalar_t = {name: getattr(decode_attention, name)
                    for name in SCALAR_T_KERNELS}
        C_st = decode_attention.cluster_size(M, 1, lambda: 0)
        other_st = [c for c in (1, 2, 4, 8, 16) if c != C_st]
        worst = dict.fromkeys(scalar_t, 0.0)
        for t in BENCH_T:
            tt = torch.full((Bb,), t, dtype=torch.int32, device=dev)
            want = decode_attention.decode_attention_plain(qb, kb, vb, tt)
            want32 = decode_attention.decode_attention_plain(
                qb.float(), kb.float(), vb.float(), tt)
            # K3 is the batched decode's default: the same shape
            got = decode_attention.flash_decode_sp(qb, kb, vb, tt)
            torch.cuda.synchronize()
            hold("flash_decode_sp_batch", dt_name, got, want,
                 extra=f"q {tuple(qb.shape)} MHA, M {M}, t {t}")
            if dt is torch.bfloat16:
                rel_f32("flash_decode_sp", got, want32,
                        where=f" at the batch shape, t {t}", plain=want)
            for name, fn in scalar_t.items():
                got = fn(qb, kb, vb, tt[:1])
                torch.cuda.synchronize()
                if not torch.isfinite(got.float()).all():
                    raise AssertionError(f"{name}: not finite at t {t}")
                worst[name] = max(worst[name], (got.float() - want.float())
                                  .abs().max().item())
                if dt is torch.bfloat16:
                    rel_f32(name, got, want32, where=f" at t {t}", plain=want)
                for c in other_st:
                    alt = decode_attention._scalar_t(name, qb, kb, vb,
                                                     tt[:1], C=c)
                    torch.cuda.synchronize()
                    hold(name, dt_name, alt, want,
                         extra=f"with C {c} at t {t}")
        # a ragged cache (no multiple of a key block or of C) and a long one
        # (the slots' ring: 59999 keys over 16 blocks), from a generator of
        # their own
        gr = torch.Generator().manual_seed(50)
        for (Br, Hr, Mr, ts) in ((2, 4, 50, (0, 41, 49)),
                                 (1, 2, 60000, (30000, 59999))):
            qr, kr, vr = (torch.randn(Br, Hr, m, Dh, generator=gr).to(dt)
                          .to(dev) for m in (1, Mr, Mr))
            for t in ts:
                tt = torch.full((Br,), t, dtype=torch.int32, device=dev)
                want = decode_attention.decode_attention_plain(qr, kr, vr, tt)
                want32 = decode_attention.decode_attention_plain(
                    qr.float(), kr.float(), vr.float(), tt)
                for name, fn in scalar_t.items():
                    got = fn(qr, kr, vr, tt[:1])
                    torch.cuda.synchronize()
                    where = f" at M {Mr}, t {t}"
                    hold(name, dt_name, got, want, extra=where.strip())
                    if dt is torch.bfloat16:
                        rel_f32(name, got, want32, where=where, plain=want)
            del qr, kr, vr
        # timed cold at t 300 and 510 in one loop, with K3, the plain
        # version, SDPA on the keys 0..t and the other cluster sizes
        fns = {}
        for t in (BENCH_TIMED_T, BENCH_LAST_T):
            tt = torch.full((Bb,), t, dtype=torch.int32, device=dev)
            fns.update({
                **{(name, t): (lambda fn=fn, tt=tt: fn(qb, kb, vb, tt[:1]))
                   for name, fn in scalar_t.items()},
                **{(name, t, c): (lambda name=name, tt=tt, c=c:
                                  decode_attention._scalar_t(
                                      name, qb, kb, vb, tt[:1], C=c))
                   for name in scalar_t for c in other_st},
                ("flash_decode_sp", t): lambda tt=tt: decode_attention
                .flash_decode_sp(qb, kb, vb, tt),
                ("plain", t): lambda tt=tt: decode_attention
                .decode_attention_plain(qb, kb, vb, tt),
                ("library", t): lambda t=t: sdpa(qb, kb[:, :, :t + 1],
                                                 vb[:, :, :t + 1], False)})
        ms = time_cold_ms(torch, fns)

        def prefix_bytes(t):
            """The keys the function needs, the prefix 0..t, with q and o."""
            return (nbytes(qb, qb) + 2 * (t + 1) * Bb * Hb * Dh
                    * kb.element_size(), 4 * Bb * Hb * (t + 1) * Dh)

        t, t2 = BENCH_TIMED_T, BENCH_LAST_T
        for name in scalar_t:
            b510 = bound_ms(*prefix_bytes(t2), dt_name)[0]
            more = {"C": C_st, "ms_t510": ms[(name, t2)],
                    "bound_ms_t510": b510, "plain_ms_t510": ms[("plain", t2)],
                    "library_ms_t510": ms[("library", t2)],
                    "other_C_ms": {c: ms[(name, t, c)] for c in other_st},
                    "other_C_ms_t510": {c: ms[(name, t2, c)]
                                        for c in other_st}}
            record(name, dt_name, worst[name], ms[(name, t)],
                   ms[("plain", t)], ms[("library", t)], *prefix_bytes(t),
                   extra=f"B {Bb}, H {Hb}, M {M}, C {C_st}, err over t in "
                         f"{BENCH_T}, timed at t {t}; at t {t2}: "
                         f"{ms[(name, t2)]:.4f} ms (bound {b510:.5f}, plain "
                         f"{ms[('plain', t2)]:.4f}, library "
                         f"{ms[('library', t2)]:.4f}); other C at t {t} / "
                         f"{t2}: " + ", ".join(
                             f"C {c} {ms[(name, t, c)]:.4f} / "
                             f"{ms[(name, t2, c)]:.4f}" for c in other_st)
                         + f"; K3 at this shape "
                           f"{ms[('flash_decode_sp', t)]:.4f} ms",
                   more=more)

        # the three one-launch fold kernels: at the batched decode's shape
        # (B 8, MHA, KVD 512; a uniform t, the whole cache and the ragged
        # lengths), and at the engine's GQA-2 shape above (kvc, with its
        # free slot); timed at t 300 and 510 (bench) and at the ragged
        # lengths (GQA-2). The cluster kernels run with the cluster size
        # the card picks for the shape (decode_fold.cluster_size) and are
        # checked and timed with the other size as well, which other shapes
        # take. At a uniform t the library call reads the slice 0..t; the
        # masked call over the whole cache is timed beside it
        whole = {name: (decode_fold.ROUNDING[name], getattr(decode_fold, name))
                 for name in CLUSTER_KERNELS}
        # demo_ckpt_b3's heads (FOLD48_SHAPE: Dh 48, MHA, M 256, a t a
        # row), with the cluster size the card picks and the other one;
        # from a generator of its own, so that the inputs of the checks
        # after it stay those of earlier runs
        B48, H48, M48, t48 = FOLD48_SHAPE
        g48 = torch.Generator().manual_seed(48)
        q48 = torch.randn(B48, 1, H48 * 48, generator=g48).to(dt).to(dev)
        kv48 = torch.randn(B48, M48, 2 * H48 * 48, generator=g48).to(dt) \
            .to(dev)
        t48 = torch.tensor(t48, dtype=torch.int32, device=dev)
        want32_48 = decode_fold.decode_attention_pm_plain(
            q48.float(), kv48.float(), t48, H48)
        for name, (norm, fn) in whole.items():
            want = decode_fold.decode_attention_pm_plain(q48, kv48, t48, H48,
                                                         normalize=norm)
            picked = decode_fold.cluster_size(decode_fold.cluster_occupancy(
                H48, H48, M48, 48, norm, dt)[1])
            for C in (picked, 24 - picked):
                got = decode_fold._fold_cluster(name, q48, kv48, t48, H48,
                                                C=C)
                torch.cuda.synchronize()
                where = (f" at Dh 48 (MHA, H {H48}, M {M48}, t "
                         f"{t48.tolist()}), C {C}"
                         + (" (picked)" if C == picked else ""))
                hold(name + "_dh48", dt_name, got, want, extra=where)
                if dt is torch.bfloat16:
                    rel_f32(name, got, want32_48, where=where,
                            tol=CLUSTER_REL_TOL, plain=want)
            if not torch.equal(fn(q48, kv48, t48, H48), decode_fold
                               ._fold_cluster(name, q48, kv48, t48, H48,
                                              C=picked)):
                raise AssertionError(f"{name} at Dh 48: the wrapper's launch "
                                     f"differs from C {picked}'s")
        kvb = randn(Bb, M, 2 * Hb * Dh, dt=dt)
        qfb = randn(Bb, 1, Hb * Dh, dt=dt)
        t_uni = torch.full((Bb,), BENCH_TIMED_T, dtype=torch.int32,
                           device=dev)
        t_last = torch.full((Bb,), BENCH_LAST_T, dtype=torch.int32,
                            device=dev)

        def prefix(q_, kv_, t_):
            """Bytes and flops of the keys 0..t[b] of every row, q and o."""
            keys = int((t_.clamp(max=M - 1) + 1).sum().item())
            return (nbytes(q_, q_, t_) + keys * kv_.shape[2]
                    * kv_.element_size(), 4 * H * keys * Dh)

        def cluster_sizes(tag, hkv, m):
            """{kernel: (C the card picks, resident clusters of 8 and 16)}"""
            out = {}
            for name in CLUSTER_KERNELS:
                occ = decode_fold.cluster_occupancy(H, hkv, m, Dh,
                                                    whole[name][0], dt)
                out[name] = (decode_fold.cluster_size(occ[1]), occ)
                log(f"[cluster] {name}{tag} {dt_name} H {H} Hkv {hkv} M {m}: "
                    f"resident clusters of 8 / 16 blocks {occ[0]} / "
                    f"{occ[1]}: C {out[name][0]}")
            return out

        # a long cache, all of it valid, where a block's shared memory grows
        # past what two blocks of an SM can hold: both cluster sizes
        # checked and timed
        ML = 4096
        long_sizes = cluster_sizes("_long", Hb, ML)
        # from a generator of its own, so that the inputs of the checks
        # after it stay those of earlier runs
        kvl = (torch.randn(Bb, ML, 2 * Hb * Dh,
                           generator=torch.Generator().manual_seed(4096))
               .to(dt).to(dev))
        tl = torch.full((Bb,), ML - 1, dtype=torch.int32, device=dev)
        want32_long = decode_fold.decode_attention_pm_plain(
            qfb.float(), kvl.float(), tl, H) if dt is torch.bfloat16 else None
        fns = {}
        for name in CLUSTER_KERNELS:
            norm = whole[name][0]
            want = decode_fold.decode_attention_pm_plain(qfb, kvl, tl, H,
                                                         normalize=norm)
            for C in (8, 16):
                got = decode_fold._fold_cluster(name, qfb, kvl, tl, H, C=C)
                torch.cuda.synchronize()
                hold(name, dt_name, got, want,
                     extra=f"with C {C} at M {ML}, t {ML - 1}")
                if dt is torch.bfloat16:   # logged, not held: see PERF.md
                    rel_f32(name + "_long", got, want32_long,
                            tol=CLUSTER_REL_TOL,
                            where=f" with C {C} at M {ML}", plain=want,
                            enforce=False)
                fns[(name, C)] = lambda name=name, C=C: decode_fold\
                    ._fold_cluster(name, qfb, kvl, tl, H, C=C)
        ms = time_cold_ms(torch, fns)
        for name in CLUSTER_KERNELS:
            log(f"[cluster] {name}_long {dt_name} M {ML}, t {ML - 1}: C 8 "
                f"{ms[(name, 8)]:.4f} ms, C 16 {ms[(name, 16)]:.4f} ms; the "
                f"card picks C {long_sizes[name][0]}")
        del kvl
        for tag, q_, kv_, ts in (("", qfb, kvb, (t_uni, t_last, tf)),
                                 ("_gqa", qf, kvc, (tf,))):
            hkv = kv_.shape[2] // (2 * Dh)
            picked = cluster_sizes(tag, hkv, M)
            other = {name: 24 - c for name, (c, _) in picked.items()}
            worst = dict.fromkeys(whole, 0.0)
            for t_ in ts:
                want32 = decode_fold.decode_attention_pm_plain(
                    q_.float(), kv_.float(), t_, H)
                if not tag:
                    # the two split kernels, which the batched decode can
                    # select too, at its MHA shape
                    want = decode_fold.decode_attention_pm_plain(q_, kv_, t_,
                                                                 H)
                    for name in ("flash_decode_fold_sp",
                                 "flash_decode_fold3_sp"):
                        got = getattr(decode_fold, name)(q_, kv_, t_, H)
                        torch.cuda.synchronize()
                        hold(name + "_batch", dt_name, got, want,
                             extra=f"q {tuple(q_.shape)}, kv "
                                   f"{tuple(kv_.shape)} MHA, t {t_.tolist()}")
                        if dt is torch.bfloat16:
                            rel_f32(name, got, want32, where=" at the batch "
                                    f"shape, t {t_.tolist()}", plain=want)
                for name, (norm, fn) in whole.items():
                    got = fn(q_, kv_, t_, H)
                    want = decode_fold.decode_attention_pm_plain(
                        q_, kv_, t_, H, normalize=norm)
                    torch.cuda.synchronize()
                    if not torch.isfinite(got.float()).all():
                        raise AssertionError(f"{name}{tag}: not finite")
                    if tag and got[0].abs().max().item() != 0.0:
                        raise AssertionError(f"{name}{tag}: a free slot (t 0 "
                                             "over zeros) must give zeros")
                    worst[name] = max(worst[name], (
                        got.float() - want.float()).abs().max().item())
                    if dt is torch.bfloat16:
                        rel_f32(name, got, want32,
                                where=f"{tag} at t {t_.tolist()}",
                                tol=CLUSTER_REL_TOL, plain=want)
                    qkv = torch.cat([q_, randn(Bb, 1, 64, dt=dt)], dim=-1)
                    if not torch.equal(fn(qkv[..., :H * Dh], kv_, t_, H),
                                       got):
                        raise AssertionError(f"{name}{tag}: strided q "
                                             "differs")
                    alt = decode_fold._fold_cluster(name, q_, kv_, t_, H,
                                                    C=other[name])
                    torch.cuda.synchronize()
                    where = f" with C {other[name]}{tag} at t {t_.tolist()}"
                    hold(name + tag, dt_name, alt, want, extra=where)
                    if dt is torch.bfloat16:
                        rel_f32(name, alt, want32, where=where,
                                tol=CLUSTER_REL_TOL)
                # fold2 must not depend on rows, to the bit
                by_rows = {r: decode_fold.flash_decode_fold2(q_, kv_, t_, H,
                                                             rows=r)
                           for r in (1, 2, 4, 8)}
                bit_equal = all(torch.equal(by_rows[r], by_rows[4])
                                for r in by_rows)
                # row 7 is fold2's function and kernel: the same bits
                fold_equal = torch.equal(
                    decode_fold.flash_decode_fold(q_, kv_, t_, H), by_rows[4])
                log(f"[check] flash_decode_fold2{tag} {dt_name} rows 1, 2, "
                    f"4, 8 at t {t_.tolist()}: bit-equal {bit_equal}; "
                    f"flash_decode_fold bit-equal to it {fold_equal}")
                if not bit_equal:
                    raise AssertionError(f"flash_decode_fold2{tag}: depends "
                                         "on rows")
                if not fold_equal:
                    raise AssertionError(f"flash_decode_fold{tag}: differs "
                                         "from flash_decode_fold2")
            timed = ((BENCH_TIMED_T, t_uni), (BENCH_LAST_T, t_last)) \
                if not tag else (("rows", tf),)
            fns = {}
            for label, t_ in timed:
                keep_ = (torch.arange(M, device=dev)[None, :]
                         <= t_[:, None])[:, None, None, :]
                kh_ = kv_[..., :hkv * Dh].reshape(Bb, M, hkv, Dh).transpose(
                    1, 2).contiguous()
                vh_ = kv_[..., hkv * Dh:].reshape(Bb, M, hkv, Dh).transpose(
                    1, 2).contiguous()
                qh_ = q_.reshape(Bb, H, 1, Dh)
                fns.update({
                    **{(name, label): (lambda fn=fn, t_=t_: fn(q_, kv_, t_, H))
                       for name, (_, fn) in whole.items()},
                    **{(name + "_other_C", label):
                       (lambda name=name, t_=t_: decode_fold._fold_cluster(
                           name, q_, kv_, t_, H, C=other[name]))
                       for name in whole},
                    ("flash_decode_fold_sp", label): lambda t_=t_: decode_fold
                    .flash_decode_fold_sp(q_, kv_, t_, H),
                    ("flash_decode_fold3_sp", label): lambda t_=t_: decode_fold
                    .flash_decode_fold3_sp(q_, kv_, t_, H),
                    ("after", label): lambda t_=t_: decode_fold
                    .decode_attention_pm_plain(q_, kv_, t_, H,
                                               normalize="after"),
                    ("before", label): lambda t_=t_: decode_fold
                    .decode_attention_pm_plain(q_, kv_, t_, H),
                    ("masked", label): lambda k=kh_, v=vh_, m=keep_: F
                    .scaled_dot_product_attention(qh_, k, v, attn_mask=m,
                                                  enable_gqa=True)})
                if label != "rows":
                    fns[("sliced", label)] = \
                        lambda k=kh_, v=vh_, n=label + 1: sdpa(
                            qh_, k[:, :, :n], v[:, :, :n], False)
            ms = time_cold_ms(torch, fns)
            if not tag:
                # rows 8 and 11 at the batched decode's MHA shape, beside
                # the sliced SDPA (rows 5 and 6's records hold theirs)
                for name in ("flash_decode_fold_sp", "flash_decode_fold3_sp"):
                    results[name][dt_name].update({
                        f"mha_ms_t{t_l}": ms[(name, t_l)]
                        for t_l in (BENCH_TIMED_T, BENCH_LAST_T)})
                    results[name][dt_name].update({
                        f"mha_library_ms_t{t_l}": ms[("sliced", t_l)]
                        for t_l in (BENCH_TIMED_T, BENCH_LAST_T)})
                    log(f"[check] {name} {dt_name} at the batch shape (MHA): "
                        + ", ".join(f"t {t_l} {ms[(name, t_l)]:.4f} ms "
                                    f"(sliced SDPA {ms[('sliced', t_l)]:.4f})"
                                    for t_l in (BENCH_TIMED_T, BENCH_LAST_T)))
            # the library yardstick: the sliced call where there is one
            lib = "masked" if tag else "sliced"
            main, t_ = timed[0]
            for name, (norm, _) in whole.items():
                more = {"library_masked_ms": ms[("masked", main)]}
                also = f"; library masked {more['library_masked_ms']:.4f} ms"
                if not tag:
                    b510 = bound_ms(*prefix(q_, kv_, t_last), dt_name)[0]
                    more.update({
                        "ms_t510": ms[(name, BENCH_LAST_T)],
                        "bound_ms_t510": b510,
                        "plain_ms_t510": ms[(norm, BENCH_LAST_T)],
                        "library_ms_t510": ms[(lib, BENCH_LAST_T)],
                        "library_masked_ms_t510": ms[("masked",
                                                      BENCH_LAST_T)]})
                    also += (f"; at t {BENCH_LAST_T}: {more['ms_t510']:.4f} "
                             f"ms (bound {b510:.5f}, plain "
                             f"{more['plain_ms_t510']:.4f}, library "
                             f"{more['library_ms_t510']:.4f}, masked "
                             f"{more['library_masked_ms_t510']:.4f})")
                c, occ = picked[name]
                more.update({"C": c, "resident_clusters_8_16": occ,
                             "other_C": other[name],
                             "other_C_ms": ms[(name + "_other_C", main)]})
                also += (f"; C {c} (resident clusters of 8 / 16: "
                         f"{occ[0]} / {occ[1]}), with C {other[name]}: "
                         f"{more['other_C_ms']:.4f} ms")
                if not tag:
                    more["other_C_ms_t510"] = ms[
                        (name + "_other_C", BENCH_LAST_T)]
                    also += f" (t {BENCH_LAST_T}: " \
                            f"{more['other_C_ms_t510']:.4f})"
                record(name + tag, dt_name, worst[name], ms[(name, main)],
                       ms[(norm, main)], ms[(lib, main)],
                       *prefix(q_, kv_, t_),
                       extra=f"q {tuple(q_.shape)}, kv {tuple(kv_.shape)}, "
                             f"err over t in {[x.tolist() for x in ts]}, "
                             f"timed at t {t_.tolist()}; rows 8 and 11 "
                             f"here: fold_sp "
                             f"{ms[('flash_decode_fold_sp', main)]:.4f} ms, "
                             f"fold3_sp "
                             f"{ms[('flash_decode_fold3_sp', main)]:.4f} ms"
                             + also, more=more)

    # the kernels' largest bf16 error against the f32 plain version beside
    # the plain bf16 version's own on the same draws; K1's, K3's and rows
    # 8 and 11's may not exceed it
    summary = {name: {"kernel_max": max(k for k, _ in v),
                      "plain_bf16_max": max(p for _, p in v), "draws": len(v)}
               for name, v in margins.items()}
    log(json.dumps({"bf16_margins": summary}))
    for name in ("flash_attention", "flash_decode_sp", "flash_decode_fold_sp",
                 "flash_decode_fold3_sp"):
        m = summary[name]
        if not m["kernel_max"] <= m["plain_bf16_max"]:
            raise AssertionError(f"{name} bf16: {m['kernel_max']} of "
                                 "max|want| against the f32 plain version, "
                                 "more than the plain bf16 version's "
                                 f"{m['plain_bf16_max']}")

    return results


def bit_identity(torch, ckpt_params) -> dict:
    """Phase 3, second part: does a row get the same bits alone and inside
    a batch of 8? The engine's contract rests on it for the kernels (they
    must), and it is reported for the library's matrix product (which need
    not: the engine and its detached route therefore share one shape)."""
    import torch.nn.functional as F

    from eamg_tpu_torch.ops import attention, decode_attention, decode_fold, \
        ffn

    dev, dt = "cuda", torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(5)
    B, M, H, Dh, Hkv = ENGINE_SLOTS, 511, 8, 64, 2
    D, KVD = H * Dh, Hkv * Dh
    kv = torch.randn(B, M, 2 * KVD, generator=g).to(dt).to(dev)
    q = torch.randn(B, 1, D, generator=g).to(dt).to(dev)
    t = torch.tensor(FOLD_T, dtype=torch.int32, device=dev)
    out = {}
    folds = ("flash_decode_fold_sp", "flash_decode_fold3_sp", *CLUSTER_KERNELS)
    for name in folds:
        fn = getattr(decode_fold, name)
        if name == "flash_decode_fold2":   # one row alone: rows 1
            fn = functools.partial(fn, rows=1)
        full = fn(q, kv, t, H)
        same = all(torch.equal(fn(q[b:b + 1], kv[b:b + 1], t[b:b + 1], H)[0],
                               full[b]) for b in range(B))
        out[name] = same
    # the scalar-t cluster kernel (rows 5 and 6) at the bench shape, t 300,
    # from a generator of its own
    gs = torch.Generator(device="cpu").manual_seed(300)
    qh, kh, vh = (torch.randn(BENCH_B, BENCH_H, m, Dh, generator=gs).to(dt)
                  .to(dev) for m in (1, M, M))
    scalar_t = SCALAR_T_KERNELS
    t300 = torch.full((1,), BENCH_TIMED_T, dtype=torch.int32, device=dev)
    for name in scalar_t:
        fn = getattr(decode_attention, name)
        full = fn(qh, kh, vh, t300)
        out[name] = all(torch.equal(fn(
            qh[b:b + 1], kh[b:b + 1], vh[b:b + 1], t300)[0], full[b])
            for b in range(BENCH_B))
    # K1 at the flagship's prefill (GQA-2, T 16, causal) with a valid
    # length a row, and K3 over its cache with a t a row, from a generator
    # of their own
    gk = torch.Generator(device="cpu").manual_seed(16)
    qa, ka, va = (torch.randn(B, h, 16, Dh, generator=gk).to(dt).to(dev)
                  for h in (H, Hkv, Hkv))
    vl = torch.tensor((16, 3, 9, 16, 1, 12, 16, 7), dtype=torch.int32,
                      device=dev)
    full = attention.flash_attention(qa, ka, va, vl, causal=True)
    out["flash_attention"] = all(torch.equal(attention.flash_attention(
        qa[b:b + 1], ka[b:b + 1], va[b:b + 1], vl[b:b + 1], causal=True)[0],
        full[b]) for b in range(B))
    qd = torch.randn(B, H, 1, Dh, generator=gk).to(dt).to(dev)
    kd, vd = (torch.randn(B, Hkv, M, Dh, generator=gk).to(dt).to(dev)
              for _ in range(2))
    td = torch.tensor(K3_ROWS_T, dtype=torch.int32, device=dev)
    full = decode_attention.flash_decode_sp(qd, kd, vd, td)
    out["flash_decode_sp"] = all(torch.equal(decode_attention.flash_decode_sp(
        qd[b:b + 1], kd[b:b + 1], vd[b:b + 1], td[b:b + 1])[0], full[b])
        for b in range(B))
    mlp = {n: w.to(dt).to(dev) for n, w in
           ckpt_params["layers"][0]["mlp"].items()}
    x = torch.randn(B, 1, D, generator=g).to(dt).to(dev)
    args = (mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"])
    for order in ffn.ORDER:
        full = ffn.fused_ffn(x, *args, activation="relu", order=order)
        out[f"fused_ffn_{order}"] = all(torch.equal(
            ffn.fused_ffn(x[b:b + 1], *args, activation="relu",
                          order=order)[0], full[b]) for b in range(B))
    attn = ckpt_params["layers"][0]["attn"]
    w, bias = attn["in_w"].to(dt).to(dev), attn["in_b"].to(dt).to(dev)
    full = F.linear(x, w, bias)
    out["library_matmul"] = all(torch.equal(F.linear(x[b:b + 1], w, bias)[0],
                                            full[b]) for b in range(B))
    torch.cuda.synchronize()
    log(f"[bit-identity] bf16, a row alone against the row inside a batch "
        f"of {B}: {out}")
    for name in (*folds, *scalar_t, "flash_attention", "flash_decode_sp",
                 "fused_ffn_xla", "fused_ffn_pallas"):
        if not out[name]:
            raise AssertionError(f"{name}: a row's bits depend on the batch")
    return out


# the phase boundaries that the timed builds stamp (csrc/decode_fold.cu
# and csrc/ffn.cu under EAMG_PHASE_TIMING)
FOLD_STAMPS = ("entry", "t+slab+q", "chunk0", "scores", "max", "p",
               "pv_pushed", "out_barrier", "store")
FFN_STAMPS = ("entry", "issued", "w1x", "h_stored", "grid_barrier",
              "h_staged", "stored")
# csrc/decode_attention.cu (the cluster kernel of K3 and rows 5, 6)
DECODE_STAMPS = ("entry", "barriers", "t_read", "copies_issued", "landed",
                 "scores", "max_exchange", "pv", "pushed", "stored")
# the same file, K3's kernel by head
HEADS_STAMPS = ("entry", "barriers", "t_read", "joined", "copies_issued",
                "landed", "scores", "maxima", "pv", "stored")
# csrc/attention.cu (K1 in bf16)
ATTN_STAMPS = ("entry", "issued", "landed", "keys", "stored")
# K4: where a handful of keys is left under 16 bits of prefix, "pass3" and
# "pass4" mark them gathered and one warp's select of the last 16 bits
TOPK_STAMPS = ("entry", "loaded", "pass1", "pass2", "pass3", "pass4",
               "stored")
STREAM_STAMPS = ("entry", "read", "arrived", "combined")


def _bind_timed(name: str, entry: str, argtypes: list):
    """A timed build's library with its stamp setter and ``entry`` bound."""
    import ctypes

    from eamg_tpu_torch.ops import _build

    lib = _build.library(name)
    for fn, args in (("eamg_set_stamps", [ctypes.c_void_p]),
                     (entry, argtypes)):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _stamped_runs(torch, lib, fn, n_blocks: int, names, khz) -> dict:
    """fn() (a launch of ``lib``'s stamped kernel) replayed cold 30 times
    with the stamps on -> :func:`_phase_table` of them."""
    from eamg_tpu_torch.ops import _build

    n = len(names)
    buf = torch.zeros(n_blocks * n * 2, dtype=torch.int64, device="cuda")
    flush = torch.empty(96 << 18, dtype=torch.float32, device="cuda")
    replay = _graphed(torch, fn)
    _build.check(lib.eamg_set_stamps(buf.data_ptr()), "set stamps")
    runs = []
    try:
        for _ in range(30):
            buf.zero_()
            flush.zero_()
            _hold_device(torch, 1000.0)
            replay()
            torch.cuda.synchronize()
            runs.append(buf.view(n_blocks, n, 2).cpu())
    finally:
        lib.eamg_set_stamps(None)
    return _phase_table(runs, names, khz)


def _phase_table(runs, names, khz) -> dict:
    """Stamps of cold replays [blocks, boundaries, (globaltimer, clock64)]
    -> per phase the median over replays of the median and the largest
    block time (clock64, ns at the card's clock rate), the timeline (ns of
    globaltimer from the first block's entry to the last block past each
    boundary), the span and the entry skew. A boundary a block did not pass
    (a fold block with no key, the chunk loop) takes the stamp before it."""
    med = lambda xs: sorted(xs)[len(xs) // 2]   # noqa: E731
    per = {k: ([], []) for k in names[1:]}
    tl = {k: [] for k in names}
    span, skew = [], []
    for st in runs:
        st = st.clone()
        for i in range(1, len(names)):
            miss = st[:, i, 0] == 0
            st[miss, i] = st[miss, i - 1]
        gt, ck = st[..., 0].double(), st[..., 1].double()
        t0 = gt[:, 0].min()
        for i, k in enumerate(names):
            tl[k].append((gt[:, i].max() - t0).item())
            if i:
                d = (ck[:, i] - ck[:, i - 1]) * 1e6 / khz
                per[k][0].append(d.median().item())
                per[k][1].append(d.max().item())
        span.append((gt[:, -1].max() - t0).item())
        skew.append((gt[:, 0].max() - t0).item())
    return {"block_ns": {k: (med(a), med(b)) for k, (a, b) in per.items()},
            "timeline_ns": {k: med(v) for k, v in tl.items()},
            "span_ns": med(span), "entry_skew_ns": med(skew),
            "replays": len(runs)}


def _log_phases(tag: str, r: dict, khz) -> None:
    log(f"[phases] {tag}: span entry->exit {r['span_ns']:.0f} ns, entry "
        f"skew {r['entry_skew_ns']:.0f} ns; per block, median / max ns "
        f"(clock64 at {khz / 1000:.0f} MHz): " + ", ".join(
            f"{k} {v[0]:.0f}/{v[1]:.0f}" for k, v in r["block_ns"].items()))
    log(f"[phases] {tag}: timeline, ns from the first entry to the last "
        "block past each boundary (globaltimer): " + ", ".join(
            f"{k} {v:.0f}" for k, v in r["timeline_ns"].items()))


def kernel_phases(torch, ckpt_params) -> dict:
    """Phase 3, last part: where the time of the cluster fold kernel (rows
    7, 9, 10), of K2, of the scalar-t cluster kernel (rows 5, 6), of K3,
    of rows 8 and 11 and of K1 goes. The timed builds of their sources stamp
    %globaltimer and clock64 at each phase boundary in thread 0 of every
    block (:func:`_phase_table` reads them, over cold replays). In one cold
    loop beside them: the wrappers' kernels, the stamped kernels, and the
    floor of this way of timing, an empty kernel and empty cluster launches
    of the fold kernel's grid (clusters of 16 and of 8, with 0 and 3
    cluster barriers). The fold kernel at the bench shape (bf16, B 8, MHA
    H 8, M 511, Dh 64, t 300) with the cluster size the card picks; K2 on
    the flagship's layer-0 FFN at rows 1 and 8, bf16, in the served order;
    the scalar-t kernel at the same shape, head-major; K3 at the solo
    decode (B 1, H 8, Hkv 2, M 511, t 300 read on the card), rows 8 and 11
    at the engine's step (8 rows, H 8, Hkv 2, M 511, FOLD_T on the card)
    and K1 at the solo prefill (B 1, H 8, Hkv 2, T 16), each beside empty
    launches of its own grid."""
    import ctypes
    import math

    from eamg_tpu_torch.ops import _build, decode_fold, ffn

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fold_lib = _bind_timed("decode_fold_timed", "eamg_fold_decode_cluster",
                           [P, P, P, P, I, I, I, I, I, I, _build.F, I, I, I,
                            P])
    for fn, args in (("eamg_fold_cluster_smem",
                      [I, I, I, I, I, ctypes.POINTER(L)]),
                     ("eamg_empty_launch", [I, I, L, I, P])):
        getattr(fold_lib, fn).argtypes = args
        getattr(fold_lib, fn).restype = ctypes.c_int
    ffn_lib = _bind_timed("ffn_timed", "eamg_fused_ffn",
                          [P] * 7 + [I] * 8 + [P])
    dev, dt = "cuda", torch.bfloat16
    B, H, M, Dh, t = BENCH_B, BENCH_H, 511, 64, BENCH_TIMED_T
    g = torch.Generator().manual_seed(511)
    kv = torch.randn(B, M, 2 * H * Dh, generator=g).to(dt).to(dev)
    q = torch.randn(B, 1, H * Dh, generator=g).to(dt).to(dev)
    tt = torch.full((B,), t, dtype=torch.int32, device=dev)
    khz = torch.cuda.get_device_properties(0).clock_rate

    def stream():   # at call time: a graph captures on a stream of its own
        return torch.cuda.current_stream().cuda_stream

    out = {"fold_shape": f"bf16 B {B} H {H} M {M} Dh {Dh} t {t}",
           "clock_mhz": khz / 1000}
    fns, stamped = {}, {}
    for name in ("flash_decode_fold2", "flash_decode_fold3"):
        norm = decode_fold.ROUNDING[name]
        C = decode_fold.cluster_size(decode_fold.cluster_occupancy(
            H, H, M, Dh, norm, dt)[1])
        o = torch.empty_like(q)

        def run(norm=norm, C=C, o=o):
            _build.check(fold_lib.eamg_fold_decode_cluster(
                q.data_ptr(), kv.data_ptr(), tt.data_ptr(), o.data_ptr(), B,
                H, H, M, Dh, q.stride(0), 1.0 / math.sqrt(Dh),
                int(norm == "before"), C, 1, stream()),
                "stamped fold kernel")

        run()
        torch.cuda.synchronize()
        if not torch.equal(o, getattr(decode_fold, name)(q, kv, tt, H)):
            raise AssertionError(f"{name}: the stamped build differs")
        fns[name] = lambda name=name: getattr(decode_fold, name)(q, kv, tt, H)
        fns[name + "_stamped"] = run
        stamped[name] = (fold_lib, run, B * C, FOLD_STAMPS)
        out[name] = {"C": C}
    smem = L(0)
    _build.check(fold_lib.eamg_fold_cluster_smem(
        H, H, Dh, -(-M // out["flash_decode_fold2"]["C"]), 1,
        ctypes.byref(smem)), "smem")
    out["fold_smem_bytes"] = smem.value

    def empty(C, rows, barriers):
        def run():
            _build.check(fold_lib.eamg_empty_launch(C, rows, smem.value,
                                                    barriers, stream()),
                         "empty launch")
        return run

    fns["empty_kernel"] = empty(0, 1, 0)
    for C in (16, 8):
        for nb in (0, 3):
            fns[f"empty_cluster{C}_b{nb}"] = empty(C, B * 16 // C, nb)
    mlp = {n: w.to(dt).to(dev) for n, w in
           ckpt_params["layers"][0]["mlp"].items()}
    D, FF = mlp["w2"].shape
    plan = ffn.ffn_plan(D, FF)
    for rows in (1, ENGINE_SLOTS):
        x = torch.randn(rows, D, generator=g).to(dt).to(dev)
        o = torch.empty_like(x)
        hbuf = torch.empty(plan.scratch_per_row * rows, dtype=dt, device=dev)

        def run(x=x, o=o, hbuf=hbuf, rows=rows):
            _build.check(ffn_lib.eamg_fused_ffn(
                x.data_ptr(), mlp["w1"].data_ptr(), mlp["b1"].data_ptr(),
                mlp["w2"].data_ptr(), mlp["b2"].data_ptr(), o.data_ptr(),
                hbuf.data_ptr(), rows, D, FF, plan.panel, 0,
                ffn.ORDER["xla"], 0, 1, stream()), "stamped K2")

        run()
        torch.cuda.synchronize()
        name = f"fused_ffn_rows{rows}"
        if not torch.equal(o, ffn.fused_ffn(x, mlp["w1"], mlp["b1"],
                                            mlp["w2"], mlp["b2"],
                                            order="xla")):
            raise AssertionError(f"{name}: the stamped build differs")
        fns[name] = lambda x=x: ffn.fused_ffn(x, mlp["w1"], mlp["b1"],
                                              mlp["w2"], mlp["b2"],
                                              order="xla")
        fns[name + "_stamped"] = run
        stamped[name] = (ffn_lib, run, len(plan.slices), FFN_STAMPS)
        out[name] = {"blocks": len(plan.slices)}
    # the cluster kernel of rows 5 and 6 at the bench shape, t 300,
    # head-major, with the cluster size the wrapper picks, and of K3 at the
    # solo shape (B 1, H 8, Hkv 2, t 300 on the device), each beside empty
    # launches of its grid (blocks of 256 threads and its shared memory, 0
    # and 2 cluster barriers)
    from eamg_tpu_torch.ops import attention, decode_attention

    st_lib = _bind_timed("decode_attention_timed",
                         "eamg_flash_decode_scalar_t",
                         [P, P, P, P, I, I, I, P, _build.F, I, I, I, P])
    t_dev = torch.full((1,), t, dtype=torch.int32, device=dev)
    for fn, args in (("eamg_decode_cluster_smem",
                      [I, I, I, I, I, I, ctypes.POINTER(L)]),
                     ("eamg_decode_heads_smem",
                      [I, I, I, ctypes.POINTER(L)]),
                     ("eamg_flash_decode_sp",
                      [P, P, P, P, P, I, I, I, I, I, _build.F, I, I, I,
                       P])):
        getattr(st_lib, fn).argtypes = args
        getattr(st_lib, fn).restype = ctypes.c_int

    def cluster_smem(g_, bk, C):
        n = L(0)
        _build.check(st_lib.eamg_decode_cluster_smem(M, Dh, g_, bk, C, 1,
                                                     ctypes.byref(n)), "smem")
        return n.value

    qh = torch.randn(B, H, 1, Dh, generator=g).to(dt).to(dev)
    kh = torch.randn(B, H, M, Dh, generator=g).to(dt).to(dev)
    vh = torch.randn(B, H, M, Dh, generator=g).to(dt).to(dev)
    C_st = decode_attention.cluster_size(M, 1, lambda: 0)
    st_smem = cluster_smem(1, decode_attention.BLOCK_K["flash_decode"], C_st)
    out["scalar_t_shape"] = f"bf16 B {B} H {H} M {M} Dh {Dh} t {t} " \
                            "(head-major)"
    out["scalar_t_C"] = C_st
    out["scalar_t_smem_bytes"] = st_smem
    for name in SCALAR_T_KERNELS:
        blocked = int(decode_attention.BLOCK_K[name] > 0)
        o = torch.empty_like(qh)

        def run(blocked=blocked, o=o):
            _build.check(st_lib.eamg_flash_decode_scalar_t(
                qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), o.data_ptr(),
                B * H, M, Dh, t_dev.data_ptr(), 1.0 / math.sqrt(Dh), blocked,
                C_st, 1, stream()), "stamped scalar-t kernel")

        run()
        torch.cuda.synchronize()
        if not torch.equal(o, getattr(decode_attention, name)(qh, kh, vh,
                                                              t_dev)):
            raise AssertionError(f"{name}: the stamped build differs")
        fns[name] = lambda name=name: getattr(decode_attention, name)(
            qh, kh, vh, t_dev)
        fns[name + "_stamped"] = run
        stamped[name] = (st_lib, run, B * H * C_st, DECODE_STAMPS)
        out[name] = {"C": C_st}
    for nb in (0, 2):
        fns[f"empty_cluster{C_st}_scalar_t_b{nb}"] = (
            lambda nb=nb: _build.check(fold_lib.eamg_empty_launch(
                C_st, B * H, st_smem, nb, stream()), "empty launch"))
    # K3 at the solo shape
    Hs, Hkvs = 8, 2
    qs = torch.randn(1, Hs, 1, Dh, generator=g).to(dt).to(dev)
    ks, vs = (torch.randn(1, Hkvs, M, Dh, generator=g).to(dt).to(dev)
              for _ in range(2))
    ts = torch.full((1,), t, dtype=torch.int32, device=dev)
    by_head, C_sp = decode_attention.sp_plan(M, Dh, Hs // Hkvs, 2,
                                             lambda: 0)
    if by_head:
        n_sp = L(0)
        _build.check(st_lib.eamg_decode_heads_smem(M, Dh, 1,
                                                   ctypes.byref(n_sp)),
                     "smem")
        sp_smem = n_sp.value
    else:
        sp_smem = cluster_smem(Hs // Hkvs, decode_attention.BLOCK_K[
            "flash_decode_sp"], C_sp)
    o_sp = torch.empty_like(qs)

    def run_sp():
        _build.check(st_lib.eamg_flash_decode_sp(
            qs.data_ptr(), ks.data_ptr(), vs.data_ptr(), ts.data_ptr(),
            o_sp.data_ptr(), 1, Hs, Hkvs, M, Dh, 1.0 / math.sqrt(Dh),
            int(by_head), C_sp, 1, stream()), "stamped K3")

    run_sp()
    torch.cuda.synchronize()
    if not torch.equal(o_sp, decode_attention.flash_decode_sp(qs, ks, vs,
                                                              ts)):
        raise AssertionError("flash_decode_sp: the stamped build differs")
    fns["flash_decode_sp"] = lambda: decode_attention.flash_decode_sp(
        qs, ks, vs, ts)
    fns["flash_decode_sp_stamped"] = run_sp
    stamped["flash_decode_sp"] = (st_lib, run_sp, Hkvs * C_sp,
                                  HEADS_STAMPS if by_head else DECODE_STAMPS)
    out["flash_decode_sp"] = {"C": C_sp, "by_head": by_head,
                              "smem_bytes": sp_smem,
                              "shape": f"bf16 B 1 H {Hs} Hkv {Hkvs} M {M} "
                                       f"Dh {Dh} t {t} (t [B] on the card)"}
    for nb in (0, 2):
        fns[f"empty_cluster{C_sp}_sp_b{nb}"] = (
            lambda nb=nb: _build.check(fold_lib.eamg_empty_launch(
                C_sp, Hkvs, sp_smem, nb, stream()), "empty launch"))
    # rows 8 and 11 (one kernel) at the engine's step: bf16, 8 rows over the
    # fused cache, H 8, Hkv 2, M 511, t FOLD_T on the card, with the plan
    # the wrappers pick, beside the empty launch of its grid
    fold_lib.eamg_fold_decode_sp.argtypes = [P, P, P, P, I, I, I, I, I, I,
                                             _build.F, I, I, I, I, P]
    fold_lib.eamg_fold_decode_sp.restype = ctypes.c_int
    Be = ENGINE_SLOTS
    qe = torch.randn(Be, 1, Hs * Dh, generator=g).to(dt).to(dev)
    kve = torch.randn(Be, M, 2 * Hkvs * Dh, generator=g).to(dt).to(dev)
    te = torch.tensor(FOLD_T, dtype=torch.int32, device=dev)
    by_head_e, C_e = decode_fold.sp_plan(M, Dh, Hs // Hkvs, dt)
    e_smem = (decode_attention.heads_smem(M, Dh, 2, decode_fold.SP_BOX)
              if by_head_e else cluster_smem(Hs // Hkvs, 128, C_e))
    o_e = torch.empty_like(qe)

    def run_fold_sp():
        _build.check(fold_lib.eamg_fold_decode_sp(
            qe.data_ptr(), kve.data_ptr(), te.data_ptr(), o_e.data_ptr(), Be,
            Hs, Hkvs, M, Dh, qe.stride(0), 1.0 / math.sqrt(Dh),
            decode_fold.SP_BLOCK_K, int(by_head_e), C_e, 1, stream()),
            "stamped rows 8 and 11")

    run_fold_sp()
    torch.cuda.synchronize()
    if not torch.equal(o_e, decode_fold.flash_decode_fold_sp(qe, kve, te, Hs)):
        raise AssertionError("flash_decode_fold_sp: the stamped build differs")
    fns["flash_decode_fold_sp"] = lambda: decode_fold.flash_decode_fold_sp(
        qe, kve, te, Hs)
    fns["flash_decode_fold_sp_stamped"] = run_fold_sp
    stamped["flash_decode_fold_sp"] = (
        fold_lib, run_fold_sp, Be * Hkvs * C_e,
        HEADS_STAMPS if by_head_e else DECODE_STAMPS)
    out["flash_decode_fold_sp"] = {
        "C": C_e, "by_head": by_head_e, "smem_bytes": e_smem,
        "shape": f"bf16 B {Be} H {Hs} Hkv {Hkvs} M {M} Dh {Dh} t {FOLD_T} "
                 "(fused cache, t [B] on the card)"}
    for nb in (0, 2):
        fns[f"empty_cluster{C_e}_fold_sp_b{nb}"] = (
            lambda nb=nb: _build.check(fold_lib.eamg_empty_launch(
                C_e, Be * Hkvs, e_smem, nb, stream()), "empty launch"))
    # K1 at the solo prefill (bf16, B 1, H 8, Hkv 2, T 16, Dh 64, causal),
    # beside an empty launch of its grid
    at_lib = _bind_timed("attention_timed", "eamg_attention_fwd",
                         [P, P, P, P, P, I, I, I, I, I, I, _build.F, I, I,
                          P])
    at_lib.eamg_attention_empty.argtypes = [I, I, I, I, I, I, P]
    at_lib.eamg_attention_empty.restype = ctypes.c_int
    Ta = 16
    qa = torch.randn(1, Hs, Ta, Dh, generator=g).to(dt).to(dev)
    ka, va = (torch.randn(1, Hkvs, Ta, Dh, generator=g).to(dt).to(dev)
              for _ in range(2))
    vla = torch.full((1,), Ta, dtype=torch.int32, device=dev)
    Wa = attention.WARPS
    o_a = torch.empty_like(qa)

    def run_attn():
        _build.check(at_lib.eamg_attention_fwd(
            qa.data_ptr(), ka.data_ptr(), va.data_ptr(), o_a.data_ptr(),
            vla.data_ptr(), 1, Hs, Hkvs, Ta, Dh, 1, 1.0 / math.sqrt(Dh), Wa,
            1, stream()), "stamped K1")

    run_attn()
    torch.cuda.synchronize()
    if not torch.equal(o_a, attention.flash_attention(qa, ka, va, vla,
                                                      causal=True)):
        raise AssertionError("flash_attention: the stamped build differs")
    n_attn = -(-(Hs // Hkvs) * Ta // (16 * Wa)) * Hkvs
    fns["flash_attention"] = lambda: attention.flash_attention(
        qa, ka, va, vla, causal=True)
    fns["flash_attention_stamped"] = run_attn
    fns["empty_attention_grid"] = lambda: _build.check(
        at_lib.eamg_attention_empty(1, Hs, Hkvs, Ta, Dh, Wa, stream()),
        "empty launch")
    stamped["flash_attention"] = (at_lib, run_attn, n_attn, ATTN_STAMPS)
    out["flash_attention"] = {"warps": Wa, "blocks": n_attn,
                              "shape": f"bf16 B 1 H {Hs} Hkv {Hkvs} T {Ta} "
                                       f"Dh {Dh} causal"}
    # K4's fused mask as the sampler launches it, at the solo step and the
    # engine's (f32 [1 or 8, 8892], k 50), beside empty launches of its
    # grid; the stream-reduce probe over the engine's cache (bf16 [8, 511,
    # 256]) and past the L2 ([64, 511, 1024]), with the grid it plans
    from eamg_tpu_torch.ops import topk

    tk_lib = _bind_timed("topk_timed", "eamg_top_k_mask",
                         [P, P, I, I, I, _build.F, P])
    tk_lib.eamg_topk_empty.argtypes = [I, I, P]
    for nb in (1, ENGINE_SLOTS):
        x = (torch.randn(nb, 8892, generator=g) * 3).to(dev)
        o = torch.empty_like(x)

        def run(x=x, o=o, nb=nb):
            _build.check(tk_lib.eamg_top_k_mask(
                x.data_ptr(), o.data_ptr(), nb, x.shape[1], 50, -1e10,
                stream()), "stamped K4")

        run()
        torch.cuda.synchronize()
        name = f"top_k_mask_b{nb}"
        if not torch.equal(o, topk.top_k_mask(x, 50)):
            raise AssertionError(f"{name}: the stamped build differs")
        fns[name] = lambda x=x: topk.top_k_mask(x, 50)
        fns[name + "_stamped"] = run
        fns[f"empty_topk_b{nb}"] = lambda nb=nb: _build.check(
            tk_lib.eamg_topk_empty(nb, 8892, stream()),
            "empty launch")
        stamped[name] = (tk_lib, run, nb, TOPK_STAMPS)
        out[name] = {"shape": f"f32 [{nb}, 8892] k 50"}
    sr_lib = _bind_timed("stream_reduce_timed", "eamg_stream_reduce",
                         [P, P, P, P, I, I, I, I, P])
    sr_lib.eamg_stream_reduce_plan.argtypes = [P, I, I, I, I,
                                               ctypes.POINTER(I),
                                               ctypes.POINTER(I)]
    for shape in ((ENGINE_SLOTS, M, 2 * 2 * Dh), (64, M, 2 * H * Dh)):
        kvx = torch.randn(*shape, generator=g).to(dt).to(dev)
        ox = torch.empty((1, shape[2]), dtype=dt, device=dev)
        groups, lines, W = shape[0] // 4, 4 * shape[1], shape[2]
        part, arrived = decode_fold._stream_scratch(kvx.device, groups,
                                                    lines, W)
        grid, rs = I(0), I(0)
        _build.check(sr_lib.eamg_stream_reduce_plan(
            kvx.data_ptr(), groups, lines, W, _build.DTYPE_CODE[dt],
            ctypes.byref(grid), ctypes.byref(rs)), "stream plan")

        def run(kvx=kvx, ox=ox, part=part, arrived=arrived, groups=groups,
                lines=lines, W=W):
            _build.check(sr_lib.eamg_stream_reduce(
                kvx.data_ptr(), ox.data_ptr(), part.data_ptr(),
                arrived.data_ptr(), groups, lines, W, _build.DTYPE_CODE[dt],
                stream()), "stamped stream_reduce")

        run()
        torch.cuda.synchronize()
        name = f"stream_reduce_{'x'.join(map(str, shape))}"
        if not torch.equal(ox, decode_fold.stream_reduce(kvx, 4)):
            raise AssertionError(f"{name}: the stamped build differs")
        fns[name] = lambda kvx=kvx: decode_fold.stream_reduce(kvx, 4)
        fns[name + "_stamped"] = run
        stamped[name] = (sr_lib, run, grid.value, STREAM_STAMPS)
        out[name] = {"shape": f"bf16 {list(shape)} rows 4",
                     "blocks": grid.value, "lines_a_unit": rs.value}
    out["event_ms"] = time_cold_ms(torch, fns)
    for name, (lib, run, n_blocks, names) in stamped.items():
        out[name].update(_stamped_runs(torch, lib, run, n_blocks, names, khz))
        _log_phases(f"{name} {out[name]}: event ms "
                    f"{out['event_ms'][name]:.4f} (stamped "
                    f"{out['event_ms'][name + '_stamped']:.4f})", out[name],
                    khz)
    log("[phases] floors, cold event ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out["event_ms"].items()
        if k.startswith("empty")) + f" (cluster blocks of {smem.value} "
        "bytes of shared memory, the fold kernel's; the scalar_t ones of "
        f"{st_smem} bytes, rows 5 and 6's; the sp ones of {sp_smem} bytes, "
        f"K3's; the fold_sp ones of {e_smem} bytes, rows 8 and 11's; 256 "
        "threads a block; the attention grid K1's; the topk ones K4's)")
    log(json.dumps({"kernel_phases": out}))
    return out


def teacher_forced(torch, ckpt) -> float:
    """Phase 4: f32 logits over a prompt + 64 forced tokens, card vs host,
    through the solo decode and through the ragged decode (batch of 3 with
    prompts of other lengths beside it); then the checkpoint as served, in
    bf16 with its kernels="xla" rounding, through the solo decode, card vs
    host (the plain versions there, which are JAX's XLA model)."""
    from eamg_tpu_torch.decode import ragged
    from eamg_tpu_torch.decode.api import _to_device
    from eamg_tpu_torch.models.gpt import decode_step, init_kv_cache, \
        prefill

    cfg = dataclasses.replace(ckpt["cfg"], dtype="float32")
    vocab = ckpt["vocab"]
    prompt = [vocab[t] for t in ("[START_SEQUENCE]", "[BPM] 120.0",
                                 "[KEY_SIGNATURE] C major",
                                 "[INSTRUMENT] Acoustic Grand Piano")]
    g = torch.Generator().manual_seed(1)
    forced = torch.randint(0, cfg.vocab_size, (64,), generator=g).tolist()
    P = 16
    ids = torch.zeros((1, P), dtype=torch.int64)
    ids[0, :len(prompt)] = torch.tensor(prompt)
    ids3 = torch.randint(0, cfg.vocab_size, (3, P), generator=g)
    ids3[1] = ids[0]
    lens3 = torch.tensor([9, len(prompt), 16], dtype=torch.int32)

    def run_solo(device, cfg=cfg):
        params = _to_device(ckpt["params"], device)
        cache = init_kv_cache(cfg, 1, 511, device=device)
        logits0, cache = prefill(params, ids.to(device), cfg, cache,
                                 prompt_len=len(prompt))
        outs = [logits0[0, :len(prompt)]]
        last = prompt[-1]
        for tok in forced:
            lg, cache = decode_step(params, torch.tensor([[last]],
                                                         device=device),
                                    cache, cfg)
            outs.append(lg)
            last = tok
        return torch.cat(outs).float().cpu()

    def run_ragged(device):
        params = _to_device(ckpt["params"], device)
        cache = ragged.init_ragged_cache(cfg, 3, 511, device=device)
        logits0, cache = ragged.prefill_ragged(
            params, ids3.to(device), lens3.to(device), cfg, cache)
        outs = [logits0[1, :len(prompt)]]
        last = ids3[torch.arange(3), (lens3 - 1).long()].to(device)
        for tok in forced:
            lg, cache = ragged.decode_step_ragged(params, last, cache, cfg)
            outs.append(lg[1:2])
            last = torch.full_like(last, tok)
        return torch.cat(outs).float().cpu()

    worst = 0.0
    for name, run in (("solo", run_solo), ("ragged", run_ragged)):
        a, b = run("cuda"), run("cpu")
        delta = (a - b).abs().max().item()
        log(f"[teacher-forced] demo_ckpt_a f32 {name} decode, prompt "
            f"{len(prompt)} + 64 forced tokens: max|logits(card) - "
            f"logits(host)| {delta:.3e} (tol {TF_TOL:.0e}, max|logit| "
            f"{b.abs().max().item():.2f})")
        if not delta <= TF_TOL:
            raise AssertionError(f"teacher-forced {name} delta {delta} > "
                                 f"{TF_TOL}")
        worst = max(worst, delta)
    cfg16 = ckpt["cfg"]
    a, b = run_solo("cuda", cfg16), run_solo("cpu", cfg16)
    delta = (a - b).abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"[teacher-forced] demo_ckpt_a {cfg16.dtype}, kernels "
        f"{cfg16.kernels!r}, solo decode, prompt {len(prompt)} + 64 forced "
        f"tokens: max|logits(card) - logits(host)| {delta:.3e} (tol "
        f"{BF16_TF_TOL}), mean {(a - b).abs().mean().item():.3e}, argmax "
        f"equal at {agree:.3f} of {a.shape[0]} positions (at least "
        f"{BF16_ARGMAX_MIN}), max|logit| {b.abs().max().item():.2f}")
    if cfg16.dtype != "bfloat16" or cfg16.kernels != "xla":
        raise AssertionError(f"demo_ckpt_a is {cfg16.dtype} {cfg16.kernels}")
    if not (delta <= BF16_TF_TOL and agree >= BF16_ARGMAX_MIN):
        raise AssertionError(f"teacher-forced bf16: delta {delta}, argmax "
                             f"agreement {agree}")
    return worst


def _multipart(fields: dict) -> tuple:
    """A form as the page posts it: -> (body, its Content-Type)."""
    boundary = "eamgsmokeboundary"
    body = b"".join(
        f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"'
        f"\r\n\r\n{v}\r\n".encode() for k, v in fields.items())
    body += f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _post(port: int, fields: dict, query: str = ""):
    body, ctype = _multipart(fields)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate{query}", data=body,
        headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        data = r.read()
        return r.status, data, dict(r.headers), time.perf_counter() - t0


def _check_reply(tag, fields, query, reply) -> int:
    """Log one reply and hold it to the contract; returns its token count."""
    status, data, headers, secs = reply
    timings = json.loads(headers.get("X-EAMG-Timings", "{}"))
    n_tok = int(headers.get("X-EAMG-Tokens", "0"))
    dec_s = timings.get("decode", 0.0) / 1000
    log(f"[{tag}] {query or 'wav'} seed {fields['seed']}: HTTP "
        f"{status}, {len(data)} bytes, {secs * 1000:.1f} ms, "
        f"emotion {headers.get('X-EAMG-Emotion')}, {n_tok} tokens "
        f"(prompt included), {n_tok / dec_s if dec_s else 0:.1f} "
        f"tokens/s of decode, timings_ms {timings}")
    if status != 200:
        raise AssertionError(f"HTTP {status}")
    if query:
        if data[:4] != b"MThd":
            raise AssertionError("MIDI reply does not start MThd")
    elif data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AssertionError("WAV reply is not RIFF....WAVE")
    return n_tok


def _serving(pipe):
    """(server, thread, port) for a pipeline on a free local port."""
    from eamg_tpu_torch.serve import make_server, serve_forever_in_thread

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = make_server(pipe, "127.0.0.1", port)
    return server, serve_forever_in_thread(server), port


def _require_xla_order(path: str, pipe) -> None:
    """The served model rounds its FFN as JAX serves it (K2's "xla" order,
    which models/gpt.py::_mlp passes on from the checkpoint)."""
    cfg = pipe.generator.cfg
    log(f"[{path}] served model: {cfg.dtype}, kernels {cfg.kernels!r}: K2 "
        f"in the {cfg.kernels!r} rounding order")
    if cfg.kernels != "xla":
        raise AssertionError(f"{path}: the served model has kernels "
                             f"{cfg.kernels!r}")


def launched(name: str, counts: dict) -> int:
    """Launches of kernel ``name`` in ``counts`` (by wrapper): those of all
    its wrappers (:data:`KERNEL_WRAPPERS`)."""
    return sum(counts.get(w, 0) for w in KERNEL_WRAPPERS.get(name, (name,)))


def _device_kernels(torch, fn) -> list:
    """fn() once under torch.profiler -> the names of the device kernels it
    ran, in the order the card started them."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _kernel_order(prof)


def _records(prof) -> tuple:
    """A torch.profiler session's raw records, read in one pass: (the
    host's calls, a count by name; the device's activities as (name,
    start ns, duration ns) in the order the card started them, user
    annotations left out). ``prof.events()`` and ``key_averages()`` would
    build a tree of Python objects over the same records first, which
    took most of the script's trace seconds."""
    host, device = collections.Counter(), []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type().name
        if kind == "CPU":
            host[e.name()] += 1
        elif kind == "CUDA" and not e.is_user_annotation():
            device.append((e.name(), e.start_ns(), e.duration_ns()))
    device.sort(key=lambda r: r[1])
    return host, device


def _kernel_order(prof) -> list:
    """The device kernels of a torch.profiler session, in the order the
    card started them (one stream)."""
    return [name for name, _, _ in _records(prof)[1]]


# the sampler's three ops after a top-k threshold, by the names of
# PyTorch's kernels for them: logits >= t (a compare), the where of two
# scalars (the scalars filled, then the where), the add
SAMPLER_OPS = ("CompareFunctor<float>", "FillFunctor<float>", "where_kernel",
               "CUDAFunctor_add<float>")


def _is_sampler_ops(names) -> bool:
    """Whether ``names`` (kernels in start order) are one run of the three
    ops: a compare first, the add last, a where and fills between."""
    return (len(names) >= 3 and SAMPLER_OPS[0] in names[0]
            and SAMPLER_OPS[3] in names[-1]
            and any(SAMPLER_OPS[2] in n for n in names[1:-1])
            and all(SAMPLER_OPS[1] in n or SAMPLER_OPS[2] in n
                    for n in names[1:-1]))


def _require_launched(path: str, counts: dict) -> None:
    from eamg_tpu_torch.ops import decode_fold

    for n in PATH_KERNELS[path]:
        if n == "fold_decode":
            n = decode_fold.fold_decode.__name__
        if counts.get(n, 0) <= 0:
            raise AssertionError(f"{n} was not launched on the {path} path")


def serve_solo(torch):
    """Phase 5: POST /generate x3 on demo_ckpt_a, bf16, on the card, one
    request at a time through the solo decode."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve import shutdown_gracefully

    from eamg_tpu_torch.decode import graphs

    pipe = cli.pipeline_from_args(cli.parse_args(["serve"]))
    _require_xla_order("solo", pipe)
    capture_solo_global(torch, pipe)
    server, thread, port = _serving(pipe)
    try:
        _build.reset_launch_counts()
        replays0 = graphs.tally()["replays"]
        reqs = [({"prompt": "I finally got the job, I am so happy!",
                  "seed": "7"}, ""),
                ({"prompt": "I finally got the job, I am so happy!",
                  "seed": "7"}, ""),
                ({"prompt": "The rain will not stop and I miss you.",
                  "seed": "11"}, "?format=midi")]
        bodies = []
        for fields, query in reqs:
            reply = _post(port, fields, query)
            _check_reply("solo", fields, query, reply)
            bodies.append(reply[1])
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        replayed = _build.replayed_counts()
        replays = graphs.tally()["replays"] - replays0
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    if bodies[0] != bodies[1]:
        raise AssertionError("same-seed WAV bytes differ")
    log("[solo] same-seed WAV bytes identical; launches over the three "
        f"requests: {counts}")
    _require_launched("solo", counts)
    _require_graphs("solo", "flash_decode_sp", counts, replayed, replays)
    eager = _eager_replies(["serve"], lambda port: _post(
        port, reqs[0][0], reqs[0][1])[1])
    if eager != bodies[0]:
        raise AssertionError("solo: the WAV of seed 7 from the eager loop "
                             "differs from the graphs'")
    log("[solo] the WAV of seed 7 decoded by the eager loop (every step "
        "issued from the host) has the graphs' bytes")
    return counts, pipe


def _eager_replies(args: list, work):
    """work(port) against the server of ``serve`` with ``args`` whose
    decode issues every step from the host (``eager=True``, which no
    served path passes), in place of replaying graphs."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.serve import shutdown_gracefully
    from eamg_tpu_torch.serve.pipeline import (DEMO_CKPT_A,
                                               pipeline_from_checkpoint)

    a = cli.parse_args(args)
    pipe = pipeline_from_checkpoint(
        a.checkpoint or DEMO_CKPT_A, full_gm=a.full_gm, device=a.device,
        coalesce=a.coalesce, coalesce_opts=cli.coalesce_opts_from_args(a),
        fast_routing=a.fast_routing, eager=True)
    if a.coalesce:
        pipe.warmup()
    server, thread, port = _serving(pipe)
    try:
        return work(port)
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)


def _port_kernel_names() -> tuple:
    """The name of every __global__ kernel in the port's CUDA sources, so
    that the profiler's "port kernels" group follows the sources and no
    kernel of the port falls into "other"."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                     r"\s+)?(\w+)\s*\(")
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "eamg_tpu_torch", "csrc")
    names = {n for f in sorted(os.listdir(csrc)) if f.endswith((".cu", ".cuh"))
             for n in pat.findall(open(os.path.join(csrc, f)).read())}
    if not names:
        raise AssertionError(f"no __global__ kernel found under {csrc}")
    return tuple(sorted(names))


def _trace(torch, tag: str, work) -> dict:
    """Run work() under torch.profiler. Device busy time is the sum of
    kernel times (one stream, so they do not overlap); the idle share is
    the rest of the wall time. work() returns the number of tokens made."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from eamg_tpu_torch.decode import graphs

    tally0 = graphs.tally()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n_tokens = work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    replays = graphs.tally()["replays"] - tally0["replays"]
    calls, device = _records(prof)
    # the host's launch calls: kernels issued one by one, and graphs
    host = collections.Counter({k: n for k, n in calls.items()
                                if k.startswith(HOST_LAUNCH_APIS)})
    # by kernel: device ms and launches
    by_name = collections.defaultdict(lambda: [0, 0])
    for name, _, ns in device:
        by_name[name][0] += ns
        by_name[name][1] += 1
    rows = sorted(((k, ns / 1e6, n) for k, (ns, n) in by_name.items()
                   if ns > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    groups = {"port kernels": _port_kernel_names(),
              "gemm": ("gemm", "xmma", "cutlass", "cublas", "nvjet")}
    by_group = {g: 0.0 for g in (*groups, "other")}
    for key, ms, _ in rows:
        g = next((g for g, pats in groups.items()
                  if any(p in key.lower() for p in pats)), "other")
        by_group[g] += ms
    launches = sum(r[2] for r in rows)
    # the five kernels the card ran after each K4 launch (one run of the
    # sampler's three ops is five), and how often each of those ops ran
    order = [name for name, _, _ in device]
    after_k4 = collections.Counter(
        tuple(order[i + 1:i + 6]) for i, name in enumerate(order)
        if any(n in name for n in K4_KERNELS))
    out = {"path": tag, "wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall_ms, "n_tokens": n_tokens,
           "tokens_per_s": n_tokens / wall_ms * 1000,
           "launches": launches,
           "launches_per_token": launches / max(n_tokens, 1),
           "host_launches": sum(host.values()),
           "host_launches_per_token": sum(host.values()) / max(n_tokens, 1),
           "host_launches_by_api": dict(host), "graph_replays": replays,
           "device_ms_by_group": by_group,
           "top": [{"kernel": k[:90], "ms": ms, "count": c}
                   for k, ms, c in rows[:12]],
           "count_by_kernel": {k[:90]: c for k, _, c in rows},
           "ms_by_kernel": {k[:90]: ms for k, ms, _ in rows},
           "after_k4": [[[n[:90] for n in names], c]
                        for names, c in after_k4.most_common(3)],
           "k4_then_sampler_ops": sum(c for names, c in after_k4.items()
                                      if _is_sampler_ops(names)),
           "sampler_op_kernels": {p: sum(c for k, _, c in rows if p in k)
                                  for p in SAMPLER_OPS}}
    if not busy > 0:
        raise AssertionError("the trace shows no device time")
    log(json.dumps({"profile": out}))
    log(f"[{tag}] traced: {n_tokens} tokens in {wall_ms:.1f} ms, device "
        f"busy {busy:.1f} ms, idle {100 * out['idle_share']:.2f}%; device "
        f"kernels a token {out['launches_per_token']:.2f}, host launch "
        f"calls a token {out['host_launches_per_token']:.3f} "
        f"({dict(host)}), graph replays {replays}")
    return out


# the runtime calls a launch from the host makes: a kernel's (three
# forms) or a graph's
HOST_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelEx",
                    "cudaLaunchCooperativeKernel", "cudaGraphLaunch")


def _require_graphs(path: str, decode_kernel: str, counts: dict,
                    replayed: dict, replays: int) -> None:
    """A served path decoded by replaying graphs: at least one replay, and
    its decode attention kernel launched by replays only (none issued a
    step at a time from Python)."""
    python = {k: n - replayed.get(k, 0) for k, n in counts.items()}
    log(f"[{path}] graph replays {replays}; launches from replays "
        f"{replayed}; issued from Python {python}")
    if replays <= 0 or replayed.get(decode_kernel, 0) <= 0 \
            or python.get(decode_kernel, 0) != 0:
        raise AssertionError(f"{path}: {replays} replays, {decode_kernel} "
                             f"{replayed.get(decode_kernel, 0)} from "
                             f"replays, {python.get(decode_kernel, 0)} from "
                             "Python")


def capture_solo_global(torch, pipe) -> None:
    """Capture the solo path's graph in "global" mode before the server
    starts, at the key a served request uses (B 1, the served max_len,
    attn_impl sp, top-k 50, the checkpoint's EOS, no filter), so that the
    requests replay it: a host sync left in a step, from any thread, would
    fail the capture."""
    import numpy as np

    from eamg_tpu_torch.decode import graphs
    from eamg_tpu_torch.decode.api import _bucket
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.utils import prng

    gen = pipe.generator
    ids = gen.vocab.encode(["[START_SEQUENCE]"])
    max_len = min(gen.cfg.seq_len, gen.max_supported_len())
    prompt = np.full((1, min(_bucket(len(ids)), max_len)), gen.pad_id,
                     np.int64)
    prompt[0, :len(ids)] = ids
    before = graphs.tally()
    t0 = time.perf_counter()
    generate_kv(gen.params, torch.from_numpy(prompt).to(gen.device),
                len(ids), prng.PRNGKey(0), gen.cfg, max_len,
                eos_id=gen.eos_id, pad_id=gen.pad_id,
                capture_error_mode="global")
    torch.cuda.synchronize()
    after = graphs.tally()
    log(f"[solo] graph captured in global mode before serving, with its "
        f"warm-up block and a generation, in "
        f"{1000 * (time.perf_counter() - t0):.1f} ms; {after}")
    if after["global_captures"] != before["global_captures"] + 1:
        raise AssertionError("the solo graph was not captured in global "
                             f"mode: {before} -> {after}")


K4_KERNELS = ("topk_reg_kernel", "topk_stream_kernel")
# launches a token in the traces when the sampler ran K4's threshold and the
# three ops after it (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 5)
LAUNCHES_A_TOKEN_UNFUSED = {"solo": 150.65, "coalesce": 59.16}


def _k4_kernels(prof: dict) -> int:
    """K4's kernel launches in a trace."""
    return sum(c for k, c in prof["count_by_kernel"].items()
               if any(n in k for n in K4_KERNELS))


def _k3_kernels(prof: dict) -> int:
    """The launches in a trace of the kernel that K3's wrapper (solo) and
    the engine's fold wrapper launch: by head at the served shape, else
    over spans."""
    return sum(c for k, c in prof["count_by_kernel"].items()
               if "decode_heads_kernel" in k or "decode_cluster_kernel" in k)


# runs of a traced workload that may be taken before its trace holds every
# launch its wrappers counted (_trace_counted)
TRACE_ATTEMPTS = 3


def _trace_counted(torch, tag: str, work, pairs) -> tuple:
    """_trace(work) and the launch counts of the same run, where
    pairs(prof, counts) -> {kernel: (its wrappers' calls, its launches in
    the trace)} must agree for every kernel. The counts are exact, and the
    same in every run of work(). The trace is not always whole: the
    profiler can lose device records (one run of the coalesce burst on an
    NVIDIA H100 80GB HBM3, 700 W, held 2296 of the 2314 K4 launches that
    every other run held). So a trace with fewer launches than calls is
    taken again, up to TRACE_ATTEMPTS runs of work(); more launches than
    calls fails at once, and fewer in every attempt fails at the end: a
    wrapper that counts a launch it does not make is short every time.
    -> (the whole trace, its counts)."""
    from eamg_tpu_torch.ops import _build

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        prof = _trace(torch, tag, work)
        counts = _build.launch_counts()
        off = {k: v for k, v in pairs(prof, counts).items() if v[0] != v[1]}
        if not off:
            log(f"[{tag}] the trace holds every counted launch (attempt "
                f"{attempt} of {TRACE_ATTEMPTS})")
            return prof, counts
        if any(kernels > calls for calls, kernels in off.values()):
            raise AssertionError(f"{tag} trace: more kernel launches than "
                                 f"wrapper calls (calls, launches): {off}")
        log(f"[{tag}] trace attempt {attempt} of {TRACE_ATTEMPTS}: fewer "
            f"kernel launches than wrapper calls (calls, launches) {off}, "
            f"{prof['launches_per_token']:.2f} device kernels a token")
    raise AssertionError(f"{tag} trace: fewer kernel launches than wrapper "
                         f"calls in all {TRACE_ATTEMPTS} attempts (calls, "
                         f"launches): {off}")


def _k4_in_trace(tag: str, prof: dict, counts: dict) -> None:
    """K4 in a path's whole trace (_trace_counted has held its launches to
    its wrapper calls, one a call): the sampler's fused mask among them,
    and fewer f32 fills in the whole trace than K4 launches (the sampler's
    three ops after K4 would launch two a call; the engine's threads share
    the stream, so the card's order may put another thread's kernels right
    after a K4 launch); its device time a launch and the path's launches a
    token."""
    calls = launched("kth_value", counts)
    kernels = _k4_kernels(prof)
    ms = sum(v for k, v in prof["ms_by_kernel"].items()
             if any(n in k for n in K4_KERNELS))
    fills = prof["sampler_op_kernels"][SAMPLER_OPS[1]]
    log(f"[{tag}] traced: K4 {calls} calls (top_k_mask "
        f"{counts.get('top_k_mask', 0)}, kth_value "
        f"{counts.get('kth_value', 0)}), its kernel {kernels} launches, "
        f"{ms:.1f} ms of device time, {1000 * ms / max(kernels, 1):.2f} us "
        f"a launch; {prof['launches_per_token']:.2f} launches a token over "
        f"{prof['n_tokens']} tokens (with the three ops: "
        f"{LAUNCHES_A_TOKEN_UNFUSED[tag]}); the sampler's three ops' "
        f"kernels in the whole trace {prof['sampler_op_kernels']} (the "
        f"three ops would add two f32 fills, a compare, a where and an add "
        f"a K4 launch); K4 launches followed by one run of them on the card "
        f"{prof['k4_then_sampler_ops']}; the kernels after K4, most common: "
        f"{prof['after_k4']}")
    if kernels != calls or counts.get("top_k_mask", 0) == 0 \
            or fills >= kernels:
        raise AssertionError(f"{tag} trace: K4 {calls} calls, {kernels} "
                             f"kernel launches, {fills} f32 fills (the "
                             f"three ops launch two a K4 launch)")


def profile_solo(torch, pipe) -> dict:
    """Phase 5, second part: one warm WAV request under torch.profiler. K3
    must show as one kernel launch a wrapper call (its cluster kernel; no
    kernel of the old split design), one call a layer and decode step."""
    text = "I finally got the job, I am so happy!"
    pipe.generate(text, seed=7)
    # K3's kernel: the solo path runs no other of csrc/decode_attention.cu
    out, counts = _trace_counted(
        torch, "solo", lambda: len(pipe.generate(text, seed=7).tokens),
        lambda prof, c: {"K3": (c.get("flash_decode_sp", 0),
                                _k3_kernels(prof)),
                         "K4": (launched("kth_value", c), _k4_kernels(prof))})
    calls = counts.get("flash_decode_sp", 0)
    kernels = _k3_kernels(out)
    stale = [k for k in out["count_by_kernel"]
             if "decode_combine" in k or "decode_partial" in k]
    n_layer = pipe.generator.cfg.n_layer
    log(f"[solo] traced request: flash_decode_sp {calls} calls, its kernel "
        f"{kernels} launches ({kernels / n_layer:.1f} a layer), "
        f"{calls / max(out['n_tokens'], 1):.2f} calls a token; kernels of "
        f"the split design: {stale or 'none'}")
    if stale or calls == 0 or kernels != calls or calls % n_layer:
        raise AssertionError(f"solo trace: K3 {calls} calls, {kernels} "
                             f"cluster launches, stale kernels {stale}")
    _k4_in_trace("solo", out, counts)
    return out


BURST_TEXTS = ("I finally got the job, I am so happy!",
               "The rain will not stop and I miss you.",
               "Why would they do that to me, I am furious.",
               "It is a quiet evening and the tea is warm.")
LONE = {"prompt": BURST_TEXTS[0], "seed": "21"}


def _burst(port: int, tag: str, lone_again: bool):
    """Ten concurrent requests on eight slots: eight at once (with
    ``lone_again`` the third of them is the lone request's prompt and seed
    again, as WAV), then a ninth and a tenth a moment later, which find the
    decode running. -> (tokens, seconds, the repeated request's bytes)."""
    replies, errors = {}, []

    def hit(i, delay, fields, query):
        try:
            time.sleep(delay)
            replies[i] = (fields, query, _post(port, fields, query))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {type(exc).__name__}: {exc}")

    plan = []
    for i in range(10):
        fields = {"prompt": BURST_TEXTS[i % len(BURST_TEXTS)],
                  "seed": str(31 + i)}
        query = "?format=midi" if i % 2 else ""
        if lone_again and i == 2:
            fields, query = dict(LONE), ""
        plan.append((i, 0.02 * i if i < 8 else 0.4 + 0.1 * i, fields, query))
    t0 = time.perf_counter()
    threads = [threading.Thread(target=hit, args=a, daemon=True)
               for a in plan]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    secs = time.perf_counter() - t0
    if errors or len(replies) != len(plan):
        raise AssertionError(f"burst failed: {errors or 'a request hung'}")
    n_tok = sum(_check_reply(tag, f, q, r)
                for _, (f, q, r) in sorted(replies.items()))
    return n_tok, secs, replies[2][2][1]


def serve_coalesced(torch):
    """Phase 6: the server as `serve --coalesce --slots 8` on demo_ckpt_a,
    bf16, full width: a lone request, then the burst; the probes on the
    engine's cache; one more burst under torch.profiler."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.decode import graphs
    from eamg_tpu_torch.ops import _build, decode_fold
    from eamg_tpu_torch.serve import shutdown_gracefully

    pipe = cli.pipeline_from_args(cli.parse_args(
        ["serve", "--coalesce", "--slots", str(ENGINE_SLOTS)]))
    eng = pipe.batcher
    _require_xla_order("coalesce", pipe)
    engine_fold = decode_fold.fold_decode.__name__
    log(f"[coalesce] engine: slots {eng.slots}, chunk {eng.chunk}, max_len "
        f"{eng.max_len}, decode attention {engine_fold}")
    t0 = time.perf_counter()
    pipe.warmup()
    log(f"[coalesce] warm-up (the detached decode's and the engine's "
        f"graphs captured) {time.perf_counter() - t0:.2f} s; "
        f"{graphs.tally()}")
    server, thread, port = _serving(pipe)
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        replays0 = graphs.tally()["replays"]
        # (a) a lone request: the idle engine is bypassed, run_detached
        admitted0 = eng.stats["admitted"]      # the warm-up's engine row
        lone = _post(port, LONE, "")
        _check_reply("coalesce lone", LONE, "", lone)
        if eng.stats["admitted"] != admitted0:
            raise AssertionError("the lone request did not take the "
                                 "detached route")
        # (b) + (c) ten requests on eight slots, the lone seed among them
        n_tok, secs, again = _burst(port, "coalesce burst", lone_again=True)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        replayed = _build.replayed_counts()
        replays = graphs.tally()["replays"] - replays0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=60) as r:
            stats = json.loads(r.read())["engine"]
        log(f"[coalesce] burst of 10: {n_tok} tokens (prompts included) in "
            f"{secs:.2f} s, {n_tok / secs:.1f} tokens/s aggregate; engine "
            f"stats {stats}")
        if again != lone[1]:
            raise AssertionError("the lone request's seed gave other bytes "
                                 "inside the burst")
        log("[coalesce] the lone request's bytes are the same inside the "
            "burst (detached row == engine row)")
        if stats["served"] < 8 or stats["served"] != stats["admitted"]:
            raise AssertionError(f"engine served {stats}")
        log(f"[coalesce] launches over the lone request and the burst: "
            f"{counts}")
        _require_launched("coalesce", counts)
        _require_graphs("coalesce", engine_fold, counts, replayed, replays)

        # The probes, once each on the engine's live cache (layer 0): the
        # read rate that bounds the fold kernels, and the fold variant the
        # engine does not call. No served path launches these two: their
        # launches here are counted apart, as probe launches.
        cache = eng.state["cache"]
        kv, t = cache["kv"][0], cache["lengths"]
        H = pipe.generator.cfg.n_head
        g = torch.Generator(device="cpu").manual_seed(3)
        q = torch.randn(kv.shape[0], 1, pipe.generator.cfg.d_model,
                        generator=g).to(kv.dtype).to(kv.device)
        before = _build.launch_counts()
        outs = {n: getattr(decode_fold, n)(q, kv, t, H)
                for n in ("flash_decode_fold_sp", "flash_decode_fold3_sp")
                if n != engine_fold}
        decode_fold.stream_reduce(kv, 4)
        after = _build.launch_counts()
        probes = {n: after.get(n, 0) - before.get(n, 0)
                  for n in (*outs, "stream_reduce")}
        if min(probes.values()) <= 0:
            raise AssertionError(f"a probe did not launch: {probes}")
        outs[engine_fold] = decode_fold.fold_decode(q, kv, t, H)
        want = decode_fold.decode_attention_pm_plain(q.float(), kv.float(), t,
                                                     H)
        rel = max((o.float() - want).abs().max().item()
                  for o in outs.values()) / max(want.abs().max().item(),
                                                1e-30)
        probe_ms = time_cold_ms(torch, {
            "stream": lambda: decode_fold.stream_reduce(kv, 4),
            "fold": lambda: decode_fold.fold_decode(q, kv, t, H)},
            iters=30, hold_us=2000.0)
        sr_ms, f_ms = probe_ms["stream"], probe_ms["fold"]
        live = int((t.clamp(max=kv.shape[1] - 1) + 1).sum().item())
        log(f"[coalesce] on the engine's cache after the burst (layer 0, "
            f"{tuple(kv.shape)}, lengths {t.tolist()}): both fold variants "
            f"vs f32 plain max|err| / max|want| {rel:.2e} (tol "
            f"{REL_TOL_F32:.0e}); stream_reduce {sr_ms:.4f} ms = "
            f"{nbytes(kv) / sr_ms / 1e6:.1f} GB/s over the whole cache; "
            f"engine fold kernel {f_ms:.4f} ms for {live} live positions")
        if not rel <= REL_TOL_F32:
            raise AssertionError(f"fold variants on the engine cache: {rel}")

        # one more burst under torch.profiler: the engine's fold (rows 8
        # and 11's kernel over the fused cache, the only kernel of
        # csrc/decode_kernels.cuh this path runs) one kernel launch a call,
        # a call a layer and step, and no kernel of the split design
        prof, traced = _trace_counted(
            torch, "coalesce",
            lambda: _burst(port, "coalesce traced", lone_again=False)[0],
            lambda p, c: {"K4": (launched("kth_value", c), _k4_kernels(p)),
                          engine_fold: (c.get(engine_fold, 0),
                                        _k3_kernels(p))})
        _k4_in_trace("coalesce", prof, traced)
        calls = traced.get(engine_fold, 0)
        kernels = _k3_kernels(prof)
        stale = [k for k in prof["count_by_kernel"]
                 if "fold_partial" in k or "fold_combine" in k]
        n_layer = pipe.generator.cfg.n_layer
        fold_ms = sum(ms for k, ms in prof["ms_by_kernel"].items()
                      if "decode_heads_kernel" in k
                      or "decode_cluster_kernel" in k)
        log(f"[coalesce] traced burst: {engine_fold} {calls} calls, its "
            f"kernel {kernels} launches ({kernels / n_layer:.1f} a layer), "
            f"{fold_ms:.1f} ms of device time, "
            f"{1000 * fold_ms / max(kernels, 1):.2f} us a launch; kernels of "
            f"the split design: {stale or 'none'}")
        if stale or calls == 0 or kernels != calls or calls % n_layer:
            raise AssertionError(f"coalesce trace: {engine_fold} {calls} "
                                 f"calls, {kernels} kernel launches, stale "
                                 f"kernels {stale}")
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)

    def eager_engine(port):
        lone_ = _post(port, LONE, "")[1]
        return lone_, _burst(port, "coalesce eager", lone_again=True)[2]

    lone_e, again_e = _eager_replies(
        ["serve", "--coalesce", "--slots", str(ENGINE_SLOTS)], eager_engine)
    if lone_e != lone[1] or again_e != again:
        raise AssertionError("coalesce: the engine's seed-21 request (alone "
                             "or in the burst) from the eager loop differs "
                             "from the graphs'")
    log("[coalesce] the engine's seed-21 request, alone and in the burst, "
        "decoded by the eager loop has the graphs' bytes")
    return counts, probes, prof


def serve_window(torch) -> dict:
    """Phase 6, last part: the other coalescing mode, `serve --coalesce
    window`: four requests at once share ragged decodes of the window
    batcher (grouped by their sampling params). -> launches per kernel
    over the four requests."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.decode import graphs
    from eamg_tpu_torch.ops import _build, decode_fold
    from eamg_tpu_torch.serve import shutdown_gracefully

    pipe = cli.pipeline_from_args(cli.parse_args(
        ["serve", "--coalesce", "window", "--slots", "4"]))
    pipe.warmup()
    replays0 = graphs.tally()["replays"]
    server, thread, port = _serving(pipe)
    replies, errors = {}, []

    def four_at_once(port, replies, errors):
        def hit(i):
            fields = {"prompt": BURST_TEXTS[i], "seed": str(51 + i)}
            try:
                replies[i] = (fields, _post(port, fields, "?format=midi"))
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(f"request {i}: {type(exc).__name__}: {exc}")

        threads = [threading.Thread(target=hit, args=(i,), daemon=True)
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or len(replies) != 4:
            raise AssertionError(f"window batch failed: "
                                 f"{errors or 'a request hung'}")
        return replies

    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        four_at_once(port, replies, errors)
        secs = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        replayed = _build.replayed_counts()
        n_tok = sum(_check_reply("window", f, "?format=midi", r)
                    for _, (f, r) in sorted(replies.items()))
        stats = dict(pipe.batcher.stats)
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    log(f"[window] 4 requests at once: {n_tok} tokens in {secs:.2f} s, "
        f"{n_tok / secs:.1f} tokens/s aggregate; batcher stats {stats}; "
        f"launches over the four requests: {counts}")
    if stats["requests"] < 5 or stats["max_group"] < 2:
        raise AssertionError(f"the window batcher did not group: {stats}")
    # each of the four seeds gives a song of hundreds of tokens (450 to
    # 511 on this checkpoint); a reply of a handful means the rows were
    # read before the decode wrote them
    short = {f["seed"]: r[2].get("X-EAMG-Tokens") for f, r in
             replies.values() if int(r[2].get("X-EAMG-Tokens", "0")) < 100}
    if short:
        raise AssertionError(f"window: replies of a few tokens {short}")
    # the same four on a window batcher whose ragged decode issues every
    # step from the host: a row's stream does not depend on its group
    eager = _eager_replies(["serve", "--coalesce", "window", "--slots", "4"],
                           lambda port: four_at_once(port, {}, []))
    if {i: r[1][1] for i, r in eager.items()} \
            != {i: r[1][1] for i, r in replies.items()}:
        raise AssertionError("window: the eager ragged decode's bytes differ "
                             "from the graphs'")
    log("[window] the four requests decoded by the eager ragged loop have "
        "the graphs' bytes")
    _require_launched("window", counts)
    _require_graphs("window", decode_fold.fold_decode.__name__, counts,
                    replayed, graphs.tally()["replays"] - replays0)
    return counts


# the page's default request: a stream of WAV, one sentence; and three
# sentences for sections
STREAM_FIELDS = {"prompt": BURST_TEXTS[0], "seed": "7"}
SECTIONS_FIELDS = {"prompt": " ".join(BURST_TEXTS[:3]), "seed": "9",
                   "sections": "1"}


def _sse_post(port: int, fields: dict, query: str = "?stream=1",
              drop: bool = False):
    """POST /generate with ``query`` (a stream), the form as the page posts
    it, its events read as they arrive. -> (status, content type, events,
    seconds to the first tokens event, seconds in all). ``drop``: close
    the connection at the first tokens event."""
    import http.client

    body, ctype = _multipart(fields)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    first, events = None, []
    try:
        conn.request("POST", f"/generate{query}", body=body,
                     headers={"Content-Type": ctype})
        resp = conn.getresponse()
        rtype = resp.getheader("Content-Type", "")
        if resp.status != 200:
            return resp.status, rtype, [json.loads(resp.read())], None, \
                time.perf_counter() - t0
        while True:
            line = resp.fp.readline()
            if not line:
                break
            if not line.startswith(b"data: "):
                continue
            events.append(json.loads(line[len(b"data: "):]))
            if events[-1]["event"] == "tokens" and first is None:
                first = time.perf_counter() - t0
                if drop:
                    break
    finally:
        conn.close()
    return resp.status, rtype, events, first, time.perf_counter() - t0


def _deltas_midi(pipe, events) -> bytes:
    """The MIDI of a stream's sections as its events give them: each
    meta event's prompt and the token deltas after it, laid end to end as
    ``generate_stream`` lays them."""
    import io

    from eamg_tpu_torch.serve.pipeline import _Sections

    vocab = pipe.scheme_b.vocab if pipe.scheme == "b3" \
        else pipe.generator.vocab
    merged, ids = _Sections(0.5), None
    for ev in events + [{"event": "meta"}]:
        if ev["event"] == "meta":
            if ids is not None:
                merged.add(pipe._song(ids)[1])
            ids = vocab.encode(ev.get("prompt_tokens", []))
        elif ev["event"] == "tokens":
            ids += ev["ids"]
    buf = io.BytesIO()
    merged.song.write(buf)
    return buf.getvalue()


def _sans_timings(events) -> list:
    """A stream's events without the done event's wall-clock timings."""
    return [{k: v for k, v in e.items() if k != "timings_ms"}
            for e in events]


def _check_stream(tag: str, fields: dict, query: str, reply, pipe) -> dict:
    """Hold one SSE reply to the contract: 200 text/event-stream; per
    section a meta event, then tokens events; a last done event whose MIDI
    is the deltas' (and whose WAV is RIFF....WAVE unless MIDI was asked
    for). Logs the time to the first tokens event beside the request's
    total; -> those and the decode rate."""
    import base64

    status, ctype, events, first, secs = reply
    if status != 200 or not ctype.startswith("text/event-stream"):
        raise AssertionError(f"{tag}: HTTP {status} {ctype}: {events}")
    kinds = [e["event"] for e in events]
    n_sec = events[0].get("n_sections", 0) if events else 0
    if not events or kinds[-1] != "done" or "error" in kinds \
            or kinds.count("meta") != n_sec or n_sec < 1 \
            or any(kinds[i + 1] != "tokens" for i, k in enumerate(kinds)
                   if k == "meta") \
            or set(kinds[:-1]) != {"meta", "tokens"} or kinds[0] != "meta":
        raise AssertionError(f"{tag}: events {kinds}")
    done = events[-1]
    midi = base64.b64decode(done["midi_b64"])
    if midi[:4] != b"MThd" or midi != _deltas_midi(pipe, events):
        raise AssertionError(f"{tag}: the done event's MIDI is not the "
                             "deltas'")
    if "format=midi" not in query:
        wav = base64.b64decode(done["wav_b64"] or "")
        if wav[:4] != b"RIFF" or wav[8:12] != b"WAVE":
            raise AssertionError(f"{tag}: the done event's WAV is not "
                                 "RIFF....WAVE")
    n_gen = sum(len(e["ids"]) for e in events if e["event"] == "tokens")
    dec_s = done["timings_ms"]["decode"] / 1000
    out = {"first_tokens_ms": first * 1000, "total_ms": secs * 1000,
           "tokens": n_gen, "events": len(events), "sections": n_sec,
           "decode_tokens_per_s": n_gen / dec_s if dec_s else 0.0}
    log(f"[{tag}] {query} seed {fields['seed']}: HTTP 200 {ctype}, "
        f"{len(events)} events ({n_sec} sections), {n_gen} tokens made, "
        f"first tokens event at {out['first_tokens_ms']:.1f} ms of "
        f"{out['total_ms']:.1f} ms in all, "
        f"{out['decode_tokens_per_s']:.1f} tokens/s of decode, emotion "
        f"{done['label']}, timings_ms {done['timings_ms']}")
    return out


def _stream_ids(events) -> tuple:
    """(the first section's prompt ids' tokens, its deltas concatenated)."""
    return (events[0]["prompt_tokens"],
            [i for e in events if e["event"] == "tokens" for i in e["ids"]])


def serve_stream(torch) -> dict:
    """Phase 7: the page's default request, POST /generate?stream=1 with
    WAV, on demo_ckpt_a: to the solo server (its chunks replayed from
    graphs, the same bytes twice and from the eager loop, three sentences
    with sections=1 streamed and not, one stream traced), then to `serve
    --coalesce` (an engine row: its deltas equal submit() for the seed, a
    stream closed mid-way frees its slot, through the library and over
    HTTP). -> launch counts by path."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.decode import graphs
    from eamg_tpu_torch.ops import _build, decode_fold
    from eamg_tpu_torch.serve import shutdown_gracefully

    counts = {}
    pipe = cli.pipeline_from_args(cli.parse_args(["serve"]))
    t0 = time.perf_counter()
    pipe.warmup()
    log(f"[stream] solo warm-up (the decode's and the stream's graphs "
        f"captured) {time.perf_counter() - t0:.2f} s; {graphs.tally()}")
    server, thread, port = _serving(pipe)
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        replays0 = graphs.tally()["replays"]
        first = _sse_post(port, STREAM_FIELDS)
        again = _sse_post(port, STREAM_FIELDS)
        torch.cuda.synchronize()
        counts["stream"] = _build.launch_counts()
        replayed = _build.replayed_counts()
        replays = graphs.tally()["replays"] - replays0
        for tag, r in (("stream solo", first), ("stream solo again", again)):
            _check_stream(tag, STREAM_FIELDS, "?stream=1", r, pipe)
        if _sans_timings(first[2]) != _sans_timings(again[2]):
            raise AssertionError("stream: same-seed events differ")
        log(f"[stream] same-seed events identical; launches over the two "
            f"streams: {counts['stream']}")
        _require_launched("solo", counts["stream"])
        _require_graphs("stream", "flash_decode_sp", counts["stream"],
                        replayed, replays)
        q = "?stream=1&format=midi"
        _check_stream("stream solo sections", SECTIONS_FIELDS, q,
                      _sse_post(port, SECTIONS_FIELDS, q), pipe)
        _check_reply("stream solo sections, not streamed", SECTIONS_FIELDS,
                     "?format=midi",
                     _post(port, SECTIONS_FIELDS, "?format=midi"))
        _build.reset_launch_counts()
        _trace(torch, "stream", lambda: len(_stream_ids(list(
            pipe.generate_stream(STREAM_FIELDS["prompt"], seed=7)))[1]))
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    eager = _eager_replies(["serve"], lambda port: _sse_post(
        port, STREAM_FIELDS))
    if _sans_timings(eager[2]) != _sans_timings(first[2]):
        raise AssertionError("stream: the eager loop's events differ from "
                             "the graphs'")
    log("[stream] the stream of seed 7 from the eager loop (every step "
        "issued from the host) has the graphs' events")

    pipe = cli.pipeline_from_args(cli.parse_args(
        ["serve", "--coalesce", "--slots", str(ENGINE_SLOTS)]))
    eng = pipe.batcher
    pipe.warmup()
    server, thread, port = _serving(pipe)
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        replays0 = graphs.tally()["replays"]
        admitted0 = eng.stats["admitted"]
        reply = _sse_post(port, STREAM_FIELDS)
        torch.cuda.synchronize()
        counts["stream_coalesce"] = _build.launch_counts()
        replayed = _build.replayed_counts()
        replays = graphs.tally()["replays"] - replays0
        _check_stream("stream engine", STREAM_FIELDS, "?stream=1", reply,
                      pipe)
        if eng.stats["admitted"] != admitted0 + 1:
            raise AssertionError("stream: the request did not join the "
                                 "engine")
        _require_launched("coalesce", counts["stream_coalesce"])
        _require_graphs("stream coalesce", decode_fold.fold_decode.__name__,
                        counts["stream_coalesce"], replayed, replays)
        prompt, deltas = _stream_ids(reply[2])
        ids = pipe.generator.vocab.encode(prompt)
        row = eng.submit(ids, seed=7)
        lib = [t for d in eng.submit_stream(ids, seed=7) for t in d]
        if row[len(ids):] != deltas or lib != deltas:
            raise AssertionError("stream: the engine row's deltas differ "
                                 "from submit()'s tokens")
        log(f"[stream] engine: the streamed deltas ({len(deltas)} tokens) "
            "equal submit()'s row and submit_stream()'s for the seed")
        q = "?stream=1&format=midi"
        _check_stream("stream engine sections", SECTIONS_FIELDS, q,
                      _sse_post(port, SECTIONS_FIELDS, q), pipe)
        # a stream closed after its first delta, through the library and
        # over HTTP: its row is cancelled (unless it ended first: a delta
        # trails the decode by up to two chunks) and its slot freed
        for how in ("library", "http"):
            before = dict(eng.stats)
            if how == "library":
                s = eng.submit_stream(ids, seed=8)
                next(s)
                s.close()
            else:
                reply = _sse_post(port, {"prompt": BURST_TEXTS[1],
                                         "seed": "12"}, drop=True)
                if reply[3] is None:
                    raise AssertionError("stream: the dropped request saw "
                                         "no tokens")
            stats = _wait_for(lambda: _stats_free(port, eng.slots),
                              f"the slot of the stream closed ({how})")
            ended = {k: eng.stats[k] - before[k]
                     for k in ("cancelled", "served")}
            log(f"[stream] a stream closed after its first delta ({how}): "
                f"{ended}; /stats engine {stats}")
            if sum(ended.values()) != 1:
                raise AssertionError(f"stream: the closed stream's row "
                                     f"({how}) ended as {ended}")
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    return counts


def _wait_for(cond, what: str, secs: float = 120.0):
    """cond()'s first true value, polled; fails after ``secs``."""
    deadline = time.monotonic() + secs
    while True:
        v = cond()
        if v:
            return v
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _stats_free(port: int, slots: int):
    """/stats's engine counters when every slot is free, else None."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                timeout=30) as r:
        eng = json.loads(r.read())["engine"]
    return eng if eng["free_slots"] == slots and eng["queue_depth"] == 0 \
        else None


def serve_b3(torch) -> dict:
    """Phase 8: `serve --coalesce` on demo_ckpt_b3 (B3 serves solo: the
    flag is switched off for it): two WAV requests of one seed (the same
    bytes, and the eager loop's), a MIDI request and a stream, decoded
    from replayed graphs with K1, K2, K3 and K4 launched at B3's shapes;
    one request traced; then `cli generate` on B3 twice. -> launch counts
    by path."""
    import tempfile

    from eamg_tpu_torch import cli
    from eamg_tpu_torch.decode import graphs
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve import shutdown_gracefully
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_B3

    counts = {}
    args = ["serve", "--checkpoint", DEMO_CKPT_B3, "--coalesce"]
    pipe = cli.pipeline_from_args(cli.parse_args(args))
    cfg, gen = pipe.generator.cfg, pipe.generator
    _require_xla_order("b3", pipe)
    if pipe.scheme != "b3" or pipe.batcher is not None:
        raise AssertionError(f"b3: scheme {pipe.scheme}, batcher "
                             f"{pipe.batcher}")
    log(f"[b3] {DEMO_CKPT_B3}: D {cfg.d_model}, H {cfg.n_head} (Hkv "
        f"{cfg.kv_heads}, Dh {cfg.head_dim}), FF {cfg.ff}, L {cfg.n_layer}, "
        f"V {cfg.vocab_size}, max_len {gen.max_supported_len()} (the "
        f"stream's cache {gen.max_supported_len() + 32}), EOS "
        f"{gen.vocab.id2tok[gen.eos_id]}; --coalesce switched off: solo")
    t0 = time.perf_counter()
    pipe.warmup()
    log(f"[b3] warm-up {time.perf_counter() - t0:.2f} s; {graphs.tally()}")
    server, thread, port = _serving(pipe)
    wav = {"prompt": BURST_TEXTS[0], "seed": "7"}
    midi = {"prompt": BURST_TEXTS[1], "seed": "11"}
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        replays0 = graphs.tally()["replays"]
        bodies = []
        for fields, query in ((wav, ""), (wav, ""), (midi, "?format=midi")):
            reply = _post(port, fields, query)
            _check_reply("b3", fields, query, reply)
            bodies.append(reply[1])
        _check_stream("b3 stream", wav, "?stream=1",
                      _sse_post(port, wav), pipe)
        torch.cuda.synchronize()
        counts["b3"] = _build.launch_counts()
        replayed = _build.replayed_counts()
        replays = graphs.tally()["replays"] - replays0
        if bodies[0] != bodies[1]:
            raise AssertionError("b3: same-seed WAV bytes differ")
        log(f"[b3] same-seed WAV bytes identical; launches over the four "
            f"requests (K1 Dh {cfg.head_dim}, K2 D {cfg.d_model} FF "
            f"{cfg.ff}, K3 H {cfg.n_head} MHA Dh {cfg.head_dim} M "
            f"{gen.max_supported_len()} and the stream's "
            f"{gen.max_supported_len() + 32}, K4 V {cfg.vocab_size}): "
            f"{counts['b3']}")
        _require_launched("solo", counts["b3"])
        _require_graphs("b3", "flash_decode_sp", counts["b3"], replayed,
                        replays)
        _build.reset_launch_counts()
        prof = _trace(torch, "b3", lambda: len(pipe.generate(
            wav["prompt"], seed=7).tokens))
        names = [k for k in prof["count_by_kernel"]
                 if "decode_" in k and "kernel" in k]
        log(f"[b3] traced: the decode attention kernels {names}")
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    eager = _eager_replies(args[:3], lambda port: _post(port, wav, "")[1])
    if eager != bodies[0]:
        raise AssertionError("b3: the WAV of seed 7 from the eager loop "
                             "differs from the graphs'")
    log("[b3] the WAV of seed 7 from the eager loop has the graphs' bytes")
    _build.reset_launch_counts()
    files = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(2):
            mid, wv = (os.path.join(tmp, f"b3_{i}.{x}") for x in ("mid",
                                                                 "wav"))
            t0 = time.perf_counter()
            code = cli.main(["generate", "--checkpoint", DEMO_CKPT_B3,
                             "--seed", "5", "--bpm", "120", "--key",
                             "C major", "--out", mid, "--wav", wv])
            torch.cuda.synchronize()
            if code != 0:
                raise AssertionError(f"b3: cli generate exited {code}")
            with open(mid, "rb") as f, open(wv, "rb") as g:
                files.append((f.read(), g.read()))
            m, w = files[-1]
            log(f"[b3 cli generate] run {i}: {len(m)} MIDI bytes, {len(w)} "
                f"WAV bytes in {time.perf_counter() - t0:.2f} s")
            if m[:4] != b"MThd" or w[:4] != b"RIFF" or w[8:12] != b"WAVE":
                raise AssertionError("b3: cli generate wrote no MThd / "
                                     "RIFF....WAVE")
    counts["b3_generate"] = _build.launch_counts()
    if files[0] != files[1]:
        raise AssertionError("b3: cli generate's same-seed bytes differ")
    log(f"[b3 cli generate] same-seed bytes identical; launches "
        f"{counts['b3_generate']}")
    _require_launched("solo", counts["b3_generate"])
    return counts


# the uncached loop's sampling values (fault C2)
C2_TEMPERATURE, C2_PENALTIES = 0.7, (1.3, 0.0, 0.0)


def uncached_divisors(torch, ckpt) -> None:
    """Phase 4, last part: generate_full (the uncached loop) on
    demo_ckpt_a at temperature 0.7 and repetition penalty 1.3, the
    sampler's inputs and the logits it filtered recorded at every step;
    those filtered logits must equal, bit for bit, the ones made from the
    same inputs with tensor divisors (a traced value in JAX, a true
    division on the card); the ones made with host floats (a multiply by
    the reciprocal on CUDA) are counted beside them."""
    from eamg_tpu_torch.decode import Generator, loop, sampling
    from eamg_tpu_torch.decode.sampling import (apply_penalties,
                                                filter_logits,
                                                penalty_tensor)
    from eamg_tpu_torch.tokenizer import Vocab
    from eamg_tpu_torch.utils import prng

    gen = Generator(ckpt["params"], ckpt["cfg"], Vocab(ckpt["vocab"]))
    ids = gen.vocab.encode(["[START_SEQUENCE]", "[BPM] 120.0",
                            "[KEY_SIGNATURE] C major"])
    prompt = torch.zeros((1, 16), dtype=torch.int64, device="cuda")
    prompt[0, :len(ids)] = torch.tensor(ids)
    seen, filtered = [], []
    real, real_filter = loop.sample_token, sampling.filter_logits

    def spy(key, logits, temperature, top_k, *a, counts=None,
            penalties=None, **kw):
        seen.append((logits.clone(), counts.clone(), temperature, penalties,
                     top_k))
        return real(key, logits, temperature, top_k, *a, counts=counts,
                    penalties=penalties, **kw)

    def filter_spy(*a, **kw):
        filtered.append(real_filter(*a, **kw))
        return filtered[-1]

    loop.sample_token, sampling.filter_logits = spy, filter_spy
    try:
        buf, n = loop.generate_full(
            gen.params, prompt, len(ids), prng.PRNGKey(3), gen.cfg, 24,
            temperature=C2_TEMPERATURE, eos_id=gen.eos_id, pad_id=gen.pad_id,
            penalties=C2_PENALTIES)
    finally:
        loop.sample_token, sampling.filter_logits = real, real_filter
    torch.cuda.synchronize()
    if len(filtered) != len(seen):
        raise AssertionError(f"C2: {len(seen)} sampler calls filtered "
                             f"{len(filtered)} times")
    temp_t = torch.full((1,), C2_TEMPERATURE, device="cuda")
    pen_t = penalty_tensor(C2_PENALTIES, "cuda")
    host_differ = 0
    for (logits, counts, temp, pen, top_k), got in zip(seen, filtered):
        if not isinstance(temp, torch.Tensor) \
                or not isinstance(pen, torch.Tensor):
            raise AssertionError("C2: generate_full hands the sampler host "
                                 f"values ({type(temp).__name__}, "
                                 f"{type(pen).__name__})")
        want = filter_logits(apply_penalties(logits, counts,
                                             penalties=pen_t), temp_t, top_k)
        host = filter_logits(apply_penalties(logits, counts, *C2_PENALTIES),
                             C2_TEMPERATURE, top_k)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError("C2: generate_full's filtered logits differ "
                                 "from those with tensor divisors")
        host_differ += int((host.view(torch.int32)
                            != want.view(torch.int32)).sum().item())
    log(f"[c2] generate_full at temperature {C2_TEMPERATURE}, repetition "
        f"penalty {C2_PENALTIES[0]}: {len(seen)} steps ({n} tokens), the "
        "logits its sampler filtered bit-equal to those with tensor divisors; host-float "
        f"divisors would change {host_differ} of "
        f"{len(seen) * gen.cfg.vocab_size} of them")


def batch_teacher_forced(torch, cfg32, params32) -> None:
    """Phase 7, second part: f32 logits of the large2 model over the
    prompt + 32 forced tokens, two rows, every attn_impl on the card
    against the same attn_impl on the host (its plain version)."""
    from eamg_tpu_torch.decode.api import _to_device
    from eamg_tpu_torch.models import gpt

    g = torch.Generator().manual_seed(2)
    forced = torch.randint(0, cfg32.vocab_size, (32, 2), generator=g)
    ids = torch.zeros((2, 16), dtype=torch.int64)
    ids[:, :3] = torch.tensor([1, 2, 3])

    def run(device, impl):
        params = _to_device(params32, device)
        cache = gpt.init_kv_cache(cfg32, 2, cfg32.n_pos, device=device,
                                  layout=gpt.cache_layout(impl, cfg32))
        logits0, cache = gpt.prefill(params, ids.to(device), cfg32, cache,
                                     prompt_len=3)
        outs = [logits0[:, 2]]
        last = ids[:, 2:3].to(device)
        for row in forced:
            lg, cache = gpt.decode_step(params, last, cache, cfg32, impl)
            outs.append(lg)
            last = row[:, None].to(device)
        return torch.stack(outs).float().cpu()

    for impl in gpt.ATTN_IMPLS:
        a, b = run("cuda", impl), run("cpu", impl)
        delta = (a - b).abs().max().item()
        log(f"[batch teacher-forced] large2 f32, attn_impl {impl}: "
            f"max|logits(card) - logits(host)| {delta:.3e} (tol "
            f"{BATCH_TF_TOL:.0e}, max|logit| {b.abs().max().item():.2f})")
        if not delta <= BATCH_TF_TOL:
            raise AssertionError(f"batch teacher-forced {impl}: {delta} > "
                                 f"{BATCH_TF_TOL}")


def batch_decode(torch) -> dict:
    """Phase 7: the bench's generation on large2, batch 8, to position
    511, once per attn_impl. -> launches per kernel wrapper, summed over
    the generations (an attention kernel launches in one of them only)."""
    import dataclasses as dc

    from eamg_tpu_torch import bench
    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.ops import _build

    cfg = bench.large2_config()
    params = bench.make_params(cfg, 0, "cuda")
    prompt = bench.bench_prompt("cuda")
    max_len = cfg.n_pos
    steps = max_len - len(bench.PROMPT) - 1
    wrappers = gpt.IMPL_KERNEL
    log(f"[batch] large2: d{cfg.d_model} h{cfg.n_head} kv{cfg.kv_heads} "
        f"L{cfg.n_layer} ff{cfg.ff} V{cfg.vocab_size} {cfg.dtype}, batch "
        f"{prompt.shape[0]}, max_len {max_len}, {steps} decode steps")
    from eamg_tpu_torch.decode import graphs, loop
    from eamg_tpu_torch.utils import prng

    bench.run_once(params, cfg, prompt, 0, 32, "sp")      # warm the library
    torch.cuda.synchronize()
    total: dict = {}
    n_tok = (max_len - len(bench.PROMPT)) * prompt.shape[0]
    # the graphs run whole blocks: the steps past max_len in the last one
    # are launched too (inert, their tokens dropped)
    run_steps = -(-steps // graphs.BLOCK) * graphs.BLOCK
    rates = {}
    for impl in gpt.ATTN_IMPLS:
        t0 = time.perf_counter()
        eager, _ = loop.generate_kv(
            params, prompt, len(bench.PROMPT), prng.PRNGKey(1), cfg, max_len,
            temperature=1.0, top_k=50, eos_id=-1, pad_id=0,
            refeed_last_prompt=False, attn_impl=impl, eager=True)
        eager = eager.cpu()
        eager_s = time.perf_counter() - t0
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        buf, pos = bench.run_once(params, cfg, prompt, 1, max_len, impl)
        first_s = time.perf_counter() - t0
        counts = _build.launch_counts()
        _build.reset_launch_counts()
        replays0 = graphs.tally()["replays"]
        t0 = time.perf_counter()
        bench.run_once(params, cfg, prompt, 1, max_len, impl)
        secs = time.perf_counter() - t0
        # the captured graph's run: no decode step issued from Python
        _require_graphs(f"batch {impl}", wrappers[impl],
                        _build.launch_counts(), _build.replayed_counts(),
                        graphs.tally()["replays"] - replays0)
        rates[impl] = [n_tok / secs]
        log(f"[batch] attn_impl {impl}: {n_tok} tokens in {secs:.3f} s, "
            f"{n_tok / secs:.1f} tokens/s, {secs / steps * 1e3:.3f} ms per "
            f"step (the first run, which captured the graph: {first_s:.3f} "
            f"s; the eager loop: {eager_s:.3f} s, {n_tok / eager_s:.1f} "
            f"tokens/s); launches {counts}")
        if not torch.equal(buf, eager):
            raise AssertionError(f"batch {impl}: the graphs' tokens differ "
                                 "from the eager loop's")
        if pos != max_len or tuple(buf.shape) != (prompt.shape[0], max_len) \
                or int(buf.min()) < 0 or int(buf.max()) >= cfg.vocab_size \
                or not torch.equal(buf[:, :3], prompt[:, :3].cpu()):
            raise AssertionError(f"batch {impl}: bad tokens")
        if len({tuple(r) for r in buf.tolist()}) < 2:
            raise AssertionError(f"batch {impl}: all rows drew one stream")
        want = {"flash_attention": cfg.n_layer,
                "fused_ffn": cfg.n_layer * (run_steps + 1),
                "top_k_mask": run_steps + 1, "kth_value": 0,
                **{w: 0 for w in wrappers.values()},
                wrappers[impl]: cfg.n_layer * run_steps}
        got = {name: counts.get(name, 0) for name in want}
        if got != want:
            raise AssertionError(f"batch {impl}: launches {got}, want "
                                 f"{want}")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    log(f"[batch] every attn_impl: the graphs' tokens equal the eager "
        f"loop's; {graphs.tally()}")
    # fold and fold2 against sp: the best of three generations each, the
    # two more taken in turns (sp, fold2, fold, fold, fold2, sp)
    turn = ("sp", *reversed(FOLD_RATED))
    for impl in (*turn, *reversed(turn)):
        t0 = time.perf_counter()
        bench.run_once(params, cfg, prompt, 1, max_len, impl)
        rates[impl].append(n_tok / (time.perf_counter() - t0))
    ratios = {impl: max(rates[impl]) / max(rates["sp"]) for impl in FOLD_RATED}
    log("[batch] tokens/s, three generations each: " + ", ".join(
        f"{impl} {[round(r, 1) for r in rates[impl]]}"
        for impl in ("sp", *FOLD_RATED)) + "; against sp: " + ", ".join(
        f"{impl} {r:.3f}" for impl, r in ratios.items())
        + f" (at least {FOLD_RATE_MIN})")
    for impl, r in ratios.items():
        if not r >= FOLD_RATE_MIN:
            raise AssertionError(f"batch {impl}: {r:.3f} of sp's rate")
    # one more generation of the default attn_impl under torch.profiler
    _trace(torch, "batch", lambda: (max_len - len(bench.PROMPT))
           * bench.run_once(params, cfg, prompt, 2, max_len,
                            "sp")[0].shape[0])
    cfg32 = dc.replace(cfg, dtype="float32")
    params32 = gpt.init_params(torch.Generator().manual_seed(0), cfg32)
    params32["pos"] = 0.1 * torch.randn(params32["pos"].shape,
                                        generator=torch.Generator()
                                        .manual_seed(1))
    batch_teacher_forced(torch, cfg32, params32)
    return total


def cli_generate(torch) -> dict:
    """Phase 7, last part: `cli generate --wav` on demo_ckpt_a, bf16, twice
    with one seed. -> launches per kernel over the two runs."""
    import tempfile

    from eamg_tpu_torch import cli
    from eamg_tpu_torch.ops import _build

    _build.reset_launch_counts()
    files = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(2):
            mid = os.path.join(tmp, f"g{i}.mid")
            wav = os.path.join(tmp, f"g{i}.wav")
            t0 = time.perf_counter()
            code = cli.main(["generate", "--seed", "5", "--bpm", "120",
                             "--key", "C major", "--out", mid, "--wav", wav])
            torch.cuda.synchronize()
            if code != 0:
                raise AssertionError(f"cli generate exited {code}")
            with open(mid, "rb") as f:
                m = f.read()
            with open(wav, "rb") as f:
                w = f.read()
            log(f"[cli generate] run {i}: {len(m)} MIDI bytes, {len(w)} WAV "
                f"bytes in {time.perf_counter() - t0:.2f} s")
            if m[:4] != b"MThd":
                raise AssertionError("cli generate: MIDI does not start MThd")
            if w[:4] != b"RIFF" or w[8:12] != b"WAVE":
                raise AssertionError("cli generate: WAV is not RIFF....WAVE")
            files.append((m, w))
    counts = _build.launch_counts()
    if files[0] != files[1]:
        raise AssertionError("cli generate: same-seed bytes differ")
    log(f"[cli generate] same-seed MIDI and WAV bytes identical; launches "
        f"over the two runs: {counts}")
    _require_launched("solo", counts)
    return counts


# ------------------------------------------------------------------- spec

# the spec phase: the page's decode options (medusa, lookup, beams), each
# decoded solo. Requests: a WAV and, for medusa, a MIDI and a stream.
SPEC_WAV = {"prompt": BURST_TEXTS[0], "seed": "7"}
SPEC_MIDI = {"prompt": BURST_TEXTS[1], "seed": "11"}
SPEC_OPTIONS = {"medusa": {"medusa": "1"}, "lookup": {"lookup": "1"},
                "beams": {"beams": "4"}}
SPEC_BEAMS = 4
# what each option's requests must have launched: K1 (prefill), K2 (the
# verify step at G rows, the beams' step at K rows), K4 (the sampler's
# top-k on the first token, the head proposals and the verify rows), K3
# (the beams' decode step at B = K; the verify step's attention is XLA
# math in JAX, plain products here)
SPEC_KERNELS = {"medusa": ("flash_attention", "fused_ffn", "top_k_mask"),
                "lookup": ("flash_attention", "fused_ffn", "top_k_mask"),
                "beams": ("flash_attention", "fused_ffn", "flash_decode_sp")}
# the shapes the spec paths must have called the kernels at, by model:
# K2 rows (beams 4, medusa's verify 5, lookup's 9), K4 rows (the first
# token 1, medusa's head proposals 4, the verify rows 5 and 9), K3 at the
# beams' batch, K1 at batch 1
SPEC_SHAPES = {"fused_ffn": (4, 5, 9), "top_k_mask": (1, 4, 5, 9),
               "flash_decode_sp": (SPEC_BEAMS,), "flash_attention": (1,)}
# the kernel checks at those shapes: (D, FF, H, Hkv, Dh, beams' cache M, V)
SPEC_MODELS = {"a": (512, 2048, 8, 2, 64, 511, 8892),
               "b3": (192, 768, 4, 4, 48, 255, 8579)}
# a greedy speculative decode may part from the plain greedy decode only
# where the plain step's top two logits lie this close (f32, TF32 off)
GREEDY_MARGIN = 1e-4
SPEC_SEEDS = (0, 1, 2, 3)


def spec_kernel_checks(torch) -> None:
    """Phase 3, last part: the kernels at the spec paths' new shapes, each
    against its plain version, on A's and B3's widths: K2 at rows 4, 5 and
    9 (in the served "xla" order, the checkpoints' layer-0 weights), K3 at
    B 4 with a t a row, K4's top-k mask at rows 1, 4, 5 and 9 (k 50, f32,
    bit-equal); each timed cold beside its plain version."""
    from eamg_tpu_torch.ops import decode_attention, ffn, topk
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_A, DEMO_CKPT_B3
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    dev = "cuda"
    g = torch.Generator().manual_seed(12)

    def randn(*shape, dt, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dt).to(dev)

    def hold(name, dt_name, got, want, extra, fns):
        tol = TOL[(name, dt_name)]
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if tol == 0.0 and not torch.equal(got.float().view(torch.int32),
                                          want.float().view(torch.int32)):
            err = float("inf")
        ms = time_cold_ms(torch, fns, iters=20)
        ok = torch.isfinite(got.float()).all().item() and err <= tol
        log(f"[check] {name:16s} {dt_name:9s} max|err| {err:.3e} (tol "
            f"{tol:.0e}) {extra}, cold: kernel {ms['kernel']:.4f} ms, plain "
            f"{ms['plain']:.4f} ms{'' if ok else '  FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {dt_name} {extra}: max|err| {err} "
                                 f"> {tol}")

    for tag, path in (("a", DEMO_CKPT_A), ("b3", DEMO_CKPT_B3)):
        D, FF, H, Hkv, Dh, M, V = SPEC_MODELS[tag]
        mlp0 = load_checkpoint(path)["params"]["layers"][0]["mlp"]
        if tuple(mlp0["w1"].shape) != (FF, D):
            raise AssertionError(f"{tag}: FFN {tuple(mlp0['w1'].shape)}")
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            mlp = {n: w.to(dt).to(dev) for n, w in mlp0.items()}
            for rows in SPEC_SHAPES["fused_ffn"]:
                args = (randn(1, rows, D, dt=dt), mlp["w1"], mlp["b1"],
                        mlp["w2"], mlp["b2"])
                hold("fused_ffn_spec", dt_name,
                     ffn.fused_ffn(*args, activation="relu", order="xla"),
                     ffn.ffn_plain(*args, activation="relu", order="xla"),
                     f"{tag}: rows {rows}, D {D}, FF {FF}",
                     {"kernel": lambda a=args: ffn.fused_ffn(
                         *a, activation="relu", order="xla"),
                      "plain": lambda a=args: ffn.ffn_plain(
                          *a, activation="relu", order="xla")})
            B = SPEC_BEAMS
            q = randn(B, H, 1, Dh, dt=dt)
            kc, vc = randn(B, Hkv, M, Dh, dt=dt), randn(B, Hkv, M, Dh, dt=dt)
            t = torch.tensor([M - 1, 17, 0, M // 2], dtype=torch.int32,
                             device=dev)
            hold("flash_decode_sp_spec", dt_name,
                 decode_attention.flash_decode_sp(q, kc, vc, t),
                 decode_attention.decode_attention_plain(q, kc, vc, t),
                 f"{tag}: B {B} H {H} Hkv {Hkv} Dh {Dh} M {M}, t "
                 f"{t.tolist()}",
                 {"kernel": lambda: decode_attention.flash_decode_sp(
                     q, kc, vc, t),
                  "plain": lambda: decode_attention.decode_attention_plain(
                      q, kc, vc, t)})
        for rows in SPEC_SHAPES["top_k_mask"]:
            x = randn(rows, V, dt=torch.float32, scale=3.0)
            hold("kth_value_spec", "float32", topk.top_k_mask(x, 50),
                 topk.top_k_mask_plain(x, 50), f"{tag}: top-k mask rows "
                 f"{rows}, V {V}, k 50",
                 {"kernel": lambda x=x: topk.top_k_mask(x, 50),
                  "plain": lambda x=x: topk.top_k_mask_plain(x, 50)})


@contextlib.contextmanager
def _shapes_seen():
    """Record the shapes each kernel wrapper of the spec paths is called
    at, eagerly or while a graph is captured (a graph replays what it
    captured): -> {wrapper: {(rows or batch, width)}}; K2 by its rows and
    D, K4 by its rows and V, K3 and K1 by their batch and head dim."""
    from eamg_tpu_torch.decode import sampling
    from eamg_tpu_torch.models import gpt

    seen = collections.defaultdict(set)
    patched = []

    def wrap(owner, attr, name, key):
        get = owner.__getitem__ if isinstance(owner, dict) else \
            functools.partial(getattr, owner)
        fn = get(attr)

        def counted(*a, **kw):
            seen[name].add(key(a[0]))
            return fn(*a, **kw)

        if isinstance(owner, dict):
            owner[attr] = counted
        else:
            setattr(owner, attr, counted)
        patched.append((owner, attr, fn))

    rows = (lambda x: (x.numel() // x.shape[-1], x.shape[-1]))
    wrap(gpt, "fused_ffn", "fused_ffn", rows)
    wrap(gpt, "flash_attention", "flash_attention",
         lambda q: (q.shape[0], q.shape[-1]))
    wrap(gpt.HEAD_IMPLS, "sp", "flash_decode_sp",
         lambda q: (q.shape[0], q.shape[-1]))
    wrap(sampling, "top_k_mask", "top_k_mask", rows)
    try:
        yield seen
    finally:
        for owner, attr, fn in reversed(patched):
            if isinstance(owner, dict):
                owner[attr] = fn
            else:
                setattr(owner, attr, fn)


def _require_spec(tag: str, opt: str, counts: dict, replayed: dict,
                  replays: int) -> None:
    """An option's requests decoded from replayed graphs: its kernels
    launched, K4 and K2 from replays (the verify chunks) or K3 from
    replays only (the beams' blocks); the verify step launches no K3."""
    for n in SPEC_KERNELS[opt]:
        if counts.get(n, 0) <= 0:
            raise AssertionError(f"{tag}: {n} was not launched")
    if opt == "beams":
        _require_graphs(tag, "flash_decode_sp", counts, replayed, replays)
        return
    log(f"[{tag}] verify chunks: graph replays {replays}; launches from "
        f"replays {replayed}")
    if replays <= 0 or replayed.get("top_k_mask", 0) <= 0 \
            or replayed.get("fused_ffn", 0) <= 0 \
            or counts.get("flash_decode_sp", 0):
        raise AssertionError(f"{tag}: {replays} replays, launches from "
                             f"replays {replayed}, all {counts}")


def _spec_tokens(events) -> list:
    """A stream's tokens as strings, its prompt first (one section)."""
    return events[0]["prompt_tokens"] + [
        t for e in events if e["event"] == "tokens" for t in e["texts"]]


def _spec_server(torch, tag: str, args: list) -> dict:
    """The spec phase on one solo server (``serve`` with ``args``): its
    warm-up captures the Medusa verify chunk's graph, a first lookup and a
    first beams request capture theirs; then, with the counts at 0 before
    each option, medusa=1 (a WAV twice, a MIDI, the MIDI's stream twice),
    lookup=1 and beams=4 (a WAV twice each): equal same-seed bytes, the
    stream's tokens the one-shot's, each option's kernels launched from
    replayed graphs; then the same requests on an eager server (every step
    issued from the host): the same bytes and events. -> {"counts": by
    option, "medusa_wav": bytes, "pipe": the pipeline}."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.decode import graphs
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve import shutdown_gracefully

    pipe = cli.pipeline_from_args(cli.parse_args(args))
    gen, cfg = pipe.generator, pipe.generator.cfg
    if pipe.medusa_heads is None:
        raise AssertionError(f"{tag}: no Medusa heads "
                             f"({pipe.medusa_unavailable})")
    log(f"[{tag}] D {cfg.d_model} H {cfg.n_head} Hkv {cfg.kv_heads} V "
        f"{cfg.vocab_size}: {len(pipe.medusa_heads['blocks'])} Medusa heads, "
        f"probe {json.dumps(pipe.medusa_probe)}")
    _require_xla_order(tag, pipe)
    t0 = time.perf_counter()
    pipe.warmup()
    for kw in ({"lookup": True}, {"beams": SPEC_BEAMS}):
        pipe.generate(SPEC_WAV["prompt"], seed=0, render_audio=False, **kw)
    torch.cuda.synchronize()
    log(f"[{tag}] warm-up with a lookup and a beams request "
        f"{time.perf_counter() - t0:.2f} s; {graphs.tally()}")
    server, thread, port = _serving(pipe)
    counts, got = {}, {}
    stream_q = "?stream=1&format=midi"
    try:
        for opt, extra in SPEC_OPTIONS.items():
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            replays0 = graphs.tally()["replays"]
            reqs = [("wav", SPEC_WAV, ""), ("wav_again", SPEC_WAV, "")]
            if opt == "medusa":
                reqs.append(("midi", SPEC_MIDI, "?format=midi"))
            for name, fields, query in reqs:
                reply = _post(port, {**fields, **extra}, query)
                _check_reply(f"{tag} {opt}", fields, query, reply)
                got[(opt, name)] = reply[1]
            if opt == "medusa":
                for name in ("stream", "stream_again"):
                    reply = _sse_post(port, {**SPEC_MIDI, **extra}, stream_q)
                    _check_stream(f"{tag} medusa stream", SPEC_MIDI,
                                  stream_q, reply, pipe)
                    got[(opt, name)] = _sans_timings(reply[2])
            torch.cuda.synchronize()
            counts[opt] = _build.launch_counts()
            _require_spec(f"{tag} {opt}", opt, counts[opt],
                          _build.replayed_counts(),
                          graphs.tally()["replays"] - replays0)
            if got[(opt, "wav")] != got[(opt, "wav_again")]:
                raise AssertionError(f"{tag} {opt}: same-seed WAV bytes "
                                     "differ")
            log(f"[{tag} {opt}] same-seed WAV bytes identical; launches "
                f"{counts[opt]}")
        if got[("medusa", "stream")] != got[("medusa", "stream_again")]:
            raise AssertionError(f"{tag}: same-seed medusa streams differ")
        one = pipe.generate(SPEC_MIDI["prompt"], seed=int(SPEC_MIDI["seed"]),
                            render_audio=False, medusa=True)
        if _spec_tokens(got[("medusa", "stream")]) != list(one.tokens):
            raise AssertionError(f"{tag}: the medusa stream's tokens are not "
                                 "the one-shot medusa decode's")
        log(f"[{tag}] medusa: same-seed streams identical, and their "
            f"{len(one.tokens)} tokens (prompt included) the one-shot's")
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)

    def eager_work(port):
        out = {opt: _post(port, {**SPEC_WAV, **extra}, "")[1]
               for opt, extra in SPEC_OPTIONS.items()}
        out["stream"] = _sans_timings(_sse_post(
            port, {**SPEC_MIDI, "medusa": "1"}, stream_q)[2])
        return out

    eager = _eager_replies(args, eager_work)
    for opt in SPEC_OPTIONS:
        if eager[opt] != got[(opt, "wav")]:
            raise AssertionError(f"{tag} {opt}: the eager loop's WAV differs "
                                 "from the graphs'")
    if eager["stream"] != got[("medusa", "stream")]:
        raise AssertionError(f"{tag}: the eager loop's medusa stream differs "
                             "from the graphs'")
    log(f"[{tag}] the eager loop (every step issued from the host) gives "
        "the graphs' bytes for medusa, lookup and beams, and their stream")
    return {"counts": counts, "medusa_wav": got[("medusa", "wav")],
            "pipe": pipe}


def _require_spec_shapes(seen: dict, models: dict) -> None:
    """Every kernel of the spec paths called at each of its SPEC_SHAPES on
    each model ({tag: (D, V, Dh)})."""
    for tag, (D, V, Dh) in models.items():
        width = {"fused_ffn": D, "top_k_mask": V, "flash_decode_sp": Dh,
                 "flash_attention": Dh}
        for name, rows in SPEC_SHAPES.items():
            miss = [r for r in rows if (r, width[name]) not in seen[name]]
            log(f"[spec {tag}] {name} called at {sorted(seen[name])}")
            if miss:
                raise AssertionError(f"spec {tag}: {name} was not called at "
                                     f"rows {miss} (width {width[name]})")


def _spec_coalesce(torch, solo_wav: bytes) -> dict:
    """`serve --coalesce` on demo_ckpt_a: a medusa request beside a burst of
    six plain requests, all at once. The medusa request decodes solo (the
    engine carries no Medusa rows, as under JAX's default): its bytes equal
    the solo server's; the plain ones ride the engine. -> launch counts."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve import shutdown_gracefully

    pipe = cli.pipeline_from_args(cli.parse_args(
        ["serve", "--coalesce", "--slots", str(ENGINE_SLOTS)]))
    pipe.warmup()
    server, thread, port = _serving(pipe)
    replies, errors = {}, []
    plan = [("medusa", {**SPEC_WAV, "medusa": "1"}, "")] + [
        (f"plain{i}", {"prompt": BURST_TEXTS[i % len(BURST_TEXTS)],
                       "seed": str(41 + i)}, "?format=midi")
        for i in range(6)]

    def hit(name, fields, query):
        try:
            replies[name] = (fields, query, _post(port, fields, query))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"{name}: {type(exc).__name__}: {exc}")

    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        admitted0 = pipe.batcher.stats["admitted"]
        threads = [threading.Thread(target=hit, args=a, daemon=True)
                   for a in plan]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        admitted = pipe.batcher.stats["admitted"] - admitted0
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    if errors or len(replies) != len(plan):
        raise AssertionError(f"spec coalesce: {errors or 'a request hung'}")
    for name, (fields, query, reply) in sorted(replies.items()):
        _check_reply(f"spec coalesce {name}", fields, query, reply)
    if replies["medusa"][2][1] != solo_wav:
        raise AssertionError("spec coalesce: the medusa request's bytes "
                             "differ from the solo server's")
    log(f"[spec coalesce] the medusa request beside the burst has the solo "
        f"server's bytes; {admitted} plain rows admitted to the engine; "
        f"launches {counts}")
    return counts


def spec_greedy(torch) -> None:
    """JAX's contract on an f32 copy of demo_ckpt_a (TF32 off): greedy
    medusa, lookup, draft (A drafting for itself) and tree verification
    give the plain greedy decode's tokens (generate_kv without refeed).
    Where one parts from it, the plain
    step's top-2 margin must be under GREEDY_MARGIN (a near tie that the
    block forward's other sums may break the other way)."""
    from eamg_tpu_torch.decode.api import _bucket, _to_device
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.decode.medusa import generate_medusa
    from eamg_tpu_torch.decode.medusa_tree import generate_medusa_tree
    from eamg_tpu_torch.decode.speculative import generate_prompt_lookup
    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_A
    from eamg_tpu_torch.tokenizer import (Vocab, closest_bpm_token,
                                          normalize_key_signature)
    from eamg_tpu_torch.tools.medusa import load_medusa_heads
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    ck = load_checkpoint(DEMO_CKPT_A)
    cfg = dataclasses.replace(ck["cfg"], dtype="float32")
    params = _to_device(ck["params"], torch.device("cuda"))

    def f32(node):
        if isinstance(node, dict):
            return {k: f32(v) for k, v in node.items()}
        if isinstance(node, list):
            return [f32(v) for v in node]
        return node.float()

    params = f32(params)
    heads = load_medusa_heads(os.path.join(DEMO_CKPT_A, "medusa_heads.pkl"))
    vocab = Vocab(ck["vocab"])
    eos, pad = vocab.get("[END_SEQUENCE]", -1), vocab.get("[PAD]", 0)
    toks = ["[START_SEQUENCE]", closest_bpm_token(vocab, 120),
            normalize_key_signature("C major"), "[INSTRUMENT] Violin",
            "[INSTRUMENT] Acoustic Grand Piano"]
    ids = vocab.encode([t for t in toks if t in vocab])
    p = len(ids)
    prompt = torch.full((1, _bucket(p)), pad, dtype=torch.int64,
                        device="cuda")
    prompt[0, :p] = torch.tensor(ids)
    common = dict(eos_id=eos, pad_id=pad, greedy=True)
    runs = {"medusa": (4, lambda L: generate_medusa(
                params, heads, prompt, p, prng.PRNGKey(0), cfg, L, gamma=4,
                **common)),
            "lookup": (8, lambda L: generate_prompt_lookup(
                params, prompt, p, prng.PRNGKey(0), cfg, L, gamma=8,
                ngram=3, **common)),
            # A drafting for itself: the draft's steps are the plain
            # decode's, the output the verify's argmax chain
            "draft": (4, lambda L: _draft_run(
                params, params, cfg, cfg, prompt, p, L, 4, 0, **common)),
            "tree": (4, lambda L: generate_medusa_tree(
                params, heads, prompt, p, cfg, L, eos_id=eos, pad_id=pad))}
    for name, (gamma, run) in runs.items():
        L = min(cfg.seq_len, cfg.n_pos - gamma)
        buf, n, steps = run(L)
        plain, n_plain = generate_kv(params, prompt, p, prng.PRNGKey(0), cfg,
                                     L, refeed_last_prompt=False, **common)
        spec = buf[0, :n].tolist()
        ref = plain[0, :n_plain].cpu().tolist()
        at = next((i for i, (a, b) in enumerate(zip(spec, ref)) if a != b),
                  None if len(spec) == len(ref) else min(len(spec),
                                                         len(ref)))
        log(f"[spec greedy] f32 demo_ckpt_a, {name} (gamma {gamma}, max_len "
            f"{L}): {n - p} tokens in {steps} verify steps "
            f"({(n - p - 1) / max(steps, 1):.3f} tokens a verify after the "
            f"first); plain greedy {n_plain - p} tokens; first difference "
            f"{'none' if at is None else at}")
        if at is None:
            continue
        logits = gpt.forward(params, plain[:, :at], cfg)[0, -1]
        top2 = logits.topk(2).values
        margin = (top2[0] - top2[1]).item()
        log(f"[spec greedy] {name} parts from the plain greedy decode at "
            f"position {at}: the plain step's top-2 margin {margin:.3e} "
            f"(limit {GREEDY_MARGIN:.0e})")
        if not margin < GREEDY_MARGIN:
            raise AssertionError(f"spec greedy: {name} parts at {at} with a "
                                 f"top-2 margin of {margin}")


def spec_measure(torch, tag: str, pipe) -> dict:
    """On the served (bf16) model: Medusa and lookup sampled (SPEC_SEEDS)
    and greedy, with their tokens a verify step and decode rates, beside
    the plain solo decode (generate_kv as served) of the same prompt and
    seeds; beams (K 4) and its ms a step; one traced decode of each: host
    launch calls and device kernels a token, the device's idle share."""
    from eamg_tpu_torch.decode.api import _bucket
    from eamg_tpu_torch.decode.beam import generate_beam
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.decode.medusa import generate_medusa
    from eamg_tpu_torch.decode.speculative import generate_prompt_lookup
    from eamg_tpu_torch.emotion import get_music_params
    from eamg_tpu_torch.utils import prng

    gen = pipe.generator
    cfg = gen.cfg
    label = pipe.classifier.predict(SPEC_WAV["prompt"])
    _, ids, _ = pipe._prompt_for(get_music_params(label, seed=7))
    p = len(ids)
    prompt = torch.full((1, _bucket(p)), gen.pad_id, dtype=torch.int64,
                        device="cuda")
    prompt[0, :p] = torch.tensor(ids)
    full = gen.max_supported_len()
    common = dict(eos_id=gen.eos_id, pad_id=gen.pad_id)

    def medusa(seed, greedy):
        return generate_medusa(gen.params, pipe.medusa_heads, prompt, p,
                               prng.PRNGKey(seed), cfg,
                               min(full, cfg.n_pos - 4), greedy=greedy,
                               **common)

    def lookup(seed, greedy):
        return generate_prompt_lookup(gen.params, prompt, p,
                                      prng.PRNGKey(seed), cfg,
                                      min(full, cfg.n_pos - 8), greedy=greedy,
                                      **common)

    def plain(seed, greedy):
        buf, n = generate_kv(gen.params, prompt, p, prng.PRNGKey(seed), cfg,
                             full, greedy=greedy, **common)
        return buf, n, None

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out = {"prompt_len": p}
    for name, fn in (("plain", plain), ("medusa", medusa),
                     ("lookup", lookup)):
        for greedy in (False, True):
            fn(0, greedy)                          # captures its graph
            rows = []
            for seed in (SPEC_SEEDS if not greedy else (0,)):
                (buf, n, steps), secs = timed(fn, seed, greedy)
                rows.append({"seed": seed, "tokens": n - p, "s": secs,
                             "tokens_per_s": (n - p) / secs,
                             "verify_steps": steps,
                             "tokens_per_verify": None if steps is None
                             else (n - p - 1) / max(steps, 1)})
            mode = "greedy" if greedy else "sampled"
            tok = sum(r["tokens"] for r in rows)
            secs = sum(r["s"] for r in rows)
            steps = None if rows[0]["verify_steps"] is None else \
                sum(r["verify_steps"] for r in rows)
            out[f"{name}_{mode}"] = {
                "tokens": tok, "tokens_per_s": tok / secs,
                "tokens_per_verify": None if steps is None
                else (tok - len(rows)) / max(steps, 1), "runs": rows}
            log(f"[spec {tag}] {name} {mode}: {tok} tokens in {secs:.3f} s, "
                f"{tok / secs:.1f} tokens/s"
                + ("" if steps is None else
                   f", {steps} verify steps, "
                   f"{(tok - len(rows)) / max(steps, 1):.3f} tokens a verify "
                   "after the first token"))
    (buf, gl, sc), secs = timed(lambda: generate_beam(
        gen.params, prompt, p, cfg, full, n_beams=SPEC_BEAMS, **common))
    (buf, gl, sc), secs = timed(lambda: generate_beam(
        gen.params, prompt, p, cfg, full, n_beams=SPEC_BEAMS, **common))
    steps = int(gl.max()) - 1
    out["beams"] = {"K": SPEC_BEAMS, "steps": steps, "s": secs,
                    "ms_per_step": 1000 * secs / max(steps, 1)}
    log(f"[spec {tag}] beams K {SPEC_BEAMS}: {steps} steps in {secs:.3f} s, "
        f"{out['beams']['ms_per_step']:.4f} ms a step (prefill included)")
    traced = {"plain": lambda: plain(1, False)[1] - p,
              "medusa": lambda: medusa(1, False)[1] - p,
              "lookup": lambda: lookup(1, False)[1] - p,
              "beams": lambda: int(generate_beam(
                  gen.params, prompt, p, cfg, full, n_beams=SPEC_BEAMS,
                  **common)[1].max()) * SPEC_BEAMS}
    for name, work in traced.items():
        prof = _trace(torch, f"spec {tag} {name}", work)
        out[f"trace_{name}"] = {k: prof[k] for k in (
            "n_tokens", "wall_ms", "device_busy_ms", "idle_share",
            "launches_per_token", "host_launches_per_token",
            "graph_replays")}
    for name in ("medusa", "lookup"):
        r, pl = out[f"{name}_sampled"], out["plain_sampled"]
        log(f"[spec {tag}] {name} sampled: {r['tokens_per_s']:.1f} tokens/s "
            f"beside the plain solo decode's {pl['tokens_per_s']:.1f} "
            f"({r['tokens_per_s'] / pl['tokens_per_s']:.3f}x), "
            f"{r['tokens_per_verify']:.3f} tokens a verify; host launch "
            f"calls a token {out[f'trace_{name}']['host_launches_per_token']:.3f}"
            f" (plain {out['trace_plain']['host_launches_per_token']:.3f})")
    log(json.dumps({"spec_measure": {tag: out}}))
    return out


def serve_spec(torch) -> dict:
    """Phase spec: the page's decode options on demo_ckpt_a and
    demo_ckpt_b3, solo (_spec_server), the kernels at their shapes; medusa
    beside an engine burst under `serve --coalesce`; the greedy check on
    an f32 copy of A; the measurements. -> launch counts by path."""
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_B3

    counts = {}
    with _shapes_seen() as seen:
        a = _spec_server(torch, "spec a", ["serve"])
        b3 = _spec_server(torch, "spec b3",
                          ["serve", "--checkpoint", DEMO_CKPT_B3])
    models = {}
    for tag, r in (("a", a), ("b3", b3)):
        cfg = r["pipe"].generator.cfg
        models[tag] = (cfg.d_model, cfg.vocab_size, cfg.head_dim)
        counts.update({f"spec {tag} {opt}": c
                       for opt, c in r["counts"].items()})
    _require_spec_shapes(seen, models)
    counts["spec coalesce"] = _spec_coalesce(torch, a["medusa_wav"])
    spec_greedy(torch)
    for tag, r in (("a", a), ("b3", b3)):
        spec_measure(torch, tag, r["pipe"])
    return counts


# ------------------------------------------------------------------ spec2

# the spec2 phase: draft speculation, Medusa rows in the engine, the tree
# verify, head training and /profile
SPEC2_LEN = 256                 # max_len of the draft runs and the timing
SPEC2_SEEDS = (0, 1)
# a bf16 greedy speculative decode may part from the plain greedy decode
# only where the plain step's top-2 logits lie this close: the verify's
# products round the bf16 hidden state elsewhere than the step's kernels,
# by up to a bf16 ulp (2^-8 relative), which moves a logit of magnitude
# ~10 by up to ~0.05
BF16_GREEDY_MARGIN = 0.125
# the trained pair: a target and a draft on the same synthetic rows and
# seed, a few steps each. The presets pick different schemes (large2 B2's
# fixed 8324 tokens, mini Scheme A's vocabulary of the rows), so the
# draft takes the target's scheme to share its vocabulary
PAIR_ARGS = {"target": ["--preset", "large2", "--corrected"],
             "draft": ["--preset", "mini", "--corrected", "--scheme", "b2"]}
PAIR_ROWS = "48"
ENGINE_MED_ARGS = ["serve", "--coalesce", "--slots", str(ENGINE_SLOTS),
                   "--engine-medusa"]
# the burst of ten on the Medusa engine: four medusa=1 (the last one
# streamed) and six plain, MIDI replies
SPEC2_MEDUSA = [({"prompt": BURST_TEXTS[i % len(BURST_TEXTS)],
                  "seed": str(61 + i), "medusa": "1"},
                 "?stream=1&format=midi" if i == 3 else "?format=midi")
                for i in range(4)]
SPEC2_PLAIN = [({"prompt": BURST_TEXTS[i % len(BURST_TEXTS)],
                 "seed": str(81 + i)}, "?format=midi") for i in range(6)]
# train-medusa on demo_ckpt_b3, cut from JAX's 4000 rows x 4 epochs
MEDUSA_TRAIN_ROWS, MEDUSA_TRAIN_EPOCHS = 512, 1
HEAD_HOST_STEPS = 3
HEAD_LOSS_RTOL = 1e-4           # a head step's loss, card against host
SPEC2_KERNELS = ("flash_attention", "fused_ffn", "flash_decode_sp",
                 "top_k_mask", "flash_decode_fold_sp")


def _draft_run(params_t, params_d, cfg_t, cfg_d, prompt, p: int, L: int,
               gamma: int, seed: int, eager: bool = False, **common):
    """generate_speculative's run on its own pooled state, with its verify
    steps: -> (tokens [1, L], n_tokens, verify steps)."""
    from eamg_tpu_torch.decode import graphs
    from eamg_tpu_torch.decode.speculative import (K_VERIFIES, run_to_end,
                                                   spec_state)
    from eamg_tpu_torch.utils import prng

    common = {"greedy": False, "eos_id": -1, "pad_id": 0, **common}
    key, make = spec_state(params_t, cfg_t, "draft", L, gamma, K_VERIFIES,
                           50, common["greedy"], 1.0, 0.0, common["eos_id"],
                           common["pad_id"], prompt.device, eager=eager,
                           draft=(params_d, cfg_d))
    with graphs.pooled(key, make) as st:
        return run_to_end(st, prompt, p, prng.PRNGKey(seed), 1.0, 1.0, 0.0)


def _a_prompt(torch, vocab):
    """A Scheme-A control prompt (120 BPM, C major, violin and piano) as a
    [1, bucket] tensor on the card, and its length."""
    from eamg_tpu_torch.decode.api import _bucket
    from eamg_tpu_torch.tokenizer import (closest_bpm_token,
                                          normalize_key_signature)

    toks = ["[START_SEQUENCE]", closest_bpm_token(vocab, 120),
            normalize_key_signature("C major"), "[INSTRUMENT] Violin",
            "[INSTRUMENT] Acoustic Grand Piano"]
    ids = vocab.encode([t for t in toks if t in vocab])
    prompt = torch.full((1, _bucket(len(ids))), vocab.get("[PAD]", 0),
                        dtype=torch.int64, device="cuda")
    prompt[0, :len(ids)] = torch.tensor(ids)
    return prompt, len(ids)


def _greedy_parting(torch, tag: str, params, cfg, got: list, ref: list,
                    margin_limit: float) -> None:
    """Hold a greedy token list to the plain greedy decode's: equal, or
    parting where the plain step's top-2 logits lie within
    ``margin_limit``."""
    from eamg_tpu_torch.models import gpt

    at = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
              None if len(got) == len(ref) else min(len(got), len(ref)))
    if at is None:
        log(f"[{tag}] equal to the plain greedy decode ({len(got)} tokens)")
        return
    ids = torch.tensor([ref[:at]], device="cuda")
    top2 = gpt.forward(params, ids, cfg)[0, -1].topk(2).values
    margin = (top2[0] - top2[1]).item()
    log(f"[{tag}] parts from the plain greedy decode at position {at}: "
        f"the plain step's top-2 margin {margin:.3e} (limit "
        f"{margin_limit:.0e})")
    if not margin < margin_limit:
        raise AssertionError(f"{tag}: parts at {at} with a top-2 margin of "
                             f"{margin}")


def _timed_run(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def spec2_draft(torch, tmp: str) -> dict:
    """Draft speculation at full width. demo_ckpt_a (bf16) drafting for
    itself: greedy against the plain greedy decode (a parting only at a
    near tie), sampled (SPEC2_SEEDS) with its tokens a verify and rate
    beside the plain solo decode, the graphs' tokens equal to the eager
    loop's. Then a trained pair: `cli train --preset large2 --corrected`
    (target) and `--preset mini --corrected --scheme b2` (draft, d256 h4
    L2: K3 at Dh 64) on the same synthetic rows and seed, a few steps each: one
    vocabulary, sampled tokens from graphs equal to the eager loop's,
    tokens a verify and rates beside the target's plain decode."""
    from eamg_tpu_torch.decode.api import _to_device
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_A
    from eamg_tpu_torch.tokenizer import Vocab
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    out = {}
    ck = load_checkpoint(DEMO_CKPT_A)
    cfg, vocab = ck["cfg"], Vocab(ck["vocab"])
    params = _to_device(ck["params"], torch.device("cuda"))
    L = min(SPEC2_LEN, cfg.n_pos - 4)

    def rows(tag, pt, pd, cfg_t, cfg_d, greedy_check, prompt, p, pad):
        common = dict(eos_id=-1, pad_id=pad)
        res = {}
        for greedy in (True, False):
            seeds = (0,) if greedy else SPEC2_SEEDS
            _draft_run(pt, pd, cfg_t, cfg_d, prompt, p, L, 4, 0,
                       greedy=greedy, **common)        # captures its graph
            generate_kv(pt, prompt, p, prng.PRNGKey(0), cfg_t, L,
                        greedy=greedy, refeed_last_prompt=False, **common)
            tok = ver = 0
            t_draft = t_plain = 0.0
            for seed in seeds:
                (buf, n, steps), secs = _timed_run(torch, lambda: _draft_run(
                    pt, pd, cfg_t, cfg_d, prompt, p, L, 4, seed,
                    greedy=greedy, **common))
                (pbuf, pn), psecs = _timed_run(torch, lambda: generate_kv(
                    pt, prompt, p, prng.PRNGKey(seed), cfg_t, L,
                    greedy=greedy, refeed_last_prompt=False, **common))
                tok, ver = tok + n - p - 1, ver + steps
                t_draft, t_plain = t_draft + secs, t_plain + psecs
                if greedy and greedy_check is not None:
                    _greedy_parting(torch, f"spec2 {tag} greedy", pt, cfg_t,
                                    buf[0, :n].tolist(),
                                    pbuf[0, :pn].cpu().tolist(),
                                    greedy_check)
                if not greedy and seed == seeds[0]:
                    eb, en, _ = _draft_run(pt, pd, cfg_t, cfg_d, prompt, p,
                                           L, 4, seed, eager=True, **common)
                    if eb[0, :en].tolist() != buf[0, :n].tolist():
                        raise AssertionError(f"spec2 {tag}: the eager loop's "
                                             "tokens differ from the graphs'")
                    log(f"[spec2 {tag}] sampled seed {seed}: the eager "
                        "loop's tokens are the graphs'")
            mode = "greedy" if greedy else "sampled"
            res[mode] = {"tokens_per_verify": tok / max(ver, 1),
                         "tokens_per_s": (tok + len(seeds)) / t_draft,
                         "plain_tokens_per_s": (L - p) * len(seeds)
                         / t_plain, "verify_steps": ver}
            log(f"[spec2 {tag}] {mode}: {res[mode]['tokens_per_verify']:.3f}"
                f" tokens a verify after the first token, "
                f"{res[mode]['tokens_per_s']:.1f} tokens/s beside the plain "
                f"solo decode's {res[mode]['plain_tokens_per_s']:.1f} "
                f"(max_len {L}, gamma 4)")
        return res

    out["self_a"] = rows("self-draft a", params, params, cfg, cfg,
                         BF16_GREEDY_MARGIN, *_a_prompt(torch, vocab),
                         vocab.get("[PAD]", 0))
    paths = {}
    for tag, argv in PAIR_ARGS.items():
        paths[tag] = os.path.join(tmp, f"pair_{tag}")
        _cli_run(f"spec2 train {tag}", [
            "train", *argv, "--synthetic", PAIR_ROWS, "--epochs", "1",
            "--seed", "0", "--log-every", "0", "--device", "cuda",
            "--out", paths[tag]])
    ct = load_checkpoint(os.path.join(paths["target"], "final"))
    cd = load_checkpoint(os.path.join(paths["draft"], "final"))
    if ct["vocab"] != cd["vocab"]:
        raise AssertionError("spec2: the trained pair's vocabularies differ")
    log(f"[spec2 pair] target {ct['cfg']}; draft {cd['cfg']}; one "
        f"vocabulary of {len(ct['vocab'])}")
    # a one-token prompt of the pair's vocabulary (id 1)
    out["pair"] = rows("pair", _to_device(ct["params"], torch.device("cuda")),
                       _to_device(cd["params"], torch.device("cuda")),
                       ct["cfg"], cd["cfg"], None,
                       torch.tensor([[1]], device="cuda"), 1, 0)
    return out


def _replies(port: int, plan: list) -> dict:
    """POST every (fields, query) of ``plan`` at once -> index -> reply;
    a streamed request's reply is its SSE result."""
    replies, errors = {}, []

    def hit(i, fields, query):
        try:
            replies[i] = _sse_post(port, fields, query) \
                if "stream=1" in query else _post(port, fields, query)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"{i}: {type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=hit, args=(i, f, q), daemon=True)
               for i, (f, q) in enumerate(plan)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or len(replies) != len(plan):
        raise AssertionError(f"spec2 burst: {errors or 'a request hung'}")
    return replies


def _reply_tokens(reply) -> int:
    if len(reply) == 5:                                  # a stream's
        return sum(len(e["ids"]) for e in reply[2] if e["event"] == "tokens")
    return int(reply[2].get("X-EAMG-Tokens", "0"))


def _stream_key(reply):
    """A stream's token ids and its done event's MIDI."""
    events = reply[2]
    if reply[0] != 200 or events[-1]["event"] != "done":
        raise AssertionError(f"spec2 stream: {reply[0]} {events[-1:]}")
    return ([t for e in events if e["event"] == "tokens" for t in e["ids"]],
            events[-1]["midi_b64"])


def spec2_engine(torch) -> dict:
    """Medusa rows in the engine at full width (demo_ckpt_a, bf16): the
    solo server's replies to SPEC2_MEDUSA; a default engine of the Medusa
    engine's budget (max_len n_pos - gamma) serving SPEC2_PLAIN at once
    and the burst of ten as plain requests; `serve --coalesce --slots 8
    --engine-medusa` (its warm-up captures the plain and the Medusa chunk
    graphs): SPEC2_PLAIN at once with no Medusa row live (the plain chunk
    program: the default engine's bytes), then the burst of ten, each
    Medusa reply equal to the solo server's (the stream's tokens and MIDI
    too), the plain replies logged beside the default engine's; aggregate
    rates of both engines; GET /profile on the Medusa engine's server: a
    trace file in its trace_dir."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.decode import graphs
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve import shutdown_gracefully
    from eamg_tpu_torch.serve.pipeline import (DEMO_CKPT_A,
                                               pipeline_from_checkpoint)

    def serving(pipe, work):
        server, thread, port = _serving(pipe)
        try:
            return work(port)
        finally:
            server.shutdown()
            shutdown_gracefully(server, pipe)
            thread.join(timeout=30)

    out = {}
    solo = cli.pipeline_from_args(cli.parse_args(["serve"]))
    solo.warmup()
    want = serving(solo, lambda port: {
        i: (_sse_post(port, f, q) if "stream=1" in q else _post(port, f, q))
        for i, (f, q) in enumerate(SPEC2_MEDUSA)})
    del solo
    med = cli.pipeline_from_args(cli.parse_args(ENGINE_MED_ARGS))
    eng = med.batcher
    if not eng.medusa:
        raise AssertionError("spec2: --engine-medusa built no Medusa engine")
    t0 = time.perf_counter()
    med.warmup()
    log(f"[spec2 engine] Medusa engine: gamma {eng.gamma}, max_len "
        f"{eng.max_len}, chunk {eng.chunk}, Medusa chunk {eng.chunk_med}; "
        f"warm-up {time.perf_counter() - t0:.1f} s; {graphs.tally()}")
    default = pipeline_from_checkpoint(
        DEMO_CKPT_A, device="cuda", coalesce="continuous",
        coalesce_opts={"slots": ENGINE_SLOTS, "max_len": eng.max_len})
    default.warmup()
    burst = SPEC2_MEDUSA + SPEC2_PLAIN
    as_plain = [({k: v for k, v in f.items() if k != "medusa"},
                 "?format=midi") for f, _ in burst]

    def timed_burst(port, plan):
        t0 = time.perf_counter()
        r = _replies(port, plan)
        return r, time.perf_counter() - t0

    base = serving(default, lambda port: {
        "plain": timed_burst(port, SPEC2_PLAIN),
        "ten": timed_burst(port, as_plain)})

    def med_work(port):
        res = {}
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        tally0 = graphs.tally()
        res["plain"] = timed_burst(port, SPEC2_PLAIN)
        res["plain_replays"] = graphs.tally()["replays"] - tally0["replays"]
        admitted0 = eng.stats["admitted"]
        res["ten"] = timed_burst(port, burst)
        torch.cuda.synchronize()
        res["admitted"] = eng.stats["admitted"] - admitted0
        res["counts"] = _build.launch_counts()
        res["replayed"] = _build.replayed_counts()
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            trace_dir = os.path.join(tmp, "profile")
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/profile?dir={trace_dir}",
                    timeout=600) as r:
                body = json.loads(r.read())
                status = r.status
            trace = os.path.join(body["trace_dir"], "trace.json")
            size = os.path.getsize(trace) if os.path.isfile(trace) else 0
        log(f"[spec2 profile] GET /profile: HTTP {status}, {body}, "
            f"trace.json {size} bytes")
        if status != 200 or body["trace_dir"] != trace_dir or size <= 0:
            raise AssertionError(f"spec2: /profile {status} {body} {size}")
        return res

    got = serving(med, med_work)
    for i, (fields, query) in enumerate(SPEC2_PLAIN):
        if got["plain"][0][i][1] != base["plain"][0][i][1]:
            raise AssertionError(f"spec2: plain request {i} with no live "
                                 "Medusa row differs from the default "
                                 "engine's bytes")
    log(f"[spec2 engine] {len(SPEC2_PLAIN)} plain requests at once with no "
        f"live Medusa row: the default engine's bytes "
        f"({got['plain_replays']} graph replays)")
    replies = got["ten"][0]
    for i, (fields, query) in enumerate(SPEC2_MEDUSA):
        if "stream=1" in query:
            if _stream_key(replies[i]) != _stream_key(want[i]):
                raise AssertionError(f"spec2: streamed Medusa row {i} "
                                     "differs from the solo server's")
        else:
            _check_reply(f"spec2 engine medusa {i}", fields, query,
                         replies[i])
            if replies[i][1] != want[i][1]:
                raise AssertionError(f"spec2: Medusa row {i} differs from "
                                     "the solo server's bytes")
    log(f"[spec2 engine] {len(SPEC2_MEDUSA)} Medusa rows in the burst of "
        f"ten (one streamed): the solo server's bytes and tokens")
    same = [replies[len(SPEC2_MEDUSA) + i][1] == base["ten"][0][
        len(SPEC2_MEDUSA) + i][1] for i in range(len(SPEC2_PLAIN))]
    log(f"[spec2 engine] plain rows inside Medusa chunks equal to the "
        f"default engine's bytes: {same} (plain products of the verify "
        "block, not row 8's kernel: bits may part on the card)")
    if got["admitted"] < len(burst):
        raise AssertionError(f"spec2: {got['admitted']} rows admitted to the "
                             f"Medusa engine for a burst of {len(burst)}")
    for name in ("flash_attention", "fused_ffn", "top_k_mask",
                 "flash_decode_fold_sp"):
        if got["counts"].get(name, 0) <= 0:
            raise AssertionError(f"spec2 engine: {name} was not launched")
    rates = {}
    for tag, (r, secs) in (("default_plain", base["plain"]),
                           ("medusa_engine_plain", got["plain"]),
                           ("default_ten", base["ten"]),
                           ("medusa_engine_ten", got["ten"])):
        tok = sum(_reply_tokens(x) for x in r.values())
        rates[tag] = {"tokens": tok, "s": secs, "tokens_per_s": tok / secs}
    log(f"[spec2 engine] aggregate rates: " + ", ".join(
        f"{k} {v['tokens_per_s']:.1f} tokens/s ({v['tokens']} tokens in "
        f"{v['s']:.3f} s)" for k, v in rates.items()))
    out.update(rates=rates, counts=got["counts"], replayed=got["replayed"],
               plain_rows_equal=same)
    return out


def spec2_engine_greedy(torch) -> None:
    """An engine on an f32 copy of demo_ckpt_a (TF32 off), greedy, with
    Medusa heads: one Medusa row and two plain rows at once. The Medusa
    row equals its solo greedy Medusa decode; every row equals the plain
    greedy decode or parts from it only at a near tie (GREEDY_MARGIN): the
    plain rows inside Medusa chunks are computed from the verify block's
    first query."""
    import dataclasses as dc

    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.decode.medusa import generate_medusa
    from eamg_tpu_torch.serve.continuous import ContinuousBatcher
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_A
    from eamg_tpu_torch.tokenizer import Vocab
    from eamg_tpu_torch.tools.medusa import load_medusa_heads
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    ck = load_checkpoint(DEMO_CKPT_A)
    cfg = dc.replace(ck["cfg"], dtype="float32")

    def f32(node):
        if isinstance(node, dict):
            return {k: f32(v) for k, v in node.items()}
        if isinstance(node, list):
            return [f32(v) for v in node]
        return node.float()

    vocab = Vocab(ck["vocab"])
    gen = Generator(f32(ck["params"]), cfg, vocab, device="cuda")
    heads = load_medusa_heads(os.path.join(DEMO_CKPT_A, "medusa_heads.pkl"))
    eng = ContinuousBatcher(gen, slots=4, chunk=32, greedy=True,
                            medusa_heads=heads)
    prompt, p = _a_prompt(torch, vocab)
    ids = prompt[0, :p].tolist()
    try:
        results = {}

        def hit(name, medusa, seed):
            results[name] = eng.submit(ids, seed=seed, medusa=medusa)

        threads = [threading.Thread(target=hit, args=a, daemon=True)
                   for a in (("medusa", True, 1), ("plain0", False, 2),
                             ("plain1", False, 3))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        eng.close()
    L = eng.max_len
    solo, n, _ = generate_medusa(gen.params, heads, prompt, p,
                                 prng.PRNGKey(1), cfg, L,
                                 gamma=len(heads["blocks"]), greedy=True,
                                 eos_id=gen.eos_id, pad_id=gen.pad_id)
    if results["medusa"] != solo[0, :n].tolist():
        raise AssertionError("spec2 engine greedy f32: the Medusa row "
                             "differs from its solo greedy decode")
    plain, pn = generate_kv(gen.params, prompt, p, prng.PRNGKey(0), cfg, L,
                            greedy=True, refeed_last_prompt=False,
                            eos_id=gen.eos_id, pad_id=gen.pad_id)
    ref = plain[0, :pn].cpu().tolist()
    for name, toks in sorted(results.items()):
        _greedy_parting(torch, f"spec2 engine greedy f32 {name}", gen.params,
                        cfg, toks, ref, GREEDY_MARGIN)


def spec2_tree(torch) -> dict:
    """`medusa-measure --tree` on both demos (the shipped heads, reps 3,
    max_len 256 or, on B3, the most its 255 positions leave the linear
    verify's overshoot of 4: 251): plain, linear and tree tokens/s, tokens
    a verify."""
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_A, DEMO_CKPT_B3
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    out = {}
    for tag, path in (("a", DEMO_CKPT_A), ("b3", DEMO_CKPT_B3)):
        L = min(SPEC2_LEN, load_checkpoint(path)["cfg"].n_pos - 4)
        lines = _cli_run(f"spec2 tree {tag}", [
            "medusa-measure", "--tree", "--ckpt", path, "--reps", "3",
            "--max-len", str(L), "--device", "cuda"])
        out[tag] = json.loads(lines[-1])["tree"]
    return out


def spec2_train_medusa(torch, tmp: str) -> dict:
    """`cli train-medusa` on demo_ckpt_b3, cut from JAX's 4000 rows x 4
    epochs to MEDUSA_TRAIN_ROWS x MEDUSA_TRAIN_EPOCHS; first its first
    HEAD_HOST_STEPS steps on an f32 copy of B3, on the card (K1, K2 in the
    frozen forward) and on the host (plain versions) from the same zero
    heads and batches: each loss within HEAD_LOSS_RTOL; the run's final
    loss below the first step's; its pickle beside B3's files serves a
    medusa=1 request."""
    import dataclasses as dc

    import numpy as np

    from eamg_tpu_torch.decode.api import _to_device
    from eamg_tpu_torch.decode.medusa import init_medusa_heads
    from eamg_tpu_torch.serve.pipeline import (DEMO_CKPT_B3,
                                               pipeline_from_checkpoint)
    from eamg_tpu_torch.tools.medusa import (MedusaSpec, _corpus_for,
                                             head_optimizer, head_step,
                                             heads_leaves)
    from eamg_tpu_torch.train.data import pad_rows
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    ck = load_checkpoint(DEMO_CKPT_B3)
    cfg = dc.replace(ck["cfg"], dtype="float32")
    spec = MedusaSpec(rows=MEDUSA_TRAIN_ROWS, epochs=MEDUSA_TRAIN_EPOCHS)
    encoded, vocab = _corpus_for(ck, spec.rows, spec.seed)
    ids = pad_rows(encoded, cfg.seq_len, vocab.pad_id)
    order = np.random.default_rng(spec.seed).permutation(ids.shape[0])
    losses = {}
    for dev in ("cuda", "cpu"):
        base = _f32_tree(_to_device(ck["params"], torch.device(dev)))
        blocks = [{k: v.to(dev) for k, v in b.items()} for b in
                  init_medusa_heads(None, cfg, spec.n_heads)["blocks"]]
        opt = head_optimizer(spec)
        state = opt.init(heads_leaves(blocks))
        losses[dev] = []
        for s in range(HEAD_HOST_STEPS):
            batch = torch.from_numpy(
                ids[order[s * spec.batch:(s + 1) * spec.batch]]).to(dev)
            losses[dev].append(float(head_step(base, blocks, opt, state,
                                               batch, cfg, vocab.pad_id)))
    log(f"[spec2 train-medusa] f32 B3, first {HEAD_HOST_STEPS} head steps: "
        f"card {losses['cuda']}, host {losses['cpu']}")
    for a, b in zip(losses["cuda"], losses["cpu"]):
        if not abs(a - b) <= HEAD_LOSS_RTOL * abs(b):
            raise AssertionError(f"spec2 train-medusa: card loss {a} against "
                                 f"host {b}")
    serve_dir = os.path.join(tmp, "b3_heads")
    os.makedirs(serve_dir)
    for f in os.listdir(DEMO_CKPT_B3):
        if f != "medusa_heads.pkl":
            os.symlink(os.path.join(DEMO_CKPT_B3, f),
                       os.path.join(serve_dir, f))
    pkl = os.path.join(serve_dir, "medusa_heads.pkl")
    t0 = time.perf_counter()
    lines = _cli_run("spec2 train-medusa", [
        "train-medusa", "--ckpt", DEMO_CKPT_B3, "--out", pkl, "--rows",
        str(MEDUSA_TRAIN_ROWS), "--epochs", str(MEDUSA_TRAIN_EPOCHS),
        "--device", "cuda"])
    secs = time.perf_counter() - t0
    res = json.loads(lines[-1])["train"]
    first = losses["cuda"][0]
    log(f"[spec2 train-medusa] bf16 B3, {MEDUSA_TRAIN_ROWS} rows x "
        f"{MEDUSA_TRAIN_EPOCHS} epoch: final loss {res['final_loss']:.4f} "
        f"(the f32 copy's first step {first:.4f}), {secs:.1f} s, probe "
        f"{json.dumps(res['probe'])}")
    if not res["final_loss"] < first:
        raise AssertionError("spec2 train-medusa: the head loss did not fall")
    pipe = pipeline_from_checkpoint(serve_dir, device="cuda")
    if pipe.medusa_heads is None:
        raise AssertionError(f"spec2: the trained heads do not serve "
                             f"({pipe.medusa_unavailable})")
    r = pipe.generate(BURST_TEXTS[0], seed=7, render_audio=False,
                      medusa=True)
    if r.midi_bytes[:4] != b"MThd" or len(r.tokens) <= 3:
        raise AssertionError("spec2: the trained heads' medusa request gave "
                             "no song")
    log(f"[spec2 train-medusa] the written heads serve a medusa=1 request: "
        f"{len(r.tokens)} tokens, {len(r.midi_bytes)} MIDI bytes")
    return {"losses": losses, "final_loss": res["final_loss"],
            "train_s": secs, "probe": res["probe"]}


def _f32_tree(node):
    if isinstance(node, dict):
        return {k: _f32_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_f32_tree(v) for v in node]
    return node.float()


def serve_spec2(torch) -> dict:
    """Phase spec2: draft speculation, Medusa rows in the engine (bf16
    burst and an f32 greedy engine), the tree verify's measure on both
    demos, head training and /profile. -> launch counts over the phase."""
    import tempfile

    from eamg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        draft = spec2_draft(torch, tmp)
        engine = spec2_engine(torch)
        spec2_engine_greedy(torch)
        tree = spec2_tree(torch)
        train = spec2_train_medusa(torch, tmp)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    for name in SPEC2_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"spec2: {name} was not launched")
    log(json.dumps({"spec2": {"draft": draft, "engine": engine,
                              "tree": tree, "train_medusa": train,
                              "launches": counts}}, default=str))
    log(f"[spec2] phase {time.perf_counter() - t0:.1f} s; launches {counts}")
    return {"spec2": counts}


# the options phase: the grammar and the history-dependent options of the
# page, solo on both demos, then on an engine and a window batcher built
# for them
OPTION_WAV = {"prompt": BURST_TEXTS[0], "seed": "7", "grammar": "1"}
OPTION_MIDI = {"prompt": BURST_TEXTS[1], "seed": "11", "grammar": "1"}
OPTION_HISTORY = {"repetition_penalty": "1.3", "presence_penalty": "0.5",
                  "no_repeat_ngram": "3"}
# name -> (form, query): the solo requests of each demo; "wav" is sent
# twice (same bytes)
OPTION_SOLO = {"wav": (OPTION_WAV, ""),
               "midi": (OPTION_MIDI, "?format=midi"),
               "stream": (OPTION_MIDI, "?stream=1&format=midi"),
               "beams": ({**OPTION_WAV, "beams": "4"}, ""),
               "composed": ({**OPTION_WAV, **OPTION_HISTORY}, "")}
OPTION_ENGINE_ARGS = ["serve", "--coalesce", "--slots", str(ENGINE_SLOTS),
                      "--engine-top-p", "row", "--engine-ngram", "3",
                      "--engine-grammar"]
OPTION_WINDOW_ARGS = ["serve", "--coalesce", "window", "--slots", "4",
                      "--engine-grammar"]
# the engine's burst: name -> (form, query, streamed)
OPTION_BURST = {
    **{f"plain{i}": ({"prompt": BURST_TEXTS[i], "seed": str(61 + i)},
                     "?format=midi" if i % 2 else "", False)
       for i in range(3)},
    **{f"grammar{i}": ({"prompt": BURST_TEXTS[i + 1], "seed": str(64 + i),
                        "grammar": "1"}, "?format=midi", False)
       for i in range(3)},
    **{f"penalties{i}": ({"prompt": BURST_TEXTS[i], "seed": str(67 + i),
                          "repetition_penalty": "1.3",
                          "presence_penalty": "0.5"}, "", False)
       for i in range(2)},
    "ngram0": ({"prompt": BURST_TEXTS[3], "seed": "69",
                "no_repeat_ngram": "3"}, "?format=midi", False),
    "ngram_stream": ({"prompt": BURST_TEXTS[2], "seed": "70",
                      "no_repeat_ngram": "3"}, "?stream=1&format=midi",
                     True)}
OPTION_WINDOW = {f"window{i}": {"prompt": BURST_TEXTS[i], "seed": str(71 + i),
                                "grammar": "1", "repetition_penalty": "1.3",
                                "presence_penalty": "0.5"}
                 for i in range(4)}
OPTION_TRACE_SEEDS = (0, 1, 2)
# ten plain requests at once (five WAV, five MIDI), sent to the option
# engine and to a default engine: their bytes and aggregate rates
PLAIN_BURST = {f"plain_burst{i}": ({"prompt": BURST_TEXTS[i % 4],
                                    "seed": str(81 + i)},
                                   "?format=midi" if i % 2 else "", False)
               for i in range(10)}


@contextlib.contextmanager
def _recorded_decodes(pipe):
    """Record the tokens (prompt included) of every request ``pipe``
    decodes, by its decode seed: -> {seed: [tokens]}."""
    rec = {}
    real = pipe._decode

    def decode(mapping, temperature, top_k, run_seed, *a, **kw):
        out = real(mapping, temperature, top_k, run_seed, *a, **kw)
        rec[run_seed] = list(out[1])
        return out

    pipe._decode = decode
    try:
        yield rec
    finally:
        pipe._decode = real


def _grammar_ids(pipe, tokens) -> list:
    vocab = pipe.scheme_b.vocab if pipe.scheme == "b3" \
        else pipe.generator.vocab
    return vocab.encode(tokens)


def _require_grammar(tag: str, pipe, ids: list) -> None:
    """A grammar reply: no broken rule, and its END token within budget."""
    g = pipe.grammar()
    bad = g.violations(ids)
    budget = pipe.generator.max_supported_len()
    end = g.classes.index("END")
    ends = bool(ids) and int(g.tclass[ids[-1]]) == end
    log(f"[{tag}] {len(ids)} ids (prompt included): {bad} broken rules, "
        f"ends with its END token: {ends}, budget {budget}")
    if bad or not ends or len(ids) > budget:
        raise AssertionError(f"{tag}: {bad} broken rules, END last {ends}, "
                             f"{len(ids)} ids of {budget}")


def _option_solo(torch, tag: str, args: list) -> dict:
    """The solo requests of OPTION_SOLO on ``serve`` with ``args``, each
    option's graph captured first (a request of its key); the counts at 0
    before the requests, read after: K1, K2, K3 and K4 launched, the decode
    replayed from graphs; same-seed bytes equal, every reply's ids within
    the grammar and closed with END, the stream's tokens; then the same
    requests on an eager server: the same bytes and stream."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.decode import graphs
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve import shutdown_gracefully

    pipe = cli.pipeline_from_args(cli.parse_args(args))
    _require_xla_order(tag, pipe)
    t0 = time.perf_counter()
    pipe.warmup()
    for fields, query in OPTION_SOLO.values():
        kw = {"grammar": True}
        if "beams" in fields:
            kw["beams"] = int(fields["beams"])
        if "no_repeat_ngram" in fields:
            kw.update(penalties=(1.3, 0.0, 0.5), no_repeat_ngram=3)
        if "stream" in query:
            for ev in pipe.generate_stream(fields["prompt"], seed=0,
                                           render_audio=False, **kw):
                pass
        else:
            pipe.generate(fields["prompt"], seed=0, render_audio=False, **kw)
    torch.cuda.synchronize()
    log(f"[{tag}] warm-up with a request of each option "
        f"{time.perf_counter() - t0:.2f} s; {graphs.tally()}")
    server, thread, port = _serving(pipe)
    got = {}
    try:
        with _recorded_decodes(pipe) as rec:
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            replays0 = graphs.tally()["replays"]
            for name, (fields, query) in [*OPTION_SOLO.items(),
                                          ("wav_again", OPTION_SOLO["wav"])]:
                if "stream" in query:
                    reply = _sse_post(port, fields, query)
                    _check_stream(f"{tag} {name}", fields, query, reply, pipe)
                    events = reply[2]
                    got[name] = _sans_timings(events)
                    prompt, ids = _stream_ids(events)
                    _require_grammar(f"{tag} {name}", pipe,
                                     _grammar_ids(pipe, prompt) + ids)
                    continue
                reply = _post(port, fields, query)
                _check_reply(f"{tag} {name}", fields, query, reply)
                got[name] = reply[1]
                _require_grammar(f"{tag} {name}", pipe, _grammar_ids(
                    pipe, rec[int(fields["seed"])]))
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            replayed = _build.replayed_counts()
            replays = graphs.tally()["replays"] - replays0
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    if got["wav"] != got["wav_again"]:
        raise AssertionError(f"{tag}: same-seed grammar WAV bytes differ")
    log(f"[{tag}] same-seed grammar WAV bytes identical; launches {counts}")
    _require_launched("solo", counts)
    _require_graphs(tag, "flash_decode_sp", counts, replayed, replays)

    def eager_work(port):
        out = {}
        for name, (fields, query) in OPTION_SOLO.items():
            if "stream" in query:
                out[name] = _sans_timings(_sse_post(port, fields, query)[2])
            else:
                out[name] = _post(port, fields, query)[1]
        return out

    eager = _eager_replies(args, eager_work)
    differ = [n for n in OPTION_SOLO if eager[n] != got[n]]
    if differ:
        raise AssertionError(f"{tag}: the eager loop's replies differ from "
                             f"the graphs' for {differ}")
    log(f"[{tag}] the eager loop (every step issued from the host) gives the "
        f"graphs' bytes for {list(OPTION_SOLO)}")
    return {"counts": counts, "pipe": pipe}


def _reply_bytes(port: int, fields: dict, query: str, streamed: bool):
    """A request's bytes: the reply, or for a stream its ids and the done
    event's MIDI (the deltas' split follows the harvests, not the
    request)."""
    import base64

    if not streamed:
        return _post(port, fields, query)
    status, ctype, events, first, secs = _sse_post(port, fields, query)
    if status != 200 or events[-1]["event"] != "done":
        raise AssertionError(f"stream {fields}: HTTP {status} {events[-1:]}")
    return (_stream_ids(events), base64.b64decode(events[-1]["midi_b64"]))


def _option_engine(torch) -> dict:
    """`serve` with OPTION_ENGINE_ARGS (per-row sampling, an n-gram ban of
    3 and the grammar in the engine): the burst of OPTION_BURST at once,
    the counts at 0 before it; every option row admitted to the engine
    (only a plain request may take the idle engine's detached decode);
    each reply equal to the same request sent alone afterwards; the
    plain ones equal to a default engine's (`serve --coalesce`)."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.decode import graphs
    from eamg_tpu_torch.ops import _build, decode_fold
    from eamg_tpu_torch.serve import shutdown_gracefully

    pipe = cli.pipeline_from_args(cli.parse_args(OPTION_ENGINE_ARGS))
    eng = pipe.batcher
    if not (eng.per_row_sampling and eng.no_repeat_ngram == 3
            and eng.use_grammar):
        raise AssertionError("the option engine lacks an option")
    pipe.warmup()
    detached = {"n": 0}
    real_detached = eng.run_detached

    def counted_detached(*a, **kw):
        detached["n"] += 1
        return real_detached(*a, **kw)

    eng.run_detached = counted_detached
    server, thread, port = _serving(pipe)
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        replays0 = graphs.tally()["replays"]
        admitted0, detached["n"] = eng.stats["admitted"], 0
        replies, secs = _all_at_once(port, OPTION_BURST)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        replayed = _build.replayed_counts()
        replays = graphs.tally()["replays"] - replays0
        admitted = eng.stats["admitted"] - admitted0
        n_detached = detached["n"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=60) as r:
            stats = json.loads(r.read())["engine"]
        n_tok = 0
        for name, (fields, query, streamed) in OPTION_BURST.items():
            if not streamed:
                n_tok += _check_reply(f"options engine {name}", fields, query,
                                      replies[name])
        log(f"[options engine] burst of {len(OPTION_BURST)}: {n_tok} tokens "
            f"(the stream's aside) in {secs:.2f} s; rows admitted to the "
            f"engine {admitted}, detached {n_detached}; /stats engine "
            f"{stats}; launches {counts}")
        if admitted + n_detached != len(OPTION_BURST) or n_detached > 1:
            raise AssertionError(f"option engine: {admitted} admitted, "
                                 f"{n_detached} detached")
        alone = {name: _reply_bytes(port, *a)
                 for name, a in OPTION_BURST.items()}
        default, bursts = _beside_default_engine(port)
    finally:
        eng.run_detached = real_detached
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)

    def body(r):
        return r[1] if len(r) == 4 else r

    differ = [n for n in OPTION_BURST if body(replies[n]) != body(alone[n])]
    if differ:
        raise AssertionError(f"option engine: the burst's replies differ "
                             f"from the same requests alone for {differ}")
    _require_launched("coalesce", counts)
    _require_graphs("options engine", decode_fold.fold_decode.__name__,
                    counts, replayed, replays)
    plain = [n for n in OPTION_BURST if n.startswith("plain")]
    differ = [n for n in plain if body(default[n]) != body(replies[n])]
    differ += [f"{tag} {n}" for tag, (got, _) in bursts for n in PLAIN_BURST
               if body(got[n]) != body(bursts[0][1][0][n])]
    if differ:
        raise AssertionError(f"option engine: plain rows differ from the "
                             f"default engine's for {differ}")
    rates = collections.defaultdict(list)
    for tag, (got, secs) in bursts:
        tok = sum(int(r[2].get("X-EAMG-Tokens", "0")) for r in got.values())
        rates[tag].append(tok / secs)
        log(f"[options engine] {len(PLAIN_BURST)} plain requests at once on "
            f"the {tag} engine: {tok} tokens in {secs:.3f} s, "
            f"{tok / secs:.1f} tokens/s aggregate")
    log("[options engine] every reply equals the same request alone; the "
        "plain rows (the burst's three and ten at once) equal a default "
        "engine's bytes; the plain bursts' aggregate rate on the option "
        f"engine {sum(rates['option']) / sum(rates['default']):.3f}x the "
        "default engine's (option, default, default, option)")
    return counts


def _beside_default_engine(port: int) -> tuple:
    """A default engine (`serve --coalesce --slots 8`) beside the option
    engine on ``port``: the plain requests of OPTION_BURST on it alone,
    then PLAIN_BURST on the option engine, the default, the default and
    the option engine. -> ({name: reply on the default engine},
    [(engine, _all_at_once's result)])."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.serve import shutdown_gracefully

    pipe = cli.pipeline_from_args(cli.parse_args(
        ["serve", "--coalesce", "--slots", str(ENGINE_SLOTS)]))
    pipe.warmup()
    server, thread, dport = _serving(pipe)
    try:
        default = {n: _reply_bytes(dport, *a)
                   for n, a in OPTION_BURST.items() if n.startswith("plain")}
        bursts = [(tag, _all_at_once(p, PLAIN_BURST)) for tag, p in (
            ("option", port), ("default", dport), ("default", dport),
            ("option", port))]
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    return default, bursts


def _all_at_once(port: int, plan: dict) -> tuple:
    """The requests of ``plan`` (name -> (form, query, streamed)) sent at
    once -> ({name: _reply_bytes}, seconds for all)."""
    replies, errors = {}, []

    def hit(name, fields, query, streamed):
        try:
            replies[name] = _reply_bytes(port, fields, query, streamed)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"{name}: {type(exc).__name__}: {exc}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=hit, args=(n, *a), daemon=True)
               for n, a in plan.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    secs = time.perf_counter() - t0
    if errors or len(replies) != len(plan):
        raise AssertionError(f"{len(plan)} at once: "
                             f"{errors or 'a request hung'}")
    return replies, secs


def _option_window(torch) -> dict:
    """`serve` with OPTION_WINDOW_ARGS: the four requests of OPTION_WINDOW
    (penalties and grammar) at once share a ragged decode of the window
    batcher; each equals the same request alone."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.decode import graphs
    from eamg_tpu_torch.ops import _build, decode_fold
    from eamg_tpu_torch.serve import shutdown_gracefully

    pipe = cli.pipeline_from_args(cli.parse_args(OPTION_WINDOW_ARGS))
    if pipe.batcher.grammar is None:
        raise AssertionError("the window batcher has no grammar")
    pipe.warmup()
    # the option groups' graphs at every batch the worker pads a group to
    ids = pipe.generator.vocab.encode(["[START_SEQUENCE]"])
    pipe.batcher.warmup(ids, penalties=(1.3, 0.0, 0.5))
    server, thread, port = _serving(pipe)
    replies, errors = {}, []

    def hit(name, fields):
        try:
            replies[name] = _post(port, fields, "?format=midi")
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"{name}: {type(exc).__name__}: {exc}")

    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        replays0 = graphs.tally()["replays"]
        calls0 = pipe.batcher.stats["calls"]
        threads = [threading.Thread(target=hit, args=a, daemon=True)
                   for a in OPTION_WINDOW.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        replayed = _build.replayed_counts()
        replays = graphs.tally()["replays"] - replays0
        stats = dict(pipe.batcher.stats)
        if errors or len(replies) != len(OPTION_WINDOW):
            raise AssertionError(
                f"option window: {errors or 'a request hung'}")
        for name, fields in OPTION_WINDOW.items():
            _check_reply(f"options window {name}", fields, "?format=midi",
                         replies[name])
        alone = {name: _post(port, fields, "?format=midi")
                 for name, fields in OPTION_WINDOW.items()}
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    log(f"[options window] {len(OPTION_WINDOW)} requests at once in "
        f"{stats['calls'] - calls0} ragged decodes; batcher stats {stats}; "
        f"launches {counts}")
    if stats["calls"] - calls0 >= len(OPTION_WINDOW) \
            or stats["max_group"] < 2:
        raise AssertionError(f"option window: not grouped: {stats}")
    differ = [n for n in OPTION_WINDOW if replies[n][1] != alone[n][1]]
    if differ:
        raise AssertionError(f"option window: the grouped replies differ "
                             f"from the same requests alone for {differ}")
    log("[options window] every grouped reply equals the same request alone")
    _require_launched("window", counts)
    _require_graphs("options window", decode_fold.fold_decode.__name__,
                    counts, replayed, replays)
    return counts


OPTION_KERNELS = ("flash_attention", "fused_ffn", "flash_decode_sp",
                  "kth_value", "flash_decode_fold_sp")


def option_measure(torch, pipe) -> dict:
    """On demo_ckpt_a as served (bf16): the solo decode (generate_kv) plain,
    with the grammar, and with penalties and the n-gram ban, the decode
    rate of each over OPTION_TRACE_SEEDS, then one traced decode of each:
    device kernels and host launch calls a token, the idle share, and the
    launches of K1, K2, K3, K4 and row 8."""
    from eamg_tpu_torch.decode.api import _bucket
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.emotion import get_music_params
    from eamg_tpu_torch.utils import prng

    gen = pipe.generator
    label = pipe.classifier.predict(OPTION_WAV["prompt"])
    _, ids, _ = pipe._prompt_for(get_music_params(label, seed=7))
    p = len(ids)
    prompt = torch.full((1, _bucket(p)), gen.pad_id, dtype=torch.int64,
                        device=gen.device)
    prompt[0, :p] = torch.tensor(ids)
    full = gen.max_supported_len()
    variants = {"plain": {}, "grammar": {"grammar": pipe.grammar()},
                "history": {"penalties": (1.3, 0.0, 0.5),
                            "no_repeat_ngram": 3}}

    def run(seed, kw):
        return generate_kv(gen.params, prompt, p, prng.PRNGKey(seed),
                           gen.cfg, full, eos_id=gen.eos_id,
                           pad_id=gen.pad_id, **kw)[1] - p

    out = {"prompt_len": p}
    for name, kw in variants.items():
        run(0, kw)                                   # its graph
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = sum(run(seed, kw) for seed in OPTION_TRACE_SEEDS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[name] = {"tokens": tok, "s": secs, "tokens_per_s": tok / secs}
    for name, kw in variants.items():
        prof, counts = _trace_counted(
            torch, f"options {name}", lambda kw=kw: run(1, kw),
            lambda prof, counts: {"kth_value": (
                launched("kth_value", counts), _k4_kernels(prof))})
        out[name].update({k: prof[k] for k in (
            "n_tokens", "wall_ms", "device_busy_ms", "idle_share",
            "launches_per_token", "host_launches_per_token",
            "graph_replays")})
        out[name]["launches"] = {k: launched(k, counts)
                                 for k in OPTION_KERNELS}
    for name in ("grammar", "history"):
        r, pl = out[name], out["plain"]
        log(f"[options] solo {name}: {r['tokens_per_s']:.1f} tokens/s beside "
            f"the plain decode's {pl['tokens_per_s']:.1f} "
            f"({r['tokens_per_s'] / pl['tokens_per_s']:.3f}x); device "
            f"kernels a token {r['launches_per_token']:.2f} (plain "
            f"{pl['launches_per_token']:.2f}, "
            f"{r['launches_per_token'] - pl['launches_per_token']:+.2f}); "
            f"host launch calls a token {r['host_launches_per_token']:.3f}; "
            f"idle {100 * r['idle_share']:.2f}% (plain "
            f"{100 * pl['idle_share']:.2f}%); launches {r['launches']}")
    log(json.dumps({"options_measure": out}))
    return out


def serve_options(torch) -> dict:
    """Phase options: the grammar and the history options of the page,
    solo on demo_ckpt_a and demo_ckpt_b3 (_option_solo), on an engine
    built for them (_option_engine) and on a window batcher with the
    grammar (_option_window); the solo decode's rates and traces with
    each. -> launch counts by path."""
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_B3

    t0 = time.perf_counter()
    a = _option_solo(torch, "options solo a", ["serve"])
    b3 = _option_solo(torch, "options solo b3",
                      ["serve", "--checkpoint", DEMO_CKPT_B3])
    counts = {"options solo a": a["counts"], "options solo b3": b3["counts"],
              "options engine": _option_engine(torch),
              "options window": _option_window(torch)}
    option_measure(torch, a["pipe"])
    log(f"[options] phase {time.perf_counter() - t0:.1f} s")
    return counts


# ------------------------------------------------------------------ train

# phase train: `cli train` on the reference large2 recipe (d512 h8 L6,
# Scheme B2, V 8324, T 511, micro-batch 16, the chunked CE of 73, f32), 16
# steps; the flagship's own recipe through `train-demo-a` (bf16, GQA-2),
# 96 steps, then served
TRAIN_ARGS = ["train", "--preset", "large2", "--corrected", "--synthetic",
              "256", "--epochs", "1", "--save-every", "8", "--log-every",
              "4", "--seed", "0"]
TRAIN_STEPS = 16
TRAIN_DEVICE = "cuda"
RESUME_AT = 8
HOST_STEPS = 3                  # steps rerun on the host, plain PyTorch
HOST_LOSS_RTOL = 1e-5           # a step's loss, card against host
HOST_GRAD_TOL = 1e-5            # step 1's gradient, x max|g| over leaves
HOST_PARAM_ATOL = 1e-5          # |delta param| after HOST_STEPS ...
HOST_PARAM_SHARE = 1e-3         # ... met by all but this share of elements
RESUME_RTOL = 1e-6              # resumed losses against the uninterrupted
ATTN_BLOCK = 128
ATTN_BLOCK_RTOL = 1e-5          # first loss, --attn-block against dense
# the short runs of (d), ~4 steps each: (preset, rows, extra flags)
SHORT_RUNS = {"pack": ("large2", 192, ["--pack"]),
              "attn_block": ("large2", 64, ["--attn-block", str(ATTN_BLOCK)]),
              "paper": ("paper", 64, [])}
DEMO_ARGS = ["train-demo-a", "--geometry", "flagship", "--kv-heads", "2",
             "--rows", "768", "--heldout-rows", "64", "--epochs", "2"]
DEMO_STEPS = 96
TIMED_FROM = 4                  # ms a step: the median of steps 4..16
PROFILED_STEPS = 4
TRAIN_KERNELS = ("flash_attention", "fused_ffn", "flash_decode_sp",
                 "top_k_mask")
SERVE_TRAINED = {"prompt": BURST_TEXTS[0], "seed": "7"}


def _cli_run(tag: str, argv: list) -> list:
    """`python -m eamg_tpu_torch.cli` with ``argv`` in this process (so its
    launches count) -> its printed lines; fails on a nonzero exit."""
    import io

    from eamg_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = cli.main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines[:-1]:
        log(f"[{tag}] {line}")
    log(f"[{tag}] exit {code} in {time.perf_counter() - t0:.1f} s: "
        f"{lines[-1] if lines else ''}")
    if code != 0:
        raise AssertionError(f"{tag}: cli {argv[0]} exited {code}")
    return lines


def _logged_losses(lines: list) -> dict:
    """step -> loss (and grad_norm when logged) from run_training's lines."""
    pat = re.compile(r"step (\d+): loss=(\S+?)(?: grad_norm=(\S+))?$")
    out = {}
    for line in lines:
        m = pat.search(line)
        if m:
            out[int(m.group(1))] = (float(m.group(2)),
                                    float(m.group(3)) if m.group(3)
                                    else None)
    return out


def _large2_setup(torch, device):
    """The run of TRAIN_ARGS rebuilt from its parts: (cfg, tcfg, its
    batches, its initial params on ``device``)."""
    from eamg_tpu_torch.models.gpt import init_params, preset
    from eamg_tpu_torch.train.data import batches, synthetic_corpus
    from eamg_tpu_torch.train.run import encode_corpus
    from eamg_tpu_torch.train.trainer import reference_preset
    from eamg_tpu_torch.utils import prng

    seq_len = preset("large2", vocab_size=1).seq_len
    encoded, vocab = encode_corpus(synthetic_corpus(256, seed=0), "b2",
                                   seq_len)
    cfg = dataclasses.replace(preset("large2", len(vocab)), causal=True)
    tcfg = dataclasses.replace(reference_preset("large2"), epochs=1,
                               pad_id=vocab.pad_id, loss_chunk=73)
    steps = list(batches(encoded, cfg.seq_len, vocab.pad_id,
                         tcfg.micro_batch, drop_last=False, shuffle_seed=0))
    return cfg, tcfg, steps, init_params(prng.PRNGKey(0), cfg,
                                         device=device), vocab


def _param_gap(torch, cfg, a: dict, b: dict) -> dict:
    """|a - b| over every parameter: its max, the elements past
    HOST_PARAM_ATOL, and the max over the K rows of each in_b alone (a key
    bias adds the same amount to every score of a query, so its gradient
    is zero in exact arithmetic)."""
    from eamg_tpu_torch.train.trainer import tree_leaves

    D, KVD = cfg.d_model, cfg.kv_dim
    kb = max(float((la["attn"]["in_b"].cpu()[D:D + KVD]
                    - lb["attn"]["in_b"].cpu()[D:D + KVD]).abs().max())
             for la, lb in zip(a["layers"], b["layers"]))
    worst, past, total = 0.0, 0, 0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.cpu() - y.cpu()).abs()
        worst = max(worst, float(d.max()))
        past += int((d > HOST_PARAM_ATOL).sum())
        total += d.numel()
    return {"max": worst, "past_tol": past, "elements": total,
            "k_bias_max": kb}


def _step_grads(torch, cfg, tcfg, params, x, y) -> list:
    """The gradient of the step's loss at ``params`` for one batch, as
    CPU tensors."""
    from eamg_tpu_torch.train.trainer import (loss_fn_chunked, tree_leaves,
                                              tree_unflatten)

    live = [p.detach().clone().requires_grad_() for p in tree_leaves(params)]
    dev = live[0].device
    loss, _ = loss_fn_chunked(
        tree_unflatten(params, live), torch.from_numpy(x[0]).to(dev),
        torch.from_numpy(y[0]).to(dev), cfg, tcfg.pad_id, tcfg.loss_chunk)
    return [g.cpu() for g in torch.autograd.grad(loss, live)]


def _timed_steps(torch, trainer, steps, tag: str, hooks=None) -> dict:
    """Run ``steps`` through ``trainer`` on the card, each between two CUDA
    events; ``hooks[i]`` runs after step i (1-based), outside the timing.
    -> per-step losses and tokens (host floats), ms a step, target tokens
    a second (non-PAD, steps TIMED_FROM..), peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks, metrics = [], []
    for i, (x, y) in enumerate(steps, start=1):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        metrics.append(trainer.train_step(x, y, sync=False))
        e1.record()
        marks.append((e0, e1))
        if hooks and i in hooks:
            hooks[i]()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in marks]
    losses = [float(m["loss"]) for m in metrics]
    tokens = [int(m["tokens"]) for m in metrics]
    timed = ms[TIMED_FROM - 1:]
    med = sorted(timed)[len(timed) // 2]
    out = {"steps": len(ms), "ms_per_step_median": med,
           "ms_per_step": ms,
           "target_tokens_per_s": sum(tokens[TIMED_FROM - 1:])
           / (sum(timed) / 1000),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "losses": losses, "tokens": tokens}
    log(f"[train {tag}] {len(ms)} steps: median {med:.3f} ms a step "
        f"(steps {TIMED_FROM}..{len(ms)}), "
        f"{out['target_tokens_per_s']:.0f} target tokens/s, peak memory "
        f"{out['max_memory_allocated_bytes'] / 2**20:.1f} MiB; losses "
        f"{[round(v, 6) for v in losses]}")
    return out


def _profiled_steps(torch, trainer, steps, tag: str) -> dict:
    """PROFILED_STEPS steps under torch.profiler: the device's idle share."""
    def work():
        ms = [trainer.train_step(x, y, sync=False) for x, y in steps]
        return int(sum(int(m["tokens"]) for m in ms))

    prof = _trace(torch, f"train {tag}", work)
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                 "launches", "host_launches",
                                 "device_ms_by_group")}


def _card_vs_host(torch, card_init, card_params, cfg, tcfg, steps,
                  card_losses):
    """The first HOST_STEPS steps again on the host (plain PyTorch), from
    the card's initial weights and the same batches; the host's own
    init_params of the same key logged beside the card's (ulps by leaf)."""
    from eamg_tpu_torch.models.gpt import init_params
    from eamg_tpu_torch.train.trainer import Trainer, tree_leaves, tree_map
    from eamg_tpu_torch.utils import prng

    t0 = time.perf_counter()
    host_init = init_params(prng.PRNGKey(0), cfg, device="cpu")
    init_ulps = []
    for a, b in zip(tree_leaves(card_init), tree_leaves(host_init)):
        d = (a.cpu().view(torch.int32).long() - b.view(torch.int32).long()
             ).abs()
        init_ulps.append((int(d.max()), int((d > 0).sum()), d.numel()))
    init_equal = all(m == 0 for m, _, _ in init_ulps)
    log(f"[train init] init_params of one key, card against host: "
        f"bit-equal {init_equal}; (max ulps, elements differing, elements) "
        f"by leaf: {[u for u in init_ulps if u[0]]}")
    host = Trainer(cfg, tcfg, card_init, device="cpu")
    losses = [host.train_step(x, y)["loss"] for x, y in steps[:HOST_STEPS]]
    secs = time.perf_counter() - t0
    rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, losses)]
    g_card = _step_grads(torch, cfg, tcfg, card_init, *steps[0])
    g_host = _step_grads(torch, cfg, tcfg,
                         tree_map(lambda p: p.cpu(), card_init), *steps[0])
    g_scale = max(float(g.abs().max()) for g in g_host)
    g_gap = max(float((a - b).abs().max()) for a, b in zip(g_card, g_host))
    gap = _param_gap(torch, cfg, card_params, host.params)
    lr_sum = sum(host.optimizer.schedule(c) for c in range(HOST_STEPS))
    bound = 2 * lr_sum * (1 + tcfg.weight_decay)
    log(f"[train host] {HOST_STEPS} steps on the host in {secs:.1f} s: "
        f"losses {losses}, card {card_losses[:HOST_STEPS]}, rel |delta| "
        f"{rel}; step 1's gradient max |delta| {g_gap:.3e} against max |g| "
        f"{g_scale:.3e}; params after {HOST_STEPS} steps: max |delta| "
        f"{gap['max']:.3e} (held to {bound:.3e}: Adam's step is ~g / |g| "
        f"where |g| nears its 1e-8, so a gradient of rounding residue "
        f"moves by up to the rate), {gap['past_tol']} of {gap['elements']} "
        f"elements past {HOST_PARAM_ATOL} (K rows of in_b "
        f"{gap['k_bias_max']:.3e})")
    if max(rel) > HOST_LOSS_RTOL:
        raise AssertionError(f"train: card and host losses differ {rel}")
    if g_gap > HOST_GRAD_TOL * g_scale:
        raise AssertionError(f"train: card and host gradients differ by "
                             f"{g_gap} (max |g| {g_scale})")
    if gap["max"] > bound or \
            gap["past_tol"] > HOST_PARAM_SHARE * gap["elements"]:
        raise AssertionError(f"train: card and host params differ: {gap}")
    return {"losses_host": losses, "loss_rel_delta": rel,
            "grad_max_abs_delta": g_gap, "grad_max_abs": g_scale,
            "params": gap, "host_seconds": secs, "init_bit_equal": init_equal,
            "init_ulps_by_leaf": init_ulps}


def train_large2(torch, tmp: str) -> dict:
    """(a) `cli train` on large2, 16 steps; (b) the same run rebuilt from
    its parts on the card, timed, against the host over its first steps;
    (c) resumed at step 8 from a checkpoint, against the uninterrupted
    run, and `cli train --resume`; (d) --pack, --attn-block and the paper
    preset, 4 steps each."""
    from eamg_tpu_torch.models.gpt import init_params
    from eamg_tpu_torch.train.trainer import Trainer, tree_leaves, tree_map
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

    out = {}
    run_dir = os.path.join(tmp, "large2")
    lines = _cli_run("train a", TRAIN_ARGS + ["--out", run_dir])
    logged = _logged_losses(lines)
    summary = json.loads(lines[-1])
    first, last = logged[min(logged)][0], logged[max(logged)][0]
    if summary["steps"] != TRAIN_STEPS or sorted(logged) != [4, 8, 12, 16]:
        raise AssertionError(f"train: {summary}, logged {sorted(logged)}")
    if not all(math.isfinite(v) for v, _ in logged.values()) \
            or not last < first:
        raise AssertionError(f"train: logged losses {logged}")
    for tag in ("latest", "ep1", "final"):
        if not os.path.exists(os.path.join(run_dir, tag, "params.pkl")):
            raise AssertionError(f"train: no {tag} checkpoint")
    out["cli"] = {"summary": summary, "logged": logged}

    cfg, tcfg, steps, params, vocab = _large2_setup(torch, TRAIN_DEVICE)
    trainer = Trainer(cfg, tcfg, params, device=TRAIN_DEVICE)
    snap = {}
    resume_dir = os.path.join(tmp, "resume8")

    def at_host_steps():
        snap["params"] = tree_map(lambda p: p.detach().cpu().clone(),
                                  trainer.params)

    def at_resume():
        save_checkpoint(resume_dir, trainer.params, vocab.tok2id, cfg,
                        opt_state=trainer.opt_state_tree(),
                        step=trainer.step)

    timed = _timed_steps(torch, trainer, steps, "large2",
                         hooks={HOST_STEPS: at_host_steps,
                                RESUME_AT: at_resume})
    out["large2"] = timed
    cli_final = load_checkpoint(os.path.join(run_dir, "final"))["params"]
    gap = _param_gap(torch, cfg, trainer.params, cli_final)
    same = all(bool(torch.equal(a.cpu(), b)) for a, b in
               zip(tree_leaves(trainer.params), tree_leaves(cli_final)))
    log(f"[train same-seed] the rebuilt run's params after {TRAIN_STEPS} "
        f"steps against `cli train`'s final: bit-equal {same}; {gap}")
    for step, (v, _) in logged.items():
        if abs(round(timed["losses"][step - 1], 4) - v) > 1.5e-4:
            raise AssertionError(f"train: step {step} logged {v}, rebuilt "
                                 f"{timed['losses'][step - 1]}")
    out["same_seed_bit_equal"] = same

    out["host"] = _card_vs_host(torch, params, snap["params"], cfg, tcfg,
                                steps, timed["losses"])

    ck = load_checkpoint(resume_dir)
    resumed = Trainer(cfg, tcfg, ck["params"], device=TRAIN_DEVICE)
    resumed.load_opt_state(ck["opt_state"])
    resumed.step = ck["step"]
    if resumed.step != RESUME_AT:
        raise AssertionError(f"resume: step {resumed.step}")
    r_losses = [resumed.train_step(x, y)["loss"]
                for x, y in steps[RESUME_AT:]]
    ref = timed["losses"][RESUME_AT:]
    rel = [abs(a - b) / abs(b) for a, b in zip(r_losses, ref)]
    bit = r_losses == ref
    log(f"[train resume] steps {RESUME_AT + 1}..{TRAIN_STEPS} from the step-"
        f"{RESUME_AT} checkpoint: {r_losses}; uninterrupted {ref}; rel "
        f"|delta| max {max(rel):.3e}; bit-equal {bit}")
    if max(rel) > RESUME_RTOL:
        raise AssertionError(f"resume: losses differ {rel}")
    out["resume"] = {"losses": r_losses, "rel_delta": rel, "bit_equal": bit}
    lines = _cli_run("train resume", TRAIN_ARGS + [
        "--resume", os.path.join(run_dir, "latest"),
        "--out", os.path.join(tmp, "resumed")])
    summary = json.loads(lines[-1])
    if summary["steps"] != 2 * TRAIN_STEPS or \
            not math.isfinite(summary["final_loss"]):
        raise AssertionError(f"train --resume: {summary}")

    short = {}
    for tag, (preset, rows, extra) in SHORT_RUNS.items():
        argv = list(TRAIN_ARGS)
        argv[argv.index("--preset") + 1] = preset
        argv[argv.index("--synthetic") + 1] = str(rows)
        lines = _cli_run(f"train {tag}", argv + extra + [
            "--log-every", "1", "--out", os.path.join(tmp, tag)])
        got = _logged_losses(lines)
        if not got or not all(math.isfinite(v) for v, _ in got.values()):
            raise AssertionError(f"train {tag}: losses {got}")
        short[tag] = got
    norms = [n for _, n in short["paper"].values()]
    if not any(n is not None and n >= 1.0 for n in norms):
        raise AssertionError(f"paper: the clip never fired: norms {norms}")
    log(f"[train paper] global grad norms {norms}: clipped at 1.0 in "
        f"{sum(n >= 1.0 for n in norms)} of {len(norms)} steps")
    block_cfg = dataclasses.replace(cfg, attn_block=ATTN_BLOCK)
    first = {}
    for tag, c in (("dense", cfg), ("attn_block", block_cfg)):
        t = Trainer(c, tcfg, init_params(prng.PRNGKey(0), c, device=TRAIN_DEVICE),
                    device=TRAIN_DEVICE)
        first[tag] = t.train_step(*steps[0])["loss"]
    rel = abs(first["attn_block"] - first["dense"]) / abs(first["dense"])
    log(f"[train attn_block] first loss {first['attn_block']} against dense "
        f"{first['dense']}: rel |delta| {rel:.3e}")
    if rel > ATTN_BLOCK_RTOL:
        raise AssertionError(f"attn_block: first loss rel delta {rel}")
    out["short"] = {k: {s: v for s, (v, _) in g.items()}
                    for k, g in short.items()}
    out["paper_grad_norms"] = norms
    out["attn_block_first_rel_delta"] = rel

    out["large2"]["profile"] = _profiled_steps(
        torch, trainer, steps[:PROFILED_STEPS], "large2")
    return out


def _flagship_trainer(torch):
    """train_demo_a's flagship trainer for DEMO_ARGS, rebuilt from its
    parts (to time its steps): (trainer, its first epoch's batches)."""
    from eamg_tpu_torch.models.gpt import GPTConfig, init_params
    from eamg_tpu_torch.tokenizer.vocab import Vocab
    from eamg_tpu_torch.tools.demo_a import flagship_spec
    from eamg_tpu_torch.train.data import batches, grid_corpus
    from eamg_tpu_torch.train.trainer import TrainConfig, Trainer
    from eamg_tpu_torch.utils import prng

    spec = dataclasses.replace(flagship_spec(), rows=768, heldout_rows=64,
                               epochs=2, kv_heads=2)
    rows = [json.loads(r) for r in grid_corpus(
        spec.rows, seed=spec.seed, max_units=spec.max_units,
        n_chains=spec.n_chains)]
    vocab = Vocab.from_sequences(rows, pad_last=True)
    encoded = [vocab.encode(s[:spec.seq_len]) for s in rows]
    cfg = GPTConfig(vocab_size=len(vocab), seq_len=spec.seq_len,
                    d_model=spec.d_model, n_head=spec.n_head,
                    n_layer=spec.n_layer, causal=True, dtype="bfloat16",
                    n_kv_heads=spec.kv_heads)
    per_epoch = -(-len(encoded) // spec.micro_batch)
    tcfg = TrainConfig(lr=spec.lr, micro_batch=spec.micro_batch,
                       epochs=spec.epochs, pad_id=vocab.pad_id,
                       schedule="warmup_cosine", warmup_steps=per_epoch // 2,
                       total_steps=spec.epochs * per_epoch,
                       loss_chunk=spec.loss_chunk)
    steps = list(batches(encoded, cfg.seq_len, vocab.pad_id,
                         tcfg.micro_batch, drop_last=False, shuffle_seed=0))
    trainer = Trainer(cfg, tcfg, init_params(prng.PRNGKey(0), cfg,
                                             device=TRAIN_DEVICE), device=TRAIN_DEVICE)
    return trainer, steps


def train_demo(torch, tmp: str) -> dict:
    """(e) `train-demo-a` with the flagship's recipe, then `serve` of its
    checkpoint: POST /generate twice with one seed."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.serve import shutdown_gracefully

    demo_dir = os.path.join(tmp, "demo_a")
    lines = _cli_run("train-demo-a", DEMO_ARGS + ["--out", demo_dir])
    metrics = json.loads(lines[-1])
    with open(os.path.join(demo_dir, "train_metrics.json")) as f:
        written = json.load(f)
    if written != metrics or metrics["steps"] != DEMO_STEPS:
        raise AssertionError(f"train-demo-a: {metrics}")
    for k in ("final_loss", "train_ppl", "heldout_ppl",
              "grid_onset_obedience", "in_key_obedience"):
        if not math.isfinite(metrics[k]):
            raise AssertionError(f"train-demo-a: {k} {metrics[k]}")
    epochs = [ln for ln in lines if "held_out_ppl=" in ln]
    if len(epochs) != 2:
        raise AssertionError(f"train-demo-a: per-epoch lines {epochs}")
    pipe = cli.pipeline_from_args(cli.parse_args(
        ["serve", "--checkpoint", demo_dir]))
    pipe.warmup()
    server, thread, port = _serving(pipe)
    try:
        bodies = []
        for _ in range(2):
            reply = _post(port, SERVE_TRAINED)
            _check_reply("train serve", SERVE_TRAINED, "", reply)
            bodies.append(reply[1])
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    if bodies[0] != bodies[1]:
        raise AssertionError("train serve: same-seed WAV bytes differ")
    log(f"[train serve] the trained flagship-recipe checkpoint served two "
        f"same-seed WAVs of {len(bodies[0])} bytes, equal")
    return {"metrics": metrics, "served_wav_bytes": len(bodies[0])}


def serve_train(torch) -> dict:
    """Phase train: training on the card, (a)-(f) of train_large2 and
    train_demo, with the timings of both recipes. -> launch counts over
    the phase."""
    import tempfile

    from eamg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _build.reset_launch_counts()
        large2 = train_large2(torch, tmp)
        demo = train_demo(torch, tmp)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
    for name in TRAIN_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"train: {name} was not launched")
    trainer, steps = _flagship_trainer(torch)
    flagship = _timed_steps(torch, trainer, steps[:TRAIN_STEPS], "flagship")
    flagship["profile"] = _profiled_steps(
        torch, trainer, steps[TRAIN_STEPS:TRAIN_STEPS + PROFILED_STEPS],
        "flagship")
    log(json.dumps({"train": {"large2": large2, "demo": demo,
                              "flagship_timing": flagship,
                              "launches": counts}}))
    log(f"[train] phase {time.perf_counter() - t0:.1f} s; launches {counts}")
    return counts


# ------------------------------------------------------------------ tools

TOOLS_KERNELS = ("flash_attention", "fused_ffn", "flash_decode_sp",
                 "top_k_mask", "flash_decode_fold_sp")
# tests/sf2_fixture.py::fixture_song: one note a preset tier (plain sine,
# slow-attack saw, filtered saw, vibrato sine), 0.1 s to 1.2 s
FIXTURE_NOTES = ((0, 69), (40, 60), (41, 64), (42, 72))
SF2_LONE = {"prompt": "I finally got the job, I am so happy!", "seed": "7"}
SF2_ATOL = 1e-5
GOLDEN_MIN_CORR = 0.7
# feed-bench's corpus, cut from the CLI's 100 000 rows: the host writes the
# synthetic CSV at ~500 rows/s, so 100 000 rows alone would take minutes
FEED_ROWS = 4000
RANDOM_BURST = ((5, ""), (6, "?format=midi"), (5, ""), (8, ""))


@contextlib.contextmanager
def _env(**kv):
    """Set (a str) or unset (None) environment variables for the block."""
    saved = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _fixture_font(tmp: str) -> str:
    """tests/sf2_fixture.py's font (built with numpy and struct) as a
    file; -> its path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "sf2_fixture.py")
    spec = importlib.util.spec_from_file_location("sf2_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    font = os.path.join(tmp, "fixture.sf2")
    with open(font, "wb") as f:
        f.write(mod.build_test_sf2())
    return font


def _fixture_song():
    from eamg_tpu_torch.midi.smf import Instrument, MidiSong, Note

    song = MidiSong(initial_tempo=120.0)
    for prog, pitch in FIXTURE_NOTES:
        inst = Instrument(prog)
        inst.notes.append(Note(100, pitch, 0.1, 1.2))
        song.instruments.append(inst)
    return song


def _band_corr(ours, golden_path: str) -> float:
    """The band-energy correlation tests/test_sf2.py holds the sampler to
    against the committed golden WAV."""
    import wave as wavemod

    import numpy as np

    with wavemod.open(golden_path, "rb") as w:
        raw = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        theirs = raw.reshape(-1, w.getnchannels()).mean(1) / 32768.0
    n = min(len(ours), len(theirs))
    bands = np.geomspace(60, 22050 / 2 - 1, 25)

    def prof(x):
        spec = np.abs(np.fft.rfft(x[:n])) ** 2
        freqs = np.fft.rfftfreq(n, 1.0 / 22050)
        return np.log10(np.asarray(
            [spec[(freqs >= lo) & (freqs < hi)].sum()
             for lo, hi in zip(bands[:-1], bands[1:])]) + 1e-12)

    return float(np.corrcoef(prof(ours), prof(theirs))[0, 1])


def _timed_render(torch, renderer, song, seed: int = 0):
    t0 = time.perf_counter()
    wave = renderer.render_song(song, seed=seed)
    if renderer.device.type == "cuda":
        torch.cuda.synchronize()
    return wave, (time.perf_counter() - t0) * 1000


def tools_sf2(torch, tmp: str) -> dict:
    """The SoundFont rung on the served flagship: `serve` on demo_ckpt_a
    with EAMG_SOUNDFONT (the fixture font) and EAMG_NO_FLUIDSYNTH=1; two
    same-seed WAV requests (equal bytes), the same request with
    EAMG_NO_SF2=1 (the additive synth: other bytes); the served bytes are
    Sf2Renderer's on the card for the request's song; the renderer on the
    card against the host (fixture song within SF2_ATOL) and against the
    committed C++-twin golden."""
    import io

    import numpy as np

    from eamg_tpu_torch import cli
    from eamg_tpu_torch.audio import fluidsynth as fs
    from eamg_tpu_torch.audio.sampler import Sf2Renderer
    from eamg_tpu_torch.serve import shutdown_gracefully
    from eamg_tpu_torch.tokenizer import tokens_to_song

    font = _fixture_font(tmp)
    out = {}
    with _env(EAMG_SOUNDFONT=font, EAMG_NO_FLUIDSYNTH="1", EAMG_NO_SF2=None):
        fs._sf2_renderers.clear()
        pipe = cli.pipeline_from_args(cli.parse_args(["serve"]))
        pipe.warmup()
        server, thread, port = _serving(pipe)
        try:
            replies = []
            for _ in range(2):
                replies.append(_post(port, SF2_LONE))
                _check_reply("tools/sf2", SF2_LONE, "", replies[-1])
            with _env(EAMG_NO_SF2="1"):
                additive = _post(port, SF2_LONE)
                _check_reply("tools/sf2 additive", SF2_LONE, "", additive)
            r = pipe.generate(SF2_LONE["prompt"], seed=7, render_audio=False)
        finally:
            server.shutdown()
            shutdown_gracefully(server, pipe)
            thread.join(timeout=30)
        keys = sorted(fs._sf2_renderers)
    if replies[0][1] != replies[1][1]:
        raise AssertionError("tools/sf2: same-seed WAV bytes differ")
    if replies[0][1] == additive[1]:
        raise AssertionError("tools/sf2: the SoundFont WAV equals the "
                             "additive synth's: rung 2 did not run")
    if keys != [(font, "cuda")]:
        raise AssertionError(f"tools/sf2: renderers {keys}, not one on the "
                             "card")
    song = tokens_to_song(r.tokens)
    card = Sf2Renderer(font, device="cuda")
    buf = io.BytesIO()
    card.render_to_wav(song, buf, seed=7)
    if buf.getvalue() != replies[0][1]:
        raise AssertionError("tools/sf2: the served WAV is not "
                             "Sf2Renderer's on the card for its song")
    host = Sf2Renderer(font, device="cpu")
    rows, left = card._voices_for(song)
    w_card, ms_card = _timed_render(torch, card, song, seed=7)
    w_host, ms_host = _timed_render(torch, host, song, seed=7)
    served_err = float(np.abs(w_card - w_host).max())
    fx_card, fx_ms_card = _timed_render(torch, card, _fixture_song())
    fx_host, fx_ms_host = _timed_render(torch, host, _fixture_song())
    fx_err = float(np.abs(fx_card - fx_host).max())
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden", "cpp_twin_fixture.wav")
    corr = _band_corr(fx_card, golden)
    timing = {k: json.loads(v[2].get("X-EAMG-Timings", "{}")).get(
        "render_wav") for k, v in (("sf2", replies[0]), ("sf2_again",
                                                          replies[1]),
                                   ("additive", additive))}
    out = {"served_same_bytes": True, "differs_from_additive": True,
           "render_wav_ms": timing, "served_song_voices": len(rows),
           "served_song_leftover_notes": sum(len(i.notes) for i in left),
           "served_song_ms": {"card": ms_card, "host": ms_host},
           "served_song_card_vs_host_max_abs": served_err,
           "fixture_ms": {"card": fx_ms_card, "host": fx_ms_host},
           "fixture_card_vs_host_max_abs": fx_err,
           "golden_band_corr": corr}
    log(f"[tools/sf2] {json.dumps(out)}")
    if fx_err > SF2_ATOL:
        raise AssertionError(f"tools/sf2: the fixture song's card render "
                             f"differs from the host's by {fx_err}")
    if not corr > GOLDEN_MIN_CORR:
        raise AssertionError(f"tools/sf2: band-energy correlation {corr}")
    return out


def _random_burst(port: int) -> dict:
    """RANDOM_BURST at once -> {i: reply}."""
    replies, errors = {}, []

    def hit(i, seed, query):
        try:
            fields = {"prompt": BURST_TEXTS[i % len(BURST_TEXTS)],
                      "seed": str(seed)}
            if seed == 5:
                fields["prompt"] = BURST_TEXTS[0]
            replies[i] = (fields, query, _post(port, fields, query))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=hit, args=(i, s, q), daemon=True)
               for i, (s, q) in enumerate(RANDOM_BURST)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or len(replies) != len(RANDOM_BURST):
        raise AssertionError(f"random burst failed: {errors or 'a hang'}")
    return replies


def tools_random_demo(torch) -> dict:
    """`serve --random-demo` (the non-causal random model, solo): two
    same-seed WAV requests and a MIDI one; `serve --random-demo --coalesce`
    (causal, the engine): a lone request, then RANDOM_BURST at once, the
    lone request's seed again among them; same seed, same bytes."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve import shutdown_gracefully

    out = {}
    for tag, argv in (("solo", ["serve", "--random-demo"]),
                      ("coalesce", ["serve", "--random-demo",
                                    "--coalesce"])):
        pipe = cli.pipeline_from_args(cli.parse_args(argv))
        cfg = pipe.generator.cfg
        log(f"[tools/random {tag}] d{cfg.d_model} h{cfg.n_head} "
            f"L{cfg.n_layer} V{cfg.vocab_size} causal {cfg.causal} "
            f"{cfg.dtype}")
        pipe.warmup()
        server, thread, port = _serving(pipe)
        try:
            _build.reset_launch_counts()
            fields = {"prompt": BURST_TEXTS[0], "seed": "5"}
            lone = _post(port, fields)
            _check_reply(f"tools/random {tag}", fields, "", lone)
            if tag == "solo":
                again = _post(port, fields)
                _check_reply(f"tools/random {tag}", fields, "", again)
                other = {**fields, "seed": "6"}
                _check_reply(f"tools/random {tag}", other, "?format=midi",
                             _post(port, other, "?format=midi"))
                same = [again[1]]
            else:
                burst = _random_burst(port)
                for f, q, rep in burst.values():
                    _check_reply(f"tools/random {tag}", f, q, rep)
                same = [burst[0][2][1], burst[2][2][1]]
            torch.cuda.synchronize()
            counts = _build.launch_counts()
        finally:
            server.shutdown()
            shutdown_gracefully(server, pipe)
            thread.join(timeout=30)
        if any(b != lone[1] for b in same):
            raise AssertionError(f"tools/random {tag}: same-seed bytes "
                                 "differ")
        _require_launched(tag, counts)
        log(f"[tools/random {tag}] same-seed bytes identical; launches "
            f"{counts}")
        out[tag] = counts
    return out


def _table_ppl(lines: list) -> dict:
    """ablate's markdown table -> {row name: PPL as printed}."""
    rows = {}
    for line in lines:
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) == 5 and cells[1] not in ("PPL ↓", "---"):
            rows[cells[0]] = cells[1]
    return rows


def tools_cli(torch) -> dict:
    """ablate at the CLI's defaults, section-eval --prompts 10 on the
    flagship, feed-bench on FEED_ROWS rows, emotion on one text."""
    out = {}
    t0 = time.perf_counter()
    lines = _cli_run("tools/ablate", ["ablate"])
    out["ablate_s"] = time.perf_counter() - t0
    ppl = _table_ppl(lines)
    log("[tools/ablate] " + " / ".join(lines[-6:]))
    if ppl.get("- KV cache") is None or ppl["- KV cache"] != ppl["full"]:
        raise AssertionError(f"tools/ablate: PPL rows {ppl}")
    out["ablate_ppl"] = ppl
    t0 = time.perf_counter()
    sec = json.loads(_cli_run("tools/section-eval",
                              ["section-eval", "--prompts", "10"])[-1])
    out["section_eval_s"] = time.perf_counter() - t0
    out["section_eval"] = sec
    if sec["n_prompts"] != 10 or sec["n_sections"] < 10:
        raise AssertionError(f"tools/section-eval: {sec}")
    t0 = time.perf_counter()
    feed = json.loads(_cli_run("tools/feed-bench",
                               ["feed-bench", "--rows", str(FEED_ROWS)])[-1])
    out["feed_bench_s"] = time.perf_counter() - t0
    out["feed_bench"] = feed
    if feed["rows"] != FEED_ROWS or not feed["device_step_ms"] > 0:
        raise AssertionError(f"tools/feed-bench: {feed}")
    emo = json.loads(_cli_run("tools/emotion", [
        "emotion", "--text", "I finally got the job, I am so happy!",
        "--seed", "3"])[-1])
    if emo["label"] != emo["mapping"]["emotion"]:
        raise AssertionError(f"tools/emotion: {emo}")
    out["emotion"] = emo
    return out


def serve_tools(torch, card: str) -> dict:
    """Phase tools: the SoundFont rung on the served flagship, the random
    demos served, and the CLI's tools on the card. -> launch counts over
    the phase."""
    import tempfile

    from eamg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        _build.reset_launch_counts()
        out["sf2"] = tools_sf2(torch, tmp)
        sf2_counts = _build.launch_counts()
    random_counts = tools_random_demo(torch)
    _build.reset_launch_counts()
    out["cli"] = tools_cli(torch)
    torch.cuda.synchronize()
    cli_counts = _build.launch_counts()
    counts = collections.Counter(sf2_counts)
    for c in (*random_counts.values(), cli_counts):
        counts.update(c)
    counts = dict(counts)
    for name in TOOLS_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"tools: {name} was not launched")
    out["launches"] = {"sf2_serve": sf2_counts, "random": random_counts,
                       "cli": cli_counts}
    out["phase_s"] = time.perf_counter() - t0
    log(json.dumps({"tools": out}))
    log(f"[tools] phase {out['phase_s']:.1f} s; launches {counts}")
    return counts


# --------------------------------------------------------------- variants

# (a) JAX's benchmarks.py::scenario_8_optimized_serving on the port: the
# large2 geometry, random weights from key 0, batch 8 to position 511
VARIANT_BASE = dict(vocab_size=8324, seq_len=512, d_model=512, n_head=8,
                    n_layer=6, causal=True, dtype="bfloat16")
VARIANT_CONFIGS = (("bf16", None, False), ("int8", None, True),
                   ("gqa2", 2, False), ("int8+gqa2", 2, True))
VARIANT_MAX_LEN = 511
VARIANT_TIMED = 3
# (b) an MoE large2 trained and served: Scheme A (B2, the preset's own,
# has no control tokens to serve, and B3 serves solo only), 8 experts in
# every second layer
MOE_TRAIN_ARGS = ["train", "--preset", "large2", "--corrected", "--scheme",
                  "a", "--experts", "8", "--moe-every", "2", "--synthetic",
                  "256", "--epochs", "1", "--save-every", "8",
                  "--log-every", "4", "--seed", "0"]
MOE_BURST_SEEDS = (41, 42, 43, 44)
MOE_SOLO = {"prompt": BURST_TEXTS[0], "seed": "7"}
VARIANT_KERNELS = ("flash_attention", "fused_ffn", "flash_decode_sp",
                   "top_k_mask", "flash_decode_fold_sp")
# (c) K1 and K3 at demo_ckpt_b3's heads after convert-gqa: H 4, Dh 48
GQA_B3_SHAPES = ((4, 2, 48), (4, 1, 48))


def _variant_params(torch, name, kv_heads, quant):
    """scenario 8's weights for one configuration on the card, and for the
    int8 ones q and s made on the card against the host's."""
    from eamg_tpu_torch.models.gpt import GPTConfig, init_params
    from eamg_tpu_torch.models.quant import quantize_params
    from eamg_tpu_torch.train.trainer import tree_leaves, tree_map
    from eamg_tpu_torch.utils import prng

    cfg = GPTConfig(**VARIANT_BASE, n_kv_heads=kv_heads)
    params = init_params(prng.PRNGKey(0), cfg, device="cuda")
    if not quant:
        return cfg, tree_map(lambda p: p.to(torch.bfloat16), params)
    card = quantize_params(params)
    host = quantize_params(tree_map(lambda p: p.cpu(), params))
    pairs = list(zip(tree_leaves(card), tree_leaves(host)))
    differ = [i for i, (a, b) in enumerate(pairs)
              if a.dtype != b.dtype or not torch.equal(a.cpu(), b)]
    n_q = sum(a.dtype == torch.int8 for a, _ in pairs)
    log(f"[variants {name}] quantize_params on the card against the host: "
        f"{len(pairs)} leaves ({n_q} int8 q), {len(differ)} differ")
    if differ or n_q != 4 * cfg.n_layer + 1:
        raise AssertionError(f"variants {name}: q/s card against host: "
                             f"leaves {differ} differ, {n_q} int8 leaves")
    return cfg, card


def variants_decode(torch) -> dict:
    """(a) int8 and GQA decode: each configuration's batch-8 decode to 511
    (temperature 1, top-k 50, no EOS) once to capture its graphs, then
    VARIANT_TIMED times (tokens/s of the fastest, as scenario 8 reports);
    same-seed tokens from graphs equal the eager loop's; K1, K3, K4
    launched, and K2 on the float FFNs only. -> per config launches."""
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.utils import prng

    prompt = torch.zeros((8, 16), dtype=torch.int64)
    prompt[:, :3] = torch.tensor([1, 2, 3])
    prompt = prompt.cuda()
    n_gen = VARIANT_MAX_LEN - 3
    out, counts_by = {}, {}
    for name, kv_heads, quant in VARIANT_CONFIGS:
        cfg, params = _variant_params(torch, name, kv_heads, quant)

        def run(seed, eager=False):
            buf, n = generate_kv(params, prompt, 3, prng.PRNGKey(seed), cfg,
                                 VARIANT_MAX_LEN, temperature=1.0, top_k=50,
                                 eos_id=-1, pad_id=0,
                                 refeed_last_prompt=False, eager=eager)
            return buf.cpu(), n

        torch.cuda.synchronize()
        _build.reset_launch_counts()
        run(0)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        ts, toks = [], None
        for seed in range(1, VARIANT_TIMED + 1):
            t0 = time.perf_counter()
            buf, n = run(seed)
            ts.append(time.perf_counter() - t0)
            toks = toks if toks is not None else buf
        eager, _ = run(1, eager=True)
        rate = 8 * n_gen / min(ts)
        same = bool(torch.equal(eager, toks))
        log(f"[variants {name}] batch 8 to {VARIANT_MAX_LEN}: "
            f"{rate:.1f} tokens/s (best of {[round(t * 1000, 1) for t in ts]}"
            f" ms); graphs == eager loop (seed 1): {same}; launches of the "
            f"capturing run {counts}")
        if not same:
            raise AssertionError(f"variants {name}: the graphs' tokens "
                                 "differ from the eager loop's")
        for k in ("flash_attention", "flash_decode_sp", "top_k_mask"):
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"variants {name}: {k} not launched")
        if bool(counts.get("fused_ffn", 0)) == quant:
            raise AssertionError(f"variants {name}: fused_ffn launched "
                                 f"{counts.get('fused_ffn', 0)} times")
        out[name] = {"tokens_per_s": rate, "seconds": ts,
                     "graphs_equal_eager": same}
        counts_by[name] = counts
        del params
    base = out["bf16"]["tokens_per_s"]
    log("[variants] scenario 8 tokens/s: " + ", ".join(
        f"{k} {v['tokens_per_s']:.1f} ({v['tokens_per_s'] / base:.3f}x)"
        for k, v in out.items()))
    return out, counts_by


def _moe_setup(torch, cfg_like):
    """MOE_TRAIN_ARGS rebuilt from its parts: (cfg, tcfg, batches, initial
    params on the card)."""
    from eamg_tpu_torch.models.gpt import init_params
    from eamg_tpu_torch.train.data import batches, synthetic_corpus
    from eamg_tpu_torch.train.run import encode_corpus
    from eamg_tpu_torch.train.trainer import reference_preset
    from eamg_tpu_torch.utils import prng

    encoded, vocab = encode_corpus(synthetic_corpus(256, seed=0), "a",
                                   cfg_like.seq_len)
    tcfg = dataclasses.replace(reference_preset("large2"), epochs=1,
                               pad_id=vocab.pad_id)
    steps = list(batches(encoded, cfg_like.seq_len, vocab.pad_id,
                         tcfg.micro_batch, drop_last=False, shuffle_seed=0))
    return tcfg, steps, init_params(prng.PRNGKey(0), cfg_like,
                                    device="cuda")


def _moe_grads(torch, cfg, tcfg, params, x, y):
    """loss_fn_moe and its gradient at ``params`` for one batch -> (loss,
    CPU gradients)."""
    from eamg_tpu_torch.train.trainer import (loss_fn_moe, tree_leaves,
                                              tree_unflatten)

    live = [p.detach().clone().requires_grad_() for p in tree_leaves(params)]
    dev = live[0].device
    loss, _ = loss_fn_moe(tree_unflatten(params, live),
                          torch.from_numpy(x[0]).to(dev),
                          torch.from_numpy(y[0]).to(dev), cfg, tcfg.pad_id,
                          tcfg.moe_aux_weight)
    return float(loss.detach()), [g.cpu() for g in
                                  torch.autograd.grad(loss, live)]


@contextlib.contextmanager
def _relu_kinks(torch, masks: list, replay: bool):
    """Every ``torch.relu`` of the training forward (a dense FFN's, or an
    MoE layer's experts'), in call order: record its mask ``h > 0`` into
    ``masks`` (replay False), or apply the recorded masks instead (replay
    True: h * mask, whose gradient is the mask), so that a second device
    takes the first one's kinks; yields the count of elements whose own
    sign disagreed with the replayed mask."""
    real = torch.relu
    calls, flipped = [0], [0]

    def record(h):
        masks.append((h.detach() > 0).cpu())
        return real(h)

    def apply(h):
        m = masks[calls[0]].to(h.device)
        calls[0] += 1
        flipped[0] += int(((h.detach() > 0) != m).sum())
        return h * m.to(h.dtype)

    torch.relu = apply if replay else record
    try:
        yield flipped
    finally:
        torch.relu = real


def _leaf_names(tree, prefix: str = "") -> list:
    """The paths of a tree's leaves in ``tree_leaves`` order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def _moe_serve(torch, ckpt_dir: str) -> dict:
    """`serve --checkpoint` of the MoE model: a WAV twice with one seed
    (equal bytes), a MIDI, the other seeds of MOE_BURST_SEEDS; then `serve
    --coalesce --slots 8`: each seed alone (the detached route), then the
    four at once, each row's bytes its lone request's (the solo server's
    beside them, logged). -> launches by route."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve import shutdown_gracefully

    plan = [{"prompt": BURST_TEXTS[i % len(BURST_TEXTS)], "seed": str(s)}
            for i, s in enumerate(MOE_BURST_SEEDS)]
    plan[0] = dict(MOE_SOLO)
    out, solo = {}, []
    for tag, extra in (("solo", []), ("coalesce", ["--coalesce", "--slots",
                                                   str(ENGINE_SLOTS)])):
        pipe = cli.pipeline_from_args(cli.parse_args(
            ["serve", "--checkpoint", ckpt_dir] + extra))
        pipe.warmup()
        server, thread, port = _serving(pipe)
        try:
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            if tag == "solo":
                a = _post(port, MOE_SOLO)
                b = _post(port, MOE_SOLO)
                for r in (a, b):
                    _check_reply("variants moe solo", MOE_SOLO, "", r)
                midi = {**MOE_SOLO, "seed": "11"}
                _check_reply("variants moe solo", midi, "?format=midi",
                             _post(port, midi, "?format=midi"))
                if a[1] != b[1]:
                    raise AssertionError("variants moe solo: same-seed WAV "
                                         "bytes differ")
                solo.append(a[1])
                for f in plan[1:]:
                    r = _post(port, f)
                    _check_reply("variants moe solo", f, "", r)
                    solo.append(r[1])
            else:
                lone = []
                for f in plan:
                    r = _post(port, f)
                    _check_reply("variants moe lone", f, "", r)
                    lone.append(r[1])
                replies, errors = {}, []

                def hit(i, f):
                    try:
                        replies[i] = _post(port, f)
                    except Exception as exc:  # noqa: BLE001 - below
                        errors.append(f"{i}: {type(exc).__name__}: {exc}")

                threads = [threading.Thread(target=hit, args=(i, f),
                                            daemon=True)
                           for i, f in enumerate(plan)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                if errors or len(replies) != len(plan):
                    raise AssertionError(f"variants moe burst: {errors}")
                for i, f in enumerate(plan):
                    _check_reply("variants moe burst", f, "", replies[i])
                same = [replies[i][1] == lone[i] for i in range(len(plan))]
                as_solo = [lone[i] == solo[i] for i in range(len(plan))]
                stats = dict(pipe.batcher.stats)
                log(f"[variants moe coalesce] burst of {len(plan)}: each "
                    f"row's bytes its lone request's: {same}; the solo "
                    f"server's (another program: K3 at batch 1, not row 8 "
                    f"at 8 rows): {as_solo}; engine admitted "
                    f"{stats.get('admitted')}, served {stats.get('served')}")
                if not all(same):
                    raise AssertionError("variants moe: a burst row's bytes "
                                         "differ from its lone request's")
                out["engine_equals_solo_server"] = as_solo
            torch.cuda.synchronize()
            counts = _build.launch_counts()
        finally:
            server.shutdown()
            shutdown_gracefully(server, pipe)
            thread.join(timeout=30)
        _require_launched(tag, counts)
        log(f"[variants moe {tag}] launches {counts}")
        out[tag] = counts
    return out


def variants_moe(torch, tmp: str) -> dict:
    """(b) `cli train` of an MoE large2 (16 steps, a checkpoint every 8),
    the same run rebuilt from its parts and timed on the card, the first
    step's loss and gradient card against host, then its checkpoint
    served solo and through the engine."""
    from eamg_tpu_torch.train.trainer import Trainer, tree_map
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    run_dir = os.path.join(tmp, "moe")
    t0 = time.perf_counter()
    lines = _cli_run("variants moe train", MOE_TRAIN_ARGS + ["--out",
                                                             run_dir])
    cli_s = time.perf_counter() - t0
    logged = _logged_losses(lines)
    summary = json.loads(lines[-1])
    ck = load_checkpoint(os.path.join(run_dir, "final"))
    cfg = ck["cfg"]
    moe_layers = [i for i, p in enumerate(ck["params"]["layers"])
                  if "router" in p["mlp"]]
    if summary["steps"] != TRAIN_STEPS or sorted(logged) != [4, 8, 12, 16] \
            or not all(math.isfinite(v) for v, _ in logged.values()):
        raise AssertionError(f"variants moe: {summary}, logged {logged}")
    if (cfg.n_experts, cfg.moe_every, moe_layers) != (8, 2, [1, 3, 5]):
        raise AssertionError(f"variants moe: config {cfg}, MoE layers "
                             f"{moe_layers}")
    if not os.path.exists(os.path.join(run_dir, "latest", "params.pkl")):
        raise AssertionError("variants moe: no latest checkpoint")

    tcfg, steps, params = _moe_setup(torch, cfg)
    init = tree_map(lambda p: p.detach().clone(), params)
    timed = _timed_steps(torch, Trainer(cfg, tcfg, params, device="cuda"),
                         steps, "moe")
    host_init = tree_map(lambda p: p.cpu(), init)
    masks = []
    with _relu_kinks(torch, masks, replay=False):
        loss_c, g_card = _moe_grads(torch, cfg, tcfg, init, *steps[0])
    t1 = time.perf_counter()
    loss_h, g_host = _moe_grads(torch, cfg, tcfg, host_init, *steps[0])
    host_s = time.perf_counter() - t1
    with _relu_kinks(torch, masks, replay=True) as flipped:
        _, g_kinked = _moe_grads(torch, cfg, tcfg, host_init, *steps[0])
    rel = abs(loss_c - loss_h) / abs(loss_h)
    g_scale = max(float(g.abs().max()) for g in g_host)

    def worst(gs):
        return max(((float((a - b).abs().max()), n) for a, b, n in
                    zip(g_card, gs, _leaf_names(init))))

    g_gap, at = worst(g_host)
    k_gap, k_at = worst(g_kinked)
    n_relu = sum(m.numel() for m in masks)
    log(f"[variants moe] `cli train` {cli_s:.1f} s, logged {logged}; "
        f"rebuilt: step 1 loss card {loss_c} host {loss_h} (rel |delta| "
        f"{rel:.3e}); gradient max |delta| {g_gap:.3e} ({at}) against max "
        f"|g| {g_scale:.3e}; the host's relu took {flipped[0]} of {n_relu} "
        f"kinks the other way (a pre-activation within rounding of 0); with "
        f"the card's kinks the host's gradient max |delta| {k_gap:.3e} "
        f"({k_at}); host step {host_s:.1f} s")
    if rel > HOST_LOSS_RTOL or k_gap > HOST_GRAD_TOL * g_scale:
        raise AssertionError(f"variants moe: card against host: loss rel "
                             f"{rel}, gradient {k_gap} of {g_scale} with "
                             "the card's kinks")
    if flipped[0] > 1e-6 * n_relu:
        raise AssertionError(f"variants moe: {flipped[0]} relu kinks of "
                             f"{n_relu} differ card against host")
    for step, (v, _) in logged.items():
        if abs(round(timed["losses"][step - 1], 4) - v) > 1.5e-4:
            raise AssertionError(f"variants moe: step {step} logged {v}, "
                                 f"rebuilt {timed['losses'][step - 1]}")
    served = _moe_serve(torch, os.path.join(run_dir, "final"))
    served["top_k_margin"] = _top_k_margin(torch, cfg, ck["params"],
                                           steps[0][0][0])
    rates = _moe_decode_rates(torch, cfg, ck["params"])
    return {"cli": {"summary": summary, "logged": logged,
                    "seconds": cli_s},
            "timed": {k: timed[k] for k in ("ms_per_step_median",
                                            "ms_per_step",
                                            "target_tokens_per_s",
                                            "max_memory_allocated_bytes",
                                            "losses")},
            "host": {"loss_rel_delta": rel, "grad_max_abs_delta": g_gap,
                     "grad_max_abs_delta_card_kinks": k_gap,
                     "relu_kinks_flipped": flipped[0], "relu_elements": n_relu,
                     "grad_max_abs": g_scale, "host_seconds": host_s},
            "served": served, "decode_rates": rates}


def _top_k_margin(torch, cfg, params, x) -> dict:
    """The trained model's next-token logits over a batch of corpus rows
    on the card: the median and smallest gap between the 50th and 51st
    largest logit (top-k 50's boundary), and the median top probability."""
    from eamg_tpu_torch.models.gpt import forward
    from eamg_tpu_torch.train.trainer import tree_map

    logits = forward(tree_map(lambda t: t.cuda(), params),
                     torch.from_numpy(x[:, :64]).long().cuda(), cfg)
    logits = logits.reshape(-1, logits.shape[-1])
    top = logits.topk(51, dim=-1).values
    gap = (top[:, 49] - top[:, 50]).float()
    out = {"gap_median": float(gap.median()), "gap_min": float(gap.min()),
           "top_prob_median": float(torch.softmax(logits, -1).amax(-1)
                                    .median())}
    log(f"[variants moe] the trained model's next-token logits on "
        f"{logits.shape[0]} corpus positions: 50th - 51st largest, median "
        f"{out['gap_median']:.3e}, min {out['gap_min']:.3e}; top "
        f"probability median {out['top_prob_median']:.4f} (V "
        f"{cfg.vocab_size})")
    return out


def _moe_decode_rates(torch, cfg, moe_params) -> dict:
    """Batch-1 decode to 511 (no EOS, top-k 50) of the trained MoE model and
    of a dense model of its config (random weights of key 0): tokens/s,
    the best of VARIANT_TIMED runs after a capturing one."""
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.models.gpt import init_params
    from eamg_tpu_torch.train.trainer import tree_map
    from eamg_tpu_torch.utils import prng

    prompt = torch.zeros((1, 16), dtype=torch.int64)
    prompt[0, :3] = torch.tensor([1, 2, 3])
    prompt = prompt.cuda()
    dense_cfg = dataclasses.replace(cfg, n_experts=None)
    out = {}
    for tag, c, p in (("moe", cfg, tree_map(lambda t: t.cuda(), moe_params)),
                      ("dense", dense_cfg, init_params(
                          prng.PRNGKey(0), dense_cfg, device="cuda"))):
        ts = []
        for seed in range(VARIANT_TIMED + 1):
            t0 = time.perf_counter()
            buf, n = generate_kv(p, prompt, 3, prng.PRNGKey(seed), c,
                                 VARIANT_MAX_LEN, temperature=1.0, top_k=50,
                                 eos_id=-1, pad_id=0,
                                 refeed_last_prompt=False)
            buf.cpu()
            ts.append(time.perf_counter() - t0)
        out[tag] = (VARIANT_MAX_LEN - 3) / min(ts[1:])
    log(f"[variants moe] batch-1 decode to {VARIANT_MAX_LEN} (f32, "
        f"{cfg.n_layer} layers, V {cfg.vocab_size}): MoE {out['moe']:.1f} "
        f"tokens/s, dense {out['dense']:.1f} "
        f"({out['moe'] / out['dense']:.3f}x)")
    return out


def _gqa_kernel_checks(torch) -> dict:
    """K1 and K3 against their plain versions at the converted B3 heads
    (H 4, Hkv 2 and 1, Dh 48), f32 and bf16, at the served shapes: a
    16-slot prompt bucket of 5 tokens, causal; a 256-slot cache, t at a
    fresh prompt, mid-song and the last slot."""
    from eamg_tpu_torch.ops import attention, decode_attention

    g = torch.Generator().manual_seed(48)
    out = {}
    for H, Hkv, Dh in GQA_B3_SHAPES:
        for dt, dt_name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            q, k, v = (torch.randn(1, h, 16, Dh, generator=g).to(dt).cuda()
                       for h in (H, Hkv, Hkv))
            vl = torch.tensor([5], dtype=torch.int32, device="cuda")
            err1 = float((attention.flash_attention(q, k, v, vl, causal=True)
                          .float() - attention.attention_plain(
                              q, k, v, vl, causal=True).float())
                         .abs().max())
            qd, kc, vc = (torch.randn(1, h, m, Dh, generator=g).to(dt).cuda()
                          for h, m in ((H, 1), (Hkv, 256), (Hkv, 256)))
            err3 = 0.0
            for t in (4, 130, 255):
                tt = torch.tensor([t], dtype=torch.int32, device="cuda")
                err3 = max(err3, float((decode_attention.flash_decode_sp(
                    qd, kc, vc, tt).float()
                    - decode_attention.decode_attention_plain(
                        qd, kc, vc, tt).float()).abs().max()))
            tol1 = TOL[("flash_attention", dt_name)]
            tol3 = TOL[("flash_decode_sp", dt_name)]
            log(f"[variants gqa kernels] H {H} Hkv {Hkv} Dh {Dh} {dt_name}: "
                f"K1 max|kernel - plain| {err1:.3e} (tol {tol1}), K3 "
                f"{err3:.3e} (tol {tol3})")
            if not (err1 <= tol1 and err3 <= tol3):
                raise AssertionError(f"variants: K1 {err1} / K3 {err3} at H "
                                     f"{H} Hkv {Hkv} Dh {Dh} {dt_name}")
            out[f"h{H}_kv{Hkv}_{dt_name}"] = {"k1": err1, "k3": err3}
    return out


def variants_convert(torch, tmp: str) -> dict:
    """(c) convert-gqa on demo_ckpt_b3 to 2 and 1 KV heads, each served
    solo; (d) export-pt then convert-pt of demo_ckpt_b3 (the round trip
    is B3's params cast to f32), export-pt refusing demo_ckpt_a (GQA), and
    `cli generate` on the converted checkpoint. -> launches by route."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve import shutdown_gracefully
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_A, DEMO_CKPT_B3
    from eamg_tpu_torch.train.trainer import tree_leaves
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    out, counts_by = {}, {}
    for kv in (2, 1):
        dst = os.path.join(tmp, f"b3_gqa{kv}")
        _cli_run(f"variants convert-gqa {kv}", [
            "convert-gqa", "--ckpt", DEMO_CKPT_B3, "--out", dst,
            "--kv-heads", str(kv)])
        pipe = cli.pipeline_from_args(cli.parse_args(
            ["serve", "--checkpoint", dst]))
        if pipe.generator.cfg.kv_heads != kv:
            raise AssertionError(f"convert-gqa: {pipe.generator.cfg}")
        pipe.warmup()
        server, thread, port = _serving(pipe)
        try:
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            _check_reply(f"variants b3 gqa{kv}", MOE_SOLO, "",
                         _post(port, MOE_SOLO))
            torch.cuda.synchronize()
            counts = _build.launch_counts()
        finally:
            server.shutdown()
            shutdown_gracefully(server, pipe)
            thread.join(timeout=30)
        _require_launched("solo", counts)
        counts_by[f"gqa{kv}"] = counts
    out["kernels"] = _gqa_kernel_checks(torch)

    pt = os.path.join(tmp, "b3.pt")
    conv = os.path.join(tmp, "b3_from_pt")
    _cli_run("variants export-pt", ["export-pt", "--ckpt", DEMO_CKPT_B3,
                                    "--pt", pt])
    _cli_run("variants convert-pt", ["convert-pt", "--pt", pt, "--out",
                                     conv])
    src, back = load_checkpoint(DEMO_CKPT_B3), load_checkpoint(conv)
    pairs = list(zip(tree_leaves(src["params"]), tree_leaves(back["params"])))
    equal = all(b.dtype == torch.float32 and torch.equal(a.float(), b)
                for a, b in pairs)
    log(f"[variants pt] demo_ckpt_b3 -> export-pt -> convert-pt: {len(pairs)}"
        f" leaves, every one B3's cast to f32: {equal}; config {back['cfg']}")
    if not equal or back["vocab"] != src["vocab"]:
        raise AssertionError("variants: the .pt round trip changed B3")
    try:
        _cli_run("variants export-pt A", ["export-pt", "--ckpt", DEMO_CKPT_A,
                                          "--pt", os.path.join(tmp, "a.pt")])
        refused = None
    except ValueError as e:
        refused = str(e)
    log(f"[variants pt] export-pt on demo_ckpt_a (GQA-2): {refused}")
    if not refused or "GQA" not in refused:
        raise AssertionError("variants: export-pt did not refuse GQA")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    mid = os.path.join(tmp, "b3_from_pt.mid")
    _cli_run("variants generate", ["generate", "--checkpoint", conv,
                                   "--max-len", "128", "--seed", "3",
                                   "--out", mid])
    with open(mid, "rb") as f:
        if f.read(4) != b"MThd":
            raise AssertionError("variants generate: not a MIDI file")
    torch.cuda.synchronize()
    counts_by["generate"] = _build.launch_counts()
    out["pt_round_trip_equal"] = equal
    return out, counts_by


def serve_variants(torch, card: str) -> dict:
    """Phase variants: (a) int8 and GQA decode, (b) an MoE model trained and
    served, (c) convert-gqa served, (d) export-pt / convert-pt, (e)
    gqa-recover at the CLI's defaults. -> launch counts over the phase."""
    import tempfile

    from eamg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    out = {"card": card}
    counts = collections.Counter()
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        out["decode"], by = variants_decode(torch)
        secs["a_decode"] = time.perf_counter() - t
        for c in by.values():
            counts.update(c)
        t = time.perf_counter()
        _build.reset_launch_counts()
        out["moe"] = variants_moe(torch, tmp)
        torch.cuda.synchronize()
        counts.update(_build.launch_counts())
        secs["b_moe"] = time.perf_counter() - t
        t = time.perf_counter()
        out["convert"], by = variants_convert(torch, tmp)
        for c in by.values():
            counts.update(c)
        secs["cd_convert"] = time.perf_counter() - t
        t = time.perf_counter()
        _build.reset_launch_counts()
        lines = _cli_run("variants gqa-recover", ["gqa-recover"])
        torch.cuda.synchronize()
        counts.update(_build.launch_counts())
        out["gqa_recover"] = json.loads(lines[-1])
        secs["e_gqa_recover"] = time.perf_counter() - t
    counts = dict(counts)
    for name in VARIANT_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"variants: {name} was not launched")
    out["seconds"] = secs
    out["phase_s"] = time.perf_counter() - t0
    log(json.dumps({"variants": out}))
    log(f"[variants] phase {out['phase_s']:.1f} s ({secs}); launches "
        f"{counts}")
    return counts


# --------------------------------------------------------------- emotion

# (a) the shipped classifier's own recipe (the CLI's defaults: d256 L4 h4,
# hidden 768, max_length 64, 1200 rows a label, pool max, cue suppression
# 0.3, seed 2026), cut from 12 epochs to 2
EMOTION_ARGS = ["distill-emotion", "--epochs", "2"]
# (b) MLM pretraining and pool cls, cut to 200 rows a label and 2 epochs
# (one classifier epoch is refused, as JAX refuses it: optax's cosine
# decay then has no steps)
EMOTION_MLM_ARGS = ["distill-emotion", "--pool", "cls", "--pretrain-epochs",
                    "1", "--epochs", "2", "--n-per-label", "200"]
EMOTION_DEVICE = "cuda"
EMOTION_TIMED_FROM = 20         # ms a step: the median of steps 20..
EMOTION_LOSS_RTOL = 1e-5        # step 1's loss, card against host (f16
                                # base included: one program, one rounding)
EMOTION_GRAD_TOL = 1e-5         # step 1's gradient, x max|g| over leaves
EMOTION_PROFILED_STEPS = 8
EMOTION_PROBS_ATOL = 1e-5       # the trained classifier, card against host
FINETUNE_ROWS = 1600            # (c) rows of the TSV: 100 steps of 16
EMOTION_TEXTS = BURST_TEXTS + ("the contractor took our deposit and never "
                               "showed, i am fuming", "meh")
EMOTION_KERNELS = ("flash_attention", "fused_ffn", "flash_decode_sp",
                   "top_k_mask")


@contextlib.contextmanager
def _timed_steps_of(torch, module, factory: str, marks: list,
                    first: dict | None = None):
    """Each step that ``module.factory`` makes runs between two CUDA events
    appended to ``marks``; with ``first``, the first call's arguments (CPU
    copies, taken before the step updates them) and its result are kept
    there under "args" and "out"."""
    real = getattr(module, factory)

    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [copy(v) for v in x]
        return x.detach().cpu().clone() if hasattr(x, "detach") else x

    def make(*a, **kw):
        made = real(*a, **kw)
        step = made[0] if isinstance(made, tuple) else made

        def timed(*sa):
            keep = first is not None and "args" not in first
            if keep:
                first["args"] = copy(sa)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step(*sa)
            e1.record()
            marks.append((e0, e1))
            if keep:
                first["out"] = out
            return out

        return (timed,) + made[1:] if isinstance(made, tuple) else timed

    setattr(module, factory, make)
    try:
        yield
    finally:
        setattr(module, factory, real)


@contextlib.contextmanager
def _timed_encodes(module, seconds: list):
    """The host's training encodes (those with piece dropout) of
    ``module._encode_all``, each one's seconds appended to ``seconds``."""
    real = module._encode_all

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = real(*a, **kw)
        if kw.get("piece_dropout"):
            seconds.append(time.perf_counter() - t0)
        return out

    module._encode_all = timed
    try:
        yield
    finally:
        module._encode_all = real


def _median_ms(marks: list, start: int) -> tuple:
    ms = [a.elapsed_time(b) for a, b in marks]
    timed = ms[start - 1:] or ms
    return sorted(timed)[len(timed) // 2], ms


@contextlib.contextmanager
def _max_choices(db, picks: list, replay: bool):
    """Every masked max over positions of the classifier (``masked_max``):
    record the position each (row, label) takes (replay False), or take
    the recorded ones instead (replay True), so that the host follows the
    card's choice; yields the count of choices the host would have made
    otherwise."""
    real = db.masked_max
    calls, differ = [0], [0]

    def record(tok, mask):
        out = real(tok, mask)
        picks.append((tok.detach() == out.detach()[:, None]).float()
                     .argmax(1).cpu())
        return out

    def apply(tok, mask):
        idx = picks[calls[0]].to(tok.device)
        calls[0] += 1
        own = (tok.detach() == real(tok, mask).detach()[:, None]).float() \
            .argmax(1)
        differ[0] += int((own != idx).sum())
        return tok.gather(1, idx[:, None, :])[:, 0]

    db.masked_max = apply if replay else record
    try:
        yield differ
    finally:
        db.masked_max = real


def _emotion_step1(torch, tag: str, cfg, params, batch: dict) -> dict:
    """The distill step's loss and gradient at ``params`` on ``batch``, on
    the card and on the host (TF32 off; the host replays the card's relu
    kinks and max-pool choices) -> the gaps, checked."""
    from eamg_tpu_torch.emotion import train_scratch as ts
    from eamg_tpu_torch.models import distilbert as db
    from eamg_tpu_torch.train.trainer import tree_leaves, tree_unflatten

    def run(device, replay, masks, picks):
        live = [p.detach().to(device).clone().requires_grad_()
                for p in tree_leaves(params)]
        b = {k: v.to(device) for k, v in batch.items()}
        with _relu_kinks(torch, masks, replay) as flipped, \
                _max_choices(db, picks, replay) as moved:
            loss, _ = ts.classifier_loss(
                tree_unflatten(params, live), b["ids"], b["mask"],
                b["labels"], b["cue"], cfg, 0.05, 0.3)
            grads = torch.autograd.grad(loss, live, materialize_grads=True)
        return float(loss.detach()), [g.cpu() for g in grads], flipped[0], \
            moved[0]

    masks, picks = [], []
    card_loss, card_g, _, _ = run(EMOTION_DEVICE, False, masks, picks)
    host_loss, host_g, flips, moves = run("cpu", True, masks, picks)
    scale = max(float(g.abs().max()) for g in host_g)
    gap = max(float((a - b).abs().max()) for a, b in zip(card_g, host_g))
    rel = abs(card_loss - host_loss) / abs(host_loss)
    out = {"card_loss": card_loss, "host_loss": host_loss, "loss_rel": rel,
           "grad_gap": gap, "grad_scale": scale, "relu_flips": flips,
           "max_pool_moves": moves}
    log(f"[emotion {tag}] step 1 card against host (TF32 off): loss "
        f"{card_loss:.8f} / {host_loss:.8f} (rel {rel:.2e}), gradient gap "
        f"{gap:.3e} of max|g| {scale:.3e}; relu kinks the host took from "
        f"the card {flips}, max-pool positions {moves}")
    if rel > EMOTION_LOSS_RTOL or gap > EMOTION_GRAD_TOL * scale:
        raise AssertionError(f"emotion {tag}: step 1 card against host: "
                             f"{out}")
    return out


def emotion_distill(torch, tmp: str) -> dict:
    """(a) `distill-emotion --epochs 2` (the shipped recipe otherwise):
    steps, ms a step, rows/s, host encode seconds an epoch, peak memory,
    metrics.json; step 1 at this width card against host."""
    import pickle

    from eamg_tpu_torch import cli
    from eamg_tpu_torch.emotion import train_scratch as ts
    from eamg_tpu_torch.emotion.distill_data import (build_wordpiece_vocab,
                                                     make_corpus,
                                                     tokenizer_corpus)
    from eamg_tpu_torch.models import distilbert as db
    from eamg_tpu_torch.utils import prng

    out_dir = os.path.join(tmp, "distill")
    argv = EMOTION_ARGS + ["--out", out_dir, "--device", EMOTION_DEVICE]
    a = cli.parse_args(argv)
    marks, encodes = [], []
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()   # what earlier phases hold
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _timed_steps_of(torch, ts, "make_classifier_step", marks), \
            _timed_encodes(ts, encodes):
        lines = _cli_run("emotion distill", argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    metrics = json.loads(lines[-1])
    med, ms = _median_ms(marks, EMOTION_TIMED_FROM)
    with open(os.path.join(out_dir, "metrics.json")) as f:
        on_disk = json.load(f)
    res = {"seconds": secs, "steps": len(ms), "ms_per_step_median": med,
           "rows_per_s": 64 / (med / 1000),
           "encode_s_per_epoch": encodes,
           "max_memory_allocated_bytes": peak,
           "allocated_before_bytes": before, "metrics": metrics}
    log(f"[emotion distill] {len(ms)} steps in {secs:.1f} s: median "
        f"{med:.3f} ms a step (steps {EMOTION_TIMED_FROM}..), "
        f"{res['rows_per_s']:.0f} rows/s, host encode "
        f"{[round(s, 2) for s in encodes]} s an epoch, peak memory "
        f"{peak / 2**20:.1f} MiB, {(peak - before) / 2**20:.1f} MiB above "
        f"the {before / 2**20:.1f} MiB allocated before the run; "
        f"metrics.json {json.dumps(on_disk)}")
    accs = [v for k, v in on_disk.items()
            if k.endswith(("_acc", "_top3", "_distilbert")) and v is not None]
    res["beats_lexicon_on_eval"] = \
        on_disk["eval_acc_distilbert"] > on_disk["eval_acc_lexicon"]
    log(f"[emotion distill] eval accuracy {on_disk['eval_acc_distilbert']}"
        f" against the lexicon's {on_disk['eval_acc_lexicon']} (logged: two "
        f"epochs, the first all warmup, are a cut of the recipe's twelve)")
    if len(ms) != a.epochs * (metrics["n_train"] // 64) or not accs or \
            not all(0.0 <= v <= 1.0 for v in accs):
        raise AssertionError(f"emotion distill: {len(ms)} steps, metrics "
                             f"{on_disk}")
    # step 1 at this width: the run's initial weights, its first 64 train
    # rows with their cue spans
    data = make_corpus(n_per_label=a.n_per_label, seed=a.seed,
                       gen_per_label=a.gen_per_label)
    tok = db.WordPieceTokenizer(build_wordpiece_vocab(
        tokenizer_corpus(data["train"][0])))
    with open(os.path.join(out_dir, "config.pkl"), "rb") as f:
        cfg = db.DistilBertConfig(**pickle.load(f))
    ids, mask, cue = ts._encode_all(tok, data["train"][0][:64],
                                    cfg.max_position_embeddings,
                                    cues=data["train_cues"][:64])
    batch = {"ids": torch.from_numpy(ids), "mask": torch.from_numpy(mask),
             "cue": torch.from_numpy(cue),
             "labels": torch.tensor(data["train"][1][:64])}
    params = db.init_params(prng.PRNGKey(a.seed), cfg,
                            device=EMOTION_DEVICE)
    res["step1"] = _emotion_step1(torch, "distill", cfg, params, batch)
    res["profile"] = _emotion_profile(torch, cfg, params, batch, med)
    res["out_dir"] = out_dir
    return res


def _emotion_profile(torch, cfg, params, batch: dict, step_ms: float):
    """EMOTION_PROFILED_STEPS classifier steps of the recipe on ``batch``
    under torch.profiler, after two untraced ones: device busy a step,
    the traced and the untraced idle share (1 - busy / the run's median
    step), kernels and host launch calls a step."""
    from eamg_tpu_torch.emotion import train_scratch as ts
    from eamg_tpu_torch.train.trainer import tree_leaves

    spec = ts.ScratchSpec(pool="max", cue_suppress=0.3)
    opt = ts.scratch_optimizer(spec, 796, 1592)
    state = opt.init(tree_leaves(params))
    step = ts.make_classifier_step(cfg, spec, opt)
    b = [batch[k].to(EMOTION_DEVICE) for k in ("ids", "mask", "labels",
                                               "cue")]
    for _ in range(2):
        step(params, state, *b)

    def work():
        for _ in range(EMOTION_PROFILED_STEPS):
            step(params, state, *b)
        return 64 * EMOTION_PROFILED_STEPS

    prof = _trace(torch, "emotion distill", work)
    n = EMOTION_PROFILED_STEPS
    busy = prof["device_busy_ms"] / n
    out = {"wall_ms_per_step": prof["wall_ms"] / n,
           "device_busy_ms_per_step": busy,
           "idle_share_traced": prof["idle_share"],
           "idle_share_untraced": 1 - busy / step_ms,
           "kernels_per_step": prof["launches"] / n,
           "host_launches_per_step": prof["host_launches"] / n,
           "device_ms_by_group": {k: v / n for k, v in
                                  prof["device_ms_by_group"].items()}}
    log(f"[emotion distill] {n} steps traced: {json.dumps(out)}")
    return out


def emotion_mlm(torch, tmp: str) -> dict:
    """(b) MLM pretraining, then pool cls: the masked NLL and ms a step of
    each trainer."""
    from eamg_tpu_torch.emotion import train_scratch as ts

    mlm_marks, cls_marks = [], []
    t0 = time.perf_counter()
    with _timed_steps_of(torch, ts, "make_mlm_step", mlm_marks), \
            _timed_steps_of(torch, ts, "make_classifier_step", cls_marks):
        lines = _cli_run("emotion mlm", EMOTION_MLM_ARGS + [
            "--out", os.path.join(tmp, "mlm"), "--device", EMOTION_DEVICE])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nll = [float(m.group(1)) for m in
           (re.search(r"\[mlm\] epoch \d+/\d+: masked_nll=(\S+)", line)
            for line in lines) if m]
    mlm_med, mlm_ms = _median_ms(mlm_marks, EMOTION_TIMED_FROM)
    cls_med, cls_ms = _median_ms(cls_marks, EMOTION_TIMED_FROM)
    metrics = json.loads(lines[-1])
    res = {"seconds": secs, "masked_nll": nll, "mlm_steps": len(mlm_ms),
           "mlm_ms_per_step_median": mlm_med, "cls_steps": len(cls_ms),
           "cls_ms_per_step_median": cls_med,
           "eval_acc_distilbert": metrics["eval_acc_distilbert"],
           "vocab_size": metrics["vocab_size"]}
    log(f"[emotion mlm] {json.dumps(res)}")
    if len(nll) != 1 or not math.isfinite(nll[0]) or \
            nll[0] >= math.log(metrics["vocab_size"]) or not cls_ms:
        raise AssertionError(f"emotion mlm: {res}")
    return res


def _np_leaves(tree, path: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _np_leaves(sub, f"{path}/{name}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _np_leaves(sub, f"{path}/{i}").items()}
    return {path: tree}


def emotion_finetune(torch, tmp: str) -> dict:
    """(c) `finetune-emotion` on the shipped f16 classifier at JAX's
    defaults (r 8, alpha 16, lr 5e-4, batch 16) for one epoch over
    FINETUNE_ROWS eval rows of (a)'s corpus: ms a step, the step-1 loss card
    against host, the final loss and params.pkl's dtype per leaf (JAX's:
    the merged q and v f32, the rest f16); then the library's finetune on
    an f32 copy of the same base, whose loss must fall."""
    import pickle

    import numpy as np

    from eamg_tpu_torch.emotion import finetune as ft
    from eamg_tpu_torch.emotion.distill_data import make_corpus
    from eamg_tpu_torch.emotion.infer import PACKAGED_CKPT
    from eamg_tpu_torch.models.distilbert import (DistilBertConfig,
                                                  WordPieceTokenizer)
    from eamg_tpu_torch.train.trainer import tree_leaves, tree_map

    base = str(PACKAGED_CKPT)
    with open(os.path.join(base, "config.pkl"), "rb") as f:
        cfg = DistilBertConfig(**pickle.load(f))
    with open(os.path.join(base, "params.pkl"), "rb") as f:
        raw = pickle.load(f)
    texts, labels = make_corpus(n_per_label=1200, seed=2026,
                                gen_per_label=0)["eval"]
    texts, labels = texts[:FINETUNE_ROWS], labels[:FINETUNE_ROWS]
    tsv = os.path.join(tmp, "finetune.tsv")
    with open(tsv, "w", encoding="utf-8") as f:
        f.writelines(f"{t}\t{l}\n" for t, l in zip(texts, labels))
    out_dir = os.path.join(tmp, "finetuned")
    marks, first = [], {}
    t0 = time.perf_counter()
    with _timed_steps_of(torch, ft, "make_finetune_step", marks, first):
        lines = _cli_run("emotion finetune", [
            "finetune-emotion", "--base", base, "--tsv", tsv, "--out",
            out_dir, "--epochs", "1", "--device", EMOTION_DEVICE])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    med, ms = _median_ms(marks, EMOTION_TIMED_FROM)
    card_loss = float(first["out"][2]["loss"])
    trainable, frozen, _, ids, mask, lab = first["args"]
    step, opt = ft.make_finetune_step(cfg, ft.LoraSpec())
    _, _, m = step(trainable, frozen, opt.init(tree_leaves(trainable)),
                   ids, mask, lab)
    host_loss = float(m["loss"])
    rel = abs(card_loss - host_loss) / abs(host_loss)
    with open(os.path.join(out_dir, "params.pkl"), "rb") as f:
        written = _np_leaves(pickle.load(f))
    f32 = sorted(k for k, a in written.items() if a.dtype == np.float32)
    want_f32 = sorted(f"/layers/{i}/{n}/w" for i in range(cfg.n_layers)
                      for n in ("q", "v"))
    heads = [a for k, a in written.items() if "classifier" in k]
    nonfinite = sum(int((~np.isfinite(a)).sum()) for a in heads) / sum(
        a.size for a in heads)
    final = json.loads(lines[-1])["final_loss"]
    res = {"seconds": secs, "steps": len(ms), "ms_per_step_median": med,
           "card_step1_loss": card_loss, "host_step1_loss": host_loss,
           "step1_rel": rel, "final_loss": final,
           "f32_leaves": f32 == want_f32,
           "heads_nonfinite_share": nonfinite}
    log(f"[emotion finetune] f16 base, {len(ms)} steps in {secs:.1f} s: "
        f"median {med:.3f} ms a step; step 1 loss card {card_loss:.8f} "
        f"host {host_loss:.8f} (rel {rel:.2e}); final loss {final}; "
        f"params.pkl f32 leaves exactly the merged q and v: {f32 == want_f32}"
        f"; heads non-finite {nonfinite:.4f} (JAX's f16 Adam: epsilon 0, "
        f"g^2 underflows)")
    if not math.isfinite(card_loss) or rel > EMOTION_LOSS_RTOL or \
            f32 != want_f32 or len(ms) != FINETUNE_ROWS // 16:
        raise AssertionError(f"emotion finetune: {res}")
    # the same run from an f32 copy of the base, through the library
    marks = []
    t0 = time.perf_counter()
    with _timed_steps_of(torch, ft, "make_finetune_step", marks):
        _, _, history = ft.finetune(
            tree_map(lambda a: np.asarray(a, np.float32), raw), cfg,
            WordPieceTokenizer(os.path.join(base, "vocab.txt")), texts,
            labels, spec=ft.LoraSpec(epochs=1), log_fn=lambda *_: None,
            device=EMOTION_DEVICE)
    torch.cuda.synchronize()
    losses = [h["loss"] for h in history]
    f32_med, _ = _median_ms(marks, EMOTION_TIMED_FROM)
    head, tail = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    res["f32_base"] = {"seconds": time.perf_counter() - t0,
                       "ms_per_step_median": f32_med,
                       "first_losses_mean": head, "last_losses_mean": tail,
                       "final_loss": losses[-1]}
    log(f"[emotion finetune] f32 copy of the base: "
        f"{json.dumps(res['f32_base'])}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"emotion finetune f32 base: losses {losses}")
    return res


def emotion_convert(torch, tmp: str) -> dict:
    """(d) `export-emotion-hf` of the shipped classifier, then
    `convert-distilbert`: every leaf back exactly (as f32); then `--push`
    without huggingface_hub (kept from importing, so no upload is tried)
    fails with JAX's RuntimeError."""
    import io
    import pickle
    from unittest import mock

    import numpy as np

    from eamg_tpu_torch.emotion.infer import PACKAGED_CKPT

    hf, back = os.path.join(tmp, "hf"), os.path.join(tmp, "hf_back")
    _cli_run("emotion export", ["export-emotion-hf", "--ckpt",
                                str(PACKAGED_CKPT), "--out", hf])
    _cli_run("emotion convert", ["convert-distilbert", "--hf-dir", hf,
                                 "--out", back])
    with open(PACKAGED_CKPT / "params.pkl", "rb") as f:
        shipped = _np_leaves(pickle.load(f))
    with open(os.path.join(back, "params.pkl"), "rb") as f:
        conv = _np_leaves(pickle.load(f))
    differ = [k for k in shipped
              if k not in conv or conv[k].dtype != np.float32
              or not np.array_equal(conv[k], shipped[k].astype(np.float32))]
    from eamg_tpu_torch import cli

    with mock.patch.dict(sys.modules, {"huggingface_hub": None}):
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["export-emotion-hf", "--ckpt", str(PACKAGED_CKPT),
                          "--out", os.path.join(tmp, "hf_push"), "--push",
                          "a/b"])
            pushed = "none"
        except RuntimeError as e:
            pushed = f"RuntimeError: {e}"
    res = {"leaves": len(shipped), "differ": differ, "push": pushed}
    log(f"[emotion convert] export then convert: {len(shipped)} leaves, "
        f"{len(differ)} differ; --push without huggingface_hub: {pushed}")
    if differ or len(conv) != len(shipped) or \
            pushed != "RuntimeError: huggingface_hub is not installed":
        raise AssertionError(f"emotion convert: {res}")
    return res


def emotion_serve(torch, ckpt_dir: str) -> dict:
    """(e) (a)'s checkpoint serves: its EmotionClassifier on the card
    against the host on EMOTION_TEXTS (probabilities within
    EMOTION_PROBS_ATOL), then one request through pipeline_from_checkpoint
    on demo_ckpt_a with it (seed 7): a WAV, the label and classify ms;
    the counts over the request."""
    import numpy as np

    from eamg_tpu_torch.emotion import EmotionClassifier
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve.pipeline import (DEMO_CKPT_A,
                                               pipeline_from_checkpoint)

    card = EmotionClassifier(checkpoint_dir=ckpt_dir, device=EMOTION_DEVICE)
    host = EmotionClassifier(checkpoint_dir=ckpt_dir, device="cpu")
    gap = max(float(np.abs(card._probs(t) - host._probs(t)).max())
              for t in EMOTION_TEXTS)
    labels = [card.predict(t) for t in EMOTION_TEXTS]
    pipe = pipeline_from_checkpoint(DEMO_CKPT_A, classifier=card,
                                    device=EMOTION_DEVICE)
    card._probs_cache.clear()      # the request classifies afresh
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    r = pipe.generate(EMOTION_TEXTS[0], seed=7)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    wav = r.wav_bytes or b""
    res = {"probs_gap": gap, "labels": labels, "label": r.label,
           "classify_ms": r.timings_ms["classify"], "wav_bytes": len(wav),
           "tokens": len(r.tokens)}
    log(f"[emotion serve] the trained classifier card against host: max "
        f"|probs gap| {gap:.2e} on {len(EMOTION_TEXTS)} texts, labels "
        f"{labels}; one request on demo_ckpt_a (seed 7): label {r.label}, "
        f"classify {r.timings_ms['classify']:.2f} ms, {len(r.tokens)} "
        f"tokens, {len(wav)} WAV bytes; launches {counts}")
    if gap > EMOTION_PROBS_ATOL or wav[:4] != b"RIFF" or \
            wav[8:12] != b"WAVE" or r.label != labels[0]:
        raise AssertionError(f"emotion serve: {res}")
    return res, counts


def serve_emotion(torch, card: str) -> dict:
    """Phase emotion: (a) distill-emotion, (b) MLM and pool cls, (c)
    finetune-emotion, (d) export then convert, (e) the trained classifier
    served. -> launch counts over the phase."""
    import tempfile

    from eamg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    out = {"card": card}
    secs = {}
    _build.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for key, fn in (("a_distill", emotion_distill),
                        ("b_mlm", emotion_mlm),
                        ("c_finetune", emotion_finetune),
                        ("d_convert", emotion_convert)):
            t = time.perf_counter()
            out[key] = fn(torch, tmp)
            secs[key] = time.perf_counter() - t
        t = time.perf_counter()
        out["e_serve"], counts = emotion_serve(
            torch, out["a_distill"]["out_dir"])
        secs["e_serve"] = time.perf_counter() - t
    for name in EMOTION_KERNELS:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"emotion: {name} was not launched")
    out["seconds"] = secs
    out["phase_s"] = time.perf_counter() - t0
    log(json.dumps({"emotion": out}))
    log(f"[emotion] phase {out['phase_s']:.1f} s ({secs}); launches "
        f"{counts}")
    return counts


# ---------------------------------------------------------------- parallel

PARALLEL_STEPS = 16
PP_LOSS_TOL = 1e-4              # PipelineTrainer's loss, against the plain
SEQ_PAR_TOL = 1e-4              # forward_seq_parallel (plain products)
EP_TOL = 1e-4                   # moe_mlp_ep against moe_mlp_dense, f32
# demo_ckpt_a's blocks on a model group of 2: H 4, Hkv 1, Dh 64, FF 1024
TP2_SHAPES = {"H": 4, "Hkv": 1, "Dh": 64, "D": 512, "FF": 1024, "M": 511}
PARALLEL_KERNELS = ("flash_attention", "fused_ffn", "flash_decode_sp",
                    "top_k_mask")


@contextlib.contextmanager
def _world_of_one(torch):
    """A world-1 NCCL process group for the phase, left at its end."""
    import tempfile

    import torch.distributed as dist

    from eamg_tpu_torch.parallel.multihost import init_distributed

    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(init_method=f"file://{tmp}/rdv", num_processes=1,
                         process_id=0, device="cuda:0")
        try:
            yield
        finally:
            dist.destroy_process_group()


def _mesh_vs_plain(torch, tag: str, cfg, tcfg, params, steps) -> dict:
    """(a) for one recipe: the plain trainer and the mesh trainer (1 x 1, tp
    and fsdp on) over ``steps``, in turns (plain, mesh, mesh, plain), each
    timed; the first mesh run bit-equal to the first plain run or it
    fails."""
    from eamg_tpu_torch.parallel.mesh import make_mesh
    from eamg_tpu_torch.train.trainer import Trainer, tree_leaves

    mtcfg = dataclasses.replace(tcfg, tp=True, fsdp=True)

    def run(kind: str, i: int):
        t = Trainer(cfg, tcfg, params, device="cuda") if kind == "plain" \
            else Trainer(cfg, mtcfg, params, device="cuda",
                         mesh=make_mesh(1, 1))
        return t, _timed_steps(torch, t, steps, f"{tag} {kind} {i}")

    plain, a = run("plain", 1)
    mesh, b = run("mesh", 1)
    same = (a["losses"] == b["losses"] and a["tokens"] == b["tokens"]
            and all(torch.equal(u, v) for u, v in zip(
                tree_leaves(plain.params), tree_leaves(mesh.params)))
            and all(torch.equal(u, v) for u, v in zip(
                plain.opt_state["mu"] + plain.opt_state["nu"],
                mesh.opt_state["mu"] + mesh.opt_state["nu"])))
    del plain, mesh
    c = run("mesh", 2)[1]
    d = run("plain", 2)[1]
    med = {k: r["ms_per_step_median"] for k, r in
           (("plain1", a), ("mesh1", b), ("mesh2", c), ("plain2", d))}
    log(f"[parallel {tag}] mesh step bit-equal to the plain step: {same}; "
        f"ms a step (median of steps {TIMED_FROM}..{len(steps)}) in turns "
        f"{med}")
    if not same:
        raise AssertionError(f"parallel: the 1x1 mesh step of {tag} is not "
                             "the plain step")
    return {"ms_per_step": med, "losses": b["losses"],
            "peak_bytes_mesh": b["max_memory_allocated_bytes"],
            "peak_bytes_plain": a["max_memory_allocated_bytes"]}


def _tp2_kernel_checks(torch) -> dict:
    """K1, K2 and K3 at demo_ckpt_a's tp-2 shard shapes against their plain
    versions (comparisons: their launches are not the phase's)."""
    from eamg_tpu_torch.ops import attention, decode_attention, ffn

    s = TP2_SHAPES
    g = torch.Generator().manual_seed(19)
    out = {}
    for dt, name in ((torch.float32, "float32"),
                     (torch.bfloat16, "bfloat16")):
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g) * scale).to(dt).cuda()

        q, k, v = rnd(1, s["H"], 16, s["Dh"]), rnd(1, s["Hkv"], 16, s["Dh"]),\
            rnd(1, s["Hkv"], 16, s["Dh"])
        vl = torch.tensor([5], dtype=torch.int32, device="cuda")
        e1 = float((attention.flash_attention(q, k, v, vl, causal=True)
                    .float() - attention.attention_plain(
                        q, k, v, vl, causal=True).float()).abs().max())
        x = rnd(1, 16, s["D"])
        w1, w2 = rnd(s["FF"], s["D"], scale=0.05), rnd(s["D"], s["FF"],
                                                       scale=0.05)
        b1, b2 = rnd(s["FF"], scale=0.05), torch.zeros(s["D"], dtype=dt,
                                                       device="cuda")
        e2 = max(float((ffn.fused_ffn(x[:, :rows], w1, b1, w2, b2,
                                      order="xla").float()
                        - ffn.ffn_plain(x[:, :rows], w1, b1, w2, b2,
                                        order="xla").float()).abs().max())
                 for rows in (1, 16))
        qd = rnd(1, s["H"], 1, s["Dh"])
        kc, vc = rnd(1, s["Hkv"], s["M"], s["Dh"]), \
            rnd(1, s["Hkv"], s["M"], s["Dh"])
        e3 = 0.0
        for t in (4, 300, 510):
            tt = torch.tensor([t], dtype=torch.int32, device="cuda")
            e3 = max(e3, float((decode_attention.flash_decode_sp(
                qd, kc, vc, tt).float() - decode_attention
                .decode_attention_plain(qd, kc, vc, tt).float()).abs().max()))
        tols = (TOL[("flash_attention", name)], TOL[("fused_ffn", name)],
                TOL[("flash_decode_sp", name)])
        log(f"[parallel tp2 kernels] {name}: K1 {e1:.3e} (tol {tols[0]}), "
            f"K2 {e2:.3e} (tol {tols[1]}), K3 {e3:.3e} (tol {tols[2]}) "
            f"at H {s['H']} Hkv {s['Hkv']} FF {s['FF']}")
        if not (e1 <= tols[0] and e2 <= tols[1] and e3 <= tols[2]):
            raise AssertionError(f"parallel: a kernel disagrees at the tp-2 "
                                 f"shapes ({name}: {e1}, {e2}, {e3})")
        out[name] = {"k1": e1, "k2": e2, "k3": e3}
    return out


def _tp_decode(torch, ckpt) -> tuple:
    """(e): generate_kv on demo_ckpt_a's params sharded for a model group
    of one against the unsharded decode, sampled, one seed. -> (record,
    the TP decode's launch counts)."""
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.parallel.collectives import tensor_parallel
    from eamg_tpu_torch.parallel.mesh import make_mesh, shard_params
    from eamg_tpu_torch.utils import prng

    cfg = ckpt["cfg"]
    params = {k: v for k, v in ckpt["params"].items()}
    params = _to_cuda(torch, params)
    mesh = make_mesh(1, 1)
    tp = tensor_parallel(cfg, mesh.get_group("model"))
    blocks = shard_params(params, mesh, tp=True, cfg=cfg)
    prompt = torch.zeros((1, 16), dtype=torch.int64, device="cuda")
    prompt[0, :5] = torch.tensor([1, 5, 9, 40, 41])
    kw = dict(greedy=False, eos_id=-1, pad_id=0, top_k=50)
    ref, n_ref = generate_kv(params, prompt, 5, prng.PRNGKey(7), cfg, 96,
                             **kw)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    got, n = generate_kv(blocks, prompt, 5, prng.PRNGKey(7), cfg, 96, tp=tp,
                         **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _build.launch_counts()
    same = torch.equal(got, ref) and n == n_ref
    log(f"[parallel tp decode] world 1, {n} tokens in {secs:.3f} s: the "
        f"unsharded stream {same}; launches {counts}")
    if not same:
        raise AssertionError("parallel: the TP decode's tokens differ from "
                             "the unsharded decode's")
    return {"tokens": n, "seconds": secs,
            "kernels": _tp2_kernel_checks(torch)}, counts


def _to_cuda(torch, tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(torch, v) for v in tree]
    return tree.cuda()


def _parallel_cli(torch, tmp: str) -> dict:
    """(f): `--mesh-data 2` on one card exits 2 with the device-count
    message; `--mesh-data 1 --fsdp` trains (as one device)."""
    import io

    from eamg_tpu_torch import cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        code = cli.main(["train", "--preset", "large2", "--corrected",
                         "--synthetic", "16", "--epochs", "1",
                         "--mesh-data", "2", "--out",
                         os.path.join(tmp, "mesh2")])
    want = f"mesh 2x1 > {torch.cuda.device_count()} devices"
    log(f"[parallel cli] --mesh-data 2: exit {code}, {err.getvalue()!r}")
    if code != 2 or want not in err.getvalue():
        raise AssertionError(f"parallel: --mesh-data 2 on one card: exit "
                             f"{code}, {err.getvalue()!r}")
    lines = _cli_run("parallel cli fsdp", [
        "train", "--preset", "large2", "--corrected", "--synthetic", "16",
        "--epochs", "1", "--mesh-data", "1", "--fsdp", "--log-every", "1",
        "--out", os.path.join(tmp, "fsdp1")])
    summary = json.loads(lines[-1])
    if summary["steps"] < 1 or not math.isfinite(summary["final_loss"]):
        raise AssertionError(f"parallel: --mesh-data 1 --fsdp: {summary}")
    return {"refused_exit": code, "fsdp1": summary}


def serve_parallel(torch, card: str, ckpt) -> dict:
    """Phase parallel: (a)-(g) of the module's docstring. -> the launch
    counts of (e)'s TP decode."""
    import tempfile

    import torch.distributed as dist

    from eamg_tpu_torch.models.gpt import forward, init_params
    from eamg_tpu_torch.parallel.moe import (MoEConfig, init_moe_params,
                                             moe_mlp_dense, moe_mlp_ep)
    from eamg_tpu_torch.parallel.pipeline import (PipelineTrainer,
                                                  make_pp_mesh)
    from eamg_tpu_torch.parallel.ring_attention import forward_seq_parallel
    from eamg_tpu_torch.train.trainer import Trainer
    from eamg_tpu_torch.utils import prng

    t0 = time.perf_counter()
    out = {"card": card}
    secs = {}
    with _world_of_one(torch):
        t = time.perf_counter()
        trainer, fsteps = _flagship_trainer(torch)
        fparams = trainer.export_params()
        out["a_flagship"] = _mesh_vs_plain(
            torch, "flagship", trainer.cfg, trainer.tcfg, fparams,
            fsteps[:PARALLEL_STEPS])
        del trainer
        cfg, tcfg, lsteps, lparams, _ = _large2_setup(torch, "cuda")
        out["a_large2"] = _mesh_vs_plain(torch, "large2", cfg, tcfg, lparams,
                                         lsteps[:PARALLEL_STEPS])
        secs["a_mesh"] = time.perf_counter() - t

        t = time.perf_counter()
        x, y = (torch.from_numpy(a[0]).cuda() for a in lsteps[0])
        pp = PipelineTrainer(cfg, tcfg, lparams, make_pp_mesh(1),
                             n_micro=2, device="cuda")
        m_pp = pp.train_step(x, y)
        m_ref = Trainer(cfg, tcfg, lparams, device="cuda").train_step(
            x[None], y[None])
        gap = abs(m_pp["loss"] - m_ref["loss"])
        log(f"[parallel pipeline] 1 stage, 2 micro-batches: loss "
            f"{m_pp['loss']:.6f} (plain {m_ref['loss']:.6f}, gap {gap:.2e})")
        if gap > PP_LOSS_TOL:
            raise AssertionError(f"parallel: pipeline loss gap {gap}")
        out["b_pipeline"] = {"loss": m_pp["loss"], "plain": m_ref["loss"]}
        del pp
        secs["b_pipeline"] = time.perf_counter() - t

        t = time.perf_counter()
        g = torch.Generator().manual_seed(3)
        ids = torch.randint(1, cfg.vocab_size, (2, 511), generator=g).cuda()
        with torch.no_grad():
            sp = forward_seq_parallel(lparams, ids, cfg, dist.group.WORLD)
        ref = forward(lparams, ids, cfg)
        err = float((sp - ref).abs().max())
        log(f"[parallel seq] forward_seq_parallel n 1 T 511 f32 against "
            f"forward: max|diff| {err:.3e} (tol {SEQ_PAR_TOL})")
        if err > SEQ_PAR_TOL:
            raise AssertionError(f"parallel: forward_seq_parallel {err}")
        out["c_seq_parallel"] = err
        secs["c_seq"] = time.perf_counter() - t

        t = time.perf_counter()
        mcfg = MoEConfig(d_model=512, d_ff=2048, n_experts=8, top_k=2)
        mp = init_moe_params(prng.PRNGKey(4), mcfg, device="cuda")
        xe = torch.randn((2, 256, 512), generator=g).cuda()
        with torch.no_grad():
            ep = moe_mlp_ep(mp, xe, mcfg, dist.group.WORLD, capacity=2 * 512)
            dense = moe_mlp_dense(mp, xe, mcfg, capacity=2 * 512)
        err = float((ep - dense).abs().max())
        log(f"[parallel ep] moe_mlp_ep n 1 against moe_mlp_dense, d512 FF "
            f"2048 8 experts: max|diff| {err:.3e} (tol {EP_TOL})")
        if err > EP_TOL:
            raise AssertionError(f"parallel: moe_mlp_ep {err}")
        out["d_ep"] = err
        secs["d_ep"] = time.perf_counter() - t
        del lparams, lsteps

        t = time.perf_counter()
        out["e_tp_decode"], counts = _tp_decode(torch, ckpt)
        secs["e_tp_decode"] = time.perf_counter() - t
    if dist.is_initialized():
        raise AssertionError("parallel: the phase's group was not left")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        out["f_cli"] = _parallel_cli(torch, tmp)
        secs["f_cli"] = time.perf_counter() - t
    t = time.perf_counter()
    import io

    from eamg_tpu_torch.parallel import dryrun

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = dryrun.main(["--world", "1"])
    line = buf.getvalue().strip().splitlines()[-1] if buf.getvalue().strip() \
        else ""
    log(f"[parallel dryrun] exit {code}: {line}")
    if code != 0 or not line.startswith("dryrun(1)") or dist.is_initialized():
        raise AssertionError(f"parallel: dryrun --world 1: exit {code}, "
                             f"{line!r}")
    out["g_dryrun"] = line
    secs["g_dryrun"] = time.perf_counter() - t
    for name in PARALLEL_KERNELS:
        if launched(name, counts) <= 0:
            raise AssertionError(f"parallel: {name} was not launched")
    out["seconds"] = secs
    out["phase_s"] = time.perf_counter() - t0
    log(json.dumps({"parallel": out}))
    log(f"[parallel] phase {out['phase_s']:.1f} s ({secs}); launches "
        f"{counts}")
    return counts


# ---------------------------------------------------------------- tp_serve

TP_BURST = 8
TP_BURST_SEEDS = tuple(range(300, 300 + TP_BURST))
TP_SERVE_KERNELS = ("flash_attention", "fused_ffn", "flash_decode_fold_sp",
                    "kth_value")
# a rank's heads of demo_ckpt_a (H 8, Hkv 2) on model groups of 2 and 4: a
# K/V head each, shared by 2 ranks at 4
TP_RANK_SHAPES = {2: (4, 1), 4: (2, 1)}


def _tp_prompts(vocab) -> list:
    """TP_BURST prompt rows of demo_ckpt_a's vocabulary, of lengths 3-10."""
    ids = sorted(vocab.values())
    return [[ids[(17 * i + 5 * j) % len(ids)] for j in range(3 + i)]
            for i in range(TP_BURST)]


def _engine_burst(eng, prompts: list) -> tuple:
    """The burst on ``eng``, staggered (a request every 20 ms) -> (the
    rows, the burst's seconds)."""
    rows = {}

    def hit(i):
        time.sleep(0.02 * i)
        rows[i] = eng.submit(prompts[i], seed=TP_BURST_SEEDS[i], timeout=600)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=hit, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    secs = time.perf_counter() - t0
    if len(rows) != len(prompts):
        raise AssertionError("tp_serve: an engine request did not return")
    return [rows[i] for i in range(len(prompts))], secs


def _tp_engine(torch, ckpt, params, blocks, tp) -> tuple:
    """(a) and (b). -> (record, the TP burst's launch counts)."""
    from eamg_tpu_torch.decode import Generator, graphs
    from eamg_tpu_torch.decode.ragged import generate_kv_ragged
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve.continuous import ContinuousBatcher
    from eamg_tpu_torch.tokenizer import Vocab
    from eamg_tpu_torch.utils import prng

    cfg, vocab = ckpt["cfg"], Vocab(ckpt["vocab"])
    prompts = _tp_prompts(ckpt["vocab"])
    rows, secs, out = {}, {}, {}
    counts = replayed = None
    for name, p, t in (("tp", blocks, tp), ("plain", params, None)):
        eng = ContinuousBatcher(Generator(p, cfg, vocab, device="cuda",
                                          tp=t), slots=ENGINE_SLOTS,
                                chunk=128)
        try:
            eng.submit(prompts[0], seed=1, timeout=600)    # captures
            torch.cuda.synchronize()
            if name == "tp":
                _build.reset_launch_counts()
                replays0 = graphs.tally()["replays"]
            rows[name], secs[name] = _engine_burst(eng, prompts)
            torch.cuda.synchronize()
            if name == "tp":
                counts = _build.launch_counts()
                replayed = _build.replayed_counts()
                _require_graphs("tp_serve engine", "flash_decode_fold_sp",
                                counts, replayed,
                                graphs.tally()["replays"] - replays0)
        finally:
            eng.close()
    same = rows["tp"] == rows["plain"]
    n_tok = sum(len(r) - len(q) for r, q in zip(rows["tp"], prompts))
    log(f"[tp_serve engine] world 1, {TP_BURST} staggered requests, "
        f"{n_tok} tokens: the unsharded engine's streams {same}; seconds "
        f"tp {secs['tp']:.3f}, plain {secs['plain']:.3f}; launches "
        f"{ {k: launched(k, counts) for k in TP_SERVE_KERNELS} }")
    if not same:
        raise AssertionError("tp_serve: the TP engine's rows differ from "
                             "the unsharded engine's")
    out["a_engine"] = {"tokens": n_tok, "seconds": secs, "same": same}

    P = 16
    prompt = torch.zeros((TP_BURST, P), dtype=torch.int64, device="cuda")
    for i, q in enumerate(prompts):
        prompt[i, :len(q)] = torch.tensor(q)
    lens = [len(q) for q in prompts]
    keys = prng.key_rows(TP_BURST_SEEDS)
    got = {}
    for name, p, t in (("tp", blocks, tp), ("plain", params, None)):
        buf, pos = generate_kv_ragged(p, prompt, lens, keys, cfg, 256,
                                      eos_id=vocab.get("[END_SEQUENCE]", -1),
                                      tp=t)
        got[name] = (buf.cpu(), pos.cpu())
    same = all(torch.equal(a, b) for a, b in zip(got["tp"], got["plain"]))
    log(f"[tp_serve ragged] generate_kv_ragged(tp=) {TP_BURST} rows to 256: "
        f"the unsharded tokens {same}")
    if not same:
        raise AssertionError("tp_serve: generate_kv_ragged(tp=) differs")
    out["b_ragged"] = {"rows": TP_BURST, "same": same}
    return out, counts


def _tp_fold_checks(torch) -> dict:
    """(c): rows 8 and 11 at the rank shapes, the engine step's q, M and t,
    against their plain versions (comparisons: not the phase's
    launches)."""
    from eamg_tpu_torch.ops import decode_fold

    g = torch.Generator().manual_seed(23)
    Dh, M, B = 64, 511, len(FOLD_T)
    tf = torch.tensor(FOLD_T, dtype=torch.int32, device="cuda")
    out = {}
    for group, (H, Hkv) in TP_RANK_SHAPES.items():
        for dt, dname in ((torch.float32, "float32"),
                          (torch.bfloat16, "bfloat16")):
            qkv = torch.randn((B, 1, (H + 2 * Hkv) * Dh), generator=g) \
                .to(dt).cuda()
            q = qkv[..., :H * Dh]                 # a view, as the engine's
            kv = torch.randn((B, M, 2 * Hkv * Dh), generator=g).to(dt).cuda()
            kv[0] = 0                             # a free slot
            want = decode_fold.decode_attention_pm_plain(q, kv, tf, H)
            want32 = decode_fold.decode_attention_pm_plain(
                q.float(), kv.float(), tf, H)
            for name in ("flash_decode_fold_sp", "flash_decode_fold3_sp"):
                got = getattr(decode_fold, name)(q, kv, tf, H)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                rel = float((got.float() - want32).abs().max()
                            / want32.abs().max())
                tol = TOL[(name, dname)]
                plan = decode_fold.sp_plan(M, Dh, H // Hkv, dt)
                log(f"[tp_serve fold] group {group}: H {H} Hkv {Hkv} "
                    f"{name} {dname}: max|err| {err:.3e} (tol {tol}), vs "
                    f"f32 plain {rel:.3e} (tol {REL_TOL_F32}); plan "
                    f"(by head, C) {plan}")
                if not (err <= tol and rel <= REL_TOL_F32
                        and got[0].abs().max().item() == 0.0):
                    raise AssertionError(f"tp_serve: {name} at H {H} Hkv "
                                         f"{Hkv} {dname}: {err}, {rel}")
                out[f"g{group}/{name}/{dname}"] = err
    return out


def _tp_orbax(torch, ckpt) -> dict:
    """(d): demo_ckpt_a through the port's Orbax writer and reader, then
    served from the Orbax directory."""
    import tempfile

    from eamg_tpu_torch.serve.pipeline import (DEMO_CKPT_A,
                                               pipeline_from_checkpoint)
    from eamg_tpu_torch.utils import zstd
    from eamg_tpu_torch.utils.orbax_io import (_walk, load_checkpoint_orbax,
                                               save_checkpoint_orbax)

    t0 = time.perf_counter()
    zstd._lib()                   # g++ at first use; raises where it fails
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a_orbax")
        t0 = time.perf_counter()
        save_checkpoint_orbax(path, ckpt["params"], ckpt["vocab"],
                              ckpt["cfg"], step=ckpt["step"],
                              extra=ckpt["extra"])
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_checkpoint_orbax(path)
        read_s = time.perf_counter() - t0
        a, b = list(_walk(ckpt["params"])), list(_walk(back["params"]))
        same = [k for k, _ in a] == [k for k, _ in b] and all(
            u.dtype == v.dtype and torch.equal(u, v)
            for (_, u), (_, v) in zip(a, b)) and back["cfg"] == ckpt["cfg"] \
            and back["vocab"] == ckpt["vocab"]
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(path) for f in fs)
        log(f"[tp_serve orbax] demo_ckpt_a as Orbax ({size} bytes, "
            f"{len(a)} leaves): written in {write_s:.3f} s, restored in "
            f"{read_s:.3f} s (the C++ decoder built in {build_s:.3f} s "
            f"before), bit-equal {same}")
        if not same:
            raise AssertionError("tp_serve: the Orbax round trip of "
                                 "demo_ckpt_a is not bit-equal")
        ref = pipeline_from_checkpoint(DEMO_CKPT_A, device="cuda")
        pipe = pipeline_from_checkpoint(path, device="cuda",
                                        classifier=ref.classifier)
        wav = {}
        for name, pp in (("pickle", ref), ("orbax", pipe)):
            res = pp.generate(BURST_TEXTS[0], seed=7, render_audio=True)
            wav[name] = res.wav_bytes
        same_wav = wav["pickle"] == wav["orbax"] and \
            wav["orbax"][:4] == b"RIFF"
        log(f"[tp_serve orbax] pipeline_from_checkpoint on the Orbax "
            f"directory, seed 7: {len(wav['orbax'])} WAV bytes, the pickle "
            f"directory's {same_wav}")
        if not same_wav:
            raise AssertionError("tp_serve: the Orbax directory's WAV "
                                 "differs")
    return {"bytes": size, "write_s": write_s, "restore_s": read_s,
            "decoder_build_s": build_s, "wav_bytes": len(wav["orbax"])}


def serve_tp(torch, card: str, ckpt) -> dict:
    """Phase tp_serve: (a)-(d) of the module's docstring. -> the launch
    counts of (a)'s TP burst."""
    import torch.distributed as dist

    from eamg_tpu_torch.parallel.collectives import tensor_parallel
    from eamg_tpu_torch.parallel.mesh import make_mesh, shard_params

    t0 = time.perf_counter()
    out, secs = {"card": card}, {}
    with _world_of_one(torch):
        t = time.perf_counter()
        params = _to_cuda(torch, ckpt["params"])
        mesh = make_mesh(1, 1)
        tp = tensor_parallel(ckpt["cfg"], mesh.get_group("model"))
        blocks = shard_params(params, mesh, tp=True, cfg=ckpt["cfg"])
        rec, counts = _tp_engine(torch, ckpt, params, blocks, tp)
        out.update(rec)
        del params, blocks
        secs["ab_engine_ragged"] = time.perf_counter() - t
    if dist.is_initialized():
        raise AssertionError("tp_serve: the phase's group was not left")
    t = time.perf_counter()
    out["c_fold"] = _tp_fold_checks(torch)
    secs["c_fold"] = time.perf_counter() - t
    t = time.perf_counter()
    out["d_orbax"] = _tp_orbax(torch, ckpt)
    secs["d_orbax"] = time.perf_counter() - t
    for name in TP_SERVE_KERNELS:
        if launched(name, counts) <= 0:
            raise AssertionError(f"tp_serve: {name} was not launched")
    out["seconds"] = secs
    out["phase_s"] = time.perf_counter() - t0
    log(json.dumps({"tp_serve": out}))
    log(f"[tp_serve] phase {out['phase_s']:.1f} s ({secs}); launches "
        f"{counts}")
    return counts


PHASES = ("build", "kernels", "teacher", "solo", "coalesce", "stream", "b3",
          "spec", "spec2", "options", "batch", "train", "tools", "variants",
          "emotion", "parallel", "tp_serve")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES)
                             + " (default: all; only the full run prints "
                             "the kernels line and the last line)")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES for p in phases):
        parser.error(f"phases are {PHASES}")

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing to run")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_A
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    phase_s = {}

    @contextlib.contextmanager
    def timed(name):
        t0 = time.perf_counter()
        yield
        phase_s[name] = round(time.perf_counter() - t0, 1)

    t_start = time.perf_counter()
    if "build" in phases:
        with timed("build"):
            built = _build.build_all()
        log(f"[build] {len(built)} libraries built in "
            f"{phase_s['build']:.1f} s: "
            + ", ".join(f"{n} {s:.1f} s" for n, s in built.items()))

    ckpt = load_checkpoint(DEMO_CKPT_A)
    checks, counts, probes = {}, {}, {}
    if "kernels" in phases:
        with timed("kernels"):
            checks = kernel_checks(torch, ckpt["params"])
            bit_identity(torch, ckpt["params"])
            kernel_phases(torch, ckpt["params"])
            spec_kernel_checks(torch)
    if "teacher" in phases:
        with timed("teacher"):
            teacher_forced(torch, ckpt)
            uncached_divisors(torch, ckpt)
    if "solo" in phases:
        with timed("solo"):
            counts["solo"], pipe = serve_solo(torch)
            profile_solo(torch, pipe)
            del pipe
    if "coalesce" in phases:
        with timed("coalesce"):
            counts["coalesce"], probes, _ = serve_coalesced(torch)
            counts["window"] = serve_window(torch)
    if "stream" in phases:
        with timed("stream"):
            counts.update(serve_stream(torch))
    if "b3" in phases:
        with timed("b3"):
            counts.update(serve_b3(torch))
    if "spec" in phases:
        with timed("spec"):
            counts.update(serve_spec(torch))
    if "spec2" in phases:
        with timed("spec2"):
            counts.update(serve_spec2(torch))
    if "options" in phases:
        with timed("options"):
            counts.update(serve_options(torch))
    if "batch" in phases:
        with timed("batch"):
            counts["batch"] = batch_decode(torch)
            counts["generate"] = cli_generate(torch)
    if "train" in phases:
        with timed("train"):
            counts["train"] = serve_train(torch)
    if "tools" in phases:
        with timed("tools"):
            counts["tools"] = serve_tools(torch, card)
    if "variants" in phases:
        with timed("variants"):
            counts["variants"] = serve_variants(torch, card)
    if "emotion" in phases:
        with timed("emotion"):
            counts["emotion"] = serve_emotion(torch, card)
    if "parallel" in phases:
        with timed("parallel"):
            counts["parallel"] = serve_parallel(torch, card, ckpt)
    if "tp_serve" in phases:
        with timed("tp_serve"):
            counts["tp_serve"] = serve_tp(torch, card, ckpt)
    log(f"[done] phases {phases} in {time.perf_counter() - t_start:.1f} s; "
        f"seconds a phase {phase_s}")
    if list(phases) != list(PHASES):
        log("chip_smoke: a partial run; no kernels line and no last line")
        return 0

    kernels = []
    for name in REPLACES:
        rec = checks[name][MAIN_DTYPE[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launched(name, counts[MAIN_PHASE[name]]),
            "launches_by_path": {p: launched(name, c)
                                 for p, c in counts.items()},
            "probe_launches": probes.get(name, 0),
            "dtype": MAIN_DTYPE[name], **rec})
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        code = 1
    sys.exit(code)
