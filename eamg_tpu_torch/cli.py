"""Command line of the port: ``python -m eamg_tpu_torch.cli serve``,
``generate``, ``train``, ``train-demo-a``, ``train-medusa``,
``medusa-measure``, ``emotion``, ``section-eval``, ``ablate``,
``feed-bench``, ``analyze``, ``tokenize``, ``convert-pt``, ``export-pt``,
``convert-gqa``, ``gqa-recover``, ``distill-emotion``,
``finetune-emotion``, ``convert-distilbert`` and ``export-emotion-hf``.

``generate`` writes one MIDI file (and with ``--wav`` a WAV file) from
fixed controls (``--bpm``, ``--key``, ``--instruments``) or, with
``--interactive``, from a typed description. On a Scheme-A checkpoint
(default: the shipped flagship) it decodes through
``Generator.sample_kvcache``; on a Scheme-B3 one (``demo_ckpt_b3``) the
prompt is the ``[START_SEQ] BPM_x KEY_y`` control prefix of ``--bpm`` and
``--key`` (B3 has no instrument tokens), the decode ``generate_ids`` and
the MIDI ``SchemeB3.decode_to_song``. ``--beams`` (with
``--length-penalty``) decodes by beam search, ``--lookup`` (with
``--gamma`` and ``--lookup-ngram``) by prompt-lookup speculation and
``--medusa PATH`` by the Medusa heads of that file, one of them at a time,
as in the JAX CLI. ``--grammar`` decodes under the scheme's FSM
(``decode/grammar.py``), sampled or with ``--beams``. ``--draft DIR``
decodes by speculation with the checkpoint in DIR as the draft model (same
vocabulary; both corrected causal checkpoints, else JAX's
``AssertionError``).

``serve`` serves ``POST /generate`` on a Scheme-A or Scheme-B3 checkpoint
of the JAX package's format (default: the shipped flagship
``eamg_tpu/serve/demo_ckpt_a``, else ``demo_ckpt_b3``; ``--random-demo``
serves the randomly initialised demo model, causal only with
``--coalesce``) on the CUDA device, or on the host with ``--device cpu``. ``--coalesce``
routes requests through the continuous-batching engine (or, with
``--coalesce window``, the 10 ms window batcher), with the JAX server's
engine options ``--slots``, ``--chunk``, ``--max-queue``,
``--fast-routing``, ``--engine-top-p``, ``--engine-ngram N`` (the engine's
n-gram ban size) and ``--engine-grammar`` (the scheme's FSM in the engine
or the window batcher) and ``--engine-medusa`` (the checkpoint's Medusa
heads in the engine, so medusa=1 requests join it; ignored, with JAX's
message, when the checkpoint has none).

``train`` runs one of the reference trainers' presets (``--preset mini``,
``large``, ``large2``, ``no_inst``, ``paper``) on a corpus CSV or
``--synthetic N`` synthetic songs, with the JAX CLI's flags
(``--corrected``, ``--pack``, ``--attn-block``, geometry overrides,
``--save-every``, ``--save-hours``, ``--resume``), and prints its summary
as JSON. ``--experts E`` (with ``--moe-every k``) trains an MoE FFN of E
routed experts in every k-th layer, with the load-balance loss.
``--mesh-data D --mesh-model M [--fsdp]`` trains on a (data, model) mesh
of D x M ranks, one process a rank (Megatron tensor parallelism when M >
1, params and moments split over the data axis with ``--fsdp``): outside
a process group the command spawns the ranks itself (gloo ranks with
``--device cpu``, else one NCCL rank a card, ``cuda:rank``; more ranks
than cards exits 2 with JAX's ``mesh DxM > n devices``), and under
torchrun it joins the group it is given. Rank 0 alone logs, saves and
prints the summary; ``--fsdp`` with a mesh of one trains as one device,
as JAX's CLI does.
``train-demo-a`` trains the Scheme-A demo on the grid corpus
(``--geometry flagship --kv-heads 2`` is the shipped flagship's own
recipe) and writes a checkpoint ``serve`` reads, with
``train_metrics.json``. ``train-medusa`` trains Medusa heads on a frozen
checkpoint (default: the shipped B3 demo) and writes JAX's heads pickle;
``medusa-measure`` times plain, linear Medusa and (``--tree``) tree
verification at batch 1 on a checkpoint's heads (default: the shipped
demo A); both print JSON.
``emotion`` classifies ``--text`` and prints its EATS mapping;
``section-eval`` scores each section of multi-emotion prompts against its
own controls; ``ablate`` prints the paper's §10.4 table; ``feed-bench``
measures the host's feed rate against the trainer's demand; ``analyze``
and ``tokenize`` are the corpus tools (host only). ``convert-pt`` and
``export-pt`` turn a reference ``.pt`` into a checkpoint directory and
back, ``convert-gqa`` mean-pools an MHA checkpoint's K/V heads (all three
host only), and ``gqa-recover`` measures that conversion's perplexity cost
and uptrains it back. ``distill-emotion`` trains the emotion classifier
from scratch on the template corpus (the shipped recipe by default: d256
L4, pool max, cue suppression 0.3), ``finetune-emotion`` LoRA-finetunes a
classifier on a "text<TAB>label" file, ``convert-distilbert`` turns an HF
DistilBERT (+PEFT) snapshot into a classifier directory and
``export-emotion-hf`` the reverse (``--push`` uploads it, and needs
``huggingface_hub``). All print what the JAX CLI prints. Every
subcommand with device work runs on the CUDA device unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

# engine modes of the JAX server that the port's engine does not carry yet
_ENGINE_NOT_YET = ()
# decode modes of the JAX CLI's generate that the port does not carry yet
_GENERATE_NOT_YET = ()
# training modes of the JAX CLI's train that the port does not carry yet
_TRAIN_NOT_YET = ()


def _refuse(args, names) -> bool:
    """Name the first of ``names`` that is set and not in the port."""
    for name in names:
        if getattr(args, name):
            print(f"--{name.replace('_', '-')} is not yet in the PyTorch "
                  "port", file=sys.stderr)
            return True
    return False


def coalesce_opts_from_args(args) -> dict:
    """The batcher's options from the serve flags, as the JAX server maps
    them."""
    opts = {}
    if args.coalesce == "continuous":
        if args.slots is not None:
            opts["slots"] = args.slots
        if args.chunk is not None:
            opts["chunk"] = args.chunk
        if args.engine_top_p == "row":
            opts["per_row_sampling"] = True
        elif args.engine_top_p is not None:
            opts["top_p"] = float(args.engine_top_p)
        if args.engine_ngram:
            opts["no_repeat_ngram"] = int(args.engine_ngram)
    elif args.coalesce and args.slots is not None:
        opts["max_batch"] = args.slots
    if args.coalesce and args.engine_grammar:
        opts["grammar"] = True
    if args.coalesce and args.max_queue is not None:
        opts["max_queue"] = args.max_queue
    return opts


def pipeline_from_args(args):
    """The serving pipeline that ``serve`` with these flags runs: the
    checkpoint's, else the packaged demo's (A, else B3), else (or with
    ``--random-demo``) the randomly initialised demo model, causal only
    with ``--coalesce``, as the JAX server picks."""
    from .serve import (demo_pipeline, packaged_demo_checkpoint,
                        pipeline_from_checkpoint)

    opts = coalesce_opts_from_args(args)
    ckpt_dir = args.checkpoint or (not args.random_demo
                                   and packaged_demo_checkpoint())
    if ckpt_dir:
        return pipeline_from_checkpoint(
            ckpt_dir, full_gm=args.full_gm, device=args.device,
            coalesce=args.coalesce, coalesce_opts=opts,
            fast_routing=args.fast_routing,
            engine_medusa=args.engine_medusa)
    if args.engine_medusa:
        print("[serve] --engine-medusa ignored: the random demo pipeline "
              "has no medusa heads")
    return demo_pipeline(corrected=bool(args.coalesce),
                         coalesce=args.coalesce, coalesce_opts=opts,
                         fast_routing=args.fast_routing, device=args.device)


def _serve(args) -> int:
    from .serve import make_server, shutdown_gracefully

    if _refuse(args, _ENGINE_NOT_YET):
        return 2
    pipeline = pipeline_from_args(args)
    print(f"warming up on {pipeline.device} (building the kernels)...",
          flush=True)
    pipeline.warmup()
    server = make_server(pipeline, args.host, args.port, quiet=False)
    print(f"EAMG (PyTorch) serving on http://{args.host}:{args.port}",
          flush=True)

    def _stop(signum, frame):
        print(f"signal {signum}: draining (send again to force-quit)...",
              flush=True)
        signal.signal(signum, signal.SIG_DFL)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        server.serve_forever()
    finally:
        shutdown_gracefully(server, pipeline)
    return 0


def _generate(args) -> int:
    """Offline generation of one MIDI (and WAV) file, as the JAX CLI's
    ``generate`` does it for Scheme-A and Scheme-B3 checkpoints."""
    if _refuse(args, _GENERATE_NOT_YET):
        return 2
    from .decode import Generator
    from .serve.pipeline import DEMO_CKPT_A
    from .tokenizer import (SchemeB3, Vocab, assemble_prompt,
                            closest_bpm_token, detect_scheme,
                            normalize_key_signature, tokens_to_song)
    from .utils.checkpoint import load_checkpoint
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    ckpt = load_checkpoint(args.checkpoint or DEMO_CKPT_A)
    vocab = Vocab(ckpt["vocab"])
    scheme = detect_scheme(vocab)
    if scheme in ("b1", "b2"):
        print(f"Scheme-{scheme.upper()} checkpoints have no control tokens "
              "to condition on; use a b3 or Scheme-A checkpoint",
              file=sys.stderr)
        return 2
    b3 = scheme == "b3"
    gen = Generator(ckpt["params"], ckpt["cfg"], vocab, device=device,
                    **({"eos_token": "[END_SEQ]"} if b3 else {}))
    penalties = (args.repetition_penalty, args.frequency_penalty,
                 args.presence_penalty)
    gram = None
    if args.grammar:
        from .decode.grammar import grammar_a, grammar_for

        gram = grammar_for(SchemeB3(seq_len=ckpt["cfg"].seq_len)) if b3 \
            else grammar_a(gen.vocab)
    sampling = dict(
        max_len=args.max_len, temperature=args.temperature, top_k=args.top_k,
        seed=args.seed, top_p=args.top_p, min_p=args.min_p,
        penalties=None if penalties == (1.0, 0.0, 0.0) else penalties,
        no_repeat_ngram=args.no_repeat_ngram, grammar=gram)
    if sum(map(bool, (args.beams, args.draft, args.lookup,
                      args.medusa))) > 1:
        raise SystemExit("--beams, --draft, --lookup and --medusa are "
                         "mutually exclusive")
    option = _option_fn(args, gen, sampling, device)
    bpm, key, mapping = args.bpm, args.key, None
    if args.interactive:
        # free text -> emotion -> mapping -> music
        from .emotion import EmotionClassifier, get_music_params

        text = input("Enter a description or feeling: ")
        label = EmotionClassifier(device=device).predict(text)
        mapping = get_music_params(label, seed=args.seed)
        print("Music Mapping:", mapping)
        bpm, key = mapping["bpm"], mapping["key"]
    if b3:
        # control-token conditioning; B3 has no instrument tokens
        if args.instruments != ["Violin", "Acoustic Grand Piano"] \
                and not args.interactive:
            print("note: --instruments ignored (B3 checkpoints have no "
                  "instrument tokens)")
        scheme_b = SchemeB3(seq_len=ckpt["cfg"].seq_len)
        prefix = scheme_b.control_prefix(bpm, key)
        ids = option(prefix) if option else \
            gen.generate_ids(prefix, **sampling)[0]
        tokens = scheme_b.vocab.decode(ids)
        print("Generated token snippet:", tokens[:20], "...")
        return _write_song(args, scheme_b.decode_to_song(ids), device)
    if mapping is not None:
        prompt = assemble_prompt(gen.vocab, mapping, full_gm=args.full_gm)
    else:
        prompt = ["[START_SEQUENCE]", closest_bpm_token(gen.vocab, args.bpm),
                  normalize_key_signature(args.key)]
        prompt += [f"[INSTRUMENT] {i}" for i in args.instruments]
    # a data-dependent vocabulary may lack a control token: drop it and say
    # so, as the serving pipeline does
    dropped = [t for t in prompt if t not in gen.vocab]
    if dropped:
        print("note: dropped prompt tokens not in this checkpoint's "
              f"vocabulary: {dropped}")
        prompt = [t for t in prompt if t in gen.vocab]
    if option:
        tokens = gen.trim_at_eos(option(gen.vocab.encode(prompt)))
    else:
        tokens = gen.sample_kvcache(prompt, **sampling)
    print("Generated token snippet:", tokens[:20], "...")
    return _write_song(args, tokens_to_song(tokens), device)


def _option_fn(args, gen, sampling: dict, device):
    """The decode of ``--beams``, ``--draft``, ``--lookup`` or
    ``--medusa``, ids in and ids out (prompt included), or None for the
    sampled decode. They refuse penalties and n-gram bans, and the
    speculative ones grammar, as the JAX CLI does; beams take the
    grammar."""
    if not (args.beams or args.draft or args.lookup or args.medusa):
        return None
    history = sampling["penalties"] is not None or args.no_repeat_ngram
    if args.beams:
        if history:
            raise SystemExit("--beams is a deterministic argmax-tree "
                             "search; penalties/n-gram transforms are "
                             "sampling-path features (--grammar composes)")
        return lambda ids: gen.generate_ids_beam(
            ids, max_len=args.max_len, n_beams=args.beams,
            length_penalty=args.length_penalty, grammar=sampling["grammar"])
    flag = ("--draft" if args.draft
            else "--lookup" if args.lookup else "--medusa")
    if history or sampling["grammar"] is not None:
        raise SystemExit(f"{flag} does not support penalties, n-gram bans "
                         "or grammar constraints yet (history-dependent "
                         "distributions break the proposal/target "
                         "acceptance math)")
    spec = dict(max_len=args.max_len, gamma=args.gamma,
                temperature=args.temperature, top_k=args.top_k,
                seed=args.seed, top_p=args.top_p, min_p=args.min_p)
    if args.medusa:
        from .tools.medusa import load_medusa_heads

        heads = load_medusa_heads(args.medusa)
        return lambda ids: gen.generate_ids_medusa(heads, ids, **spec)[0]
    if args.draft:
        draft = _draft_generator(args.draft, device)
        return lambda ids: gen.generate_ids_speculative(draft, ids,
                                                        **spec)[0]
    return lambda ids: gen.generate_ids_lookup(
        ids, ngram=args.lookup_ngram, **spec)[0]


def _draft_generator(path: str, device):
    """The draft model of ``--draft``: a Generator of the checkpoint in
    ``path`` on ``device`` (B3's EOS on a B3 vocabulary, as JAX loads it)."""
    from .decode import Generator
    from .tokenizer import Vocab, detect_scheme
    from .utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(path)
    vocab = Vocab(ckpt["vocab"])
    b3 = detect_scheme(vocab) == "b3"
    return Generator(ckpt["params"], ckpt["cfg"], vocab, device=device,
                     **({"eos_token": "[END_SEQ]"} if b3 else {}))


def _write_song(args, song, device) -> int:
    from .audio import render_to_wav

    song.write(args.out)
    print("MIDI saved ->", args.out)
    if args.wav:
        render_to_wav(song, args.wav, seed=args.seed, device=device)
        print("WAV saved ->", args.wav)
    return 0


def _train(args) -> int:
    if _refuse(args, _TRAIN_NOT_YET):
        return 2
    if args.mesh_data * args.mesh_model > 1:
        return _train_mesh(args)
    return _train_run(args, args.device)


def _train_mesh(args) -> int:
    """``train`` on a D x M mesh: join torchrun's group, or spawn the ranks
    (one process each) and wait for them."""
    import os
    import tempfile

    import torch

    world = args.mesh_data * args.mesh_model
    if os.environ.get("WORLD_SIZE") and os.environ.get("MASTER_ADDR"):
        if int(os.environ["WORLD_SIZE"]) != world:
            print(f"mesh {args.mesh_data}x{args.mesh_model} in a world of "
                  f"{os.environ['WORLD_SIZE']} ranks", file=sys.stderr)
            return 2
        dev = args.device or f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        return _train_rank_run(args, dev, None, None, None)
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if world > n:
            print(f"mesh {args.mesh_data}x{args.mesh_model} > {n} devices",
                  file=sys.stderr)
            return 2
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_train_rank, args=(args, world,
                                              f"file://{tmp}/rendezvous"),
                           nprocs=world, start_method="spawn")
    return 0


def _train_rank(rank: int, args, world: int, init_method: str) -> None:
    """One spawned rank of ``train`` on a mesh."""
    import os

    import torch

    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = "cpu" if args.device == "cpu" else f"cuda:{rank}"
    if _train_rank_run(args, dev, init_method, world, rank):
        raise SystemExit(1)


def _train_rank_run(args, dev, init_method, world, rank) -> int:
    import torch.distributed as dist

    from .parallel.mesh import make_mesh
    from .parallel.multihost import init_distributed

    init_distributed(num_processes=world, process_id=rank, device=dev,
                     init_method=init_method)
    try:
        mesh = make_mesh(args.mesh_data, args.mesh_model, device=dev)
        return _train_run(args, dev, mesh)
    finally:
        dist.destroy_process_group()


def _train_run(args, device, mesh=None) -> int:
    import json

    from .parallel.multihost import is_main_process
    from .train.run import run_training

    summary = run_training(
        args.preset, csv_path=args.csv, synthetic_rows=args.synthetic,
        max_rows=args.max_rows, out_dir=args.out, scheme=args.scheme,
        epochs=args.epochs, save_every_steps=args.save_every,
        save_hours=args.save_hours, seed=args.seed,
        log_every=args.log_every, log_fn=lambda m: print(m, flush=True),
        resume_from=args.resume, corrected=args.corrected, pack=args.pack,
        geometry={"d_model": args.d_model, "n_head": args.n_head,
                  "n_layer": args.n_layer, "seq_len": args.seq_len,
                  "n_experts": args.experts,
                  "attn_block": args.attn_block,
                  "moe_every": args.moe_every if args.experts else None},
        device=device, mesh=mesh, tp=args.mesh_model > 1, fsdp=args.fsdp)
    if is_main_process():
        print(json.dumps(summary), flush=True)
    return 0


def _train_demo_a(args) -> int:
    import dataclasses
    import json

    from .tools.demo_a import DemoASpec, flagship_spec, train_demo_a

    if args.geometry == "flagship":
        spec = flagship_spec(seed=args.seed)
        over = {k: v for k, v in
                [("epochs", args.epochs), ("rows", args.rows),
                 ("heldout_rows", args.heldout_rows),
                 ("kv_heads", args.kv_heads)] if v is not None}
        spec = dataclasses.replace(spec, **over)
    else:
        spec = DemoASpec(rows=args.rows or 12000,
                         heldout_rows=args.heldout_rows or 400,
                         epochs=args.epochs or 8, seed=args.seed,
                         kv_heads=args.kv_heads)
    metrics = train_demo_a(args.out, spec=spec,
                           log_fn=lambda m: print(m, flush=True),
                           device=args.device)
    print(json.dumps(metrics), flush=True)
    return 0


def _train_medusa(args) -> int:
    import json

    from .serve.pipeline import DEMO_CKPT_B3
    from .tools.medusa import MedusaSpec, measure, train_medusa_heads

    ckpt = args.ckpt or DEMO_CKPT_B3
    out = train_medusa_heads(ckpt, args.out, MedusaSpec(
        n_heads=args.heads, rows=args.rows, epochs=args.epochs,
        batch=args.batch, lr=args.lr, seed=args.seed), device=args.device)
    res = {"train": {k: v for k, v in out.items() if k != "blocks"}}
    if args.measure:
        res["measure"] = measure(ckpt, args.out, max_len=args.max_len,
                                 gamma=args.heads, greedy=not args.sample,
                                 device=args.device)
    print(json.dumps(res), flush=True)
    return 0


def _medusa_measure(args) -> int:
    import json

    from .serve.pipeline import DEMO_CKPT_A
    from .tools.medusa import measure, measure_tree

    ckpt = args.ckpt or DEMO_CKPT_A
    heads = args.heads or f"{ckpt}/medusa_heads.pkl"
    res = {}
    if args.tree:
        res["tree"] = measure_tree(ckpt, heads, max_len=args.max_len,
                                   reps=args.reps, device=args.device)
    else:
        res["linear"] = measure(ckpt, heads, max_len=args.max_len, gamma=4,
                                greedy=not args.sample, device=args.device)
    print(json.dumps(res), flush=True)
    return 0


def _emotion(args) -> int:
    """Classify a text and map it to music (emotion_analysis/main.py)."""
    import json

    from .emotion import EmotionClassifier, get_music_params

    clf = EmotionClassifier(device=args.device)
    label = clf.predict(args.text)
    mapping = get_music_params(label, seed=args.seed)
    print(json.dumps({"label": label, "mapping": mapping,
                      "top_k": clf.predict_top_k_labels(args.text, k=3)}))
    return 0


def _section_eval(args) -> int:
    import json

    from .serve import packaged_demo_checkpoint, pipeline_from_checkpoint
    from .tools.section_metrics import measure_section_obedience

    pipe = pipeline_from_checkpoint(args.ckpt or packaged_demo_checkpoint(),
                                    device=args.device)
    print(json.dumps(measure_section_obedience(pipe, n_prompts=args.prompts,
                                               seed=args.seed)))
    return 0


def _feed_bench(args) -> int:
    import json

    from .tools.feed_bench import run_feed_bench

    print(json.dumps(run_feed_bench(rows=args.rows, notes=args.notes,
                                    steps=args.steps, shards=args.shards,
                                    device=args.device)))
    return 0


def _ablate(args) -> int:
    """The paper's §10.4 table: full / - KV / - emotion / - fine bins."""
    from .tools.ablation import AblationConfig, markdown_table, run_ablation

    acfg = AblationConfig(
        csv_path=args.csv, n_rows=args.synthetic, max_rows=args.max_rows,
        seq_len=args.seq_len, d_model=args.d_model, n_head=args.n_head,
        n_layer=args.n_layer, epochs=args.epochs, seed=args.seed,
        dtype=args.dtype, jitter_ms=args.jitter_ms)
    table = markdown_table(run_ablation(acfg, device=args.device))
    print(table)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write("# §10.4 ablation table\n\n" + table + "\n")
        print("written ->", args.out)
    return 0


def _analyze(args) -> int:
    from .tools.analysis import analyze_corpus, write_report

    stats = analyze_corpus(args.csv, max_rows=args.max_rows)
    write_report(stats, args.out)
    print(f"analyzed {stats['rows']} rows -> {args.out}")
    return 0


def _tokenize(args) -> int:
    import json

    from .tools.corpus import build_corpus_csv

    print(json.dumps(build_corpus_csv(args.midi_dir, args.out,
                                      max_files=args.max_files,
                                      log_fn=print)))
    return 0


def _add_tools(sub) -> None:
    dev_help = "torch device (default cuda; 'cpu' runs on the host)"
    se = sub.add_parser("section-eval",
                        help="per-section emotion-adaptivity obedience over "
                             "multi-emotion prompts "
                             "(tools/section_metrics.py)")
    se.add_argument("--ckpt", default=None,
                    help="checkpoint dir (default: packaged demo)")
    se.add_argument("--prompts", type=int, default=50)
    se.add_argument("--seed", type=int, default=0)
    se.add_argument("--device", default=None, help=dev_help)
    se.set_defaults(fn=_section_eval)

    fb = sub.add_parser("feed-bench",
                        help="host data-pipeline feed rate at corpus scale "
                             "(tools/feed_bench.py)")
    fb.add_argument("--rows", type=int, default=100_000)
    fb.add_argument("--notes", type=int, default=126)
    fb.add_argument("--steps", type=int, default=200)
    fb.add_argument("--shards", type=int, default=16)
    fb.add_argument("--device", default=None, help=dev_help)
    fb.set_defaults(fn=_feed_bench)

    ab = sub.add_parser("ablate",
                        help="paper §10.4 ablation table (PPL / MSE-Tune)")
    ab.add_argument("--csv", default=None,
                    help="real Lakh corpus CSV (paper scale); default: "
                         "synthetic tempo-locked corpus")
    ab.add_argument("--synthetic", type=int, default=384)
    ab.add_argument("--max-rows", type=int, default=None)
    ab.add_argument("--seq-len", type=int, default=96)
    ab.add_argument("--d-model", type=int, default=128)
    ab.add_argument("--n-head", type=int, default=4)
    ab.add_argument("--n-layer", type=int, default=2)
    ab.add_argument("--epochs", type=int, default=4)
    ab.add_argument("--seed", type=int, default=0)
    ab.add_argument("--jitter-ms", type=float, default=0.0,
                    help="Gaussian micro-timing on synthetic onsets "
                         "(performance-MIDI realism; see tools/ablation)")
    ab.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ab.add_argument("--out", default=None, help="write markdown table here")
    ab.add_argument("--device", default=None, help=dev_help)
    ab.set_defaults(fn=_ablate)

    a = sub.add_parser("analyze", help="corpus key/instrument histograms")
    a.add_argument("--csv", required=True)
    a.add_argument("--max-rows", type=int, default=20_000)
    a.add_argument("--out", default="analysis_output.txt")
    a.set_defaults(fn=_analyze)

    k = sub.add_parser("tokenize", help="MIDI dir -> corpus CSV")
    k.add_argument("--midi-dir", required=True)
    k.add_argument("--out", required=True)
    k.add_argument("--max-files", type=int, default=None)
    k.set_defaults(fn=_tokenize)

    e = sub.add_parser("emotion", help="classify text + EATS mapping demo")
    e.add_argument("--text", required=True)
    e.add_argument("--seed", type=int, default=None)
    e.add_argument("--device", default=None, help=dev_help)
    e.set_defaults(fn=_emotion)


def _add_medusa(sub) -> None:
    md = sub.add_parser("train-medusa",
                        help="train Medusa heads on a frozen checkpoint "
                             "(batch-1 multi-token decoding) and "
                             "optionally measure the latency win")
    md.add_argument("--ckpt", default=None,
                    help="checkpoint dir (default: the shipped B3 demo)")
    md.add_argument("--out", required=True, help="heads pickle path")
    md.add_argument("--heads", type=int, default=4)
    md.add_argument("--rows", type=int, default=4000)
    md.add_argument("--epochs", type=int, default=4)
    md.add_argument("--batch", type=int, default=32)
    md.add_argument("--lr", type=float, default=1e-3)
    md.add_argument("--seed", type=int, default=0)
    md.add_argument("--measure", action="store_true",
                    help="time batch-1 plain vs medusa after training")
    md.add_argument("--max-len", dest="max_len", type=int, default=256)
    md.add_argument("--sample", action="store_true",
                    help="measure sampled (default greedy) decoding")
    md.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs on the "
                         "host)")
    md.set_defaults(fn=_train_medusa)

    mm = sub.add_parser("medusa-measure",
                        help="interleaved A/B latency of plain vs medusa "
                             "(linear or --tree) on a checkpoint's heads")
    mm.add_argument("--ckpt", default=None,
                    help="checkpoint dir (default: the shipped demo A)")
    mm.add_argument("--heads", default=None,
                    help="default: <ckpt>/medusa_heads.pkl")
    mm.add_argument("--max-len", dest="max_len", type=int, default=256)
    mm.add_argument("--reps", type=int, default=5)
    mm.add_argument("--tree", action="store_true",
                    help="measure Medusa-2 tree verification (greedy)")
    mm.add_argument("--sample", action="store_true")
    mm.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs on the "
                         "host)")
    mm.set_defaults(fn=_medusa_measure)


def _convert_pt(args) -> int:
    from .tools.convert import convert_reference_pt

    convert_reference_pt(args.pt, args.out, serving_arch=args.serving_arch)
    print("converted ->", args.out)
    return 0


def _export_pt(args) -> int:
    from .models.import_torch import export_reference_checkpoint
    from .utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(args.ckpt)
    cfg = ckpt["cfg"]
    # the .pt carries the geometry only: the key dialect follows the LN
    # placement (post-LN: the trainer scripts, pre-LN/GELU: api_cache.py)
    dialect = args.dialect or (
        "kv" if cfg.ln_placement == "pre" else "trainer")
    canon_loader = "kv" if cfg.ln_placement == "pre" else "trainer"
    if dialect != canon_loader:
        print(f"warning: checkpoint is {cfg.ln_placement}-LN but the "
              f"{dialect} dialect targets the "
              f"{'pre' if dialect == 'kv' else 'post'}-LN reference "
              f"loader — outputs will differ from this checkpoint's "
              f"native forward")
    dropped = [f"{k}={getattr(cfg, k)}" for k, default in (
        ("causal", False), ("batch_first_bug", False),
        ("pos_broadcast_bug", False), ("n_experts", None),
        ("n_kv_heads", None)) if getattr(cfg, k) != default]
    if dropped:
        print("warning: the reference .pt payload cannot represent these "
              "arch flags (they are dropped; reference scripts will run "
              "their own defaults): " + ", ".join(dropped))
    export_reference_checkpoint(args.pt, ckpt["params"], ckpt["vocab"],
                                cfg, dialect=dialect)
    print(f"exported -> {args.pt} ({dialect} dialect; loadable by "
          f"the reference's torch scripts via torch.load + strict "
          f"load_state_dict)")
    return 0


def _convert_gqa(args) -> int:
    from .models.gqa_convert import convert_checkpoint_dir

    convert_checkpoint_dir(args.ckpt, args.out, args.kv_heads)
    print(f"converted -> {args.out} (n_kv_heads={args.kv_heads}; run a "
          f"short finetune to recover quality: cli train --resume)")
    return 0


def _gqa_recover(args) -> int:
    import json

    from .serve.pipeline import DEMO_CKPT_B3
    from .tools.gqa_recover import RecoveryConfig, run_gqa_recovery

    res = run_gqa_recovery(RecoveryConfig(
        ckpt_dir=args.ckpt or DEMO_CKPT_B3, kv_heads=args.kv_heads,
        out_dir=args.out, rows=args.rows, steps=args.steps, lr=args.lr,
        seed=args.seed, log_fn=lambda m: print(m, flush=True)),
        device=args.device)
    print(json.dumps(res), flush=True)
    return 0


def _convert_distilbert(args) -> int:
    from .tools.convert import convert_hf_distilbert

    convert_hf_distilbert(args.hf_dir, args.out, lora_alpha=args.alpha)
    print("converted ->", args.out)
    return 0


def _export_emotion_hf(args) -> int:
    from .tools.publish import export_emotion_hf, push_to_hub

    export_emotion_hf(args.ckpt, args.out)
    print("exported HF snapshot ->", args.out)
    if args.push:
        push_to_hub(args.out, args.push)
        print("pushed ->", args.push)
    return 0


def _distill_emotion(args) -> int:
    import json
    import math

    from .emotion.train_scratch import ScratchSpec, distill_classifier

    spec = ScratchSpec(dim=args.dim, n_layers=args.n_layers,
                       hidden_dim=3 * args.dim, epochs=args.epochs,
                       seed=args.seed, n_per_label=args.n_per_label,
                       pool=args.pool, cue_suppress=args.cue_suppress,
                       pretrain_epochs=args.pretrain_epochs,
                       gen_per_label=args.gen_per_label)
    metrics = distill_classifier(args.out, spec=spec, device=args.device)
    # empty splits report nan; stdout stays strict JSON (RFC 8259)
    print(json.dumps({k: (None if isinstance(v, float)
                          and not math.isfinite(v) else v)
                      for k, v in metrics.items()}), flush=True)
    return 0


def _finetune_emotion(args) -> int:
    import json
    import os
    import pickle
    import shutil

    from .emotion.finetune import LoraSpec, finetune, load_label_tsv
    from .emotion.train_scratch import numpy_tree
    from .models.distilbert import DistilBertConfig, WordPieceTokenizer
    from .utils.device import resolve_device

    device = resolve_device(args.device)   # before any file is read
    with open(f"{args.base}/config.pkl", "rb") as f:
        cfg = DistilBertConfig(**pickle.load(f))
    with open(f"{args.base}/params.pkl", "rb") as f:
        params = pickle.load(f)
    tok = WordPieceTokenizer(f"{args.base}/vocab.txt")
    texts, labels = load_label_tsv(args.tsv)
    spec = LoraSpec(r=args.r, alpha=args.alpha, lr=args.lr,
                    batch=args.batch, epochs=args.epochs, seed=args.seed)
    merged, _, history = finetune(params, cfg, tok, texts, labels,
                                  spec=spec, log_every=args.log_every,
                                  device=device)
    os.makedirs(args.out, exist_ok=True)
    with open(f"{args.out}/params.pkl", "wb") as f:
        pickle.dump(numpy_tree(merged), f)   # each leaf's dtype kept
    shutil.copy(f"{args.base}/config.pkl", f"{args.out}/config.pkl")
    shutil.copy(f"{args.base}/vocab.txt", f"{args.out}/vocab.txt")
    print(json.dumps({"final_loss": history[-1]["loss"],
                      "out": args.out}), flush=True)
    return 0


def _add_emotion_training(sub) -> None:
    dev_help = "torch device (default cuda; 'cpu' runs on the host)"
    d = sub.add_parser("convert-distilbert",
                       help="HF snapshot dir -> emotion checkpoint dir")
    d.add_argument("--hf-dir", required=True)
    d.add_argument("--out", required=True)
    d.add_argument("--alpha", type=float, default=16.0)
    d.set_defaults(fn=_convert_distilbert)

    x = sub.add_parser("export-emotion-hf",
                       help="emotion ckpt dir -> HF snapshot (+ optional "
                            "Hub push)")
    x.add_argument("--ckpt", required=True)
    x.add_argument("--out", required=True)
    x.add_argument("--push", default=None, help="HF repo id to upload to")
    x.set_defaults(fn=_export_emotion_hf)

    di = sub.add_parser("distill-emotion",
                        help="train the in-repo neural emotion classifier "
                             "from scratch (template distillation)")
    di.add_argument("--out", default="eamg_tpu/emotion/ckpt_distilbert",
                    help="checkpoint dir (default: the shipped classifier "
                         "the port serves)")
    di.add_argument("--dim", type=int, default=256)
    di.add_argument("--n-layers", type=int, default=4)
    di.add_argument("--epochs", type=int, default=12)
    di.add_argument("--seed", type=int, default=2026)
    di.add_argument("--n-per-label", type=int, default=1200,
                    help="template rows per label (the shipped recipe)")
    di.add_argument("--pool", default="max",
                    choices=["max", "cls", "mean"],
                    help="max = per-token cue-detector head (the shipped "
                         "recipe)")
    di.add_argument("--cue-suppress", type=float, default=0.3,
                    help="span-supervision weight on non-cue tokens' "
                         "non-neutral logits (pool=max only)")
    di.add_argument("--gen-per-label", type=int, default=0,
                    help="compositional situation-generator TRAINING "
                         "rows per label (situation_gen); the frozen exam "
                         "is built regardless, and eval_gen_schemas is "
                         "empty (metrics null) at 0")
    di.add_argument("--pretrain-epochs", type=int, default=0,
                    help="MLM-pretrain the trunk on the train split for "
                         "N epochs before classification (0 = off)")
    di.add_argument("--device", default=None, help=dev_help)
    di.set_defaults(fn=_distill_emotion)

    f = sub.add_parser("finetune-emotion",
                       help="LoRA-finetune the emotion classifier")
    f.add_argument("--base", required=True,
                   help="base emotion checkpoint dir")
    f.add_argument("--tsv", required=True)
    f.add_argument("--out", required=True)
    f.add_argument("--r", type=int, default=8)
    f.add_argument("--alpha", type=float, default=16.0)
    f.add_argument("--lr", type=float, default=5e-4)
    f.add_argument("--batch", type=int, default=16)
    f.add_argument("--epochs", type=int, default=3)
    f.add_argument("--seed", type=int, default=42)
    f.add_argument("--log-every", type=int, default=10)
    f.add_argument("--device", default=None, help=dev_help)
    f.set_defaults(fn=_finetune_emotion)


def _add_convert(sub) -> None:
    c = sub.add_parser("convert-pt", help="reference .pt -> checkpoint dir")
    c.add_argument("--pt", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--serving-arch", action="store_true",
                   help="build the api_cache pre-LN serving arch")
    c.set_defaults(fn=_convert_pt)

    ep = sub.add_parser("export-pt",
                        help="checkpoint dir -> reference .pt (torch "
                             "format; the reverse of convert-pt)")
    ep.add_argument("--ckpt", required=True)
    ep.add_argument("--pt", required=True)
    ep.add_argument("--dialect", choices=("trainer", "kv"), default=None,
                    help="state-dict key naming: trainer (train_*.py / "
                         "api.py) or kv (api_cache.py remap output); "
                         "default follows the checkpoint's ln_placement "
                         "(post -> trainer, pre -> kv)")
    ep.set_defaults(fn=_export_pt)

    q = sub.add_parser("convert-gqa",
                       help="MHA checkpoint dir -> GQA (mean-pooled K/V "
                            "heads)")
    q.add_argument("--ckpt", required=True)
    q.add_argument("--out", required=True)
    q.add_argument("--kv-heads", type=int, required=True)
    q.set_defaults(fn=_convert_gqa)

    gr = sub.add_parser("gqa-recover",
                        help="convert an MHA checkpoint to GQA, measure "
                             "the PPL cost, uptrain to recover it, and "
                             "time decode for both architectures")
    gr.add_argument("--ckpt", default=None,
                    help="checkpoint dir (default: the packaged B3 demo)")
    gr.add_argument("--out", default=None,
                    help="save the recovered GQA checkpoint here")
    gr.add_argument("--kv-heads", type=int, default=2)
    gr.add_argument("--rows", type=int, default=2000)
    gr.add_argument("--steps", type=int, default=200)
    gr.add_argument("--lr", type=float, default=1e-4)
    gr.add_argument("--seed", type=int, default=0)
    gr.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs on the "
                         "host)")
    gr.set_defaults(fn=_gqa_recover)


def _add_train(sub) -> None:
    t = sub.add_parser("train", help="train a music generator")
    t.add_argument("--preset", default="large2",
                   choices=["mini", "large", "large2", "no_inst", "paper"])
    t.add_argument("--csv", default=None)
    t.add_argument("--synthetic", type=int, default=None,
                   help="rows of synthetic corpus instead of --csv")
    t.add_argument("--max-rows", type=int, default=None)
    t.add_argument("--out", default="ckpt_out")
    t.add_argument("--scheme", default=None,
                   choices=[None, "a", "b1", "b2", "b3"])
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--save-every", type=int, default=500)
    t.add_argument("--save-hours", type=float, default=None)
    t.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' trains on the "
                        "host)")
    t.add_argument("--mesh-data", type=int, default=1,
                   help="data-parallel axis size (ranks a process each)")
    t.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel axis size (enables Megatron TP)")
    t.add_argument("--fsdp", action="store_true",
                   help="ZeRO/FSDP: shard params + optimizer state over "
                        "the data axis (needs --mesh-data > 1)")
    t.add_argument("--pack", action="store_true",
                   help="sequence packing: several whole songs per row "
                        "with block-diagonal attention + per-segment "
                        "positions (implies --corrected)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--log-every", type=int, default=50)
    t.add_argument("--resume", default=None,
                   help="checkpoint dir to resume from (step + optimizer "
                        "state restored)")
    t.add_argument("--d-model", type=int, default=None,
                   help="override the preset's model width")
    t.add_argument("--n-head", type=int, default=None)
    t.add_argument("--n-layer", type=int, default=None)
    t.add_argument("--seq-len", type=int, default=None)
    t.add_argument("--attn-block", type=int, default=None,
                   help="blockwise online-softmax training attention "
                        "with this KV block size")
    t.add_argument("--experts", type=int, default=None,
                   help="mixture-of-experts FFN: number of routed experts "
                        "(beyond-reference; dense when omitted)")
    t.add_argument("--moe-every", type=int, default=1,
                   help="replace every k-th layer's MLP with experts")
    t.add_argument("--corrected", action="store_true",
                   help="train the corrected causal architecture (no "
                        "reference quirks; enables speculative decoding "
                        "and request coalescing)")
    t.set_defaults(fn=_train)

    da = sub.add_parser("train-demo-a",
                        help="train the Scheme-A demo on the grid-quantized "
                             "motif-reuse corpus (metrics in "
                             "train_metrics.json)")
    da.add_argument("--out", default="demo_a_out")
    da.add_argument("--rows", type=int, default=None,
                    help="default: 12000 compact / 24000 flagship")
    da.add_argument("--heldout-rows", type=int, default=None)
    da.add_argument("--epochs", type=int, default=None,
                    help="default: 8 compact / 24 flagship")
    da.add_argument("--seed", type=int, default=0)
    da.add_argument("--geometry", choices=["compact", "flagship"],
                    default="compact",
                    help="flagship = the reference product geometry "
                         "(d512 h8 L6 seq512) on ~480-token grid songs")
    da.add_argument("--kv-heads", type=int, default=None,
                    help="train GQA natively with this many K/V heads")
    da.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' trains on the "
                         "host)")
    da.set_defaults(fn=_train_demo_a)


def _add_generate(sub) -> None:
    g = sub.add_parser("generate", help="generate MIDI (batch/interactive)")
    g.add_argument("--checkpoint", default=None,
                   help="checkpoint dir, Scheme A or B3 (default: "
                        "eamg_tpu/serve/demo_ckpt_a)")
    g.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    g.add_argument("--interactive", action="store_true",
                   help="ask for a description, classify its emotion and "
                        "take the controls from it")
    g.add_argument("--bpm", type=float, default=180)
    g.add_argument("--key", default="A minor")
    g.add_argument("--instruments", nargs="*",
                   default=["Violin", "Acoustic Grand Piano"])
    g.add_argument("--max-len", type=int, default=None)
    g.add_argument("--temperature", type=float, default=1.0)
    g.add_argument("--top-k", type=int, default=50)
    g.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling mass (1.0 = off; after top-k)")
    g.add_argument("--min-p", type=float, default=0.0,
                   help="drop tokens below min_p x the top token's "
                        "probability (0 = off)")
    g.add_argument("--repetition-penalty", type=float, default=1.0,
                   help="CTRL/HF repetition penalty over tokens already "
                        "seen (1.0 = off; > 1 discourages repeats)")
    g.add_argument("--frequency-penalty", type=float, default=0.0,
                   help="subtract count x this from seen tokens' logits "
                        "(0 = off)")
    g.add_argument("--presence-penalty", type=float, default=0.0,
                   help="subtract this from every seen token's logit "
                        "(0 = off)")
    g.add_argument("--no-repeat-ngram", type=int, default=0,
                   help="ban tokens completing an n-gram already in the "
                        "stream (0 = off)")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--out", default="generated.mid")
    g.add_argument("--wav", default=None)
    g.add_argument("--full-gm", action="store_true")
    g.add_argument("--beams", type=int, default=0,
                   help="deterministic beam search with this many beams "
                        "instead of sampling (decode/beam.py); 0 = off")
    g.add_argument("--length-penalty", type=float, default=1.0,
                   help="beam ranking: score / gen_len**alpha (GNMT); "
                        "only with --beams")
    g.add_argument("--grammar", action="store_true",
                   help="FSM-constrained decoding: every token follows the "
                        "scheme's surface grammar and the stream closes "
                        "within budget (decode/grammar.py)")
    g.add_argument("--draft", default=None,
                   help="draft-model checkpoint dir: speculative decoding "
                        "with it as the proposer (same vocabulary; exact "
                        "output distribution)")
    g.add_argument("--gamma", type=int, default=4,
                   help="speculative proposals per verify step")
    g.add_argument("--lookup", action="store_true",
                   help="draft-free speculative decoding: propose "
                        "continuations from the stream's own history "
                        "(exact output distribution)")
    g.add_argument("--lookup-ngram", type=int, default=3,
                   help="history n-gram length matched by --lookup")
    g.add_argument("--medusa", default=None,
                   help="medusa heads pickle: gamma head proposals "
                        "verified in one block forward (exact output "
                        "distribution)")
    g.set_defaults(fn=_generate)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="eamg_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_generate(sub)
    _add_train(sub)
    _add_medusa(sub)
    _add_tools(sub)
    _add_convert(sub)
    _add_emotion_training(sub)
    s = sub.add_parser("serve", help="serve POST /generate")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--checkpoint", default=None,
                   help="checkpoint dir, Scheme A or B3 (default: the "
                        "packaged demo, eamg_tpu/serve/demo_ckpt_a)")
    s.add_argument("--random-demo", action="store_true",
                   help="serve the randomly initialised demo model even "
                        "when the packaged trained demo is present")
    s.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    s.add_argument("--full-gm", action="store_true",
                   help="map all instrument families, not just the "
                        "reference's three")
    s.add_argument("--coalesce", nargs="?", const="continuous",
                   default=False, choices=["window", "continuous"],
                   help="batch concurrent requests into one ragged decode "
                        "(requires a causal model). '--coalesce' / "
                        "'--coalesce continuous' = persistent engine, "
                        "requests join a RUNNING decode; '--coalesce "
                        "window' = 10 ms grouping window")
    s.add_argument("--slots", type=int, default=None,
                   help="continuous engine: concurrent request rows "
                        "(default 8); window mode: max batch size")
    s.add_argument("--chunk", type=int, default=None,
                   help="continuous engine: decode steps between "
                        "admission/harvest boundaries (default 128; "
                        "smaller = faster join, larger = fewer harvests)")
    s.add_argument("--max-queue", type=int, default=None,
                   help="admission-queue bound before requests are shed "
                        "with 503 (default 256; 0 = unbounded)")
    s.add_argument("--fast-routing", action="store_true",
                   help="a lone request on an idle engine decodes through "
                        "the batch-1 ragged decode instead of the engine's "
                        "own shape: fewer rows per step, but same-seed "
                        "bytes may then differ by load on the card")
    s.add_argument("--engine-top-p", default=None,
                   help="continuous engine nucleus mode: a float fixes the "
                        "mass for the shared decode (mismatching requests "
                        "decode solo); 'row' filters top-p AND min-p per "
                        "row, so every request's values ride the engine")
    s.add_argument("--engine-medusa", action="store_true",
                   help="put the checkpoint's Medusa heads into the "
                        "continuous engine, so medusa=true requests join "
                        "the shared decode (per-row speculation; every row "
                        "of a chunk with a live Medusa row pays the block "
                        "verify); default off: medusa requests decode solo")
    s.add_argument("--engine-ngram", type=int, default=0,
                   help="continuous engine: ban n-grams of this size in "
                        "the shared decode; requests asking "
                        "no_repeat_ngram=N ride the engine (a per-row "
                        "on/off bit, plain rows keep their bytes); other "
                        "sizes decode solo")
    s.add_argument("--engine-grammar", action="store_true",
                   help="put the served scheme's FSM (decode/grammar.py) "
                        "into the engine or the window batcher, so "
                        "grammar=true requests ride the shared decode "
                        "(a per-row on/off bit, plain rows keep their "
                        "bytes); without it they decode solo")
    s.set_defaults(fn=_serve)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
