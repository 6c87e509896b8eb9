"""CLI harness: completion | perplexity | passkey (counterpart of
``xalm_tpu/harness/main.py``, same flags and output format).

    python -m xalm_tpu_torch.harness.main <checkpoint.xalm> [options]
      -d [cuda,cpu]   device (default cuda)
      -m [completion,c,perplexity,passkey]   mode (default completion)
      -T <int>        sliding window context length (0 - max)
      -i <string>     input prompt
      -f <filepath>   input file with prompt
      -n <int>        completion: steps (default 256, 0 = max_seq_len);
                      passkey: junk lines (default 250)
      -l <int>        passkey position (-1 - random)
      --seed <int>    seed of the passkey and its position, and of sampling
      -t <dtype>      kv cache dtype: auto (bf16 on cuda, f16 on cpu) | f16 | bf16 | f32
                      | i8 (int8 codes with per-row f32 scales); on the card bf16 and
                      f32 run the attention kernels (and the megakernel), i8 their
                      int8 forms, f16 the dense attention (the reference's routing)
      --compute <d>   matmul compute dtype of the plain paths: auto | f32 | bf16
      --matmul <i>    auto (= kernel) | kernel (= pallas, the JAX harness's name for
                      its kernel path) | plain | xla
      --wcls-i8       re-code a float head to i8 per row at load; the decode
                      megakernel then runs the head in the same launch
      --q4 GROUP      pack the body weights to 4-bit at load, GROUP weights per
                      scale (a multiple of 128 dividing every half contraction
                      width, e.g. 128 or 512); decode then takes int8
                      activations (the megakernel's q4 body, or the q4 GEMV)
      --temperature <float>  sampling temperature (0 = greedy, the default)
      --top-k <int>   top-k filter of sampling (0 = off)
      --top-p <float> nucleus filter of sampling (1 = off)
      --spec K        speculative decoding with K drafts a verify chunk (try 7;
                      greedy-exact; ``runtime/spec.py``); n-gram drafts, or
      --draft D.xalm  drafts from this (smaller) model on the same vocabulary
      --session PATH  completion: resume from PATH if it exists, and save the
                      cache and the token history there afterwards (xalm v2
                      block store; ``runtime/session.py``)
      --profile       print the profiler table (``obs/profiler.py``: the spans
                      ``model load`` and the mode's, host wall time, each
                      ending where the host waits for the card, so the card's
                      time is in it) and the process's resource usage at exit
      --tp/--dp/--pp N  tensor / data / pipeline parallel ways (``parallel/``;
                      --pp composes with --tp, not --dp)
      --coordinator H:P, --num-processes N, --process-id I
                      multi-host: this process is rank I of N (or
                      XALM_COORDINATOR / XALM_NUM_PROCESSES / XALM_PROCESS_ID,
                      or torchrun's variables)

Every family the JAX converter writes loads (Llama/Mistral, Mixtral, Qwen2
and Qwen3, Gemma, Gemma-2, Phi-3). Decode goes through the whole-step
megakernel where it takes the model (i8 or q4 body, a bf16, f32 or int8
cache, B <= 8, head_dim 128 or 256 on the card) and through the
per-layer kernels otherwise (Phi-3's head_dim 96, MoE, every sharded
engine); the stats print which ("decode path: ..."). The parser takes
every flag of the JAX harness. As in the JAX harness, --session goes
before --spec, and both before sampling; the draft model loads with
``Engine.from_xalm``'s defaults on the same device.

Parallel runs (``xalm_tpu_torch/parallel/``): --tp/--dp build a
``ShardedEngine`` over a (dp, tp) mesh, --pp a ``PipelinedEngine`` over a
(pp, tp) one; --q4 with any of them, and --pp with --dp, are refused as
the JAX harness refuses them. Each rank is one process. Under torchrun,
or with the multi-host flags, this process is one rank of the world;
started plainly with a flag above 1, the harness starts the other ranks
itself (``multihost.spawn_ranks``), one a card over NCCL, or gloo ranks
on the CPU with ``-d cpu``, and is rank 0. Only rank 0 writes the report. --temperature
above 0 samples (``Engine.generate``'s sampler, seeded by --seed); --top-k
and --top-p act only then, so without it they run greedily, as in the JAX
harness. On the card decode runs in segments of 16 steps replayed from a
CUDA graph (``runtime/graphs.py``).

``-t auto``, the default, is a bf16 cache on the card and f16 on the CPU
(``runtime.engine.auto_kv_dtype``); the JAX harness defaults to f16
everywhere, which on the card would take the dense attention on every
chunk and step (no attention kernel or megakernel takes f16, in either
package).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import random
import sys
import time

from xalm_tpu_torch.obs.console import SystemUsage
from xalm_tpu_torch.obs.profiler import profile, report, reset

__all__ = ["main"]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="xalm-torch", description="xalm inference on PyTorch + CUDA")
    p.add_argument("checkpoint", help=".xalm model file")
    p.add_argument("-d", dest="device", default="cuda", choices=["cuda", "cpu"], help="device")
    p.add_argument("-m", dest="mode", default="completion",
                   choices=["completion", "c", "passkey", "perplexity"], help="run mode")
    p.add_argument("-T", dest="context", type=int, default=0, help="context window (0 - max)")
    p.add_argument("-i", dest="prompt", default=None, help="input prompt")
    p.add_argument("-f", dest="prompt_file", default=None, help="input file with prompt")
    p.add_argument("-n", dest="num", type=int, default=None,
                   help="completion: steps (default 256; 0 = max_seq_len); passkey: junk lines "
                        "(default 250)")
    p.add_argument("-l", dest="passkey_pos", type=int, default=-1,
                   help="passkey position (-1 - random)")
    p.add_argument("--seed", type=int, default=None,
                   help="seed for passkey randomness and for sampling")
    p.add_argument("-t", dest="kv_dtype", default="auto", choices=["auto", "f16", "bf16", "f32", "i8"],
                   help="kv cache dtype (auto: bf16 on cuda, f16 on cpu; i8 = int8 with per-row "
                        "scales)")
    p.add_argument("--compute", default="auto", choices=["auto", "f32", "bf16"],
                   help="matmul compute dtype of the plain paths")
    p.add_argument("--matmul", default="auto",
                   choices=["auto", "kernel", "pallas", "plain", "xla"],
                   help="per-layer implementation (auto = kernel; pallas, the JAX harness's "
                        "kernel path, = kernel)")
    p.add_argument("--wcls-i8", action="store_true",
                   help="re-code a float head to i8 per row (the megakernel then runs it)")
    p.add_argument("--q4", type=int, default=0, metavar="GROUP",
                   help="pack the body weights to 4-bit at load with GROUP weights per scale "
                        "(a multiple of 128, e.g. 128); implies int8 activations in decode")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature (0 = greedy, the reference's only mode)")
    p.add_argument("--top-k", type=int, default=0, help="top-k filter (0 = off)")
    p.add_argument("--top-p", type=float, default=1.0, help="nucleus filter (1 = off)")
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="speculative decoding with K drafts per verify chunk (try 7; "
                        "greedy-exact)")
    p.add_argument("--draft", metavar="DRAFT.xalm", default=None,
                   help="with --spec: draft with this (smaller) model instead of n-gram lookup "
                        "(same vocabulary)")
    p.add_argument("--session", default=None, metavar="PATH",
                   help="completion: resume from PATH if it exists, save the KV cache and token "
                        "history there afterwards (xalm v2 block store)")
    p.add_argument("--profile", action="store_true",
                   help="print the profiler report and the process usage at exit")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ways (device mesh)")
    p.add_argument("--dp", type=int, default=1, help="data-parallel ways (device mesh)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages (layers split over devices: capacity mode; "
                        "composes with --tp, exclusive with --dp)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host: coordinator address host:port (or XALM_COORDINATOR)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host: total processes (or XALM_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host: this process id (or XALM_PROCESS_ID)")
    return p


def _refuse(args) -> None:
    """The JAX harness's refusals of parallel flags, before anything loads."""
    if args.q4 and (args.tp > 1 or args.dp > 1 or args.pp > 1):
        raise SystemExit("error: --q4 is single-device (the sharded engines "
                         "stream i8; shard-aware 4-bit packing is future work)")
    if args.pp > 1 and args.dp > 1:
        raise SystemExit("error: --pp composes with --tp, not --dp")


def _get_prompt(args) -> str:
    if args.prompt is not None and args.prompt_file is not None:
        raise SystemExit("error: choose one of -i or -f")
    if args.prompt_file is not None:
        with open(args.prompt_file) as f:
            return f.read()
    if args.prompt is not None:
        return args.prompt
    raise SystemExit("error: provide a prompt with -i or -f")


def _load_engine(args):
    import torch

    from xalm_tpu_torch.runtime.engine import Engine

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: -d cuda but no CUDA device is visible (use -d cpu)")
    dt = {"f16": torch.float16, "bf16": torch.bfloat16, "f32": torch.float32, "i8": torch.int8,
          "auto": "auto"}
    print(f"loading model {args.checkpoint}")
    with profile("model load"):
        eng = _load_parallel(args, dt) if args.tp * args.dp * args.pp > 1 else Engine.from_xalm(
            args.checkpoint,
            context=args.context,
            kv_dtype=dt[args.kv_dtype],
            compute_dtype=dt[args.compute],
            matmul_impl="kernel" if args.matmul == "pallas" else args.matmul,
            wcls_i8=args.wcls_i8,
            q4_group=args.q4,
            device=args.device,
        )
        if args.device == "cuda":
            torch.cuda.synchronize()  # the span holds the load's device work
    cfg = eng.cfg
    print(
        f"{cfg.n_layers} layers | dim {cfg.dim} | {cfg.n_heads} heads "
        f"({cfg.n_kv_heads} kv) | window {cfg.max_seq_len} | vocab {cfg.vocab_size}"
    )
    print(f"active bytes with full context window: {eng.active_bytes(cfg.max_seq_len):,}")
    return eng


def _load_parallel(args, dt):
    """The sharded engine of --tp/--dp, or the pipelined one of --pp, over
    a mesh of this world's ranks."""
    import torch.distributed as dist

    world = dist.get_world_size()
    matmul = "kernel" if args.matmul == "pallas" else args.matmul
    if args.pp > 1:
        from xalm_tpu_torch.parallel.pipeline import PipelinedEngine, make_pp_mesh

        mesh = make_pp_mesh(args.pp, tp=args.tp)
        print(f"mesh: pp={args.pp} x tp={args.tp} over {world} devices")
        return PipelinedEngine.from_xalm(args.checkpoint, mesh, context=args.context,
                                         kv_dtype=dt[args.kv_dtype],
                                         compute_dtype=dt[args.compute])
    from xalm_tpu_torch.parallel.mesh import make_mesh
    from xalm_tpu_torch.parallel.sharded_engine import ShardedEngine

    mesh = make_mesh(dp=args.dp, tp=args.tp)
    print(f"mesh: dp={args.dp} x tp={args.tp} over {world} devices")
    return ShardedEngine.from_xalm(args.checkpoint, mesh, context=args.context,
                                   kv_dtype=dt[args.kv_dtype], compute_dtype=dt[args.compute],
                                   matmul_impl=matmul)


def run_completion(args) -> int:
    eng = _load_engine(args)
    tok = eng.tokenizer
    if tok is None:
        raise SystemExit("error: model has no tokenizer.tokens tensor")
    prompt = _get_prompt(args)
    num_steps = 256 if args.num is None else args.num
    if num_steps == 0:
        num_steps = eng.cfg.max_seq_len

    t0 = time.perf_counter()
    ids = tok.encode(prompt)
    enc_s = time.perf_counter() - t0
    print(
        f"Encoding stats: ({len(ids)} tokens, throughput: {len(ids)/max(enc_s,1e-9):.4g} tok/s, "
        f"latency: {enc_s/max(len(ids),1):.4g} s/tok, total: {enc_s:.4g}s)"
    )
    resume = None
    if args.session and os.path.exists(args.session):
        from xalm_tpu_torch.runtime.session import load_session

        resume = load_session(args.session, eng.cfg, device=args.device)
        print(f"resumed session {args.session}: {len(resume.tokens[0])} tokens at pos "
              f"{int(resume.pos[0])}")
        ids = tok.encode(prompt, bos=False)  # a continuation: the context is in the cache
    prev = ids[0] if ids else tok.bos_id

    def on_token(t):
        nonlocal prev
        sys.stdout.write(tok.decode_one(prev, t).decode("utf-8", "replace"))
        sys.stdout.flush()
        prev = t

    sys.stdout.write(prompt)
    if args.session:
        from xalm_tpu_torch.runtime.session import save_session

        out, stats, sess = eng.generate(ids, num_steps, on_token=on_token, resume=resume,
                                        return_session=True)
        save_session(args.session, eng.cfg, sess)
        print(f"\nsaved session to {args.session} ({len(sess.tokens[0])} tokens)", end="")
    elif args.spec:
        from xalm_tpu_torch.runtime.engine import Engine
        from xalm_tpu_torch.runtime.spec import generate_spec

        draft = Engine.from_xalm(args.draft, device=args.device) if args.draft else None
        out, stats = generate_spec(eng, ids, num_steps, k=args.spec, on_token=on_token,
                                   draft_engine=draft)
    else:
        sampling = {}
        if args.temperature > 0:
            sampling = dict(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                            seed=args.seed)
        out, stats = eng.generate(ids, num_steps, on_token=on_token, **sampling)
    print()
    print(
        f"Generation stats:\n"
        f"  prompt: {stats.prompt_tokens} tokens, hydrate: {stats.prefill_s:.4g}s\n"
        f"  {stats.generated_tokens} tokens, throughput: {stats.tok_per_s:.5g} tok/s, "
        f"latency: {stats.decode_s/max(stats.generated_tokens,1):.5g} s/tok\n"
        f"  bandwidth: {stats.bandwidth_gb_s:.5g} GB/s (vs active bytes model)\n"
        f"  decode path: {eng.decode_path(1)}"
    )
    if stats.spec_proposed:
        print(f"  speculation: {stats.spec_accepted}/{stats.spec_proposed} drafts accepted "
              f"({100.0 * stats.spec_accepted / stats.spec_proposed:.1f}%)")
    return 0


def run_perplexity(args) -> int:
    eng = _load_engine(args)
    ids = eng.tokenizer.encode(_get_prompt(args))
    print(f"perplexity over {len(ids)} tokens...")
    t0 = time.perf_counter()
    ppl, err, n = eng.perplexity(ids)
    dt = time.perf_counter() - t0
    bw = sum(eng.active_bytes(p) for p in range(n)) / dt / 1e9
    print(
        f"perplexity: {ppl:.4f} ± {err:.4f} over {n} tokens\n"
        f"  throughput: {n/dt:.4g} tok/s, bandwidth: {bw:.4g} GB/s"
    )
    return 0


PASSKEY_PREFIX = (
    "There is an important info hidden inside a lot of irrelevant text. "
    "Find it and memorize them. I will quiz you about the important information there."
)
PASSKEY_SUFFIX = " What is the pass key? The pass key is"
PASSKEY_JUNK = (
    " The grass is green. The sky is blue. The sun is yellow. "
    "Here we go. There and back again."
)


def build_passkey_prompt(n_junk: int, pos: int, passkey: int) -> str:
    """The synthetic long-context retrieval prompt of the JAX harness: the
    passkey line before junk line ``pos`` of ``n_junk``."""
    parts = [PASSKEY_PREFIX]
    for i in range(n_junk):
        if i == pos:
            parts.append(f" The pass key is {passkey}. Remember it. {passkey} is the pass key.")
        parts.append(PASSKEY_JUNK)
    parts.append(PASSKEY_SUFFIX)
    return "".join(parts)


def run_passkey(args) -> int:
    """Long-context retrieval while the sliding-window KV ring wraps: the
    passkey and its position drawn from Python's ``random`` (``--seed``),
    up to 16 greedy tokens; exit 0 when the answer holds the passkey."""
    eng = _load_engine(args)
    tok = eng.tokenizer
    if args.seed is not None:
        random.seed(args.seed)
    n_junk = 250 if args.num is None else args.num
    passkey = random.randint(1, 50000)
    pos = args.passkey_pos if args.passkey_pos != -1 else random.randrange(n_junk)
    ids = tok.encode(build_passkey_prompt(n_junk, pos, passkey))
    print(
        f"Passkey test:\n  prompt: {len(ids)} tokens\n  passkey: {passkey}\n"
        f"  passkey position: {pos}/{n_junk}\n  context window: {eng.cfg.max_seq_len}"
    )
    t0 = time.perf_counter()
    out, stats = eng.generate(ids, 16)
    dt = time.perf_counter() - t0
    text = tok.decode(out)
    print(f"  model answer: {text.strip()!r}")
    ok = str(passkey) in text
    print(f"  retrieval: {'OK' if ok else 'FAILED'}  ({dt:.1f}s total, "
          f"hydrate {stats.prefill_s:.1f}s, {stats.tok_per_s:.3g} tok/s decode)\n"
          f"  decode path: {eng.decode_path(1)}")
    return 0 if ok else 1


def _join_world(args, argv) -> list:
    """Join (or start) the world a parallel run needs: under torchrun or
    with the multi-host flags this process is one rank; started plainly
    with a parallel flag above 1 it starts the other ranks itself and is
    rank 0. -> the children it started (none where it joined a world)."""
    from xalm_tpu_torch.parallel import multihost

    ways = args.tp * args.dp * args.pp
    joined = multihost.distributed_requested(args.coordinator) or args.num_processes is not None
    if not joined and ways == 1:
        return []
    children = [] if joined else multihost.spawn_ranks(
        list(sys.argv[1:] if argv is None else argv), ways, "xalm_tpu_torch.harness.main")
    try:
        multihost.init_distributed(args.coordinator, args.num_processes, args.process_id,
                                   device="cpu" if args.device == "cpu" else None)
    except (KeyError, ValueError) as e:
        raise SystemExit("error: --coordinator/--num-processes/--process-id: this process "
                         f"cannot join its world ({e})") from e
    return children


def main(argv: list[str] | None = None) -> int:
    proc_t0, proc_r0 = SystemUsage._now()
    args = _build_parser().parse_args(argv)
    _refuse(args)
    children = _join_world(args, argv)
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        if rank == 0:
            rc = _run(args, proc_t0, proc_r0)
        else:
            with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
                rc = _run(args, proc_t0, proc_r0)  # only rank 0 writes the report
    except BaseException:
        for p in children:  # they would wait for rank 0's next collective
            p.kill()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if children:
            from xalm_tpu_torch.parallel.multihost import wait_ranks

            if wait_ranks(children) != 0:
                print("error: a rank of the world failed", file=sys.stderr)
                rc = 1
    return rc


def _run(args, proc_t0, proc_r0) -> int:
    mode = {"c": "completion"}.get(args.mode, args.mode)
    run = {"completion": run_completion, "perplexity": run_perplexity, "passkey": run_passkey}
    if args.profile:
        reset()  # this run's spans only
    try:
        with profile(mode):
            rc = run[mode](args)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.profile:
        print(report())
        print(SystemUsage.measure(proc_t0, proc_r0).format(title="process usage"))
    return rc


if __name__ == "__main__":
    sys.exit(main())
