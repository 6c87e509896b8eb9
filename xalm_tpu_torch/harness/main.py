"""CLI harness: completion | perplexity (counterpart of
``xalm_tpu/harness/main.py``, same flags and output format).

    python -m xalm_tpu_torch.harness.main <checkpoint.xalm> [options]
      -d [cuda,cpu]   device (default cuda)
      -m [completion,c,perplexity]   mode (default completion)
      -T <int>        sliding window context length (0 - max)
      -i <string>     input prompt
      -f <filepath>   input file with prompt
      -n <int>        completion steps (default 256, 0 = max_seq_len)
      -t <dtype>      kv cache dtype: auto (bf16 on cuda, f16 on cpu) | f16 | bf16 | f32
      --compute <d>   matmul compute dtype of the plain paths: auto | f32 | bf16
      --matmul <i>    auto (= kernel) | kernel | plain | xla
      --wcls-i8       re-code a float head to i8 per row at load; the decode
                      megakernel then runs the head in the same launch

Decode goes through the whole-step megakernel where it takes the model (i8
body, bf16 cache on the card, B <= 8) and through the per-layer kernels
otherwise; the stats print which ("decode path: ..."). The JAX harness's
passkey mode and its --q4, --temperature, --spec, --draft, --session,
--tp/--dp/--pp flags belong to later slices: they are accepted and refused
with a message.
"""

from __future__ import annotations

import argparse
import sys
import time

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
                   help="completion: steps (default 256; 0 = max_seq_len)")
    p.add_argument("-t", dest="kv_dtype", default="auto", choices=["auto", "f16", "bf16", "f32", "i8"],
                   help="kv cache dtype (auto: bf16 on cuda, f16 on cpu)")
    p.add_argument("--compute", default="auto", choices=["auto", "f32", "bf16"],
                   help="matmul compute dtype of the plain paths")
    p.add_argument("--matmul", default="auto", choices=["auto", "kernel", "plain", "xla"],
                   help="per-layer implementation (auto = kernel)")
    p.add_argument("--wcls-i8", action="store_true",
                   help="re-code a float head to i8 per row (the megakernel then runs it)")
    # JAX-harness flags of later slices: refused unless left at their defaults
    p.add_argument("--q4", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--temperature", type=float, default=0.0, help=argparse.SUPPRESS)
    p.add_argument("--spec", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--draft", default=None, help=argparse.SUPPRESS)
    p.add_argument("--session", default=None, help=argparse.SUPPRESS)
    for flag in ("--tp", "--dp", "--pp"):
        p.add_argument(flag, type=int, default=1, help=argparse.SUPPRESS)
    return p


def _refuse_later(args) -> None:
    later = {
        "passkey mode": args.mode == "passkey",
        "-t i8": args.kv_dtype == "i8",
        "--q4": args.q4,
        "--temperature": args.temperature > 0,
        "--spec/--draft": args.spec or args.draft,
        "--session": args.session,
        "--tp/--dp/--pp": args.tp * args.dp * args.pp > 1,
    }
    for name, used in later.items():
        if used:
            raise SystemExit(f"error: {name} is not ported yet (later slice)")


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
    dt = {"f16": torch.float16, "bf16": torch.bfloat16, "f32": torch.float32, "auto": "auto"}
    print(f"loading model {args.checkpoint}")
    eng = Engine.from_xalm(
        args.checkpoint,
        context=args.context,
        kv_dtype=dt[args.kv_dtype],
        compute_dtype=dt[args.compute],
        matmul_impl=args.matmul,
        wcls_i8=args.wcls_i8,
        device=args.device,
    )
    cfg = eng.cfg
    print(
        f"{cfg.n_layers} layers | dim {cfg.dim} | {cfg.n_heads} heads "
        f"({cfg.n_kv_heads} kv) | window {cfg.max_seq_len} | vocab {cfg.vocab_size}"
    )
    print(f"active bytes with full context window: {eng.active_bytes(cfg.max_seq_len):,}")
    return eng


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
    prev = ids[0] if ids else tok.bos_id

    def on_token(t):
        nonlocal prev
        sys.stdout.write(tok.decode_one(prev, t).decode("utf-8", "replace"))
        sys.stdout.flush()
        prev = t

    sys.stdout.write(prompt)
    out, stats = eng.generate(ids, num_steps, on_token=on_token)
    print()
    print(
        f"Generation stats:\n"
        f"  prompt: {stats.prompt_tokens} tokens, hydrate: {stats.prefill_s:.4g}s\n"
        f"  {stats.generated_tokens} tokens, throughput: {stats.tok_per_s:.5g} tok/s, "
        f"latency: {stats.decode_s/max(stats.generated_tokens,1):.5g} s/tok\n"
        f"  bandwidth: {stats.bandwidth_gb_s:.5g} GB/s (vs active bytes model)\n"
        f"  decode path: {eng.decode_path(1)}"
    )
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


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    _refuse_later(args)
    mode = {"c": "completion"}.get(args.mode, args.mode)
    try:
        return run_completion(args) if mode == "completion" else run_perplexity(args)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
