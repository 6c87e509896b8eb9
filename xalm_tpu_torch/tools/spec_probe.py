"""Speculative-decoding probe on a real checkpoint (the port's copy of
``tools/spec_probe.py``).

Measures what prompt-lookup speculation (``runtime/spec.py``) buys on real
text: greedy-exactness against ``Engine.generate``, the draft acceptance
rate, and the weight-stream reuse factor (tokens emitted a verify or decode
call): on a bandwidth-bound decoder every call streams the weights once,
so reuse bounds the speedup whatever the device.

Prompts are windows of held-out token ids (``<model>/heldout_ids.npy``),
continued ``--gen`` tokens each. The HF directory converts to an i8
container with the port's converter into ``--work``.

    python -m xalm_tpu_torch.tools.spec_probe [--model models/xalm-mini] [--cpu]
        [--prompts 16] [--ctx 192] [--gen 64] [--k 7] [--json out.json]
        [--draft | --draft-model DIR] [--context N]

It runs on the card (``cuda``) unless ``--cpu`` is given; acceptance and
reuse depend on the greedy tokens alone.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]


def _container(hf_dir: str, work: Path) -> str:
    """An i8 container of the HF directory in ``work``, converted once."""
    from xalm_tpu_torch.convert import convert as cvt

    out = work / (Path(hf_dir).name + "_i8.xalm")
    if not out.exists():
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cvt.main(["--input", hf_dir, "--output", str(out), "--type", "i8"])
        if rc != 0:
            raise SystemExit(f"error: converting {hf_dir} failed")
    return str(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spec_probe")
    ap.add_argument("--model", default=str(REPO / "models" / "xalm-mini"))
    ap.add_argument("--work", default=str(REPO / "build" / "spec_probe"))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--prompts", type=int, default=16)
    ap.add_argument("--ctx", type=int, default=192, help="prompt tokens per window")
    ap.add_argument("--gen", type=int, default=64, help="tokens generated per prompt")
    ap.add_argument("--k", type=int, default=7, help="drafts per verify chunk")
    ap.add_argument("--json", default=None, help="also write a JSON summary here")
    ap.add_argument("--draft", action="store_true",
                    help="the model drafts for itself through a second engine")
    ap.add_argument("--draft-model", default=None, metavar="DIR",
                    help="HF directory of a smaller draft model with the same tokenizer")
    ap.add_argument("--context", type=int, default=0,
                    help="window override (e.g. 128 with --ctx 192: the ring wraps)")
    args = ap.parse_args(argv)

    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.runtime.spec import generate_spec

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device (use --cpu)")
    model_dir = str(Path(args.model).resolve())
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    eng = Engine.from_xalm(_container(model_dir, work), context=args.context, device=device,
                           progress=False)
    draft_eng = None
    if args.draft_model:
        draft_eng = Engine.from_xalm(_container(str(Path(args.draft_model).resolve()), work),
                                     context=args.context, device=device, progress=False)
    elif args.draft:
        draft_eng = Engine(eng.cfg, eng.params, eng.tokenizer)

    heldout = np.load(Path(model_dir) / "heldout_ids.npy")
    stride = (len(heldout) - args.ctx - 1) // args.prompts
    segment = 16 if device == "cuda" else 1

    tot_emitted = tot_calls = tot_prop = tot_acc = mismatches = 0
    t_spec = t_plain = 0.0
    for i in range(args.prompts):
        prompt = heldout[i * stride : i * stride + args.ctx].tolist()
        t0 = time.perf_counter()
        ref, _ = eng.generate(prompt, args.gen, stop_on_eos=False, segment=segment)
        t_plain += time.perf_counter() - t0
        t0 = time.perf_counter()
        out, st = generate_spec(eng, prompt, args.gen, k=args.k, stop_on_eos=False,
                                segment=segment, draft_engine=draft_eng)
        t_spec += time.perf_counter() - t0
        if out != ref:
            mismatches += 1
            d = next(j for j, (a, b) in enumerate(zip(out, ref)) if a != b)
            # a near tie? the two candidates' logits under the plain forward
            logits, _, _ = eng.prefill(prompt + ref[:d], eng.new_cache(1), logits_mode="last")
            lg = logits.float().cpu().numpy()[0]
            print(f"  prompt {i}: MISMATCH at gen pos {d}: spec={out[d]} ref={ref[d]} | "
                  f"logits: spec {lg[out[d]]:.6f} vs ref {lg[ref[d]]:.6f} "
                  f"(delta {lg[out[d]] - lg[ref[d]]:+.2e})", flush=True)
        n_verify = st.spec_proposed // args.k
        # fallback segments emitted the tokens speculation did not
        n_fallback = -(-max(len(out) - (st.spec_accepted + n_verify), 0) // segment)
        tot_calls += n_verify + n_fallback
        tot_emitted += len(out)
        tot_prop += st.spec_proposed
        tot_acc += st.spec_accepted
        print(f"prompt {i}: {len(out)} tok, {n_verify} verifies, "
              f"{st.spec_accepted}/{st.spec_proposed} drafts accepted", flush=True)

    acc = tot_acc / max(tot_prop, 1)
    reuse = tot_emitted / max(tot_calls, 1)
    summary = {
        "prompts": args.prompts, "gen_per_prompt": args.gen, "k": args.k,
        "accept_rate": round(acc, 4), "tokens_per_call": round(reuse, 3),
        "exact_vs_generate": mismatches == 0, "spec_s": round(t_spec, 2),
        "plain_s": round(t_plain, 2),
        "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "mode": ("real-draft:" + Path(args.draft_model).name) if args.draft_model
        else ("draft-model" if args.draft else "ngram"),
        "context": args.context,
    }
    print(f"\nacceptance {100 * acc:.1f}% | weight-stream reuse {reuse:.2f} tokens/call | "
          f"greedy-exact: {mismatches == 0} ({mismatches} mismatches)")
    print(json.dumps(summary))
    if args.json:
        Path(args.json).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
