"""Quality gate on a real checkpoint (the port's copy of
``tools/eval_real_model.py``), through the whole user pipeline: HF
directory -> the port's converter -> .xalm -> the port's engine.

1. HF cross-check: the engine's f32 logits against ``transformers``'
   ``MistralForCausalLM`` on the same checkpoint (``transformers`` is
   imported in this step alone).
2. Perplexity +- stderr on held-out text for every container dtype (f32,
   f16, bf16, i8, f8_e4m3, q8) and the i8 head recode: quantized containers
   should sit within noise of f32.
3. Wrapped-context perplexity: a document longer than the window through
   the sink + ring cache.
4. Decode-path quality of int8 activations (``a8_decode``) and of the
   packed-q4 body at groups 128, 256 and 512 where the widths allow.
5. Passkey retrieval at three depths and a code-copy probe, in the window
   and wrapped past it; a greedy completion sample.

    python -m xalm_tpu_torch.tools.eval_real_model [--model models/xalm-mini]
        [--out build/eval_real_model.md] [--segments 6] [--cpu]

The checkpoint directory holds ``heldout_ids.npy`` beside its weights. It
runs on the card (``cuda``) unless ``--cpu`` is given, and writes its
report to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import math
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]

DTYPES = ["f32", "f16", "bf16", "i8", "f8_e4m3", "q8"]


def hf_crosscheck(model_dir: str, eng, tokens: list[int]) -> float:
    """Max |logit delta| between transformers' MistralForCausalLM (f32, on
    the CPU) and the engine."""
    from transformers import MistralForCausalLM

    hf = MistralForCausalLM.from_pretrained(model_dir, torch_dtype=torch.float32)
    hf.eval()
    with torch.no_grad():
        want = hf(torch.tensor([tokens])).logits[0].numpy()
    got, _, _ = eng.prefill(tokens, eng.new_cache(1), logits_mode="all")
    return float(np.abs(np.asarray(got) - want).max())


def ppl_segments(eng, ids: np.ndarray, seg_len: int, n_seg: int):
    """Perplexity +- stderr over n_seg disjoint held-out segments (the
    chunked prefill path)."""
    from xalm_tpu_torch.sampler import token_logprobs

    sum_lp = sum_lp2 = 0.0
    count = 0
    for i in range(n_seg):
        seg = ids[i * seg_len : (i + 1) * seg_len].tolist()
        logits, _, _ = eng.prefill(seg, eng.new_cache(1), logits_mode="all")
        lps = token_logprobs(torch.as_tensor(np.asarray(logits[: len(seg) - 1])),
                             torch.tensor(seg[1:])).double().numpy()
        sum_lp += lps.sum()
        sum_lp2 += (lps ** 2).sum()
        count += len(lps)
    ppl = math.exp(-sum_lp / count)
    err = ppl * math.sqrt((sum_lp2 - sum_lp * sum_lp / count) / count / count)
    return ppl, err, count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="eval_real_model")
    ap.add_argument("--model", default=str(REPO / "models" / "xalm-mini"))
    ap.add_argument("--out", default=str(REPO / "build" / "eval_real_model.md"))
    ap.add_argument("--work", default=str(REPO / "build" / "eval_real_model"))
    ap.add_argument("--segments", type=int, default=6)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from xalm_tpu_torch.convert import convert as cvt
    from xalm_tpu_torch.harness.main import build_passkey_prompt
    from xalm_tpu_torch.models.params import recode_params_q4
    from xalm_tpu_torch.runtime.engine import Engine

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device (use --cpu)")
    dev_name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    model_dir = str(Path(args.model).resolve())
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)

    def load(path, **kw):
        return Engine.from_xalm(path, device=device, progress=False, **kw)

    heldout = np.load(Path(model_dir) / "heldout_ids.npy")
    lines = ["# Quality gate on a real checkpoint (PyTorch port)", "",
             f"Checkpoint `{args.model}` through the port's converter and engine on {dev_name}.",
             ""]

    paths = {}
    for dt in DTYPES:
        out = str(work / f"model_{dt}.xalm")
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cvt.main(["--input", model_dir, "--output", out, "--type", dt])
        if rc != 0:
            raise SystemExit(f"error: converting to {dt} failed")
        paths[dt] = out
        print(f"converted {dt} ({time.time() - t0:.1f}s)", flush=True)

    eng32 = load(paths["f32"], compute_dtype=torch.float32, kv_dtype=torch.float32,
                 matmul_impl="xla")
    delta = hf_crosscheck(model_dir, eng32, heldout[: min(256, eng32.cfg.max_seq_len)].tolist())
    lines += ["## HF-transformers cross-check", "",
              f"Max |logit delta| against `MistralForCausalLM` over a held-out probe, f32 "
              f"end to end: **{delta:.2e}**", ""]
    print(f"HF cross-check max|dlogit| = {delta:.3e}", flush=True)

    seg_len = min(512, eng32.cfg.max_seq_len)  # every segment fits the window
    lines += ["## Held-out perplexity by container dtype", "",
              f"Segments of {seg_len} tokens x {args.segments}, chunked prefill:", "",
              "| dtype | ppl | +- stderr | delta vs f32 |", "|---|---|---|---|"]
    base = None
    for dt in DTYPES + ["i8 + wcls_i8"]:
        eng = load(paths["i8"], wcls_i8=True) if dt == "i8 + wcls_i8" else load(paths[dt])
        ppl, err, n = ppl_segments(eng, heldout, seg_len, args.segments)
        base = ppl if base is None else base
        lines.append(f"| {dt} | {ppl:.3f} | {err:.3f} | {ppl - base:+.3f} |")
        print(f"[{dt}] ppl {ppl:.3f} +- {err:.3f} (n={n})", flush=True)
    lines.append("")

    eng = load(paths["i8"])
    window = eng.cfg.max_seq_len
    long_ids = heldout[: window + window // 2].tolist()  # 1.5 windows: the ring wraps
    ppl_w, err_w, n_w = eng.perplexity(long_ids)
    lines += ["## Wrapped-context perplexity (sink + ring)", "",
              f"{len(long_ids)} held-out tokens through the {window}-token window (i8): "
              f"ppl **{ppl_w:.3f} +- {err_w:.3f}** over {n_w} tokens.", ""]
    print(f"wrapped ppl {ppl_w:.3f} +- {err_w:.3f}", flush=True)

    eng_mk = load(paths["i8"], kv_dtype=torch.float32, wcls_i8=True)
    eng_a8 = Engine(eng_mk.cfg, eng_mk.params, eng_mk.tokenizer, kv_dtype=torch.float32,
                    wcls_i8=True, a8_decode=True)
    ppl_mk, err_mk, _ = eng_mk.perplexity(long_ids)
    ppl_a8, err_a8, _ = eng_a8.perplexity(long_ids)
    lines += ["## int8-activation decode quality (`a8_decode`)", "",
              f"Decode path: {eng_mk.decode_path(1)}. bf16 activations: ppl {ppl_mk:.3f} +- "
              f"{err_mk:.3f}; int8 activations: ppl {ppl_a8:.3f} +- {err_a8:.3f} "
              f"(delta {ppl_a8 - ppl_mk:+.4f}).", ""]
    print(f"a8-decode ppl {ppl_a8:.3f} (delta {ppl_a8 - ppl_mk:+.4f})", flush=True)

    q4_lines = []
    for grp in (128, 256, 512):
        try:
            pq4 = recode_params_q4(eng_mk.params, group=grp)
        except ValueError as e:  # the group does not divide every half contraction
            q4_lines.append(f"- q4 group {grp}: not measurable here ({e})")
            continue
        eng_q4 = Engine(eng_mk.cfg, pq4, eng_mk.tokenizer, kv_dtype=torch.float32,
                        wcls_i8=True, a8_decode=True)
        ppl_q4, err_q4, _ = eng_q4.perplexity(long_ids)
        q4_lines.append(f"- q4 group {grp}: ppl {ppl_q4:.3f} +- {err_q4:.3f} "
                        f"(delta {ppl_q4 - ppl_mk:+.4f})")
        print(f"q4 g{grp} ppl {ppl_q4:.3f} (delta {ppl_q4 - ppl_mk:+.4f})", flush=True)
    lines += ["## q4 body quality", "",
              f"Wrapped decode-path ppl with the body packed to 4 bits, against {ppl_mk:.3f}:",
              "", *q4_lines, ""]

    tok = eng32.tokenizer
    random.seed(7)
    passkey = random.randint(1, 50000)
    pk_rows = []
    for pos, label in ((10, "early/evicted"), (30, "mid/in-window"), (38, "late/in-window")):
        ids = tok.encode(build_passkey_prompt(40, pos, passkey))
        out, _ = eng32.generate(ids, 16)
        text = tok.decode(out)
        pk_rows.append((pos, label, len(ids), str(passkey) in text, text))
        print(f"passkey pos {pos}/40 ({label}, {len(ids)} tok): "
              f"{'OK' if pk_rows[-1][3] else 'MISS'} -> {text!r}", flush=True)

    def copy_probe(filler_lines: int, lead_lines: int = 0):
        src = ("y = 0\n" * lead_lines + f"PASS_KEY = {passkey}\n" + "x = 1\n" * filler_lines
               + "print(PASS_KEY)\nPASS_KEY = ")
        cids = tok.encode(src)
        cout, _ = eng32.generate(cids, 8)
        text = tok.decode(cout)
        return str(passkey) in text, text, len(cids)

    copy_ok, copy_text, copy_n = copy_probe(60)
    wrap_ok, wrap_text, wrap_n = copy_probe(60, lead_lines=window // 2)
    lines += ["## Retrieval", "", f"Passkey prompts through the {window}-token window:", ""]
    lines += [f"- key at {p}/40 ({lb}, {n} tokens): {'**retrieved**' if ok else 'missed'} — "
              f"answer {t.strip()!r}" for p, lb, n, ok, t in pk_rows]
    lines += ["", f"- code copy probe ({copy_n} tokens): "
              f"{'**retrieved**' if copy_ok else 'missed'} — answer {copy_text.strip()!r}",
              f"- the same, wrapped ({wrap_n} tokens): "
              f"{'**retrieved**' if wrap_ok else 'missed'} — answer {wrap_text.strip()!r}", ""]

    sample_prompt = "def binary_search(arr, target):\n"
    sout, stats = eng32.generate(tok.encode(sample_prompt), 64)
    sample = tok.decode(sout)
    lines += ["## Greedy completion sample (f32)", "", "```python", sample_prompt + sample,
              "```", "", f"decode: {stats.tok_per_s:.1f} tok/s on {dev_name}", ""]
    print("sample:\n" + sample_prompt + sample, flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines))
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
