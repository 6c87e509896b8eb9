"""HF checkpoint -> .xalm converter (the port's counterpart of
``xalm_tpu/convert/convert.py``: the same container, byte for byte).

    python -m xalm_tpu_torch.convert.convert --input <hf_dir> [--output x.xalm]
        [--type f16|bf16|f32|f8_e4m3|f8_e5m2|q8|i8|q4|qi8|...|tq2_0]
        [--q4-group 128] [--analyze]
    python -m xalm_tpu_torch.convert.convert --input model.gguf ...

- ``--input <dir>``: an HF model directory (config.json, tokenizer.json,
  *.safetensors, read by ``io/safetensors.py``, the port's own reader), or a
  ``.gguf`` file (``gguf_container.import_gguf``).
- ``--type``: the body's dtype; every ``TARGET_TYPES`` entry: the runtime
  types, packed ``q4`` (``--q4-group``) and the simulated interchange
  formats (stored as the f16 values of their round trip).
- ``--analyze``: a per-tensor quantization-error table across every type.

Weights arrive as torch tensors (bf16 kept as torch's bf16, no
``ml_dtypes``) and are quantized by ``quant.py`` in numpy float32, the JAX
converter's arithmetic; bf16 and fp8 outputs are torch's round-to-nearest-
even casts, equal to ``ml_dtypes``' on every finite input. The container is
written with content hashes (``io/xxh3.py``), as the JAX converter writes
it. The converter downloads nothing: there is no ``--download``.

Carried over: the HF -> canonical name mapping, the q/k RoPE re-interleave
(``permute_reverse``), ``boost_type`` (embeddings and the head stay >=
16-bit for an 8-bit body, >= fp8 for a sub-byte one), 1-D tensors and the
MoE router kept bf16/f32, the tokenizer export (GPT-2 byte-unicode reversal
or sentencepiece ``▁`` -> space, NUL -> 0x07, NUL-joined into a U8
``tokenizer.tokens`` tensor), the canonical emission order, Phi-3's fused
qkv / gate_up split, Gemma-2's norm renames and q fold, and Gemma's (1 + w)
norm fold.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

import numpy as np
import torch

from xalm_tpu_torch import dtypes as xdt
from xalm_tpu_torch import quant
from xalm_tpu_torch.io import write_xalm
from xalm_tpu_torch.io.safetensors import read_safetensors
from xalm_tpu_torch.obs.table import Table

SUPPORTED_ARCHITECTURES = (
    "MistralForCausalLM",
    "LlamaForCausalLM",
    "GemmaForCausalLM",
    "Qwen2ForCausalLM",
    "MixtralForCausalLM",
    "Phi3ForCausalLM",
    "Gemma2ForCausalLM",
    "Qwen3ForCausalLM",
)

# dtypes a weight body may be converted to. Runtime types are stored as-is;
# the simulated interchange formats (GGUF blocks + sub-byte packers,
# reference convert.py:43-62 XType members) round-trip through the packed
# representation and store the dequantized f16 result — unlike the reference,
# everything the converter emits is loadable by the engine (SURVEY.md §2.3).
RUNTIME_TYPES = ("f32", "f16", "bf16", "f8_e4m3", "f8_e5m2", "q8", "i8", "q4")
TARGET_TYPES = RUNTIME_TYPES + quant.SIMULATED_TYPES


# ---------------------------------------------------------------------------
# Metadata normalization
# ---------------------------------------------------------------------------


def normalize_config(config: dict) -> tuple[str, dict[str, str]]:
    """HF config.json -> (arch, stringly-typed .xalm config dict)."""
    arch = config["architectures"][0]
    if arch not in SUPPORTED_ARCHITECTURES:
        raise ValueError(
            f"architecture {arch} is not supported, must be one of {SUPPORTED_ARCHITECTURES}"
        )
    head_dim = config.get("head_dim") or config["hidden_size"] // config["num_attention_heads"]
    act = config.get("hidden_activation") or config["hidden_act"]
    if act == "gelu_pytorch_tanh":
        act = "gelu"  # the runtime gelu IS the tanh approximation (llama.py)
    if act not in ("gelu", "silu"):
        raise ValueError(f"unsupported hidden_act {act}")
    out = {
        "dim": str(config["hidden_size"]),
        "hidden_dim": str(config["intermediate_size"]),
        "head_dim": str(head_dim),
        "n_layers": str(config["num_hidden_layers"]),
        "n_heads": str(config["num_attention_heads"]),
        "n_kv_heads": str(config.get("num_key_value_heads", config["num_attention_heads"])),
        "vocab_size": str(config["vocab_size"]),
        "max_seq_len": str(config["max_position_embeddings"]),
        "bos_token_id": str(config["bos_token_id"]),
        "eos_token_id": str(config["eos_token_id"]),
        "rope_theta": str(config.get("rope_theta", 10000.0)),
        "rotary_dim": str(int(head_dim * config.get("partial_rotary_factor", 1))),
        "norm_eps": str(config["rms_norm_eps"]),
        "norm_type": "rmsnorm",
        "act_type": str(act),
        "tie_word_embeddings": str(config["tie_word_embeddings"]),
    }
    if arch in ("GemmaForCausalLM", "Gemma2ForCausalLM"):
        # HF modeling_gemma scales the embed output by sqrt(hidden_size);
        # stored in the container so the runtime stays family-agnostic
        out["embed_scale"] = repr(float(config["hidden_size"]) ** 0.5)
    if arch == "Gemma2ForCausalLM":
        # alternating local/global attention collapses to ONE behavior when
        # the context never exceeds the sliding window — clamp the stored
        # max_seq_len so the equivalence holds (the runtime's 4k clamp
        # matches Gemma-2's 4k window anyway)
        out["max_seq_len"] = str(
            min(int(config["max_position_embeddings"]), int(config["sliding_window"]))
        )
        out["attn_softcap"] = repr(float(config["attn_logit_softcapping"] or 0))
        out["logit_softcap"] = repr(float(config["final_logit_softcapping"] or 0))
        out["post_norms"] = "True"
    if arch == "Qwen2ForCausalLM":
        # Qwen2 q/k/v projections carry bias vectors (HF modeling_qwen2)
        out["qkv_bias"] = "True"
    if arch == "Qwen3ForCausalLM":
        # Qwen3 dropped the bias but normalizes q/k per head before rope
        out["qk_norm"] = "True"
    if arch == "MixtralForCausalLM":
        out["n_experts"] = str(config["num_local_experts"])
        out["n_experts_active"] = str(config["num_experts_per_tok"])
    if arch == "Phi3ForCausalLM" and (config.get("rope_scaling") or {}).get(
        "type"
    ) in ("longrope", "su", "yarn"):
        raise ValueError("Phi-3 longrope/su/yarn rope scaling is not supported")
    rs = config.get("rope_scaling") or {}
    rtype = rs.get("rope_type") or rs.get("type")
    if rtype in ("linear", "llama3"):
        out["rope_scaling"] = rtype
        out["rope_factor"] = repr(float(rs["factor"]))
        if rtype == "llama3":
            out["rope_low_freq_factor"] = repr(float(rs["low_freq_factor"]))
            out["rope_high_freq_factor"] = repr(float(rs["high_freq_factor"]))
            out["rope_original_max_pos"] = str(
                int(rs["original_max_position_embeddings"])
            )
    elif rtype not in (None, "default"):
        raise ValueError(f"unsupported rope_scaling type {rtype}")
    return arch, out


# ---------------------------------------------------------------------------
# Weight-name mapping
# ---------------------------------------------------------------------------


def translate_name(name: str) -> str:
    if name == "model.embed_tokens.weight":
        return "embed.weight"
    if name == "model.norm.weight":
        return "output.norm.weight"
    if name == "lm_head.weight":
        return "output.weight"
    name = name.replace("model.layers.", "l.")
    name = name.replace(".self_attn.q_proj.", ".attn.q.")
    name = name.replace(".self_attn.k_proj.", ".attn.k.")
    name = name.replace(".self_attn.v_proj.", ".attn.v.")
    name = name.replace(".self_attn.o_proj.", ".attn.down.")
    name = name.replace(".self_attn.q_norm.", ".attn.qnorm.")
    name = name.replace(".self_attn.k_norm.", ".attn.knorm.")
    name = name.replace(".post_attention_layernorm.", ".mlp.norm.")
    name = name.replace(".input_layernorm.", ".attn.norm.")
    name = name.replace(".mlp.gate_proj.", ".mlp.gate.")
    name = name.replace(".mlp.down_proj.", ".mlp.down.")
    name = name.replace(".mlp.up_proj.", ".mlp.up.")
    # Mixtral sparse-MoE block (HF modeling_mixtral): router + experts
    name = name.replace(".block_sparse_moe.gate.", ".moe.gate.")
    name = re.sub(r"\.block_sparse_moe\.experts\.(\d+)\.w1\.", r".moe.\1.gate.", name)
    name = re.sub(r"\.block_sparse_moe\.experts\.(\d+)\.w3\.", r".moe.\1.up.", name)
    name = re.sub(r"\.block_sparse_moe\.experts\.(\d+)\.w2\.", r".moe.\1.down.", name)
    return name


def permute_reverse(w, heads: int, rotary_dim: int):
    """Undo HF's q/k RoPE permutation (a numpy array or a torch tensor, of
    the same kind out).

    HF stores q/k projections so that rotary pairs are (i, i + rotary/2)
    within each head; the runtime uses interleaved pairs (2i, 2i+1). This
    re-interleaves the first ``rotary_dim`` rows of every head.
    """
    if isinstance(w, np.ndarray):
        return permute_reverse(torch.from_numpy(w), heads, rotary_dim).numpy()
    head_dim = w.shape[0] // heads
    assert rotary_dim <= head_dim
    w = w.reshape(heads, head_dim, *w.shape[1:])
    wr = w[:, :rotary_dim]  # rotary part
    wk = w[:, rotary_dim:]  # non-rotated tail
    wr = wr.reshape(heads, 2, rotary_dim // 2, *w.shape[2:])
    wr = wr.swapaxes(1, 2).reshape(heads, rotary_dim, *w.shape[2:])
    return torch.cat([wr, wk], dim=1).reshape(heads * head_dim, *w.shape[2:])


def _bf16(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16


def boost_type(org_bf16: bool, target: str) -> str:
    """Keep embed/output at >=16-bit when the body is 8-bit and >=fp8 when
    the body is sub-byte; ``org_bf16``: the tensor arrived as bf16."""
    if target in ("qi4", "qi3", "f4_e2m1", "f6_e3m2", "q4_0", "q4_1", "q5_0", "q5_1", "tq1_0", "tq2_0"):
        # bf16-origin tensors boost to the wide-exponent fp8 (e5m2 covers the
        # bf16 exponent range); f16/f32 keep the e4m3 precision
        # (reference convert.py:729-744)
        if org_bf16:
            return "f8_e5m2"
        return "f8_e4m3"
    if target in ("f8_e4m3", "f8_e5m2", "q8", "i8", "qi8", "q8_0", "q4"):
        # q4 keeps the 16-bit boost (not the reference's fp8): the decode
        # megakernel's embed fold wants a bf16 table, and the head recodes
        # to i8 per-row at load (wcls_i8) — both quality-gated paths
        if org_bf16:
            return "bf16"
        return "f16"
    return target


# ---------------------------------------------------------------------------
# Tokenizer export
# ---------------------------------------------------------------------------


def gpt2_bytes_to_unicode() -> dict[int, str]:
    # The GPT-2 byte<->unicode table that poisons HF ByteLevel tokenizers;
    # needed to undo it (reference convert.py:326-336).
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def load_tokens(tokenizer_path: str, vocab_size: int) -> list[bytes]:
    with open(tokenizer_path) as f:
        tokenizer = json.load(f)
    use_gpt2_bytes = not tokenizer["model"].get("byte_fallback", False)

    tokens: list[str] = [""] * vocab_size
    vocab = tokenizer["model"]["vocab"]
    assert len(vocab) <= vocab_size
    for t, i in vocab.items():
        tokens[i] = t
    for added in tokenizer.get("added_tokens", []):
        tokens[added["id"]] = added["content"]

    gpt2_decode = {v: k for k, v in gpt2_bytes_to_unicode().items()}
    out: list[bytes] = []
    for t in tokens:
        if use_gpt2_bytes:
            b = bytes([gpt2_decode.get(c, 0) for c in t])
        else:
            b = t.replace("▁", " ").encode("utf-8")
        b = b.replace(b"\x00", b"\x07")  # container is NUL-delimited
        out.append(b)
    return out


def tokens_tensor(tokens: list[bytes]) -> np.ndarray:
    blob = b"\x00".join(tokens) + b"\x00"
    return np.frombuffer(blob, dtype=np.uint8).copy()


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------


def _read_safetensors(files: list[str]) -> dict[str, torch.Tensor]:
    weights: dict[str, torch.Tensor] = {}
    for path in files:
        for k, t in read_safetensors(path).items():
            if k in weights:
                raise ValueError(f"duplicate tensor {k}")
            weights[k] = t
    return weights


def canonical_order(n_layers: int, tied: bool, qkv_bias: bool = False,
                    n_experts: int = 0, post_norms: bool = False,
                    qk_norm: bool = False) -> list[str]:
    """Fixed on-disk emission order (reference convert.py:825-848, 1057-1108).
    ``qkv_bias`` appends the Qwen2-family attention bias vectors;
    ``n_experts`` swaps the dense mlp tensors for the MoE router+experts."""
    names = ["embed.weight"]
    for i in range(n_layers):
        names += [
            f"l.{i}.attn.norm.weight",
            f"l.{i}.attn.q.weight",
            f"l.{i}.attn.k.weight",
            f"l.{i}.attn.v.weight",
        ]
        if qkv_bias:
            names += [
                f"l.{i}.attn.q.bias",
                f"l.{i}.attn.k.bias",
                f"l.{i}.attn.v.bias",
            ]
        names += [
            f"l.{i}.attn.down.weight",
        ]
        if post_norms:
            names.append(f"l.{i}.attn.postnorm.weight")
        if qk_norm:
            names += [f"l.{i}.attn.qnorm.weight", f"l.{i}.attn.knorm.weight"]
        names.append(f"l.{i}.mlp.norm.weight")
        if n_experts:
            names.append(f"l.{i}.moe.gate.weight")
            for e in range(n_experts):
                names += [
                    f"l.{i}.moe.{e}.gate.weight",
                    f"l.{i}.moe.{e}.down.weight",
                    f"l.{i}.moe.{e}.up.weight",
                ]
        else:
            names += [
                f"l.{i}.mlp.gate.weight",
                f"l.{i}.mlp.down.weight",
                f"l.{i}.mlp.up.weight",
            ]
        if post_norms:
            names.append(f"l.{i}.mlp.postnorm.weight")
    if not tied:
        names.append("output.weight")
    names.append("output.norm.weight")
    return names


def convert_weights(
    weights: dict,
    arch_config: dict[str, str],
    target_type: str,
    analyze: bool = False,
    q4_group: int = 128,
) -> dict[str, np.ndarray]:
    """Translate names, fix RoPE layout, quantize; returns container tensors
    (numpy arrays, torch tensors for bf16 and fp8). ``weights``: torch
    tensors or numpy arrays by HF (or GGUF-import canonical) name."""
    n_heads = int(arch_config["n_heads"])
    n_kv_heads = int(arch_config["n_kv_heads"])
    rotary_dim = int(arch_config["rotary_dim"])
    n_layers = int(arch_config["n_layers"])
    tied = arch_config["tie_word_embeddings"] == "True"

    translated = {translate_name(k): v for k, v in weights.items()}
    out: dict[str, np.ndarray] = {}
    qkv_bias = arch_config.get("qkv_bias") == "True"
    order = canonical_order(
        n_layers, tied, qkv_bias, int(arch_config.get("n_experts", "0")),
        arch_config.get("post_norms") == "True",
        arch_config.get("qk_norm") == "True",
    )
    missing = [n for n in order if n not in translated]
    if missing:
        raise ValueError(f"missing tensors in checkpoint: {missing[:5]}...")

    # GGUF imports arrive already interleaved (gguf_container.import_gguf)
    interleaved = arch_config.get("rope_interleaved") == "True"
    analyze_rows: list[dict] = []
    for name in order:
        t = translated[name]
        # rope re-interleave applies to anything with per-output-row layout:
        # q/k projections AND their bias vectors (Qwen2)
        if interleaved:
            pass
        elif ".attn.q." in name:
            t = permute_reverse(t, n_heads, rotary_dim)
        elif ".attn.k." in name:
            t = permute_reverse(t, n_kv_heads, rotary_dim)
        elif ".attn.qnorm." in name or ".attn.knorm." in name:
            # per-head (head_dim,) qk-norm weights (Qwen3) must carry the
            # same in-head permutation as the rows they scale; the RMS
            # reduction itself is permutation-invariant
            t = permute_reverse(t, 1, rotary_dim)

        if t.ndim == 1 or ".moe.gate." in name:
            # norm weights (and the MoE router, whose precision gates expert
            # selection) stay high precision (reference convert.py:770-774)
            actual = "bf16" if _bf16(t) else "f32"
        elif name in ("embed.weight", "output.weight"):
            actual = boost_type(_bf16(t), target_type)
        else:
            actual = target_type
            if target_type == "q4" and (
                t.ndim != 2 or ".moe." in name
                or t.shape[-1] % (2 * q4_group)
            ):
                # q4 is the dense-body runtime format; experts and
                # group-unaligned tensors keep per-row i8
                actual = "i8"

        if actual == "q4":
            packed, sc = quant.quantize_q4_rows(t, q4_group)
            out[name] = packed
            out[name + ".scale4"] = sc
            continue

        if analyze and t.ndim > 1:
            tf = quant.as_f32(t)
            # q4's per-(row, group) scales don't fit the scalar scale sweep
            # (its error is gated end-to-end in RESULTS.md instead)
            for cand in [c for c in TARGET_TYPES[1:] if c != "q4"]:
                # per-type scale sweep (reference convert.py:776-798)
                for sc in quant.analyze_scales(tf, cand):
                    m = quant.analyze(tf, cand, sc)
                    m["tensor"] = name
                    analyze_rows.append(m)

        q = quant.quantize(t, actual)
        out[name] = q.values
        if q.scale is not None:
            out[xdt.scale_name(name)] = q.scale

    if analyze and analyze_rows:
        tbl = Table(["tensor"] + quant.ANALYZE_COLUMNS)
        for m in analyze_rows:
            tbl.add(
                m["tensor"], m["type"], m["scale"], f"{m['mse']:.3e}",
                f"{m['norm_err']:.4f}", f"{m['cosine']:.5f}", f"{m['snr_db']:.1f}",
                f"{m['exact_%']:.1f}", m["bytes"],
            )
        print(tbl.format(title="quantization error analysis"))

    return out


def process_input(input_dir: str) -> tuple[dict, str, list[str]]:
    """Locate config/tokenizer/shards in an HF model dir."""
    config_path = os.path.join(input_dir, "config.json")
    tokenizer_path = os.path.join(input_dir, "tokenizer.json")
    if not os.path.exists(config_path):
        raise FileNotFoundError(config_path)
    if not os.path.exists(tokenizer_path):
        raise FileNotFoundError(tokenizer_path)
    with open(config_path) as f:
        config = json.load(f)
    shards = sorted(glob.glob(os.path.join(input_dir, "*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no .safetensors files in {input_dir}")
    return config, tokenizer_path, shards


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="xalm-torch-convert", description="Convert HF checkpoints to .xalm containers"
    )
    p.add_argument("--input", required=True, help="HF model directory, or a .gguf file")
    p.add_argument("--output", help="output .xalm path (default: <input>.xalm)")
    p.add_argument("--type", default="f16", choices=TARGET_TYPES, help="target weight dtype")
    p.add_argument("--analyze", action="store_true", help="report quantization error per tensor")
    p.add_argument("--q4-group", type=int, default=128,
                   help="q4: weights per scale group along the contraction "
                   "(128-multiple; runtime-streamable packed 4-bit)")
    args = p.parse_args(argv)

    input_dir = args.input

    if input_dir and input_dir.endswith(".gguf"):
        # GGUF import: dequantize through the golden-pinned block codecs,
        # then the standard quantize/write pipeline (no rope re-permute —
        # gguf q/k are already interleaved)
        from xalm_tpu_torch.convert.gguf_container import import_gguf

        arch, arch_config, weights, toks = import_gguf(input_dir)
        print(
            f"arch={arch} (from gguf) layers={arch_config['n_layers']} "
            f"dim={arch_config['dim']} target={args.type}"
        )
        tensors = convert_weights(weights, arch_config, args.type, analyze=args.analyze, q4_group=args.q4_group)
        if toks is not None:
            tensors["tokenizer.tokens"] = tokens_tensor(toks)
        out_path = args.output or (input_dir[: -len(".gguf")] + ".xalm")
        write_xalm(out_path, arch, arch_config, tensors, compute_hashes=True)
        print(f"wrote {out_path} ({os.path.getsize(out_path) / 1e9:.2f} GB, {len(tensors)} tensors)")
        return 0

    config, tokenizer_path, shards = process_input(input_dir)
    arch, arch_config = normalize_config(config)
    tc_path = os.path.join(input_dir, "tokenizer_config.json")
    if os.path.exists(tc_path):
        with open(tc_path) as f:
            tc = json.load(f)
        if isinstance(tc.get("chat_template"), str):
            # carried for the serving front end's /v1/chat/completions
            # (stringly container config; the runtime ignores it otherwise)
            arch_config["chat_template"] = tc["chat_template"]
    print(f"arch={arch} layers={arch_config['n_layers']} dim={arch_config['dim']} target={args.type}")

    weights = _read_safetensors(shards)
    if arch == "Phi3ForCausalLM":
        # Phi-3 stores qkv and gate/up FUSED (modeling_phi3: qkv_proj rows
        # [q | k | v], gate_up_proj rows [gate | up]); split them into the
        # canonical separate tensors the container keeps
        q_dim = int(arch_config["n_heads"]) * int(arch_config["head_dim"])
        kv_dim = int(arch_config["n_kv_heads"]) * int(arch_config["head_dim"])
        h = int(arch_config["hidden_dim"])
        for k in list(weights):
            if k.endswith(".self_attn.qkv_proj.weight"):
                w = weights.pop(k)
                base = k[: -len("qkv_proj.weight")]
                weights[base + "q_proj.weight"] = w[:q_dim]
                weights[base + "k_proj.weight"] = w[q_dim : q_dim + kv_dim]
                weights[base + "v_proj.weight"] = w[q_dim + kv_dim :]
            elif k.endswith(".mlp.gate_up_proj.weight"):
                w = weights.pop(k)
                base = k[: -len("gate_up_proj.weight")]
                weights[base + "gate_proj.weight"] = w[:h]
                weights[base + "up_proj.weight"] = w[h:]
    if arch == "Gemma2ForCausalLM":
        # Gemma-2's four per-layer norms map onto [attn.norm, attn.postnorm,
        # mlp.norm, mlp.postnorm]: rename BEFORE translate_name so the
        # generic post_attention_layernorm -> mlp.norm rule doesn't misfile
        # the post-ATTENTION norm (in Gemma-2 the mlp norm is
        # pre_feedforward_layernorm). Also fold query_pre_attn_scalar into
        # the q weights: attention computes q.k/sqrt(hd), Gemma-2 wants
        # q.k/sqrt(qpas) -> scale q rows by sqrt(hd)/sqrt(qpas) (exact,
        # commutes with the linear rope permute).
        qpas = float(config["query_pre_attn_scalar"])
        hd = float(config.get("head_dim") or config["hidden_size"] // config["num_attention_heads"])
        qfold = np.float32((hd ** 0.5) / (qpas ** 0.5))
        renames = {
            ".post_attention_layernorm.": ".attn.postnorm.",
            ".pre_feedforward_layernorm.": ".mlp.norm.",
            ".post_feedforward_layernorm.": ".mlp.postnorm.",
        }
        for k in list(weights):
            if ".self_attn.q_proj." in k:
                weights[k] = torch.from_numpy(quant.as_f32(weights[k]) * qfold)
            for old, new in renames.items():
                if old in k:
                    weights[k.replace(old, new)] = weights.pop(k)
                    break
    if arch in ("GemmaForCausalLM", "Gemma2ForCausalLM"):
        # GemmaRMSNorm scales by (1 + weight): fold the offset into the
        # stored norm weights so the runtime's plain rmsnorm serves every
        # family (norm weights stay f32 in the container, so this is exact)
        for k in list(weights):
            if k.endswith("norm.weight"):
                weights[k] = torch.from_numpy(quant.as_f32(weights[k]) + 1.0)
    tensors = convert_weights(weights, arch_config, args.type, analyze=args.analyze, q4_group=args.q4_group)
    toks = load_tokens(tokenizer_path, int(arch_config["vocab_size"]))
    tensors["tokenizer.tokens"] = tokens_tensor(toks)

    out_path = args.output or (input_dir.rstrip("/") + ".xalm")
    write_xalm(out_path, arch, arch_config, tensors, compute_hashes=True)
    size = os.path.getsize(out_path)
    print(f"wrote {out_path} ({size / 1e9:.2f} GB, {len(tensors)} tensors)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
