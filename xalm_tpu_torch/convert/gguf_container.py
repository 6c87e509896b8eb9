"""GGUF container I/O: import .gguf checkpoints, export .xalm to .gguf (the
port's counterpart of ``xalm_tpu/convert/gguf_container.py``, the same
bytes both ways).

The GGUF v3 container (header, typed metadata KV, tensor directory, aligned
data section) over the block codecs of ``xalm_tpu_torch/gguf.py``, plus the
llama-arch name and config crosswalk:
- tensor dims are stored innermost-first (``ne[0]`` = row length), the
  reverse of the numpy shape; bytes are plain row-major;
- llama-arch q/k projections are stored in the interleaved rotary layout,
  the runtime's, so no rope re-permute happens in either direction
  (``rope_interleaved`` on import);
- tokenizer.ggml.tokens carries sentencepiece-style pieces (``▁`` for
  space, ``<0xNN>`` byte fallback), the conventions of the .xalm tokens
  tensor after the ``▁`` -> space swap.

    python -m xalm_tpu_torch.convert.gguf_container model.xalm model.gguf [--type q8_0]
"""

from __future__ import annotations

import struct

import numpy as np

from xalm_tpu_torch import gguf as codecs

__all__ = ["read_gguf", "write_gguf", "import_gguf", "export_xalm_to_gguf"]

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
_DEFAULT_ALIGN = 32

# ggml_type id <-> codec name (ids from ggml.h)
GGML_TYPES = {
    0: "f32", 1: "f16", 2: "q4_0", 3: "q4_1", 6: "q5_0", 7: "q5_1",
    8: "q8_0", 10: "q2_k", 11: "q3_k", 12: "q4_k", 13: "q5_k", 14: "q6_k",
    16: "iq2_xxs", 17: "iq2_xs", 18: "iq3_xxs", 19: "iq1_s", 20: "iq4_nl",
    21: "iq3_s", 22: "iq2_s", 23: "iq4_xs", 29: "iq1_m", 30: "bf16",
    34: "tq1_0", 35: "tq2_0",
}
GGML_IDS = {v: k for k, v in GGML_TYPES.items()}

# metadata value type ids
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 = range(13)
_SCALAR_FMT = {
    _U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I", _I32: "<i",
    _F32: "<f", _U64: "<Q", _I64: "<q", _F64: "<d",
}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def read(self, fmt: str):
        try:
            v = struct.unpack_from(fmt, self.buf, self.off)[0]
        except struct.error as e:
            raise ValueError(f"truncated GGUF header at offset {self.off}") from e
        self.off += struct.calcsize(fmt)
        return v

    def read_str(self) -> str:
        n = self.read("<Q")
        if n > len(self.buf) - self.off:
            raise ValueError(
                f"GGUF string of {n} bytes overruns the file at offset {self.off}"
            )
        s = bytes(self.buf[self.off : self.off + n])
        self.off += n
        return s.decode("utf-8", "replace")

    def read_value(self, t: int):
        if t in _SCALAR_FMT:
            return self.read(_SCALAR_FMT[t])
        if t == _BOOL:
            return bool(self.read("<B"))
        if t == _STR:
            return self.read_str()
        if t == _ARR:
            et = self.read("<I")
            n = self.read("<Q")
            if n > len(self.buf):  # cheap sanity: can't have more elems than bytes
                raise ValueError(f"GGUF array length {n} exceeds file size")
            return [self.read_value(et) for _ in range(n)]
        raise ValueError(f"unknown GGUF metadata type {t}")


def read_gguf(path: str):
    """Parse a .gguf file -> (metadata dict, tensors dict).

    tensors: name -> (codec_name, shape (numpy order), raw uint8 bytes).
    Uses a memory-map so large files aren't copied up front."""
    buf = np.memmap(path, dtype=np.uint8, mode="r")
    r = _Reader(memoryview(buf))
    if bytes(r.buf[:4]) != GGUF_MAGIC:
        raise ValueError(f"{path}: not a GGUF file")
    r.off = 4
    version = r.read("<I")
    if version not in (2, 3):
        raise ValueError(f"{path}: unsupported GGUF version {version}")
    n_tensors = r.read("<Q")
    n_kv = r.read("<Q")
    md = {}
    for _ in range(n_kv):
        k = r.read_str()
        t = r.read("<I")
        md[k] = r.read_value(t)
    infos = []
    for _ in range(n_tensors):
        name = r.read_str()
        nd = r.read("<I")
        ne = [r.read("<Q") for _ in range(nd)]
        tid = r.read("<I")
        off = r.read("<Q")
        if tid not in GGML_TYPES:
            raise ValueError(f"{path}: tensor {name}: unsupported ggml type {tid}")
        infos.append((name, ne, GGML_TYPES[tid], off))
    align = int(md.get("general.alignment", _DEFAULT_ALIGN))
    data0 = (r.off + align - 1) // align * align
    tensors = {}
    for name, ne, cname, off in infos:
        shape = tuple(reversed(ne))  # ne[0] is innermost
        n_elems = int(np.prod(shape)) if shape else 1
        nbytes = codecs.quant_byte_size(n_elems, cname)
        start = data0 + off
        if start + nbytes > buf.size:
            raise ValueError(
                f"{path}: tensor {name} ({cname} {shape}) overruns the file: "
                f"needs [{start}, {start + nbytes}) of {buf.size} bytes"
            )
        raw = np.asarray(buf[start : start + nbytes])
        tensors[name] = (cname, shape, raw)
    return md, tensors


def _write_str(out: list[bytes], s: str) -> None:
    b = s.encode("utf-8")
    out.append(struct.pack("<Q", len(b)))
    out.append(b)


def _write_value(out: list[bytes], v) -> None:
    """Typed KV value with the type tag (narrow int types are not
    round-tripped — ints write as int64, floats as f32, which llama.cpp
    accepts for every key we emit)."""
    if isinstance(v, bool):
        out.append(struct.pack("<I", _BOOL))
        out.append(struct.pack("<B", int(v)))
    elif isinstance(v, int):
        out.append(struct.pack("<I", _I64 if v < 0 else _U64))
        out.append(struct.pack("<q" if v < 0 else "<Q", v))
    elif isinstance(v, float):
        out.append(struct.pack("<I", _F32))
        out.append(struct.pack("<f", v))
    elif isinstance(v, str):
        out.append(struct.pack("<I", _STR))
        _write_str(out, v)
    elif isinstance(v, (list, tuple)):
        out.append(struct.pack("<I", _ARR))
        if not v:
            out.append(struct.pack("<IQ", _STR, 0))
            return
        e = v[0]
        if isinstance(e, str):
            out.append(struct.pack("<IQ", _STR, len(v)))
            for s in v:
                _write_str(out, s)
        elif isinstance(e, bool):
            out.append(struct.pack("<IQ", _BOOL, len(v)))
            out.append(struct.pack(f"<{len(v)}B", *[int(x) for x in v]))
        elif isinstance(e, int):
            out.append(struct.pack("<IQ", _I64, len(v)))
            out.append(struct.pack(f"<{len(v)}q", *v))
        elif isinstance(e, float):
            out.append(struct.pack("<IQ", _F32, len(v)))
            out.append(struct.pack(f"<{len(v)}f", *v))
        else:
            raise TypeError(f"unsupported GGUF array element {type(e)}")
    else:
        raise TypeError(f"unsupported GGUF metadata value {type(v)}")


def write_gguf(path: str, metadata: dict, tensors: dict) -> None:
    """Write a GGUF v3 file. tensors: name -> (codec_name, shape, raw bytes)."""
    align = int(metadata.get("general.alignment", _DEFAULT_ALIGN))
    head: list[bytes] = [GGUF_MAGIC, struct.pack("<IQQ", GGUF_VERSION, len(tensors), len(metadata))]
    for k, v in metadata.items():
        _write_str(head, k)
        _write_value(head, v)
    off = 0
    data_parts = []
    for name, (cname, shape, raw) in tensors.items():
        _write_str(head, name)
        ne = list(reversed(shape))
        head.append(struct.pack("<I", len(ne)))
        head.append(struct.pack(f"<{len(ne)}Q", *ne))
        head.append(struct.pack("<I", GGML_IDS[cname]))
        head.append(struct.pack("<Q", off))
        raw = np.ascontiguousarray(raw, np.uint8)
        pad = (-raw.nbytes) % align
        data_parts.append(raw.tobytes() + b"\x00" * pad)
        off += raw.nbytes + pad
    blob = b"".join(head)
    blob += b"\x00" * ((-len(blob)) % align)
    with open(path, "wb") as f:
        f.write(blob)
        for p in data_parts:
            f.write(p)


# ---------------------------------------------------------------------------
# llama-arch crosswalk
# ---------------------------------------------------------------------------

_NAME_TO_CANON = {
    "token_embd.weight": "embed.weight",
    "output_norm.weight": "output.norm.weight",
    "output.weight": "output.weight",
}
_BLK = {
    "attn_norm.weight": "attn.norm.weight",
    "attn_q.weight": "attn.q.weight",
    "attn_k.weight": "attn.k.weight",
    "attn_v.weight": "attn.v.weight",
    "attn_q.bias": "attn.q.bias",
    "attn_k.bias": "attn.k.bias",
    "attn_v.bias": "attn.v.bias",
    "attn_output.weight": "attn.down.weight",
    "ffn_norm.weight": "mlp.norm.weight",
    "ffn_gate.weight": "mlp.gate.weight",
    "ffn_up.weight": "mlp.up.weight",
    "ffn_down.weight": "mlp.down.weight",
}
_CANON_TO_GG = {v: k for k, v in _NAME_TO_CANON.items()}
_CANON_BLK = {v: k for k, v in _BLK.items()}


def _gg_name_to_canon(name: str) -> str | None:
    if name in _NAME_TO_CANON:
        return _NAME_TO_CANON[name]
    if name.startswith("blk."):
        _, i, rest = name.split(".", 2)
        mapped = _BLK.get(rest)
        if mapped:
            return f"l.{i}.{mapped}"
    return None


def import_gguf(path: str):
    """Read a llama-arch .gguf -> (arch, arch_config, weights (canonical
    names, f32), tokens list[bytes]) ready for the .xalm writer.

    Weights come back dequantized to f32 in the runtime's interleaved
    rotary layout (``rope_interleaved`` set so convert_weights skips the
    HF re-permute)."""
    md, tensors = read_gguf(path)
    g_arch = md.get("general.architecture")
    if g_arch not in ("llama", "mistral"):
        raise ValueError(f"{path}: unsupported GGUF architecture {g_arch!r}")
    p = g_arch

    def key(name, default=None):
        v = md.get(f"{p}.{name}", default)
        if v is None:
            raise ValueError(f"{path}: missing metadata {p}.{name}")
        return v

    n_heads = int(key("attention.head_count"))
    embd = int(key("embedding_length"))
    head_dim = int(md.get(f"{p}.attention.key_length", embd // n_heads))
    tied = "output.weight" not in tensors
    arch_config = {
        "dim": str(embd),
        "hidden_dim": str(int(key("feed_forward_length"))),
        "head_dim": str(head_dim),
        "n_layers": str(int(key("block_count"))),
        "n_heads": str(n_heads),
        "n_kv_heads": str(int(key("attention.head_count_kv", n_heads))),
        "vocab_size": str(int(md.get(f"{p}.vocab_size",
                                     len(md.get("tokenizer.ggml.tokens", []))))),
        "max_seq_len": str(int(key("context_length"))),
        "bos_token_id": str(int(md.get("tokenizer.ggml.bos_token_id", 1))),
        "eos_token_id": str(int(md.get("tokenizer.ggml.eos_token_id", 2))),
        "rope_theta": str(float(md.get(f"{p}.rope.freq_base", 10000.0))),
        "rotary_dim": str(int(md.get(f"{p}.rope.dimension_count", head_dim))),
        "norm_eps": str(float(key("attention.layer_norm_rms_epsilon", 1e-5))),
        "norm_type": "rmsnorm",
        "act_type": "silu",
        "tie_word_embeddings": str(tied),
        "rope_interleaved": "True",  # gguf q/k are already interleaved
    }
    weights = {}
    for name, (cname, shape, raw) in tensors.items():
        canon = _gg_name_to_canon(name)
        if canon is None:
            continue  # rope_freqs etc: runtime recomputes them
        weights[canon] = codecs.dequantize(np.asarray(raw), cname, shape)
    if any(k.endswith("attn.q.bias") for k in weights):
        arch_config["qkv_bias"] = "True"
    toks = md.get("tokenizer.ggml.tokens")
    tokens = None
    if toks:
        tokens = [
            t.replace("▁", " ").encode("utf-8").replace(b"\x00", b"\x07")
            for t in toks
        ]
    arch = "MistralForCausalLM"  # llama-family runtime arch
    return arch, arch_config, weights, tokens


def export_xalm_to_gguf(xalm_path: str, out_path: str, gtype: str = "q8_0") -> None:
    """Export a .xalm container to .gguf (body tensors in ``gtype``;
    norms f32, embed/head f16)."""
    from xalm_tpu_torch import quant
    from xalm_tpu_torch.io.container import XalmFile

    xf = XalmFile(xalm_path)
    cfg = xf.config
    n_layers = int(cfg["n_layers"])
    md = {
        "general.architecture": "llama",
        "general.name": xalm_path.rsplit("/", 1)[-1],
        "llama.block_count": n_layers,
        "llama.context_length": int(cfg["max_seq_len"]),
        "llama.embedding_length": int(cfg["dim"]),
        "llama.feed_forward_length": int(cfg["hidden_dim"]),
        "llama.attention.head_count": int(cfg["n_heads"]),
        "llama.attention.head_count_kv": int(cfg["n_kv_heads"]),
        "llama.attention.key_length": int(cfg["head_dim"]),
        "llama.attention.value_length": int(cfg["head_dim"]),
        "llama.attention.layer_norm_rms_epsilon": float(cfg["norm_eps"]),
        "llama.rope.freq_base": float(cfg["rope_theta"]),
        "llama.rope.dimension_count": int(cfg["rotary_dim"]),
        "llama.vocab_size": int(cfg["vocab_size"]),
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.bos_token_id": int(cfg.get("bos_token_id", 1)),
        "tokenizer.ggml.eos_token_id": int(cfg.get("eos_token_id", 2)),
    }
    if "tokenizer.tokens" in xf:
        blob = bytes(xf.load("tokenizer.tokens"))
        pieces = blob.split(b"\x00")[: int(cfg["vocab_size"])]
        md["tokenizer.ggml.tokens"] = [
            p.decode("utf-8", "replace").replace(" ", "▁") for p in pieces
        ]

    tied = cfg.get("tie_word_embeddings") == "True"
    order = ["embed.weight"]
    for i in range(n_layers):
        for suffix in _CANON_BLK:
            name = f"l.{i}.{suffix}"
            if name.endswith(".bias") and name not in xf.tensors:
                continue
            order.append(name)
    if not tied:
        order.append("output.weight")
    order.append("output.norm.weight")

    from xalm_tpu_torch import dtypes as xdt

    def load_f32(name: str) -> np.ndarray:
        info = xf.tensors[name]
        vals = np.asarray(xf.load(name))
        sname = xdt.scale_name(name)
        scale = np.asarray(xf.load(sname)) if sname in xf else None
        return quant.dequantize(vals, info.dtype.name, scale)

    tensors = {}
    for name in order:
        if name not in xf.tensors:
            raise ValueError(f"{xalm_path}: missing tensor {name}")
        f32 = load_f32(name).astype(np.float32)
        if f32.ndim == 1:
            t = "f32"
        elif name in ("embed.weight", "output.weight"):
            t = "f16"
        else:
            t = gtype
        raw = codecs.quantize(f32, t)
        if name in _CANON_TO_GG:
            gname = _CANON_TO_GG[name]
        else:
            _, i, rest = name.split(".", 2)
            gname = f"blk.{i}.{_CANON_BLK[rest]}"
        tensors[gname] = (t, f32.shape, raw)
    xf.close()
    write_gguf(out_path, md, tensors)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="xalm-gguf",
        description="Export a .xalm container to GGUF "
                    "(import goes through xalm_tpu_torch.convert.convert --input x.gguf)",
    )
    ap.add_argument("xalm", help="input .xalm container")
    ap.add_argument("gguf", help="output .gguf path")
    ap.add_argument("--type", default="q8_0",
                    choices=[n for n, c in codecs.CODECS.items() if c.quant]
                    + ["f32", "f16"],
                    help="gguf block type for the body tensors")
    args = ap.parse_args(argv)
    export_xalm_to_gguf(args.xalm, args.gguf, args.type)
    import os

    print(f"wrote {args.gguf} ({os.path.getsize(args.gguf) / 1e9:.2f} GB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
