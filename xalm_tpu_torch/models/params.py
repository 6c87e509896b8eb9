"""Weights as torch tensors and .xalm loading (counterpart of
``xalm_tpu/models/params.py``).

Layers are stacked along a leading L axis, in the same fused device layouts
as the JAX package, so every intermediate can be compared with it:

- ``wqkv`` (L, KH*(G+2)*hd, dim): per kv-head group j the rows are
  [q rows of group j | k row-block j | v row-block j].
- ``w13`` (L, 2*hidden, dim): gate/up interleaved in ``ffn_chunk``-row
  chunks [gate_c0 | up_c0 | gate_c1 | ...].

Quantization rides the dtype plus an optional per-output-row f32 ``scale``:
float weights dequantize by a cast, int8 with ``scale`` is `i8`
(y = (x @ W^T) * scale), int8 without it is `q8` (fixed scale 1/100).
``recode_wcls_i8`` re-codes a float head to i8 per row. Packed q4, fp8, MoE
and family extras are later slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from xalm_tpu_torch import dtypes as xdt
from xalm_tpu_torch.models.config import ModelConfig

__all__ = [
    "QWeight",
    "LayerParams",
    "ModelParams",
    "load_params",
    "from_jax_params",
    "recode_wcls_i8",
    "Q8_FIXED_SCALE",
    "ffn_chunk",
    "fuse_qkv",
    "fuse_w13",
    "split_qkv_rows",
    "split_w13_rows",
]

Q8_FIXED_SCALE = 1.0 / 100.0


def ffn_chunk(hidden_dim: int) -> int:
    """Interleave chunk of the fused gate/up weight: the largest power of
    two <= 128 dividing the hidden dim into a multiple-of-8 chunk count
    (Mistral's 14336 -> 128-row chunks, 112 of them)."""
    c = 128
    while c > 1 and (hidden_dim % c != 0 or (hidden_dim // c) % 8 != 0):
        c //= 2
    return c


@dataclasses.dataclass
class QWeight:
    """A weight matrix of logical shape (..., D, N); ``scale`` is a per-row
    f32 tensor of shape (..., D) for `i8`, else None."""

    values: torch.Tensor
    scale: torch.Tensor | None = None

    @property
    def shape(self):
        return self.values.shape

    def nbytes(self) -> int:
        n = self.values.nelement() * self.values.element_size()
        if self.scale is not None:
            n += self.scale.nelement() * self.scale.element_size()
        return n


@dataclasses.dataclass
class LayerParams:
    """Per-layer weights of the dense Llama/Mistral block, stacked (L, ...)."""

    attn_norm: torch.Tensor  # (L, dim) f32
    wqkv: QWeight  # (L, kh*(g+2)*hd, dim)
    wo: QWeight  # (L, dim, q_dim)
    mlp_norm: torch.Tensor  # (L, dim) f32
    w13: QWeight  # (L, 2*hidden, dim)
    w2: QWeight  # (L, dim, hidden)


@dataclasses.dataclass
class ModelParams:
    embed: QWeight  # (vocab, dim)
    layers: LayerParams
    out_norm: torch.Tensor  # (dim,) f32
    wcls: QWeight  # (vocab, dim); the same object as embed when tied

    def nbytes(self) -> int:
        lp = self.layers
        n = sum(w.nbytes() for w in (self.embed, lp.wqkv, lp.wo, lp.w13, lp.w2))
        if self.wcls is not self.embed:
            n += self.wcls.nbytes()
        for t in (lp.attn_norm, lp.mlp_norm, self.out_norm):
            n += t.nelement() * 4
        return n


def _fuse_rows(parts: list[np.ndarray]) -> np.ndarray:
    return np.ascontiguousarray(np.concatenate(parts, axis=2)).reshape(
        parts[0].shape[0], -1, *parts[0].shape[3:]
    )


def fuse_qkv(wq: np.ndarray, wk: np.ndarray, wv: np.ndarray, kh: int) -> np.ndarray:
    """(L, q_dim, d) + 2x (L, kv_dim, d) -> (L, kh*(g+2)*hd, d) grouped by kv
    head; also fuses (L, rows) scale planes."""
    l = wq.shape[0]
    tail = wq.shape[2:]
    return _fuse_rows([w.reshape(l, kh, -1, *tail) for w in (wq, wk, wv)])


def split_qkv_rows(y: torch.Tensor, kh: int, g: int, hd: int):
    """Inverse of fuse_qkv on the output side: y (..., kh*(g+2)*hd) ->
    (q (..., kh*g*hd), k (..., kh*hd), v (..., kh*hd)); kh=-1 infers it."""
    lead = y.shape[:-1]
    y4 = y.reshape(*lead, kh, g + 2, hd)
    q = y4[..., :g, :].reshape(*lead, -1)
    k = y4[..., g, :].reshape(*lead, -1)
    v = y4[..., g + 1, :].reshape(*lead, -1)
    return q, k, v


def fuse_w13(w1: np.ndarray, w3: np.ndarray, chunk: int) -> np.ndarray:
    """(L, hidden, d) x2 -> (L, 2*hidden, d), chunk-interleaved."""
    l = w1.shape[0]
    tail = w1.shape[2:]
    a = w1.reshape(l, -1, 1, chunk, *tail)
    b = w3.reshape(l, -1, 1, chunk, *tail)
    return np.ascontiguousarray(np.concatenate([a, b], axis=2)).reshape(l, -1, *tail)


def split_w13_rows(y: torch.Tensor, chunk: int):
    """y (..., 2*hidden) -> (gate (..., hidden), up (..., hidden))."""
    lead = y.shape[:-1]
    y4 = y.reshape(*lead, -1, 2, chunk)
    return y4[..., 0, :].reshape(*lead, -1), y4[..., 1, :].reshape(*lead, -1)


def _torch(arr: np.ndarray, torch_dtype: torch.dtype, device) -> torch.Tensor:
    """numpy storage (raw uint16/int16 for bf16) -> torch tensor on device."""
    arr = np.require(arr, requirements=["C", "W"])  # copies read-only mmap views
    if torch_dtype == torch.bfloat16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _check_dense(cfg: ModelConfig, xf=None) -> None:
    extras = {
        "MoE": cfg.n_experts,
        "post_norms": cfg.post_norms,
        "qk_norm": cfg.qk_norm,
        "embed_scale": cfg.embed_scale != 1.0,
        "softcaps": cfg.attn_softcap or cfg.logit_softcap,
        "gelu": cfg.act != "silu",
        "qkv bias": xf is not None and "l.0.attn.q.bias" in xf,
    }
    for name, present in extras.items():
        if present:
            raise NotImplementedError(f"{name}: later slice")


def load_params(xf, cfg: ModelConfig, device="cpu") -> ModelParams:
    """Load and stack all weights of a dense Llama/Mistral container
    (f32/f16/bf16/q8/i8) from an open XalmFile onto ``device``. f16 stays
    f16 (the JAX loader keeps it off-TPU too)."""
    _check_dense(cfg, xf)

    def info(name: str, expect_shape):
        t = xf.tensors.get(name)
        if t is None:
            raise ValueError(f"FATAL: missing tensor {name}")
        if name + ".scale4" in xf:
            raise NotImplementedError(f"{name}: packed q4 containers are a later slice")
        if tuple(t.shape) != tuple(expect_shape):
            raise ValueError(
                f"FATAL: tensor {name} has unexpected shape {t.shape}, expected {expect_shape}"
            )
        return t

    def stack_host(name_fmt: str, expect_shape):
        names = [name_fmt.format(i) for i in range(cfg.n_layers)]
        infos = [info(n, expect_shape) for n in names]
        dt = infos[0].dtype
        if any(i.dtype.name != dt.name for i in infos):
            raise ValueError(f"FATAL: mixed dtypes across {name_fmt}")
        vals = np.stack([xf.load(n) for n in names])
        scale = None
        if dt.name == "i8":
            snames = [xdt.scale_name(n) for n in names]
            if any(s not in xf for s in snames):
                raise ValueError(f"FATAL: i8 tensors for {name_fmt} missing scales")
            scale = np.stack([xf.load(s) for s in snames])
        return vals, scale, dt.torch_dtype

    def qw(vals, scale, tdt) -> QWeight:
        return QWeight(
            _torch(vals, tdt, device),
            None if scale is None else _torch(scale, torch.float32, device),
        )

    def fused(parts, fuse, *fargs) -> QWeight:
        has_scale = parts[0][1] is not None
        if any((p[1] is not None) != has_scale for p in parts) or any(
            p[2] != parts[0][2] for p in parts
        ):
            raise ValueError("FATAL: mixed quantization across fused weights")
        vals = fuse(*[p[0] for p in parts], *fargs)
        scale = fuse(*[p[1] for p in parts], *fargs) if has_scale else None
        return qw(vals, scale, parts[0][2])

    def stack_norm(name_fmt: str) -> torch.Tensor:
        vals, _, _ = stack_host(name_fmt, (cfg.dim,))
        return _torch(np.asarray(vals, np.float32), torch.float32, device)

    def single(name: str, shape) -> QWeight:
        t = info(name, shape)
        scale = None
        if t.dtype.name == "i8":
            scale = xf.load(xdt.scale_name(name))
        return qw(xf.load(name), scale, t.dtype.torch_dtype)

    d, q, kv, h = cfg.dim, cfg.q_dim, cfg.kv_dim, cfg.hidden_dim
    layers = LayerParams(
        attn_norm=stack_norm("l.{}.attn.norm.weight"),
        wqkv=fused(
            [
                stack_host("l.{}.attn.q.weight", (q, d)),
                stack_host("l.{}.attn.k.weight", (kv, d)),
                stack_host("l.{}.attn.v.weight", (kv, d)),
            ],
            fuse_qkv,
            cfg.n_kv_heads,
        ),
        wo=qw(*stack_host("l.{}.attn.down.weight", (d, q))),
        mlp_norm=stack_norm("l.{}.mlp.norm.weight"),
        w13=fused(
            [
                stack_host("l.{}.mlp.gate.weight", (h, d)),
                stack_host("l.{}.mlp.up.weight", (h, d)),
            ],
            fuse_w13,
            ffn_chunk(h),
        ),
        w2=qw(*stack_host("l.{}.mlp.down.weight", (d, h))),
    )
    embed = single("embed.weight", (cfg.vocab_size, d))
    onv = xf.load("output.norm.weight")
    out_norm = _torch(np.asarray(onv, np.float32), torch.float32, device)
    wcls = embed if cfg.tie_word_embeddings else single("output.weight", (cfg.vocab_size, d))
    return ModelParams(embed=embed, layers=layers, out_norm=out_norm, wcls=wcls)


def _from_np(arr, device) -> torch.Tensor:
    """A numpy leaf of the JAX tree (ml_dtypes bf16 included) -> torch."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return _torch(arr.view(np.int16), torch.bfloat16, device)
    return _torch(arr, None, device)


def from_jax_params(tree, device="cpu") -> ModelParams:
    """Carry weights across from the JAX package: ``tree`` is a JAX
    ``ModelParams`` whose leaves the caller turned into numpy arrays. The
    layouts are the same, so every tensor is a bit-exact copy."""
    lp = tree.layers
    for name in ("bqkv", "wgate", "w13e", "w2e", "post_attn_norm", "post_mlp_norm",
                 "q_norm", "k_norm"):
        if getattr(lp, name, None) is not None:
            raise NotImplementedError(f"{name}: later slice")

    def qw(w) -> QWeight:
        if getattr(w, "q4group", 0):
            raise NotImplementedError("packed q4 weights: later slice")
        return QWeight(
            _from_np(w.values, device),
            None if w.scale is None else _from_np(w.scale, device),
        )

    embed = qw(tree.embed)
    return ModelParams(
        embed=embed,
        layers=LayerParams(
            attn_norm=_from_np(lp.attn_norm, device),
            wqkv=qw(lp.wqkv),
            wo=qw(lp.wo),
            mlp_norm=_from_np(lp.mlp_norm, device),
            w13=qw(lp.w13),
            w2=qw(lp.w2),
        ),
        out_norm=_from_np(tree.out_norm, device),
        wcls=embed if tree.wcls is tree.embed else qw(tree.wcls),
    )


def recode_wcls_i8(params: ModelParams) -> ModelParams:
    """Re-code a float (bf16/f16/f32) classifier head to i8 with per-row
    absmax/127 scales (rounded half to even, clipped to +-127), bit-equal to
    the JAX package's ``recode_wcls_i8``, whose compiled form multiplies by
    the f32 reciprocal of 127: half the bytes of a 16-bit head, and the
    megakernel can stream it. A head that is already i8 is left alone; a
    tied head is untied (the embed lookup keeps the float table)."""
    w = params.wcls
    if w.values.dtype == torch.int8:
        return params
    f = w.values.to(torch.float32)
    amax = f.abs().amax(dim=-1)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=amax.device)
    scale = torch.where(amax > 0, amax * inv127, torch.ones_like(amax))
    q = torch.clamp(torch.round(f / scale[..., None]), -127, 127).to(torch.int8)
    return dataclasses.replace(params, wcls=QWeight(q, scale))
