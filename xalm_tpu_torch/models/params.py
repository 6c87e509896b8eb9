"""Weights as torch tensors and .xalm loading (counterpart of
``xalm_tpu/models/params.py``).

Layers are stacked along a leading L axis, in the same fused device layouts
as the JAX package, so every intermediate can be compared with it:

- ``wqkv`` (L, KH*(G+2)*hd, dim): per kv-head group j the rows are
  [q rows of group j | k row-block j | v row-block j].
- ``w13`` (L, 2*hidden, dim): gate/up interleaved in ``ffn_chunk``-row
  chunks [gate_c0 | up_c0 | gate_c1 | ...].
- MoE (Mixtral): ``w13``/``w2`` are None; ``wgate`` (L, E, dim) f32 is the
  router, ``w13e`` (L, E, 2*hidden, dim) each expert's fused gate/up in the
  ``w13`` layout, ``w2e`` (L, E, dim, hidden) each expert's down.

Quantization rides the dtype plus an optional per-output-row f32 ``scale``:
float weights dequantize by a cast, int8 with ``scale`` is `i8`
(y = (x @ W^T) * scale), int8 without it is `q8` (fixed scale 1/100).
``recode_wcls_i8`` re-codes a float head to i8 per row.

Packed q4 (``QWeight.q4group`` = g > 0): int8 values of shape (..., D, K/2)
hold two signed 4-bit codes per byte in split-half k-order (the low nibble
of byte j is code k = j, the high nibble code k = j + K/2), and ``scale`` is
(..., D, K/g) f32, one symmetric absmax/7 scale per (row, group of g codes).
A ``--type q4`` container stores them as a packed tensor with a ``.scale4``
partner; ``recode_params_q4`` packs an i8/q8/float body at load.

Family extras: Qwen2's q/k/v projection bias is ``bqkv`` (L, DQ) f32, fused
in ``wqkv``'s row order; Qwen3's per-head q/k RMS norm weights are
``q_norm``/``k_norm`` (L, head_dim) f32; Gemma-2's post-attention and
post-feedforward norm weights are ``post_attn_norm``/``post_mlp_norm`` (L,
dim) f32 (the converter files them as ``l.{i}.attn.postnorm.weight`` and
``l.{i}.mlp.postnorm.weight``, the (1 + w) offset folded in). Gemma's gelu
and embed scale and Gemma-2's softcaps are config fields
(``models/config.py``).

Weight formats at load (``load_params``'s modes, the JAX loader's): f16
weights become bf16 on the card (``f16_mode``; the kernels take no f16)
and fp8 weights int8 with per-row scales (``fp8_mode``, ``recode_fp8_rows``:
the `i8` scheme, bit-equal to the JAX recode); on the CPU both stay as
stored by default, and every mode can be asked for on either device.
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
    "load_units",
    "from_jax_params",
    "recode_wcls_i8",
    "recode_qweight_q4",
    "recode_params_q4",
    "recode_fp8_rows",
    "unpack_q4",
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
    f32 tensor of shape (..., D) for `i8`, else None. ``q4group`` = g > 0
    marks packed 4-bit values (..., D, N/2) with (..., D, N/g) f32 scales
    (see the module docstring)."""

    values: torch.Tensor
    scale: torch.Tensor | None = None
    q4group: int = 0

    @property
    def shape(self):
        return self.values.shape

    def dequant(self, dtype) -> torch.Tensor:
        """The dequantized matrix in ``dtype`` (``astype_dequant`` of the JAX
        package): q4 codes and group scales are cast to ``dtype`` and
        multiplied there; i8/q8 values times their row scale or 1/100."""
        if self.q4group:
            codes = unpack_q4(self.values)
            c = codes.reshape(*codes.shape[:-1], -1, self.q4group).to(dtype)
            return (c * self.scale[..., None].to(dtype)).reshape(codes.shape)
        v = self.values.to(dtype)
        if self.values.dtype == torch.int8:
            if self.scale is not None:
                return v * self.scale[..., None].to(dtype)
            return v * torch.tensor(Q8_FIXED_SCALE, dtype=dtype, device=v.device)
        return v

    def nbytes(self) -> int:
        n = self.values.nelement() * self.values.element_size()
        if self.scale is not None:
            n += self.scale.nelement() * self.scale.element_size()
        return n


@dataclasses.dataclass
class LayerParams:
    """Per-layer weights of the Llama/Mistral/Mixtral block, stacked (L, ...)."""

    attn_norm: torch.Tensor  # (L, dim) f32
    wqkv: QWeight  # (L, kh*(g+2)*hd, dim)
    wo: QWeight  # (L, dim, q_dim)
    mlp_norm: torch.Tensor  # (L, dim) f32
    # dense GLU FFN (None for MoE: w13e/w2e carry the experts)
    w13: QWeight | None = None  # (L, 2*hidden, dim)
    w2: QWeight | None = None  # (L, dim, hidden)
    # Mixtral sparse-MoE FFN (None for dense models)
    wgate: torch.Tensor | None = None  # (L, E, dim) f32 router
    w13e: QWeight | None = None  # (L, E, 2*hidden, dim), scale (L, E, 2*hidden)
    w2e: QWeight | None = None  # (L, E, dim, hidden), scale (L, E, dim)
    # family extras (None where the model has none)
    bqkv: torch.Tensor | None = None  # (L, kh*(g+2)*hd) f32 Qwen2 qkv bias, wqkv's row order
    q_norm: torch.Tensor | None = None  # (L, head_dim) f32 Qwen3 per-head q RMS norm
    k_norm: torch.Tensor | None = None  # (L, head_dim) f32 Qwen3 per-head k RMS norm
    post_attn_norm: torch.Tensor | None = None  # (L, dim) f32 Gemma-2 post-attention norm
    post_mlp_norm: torch.Tensor | None = None  # (L, dim) f32 Gemma-2 post-feedforward norm


@dataclasses.dataclass
class ModelParams:
    embed: QWeight  # (vocab, dim)
    layers: LayerParams
    out_norm: torch.Tensor  # (dim,) f32
    wcls: QWeight  # (vocab, dim); the same object as embed when tied

    def nbytes(self) -> int:
        lp = self.layers
        mats = (self.embed, lp.wqkv, lp.wo, lp.w13, lp.w2, lp.w13e, lp.w2e)
        n = sum(w.nbytes() for w in mats if w is not None)
        if self.wcls is not self.embed:
            n += self.wcls.nbytes()
        for t in (lp.attn_norm, lp.mlp_norm, self.out_norm, lp.wgate, lp.bqkv, lp.q_norm,
                  lp.k_norm, lp.post_attn_norm, lp.post_mlp_norm):
            if t is not None:
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


_RAW = {torch.bfloat16: np.int16, torch.float8_e4m3fn: np.uint8, torch.float8_e5m2: np.uint8}


def _torch(arr: np.ndarray, torch_dtype: torch.dtype | None, device,
           cast: torch.dtype | None = None) -> torch.Tensor:
    """numpy storage (raw 16 bits for bf16, raw bytes for fp8) -> torch
    tensor on device, cast on the host to ``cast`` first where given."""
    arr = np.require(arr, requirements=["C", "W"])  # copies read-only mmap views
    if torch_dtype in _RAW:
        t = torch.from_numpy(arr.view(_RAW[torch_dtype])).view(torch_dtype)
    else:
        t = torch.from_numpy(arr)
    if cast is not None:
        t = t.to(cast)
    return t.to(device)


def _host_f32(arr: np.ndarray, tdt: torch.dtype) -> np.ndarray:
    """Stored float values (bf16 and fp8 as their raw bits) -> f32."""
    if tdt in _RAW:
        return _torch(arr, tdt, "cpu", torch.float32).numpy()
    return np.asarray(arr, np.float32)


F16_MODES = ("auto", "keep", "bf16", "f32")
FP8_MODES = ("auto", "keep", "recode")
_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def recode_fp8_rows(vals: np.ndarray, tdt: torch.dtype) -> tuple[np.ndarray, np.ndarray]:
    """fp8 weights (raw bytes of ``tdt``, shape (..., N)) -> (int8 codes,
    per-row f32 scale), the `i8` scheme of the JAX package's
    ``recode_fp8_rows``, bit for bit: scale = amax / 127.0 (an f32 IEEE
    division; 1 for an all-zero row), codes = round half to even of
    f / scale, clipped to +-127. Blocked over rows, so the f32 temporary
    stays at about 64 MB. Non-finite values (e5m2 encodes inf and NaN)
    raise: a saturating converter writes none."""
    rows = np.asarray(vals).reshape(-1, vals.shape[-1])
    n = rows.shape[0]
    q = np.empty(rows.shape, np.int8)
    scale = np.empty((n,), np.float32)
    slab = max(1, (64 << 20) // (rows.shape[-1] * 4))
    for at in range(0, n, slab):
        f = _host_f32(rows[at : at + slab], tdt)
        if not np.isfinite(f).all():
            raise ValueError(
                "non-finite fp8 weight values: container is corrupt or was "
                "not produced by a saturating converter (cannot recode to i8)"
            )
        amax = np.abs(f).max(axis=1)
        sc = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
        scale[at : at + slab] = sc
        np.clip(np.round(f / sc[:, None]), -127, 127, out=f)
        q[at : at + slab] = f.astype(np.int8)
    return q.reshape(vals.shape), scale.reshape(vals.shape[:-1])


def load_units(cfg: ModelConfig) -> int:
    """The ``progress`` calls of ``load_params`` (the JAX ``load_units``):
    9 tensors a layer (7 and 3 an expert with MoE, 2 more with post-norms),
    then the embed, the output norm and the head. The q/k norms and biases
    are not counted."""
    per_layer = 9 if not cfg.n_experts else 7 + 3 * cfg.n_experts
    if cfg.post_norms:
        per_layer += 2
    return per_layer * cfg.n_layers + 3


def load_params(xf, cfg: ModelConfig, device="cuda", f16_mode: str = "auto",
                fp8_mode: str = "auto", progress=None) -> ModelParams:
    """Load and stack all weights of a container of any family the JAX
    package reads (Llama/Mistral/Mixtral, Qwen2/3, Gemma, Gemma-2, Phi-3;
    f32/f16/bf16/f8_e4m3/f8_e5m2/q8/i8, packed q4) from an open XalmFile
    onto ``device`` (the card unless the caller asks for the CPU).

    ``f16_mode`` (the JAX loader's): what f16 weights become. "auto" is bf16
    on the card (its kernels take no f16; the same bytes, 3 fewer mantissa
    bits) and "keep" elsewhere; "keep", "bf16" and "f32" force.
    ``fp8_mode``: "auto" recodes fp8 weights to int8 with per-row scales on
    the card (``recode_fp8_rows``: the kernels and the megakernel take i8)
    and keeps fp8 elsewhere; "keep" and "recode" force. A weight kept f16 or
    fp8 runs ops.linear's plain product. Norms, biases, the router and
    scales are f32 whatever the modes. ``progress``, if given, is called
    once a unit of ``load_units(cfg)`` as the tensors are read (the JAX
    loader's callback, ``ProgressBar.advance``)."""
    if f16_mode not in F16_MODES or fp8_mode not in FP8_MODES:
        raise ValueError(f"f16_mode {f16_mode!r} (one of {F16_MODES}), fp8_mode {fp8_mode!r} "
                         f"(one of {FP8_MODES})")
    on_card = torch.device(device).type == "cuda"
    if f16_mode == "auto":
        f16_mode = "bf16" if on_card else "keep"
    if fp8_mode == "auto":
        fp8_mode = "recode" if on_card else "keep"
    f16_to = {"keep": None, "bf16": torch.bfloat16, "f32": torch.float32}[f16_mode]
    tick = progress if progress is not None else (lambda: None)

    def recoded(vals, scale, tdt):
        """(values, scale, dtype) of a weight as stored -> as loaded: fp8
        recoded to i8 rows under "recode" (fp8 containers carry no scales)."""
        if fp8_mode == "recode" and tdt in _FP8:
            return (*recode_fp8_rows(vals, tdt), torch.int8)
        return vals, scale, tdt

    def cast(tdt):
        """The dtype a weight of dtype ``tdt`` takes on ``device``."""
        return (f16_to or tdt) if tdt == torch.float16 else tdt

    def info(name: str, expect_shape):
        t = xf.tensors.get(name)
        if t is None:
            raise ValueError(f"FATAL: missing tensor {name}")
        # a q4 tensor holds K/2 packed bytes per row beside its .scale4 partner
        packed = tuple(expect_shape[:-1]) + (expect_shape[-1] // 2,)
        if tuple(t.shape) != tuple(expect_shape) and not (
                name + ".scale4" in xf and tuple(t.shape) == packed):
            raise ValueError(
                f"FATAL: tensor {name} has unexpected shape {t.shape}, expected {expect_shape}"
            )
        return t

    def stack_host(name_fmt: str, expect_shape, recode: bool = True, ticks: bool = True):
        """(values, scale, dtype) of a weight kind stacked over the layers
        on the host (``XalmFile.read_stack``: the native pool's copies);
        fp8 recoded under "recode" (not for ``stack_norm``, as in the JAX
        loader). One ``progress`` call a layer unless ``ticks`` is off."""
        names = [name_fmt.format(i) for i in range(cfg.n_layers)]
        infos = [info(n, expect_shape) for n in names]
        dt = infos[0].dtype
        if any(i.dtype.name != dt.name for i in infos):
            raise ValueError(f"FATAL: mixed dtypes across {name_fmt}")
        vals = xf.read_stack(names)
        if ticks:
            for _ in names:
                tick()
        scale = None
        if names[0] + ".scale4" in xf:
            # q4: (D, K/g) group-scale planes, fused and stacked like the values
            if any(n + ".scale4" not in xf for n in names):
                raise ValueError(f"FATAL: mixed q4 and unpacked tensors across {name_fmt}")
            scale = xf.read_stack([n + ".scale4" for n in names])
            return vals, scale, torch.int8
        if dt.name == "i8":
            snames = [xdt.scale_name(n) for n in names]
            if any(s not in xf for s in snames):
                raise ValueError(f"FATAL: i8 tensors for {name_fmt} missing scales")
            scale = xf.read_stack(snames)
        if not recode:
            return vals, scale, dt.torch_dtype
        return recoded(vals, scale, dt.torch_dtype)

    def qw(vals, scale, tdt) -> QWeight:
        # q4: the scale has one column per group, the values K/2 bytes a row
        q4group = 2 * vals.shape[-1] // scale.shape[-1] if (
            scale is not None and scale.ndim == vals.ndim) else 0
        return QWeight(
            _torch(vals, tdt, device, cast(tdt)),
            None if scale is None else _torch(scale, torch.float32, device),
            q4group,
        )

    def fuse_host(parts, fuse, *fargs):
        """(values, scale, dtype) stacks -> the fused host (values, scale, dtype)."""
        has_scale = parts[0][1] is not None
        if any((p[1] is not None) != has_scale for p in parts) or any(
            p[2] != parts[0][2] for p in parts
        ):
            raise ValueError("FATAL: mixed quantization across fused weights")
        vals = fuse(*[p[0] for p in parts], *fargs)
        scale = fuse(*[p[1] for p in parts], *fargs) if has_scale else None
        return vals, scale, parts[0][2]

    def fused(parts, fuse, *fargs) -> QWeight:
        return qw(*fuse_host(parts, fuse, *fargs))

    def stack_norm(name_fmt: str, n: int, ticks: bool = True) -> torch.Tensor:
        """(L, n) f32 of a float (f32, f16, bf16 or fp8) vector per layer."""
        vals, _, tdt = stack_host(name_fmt, (n,), recode=False, ticks=ticks)
        return _torch(_host_f32(vals, tdt), torch.float32, device)

    def bias() -> torch.Tensor:
        """(L, DQ) f32 q/k/v bias, fused in wqkv's row order (JAX
        ``load_params`` takes the stored values alone, as here)."""
        parts = [stack_host(f"l.{{}}.attn.{w}.bias", (n,), ticks=False)
                 for w, n in (("q", q), ("k", kv), ("v", kv))]
        return _torch(fuse_qkv(*(_host_f32(v, tdt) for v, _, tdt in parts), cfg.n_kv_heads),
                      torch.float32, device)

    def single(name: str, shape) -> QWeight:
        t = info(name, shape)
        scale = None
        if t.dtype.name == "i8":
            scale = xf.load(xdt.scale_name(name))
        # read_stack: a writable copy by the native pool (a view of the map
        # would be copied once more, serially, for torch)
        return qw(*recoded(xf.read_stack([name])[0], scale, t.dtype.torch_dtype))

    def router() -> torch.Tensor:
        """(L, E, dim) f32; expert selection cannot ride an int8 code."""
        vals, _, tdt = stack_host("l.{}.moe.gate.weight", (cfg.n_experts, d))
        if tdt == torch.int8:
            raise ValueError("FATAL: MoE router weights must not be int8-quantized")
        return _torch(_host_f32(vals, tdt), torch.float32, device)

    def experts(host_stack) -> QWeight:
        """(L, E, ...) stacks of the (values, scale, dtype) that
        ``host_stack(e)`` gives for each expert, filled one expert at a time
        on ``device``: the host holds one expert's (L, ...) stack at once."""
        vals = scale = None
        for e in range(cfg.n_experts):
            v, sc, tdt = host_stack(e)
            if e and ((sc is None) != (scale is None) or cast(tdt) != vals.dtype):
                raise ValueError(f"FATAL: mixed quantization across MoE experts (expert {e})")
            v = _torch(v, tdt, "cpu", cast(tdt))
            if e == 0:
                vals = torch.empty((v.shape[0], cfg.n_experts, *v.shape[1:]), dtype=v.dtype,
                                   device=device)
                if sc is not None:
                    scale = torch.empty((sc.shape[0], cfg.n_experts, *sc.shape[1:]),
                                        dtype=torch.float32, device=device)
            vals[:, e] = v
            if sc is not None:
                scale[:, e] = _torch(sc, torch.float32, "cpu")
        return QWeight(vals, scale)

    def gate_up(e):
        return fuse_host([stack_host(f"l.{{}}.moe.{e}.gate.weight", (h, d)),
                          stack_host(f"l.{{}}.moe.{e}.up.weight", (h, d))], fuse_w13, ffn_chunk(h))

    def down(e):
        return stack_host(f"l.{{}}.moe.{e}.down.weight", (d, h))

    d, q, kv, h = cfg.dim, cfg.q_dim, cfg.kv_dim, cfg.hidden_dim
    moe = cfg.n_experts > 0
    layers = LayerParams(
        attn_norm=stack_norm("l.{}.attn.norm.weight", d),
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
        mlp_norm=stack_norm("l.{}.mlp.norm.weight", d),
        w13=None if moe else fused(
            [
                stack_host("l.{}.mlp.gate.weight", (h, d)),
                stack_host("l.{}.mlp.up.weight", (h, d)),
            ],
            fuse_w13,
            ffn_chunk(h),
        ),
        w2=None if moe else qw(*stack_host("l.{}.mlp.down.weight", (d, h))),
        wgate=router() if moe else None,
        w13e=experts(gate_up) if moe else None,
        w2e=experts(down) if moe else None,
        bqkv=bias() if "l.0.attn.q.bias" in xf else None,
        q_norm=stack_norm("l.{}.attn.qnorm.weight", cfg.head_dim, False) if cfg.qk_norm else None,
        k_norm=stack_norm("l.{}.attn.knorm.weight", cfg.head_dim, False) if cfg.qk_norm else None,
        post_attn_norm=stack_norm("l.{}.attn.postnorm.weight", d) if cfg.post_norms else None,
        post_mlp_norm=stack_norm("l.{}.mlp.postnorm.weight", d) if cfg.post_norms else None,
    )
    embed = single("embed.weight", (cfg.vocab_size, d))
    tick()
    out_norm = _torch(_host_f32(xf.load("output.norm.weight"),
                                info("output.norm.weight", (d,)).dtype.torch_dtype),
                      torch.float32, device)
    tick()
    wcls = embed if cfg.tie_word_embeddings else single("output.weight", (cfg.vocab_size, d))
    tick()
    return ModelParams(embed=embed, layers=layers, out_norm=out_norm, wcls=wcls)


_ML_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}


def _from_np(arr, device) -> torch.Tensor:
    """A numpy leaf of the JAX tree (ml_dtypes bf16 and fp8 included) -> torch."""
    arr = np.asarray(arr)
    tdt = _ML_DTYPES.get(arr.dtype.name)
    if tdt is not None:
        return _torch(arr.view(_RAW[tdt]), tdt, device)
    return _torch(arr, None, device)


def from_jax_params(tree, device="cuda") -> ModelParams:
    """Carry weights across from the JAX package: ``tree`` is a JAX
    ``ModelParams`` whose leaves the caller turned into numpy arrays. The
    layouts are the same, so every tensor is a bit-exact copy. On the card
    unless the caller asks for the CPU, as ``load_params``."""
    lp = tree.layers
    opt = lambda a: None if a is None else _from_np(a, device)  # noqa: E731

    def qw(w) -> QWeight | None:
        if w is None:
            return None
        return QWeight(
            _from_np(w.values, device),
            None if w.scale is None else _from_np(w.scale, device),
            getattr(w, "q4group", 0),
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
            wgate=opt(lp.wgate),
            w13e=qw(lp.w13e),
            w2e=qw(lp.w2e),
            bqkv=opt(lp.bqkv),
            q_norm=opt(lp.q_norm),
            k_norm=opt(lp.k_norm),
            post_attn_norm=opt(lp.post_attn_norm),
            post_mlp_norm=opt(lp.post_mlp_norm),
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


# ------------------------------------------------------------------ packed q4


def unpack_q4(packed: torch.Tensor) -> torch.Tensor:
    """Packed (..., K/2) int8 -> (..., K) int8 codes in [-8, 7]: the low
    nibbles (codes 0..K/2-1), sign-extended, then the high nibbles (an
    arithmetic shift)."""
    w = packed.to(torch.int32)
    lo = ((w & 0xF) ^ 8) - 8
    return torch.cat([lo, w >> 4], dim=-1).to(torch.int8)


def _pack_q4_codes(q: torch.Tensor) -> torch.Tensor:
    """int codes in [-8, 7] of shape (..., K) -> packed (..., K/2) int8."""
    k = q.shape[-1]
    lo, hi = q[..., : k // 2].to(torch.int32), q[..., k // 2 :].to(torch.int32)
    u = ((hi & 0xF) << 4) | (lo & 0xF)  # 0..255
    return torch.where(u > 127, u - 256, u).to(torch.int8)


def _q4_slab(f: torch.Tensor, group: int) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 (..., D, K) -> (packed (..., D, K/2) int8, scale (..., D, K/g)):
    per (row, group) scale absmax/7 (1 for an all-zero group), codes
    round(v / scale) half to even, clipped to [-8, 7]. The JAX recode runs
    compiled, where XLA turns the division by 7 into a multiply by the f32
    reciprocal of 7; the scale here is that product, so both give the same
    bits. The codes divide by the scale (IEEE division, a tensor divisor)."""
    *lead, d, k = f.shape
    fg = f.reshape(*lead, d, k // group, group)
    amax = fg.abs().amax(dim=-1)
    inv7 = torch.tensor(1.0 / 7.0, dtype=torch.float32, device=f.device)
    sc = torch.where(amax > 0, amax * inv7, torch.ones_like(amax))
    q = torch.clamp(torch.round(fg / sc[..., None]), -8, 7)
    return _pack_q4_codes(q.reshape(f.shape)), sc


def recode_qweight_q4(qw: QWeight, group: int) -> QWeight:
    """Re-code one i8/q8/float QWeight to packed 4-bit with per-(row, group)
    scales, bit-equal to the JAX package's ``recode_qweight_q4``. The f32
    temporary is one layer (stacked (L, D, K)) or one expert (stacked
    (L, E, D, K)) at a time, as in the reference; the new tensors are made
    on the weight's device."""
    if qw.q4group:
        return qw
    k = qw.values.shape[-1]
    if k % (2 * group) or group % 128:
        raise ValueError(f"q4 group {group} must be a 128-multiple dividing K/2={k // 2}")
    v, s = qw.values, qw.scale
    lead = v.shape[:-2]
    flat_v = v.reshape(-1, *v.shape[-2:])
    flat_s = None if s is None else s.reshape(-1, s.shape[-1])
    packed = torch.empty((*flat_v.shape[:-1], k // 2), dtype=torch.int8, device=v.device)
    scale = torch.empty((*flat_v.shape[:-1], k // group), dtype=torch.float32, device=v.device)
    for i in range(flat_v.shape[0]):
        f = flat_v[i].to(torch.float32)
        if flat_s is not None:
            f = f * flat_s[i][:, None]
        elif v.dtype == torch.int8:
            f = f * Q8_FIXED_SCALE
        packed[i], scale[i] = _q4_slab(f, group)
        del f
    return QWeight(packed.reshape(*lead, *packed.shape[-2:]),
                   scale.reshape(*lead, *scale.shape[-2:]), group)


def recode_params_q4(params: ModelParams, group: int = 512) -> ModelParams:
    """Re-code the four body weights (wqkv/wo/w13/w2, or for MoE wqkv/wo and
    the expert stacks) to packed 4-bit; embed, head, norms and the router
    stay as they are (``recode_params_q4`` of the JAX package). Each weight
    is replaced as soon as it is recoded, so its source can be freed."""
    lp = params.layers
    names = ("wqkv", "wo", "w13e", "w2e") if lp.w13 is None else ("wqkv", "wo", "w13", "w2")
    layers = dataclasses.replace(lp)
    for name in names:
        setattr(layers, name, recode_qweight_q4(getattr(layers, name), group))
    return dataclasses.replace(params, layers=layers)
