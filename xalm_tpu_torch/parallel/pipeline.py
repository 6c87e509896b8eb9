"""Pipeline parallelism: the layer stack split over a ``pp`` mesh axis
(counterpart of ``xalm_tpu/parallel/pipeline.py``).

Stage s holds layers [s*L/pp, (s+1)*L/pp) and their block of the KV
cache, so weight and cache memory divide by pp. A step runs the stages in
turn: the active stage runs its local stack and broadcasts its residual,
and after the last stage every rank computes the (whole) head
(``models/llama.forward`` with ``pp``). tp composes within a stage: the
megatron shards of ``parallel/shardings.py`` and the stage's tp group.

On the card each stage runs the port's kernels over its local stack with
the local layer index; the JAX engine sends pp to its XLA path only
because its scalar-prefetch kernels index the whole stack. As in the JAX
engine: pp must divide n_layers, MoE with tp > 1 is refused, there are no
sampled scans, and prefill takes the per-chunk path. Perplexity runs the
engine's log-prob scan (the JAX engine steps token by token there: its
scan is a ``shard_map`` it does not build for pp; the port's scan step
already runs a pp forward). One sequence's forward is sequential across stages, so
pp buys memory, not single-stream speed.
"""

from __future__ import annotations

import torch

from xalm_tpu_torch.models.config import ModelConfig
from xalm_tpu_torch.models.llama import gathered_ok
from xalm_tpu_torch.models.params import LayerParams, ModelParams, QWeight
from xalm_tpu_torch.parallel.mesh import AXIS_PP, AXIS_TP, Mesh, build_mesh
from xalm_tpu_torch.parallel.sharded_engine import backend_of, load_full
from xalm_tpu_torch.parallel.shardings import shard_tree, validate_tp
from xalm_tpu_torch.runtime.cache import KVCache
from xalm_tpu_torch.runtime.engine import Engine, weight_bytes_per_token
from xalm_tpu_torch.tokenizer import Tokenizer

__all__ = ["AXIS_PP", "make_pp_mesh", "PipelinedEngine"]


def make_pp_mesh(pp: int, tp: int = 1, ranks=None, device=None) -> Mesh:
    """A (pp,) or (pp, tp) mesh: stages over pp, megatron tensor
    parallelism within each stage over tp."""
    import torch.distributed as dist

    n = len(ranks) if ranks is not None else (dist.get_world_size() if dist.is_initialized()
                                               else 1)
    if pp * tp > n:
        raise ValueError(f"pp*tp={pp}*{tp} > {n} devices")
    shape = {AXIS_PP: pp} if tp == 1 else {AXIS_PP: pp, AXIS_TP: tp}
    return build_mesh(shape, ranks, device)


def _param_pspecs(tp: int) -> ModelParams:
    """Layer stacks split on their leading L over pp (and with tp > 1
    megatron column/row within the stage, the layout of
    ``shardings.param_pspecs``); embed, head and final norm whole on every
    rank (the head runs on the broadcast final residual)."""
    tpa = AXIS_TP if tp > 1 else None
    col = QWeight((AXIS_PP, tpa, None), (AXIS_PP, tpa))
    row = QWeight((AXIS_PP, None, tpa), (AXIS_PP, None))
    layers = LayerParams(
        attn_norm=(AXIS_PP, None), wqkv=col, wo=row, mlp_norm=(AXIS_PP, None), w13=col, w2=row,
        bqkv=(AXIS_PP, tpa), wgate=(AXIS_PP, None, None),
        # MoE expert stacks split by layer like everything else (E local)
        w13e=QWeight((AXIS_PP, None, None, None), (AXIS_PP, None, None)),
        w2e=QWeight((AXIS_PP, None, None, None), (AXIS_PP, None, None)),
        post_attn_norm=(AXIS_PP, None), post_mlp_norm=(AXIS_PP, None),
        q_norm=(AXIS_PP, None), k_norm=(AXIS_PP, None),
    )
    return ModelParams(embed=QWeight((None, None), (None,)), layers=layers, out_norm=(None,),
                       wcls=QWeight((None, None), (None,)))


class PipelinedEngine(Engine):
    """Engine with the layer stack pipeline-split over a pp mesh."""

    _sample_scan = None  # stochastic decode: not built for pp, as in the JAX engine
    sample_scan_rows = None

    def __init__(
        self,
        cfg: ModelConfig,
        params: ModelParams,
        tokenizer: Tokenizer | None,
        mesh: Mesh,
        *,
        kv_dtype="auto",
        compute_dtype="auto",
    ):
        """``params``: the FULL weights; this rank keeps its stage's layers
        (and its tp shard of them) on ``mesh.device``."""
        pp = mesh.shape[AXIS_PP]
        tp = mesh.shape.get(AXIS_TP, 1)
        if cfg.n_layers % pp != 0:
            raise ValueError(f"pp={pp} must divide n_layers={cfg.n_layers}")
        if tp > 1:
            validate_tp(cfg, tp)
            if params.layers.w13e is not None:
                raise NotImplementedError(
                    "MoE + tp: expert stacks are not tp-sharded yet; "
                    "use a pp-only mesh"
                )
        if not mesh.member:
            raise ValueError("this rank holds no place in the mesh")
        self.mesh = mesh
        moe = params.layers.w13e
        full_bytes = weight_bytes_per_token(cfg, params, moe is not None and gathered_ok(moe, "kernel"))
        super().__init__(cfg, shard_tree(params, _param_pspecs(tp), mesh, mesh.device),
                         tokenizer, kv_dtype=kv_dtype, compute_dtype=compute_dtype,
                         fused_step=False)
        self._per_token_weight_bytes = full_bytes
        self._pp = mesh.axis(AXIS_PP)
        self._tp = mesh.axis(AXIS_TP) if tp > 1 else None
        self.backend = backend_of(mesh)
        self.capture_steps = self.backend != "gloo"

    @classmethod
    def from_xalm(cls, path: str, mesh: Mesh, *, context: int = 0, kv_dtype="auto",
                  compute_dtype="auto", fp8_mode: str = "auto",
                  device=None) -> "PipelinedEngine":
        if device is not None:
            mesh.device = torch.device(device)
        cfg, params, tokenizer, chat_template = load_full(path, context, mesh.device,
                                                          fp8_mode=fp8_mode)
        eng = cls(cfg, params, tokenizer, mesh, kv_dtype=kv_dtype, compute_dtype=compute_dtype)
        eng.chat_template = chat_template
        return eng

    def decode_path(self, batch: int = 1) -> str:
        tp = 1 if self._tp is None else self._tp.size
        path = f"perlayer (pp={self._pp.size} tp={tp})"
        if self.device.type == "cuda" and not self.capture_steps:
            path += ", eager steps: gloo collectives cannot be captured"
        return path

    def _forward_kw(self) -> dict:
        return dict(super()._forward_kw(), pp=self._pp, tp=self._tp)

    def new_cache(self, batch: int = 1) -> KVCache:
        """This stage's layers of the cache (and its tp kv heads)."""
        shape = list(KVCache.plane_shape(self.cfg, batch))
        shape[0] //= self._pp.size
        if self._tp is not None:
            shape[2] //= self._tp.size
        return KVCache.zeros(tuple(shape), self.kv_dtype, self.device)

    def generate(self, prompt_ids, max_new_tokens, *, resume=None, return_session=False,
                 **kw):
        if resume is not None or return_session:
            raise NotImplementedError("sessions are single-device: save and resume them with "
                                      "Engine")
        if kw.get("temperature", 0.0) > 0.0:
            raise NotImplementedError(
                "stochastic sampling is not wired into this engine subclass; "
                "use temperature=0 (greedy)"
            )
        return super().generate(prompt_ids, max_new_tokens, **kw)
