"""Process meshes over ``torch.distributed`` ranks (counterpart of
``xalm_tpu/parallel/mesh.py``).

Every rank is one process driving one device (SPMD, PyTorch's idiom): a
(dp, tp) mesh lays ranks out as ``np.array(ranks).reshape(dp, tp)`` lays
out JAX devices, so rank r sits at (r // tp, r % tp). Each axis gives a
rank one process group: the ranks that differ from it along that axis
only (its tp row, its dp column). Every rank of the world creates every
group, in the same order, as ``torch.distributed.new_group`` requires.

The collectives of the port are written as ``all_reduce`` (a sum) or
``broadcast`` only: the backend table of ``torch.distributed`` gives gloo
just those two over CUDA tensors, and so the same code runs on NCCL, on
gloo on the CPU and on gloo over one card. An all-gather is an all-reduce
of a zero-filled (size, ...) buffer in which each rank writes its own row
(``Axis.gather``); the sums add zeros, so they are exact. The greedy
token and the log-probs of a vocab-sharded head (``sharded_argmax``,
``sharded_token_logprobs``) are built on these, and the forward and the
engine's scans import them from here.

``COLLECTIVES`` counts the calls and bytes of each kind over groups of more
than one rank (a collective over one rank moves nothing), as
``ops/build.LAUNCHES`` counts kernel launches: a CUDA graph's capture takes
its counts back out (``take_collectives``) and each replay adds them
(``add_collectives``). ``parallel/aot.collective_stats`` reads them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "Mesh", "Axis", "AXIS_DP", "AXIS_TP", "AXIS_PP", "COLLECTIVES",
           "take_collectives", "add_collectives"]

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_PP = "pp"

COLLECTIVES: dict[str, dict[str, int]] = {
    "all_reduce": {"calls": 0, "bytes": 0}, "broadcast": {"calls": 0, "bytes": 0}}


def _snapshot() -> dict:
    return {k: dict(v) for k, v in COLLECTIVES.items()}


def take_collectives(before: dict) -> dict:
    """The collectives counted since ``before`` (a ``_snapshot``), taken back
    out of ``COLLECTIVES`` (a graph's capture runs them but moves nothing)."""
    made = {k: {f: COLLECTIVES[k][f] - before[k][f] for f in ("calls", "bytes")}
            for k in COLLECTIVES}
    for k in COLLECTIVES:
        COLLECTIVES[k].update(before[k])
    return made


def add_collectives(counts: dict, times: int = 1) -> None:
    """Count ``times`` replays of a graph that recorded ``counts``."""
    for k, c in counts.items():
        for f in ("calls", "bytes"):
            COLLECTIVES[k][f] += c[f] * times


def _count(kind: str, size: int, t: torch.Tensor) -> None:
    if size > 1:
        COLLECTIVES[kind]["calls"] += 1
        COLLECTIVES[kind]["bytes"] += t.nelement() * t.element_size()


class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index
    along it, the world ranks of its group (ordered by index) and the group
    itself (None in a layout-only mesh, which only slices shards)."""

    def __init__(self, name: str, size: int, index: int, ranks: list[int], group=None):
        self.name, self.size, self.index = name, size, index
        self.ranks, self.group = ranks, group

    def __repr__(self) -> str:
        return f"Axis({self.name}, {self.index}/{self.size})"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the axis, in place; returns it."""
        _count("all_reduce", self.size, t)
        dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of the rank at index ``src`` on every rank, in place."""
        _count("broadcast", self.size, t)
        dist.broadcast(t, src=self.ranks[src], group=self.group)
        return t

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in index order (an
        all-gather, as an all-reduce of a zero-filled buffer)."""
        buf = torch.zeros((self.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        buf[self.index] = t
        self.all_reduce(buf)
        dim = dim % t.dim()
        return buf.movedim(0, dim).reshape(*t.shape[:dim], -1, *t.shape[dim + 1:])


class Mesh:
    """A mesh of ``shape`` (axis name -> size, in layout order) over world
    ranks laid out row-major; ``rank`` is this process's world rank, or
    None where it holds no place in the mesh. ``axis(name)`` is this rank's
    view of an axis; ``mesh`` the axis of all its ranks; ``device`` where
    this rank's shards live."""

    def __init__(self, shape: dict, ranks: list[int], rank: int | None, device=None,
                 groups: dict | None = None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.ranks = list(ranks)
        self.rank = rank if rank in self.ranks else None
        self.device = torch.device(device if device is not None else "cpu")
        groups = groups or {}
        grid = np.array(self.ranks).reshape(*self.shape.values())
        self._axes: dict[str, Axis] = {}
        if self.rank is None:
            return
        coords = [int(c[0]) for c in np.nonzero(grid == self.rank)]
        for k, name in enumerate(self.axis_names):
            line = np.moveaxis(grid, k, -1)[tuple(c for j, c in enumerate(coords) if j != k)]
            members = [int(r) for r in line]
            self._axes[name] = Axis(name, len(members), coords[k], members,
                                    groups.get((name, tuple(members))))
        self._axes["mesh"] = Axis("mesh", len(self.ranks), self.ranks.index(self.rank),
                                  self.ranks, groups.get(("mesh", tuple(self.ranks))))

    @property
    def member(self) -> bool:
        return self.rank is not None

    def axis(self, name: str) -> Axis:
        """This rank's view of axis ``name`` (size 1 where the mesh lacks it)."""
        if name not in self._axes:
            if name in self.shape or self.rank is None:
                raise ValueError(f"rank {self.rank} holds no place in this mesh")
            return Axis(name, 1, 0, [self.rank])
        return self._axes[name]

    def coords(self) -> dict:
        return {n: self._axes[n].index for n in self.axis_names}

    @classmethod
    def layout(cls, shape: dict, index: int) -> "Mesh":
        """The mesh of ``shape`` over ranks 0..n-1 seen from rank ``index``,
        with no process group: it only slices shards (``shard_params``)."""
        return cls(shape, list(range(int(np.prod(list(shape.values()))))), index)


def build_mesh(shape: dict, ranks=None, device=None) -> Mesh:
    """A mesh of ``shape`` over ``ranks`` (default: the world's first ranks)
    with its process groups; every rank of the world must call it."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "xalm_tpu_torch.parallel.multihost.init_distributed first")
    n_mesh = int(np.prod(list(shape.values())))
    ranks = list(range(dist.get_world_size()))[:n_mesh] if ranks is None else list(ranks)[:n_mesh]
    grid = np.array(ranks).reshape(*shape.values())
    groups = {}
    # every rank creates every group in this same order
    for k, name in enumerate(shape):
        for line in np.moveaxis(grid, k, -1).reshape(-1, grid.shape[k]):
            members = tuple(int(r) for r in line)
            groups[(name, members)] = dist.new_group(list(members))
    groups[("mesh", tuple(ranks))] = dist.new_group(ranks)
    if device is None:
        from xalm_tpu_torch.parallel.multihost import local_device

        device = local_device()
    return Mesh(shape, ranks, dist.get_rank(), device, groups)


def make_mesh(dp: int = 1, tp: int | None = None, ranks=None, device=None) -> Mesh:
    """A (dp, tp) mesh over the world's ranks. tp defaults to all remaining
    ranks. tp must divide n_kv_heads so that GQA decode stays on one device
    (checked when the weights are sharded)."""
    n = dist.get_world_size() if ranks is None and dist.is_initialized() else (
        len(ranks) if ranks is not None else 1)
    if tp is None:
        if n % dp != 0:
            raise ValueError(f"{n} devices not divisible by dp={dp}")
        tp = n // dp
    if dp * tp > n:
        raise ValueError(f"dp*tp = {dp}*{tp} > {n} devices")
    return build_mesh({AXIS_DP: dp, AXIS_TP: tp}, ranks, device)


def sharded_token_logprobs(logits: torch.Tensor, targets: torch.Tensor, axis: Axis) -> torch.Tensor:
    """log softmax(logits)[target] over vocab-sharded (B, V_local) logits
    (the tp analogue of ``sampler.token_logprobs``): the local maxima
    gathered for the global max, the local sums of exp summed, and the
    target's logit taken from the shard that owns its index. -> (B,) f32."""
    logits = logits.to(torch.float32)
    vloc = logits.shape[-1]
    m = axis.gather(torch.amax(logits, dim=-1)[None], 0).amax(dim=0)  # (B,)
    se = axis.all_reduce(torch.sum(torch.exp(logits - m[:, None]), dim=-1))
    lse = m + torch.log(se)
    loc_t = targets.to(torch.int64) - axis.index * vloc
    in_shard = (loc_t >= 0) & (loc_t < vloc)
    tl = torch.gather(logits, -1, torch.clamp(loc_t, 0, vloc - 1)[:, None])[:, 0]
    tl = axis.all_reduce(torch.where(in_shard, tl, torch.zeros_like(tl)))
    return tl - lse


def sharded_argmax(logits: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Greedy token over vocab-sharded (B, V_local) logits: each shard's
    argmax and its value, gathered in one (tp, 2, B) f64 all-reduce (f32
    values and int32 indices are exact in f64), then the first shard
    holding the largest value wins, so ties go to the first occurrence as
    a full-vocab argmax gives it. -> (B,) int32."""
    vloc = logits.shape[-1]
    loc_idx = torch.argmax(logits, dim=-1)
    loc_val = torch.gather(logits, -1, loc_idx[:, None])[:, 0]
    mine = torch.stack([loc_val.to(torch.float64),
                        (loc_idx + axis.index * vloc).to(torch.float64)])  # (2, B)
    both = axis.gather(mine[None], 0)  # (tp, 2, B)
    winner = torch.argmax(both[:, 0], dim=0)  # (B,): the first shard of the max
    return torch.gather(both[:, 1], 0, winner[None])[0].to(torch.int32)
