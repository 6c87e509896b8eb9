"""Decode sessions: save the KV cache mid-generation and resume from it
(counterpart of ``xalm_tpu/runtime/session.py``), through the xalm v2 block
store (io/blockstore.py): one block per cache plane, the positions, the
token history, and a record of the model config, so that a resume against
another checkpoint fails loudly.

The file is the JAX package's: a session passes between the packages both
ways, with an f16, f32 or int8 cache. A bf16 cache (the port's default on
the card) is stored as its 16-bit patterns under ``"<V2"``, which is what the
JAX writer gives it; the port reads it back as bf16, while the JAX
``load_session`` cannot (its reader rebuilds the dtype as a plain 2-byte
void, which JAX refuses).

``save_session`` writes no content hashes (``hash`` 0, which both readers
accept): hashing costs about 3 s a GB on the host (io/xxh3.py), several
times the write itself. ``write_blocks(path, *session_blocks(cfg, s))``
writes the same file with them, the JAX writer's default.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from xalm_tpu_torch.io.blockstore import BlockStore, to_torch, write_blocks
from xalm_tpu_torch.models.config import ModelConfig
from xalm_tpu_torch.runtime.cache import KVCache

__all__ = ["Session", "save_session", "load_session", "session_blocks"]

_FINGERPRINT_KEYS = ("dim", "hidden_dim", "head_dim", "n_layers", "n_heads", "n_kv_heads",
                     "vocab_size", "max_seq_len")


def _fingerprint(cfg: ModelConfig) -> dict:
    return {k: int(getattr(cfg, k)) for k in _FINGERPRINT_KEYS}


@dataclasses.dataclass
class Session:
    """A paused generation: the cache, each sequence's next absolute
    position (the position of its pending token: emitted, not yet written
    to the cache), and the token ids so far (prompt and output)."""

    cache: KVCache
    pos: np.ndarray  # (B,) int32
    tokens: list[list[int]]


def session_blocks(cfg: ModelConfig, session: Session) -> tuple[dict, dict]:
    """The blocks and the meta of ``session``'s file."""
    tok_lens = np.array([len(t) for t in session.tokens], np.int32)
    flat = np.array([t for seq in session.tokens for t in seq], np.int32)
    cache = session.cache
    blocks = {"kv.k": cache.k, "kv.v": cache.v, "pos": np.asarray(session.pos, np.int32),
              "tokens.lens": tok_lens, "tokens.flat": flat}
    if cache.quantized:
        blocks["kv.k_scale"] = cache.k_scale
        blocks["kv.v_scale"] = cache.v_scale
    return blocks, {"kind": "xalm-session", "config": _fingerprint(cfg)}


def save_session(path: str, cfg: ModelConfig, session: Session) -> None:
    write_blocks(path, *session_blocks(cfg, session), compute_hashes=False)


def load_session(path: str, cfg: ModelConfig, device="cuda") -> Session:
    """Read a session file (the port's or the JAX package's) and put its
    cache on ``device``. Raises ValueError for another model's session and
    for a cache laid out otherwise than ``KVCache.plane_shape``."""
    with BlockStore(path) as bs:
        if bs.meta.get("kind") != "xalm-session":
            raise ValueError(f"{path}: not a session file")
        fp = bs.meta.get("config", {})
        want = _fingerprint(cfg)
        if fp != want:
            diff = {k: (fp.get(k), want[k]) for k in want if fp.get(k) != want[k]}
            raise ValueError(f"{path}: session/model config mismatch: {diff}")
        expect = KVCache.plane_shape(cfg, int(bs.get("pos").shape[0]))
        got_shape = tuple(bs.blocks["kv.k"].shape)
        if got_shape != expect:
            raise ValueError(f"{path}: stale session cache layout {got_shape} != {expect} "
                             f"(re-create the session)")
        planes = {key: to_torch(bs.get(key)).to(device)
                  for key in ("kv.k", "kv.v", "kv.k_scale", "kv.v_scale") if key in bs}
        pos = np.array(bs.get("pos"))
        lens = bs.get("tokens.lens")
        flat = bs.get("tokens.flat")
        tokens, at = [], 0
        for n in lens:
            tokens.append([int(t) for t in flat[at:at + n]])
            at += int(n)
    cache = KVCache(k=planes["kv.k"], v=planes["kv.v"], k_scale=planes.get("kv.k_scale"),
                    v_scale=planes.get("kv.v_scale"))
    return Session(cache=cache, pos=pos, tokens=tokens)
