"""The port's xalm v2 block store (``xalm_tpu_torch/io/blockstore.py``) and
its own XXH3-64 (``io/xxh3.py``) against the JAX package's block store and
the ``xxhash`` package, on the CPU.

The hash must be ``xxhash.xxh3_64`` bit for bit: at every length from 0 to
240 (each short path and its edges) and at long lengths around the 64-byte
stripe and the 1024-byte block, and on arbitrary bytes. Files pass between
the two block stores both ways with every block's bytes equal; the port's
modules import neither ``xxhash`` nor ``ml_dtypes``, which the card's
machine lacks.
"""

import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
import xxhash
from hypothesis import given, settings
from hypothesis import strategies as st

from xalm_tpu.io.blockstore import BlockStore as JaxBlockStore
from xalm_tpu.io.blockstore import write_blocks as jax_write_blocks
from xalm_tpu_torch.io.blockstore import BlockStore, to_torch, write_blocks
from xalm_tpu_torch.io.xxh3 import xxh3_64

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

ROOT = Path(__file__).resolve().parents[1]


def _bytes(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed + n).integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("lo,hi", [(0, 17), (17, 129), (129, 241)])
def test_xxh3_short_inputs_match_xxhash(lo, hi):
    for n in range(lo, hi):
        data = _bytes(n)
        assert xxh3_64(data) == xxhash.xxh3_64(data).intdigest(), n


@pytest.mark.parametrize("n", [241, 255, 256, 320, 1023, 1024, 1025, 1088, 2048, 2049,
                               16 * 1024 + 63, 1 << 20, (1 << 20) + 13])
def test_xxh3_long_inputs_match_xxhash(n):
    data = _bytes(n)
    assert xxh3_64(data) == xxhash.xxh3_64(data).intdigest()
    # a numpy array hashes as its bytes
    assert xxh3_64(np.frombuffer(data, np.uint8)) == xxhash.xxh3_64(data).intdigest()


@settings(max_examples=200, deadline=None, database=None)
@given(st.binary(min_size=0, max_size=3000))
def test_xxh3_matches_xxhash_on_any_bytes(data):
    assert xxh3_64(data) == xxhash.xxh3_64(data).intdigest()


def _blocks():
    rng = np.random.default_rng(7)
    return {
        "a": rng.standard_normal((4, 8)).astype(np.float32),
        "b/nested": np.arange(37, dtype=np.int32),
        "c": rng.integers(-128, 127, size=(3, 5, 7), dtype=np.int8),
        "d": rng.standard_normal((2, 3, 33)).astype(np.float16),
        "empty": np.zeros((0,), np.int32),
    }


def test_port_file_opens_in_jax_and_back(tmp_path):
    blocks = _blocks()
    bf16 = np.random.default_rng(8).standard_normal((5, 9)).astype(ml_dtypes.bfloat16)
    port_path, jax_path = tmp_path / "port.xbk", tmp_path / "jax.xbk"
    write_blocks(port_path, dict(blocks, bf=torch.from_numpy(bf16.view(np.int16)).view(
        torch.bfloat16)), meta={"kind": "test", "n": 3})
    jax_write_blocks(str(jax_path), dict(blocks, bf=bf16), meta={"kind": "test", "n": 3})
    assert port_path.read_bytes() == jax_path.read_bytes()
    for reader in (JaxBlockStore, BlockStore):
        for path in (port_path, jax_path):
            with reader(str(path)) as bs:
                assert bs.meta == {"kind": "test", "n": 3}
                assert list(bs.keys()) == list(blocks) + ["bf"]
                for key, want in blocks.items():
                    got = bs.get(key)
                    assert got.dtype == want.dtype and got.shape == want.shape
                    assert got.tobytes() == want.tobytes()
                    assert bs.verify(key)
                    assert bs.blocks[key].offset % 32 == 0
                assert bs.get("bf").tobytes() == bf16.tobytes() and bs.verify("bf")
                np.testing.assert_array_equal(bs.get(bs.blocks["a"].khash), blocks["a"])
    with BlockStore(jax_path) as bs:  # "<V2" comes back as bf16
        got = to_torch(bs.get("bf"))
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(), bf16.view(np.int16))
        assert to_torch(bs.get("d")).dtype == torch.float16


def test_verify_catches_a_flipped_byte_and_garbage_is_refused(tmp_path):
    path = tmp_path / "x.xbk"
    write_blocks(path, _blocks())
    with BlockStore(path) as bs:
        off = bs.blocks["a"].offset
    raw = bytearray(path.read_bytes())
    raw[off + 3] ^= 0x40
    path.write_bytes(bytes(raw))
    with BlockStore(path) as bs:
        assert not bs.verify("a") and bs.verify("c")
    bad = tmp_path / "bad.xbk"
    bad.write_bytes(b"not a store at all")
    with pytest.raises(ValueError, match="not an xalm v2 block store"):
        BlockStore(bad)


_BLOCKER = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("xxhash", "ml_dtypes", "jax", "xalm_tpu"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, _Block())
"""


def test_modules_need_neither_xxhash_nor_ml_dtypes(tmp_path):
    """With xxhash, ml_dtypes (and JAX) blocked from import, the port's
    block store, container and sessions import, write and read a bf16
    session and a hashed container."""
    code = _BLOCKER + f"""
import numpy as np, torch
from xalm_tpu_torch.io import blockstore, container
from xalm_tpu_torch.runtime import session
from xalm_tpu_torch.runtime.cache import KVCache
from xalm_tpu_torch.models.config import ModelConfig
cfg = ModelConfig(dim=64, hidden_dim=128, head_dim=16, n_layers=2, n_heads=4, n_kv_heads=2,
                  vocab_size=100, max_seq_len=40, rope_theta=10000.0, rotary_dim=16)
cache = KVCache.init(cfg, 1, torch.bfloat16, "cpu")
cache.k.normal_()
s = session.Session(cache=cache, pos=np.array([7], np.int32), tokens=[[1, 2, 3]])
p = {str(tmp_path / 's.xbk')!r}
blockstore.write_blocks(p, *session.session_blocks(cfg, s))  # with content hashes
back = session.load_session(p, cfg, device="cpu")
assert torch.equal(back.cache.k, cache.k) and back.tokens == [[1, 2, 3]]
with blockstore.BlockStore(p) as bs:
    assert all(bs.verify(k) for k in bs.keys())
x = {str(tmp_path / 'c.xalm')!r}
container.write_xalm(x, "LlamaForCausalLM", {{"dim": "64"}},
                     {{"w": np.arange(3000, dtype=np.float32)}}, compute_hashes=True)
with container.XalmFile(x) as xf:
    assert xf.tensors["w"].hash is not None and xf.verify("w")
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stdout + res.stderr
