"""Port weights against the JAX package: container reading, the fused
device layouts, and the weights carry-across function. Every comparison is
bit-exact: loading only copies, stacks and interleaves stored values."""

import jax
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from xalm_tpu.convert import convert as cvt
from xalm_tpu.io import XalmFile as JaxXalmFile
from xalm_tpu.models.config import ModelConfig as JaxConfig
from xalm_tpu.models.params import load_params as jax_load_params
from xalm_tpu.tokenizer import Tokenizer as JaxTokenizer
from xalm_tpu_torch import dtypes as tdt
from xalm_tpu_torch.io import XalmFile, write_xalm
from xalm_tpu_torch.models.config import ModelConfig
from xalm_tpu_torch.models.params import (
    ffn_chunk,
    from_jax_params,
    fuse_qkv,
    fuse_w13,
    load_params,
    split_qkv_rows,
    split_w13_rows,
)
from xalm_tpu_torch.tokenizer import Tokenizer

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

TYPES = ["f32", "f16", "i8", "q8"]


@pytest.fixture(scope="module")
def containers(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    d = tmp_path_factory.mktemp("x")
    out = {}
    for t in TYPES:
        out[t] = str(d / f"tiny_{t}.xalm")
        assert cvt.main(["--input", hf, "--output", out[t], "--type", t]) == 0
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _leaves(p):
    """(name, values) pairs of a port or JAX ModelParams (same field names)."""
    lp = p.layers
    out = [("attn_norm", lp.attn_norm), ("mlp_norm", lp.mlp_norm), ("out_norm", p.out_norm)]
    # the family planes (Qwen2 bias, Qwen3 q/k norms): None for this Mistral model
    out += [(n, getattr(lp, n)) for n in ("bqkv", "q_norm", "k_norm")]
    for name, w in [("embed", p.embed), ("wqkv", lp.wqkv), ("wo", lp.wo),
                    ("w13", lp.w13), ("w2", lp.w2), ("wcls", p.wcls)]:
        out.append((name, w.values))
        out.append((name + ".scale", w.scale))
    return out


@pytest.mark.parametrize("tname", TYPES)
def test_load_params_bit_equal_to_jax(containers, tname):
    with XalmFile(containers[tname]) as xf:
        cfg = ModelConfig.from_metadata(xf.config)
        port = load_params(xf, cfg, device="cpu")
    jf = JaxXalmFile(containers[tname])
    ref = jax_load_params(jf, JaxConfig.from_metadata(jf.config))
    jf.close()
    for (name, got), (_, want) in zip(_leaves(port), _leaves(ref)):
        if want is None:
            assert got is None, name
            continue
        want = _jnp(want)
        assert tuple(got.shape) == want.shape, name
        assert _np(got).dtype.itemsize == want.dtype.itemsize, name
        np.testing.assert_array_equal(_np(got), want, err_msg=f"{tname} {name}")


@pytest.mark.parametrize("tname", ["f32", "i8"])
def test_from_jax_params_round_trip(containers, tname):
    jf = JaxXalmFile(containers[tname])
    ref = jax_load_params(jf, JaxConfig.from_metadata(jf.config))
    jf.close()
    tree = jax.tree.map(np.asarray, ref)
    port = from_jax_params(tree, device="cpu")
    for (name, got), (_, want) in zip(_leaves(port), _leaves(tree)):
        if want is None:
            assert got is None, name
            continue
        np.testing.assert_array_equal(_np(got), _jnp(want), err_msg=name)


def test_bf16_weights_round_trip_through_jax_tree():
    """bf16 (ml_dtypes) leaves carry across as raw bits."""
    from xalm_tpu.utils.synthetic import synthetic_params
    import jax.numpy as jnp
    from xalm_tpu.models.config import ModelConfig as JC

    cfg = JC(dim=32, hidden_dim=64, head_dim=8, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=40, max_seq_len=16, rope_theta=1e4, rotary_dim=8, act="silu")
    tree = jax.tree.map(np.asarray, synthetic_params(cfg, weight_dtype=jnp.int8))
    port = from_jax_params(tree, device="cpu")
    assert port.embed.values.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(port.embed.values), _jnp(tree.embed.values))
    np.testing.assert_array_equal(_np(port.layers.wqkv.values), _jnp(tree.layers.wqkv.values))


def test_fused_layout_helpers_invert():
    rng = np.random.default_rng(0)
    l, kh, g, hd, d, h = 2, 2, 3, 4, 5, 64
    wq = rng.normal(size=(l, kh * g * hd, d)).astype(np.float32)
    wk = rng.normal(size=(l, kh * hd, d)).astype(np.float32)
    wv = rng.normal(size=(l, kh * hd, d)).astype(np.float32)
    fused = torch.from_numpy(fuse_qkv(wq, wk, wv, kh))
    q, k, v = split_qkv_rows(fused.transpose(1, 2), kh, g, hd)
    np.testing.assert_array_equal(q.transpose(1, 2).numpy(), wq)
    np.testing.assert_array_equal(k.transpose(1, 2).numpy(), wk)
    np.testing.assert_array_equal(v.transpose(1, 2).numpy(), wv)
    w1 = rng.normal(size=(l, h, d)).astype(np.float32)
    w3 = rng.normal(size=(l, h, d)).astype(np.float32)
    c = ffn_chunk(h)
    gate, up = split_w13_rows(torch.from_numpy(fuse_w13(w1, w3, c)).transpose(1, 2), c)
    np.testing.assert_array_equal(gate.transpose(1, 2).numpy(), w1)
    np.testing.assert_array_equal(up.transpose(1, 2).numpy(), w3)
    assert ffn_chunk(14336) == 128 and ffn_chunk(11008) == 32


def test_write_xalm_read_by_jax(tmp_path):
    """A container the port writes (bf16 from torch, i8 + scale) reads back
    identically through the JAX package's reader."""
    rng = np.random.default_rng(1)
    bf = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)).to(torch.bfloat16)
    i8 = rng.integers(-127, 128, size=(4, 6)).astype(np.int8)
    sc = rng.random(4).astype(np.float32)
    f16 = rng.normal(size=(7,)).astype(np.float16)
    path = str(tmp_path / "w.xalm")
    write_xalm(path, "MistralForCausalLM", {"dim": "5"},
               {"a": bf, "b": i8, "b.scale": sc, "c": f16})
    jf = JaxXalmFile(path)
    assert jf.tensors["a"].dtype.name == "bf16" and jf.tensors["b"].dtype.name == "i8"
    np.testing.assert_array_equal(_jnp(jf.load("a")), bf.view(torch.int16).numpy())
    np.testing.assert_array_equal(jf.load("b"), i8)
    np.testing.assert_array_equal(jf.load("c"), f16)
    jf.close()
    with XalmFile(path) as xf:
        assert torch.equal(xf.load_torch("a"), bf)
        np.testing.assert_array_equal(xf.load("b.scale"), sc)


def test_unknown_container_types_are_refused():
    # "q4" is no container type: a q4 container stores its packed tensors as
    # q8-typed int8 with a .scale4 partner (tests/test_torch_q4.py loads one)
    for name in ("nope", "q4"):
        with pytest.raises(ValueError):
            tdt.parse(name)


def test_tokenizer_matches_jax(containers):
    texts = ["hello world", "the quick brown fox jumps over the lazy dog",
             "pass key is 12345. what?", "unseen bytes: é中"]
    with XalmFile(containers["f16"]) as xf:
        tok = Tokenizer.from_xalm(xf)
    jf = JaxXalmFile(containers["f16"])
    ref = JaxTokenizer.from_xalm(jf)
    jf.close()
    for t in texts:
        ids = tok.encode(t)
        assert ids == ref.encode(t), t
        assert tok.decode(ids) == ref.decode(ids)


def test_entry_points_default_to_the_card():
    """The port's entry points put weights, caches and runs on the card
    unless the caller asks for the CPU (``load_params`` and ``KVCache.init``
    defaulted to the CPU before)."""
    import inspect

    from xalm_tpu_torch.harness import main as harness
    from xalm_tpu_torch.runtime.cache import KVCache
    from xalm_tpu_torch.runtime.engine import Engine
    from xalm_tpu_torch.utils.synthetic import synthetic_params

    for fn in (load_params, KVCache.init, Engine.from_xalm, synthetic_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert harness._build_parser().parse_args(["m.xalm"]).device == "cuda"


def test_from_jax_params_defaults_to_the_card():
    """``from_jax_params`` puts the carried weights on the card unless the
    caller asks for the CPU, as ``load_params`` does; with ``device="cpu"``
    every tensor lies there."""
    import inspect

    from xalm_tpu.utils.synthetic import synthetic_params
    import jax.numpy as jnp
    from xalm_tpu.models.config import ModelConfig as JC

    assert inspect.signature(from_jax_params).parameters["device"].default == "cuda"
    cfg = JC(dim=32, hidden_dim=64, head_dim=8, n_layers=1, n_heads=4, n_kv_heads=2,
             vocab_size=40, max_seq_len=16, rope_theta=1e4, rotary_dim=8, act="silu")
    tree = jax.tree.map(np.asarray, synthetic_params(cfg, weight_dtype=jnp.int8))
    port = from_jax_params(tree, device="cpu")
    assert port.embed.values.device.type == port.layers.wqkv.values.device.type == "cpu"
