"""Tensor, data and expert parallelism of the port (``xalm_tpu_torch/
parallel/``) against the JAX ``ShardedEngine``.

One world of 8 gloo ranks on the CPU (``tests/torch_parallel_world.py``)
runs every case once; each test then holds a case against the JAX
``ShardedEngine`` on the same mesh of the 8-device virtual CPU mesh
(``tests/conftest.py``), on the same tiny f32 container (converted by the
JAX converter) and the same prompts. Logits within rtol 2e-4 and atol
2e-4, the JAX tests' own bar; greedy tokens equal; sampled tokens equal to
the JAX engine's on the same seed (the port's threefry is the JAX one
bit for bit, and the logits agree far inside a draw's margin).

The cases are the JAX package's (``tests/test_sharding.py``, the tp=2 half
of ``tests/test_families_sharded.py``, ``tests/test_scaling_model.py``'s
collective counts), Mixtral expert parallelism at tp=2, and the shards
themselves against the JAX ``shard_params``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from tests.test_gemma import GEMMA_OVERRIDES
from tests.test_gemma2 import GEMMA2_OVERRIDES
from tests.test_mixtral import MIXTRAL_OVERRIDES
from tests.test_phi3 import PHI3_OVERRIDES
from tests.test_qwen2 import QWEN2_OVERRIDES
from tests.test_qwen3 import QWEN3_OVERRIDES
from tests.torch_parallel_world import run_world
from xalm_tpu.convert import convert as cvt
from xalm_tpu.parallel.mesh import make_mesh as jax_mesh
from xalm_tpu.parallel.sharded_engine import ShardedEngine as JaxSharded
from xalm_tpu_torch.parallel.mesh import Mesh

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

TOKENS = [1, 259, 260, 10, 20, 300, 5, 77, 261, 262]
TOL = dict(rtol=2e-4, atol=2e-4)
MESHES = [(1, 2), (2, 2), (4, 2)]
FAMILIES = {
    "mistral": {},
    "gemma": dict(GEMMA_OVERRIDES, head_dim=16),  # tp=2 needs n_kv_heads divisible
    "gemma2": GEMMA2_OVERRIDES,
    "qwen2": QWEN2_OVERRIDES,
    "qwen3": QWEN3_OVERRIDES,
    "phi3": PHI3_OVERRIDES,
}
WRAP_TOKENS = np.random.default_rng(0).integers(3, 350, size=40).tolist()
PAD_PROMPT = np.random.default_rng(4).integers(3, 350, size=6).tolist()
PPL_TOKENS = np.random.default_rng(7).integers(3, 350, size=48).tolist()
LONG_PROMPT = np.random.default_rng(11).integers(3, 350, size=1100).tolist()
A8_PROMPT = np.random.default_rng(4).integers(3, 350, size=300).tolist()
MOE_TOKENS = [1, 259, 260, 10, 20, 300, 5, 77, 261, 262, 263, 264, 8, 9, 1, 2, 33]


def _container(tmp_path_factory, name, overrides=None, kind="f32"):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / name),
                         config_overrides=overrides or None)
    out = str(tmp_path_factory.mktemp("x") / f"{name}.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", kind]) == 0
    return out


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    m = {f: _container(tmp_path_factory, f, ov) for f, ov in FAMILIES.items()}
    m["i8"] = _container(tmp_path_factory, "tiny_i8", kind="i8")
    m["mixtral"] = _container(tmp_path_factory, "mixtral", MIXTRAL_OVERRIDES)
    return m


def _cases(m):
    tiny = m["mistral"]
    cases = [dict(name=f"step_{dp}x{tp}", kind="step", model=tiny, mesh=dict(dp=dp, tp=tp),
                  args=dict(tokens=[TOKENS] * dp)) for dp, tp in MESHES]
    cases += [
        dict(name="tp_over_kv_heads", kind="construct", model=tiny, mesh=dict(dp=2, tp=4)),
        dict(name="scan_4x2", kind="step_then_scan", model=tiny, mesh=dict(dp=4, tp=2),
             args=dict(tokens=[TOKENS[:5]] * 4, n=5)),
        dict(name="ring_wrap", kind="decode_steps", model=tiny, mesh=dict(tp=2),
             engine=dict(context=16), args=dict(tokens=WRAP_TOKENS)),
        dict(name="dp_padding", kind="generate", model=tiny, mesh=dict(dp=2, tp=2),
             args=dict(prompt=PAD_PROMPT, n=7)),
        dict(name="wrapped_ppl", kind="perplexity", model=tiny, mesh=dict(tp=2),
             engine=dict(context=16), args=dict(tokens=PPL_TOKENS)),
        dict(name="long_prefill", kind="prefill", model=tiny, mesh=dict(dp=2, tp=2),
             engine=dict(context=2048), args=dict(tokens=LONG_PROMPT, mode="last")),
        dict(name="a8_off", kind="prefill", model=m["i8"], mesh=dict(tp=2),
             engine=dict(context=1024), args=dict(tokens=A8_PROMPT, mode="last")),
        dict(name="a8_on", kind="prefill", model=m["i8"], mesh=dict(tp=2),
             engine=dict(context=1024, a8_prefill=True), args=dict(tokens=A8_PROMPT, mode="last")),
        dict(name="sample_scan", kind="sample_scan", model=tiny, mesh=dict(dp=2, tp=2),
             args=dict(tokens=[TOKENS[0]] * 2, seed=11, n=12, temp=1.2)),
        dict(name="generate_sampled", kind="generate", model=tiny, mesh=dict(tp=2),
             args=dict(prompt=[1, 259, 260], n=8, times=2, kw=dict(temperature=0.9, seed=5))),
        dict(name="generate_sampled_dp", kind="generate", model=tiny, mesh=dict(dp=2, tp=2),
             args=dict(prompt=[1, 259, 260], n=8, kw=dict(temperature=0.9, seed=5))),
        dict(name="shapes", kind="shapes", model=tiny, mesh=dict(dp=2, tp=2), per_rank=True,
             args=dict(batch=3)),
        dict(name="copy_lane", kind="copy_lane", model=tiny, mesh=dict(dp=2, tp=2),
             args=dict(batch=4, src=0, dst=3, tokens=TOKENS, next=77)),
        dict(name="moe_prefill", kind="prefill", model=m["mixtral"], mesh=dict(tp=2),
             engine=dict(kv="f32"), args=dict(tokens=MOE_TOKENS, mode="all")),
        dict(name="moe_generate", kind="generate", model=m["mixtral"], mesh=dict(tp=2),
             engine=dict(kv="f32"), args=dict(prompt=MOE_TOKENS[:5], n=8)),
    ]
    for mesh, batch in (((1, 2), 1), ((2, 2), 2), ((2, 1), 2)):
        cases.append(dict(name=f"collectives_{mesh[0]}x{mesh[1]}", kind="collectives",
                          model=tiny, mesh=dict(dp=mesh[0], tp=mesh[1]),
                          args=dict(batch=batch, n=4)))
    for fam in FAMILIES:
        cases += [
            dict(name=f"{fam}_prefill", kind="prefill", model=m[fam], mesh=dict(tp=2),
                 engine=dict(kv="f32"), args=dict(tokens=TOKENS, mode="all")),
            dict(name=f"{fam}_generate", kind="generate", model=m[fam], mesh=dict(tp=2),
                 engine=dict(kv="f32"), args=dict(prompt=TOKENS[:5], n=8, kw=dict(segment=4))),
        ]
    return cases


@pytest.fixture(scope="module")
def world(models, tmp_path_factory):
    results = run_world(_cases(models), 8, tmp_path_factory.mktemp("world"))
    for name, r in results.items():
        if isinstance(r, dict) and "traceback" in r:
            print(f"--- case {name}:\n{r['traceback']}")
    return results


def _ok(world, name):
    r = world[name]
    assert "traceback" not in r, r.get("traceback")
    return r


def _jax(path, dp=1, tp=2, **kw):
    return JaxSharded.from_xalm(path, jax_mesh(dp=dp, tp=tp), **kw)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_step_matches_jax(world, models, dp, tp):
    got = _ok(world, f"step_{dp}x{tp}")
    eng = _jax(models["mistral"], dp, tp)
    want, _ = eng.step(np.tile(np.array([TOKENS], np.int32), (dp, 1)), np.zeros(dp, np.int32),
                       eng.new_cache(dp), logits_mode="all")
    assert got["logits"].shape == (dp, len(TOKENS), eng.cfg.vocab_size)
    np.testing.assert_allclose(got["logits"], np.asarray(want), **TOL)
    assert got["decode_path"] == f"perlayer (dp={dp} tp={tp})"


def test_tp_over_kv_heads_refused(world):
    got = _ok(world, "tp_over_kv_heads")
    assert got["raised"] == "ValueError" and "kv_heads" in got["message"]


def test_sharded_decode_scan_matches_jax(world, models):
    got = _ok(world, "scan_4x2")
    eng = _jax(models["mistral"], 4, 2)
    toks = np.tile(np.array([TOKENS[:5]], np.int32), (4, 1))
    logits, cache = eng.step(toks, np.zeros(4, np.int32), eng.new_cache(4), logits_mode="last")
    tok0 = np.argmax(np.asarray(logits), -1).astype(np.int32)
    out, _ = eng.decode_scan(tok0, np.full((4,), 5, np.int32), cache, 5)
    np.testing.assert_array_equal(got["tok0"], tok0)
    np.testing.assert_array_equal(got["tokens"], np.asarray(out))


def test_sharded_ring_wrap_matches_jax(world, models):
    got = _ok(world, "ring_wrap")
    eng = _jax(models["mistral"], context=16)
    cache = eng.new_cache(1)
    for i, t in enumerate(WRAP_TOKENS):
        logits, cache = eng.decode(np.array([t]), np.array([i]), cache)
    np.testing.assert_allclose(got["logits"], np.asarray(logits), **TOL)


def test_dp_batch_padding_matches_jax(world, models):
    want, _ = _jax(models["mistral"], 2, 2).generate(PAD_PROMPT, 7, stop_on_eos=False)
    assert _ok(world, "dp_padding")["tokens"][0] == want


def test_sharded_wrapped_perplexity_matches_jax(world, models):
    p, e, n = _ok(world, "wrapped_ppl")["ppl"]
    pw, ew, nw = _jax(models["mistral"], context=16).perplexity(PPL_TOKENS)
    assert n == nw == 47
    assert p == pytest.approx(pw, rel=1e-3)
    assert e == pytest.approx(ew, rel=1e-2)


def test_sharded_scanned_prefill_chunks_match_jax(world, models):
    """Two full 512-token chunks and a tail, on a dp=2 x tp=2 mesh."""
    got = _ok(world, "long_prefill")
    want, _, pos = _jax(models["mistral"], 2, 2, context=2048).prefill(
        LONG_PROMPT, _jax(models["mistral"], 2, 2, context=2048).new_cache(1), logits_mode="last")
    assert got["pos"] == pos == 1100
    np.testing.assert_allclose(got["logits"], np.asarray(want)[:1], **TOL)


def test_sharded_a8_prefill(world, models):
    """W8A8 prefill chunks (300 rows: the int8-activation route) under tp=2:
    close to the bf16-activation sharded run (the JAX test's rule) and to
    the JAX sharded engine's W8A8 run."""
    off, on = _ok(world, "a8_off")["logits"][0], _ok(world, "a8_on")["logits"][0]
    assert np.abs(off - on).max() < 0.35
    assert off.argmax() == on.argmax()
    eng = _jax(models["i8"], matmul_impl="pallas", a8_prefill=True, context=1024)
    want, _, _ = eng.prefill(A8_PROMPT, eng.new_cache(1), logits_mode="last")
    np.testing.assert_allclose(on, np.asarray(want)[0], rtol=2e-2, atol=2e-2)


def test_sharded_sample_scan(world, models):
    """Reproducible by seed, tokens in range, the dp rows decorrelated by the
    dp key fold, and the JAX sharded engine's tokens on the same key."""
    a, b = _ok(world, "sample_scan")["runs"]
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 12) and (a >= 0).all() and (a < 384).all()
    assert not np.array_equal(a[0], a[1])
    eng = _jax(models["mistral"], 2, 2)
    toks = np.array([TOKENS[0]] * 2, np.int32)
    _, cache = eng.step(toks[:, None], np.zeros(2, np.int32), eng.new_cache(2), logits_mode="none")
    want, _ = eng._sample_scan(eng.params, toks, np.ones(2, np.int32), cache,
                               jax.random.PRNGKey(11), n_steps=12, temperature=1.2, top_k=0,
                               top_p=1.0)
    np.testing.assert_array_equal(a, np.asarray(want))


def test_sharded_generate_sampling(world, models):
    a, b = _ok(world, "generate_sampled")["tokens"]
    assert a == b and len(a) == 8
    want, _ = _jax(models["mistral"]).generate([1, 259, 260], 8, stop_on_eos=False,
                                               temperature=0.9, seed=5)
    assert a == want
    # at dp=2 the one row sits on dp rank 0, whose key folds in 0: the same draws
    assert _ok(world, "generate_sampled_dp")["tokens"][0] == want


def test_shard_shapes_per_rank(world):
    """dp=2 x tp=2, a batch of 3 padded to 4: each rank holds half the kv
    heads' wqkv rows, half the vocab rows and 2 rows of 1 kv head."""
    got = world["shapes"]
    assert sorted(got) == [0, 1, 2, 3]
    for rank, r in got.items():
        assert r["coords"] == {"dp": rank // 2, "tp": rank % 2}
        assert r["wqkv"] == (2, 64, 64)  # (L, (G+2)*hd*KH/tp, dim)
        assert r["wcls"] == (192, 64)
        assert r["cache"][1:3] == (2, 1)


def test_copy_lane_across_dp_ranks(world):
    """A lane copied from dp rank 0 onto dp rank 1 attends as its source."""
    logits = _ok(world, "copy_lane")["logits"]
    np.testing.assert_array_equal(logits[3], logits[0])
    assert np.abs(logits[3] - logits[1]).max() > 1e-3


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_shards_match_jax_shard_params(models, dp, tp):
    """The port's shard of every weight equals the JAX shard_params' block
    on the device at the same mesh position: fused wqkv and w13 give one
    contiguous block of rows a rank."""
    from xalm_tpu.io import XalmFile
    from xalm_tpu.models.config import ModelConfig
    from xalm_tpu.models.params import load_params
    from xalm_tpu.parallel.shardings import shard_params as jax_shard
    from xalm_tpu_torch.models.params import from_jax_params
    from xalm_tpu_torch.parallel.shardings import shard_params

    for fam in ("qwen2", "mixtral"):
        xf = XalmFile(models[fam])
        cfg = ModelConfig.from_metadata(xf.config, 0)
        params = load_params(xf, cfg, device_put=False)
        xf.close()
        mesh = jax_mesh(dp=dp, tp=tp)
        sharded = jax_shard(params, cfg, mesh)
        full = from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
        from xalm_tpu_torch.models.config import ModelConfig as TorchConfig
        from xalm_tpu_torch.io import XalmFile as TorchXalm

        with TorchXalm(models[fam]) as txf:
            tcfg = TorchConfig.from_metadata(txf.config, 0)
        flat, _ = jax.tree_util.tree_flatten_with_path(sharded)
        for index, dev in enumerate(mesh.devices.reshape(-1)):
            mine = shard_params(full, tcfg, Mesh.layout({"dp": dp, "tp": tp}, index),
                                device="cpu")
            ours = jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda t: t.numpy(), _as_jax_tree(mine)))[0]
            assert len(ours) == len(flat)
            for (path, arr), (_, got) in zip(flat, ours):
                shard = next(s for s in arr.addressable_shards if s.device == dev)
                np.testing.assert_array_equal(got, np.asarray(shard.data), err_msg=str(path))


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (4, 2)])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_cache_shards_match_jax_shard_cache(dp, tp, quantized):
    """Each rank's block of a cache (rows over dp, kv heads over tp, an int8
    cache's scale planes with them) equals the JAX shard_cache's shard on
    the device of the same mesh index."""
    from xalm_tpu.parallel.shardings import shard_cache as jax_shard_cache
    from xalm_tpu.runtime.cache import KVCache as JaxCache
    from xalm_tpu_torch.models.config import ModelConfig
    from xalm_tpu_torch.parallel.shardings import shard_cache
    from xalm_tpu_torch.runtime.cache import KVCache

    cfg = ModelConfig(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                      vocab_size=64, max_seq_len=32, rope_theta=1e4, rotary_dim=16)
    rng = np.random.default_rng(dp * 10 + tp + quantized)
    shape = (cfg.n_layers, 4, cfg.n_kv_heads, 32, cfg.head_dim)
    if quantized:
        planes = [rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2)]
        planes += [rng.random(shape[:-1]).astype(np.float32) for _ in range(2)]
    else:
        planes = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    mesh = jax_mesh(dp=dp, tp=tp)
    want = jax_shard_cache(JaxCache(*map(jnp.asarray, planes)), cfg, mesh)
    full = KVCache(*map(torch.from_numpy, planes))
    for index, dev in enumerate(mesh.devices.reshape(-1)):
        mine = shard_cache(full, cfg, Mesh.layout({"dp": dp, "tp": tp}, index), device="cpu")
        assert len(mine.planes()) == len(planes)
        for got, arr in zip(mine.planes(), (want.k, want.v, want.k_scale, want.v_scale)):
            shard = next(s for s in arr.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


@pytest.mark.parametrize("spec", [("dp", None), (None, "tp"), ("dp", "tp"), (None, None)])
def test_make_global_blocks_match_jax(spec):
    """``make_global`` (every process passes the full value) keeps this
    rank's block under ``spec``, the JAX make_global's shard on the device
    of the same mesh index; the global shape is the full one."""
    from jax.sharding import PartitionSpec

    from xalm_tpu.parallel.multihost import make_global as jax_make_global
    from xalm_tpu_torch.parallel.multihost import make_global

    full = np.arange(4 * 6, dtype=np.int32).reshape(4, 6)
    mesh = jax_mesh(dp=2, tp=2)
    want = jax_make_global(mesh, PartitionSpec(*spec), full)
    for index, dev in enumerate(mesh.devices.reshape(-1)):
        got = make_global(Mesh.layout({"dp": 2, "tp": 2}, index), spec, full)
        assert got.shape == full.shape and got.spec == spec
        shard = next(s for s in want.addressable_shards if s.device == dev)
        np.testing.assert_array_equal(got.local.numpy(), np.asarray(shard.data))


def _as_jax_tree(p):
    """The port's ModelParams as the JAX ModelParams tree (same fields)."""
    from xalm_tpu.models.params import LayerParams, ModelParams, QWeight

    def qw(w):
        return None if w is None else QWeight(w.values, w.scale)

    lp = p.layers
    layers = LayerParams(**{f.name: (qw(getattr(lp, f.name)) if f.name in (
        "wqkv", "wo", "w13", "w2", "w13e", "w2e") else getattr(lp, f.name))
        for f in dataclasses.fields(LayerParams)})
    return ModelParams(embed=qw(p.embed), layers=layers, out_norm=p.out_norm, wcls=qw(p.wcls))


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "2x1"])
def test_collectives_per_decode_step(world, mesh):
    """The tp decode step issues 2 all-reduces a layer (the row-parallel wo
    and w2 partial sums, each one (B, dim) f32 activation) and one for the
    greedy token (the sharded argmax's (tp, 2, B) f64 gather), and nothing
    else; dp adds none a step: a scan gathers its tokens over dp once at its
    end. (tests/test_scaling_model.py pins the JAX step's HLO the same way.)"""
    got = _ok(world, f"collectives_{mesh}")
    dp, tp = map(int, mesh.split("x"))
    L, n, bl, dim = got["n_layers"], 4, 1, 64
    per_step = (2 * L + 1) if tp > 1 else 0
    per_step_bytes = (2 * L * bl * dim * 4 + tp * 2 * bl * 8) if tp > 1 else 0
    tail = 1 if dp > 1 else 0  # the step's or the scan's one dp gather
    assert got["step"]["all_reduce"]["calls"] == per_step + tail
    assert got["scan"]["all_reduce"]["calls"] == n * per_step + tail
    assert got["scan"]["all_reduce"]["bytes"] == n * per_step_bytes + tail * dp * bl * n * 4
    assert got["step"]["broadcast"]["calls"] == got["scan"]["broadcast"]["calls"] == 0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_tp2_matches_jax(world, models, family):
    got = _ok(world, f"{family}_prefill")
    eng = _jax(models[family], kv_dtype=jnp.float32)
    want, _, _ = eng.prefill(TOKENS, eng.new_cache(1), logits_mode="all")
    np.testing.assert_allclose(got["logits"], np.asarray(want), **TOL)
    b, _ = eng.generate(TOKENS[:5], 8, stop_on_eos=False, segment=4)
    assert _ok(world, f"{family}_generate")["tokens"][0] == b, family


def test_moe_expert_parallel_matches_jax(world, models):
    """Mixtral at tp=2: the router over all experts, each rank its 2 of the
    4 experts dense-masked, the shares summed by the w2 all-reduce."""
    eng = _jax(models["mixtral"], kv_dtype=jnp.float32)
    want, _, _ = eng.prefill(MOE_TOKENS, eng.new_cache(1), logits_mode="all")
    np.testing.assert_allclose(_ok(world, "moe_prefill")["logits"], np.asarray(want), **TOL)
    b, _ = eng.generate(MOE_TOKENS[:5], 8, stop_on_eos=False)
    assert _ok(world, "moe_generate")["tokens"][0] == b


def test_layout_mesh_coordinates():
    """Rank r of a (dp, tp) mesh sits at (r // tp, r % tp), as
    ``np.array(devices).reshape(dp, tp)`` lays the JAX devices out; its
    axes list the ranks of its tp row and dp column."""
    for r in range(8):
        m = Mesh.layout({"dp": 4, "tp": 2}, r)
        assert m.coords() == {"dp": r // 2, "tp": r % 2}
        assert m.axis("tp").ranks == [r // 2 * 2, r // 2 * 2 + 1]
        assert m.axis("dp").ranks == [r % 2 + 2 * d for d in range(4)]
    assert torch.distributed.is_available()
