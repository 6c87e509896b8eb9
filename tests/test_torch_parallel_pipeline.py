"""Pipeline parallelism of the port (``xalm_tpu_torch/parallel/
pipeline.py``) against the JAX ``PipelinedEngine``.

One world of 4 gloo ranks on the CPU (``tests/torch_parallel_world.py``)
runs every case once; each test holds a case against the JAX
``PipelinedEngine`` on the same mesh of the 8-device virtual CPU mesh, on
the same tiny 4-layer f32 container and prompts: logits within rtol 2e-4
and atol 2e-4, greedy tokens equal. The cases are
``tests/test_pipeline.py``'s and the pp=2 half of
``tests/test_families_sharded.py``, with the refusals of the JAX engine
(sampling, MoE with tp) and its perplexity over a wrapped ring (the
JAX engine's per-token steps; the port's log-prob scan).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.make_tiny_model import make_tiny_model
from tests.test_gemma2 import GEMMA2_OVERRIDES
from tests.test_mixtral import MIXTRAL_OVERRIDES
from tests.test_qwen3 import QWEN3_OVERRIDES
from tests.torch_parallel_world import run_world
from xalm_tpu.convert import convert as cvt
from xalm_tpu.parallel.pipeline import PipelinedEngine as JaxPipelined
from xalm_tpu.parallel.pipeline import make_pp_mesh as jax_pp_mesh
from xalm_tpu.runtime.engine import Engine as JaxEngine

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

TOKENS = [1, 259, 260, 10, 20, 300, 5, 77, 261, 262, 263, 264, 8, 9]
TOL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = {"mistral": {}, "gemma2": GEMMA2_OVERRIDES, "qwen3": QWEN3_OVERRIDES}
PPL_TOKENS = np.random.default_rng(7).integers(3, 350, size=40).tolist()


def _container(tmp_path_factory, name, overrides):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / name), config_overrides=overrides)
    out = str(tmp_path_factory.mktemp("x") / f"{name}.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "f32"]) == 0
    return out


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    m = {"tiny4": _container(tmp_path_factory, "tiny4", {"num_hidden_layers": 4})}
    for fam, ov in FAMILIES.items():
        m[fam] = _container(tmp_path_factory, f"{fam}_pp", dict(ov) or None)
    m["mixtral"] = _container(tmp_path_factory, "mixtral", MIXTRAL_OVERRIDES)
    return m


def _cases(m):
    t4, f32 = m["tiny4"], dict(kv="f32")
    cases = [dict(name=f"prefill_pp{pp}", kind="prefill", model=t4, mesh=dict(pp=pp),
                  engine=f32, args=dict(tokens=TOKENS, mode="all")) for pp in (2, 4)]
    cases += [
        dict(name="generate_pp2", kind="generate", model=t4, mesh=dict(pp=2),
             args=dict(prompt=TOKENS[:5], n=12, kw=dict(segment=4))),
        dict(name="generate_pp4_seg1", kind="generate", model=t4, mesh=dict(pp=4),
             args=dict(prompt=TOKENS[:4], n=9, kw=dict(segment=1))),
        dict(name="generate_pp4_seg3", kind="generate", model=t4, mesh=dict(pp=4),
             args=dict(prompt=TOKENS[:4], n=9, kw=dict(segment=3))),
        dict(name="int8_cache", kind="generate", model=t4, mesh=dict(pp=2),
             engine=dict(kv="i8"), args=dict(prompt=TOKENS[:5], n=8, kw=dict(segment=1))),
        dict(name="pp3", kind="construct", model=t4, mesh=dict(pp=3)),
        dict(name="shapes_pp4", kind="shapes", model=t4, mesh=dict(pp=4), per_rank=True),
        dict(name="shapes_pp2tp2", kind="shapes", model=t4, mesh=dict(pp=2, tp=2),
             per_rank=True),
        dict(name="prefill_pp2tp2", kind="prefill", model=t4, mesh=dict(pp=2, tp=2),
             engine=f32, args=dict(tokens=TOKENS, mode="all")),
        dict(name="generate_pp2tp2", kind="generate", model=t4, mesh=dict(pp=2, tp=2),
             args=dict(prompt=TOKENS[:5], n=10, kw=dict(segment=5))),
        dict(name="sampled", kind="generate", model=t4, mesh=dict(pp=2),
             args=dict(prompt=TOKENS[:5], n=4, kw=dict(temperature=0.9))),
        dict(name="moe_tp", kind="construct", model=m["mixtral"], mesh=dict(pp=2, tp=2)),
        dict(name="moe_pp2", kind="prefill", model=m["mixtral"], mesh=dict(pp=2), engine=f32,
             args=dict(tokens=TOKENS, mode="all")),
        dict(name="moe_pp2_generate", kind="generate", model=m["mixtral"], mesh=dict(pp=2),
             engine=f32, args=dict(prompt=TOKENS[:5], n=8, kw=dict(segment=4))),
        dict(name="spec", kind="spec", model=t4, mesh=dict(pp=2)),
        dict(name="wrapped_ppl", kind="perplexity", model=t4, mesh=dict(pp=2),
             engine=dict(context=16), args=dict(tokens=PPL_TOKENS)),
        dict(name="collectives_pp2", kind="collectives", model=t4, mesh=dict(pp=2),
             args=dict(batch=1, n=3)),
    ]
    cases += [dict(name=f"{fam}_pp2", kind="prefill", model=m[fam], mesh=dict(pp=2), engine=f32,
                   args=dict(tokens=TOKENS, mode="all")) for fam in FAMILIES]
    return cases


@pytest.fixture(scope="module")
def world(models, tmp_path_factory):
    return run_world(_cases(models), 4, tmp_path_factory.mktemp("world"))


def _ok(world, name):
    r = world[name]
    assert "traceback" not in r, r.get("traceback")
    return r


def _jax(path, pp=2, tp=1, **kw):
    return JaxPipelined.from_xalm(path, jax_pp_mesh(pp, tp=tp), **kw)


def _prefill_all(eng):
    return np.asarray(eng.prefill(TOKENS, eng.new_cache(1), logits_mode="all")[0])


@pytest.mark.parametrize("pp", [2, 4])
def test_pp_prefill_matches_jax(world, models, pp):
    want = _prefill_all(_jax(models["tiny4"], pp, kv_dtype=jnp.float32))
    np.testing.assert_allclose(_ok(world, f"prefill_pp{pp}")["logits"], want, **TOL)


def test_pp_generate_matches_jax(world, models):
    want, _ = _jax(models["tiny4"]).generate(TOKENS[:5], 12, stop_on_eos=False, segment=4)
    assert _ok(world, "generate_pp2")["tokens"][0] == want


def test_pp_decode_scan_matches_stepwise(world):
    a = _ok(world, "generate_pp4_seg1")["tokens"][0]
    assert a == _ok(world, "generate_pp4_seg3")["tokens"][0] and len(a) == 9


def test_pp_quantized_cache(world, models):
    """int8 KV quantization noise can flip late tokens on a tiny random
    model; the first few greedy tokens must agree (the JAX test's rule)."""
    ref = JaxEngine.from_xalm(models["tiny4"], kv_dtype=jnp.float32)
    want, _ = ref.generate(TOKENS[:5], 8, stop_on_eos=False, segment=1)
    assert _ok(world, "int8_cache")["tokens"][0][:4] == want[:4]


def test_pp_validates_divisibility(world):
    got = _ok(world, "pp3")
    assert got["raised"] == "ValueError" and "n_layers" in got["message"]


def test_pp_cache_and_weights_are_layer_sharded(world):
    for rank, r in world["shapes_pp4"].items():
        assert r["wqkv"][0] == r["cache"][0] == 1  # L/pp layers local
        assert r["coords"] == {"pp": rank} and r["wcls"] == (384, 64)  # whole head
    for rank, r in world["shapes_pp2tp2"].items():
        assert r["coords"] == {"pp": rank // 2, "tp": rank % 2}
        assert r["wqkv"][:2] == (2, 64) and r["cache"][:3] == (2, 1, 1)


def test_pp_tp_composed(world, models):
    want = _prefill_all(_jax(models["tiny4"], 2, 2, kv_dtype=jnp.float32))
    np.testing.assert_allclose(_ok(world, "prefill_pp2tp2")["logits"], want, **TOL)
    b, _ = _jax(models["tiny4"], 2, 2).generate(TOKENS[:5], 10, stop_on_eos=False, segment=5)
    assert _ok(world, "generate_pp2tp2")["tokens"][0] == b


def test_pp_refuses_sampling_and_moe_tp(world):
    """As the JAX engine: no sampled scan under pp, and MoE with tp > 1
    refused by name (its expert stacks are not tp-split within a stage)."""
    err = world["sampled"]["error"]
    assert err.startswith("NotImplementedError") and "stochastic sampling" in err
    got = _ok(world, "moe_tp")
    assert got["raised"] == "NotImplementedError" and "MoE + tp" in got["message"]


def test_pp_moe_matches_jax(world, models):
    """Mixtral at pp=2: each stage's 2 layers of the 4 experts; a decode
    step gathers the chosen experts with the stage's own layer index (the
    JAX pp engine runs them dense on its XLA path: the same function)."""
    eng = _jax(models["mixtral"], kv_dtype=jnp.float32)
    np.testing.assert_allclose(_ok(world, "moe_pp2")["logits"], _prefill_all(eng), **TOL)
    want, _ = eng.generate(TOKENS[:5], 8, stop_on_eos=False, segment=4)
    assert _ok(world, "moe_pp2_generate")["tokens"][0] == want


def test_spec_refuses_a_sharded_engine(world):
    """Speculative decoding is single-device, as the JAX forward asserts."""
    err = world["spec"]["error"]
    assert err.startswith("NotImplementedError") and "PipelinedEngine is sharded" in err


def test_pp_wrapped_perplexity_matches_jax(world, models):
    """The wrapped tail through the port's log-prob scan under pp, against
    the JAX pp engine, which steps it token by token."""
    p, e, n = _ok(world, "wrapped_ppl")["ppl"]
    pw, ew, nw = _jax(models["tiny4"], context=16).perplexity(PPL_TOKENS)
    assert n == nw == 39
    assert p == pytest.approx(pw, rel=1e-3) and e == pytest.approx(ew, rel=1e-2)


def test_pp_collectives_per_decode_step(world):
    """A pp step broadcasts the residual once a stage ((B, 1, dim) f32 each)
    and issues nothing else (the JAX step: pp ring hops and one psum)."""
    got = _ok(world, "collectives_pp2")
    assert got["step"]["broadcast"] == {"calls": 2, "bytes": 2 * 64 * 4}
    assert got["scan"]["broadcast"] == {"calls": 3 * 2, "bytes": 3 * 2 * 64 * 4}
    assert got["step"]["all_reduce"]["calls"] == got["scan"]["all_reduce"]["calls"] == 0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_pp2_matches_jax(world, models, family):
    want = _prefill_all(_jax(models[family], kv_dtype=jnp.float32))
    np.testing.assert_allclose(_ok(world, f"{family}_pp2")["logits"], want, **TOL)
