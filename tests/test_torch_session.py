"""Decode sessions: the port's ``runtime/session.py`` and
``Engine.generate(resume=, return_session=)`` against the JAX package's
on the CPU (tiny i8 model, ``tests/make_tiny_model.py``; f32 compute; both
engines on the reference "xla" arithmetic so that their greedy tokens
agree), with an f16 and an int8 cache.

A session file passes between the packages both ways; a continuation from
one is compared with the other package's own continuation of its own file,
token for token. A bf16 cache (the port's default on the card) does not
load back in the JAX package (its reader rebuilds ml_dtypes' ``"<V2"`` as
a plain 2-byte void, which ``jnp.asarray`` refuses): the port reads the
JAX package's bf16 file, and the JAX ``load_session`` raises on it. Both
sides of that difference are pinned here.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from xalm_tpu.convert import convert as cvt
from xalm_tpu.runtime import session as jax_session
from xalm_tpu.runtime.engine import Engine as JaxEngine
from xalm_tpu_torch.io.blockstore import BlockStore, write_blocks
from xalm_tpu_torch.runtime import session
from xalm_tpu_torch.runtime.engine import Engine

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

CACHES = {"f16": (jnp.float16, torch.float16), "i8": (jnp.int8, torch.int8),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
WINDOW = 16


@pytest.fixture(scope="module")
def tiny_i8(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    out = str(tmp_path_factory.mktemp("x") / "tiny_i8.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "i8"]) == 0
    return out


@functools.lru_cache(maxsize=None)
def _engines(path: str, cache: str, window: int):
    jdt, tdt = CACHES[cache]
    ref = JaxEngine.from_xalm(path, context=window, kv_dtype=jdt, compute_dtype=jnp.float32,
                              progress=False)
    port = Engine.from_xalm(path, context=window, kv_dtype=tdt, compute_dtype=torch.float32,
                            matmul_impl="xla", device="cpu")
    return ref, port


def _prompt(eng):
    return eng.tokenizer.encode("the quick brown fox")


@pytest.mark.parametrize("segment", [1, 4])
@pytest.mark.parametrize("window", [0, WINDOW])
@pytest.mark.parametrize("cache", ["f16", "i8", "bf16"])
def test_resume_equals_the_uninterrupted_run(tiny_i8, tmp_path, cache, window, segment):
    """12 tokens cut after 5, saved, loaded and resumed: the uninterrupted
    run's tokens, and the history the Session carries."""
    _, port = _engines(tiny_i8, cache, window)
    prompt = _prompt(port)
    full, _ = port.generate(prompt, 12, stop_on_eos=False, segment=segment)
    first, _, sess = port.generate(prompt, 5, stop_on_eos=False, segment=segment,
                                   return_session=True)
    path = str(tmp_path / "s.xbk")
    session.save_session(path, port.cfg, sess)
    sess2 = session.load_session(path, port.cfg, device="cpu")
    assert sess2.tokens == sess.tokens and sess2.cache.k.dtype == CACHES[cache][1]
    assert all(torch.equal(a, b) for a, b in zip(sess.cache.planes(), sess2.cache.planes()))
    rest, _, sess3 = port.generate([], 7, stop_on_eos=False, segment=segment, resume=sess2,
                                   return_session=True)
    assert first + rest == full
    assert sess3.tokens[0] == prompt + full


def test_returned_session_is_a_copy(tiny_i8):
    """The engine zeroes its own cache for the next call; the Session's
    planes stay as they were."""
    _, port = _engines(tiny_i8, "f16", 0)
    _, _, sess = port.generate(_prompt(port), 4, stop_on_eos=False, return_session=True)
    kept = sess.cache.k.clone()
    port.generate([1, 5], 3, stop_on_eos=False)
    assert torch.equal(sess.cache.k, kept) and bool(kept.abs().sum() > 0)


@pytest.mark.parametrize("cache", ["f16", "i8"])
def test_sessions_pass_between_the_packages(tiny_i8, tmp_path, cache):
    """A JAX session resumes in the port with the JAX package's own resumed
    tokens, and a port session resumes in the JAX package with the port's."""
    ref, port = _engines(tiny_i8, cache, WINDOW)
    prompt = _prompt(port)
    jfirst, _, jsess = ref.generate(prompt, 10, stop_on_eos=False, segment=1,
                                    return_session=True)
    pfirst, _, psess = port.generate(prompt, 10, stop_on_eos=False, segment=1,
                                     return_session=True)
    assert jfirst == pfirst
    jpath, ppath = str(tmp_path / "jax.xbk"), str(tmp_path / "port.xbk")
    jax_session.save_session(jpath, ref.cfg, jsess)
    session.save_session(ppath, port.cfg, psess)
    jrest, _ = ref.generate([], 10, stop_on_eos=False, segment=1,
                            resume=jax_session.load_session(jpath, ref.cfg))
    prest, _ = port.generate([], 10, stop_on_eos=False, segment=1,
                             resume=session.load_session(ppath, port.cfg, device="cpu"))
    # across: the port resumes the JAX file, the JAX package the port's
    got, _ = port.generate([], 10, stop_on_eos=False, segment=1,
                           resume=session.load_session(jpath, port.cfg, device="cpu"))
    want, _ = ref.generate([], 10, stop_on_eos=False, segment=1,
                           resume=jax_session.load_session(ppath, ref.cfg))
    assert jrest == prest == got == want
    assert len(set(jrest)) > 1  # the continuation is not one token repeated throughout


def test_port_file_equals_the_jax_file_with_hashes(tiny_i8, tmp_path):
    """With content hashes on (the JAX writer's default), the port writes
    the JAX package's bytes for the same session."""
    ref, port = _engines(tiny_i8, "f16", 0)
    _, _, jsess = ref.generate(_prompt(port), 6, stop_on_eos=False, return_session=True)
    jpath, ppath = tmp_path / "jax.xbk", tmp_path / "port.xbk"
    jax_session.save_session(str(jpath), ref.cfg, jsess)
    from xalm_tpu_torch.runtime.cache import KVCache

    psess = session.Session(
        cache=KVCache(torch.from_numpy(np.array(jsess.cache.k)),
                      torch.from_numpy(np.array(jsess.cache.v))),
        pos=np.asarray(jsess.pos), tokens=jsess.tokens)
    write_blocks(str(ppath), *session.session_blocks(port.cfg, psess))
    assert ppath.read_bytes() == jpath.read_bytes()
    session.save_session(str(ppath), port.cfg, psess)
    with BlockStore(ppath) as bs:  # save_session: no content hashes, which verify accepts
        assert all(bs.blocks[k].hash == 0 and bs.verify(k) for k in bs.keys())


def test_bf16_sessions_load_in_the_port_not_in_jax(tiny_i8, tmp_path):
    """The standing difference: the JAX package writes a bf16 session it
    cannot read back; the port resumes it (and its own) with the port's
    uninterrupted tokens, and the JAX reader refuses both files."""
    ref, port = _engines(tiny_i8, "bf16", WINDOW)
    prompt = _prompt(port)
    full, _ = port.generate(prompt, 20, stop_on_eos=False, segment=1)
    _, _, jsess = ref.generate(prompt, 10, stop_on_eos=False, segment=1, return_session=True)
    _, _, psess = port.generate(prompt, 10, stop_on_eos=False, segment=1, return_session=True)
    jpath, ppath = str(tmp_path / "jax.xbk"), str(tmp_path / "port.xbk")
    jax_session.save_session(jpath, ref.cfg, jsess)
    session.save_session(ppath, port.cfg, psess)
    for path in (jpath, ppath):
        with BlockStore(path) as bs:
            assert bs.blocks["kv.k"].dtype.str == "|V2"
        with pytest.raises(TypeError):
            jax_session.load_session(path, ref.cfg)
    loaded = session.load_session(jpath, port.cfg, device="cpu")
    assert loaded.cache.k.dtype == torch.bfloat16
    assert np.array_equal(loaded.cache.k.view(torch.int16).numpy(),
                          np.asarray(jsess.cache.k).view(np.int16))
    for path in (jpath, ppath):
        rest, _ = port.generate([], 10, stop_on_eos=False, segment=1,
                                resume=session.load_session(path, port.cfg, device="cpu"))
        assert full[:10] + rest == full


def test_mismatched_config_and_stale_layout_are_refused(tiny_i8, tmp_path):
    _, port = _engines(tiny_i8, "f16", 0)
    _, _, sess = port.generate(_prompt(port), 2, stop_on_eos=False, return_session=True)
    path = str(tmp_path / "s.xbk")
    session.save_session(path, port.cfg, sess)
    other = dataclasses.replace(port.cfg, n_layers=port.cfg.n_layers + 1)
    with pytest.raises(ValueError, match="mismatch"):
        session.load_session(path, other, device="cpu")
    # a cache padded to 8 rows (the layout before 32-row tiles)
    stale = str(tmp_path / "stale.xbk")
    shape = list(sess.cache.k.shape)
    shape[3] = (port.cfg.max_seq_len + 7) // 8 * 8 + 8
    with BlockStore(path) as bs:
        blocks = {k: np.array(bs.get(k)) for k in bs.keys()}
        meta = bs.meta
    blocks["kv.k"] = blocks["kv.v"] = np.zeros(shape, np.float16)
    write_blocks(stale, blocks, meta=meta)
    with pytest.raises(ValueError, match="stale session cache layout"):
        session.load_session(stale, port.cfg, device="cpu")
    with pytest.raises(ValueError, match="stale session cache layout"):
        jax_session.load_session(stale, _engines(tiny_i8, "f16", 0)[0].cfg)


@pytest.mark.parametrize("cache", ["f16", "i8"])
def test_resume_after_the_wrap_with_segments(tiny_i8, tmp_path, cache):
    """Saved at 20 tokens, well past the 16-slot window, with segments of
    8: the port's resumed run equals its uninterrupted one and the JAX
    package's (the session's steps near and past the wrap go one at a time
    when EOS can stop the run, so no step past EOS overwrites live rows)."""
    ref, port = _engines(tiny_i8, cache, WINDOW)
    prompt = port.tokenizer.encode("a b c d e f")
    full, _ = port.generate(prompt, 30, stop_on_eos=False, segment=1)
    jfull, _ = ref.generate(prompt, 30, stop_on_eos=False, segment=1)
    first, _, sess = port.generate(prompt, 20, stop_on_eos=False, segment=8,
                                   return_session=True)
    path = str(tmp_path / "s.xbk")
    session.save_session(path, port.cfg, sess)
    rest, _ = port.generate([], 10, stop_on_eos=False, segment=1,
                            resume=session.load_session(path, port.cfg, device="cpu"))
    assert first + rest == full == jfull


def test_eos_near_the_wrap_steps_one_token_at_a_time(tiny_i8, monkeypatch):
    """With return_session and EOS able to stop the run, a segment that
    would cross the window's edge shrinks to one step (the JAX seg_n rule);
    without either, segments stay whole."""
    _, port = _engines(tiny_i8, "f16", WINDOW)
    calls = []
    real = port._run

    def spy(st, graph, n):
        calls.append(n)
        return real(st, graph, n)

    monkeypatch.setattr(port, "_run", spy)
    prompt = port.tokenizer.encode("a b c d e f")
    port.generate(prompt, 20, stop_on_eos=True, segment=8, return_session=True)
    assert calls and all(n == 1 for n in calls[1:])
    calls.clear()
    port.generate(prompt, 20, stop_on_eos=False, segment=8, return_session=True)
    assert calls[0] == 8
