"""The port's native host components (``xalm_tpu_torch/native.py`` over the
repository's ``native/*.cpp``) and what rides on them:

- ``NativeTrie`` ids equal to the port's Python trie and to the JAX
  tokenizer, on the tiny model's vocabulary and on ``models/xalm-mini``'s
  byte-level one, over ASCII, unicode, byte-fallback and empty texts;
- ``XalmFile.read_stack`` equal to ``np.stack`` of the tensors, through the
  native pool and through the serial copies, and ``prefault``;
- two processes building the library at once both end with a whole
  library, and nothing is left behind;
- ``load_params``' progress calls equal ``load_units`` on every family, and
  ``Engine.from_xalm`` with the native pool loads the same parameters as
  without it;
- without the native library the tokenizer and the loader take their
  Python paths, with the same results.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from tests.test_gemma2 import GEMMA2_OVERRIDES
from tests.test_mixtral import MIXTRAL_OVERRIDES
from tests.test_qwen2 import QWEN2_OVERRIDES
from tests.test_qwen3 import QWEN3_OVERRIDES
from xalm_tpu.convert import convert as jcvt
from xalm_tpu.io.container import XalmFile as JaxXalmFile
from xalm_tpu.tokenizer import Tokenizer as JaxTokenizer
from xalm_tpu_torch import native
from xalm_tpu_torch.convert import convert as pcvt
from xalm_tpu_torch.io import XalmFile
from xalm_tpu_torch.models.config import ModelConfig
from xalm_tpu_torch.models.params import load_params, load_units
from xalm_tpu_torch.runtime.engine import Engine
from xalm_tpu_torch.tokenizer import Tokenizer

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

ROOT = Path(__file__).resolve().parents[1]

TEXTS = [
    "",
    "hello world the quick brown fox jumps over the lazy dog",
    "   leading spaces,\ttabs\nand newlines\n\n",
    "unicode: naïve café — 日本語 テキスト 🚀🚀 ünïcödé",
    "digits 1234567890 and punctuation .,?!;:'\"()[]{}<>",
    "".join(chr(c) for c in range(1, 128)),
]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    out = str(tmp_path_factory.mktemp("x") / "tiny_i8.xalm")
    assert jcvt.main(["--input", hf, "--output", out, "--type", "i8"]) == 0
    return out


def _blob(tokens: list[bytes]) -> np.ndarray:
    return pcvt.tokens_tensor(tokens)


@pytest.fixture(scope="module")
def vocabularies(tiny):
    with XalmFile(tiny) as xf:
        small = np.array(xf.load("tokenizer.tokens"))
    mini = _blob(pcvt.load_tokens(str(ROOT / "models/xalm-mini/tokenizer.json"), 8192))
    return {"tiny": small, "xalm-mini": mini}


def test_native_library_builds_and_loads():
    assert native.load() is not None
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR != ROOT / "native"


@pytest.mark.parametrize("vocab", ["tiny", "xalm-mini"])
@pytest.mark.parametrize("bos", [True, False])
def test_native_trie_ids_equal_python_and_jax(vocabularies, vocab, bos):
    blob = vocabularies[vocab]
    tok = Tokenizer(blob, "1", "2")
    assert tok._native is not None
    jtok = JaxTokenizer(blob, "1", "2")
    rng = np.random.default_rng(0)
    texts = TEXTS + [bytes(rng.integers(0, 256, size=300, dtype=np.uint8))]
    for text in texts:
        data = text.encode("utf-8") if isinstance(text, str) else text
        got = tok.encode(text, bos=bos)
        assert got == tok.encode_python(data, bos=bos) == jtok.encode(text, bos=bos)


def test_native_trie_long_passkey_prompt(vocabularies):
    from xalm_tpu_torch.harness.main import build_passkey_prompt

    tok = Tokenizer(vocabularies["xalm-mini"], "1", "2")
    prompt = build_passkey_prompt(400, 200, 31337)
    assert tok.encode(prompt) == tok.encode_python(prompt.encode())


def _without_native(monkeypatch):
    """Make the native library unavailable, as on a host without ``g++``."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)


def test_tokenizer_without_the_native_library(monkeypatch, vocabularies):
    """Where the library cannot load, ``Tokenizer`` takes the Python trie."""
    _without_native(monkeypatch)
    tok = Tokenizer(vocabularies["tiny"], "1", "2")
    assert tok._native is None
    assert tok.encode(TEXTS[1]) == JaxTokenizer(vocabularies["tiny"], "1", "2").encode(TEXTS[1])


@pytest.mark.parametrize("use_native", [True, False])
def test_read_stack_equals_np_stack(tiny, use_native, monkeypatch):
    if not use_native:
        _without_native(monkeypatch)
    with XalmFile(tiny) as xf:
        groups = {}
        for name, info in xf.tensors.items():
            groups.setdefault((info.shape, info.dtype.name), []).append(name)
        n = 0
        for names in groups.values():
            got = xf.read_stack(names)
            want = np.stack([xf.load(nm) for nm in names])
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
            n += len(names) > 1
        assert n >= 4
        assert (xf._native is not None) == use_native
        xf.prefault()
        with pytest.raises(ValueError):
            xf.read_stack(["l.0.attn.q.weight", "l.0.attn.k.weight"])


def test_native_map_bounds_and_checksum(tmp_path):
    data = np.random.default_rng(3).integers(0, 256, size=3 * 4096 + 17, dtype=np.uint8)
    path = tmp_path / "blob.bin"
    path.write_bytes(data.tobytes())
    nm = native.NativeMap(str(path))
    assert nm.size == data.size
    assert nm.prefault(4) == int(data[::4096].astype(np.uint64).sum())
    out = np.empty(100, np.uint8)
    nm.copy_batch([5000], [100], [out], n_threads=2)
    assert np.array_equal(out, data[5000:5100])
    with pytest.raises(ValueError):
        nm.copy_batch([data.size - 10], [100], [np.empty(100, np.uint8)])
    with pytest.raises(ValueError):
        nm.copy_batch([0], [100], [np.empty(50, np.uint8)])
    nm.close()
    with pytest.raises(RuntimeError):
        native.NativeMap(str(tmp_path / "missing.bin"))


_BUILD_ONE = """
import sys, time
from pathlib import Path
from xalm_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
while time.time() < float(sys.argv[2]):
    time.sleep(0.005)
lib = native.load()
assert lib is not None
trie = native.NativeTrie(b"a\\x00ab\\x00b\\x00", 1, 2)
print(native.library_path(), trie.encode(b"abab", False))
"""


def test_concurrent_first_build_from_two_processes(tmp_path):
    """Two processes build the same library at the same moment into an
    empty directory: each writes its own temporary file and renames it
    into place, so both load a whole library and no temporary remains."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    start = time.time() + 1.0
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(tmp_path), str(start)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = [o.strip() for o, _ in outs]
    assert lines[0] == lines[1] and lines[0].endswith("[1, 1]")
    files = sorted(f.name for f in tmp_path.iterdir())
    assert len(files) == 1 and files[0].endswith(".so"), files


FAMILIES = {"mistral": {}, "mixtral": MIXTRAL_OVERRIDES, "gemma2": GEMMA2_OVERRIDES,
            "qwen2": QWEN2_OVERRIDES, "qwen3": QWEN3_OVERRIDES,
            "tied": {"tie_word_embeddings": True}}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_progress_calls_equal_load_units(tmp_path, family):
    hf = make_tiny_model(str(tmp_path / "hf"), config_overrides=FAMILIES[family])
    out = str(tmp_path / "m.xalm")
    assert jcvt.main(["--input", hf, "--output", out, "--type", "i8"]) == 0
    calls = []
    with XalmFile(out) as xf:
        cfg = ModelConfig.from_metadata(xf.config)
        load_params(xf, cfg, device="cpu", progress=lambda: calls.append(1))
    from xalm_tpu.models.config import ModelConfig as JaxConfig
    from xalm_tpu.models.params import load_units as jax_load_units

    with JaxXalmFile(out) as jf:
        assert load_units(cfg) == jax_load_units(JaxConfig.from_metadata(jf.config))
    assert len(calls) == load_units(cfg)


def _tensors(p, prefix="params"):
    if isinstance(p, torch.Tensor):
        yield prefix, p
    elif dataclasses.is_dataclass(p):
        for f in dataclasses.fields(p):
            yield from _tensors(getattr(p, f.name), f"{prefix}.{f.name}")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as integers of its element size, so equality is bitwise."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def test_engine_loads_the_same_params_with_and_without_the_pool(tiny, capsys, monkeypatch):
    a = Engine.from_xalm(tiny, device="cpu")
    assert native.load() is not None
    assert "loading weights: done" in capsys.readouterr().err
    _without_native(monkeypatch)
    b = Engine.from_xalm(tiny, device="cpu", progress=False)
    assert capsys.readouterr().err == ""
    ta, tb = dict(_tensors(a.params)), dict(_tensors(b.params))
    assert ta.keys() == tb.keys() and len(ta) > 10
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(_bits(ta[k]), _bits(tb[k])), k


def test_chip_smoke_safetensors_writer_reads_back(tmp_path):
    """``chip_smoke.py``'s own writer gives a file the port's reader (and
    the ``safetensors`` package) reads back."""
    import chip_smoke
    import safetensors.torch

    from xalm_tpu_torch.io.safetensors import read_safetensors

    t = {"b": torch.randn(3, 5).bfloat16(), "a": torch.randn(7).bfloat16()}
    path = str(tmp_path / "m.safetensors")
    chip_smoke._write_safetensors(path, t)
    for got in (read_safetensors(path), safetensors.torch.load_file(path)):
        assert set(got) == set(t) and all(torch.equal(got[k], t[k]) for k in t)
    header = json.loads(Path(path).read_bytes()[8:8 + int.from_bytes(
        Path(path).read_bytes()[:8], "little")])
    assert list(header) == ["b", "a"]
