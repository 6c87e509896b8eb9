"""The port's converter (``xalm_tpu_torch/convert``) against the JAX
converter, byte for byte: the same HF checkpoint gives the same ``.xalm``
file (header, tensors, content hashes) for every ``--type`` of
``TARGET_TYPES``, on checkpoints that ``transformers`` saves locally in f32
and in bf16, on every family's tiny checkpoint, for packed q4 at two
groups, and through a GGUF round trip (export from a container, import to a
container) in both directions. ``--analyze`` prints the same table, and
``container_cli --verify`` passes (and fails on a corrupted byte) in both.
The port reads safetensors with its own reader (``io/safetensors.py``).
"""

import contextlib
import filecmp
import io
import json
import shutil

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
from tests.test_rope_scaling import LLAMA3_OVERRIDES
from xalm_tpu.convert import convert as jcvt
from xalm_tpu.convert import gguf_container as jgg
from xalm_tpu.obs import inspect as jins
from xalm_tpu_torch.convert import convert as pcvt
from xalm_tpu_torch.convert import gguf_container as pgg
from xalm_tpu_torch.io.safetensors import read_safetensors
from xalm_tpu_torch.obs import inspect as pins

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

WIDE = {"hidden_size": 256, "intermediate_size": 512, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 64}


def _quiet(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def _both(hf: str, tmp_path, *extra) -> tuple[str, str]:
    """Convert ``hf`` with both converters; the two output paths."""
    a, b = str(tmp_path / "jax.xalm"), str(tmp_path / "port.xalm")
    assert _quiet(jcvt.main, ["--input", hf, "--output", a, *extra])[0] == 0
    assert _quiet(pcvt.main, ["--input", hf, "--output", b, *extra])[0] == 0
    return a, b


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """The tiny Mistral checkpoint saved by ``transformers`` in f32 and bf16."""
    import transformers

    base = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "base"))
    dirs = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = transformers.AutoModelForCausalLM.from_pretrained(base, torch_dtype=dt)
        d = str(tmp_path_factory.mktemp("hf") / name)
        model.save_pretrained(d, safe_serialization=True)
        shutil.copy(f"{base}/tokenizer.json", d)
        dirs[name] = d
    return dirs


@pytest.mark.parametrize("target", pcvt.TARGET_TYPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_every_type_byte_equal(hf_dirs, tmp_path, dtype, target):
    assert pcvt.TARGET_TYPES == jcvt.TARGET_TYPES
    a, b = _both(hf_dirs[dtype], tmp_path, "--type", target)
    assert filecmp.cmp(a, b, shallow=False)


FAMILIES = {"phi3": PHI3_OVERRIDES, "gemma": GEMMA_OVERRIDES, "gemma2": GEMMA2_OVERRIDES,
            "qwen2": QWEN2_OVERRIDES, "qwen3": QWEN3_OVERRIDES, "mixtral": MIXTRAL_OVERRIDES,
            "llama3": LLAMA3_OVERRIDES}


@pytest.mark.parametrize("target", ["i8", "f8_e4m3"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_byte_equal(tmp_path, family, target):
    hf = make_tiny_model(str(tmp_path / "hf"), config_overrides=FAMILIES[family])
    a, b = _both(hf, tmp_path, "--type", target)
    assert filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("group", [128, 256])
def test_q4_byte_equal(tmp_path, group):
    hf = make_tiny_model(str(tmp_path / "hf"), config_overrides=WIDE)
    a, b = _both(hf, tmp_path, "--type", "q4", "--q4-group", str(group))
    assert filecmp.cmp(a, b, shallow=False)
    from xalm_tpu_torch.io import XalmFile

    with XalmFile(b) as xf:  # the body really packed (K/2 bytes and a scale4 partner)
        assert xf.tensors["l.0.mlp.down.weight"].shape == (256, 256)
        assert xf.tensors["l.0.mlp.down.weight.scale4"].shape == (256, 512 // group)


def test_chat_template_carried(hf_dirs, tmp_path):
    hf = str(tmp_path / "hf")
    shutil.copytree(hf_dirs["bf16"], hf)
    with open(f"{hf}/tokenizer_config.json", "w") as f:
        json.dump({"chat_template": "{% for m in messages %}{{ m.content }}{% endfor %}"}, f)
    a, b = _both(hf, tmp_path, "--type", "i8")
    assert filecmp.cmp(a, b, shallow=False)


def test_analyze_prints_the_same_table(hf_dirs, tmp_path):
    outs = []
    for mod, name in ((jcvt, "j"), (pcvt, "p")):
        with np.errstate(all="ignore"):
            rc, out = _quiet(mod.main, ["--input", hf_dirs["f32"], "--output",
                                        str(tmp_path / f"{name}.xalm"), "--type", "i8",
                                        "--analyze"])
        assert rc == 0
        outs.append(out.replace(str(tmp_path / f"{name}.xalm"), "OUT"))
    assert "quantization error analysis" in outs[1]
    assert outs[0] == outs[1]


@pytest.fixture(scope="module")
def containers(hf_dirs, tmp_path_factory):
    d = tmp_path_factory.mktemp("c")
    out = {}
    for t in ("i8", "bf16", "f8_e5m2"):
        out[t] = str(d / f"{t}.xalm")
        assert _quiet(jcvt.main, ["--input", hf_dirs["bf16"], "--output", out[t],
                                  "--type", t])[0] == 0
    return out


@pytest.mark.parametrize("gtype", ["q8_0", "q4_0", "q5_1", "tq1_0", "f16", "f32", "bf16"])
@pytest.mark.parametrize("source", ["i8", "bf16", "f8_e5m2"])
def test_gguf_round_trip_byte_equal(containers, tmp_path, source, gtype):
    """Export a container to GGUF with both packages (equal bytes), then
    import that GGUF with both converters (equal containers)."""
    a, b = str(tmp_path / "j.gguf"), str(tmp_path / "p.gguf")
    jgg.export_xalm_to_gguf(containers[source], a, gtype)
    assert _quiet(pgg.main, [containers[source], b, "--type", gtype])[0] == 0
    assert filecmp.cmp(a, b, shallow=False)
    ja, pb = _both(b, tmp_path, "--type", "i8")
    assert filecmp.cmp(ja, pb, shallow=False)


def test_gguf_reader_equal(containers, tmp_path):
    path = str(tmp_path / "m.gguf")
    pgg.export_xalm_to_gguf(containers["i8"], path, "q8_0")
    jmd, jt = jgg.read_gguf(path)
    pmd, pt = pgg.read_gguf(path)
    assert jmd == pmd and list(jt) == list(pt)
    for k in jt:
        assert jt[k][:2] == pt[k][:2] and np.array_equal(jt[k][2], pt[k][2])
    with open(path, "r+b") as f:
        f.write(b"XXXX")
    with pytest.raises(ValueError):
        pgg.read_gguf(path)


def test_container_cli_verify(containers, tmp_path):
    path = str(tmp_path / "m.xalm")
    shutil.copy(containers["i8"], path)
    outs = [_quiet(m.container_cli, [path, "--verify"]) for m in (jins, pins)]
    assert outs[0] == outs[1] and outs[1][0] == 0
    assert "tensor hashes verified" in outs[1][1]
    from xalm_tpu_torch.io import XalmFile

    with XalmFile(path) as xf:
        off = xf.tensors["l.1.mlp.down.weight"].offset
    with open(path, "r+b") as f:  # one corrupted byte
        f.seek(off + 3)
        byte = f.read(1)
        f.seek(off + 3)
        f.write(bytes([byte[0] ^ 0xFF]))
    outs = [_quiet(m.container_cli, [path, "--verify"]) for m in (jins, pins)]
    assert outs[0] == outs[1] and outs[1][0] == 1 and "l.1.mlp.down.weight" in outs[1][1]


def test_safetensors_reader_equals_the_package(hf_dirs, tmp_path):
    import safetensors.torch

    for d in hf_dirs.values():
        want = safetensors.torch.load_file(f"{d}/model.safetensors")
        got = read_safetensors(f"{d}/model.safetensors")
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    t = {"w": torch.randn(4, 3).to(torch.float16), "e": torch.zeros((0,)),
         "f8": torch.randn(8).to(torch.float8_e4m3fn), "i": torch.arange(6)}
    path = str(tmp_path / "w.safetensors")
    safetensors.torch.save_file(t, path, metadata={"format": "pt"})
    back = read_safetensors(path)
    for k, v in t.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k].view(torch.uint8),
                                                        v.view(torch.uint8))


@pytest.mark.parametrize("rot", [16, 8])
def test_permute_reverse_equal(rot):
    w = np.random.default_rng(0).standard_normal((4 * 16, 12)).astype(np.float32)
    assert np.array_equal(pcvt.permute_reverse(w, 4, rot), jcvt.permute_reverse(w, 4, rot))
    t = torch.from_numpy(w).to(torch.bfloat16)
    assert torch.equal(pcvt.permute_reverse(t, 4, rot),
                       torch.from_numpy(jcvt.permute_reverse(w, 4, rot)).to(torch.bfloat16))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_normalize_config_equal(tmp_path, family):
    hf = make_tiny_model(str(tmp_path / "hf"), config_overrides=FAMILIES[family])
    with open(f"{hf}/config.json") as f:
        config = json.load(f)
    assert pcvt.normalize_config(config) == jcvt.normalize_config(config)


def test_load_tokens_equal(hf_dirs):
    from pathlib import Path

    mini = str(Path(__file__).resolve().parents[1] / "models/xalm-mini/tokenizer.json")
    for path, n in ((f"{hf_dirs['f32']}/tokenizer.json", 384), (mini, 8192)):
        assert pcvt.load_tokens(path, n) == jcvt.load_tokens(path, n)


def test_converter_needs_an_input(tmp_path):
    with pytest.raises(SystemExit):
        pcvt.main(["--type", "i8"])
    with pytest.raises(SystemExit):  # no --download in the port
        pcvt.main(["--download", "org/model"])
    with pytest.raises(FileNotFoundError):
        pcvt.main(["--input", str(tmp_path)])
