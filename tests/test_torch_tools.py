"""The port's harness ``--profile`` and its tools on the CPU at tiny size:

- ``--profile`` prints the profiler report with the ``model load`` span and
  the mode's span, and the process usage table, in every mode; the text it
  generates is the JAX harness's (``--profile`` there too); the refusals of
  later slices stay;
- ``tools/spec_probe.py`` and ``tools/eval_real_model.py`` (the port's
  copies) run end to end on a tiny checkpoint with ``--cpu``;
- ``harness/bench_kernels.py`` refuses to measure without a card.
"""

import json

import numpy as np
import pytest
import torch

from tests.make_tiny_model import make_tiny_model
from xalm_tpu.convert import convert as jcvt
from xalm_tpu.harness import main as jax_harness
from xalm_tpu_torch.harness import bench_kernels
from xalm_tpu_torch.harness import main as port_harness
from xalm_tpu_torch.tools import eval_real_model, spec_probe

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)


@pytest.fixture(scope="module")
def tiny_hf(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    rng = np.random.default_rng(0)
    np.save(f"{hf}/heldout_ids.npy", rng.integers(3, 380, size=2000).astype(np.int32))
    return hf


@pytest.fixture(scope="module")
def tiny_i8(tiny_hf, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("x") / "tiny_i8.xalm")
    assert jcvt.main(["--input", tiny_hf, "--output", out, "--type", "i8"]) == 0
    return out


def _report_spans(out: str) -> dict:
    spans = {}
    for line in out[out.index("profiler report"):].splitlines():
        cells = [c.strip() for c in line.strip("|").split("|")]
        if len(cells) == 4 and cells[1].isdigit():
            spans[cells[0]] = int(cells[1])
    return spans


@pytest.mark.parametrize("mode,extra", [("c", ["-i", "hello world the quick", "-n", "12"]),
                                        ("perplexity", ["-i", "the quick brown fox is here"]),
                                        ("passkey", ["-n", "4", "-l", "1", "--seed", "3"])])
def test_profile_prints_spans_and_usage(tiny_i8, capsys, mode, extra):
    rc = port_harness.main([tiny_i8, "-d", "cpu", "-m", mode, "--profile", "-T", "64"] + extra)
    assert rc in (0, 1)  # passkey exits 1 when the tiny model misses the key
    out = capsys.readouterr().out
    name = {"c": "completion"}.get(mode, mode)
    assert _report_spans(out) == {"model load": 1, name: 1}
    assert "process usage" in out and "max rss" in out


def test_profile_text_equals_the_jax_harness(tiny_i8, capsys):
    args = [tiny_i8, "-m", "c", "-i", "hello world the quick", "-n", "20", "-T", "16",
            "--profile"]
    assert jax_harness.main(args + ["--matmul", "xla"]) == 0
    want = capsys.readouterr().out
    assert port_harness.main(args + ["-d", "cpu", "-t", "f16", "--compute", "f32",
                                     "--matmul", "xla"]) == 0
    got = capsys.readouterr().out
    text = lambda s: s.split("Generation stats")[0].split("Encoding stats")[-1]  # noqa: E731
    assert text(got).splitlines()[1:] == text(want).splitlines()[1:]
    assert "model load" in _report_spans(want) and "model load" in _report_spans(got)


def test_profile_reports_only_its_own_run(tiny_i8, capsys):
    for _ in range(2):
        port_harness.main([tiny_i8, "-d", "cpu", "-i", "hello", "-n", "2", "--profile"])
    assert _report_spans(capsys.readouterr().out.split("process usage")[-2]) == {
        "model load": 1, "completion": 1}


@pytest.mark.parametrize("extra", [["--tp", "2"], ["--dp", "2"], ["--pp", "2"],
                                   ["--coordinator", "localhost:1"]])
def test_later_slice_flags_still_refused(tiny_i8, extra):
    with pytest.raises(SystemExit, match="not ported yet"):
        port_harness.main([tiny_i8, "-d", "cpu", "-i", "x", "--profile"] + extra)


def test_spec_probe_runs_on_the_cpu(tiny_hf, tmp_path, capsys):
    out = tmp_path / "s.json"
    assert spec_probe.main(["--model", tiny_hf, "--work", str(tmp_path / "w"), "--cpu",
                            "--prompts", "2", "--ctx", "40", "--gen", "16", "--k", "4",
                            "--json", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert summary["exact_vs_generate"] is True and summary["device"] == "cpu"
    assert summary["mode"] == "ngram" and summary["tokens_per_call"] >= 1.0
    assert "acceptance" in capsys.readouterr().out
    assert spec_probe.main(["--model", tiny_hf, "--work", str(tmp_path / "w"), "--cpu",
                            "--prompts", "1", "--ctx", "40", "--gen", "8", "--k", "3",
                            "--draft", "--json", str(out)]) == 0
    assert json.loads(out.read_text())["exact_vs_generate"] is True


def test_eval_real_model_runs_on_the_cpu(tiny_hf, tmp_path):
    out = tmp_path / "report.md"
    assert eval_real_model.main(["--model", tiny_hf, "--work", str(tmp_path / "w"), "--cpu",
                                 "--segments", "1", "--out", str(out)]) == 0
    text = out.read_text()
    delta = float(text.split("end to end: **")[1].split("**")[0])
    assert delta < 1e-3  # the f32 container against transformers' own forward
    for section in ("Held-out perplexity", "| q8 |", "| i8 + wcls_i8 |", "Wrapped-context",
                    "int8-activation", "q4 body", "Retrieval", "Greedy completion"):
        assert section in text


def test_bench_kernels_needs_a_card(capsys):
    assert bench_kernels.main([]) == 0  # no probe asked for: the help
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the probes")
    assert bench_kernels.main(["-k", "mha"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_bench_kernels_refuses_a_reading_above_the_card():
    """A reading above 105 % of 3.35 TB/s is a timing fault, not a rate."""
    row = bench_kernels._reading("probe", 1.0, int(3.3e9), 1)  # 3.3 TB/s: kept
    assert row["share"] == pytest.approx(3300 / 3350)
    with pytest.raises(RuntimeError, match="above 105%"):
        bench_kernels._reading("probe", 1.0, int(3.6e9), 1)
