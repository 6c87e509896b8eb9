"""How the port's parallel runs start: a multi-host world over TCP through
``init_distributed`` with ``--coordinator``-style arguments, the harness's
``--tp``/``--pp`` with the ranks it starts itself, and the server's
``--tp`` with rank 0 serving and the other ranks following, each against
the JAX package on the CPU (``tests/test_multiprocess.py``,
``tests/multiproc_worker.py``, the JAX harness's ``--tp`` and ``--pp``).

The harness and the server run as subprocesses (python -m ...), as a
user starts them: the ranks they start are their own children, and no
process group is ever made in the test process.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from tests.make_tiny_model import make_tiny_model
from tests.torch_parallel_world import run_world
from xalm_tpu.convert import convert as cvt
from xalm_tpu.harness import main as jax_harness
from xalm_tpu.runtime.engine import Engine as JaxEngine

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)

REPO = Path(__file__).resolve().parent.parent
PROMPT = "hello world the quick brown fox"
SERVE_PROMPT = "the lazy dog"  # no EOS in its first 8 greedy tokens


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"),
                         config_overrides={"num_hidden_layers": 4})
    out = str(tmp_path_factory.mktemp("x") / "tiny.xalm")
    assert cvt.main(["--input", hf, "--output", out, "--type", "f32"]) == 0
    return out


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", XALM_DIST_TIMEOUT="120")
    return env


def _port_harness(args) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "xalm_tpu_torch.harness.main", *args],
                          cwd=str(REPO), env=_env(), capture_output=True, text=True, timeout=300)


def _generated_text(out: str) -> list[str]:
    return out.split("Generation stats")[0].split("Encoding stats")[-1].splitlines()[1:]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_world_over_tcp_matches_single(tiny, tmp_path):
    """Two processes joined by ``init_distributed("127.0.0.1:PORT", 2, id)``,
    a dp=2 mesh spanning them: per-host feeding assembles the global batch,
    and the logits' greedy tokens and a decode scan equal the single JAX
    engine's."""
    eng = JaxEngine.from_xalm(tiny)
    prompts = np.random.default_rng(0).integers(3, 350, size=(2, 8)).astype(np.int32)
    logits, cache = eng.step(prompts, np.zeros(2, np.int32), eng.new_cache(2), logits_mode="last")
    tok0 = np.asarray(logits).argmax(-1).astype(np.int32)
    want, _ = eng.decode_scan(tok0, np.full(2, 8, np.int32), cache, 6)
    case = dict(name="mh", kind="multihost", model=tiny, mesh=dict(dp=2, tp=1),
                args=dict(prompts=prompts.tolist(), n=6))
    got = run_world([case], 2, tmp_path, coordinator=f"127.0.0.1:{_free_port()}")["mh"]
    assert "traceback" not in got, got.get("traceback")
    assert got["fed_shape"] == prompts.shape
    np.testing.assert_array_equal(got["fed"], prompts)
    np.testing.assert_array_equal(got["tok0"], tok0)
    np.testing.assert_array_equal(got["generated"], np.asarray(want))


@pytest.mark.parametrize("flag", ["--tp", "--pp"])
def test_harness_parallel_text_identical_to_jax(tiny, capsys, flag):
    """``--tp 2`` / ``--pp 2 -d cpu``: the harness starts its second rank
    itself and prints the JAX harness's text for the same flag."""
    args = [tiny, "-m", "c", "-i", PROMPT, "-n", "24", flag, "2"]
    assert jax_harness.main(args) == 0
    want = capsys.readouterr().out
    got = _port_harness(args + ["-d", "cpu"])
    assert got.returncode == 0, got.stderr[-3000:]
    assert _generated_text(got.stdout) == _generated_text(want)
    assert ("mesh: dp=1 x tp=2 over 2 devices" if flag == "--tp"
            else "mesh: pp=2 x tp=1 over 2 devices") in got.stdout
    assert "decode path: perlayer (" in got.stdout
    assert got.stdout.count("Generation stats") == 1  # only rank 0 writes the report


def test_harness_tp_perplexity_matches_jax(tiny, capsys):
    args = [tiny, "-m", "perplexity", "-i", PROMPT * 4, "-T", "16", "--tp", "2"]
    assert jax_harness.main(args) == 0
    want = re.search(r"perplexity: ([0-9.]+)", capsys.readouterr().out).group(1)
    got = _port_harness(args + ["-d", "cpu"])
    assert got.returncode == 0, got.stderr[-3000:]
    ppl = float(re.search(r"perplexity: ([0-9.]+)", got.stdout).group(1))
    assert ppl == pytest.approx(float(want), rel=1e-3)


def test_harness_refuses_tp_over_kv_heads(tiny):
    """tp must divide n_kv_heads (2): every rank refuses by name."""
    got = _port_harness([tiny, "-d", "cpu", "-i", "x", "--tp", "4"])
    assert got.returncode == 1
    assert "kv_heads" in got.stderr


def test_server_tp2_answers_a_completion(tiny):
    """``--tp 2 -d cpu``: rank 0 serves HTTP and the batcher, rank 1
    follows its engine calls; a greedy completion is the single engine's
    greedy text, a sampled request is refused (no per-row sampled scan)."""
    proc = subprocess.Popen([sys.executable, "-m", "xalm_tpu_torch.serve.server", tiny,
                             "--tp", "2", "-d", "cpu", "--port", "0", "--max-batch", "2"],
                            cwd=str(REPO), env=_env(), stdout=subprocess.PIPE, text=True)
    try:
        line = ""
        while not line.startswith("serving "):
            line = proc.stdout.readline()
            assert line, "the server exited before serving"
        assert "decode path: perlayer (dp=1 tp=2)" in line
        port = int(re.search(r":(\d+)/v1", line).group(1))

        def post(body):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                         data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            try:
                return 200, json.loads(urllib.request.urlopen(req, timeout=120).read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        code, body = post({"prompt": SERVE_PROMPT, "max_tokens": 8})
        assert code == 200 and body["usage"]["completion_tokens"] == 8
        eng = JaxEngine.from_xalm(tiny)
        ids = eng.tokenizer.encode(SERVE_PROMPT)
        want, _ = eng.generate(ids, 8, stop_on_eos=False)
        text = "".join(eng.tokenizer.decode_one(p, t).decode("utf-8", "replace")
                       for p, t in zip([ids[-1]] + want[:-1], want))
        assert body["choices"][0]["text"] == text
        code, body = post({"prompt": PROMPT, "max_tokens": 4, "temperature": 0.7})
        assert code == 400 and "per-row sampled scan" in body["error"]["message"]
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=120) == 0


def test_aot_build_kernels_waits_for_every_source(monkeypatch):
    """``aot.build_kernels`` starts every kernel source's nvcc at once and
    waits for each (no card needed; here the builds are stood in for)."""
    from xalm_tpu_torch.ops import build
    from xalm_tpu_torch.parallel import aot

    started, waited = [], []
    monkeypatch.setattr(build, "start_all", lambda: started.append(True))
    monkeypatch.setattr(build, "wait", lambda name: waited.append(name) or (Path(name), 1.5))
    got = aot.build_kernels()
    assert started == [True] and waited == list(build.KERNELS)
    assert got == {n: {"path": n, "seconds": 1.5} for n in build.KERNELS}
