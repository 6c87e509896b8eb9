"""The port's observability helpers against the JAX package's: tables,
histograms, tensor dumps, CSV dumps, the profiler's report, the usage
table and the progress bar give the same text for the same entries (string
equal), and the container listing of a converted model is the same with and
without its per-tensor histograms."""

import io
import time

import numpy as np
import pytest

from tests.make_tiny_model import make_tiny_model
from xalm_tpu.convert import convert as jcvt
from xalm_tpu.io.container import XalmFile as JaxXalmFile
from xalm_tpu.obs import console as jcon
from xalm_tpu.obs import inspect as jins
from xalm_tpu.obs import profiler as jprof
from xalm_tpu.obs import stats as jstats
from xalm_tpu.obs import table as jtab
from xalm_tpu_torch.io import XalmFile
from xalm_tpu_torch.obs import console as pcon
from xalm_tpu_torch.obs import inspect as pins
from xalm_tpu_torch.obs import profiler as pprof
from xalm_tpu_torch.obs import stats as pstats
from xalm_tpu_torch.obs import table as ptab

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)


def _table(mod, hist_mod):
    t = mod.Table(["name", "bytes", "ratio", "flag", "cell", "mixed"],
                  formats={"bytes": "h", "ratio": ".3f"}, align={"flag": "r"})
    rng = np.random.default_rng(0)
    for i in range(6):
        t.add(f"tensor.{i}", int(rng.integers(0, 1 << 40)), float(rng.uniform()), bool(i % 2),
              hist_mod.Histogram(rng.standard_normal(100 + i), bins=8),
              i if i % 3 else f"s{i}")
    return t


@pytest.mark.parametrize("title", [None, "listing"])
def test_table_string_equal(title):
    assert _table(ptab, pstats).format(title) == _table(jtab, jstats).format(title)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 5 * 1024 ** 2, 3 * 1024 ** 5])
def test_human_size_equal(n):
    assert ptab.human_size(n) == jtab.human_size(n)


def test_table_rejects_a_short_row():
    with pytest.raises(ValueError):
        ptab.Table(["a", "b"]).add(1)


@pytest.mark.parametrize("bins", [4, 10, 16])
def test_histogram_streaming_equal(bins):
    rng = np.random.default_rng(bins)
    hj, hp = jstats.Histogram(bins=bins), pstats.Histogram(bins=bins)
    for k in range(5):  # batches that extend the range re-bin
        batch = rng.standard_normal(500) * (k + 1) + k
        hj.add(batch)
        hp.add(batch)
    assert np.array_equal(hp.counts, hj.counts)
    assert (hp.min, hp.max, hp.sum, hp.n, hp.mean) == (hj.min, hj.max, hj.sum, hj.n, hj.mean)
    assert hp.sparkline() == hj.sparkline() and hp.format() == hj.format()
    assert hp.suggest_scale(2.0) == hj.suggest_scale(2.0)


@pytest.mark.parametrize("shape,dtype", [((40, 33), np.float32), ((3, 4, 5), np.float16),
                                          ((7,), np.int8)])
def test_format_tensor_equal(shape, dtype):
    x = (np.random.default_rng(1).standard_normal(shape) * 10).astype(dtype)
    assert pins.format_tensor(x, "w", max_rows=16) == jins.format_tensor(x, "w", max_rows=16)


@pytest.mark.parametrize("shape", [(), (5,), (4, 6), (2, 3, 4)])
def test_save_csv_bytes_equal(tmp_path, shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    pins.save_csv(x, str(tmp_path / "p.csv"))
    jins.save_csv(x, str(tmp_path / "j.csv"))
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_uniform_fixture_equal():
    assert np.array_equal(pins.uniform((3, 5)), jins.uniform((3, 5)))
    assert np.array_equal(pins.uniform(8, -2, 2, seed=7), jins.uniform(8, -2, 2, seed=7))


def test_profiler_report_equal_on_the_same_entries():
    """The same entries give the same report; the port's spans count calls
    and add up host time."""
    pprof.reset()
    with pprof.profile("model load"):
        time.sleep(0.01)
    for _ in range(3):
        with pprof.profile("decode"):
            pass
    total, calls = pprof.get("model load")
    assert calls == 1 and total >= 0.01
    assert pprof.get("decode")[1] == 3 and pprof.get("missing") == (0.0, 0)
    entries = {"model load": [1.25, 1], "decode": [0.5, 64], "prefill": [0.75, 2]}
    saved = dict(jprof._entries)
    try:
        jprof._entries.clear()
        jprof._entries.update({k: list(v) for k, v in entries.items()})
        pprof._entries.clear()
        pprof._entries.update({k: list(v) for k, v in entries.items()})
        assert pprof.report() == jprof.report()
    finally:
        jprof._entries.clear()
        jprof._entries.update(saved)
        pprof.reset()
    assert "model load" not in pprof.report()


def test_profile_records_when_the_block_raises():
    pprof.reset()
    with pytest.raises(KeyError):
        with pprof.profile("failing"):
            raise KeyError("x")
    assert pprof.get("failing")[1] == 1
    pprof.reset()


def test_system_usage_table_equal():
    fields = dict(wall_ms=1234.5, user_ms=1000.25, sys_ms=12.0, minor_faults=123456,
                  major_faults=2, swaps=0, block_in=800, block_out=16, vol_ctx_switches=42,
                  invol_ctx_switches=7, max_rss_kb=2_000_000)
    pu, ju = pcon.SystemUsage(**fields), jcon.SystemUsage(**fields)
    assert pu.format() == ju.format() and pu.format("process usage") == ju.format("process usage")
    assert pu.summary() == ju.summary()


def test_system_usage_measures_this_process():
    t0, r0 = pcon.SystemUsage._now()
    sum(i * i for i in range(100_000))
    time.sleep(0.02)
    u = pcon.SystemUsage.measure(t0, r0)
    assert u.wall_ms >= 20 and u.user_ms >= 0 and u.max_rss_kb > 0
    with pcon.scoped_usage("stage", report=False) as s:
        time.sleep(0.01)
    assert s["usage"].wall_ms >= 10


def test_progress_bar_equal_render_and_summary():
    buf = io.StringIO()  # not a terminal: no repaint, the done summary only
    with pcon.ProgressBar("loading weights", total=5, interval=0.01, stream=buf) as bar:
        for _ in range(5):
            bar.advance()
    out = buf.getvalue()
    assert out.startswith("loading weights: done (wall ") and "user" in out and "sys" in out
    for n in (0, 3, 9):
        p, j = pcon.ProgressBar("x", total=4, stream=io.StringIO()), \
            jcon.ProgressBar("x", total=4, stream=io.StringIO())
        p.set(n)
        j.set(n)
        assert p._render() == j._render()


def test_error_exits_with_its_code():
    with pytest.raises(SystemExit) as e:
        pcon.error("boom", code=3)
    assert e.value.code == 3


@pytest.fixture(scope="module")
def tiny_f16(tmp_path_factory):
    hf = make_tiny_model(str(tmp_path_factory.mktemp("hf") / "tiny"))
    out = str(tmp_path_factory.mktemp("x") / "tiny_f16.xalm")
    assert jcvt.main(["--input", hf, "--output", out, "--type", "f16"]) == 0
    return out


@pytest.mark.parametrize("histograms", [False, True])
def test_container_listing_equal(tiny_f16, histograms):
    with XalmFile(tiny_f16) as xf, JaxXalmFile(tiny_f16) as jf:
        assert xf.format(histograms=histograms) == jf.format(histograms=histograms)
