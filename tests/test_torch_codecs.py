"""The port's host-side codecs against the JAX package's, bit for bit:
every ``gguf`` codec of the registry (quantize where it has one, and
dequantize on random block bytes), every ``quant`` type (values, scales,
byte counts, the dequantized values, the ``--analyze`` rows), the packed
q4 rows, every ``packing`` width and packer, and every ``floatlab`` spec and
mapping. The same seeded numpy inputs go through both packages; outputs are
compared as raw bytes (a NaN compares by its bits).

bf16 and fp8 take torch's casts in the port (``ml_dtypes``' in the JAX
package): ``test_torch_casts_round_as_ml_dtypes`` pins the two equal on
every bf16 bit pattern and two million random f32 patterns.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from xalm_tpu import floatlab as jfl
from xalm_tpu import gguf as jgg
from xalm_tpu import packing as jpk
from xalm_tpu import quant as jq
from xalm_tpu_torch import floatlab as pfl
from xalm_tpu_torch import gguf as pgg
from xalm_tpu_torch import packing as ppk
from xalm_tpu_torch import quant as pq

import tests.torch_threads  # noqa: F401  (one intra-op thread per process)


def _bits(a) -> bytes:
    """The raw bytes of a numpy array or a torch tensor (bf16 and fp8 as
    their storage)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous()
        return t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
    return np.ascontiguousarray(a).tobytes()


def _inputs(n: int, seed: int) -> np.ndarray:
    """Normal values over a wide range of scales, with zeros, ties and
    extremes in the first block."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-12, 8, size=n))).astype(np.float32)
    x[:12] = [0.0, -0.0, 1.0, -1.0, 0.5, 1e-30, -3e38, 3e38, 448.0, 57344.0, 65504.0, 1e-8]
    return x


@pytest.mark.parametrize("name", sorted(n for n, c in jgg.CODECS.items() if c.quant))
def test_gguf_quantize_bit_equal(name):
    x = _inputs(8 * jgg.QK_K, seed=1)
    with np.errstate(all="ignore"):
        a, b = jgg.quantize(x, name), pgg.quantize(x, name)
        assert _bits(a) == _bits(b)
        assert _bits(jgg.dequantize(a, name, x.shape)) == _bits(pgg.dequantize(b, name, x.shape))


@pytest.mark.parametrize("name", sorted(jgg.CODECS))
def test_gguf_dequantize_random_blocks_bit_equal(name):
    c = jgg.CODECS[name]
    raw = np.random.default_rng(2).integers(0, 256, size=16 * c.nbytes, dtype=np.uint8)
    with np.errstate(all="ignore"):
        a, b = jgg.dequantize(raw, name), pgg.dequantize(raw, name)
    assert a.shape == b.shape and _bits(a) == _bits(b)


@pytest.mark.parametrize("name", ["f32", "f16"])
def test_gguf_plain_types_bit_equal(name):
    x = _inputs(512, seed=3)
    with np.errstate(all="ignore"):
        a, b = jgg.quantize(x, name), pgg.quantize(x, name)
        assert _bits(a) == _bits(b)
        assert _bits(jgg.dequantize(a, name)) == _bits(pgg.dequantize(b, name))


def test_gguf_registry_and_grids_equal():
    assert pgg.GGUF_SIZES == jgg.GGUF_SIZES
    assert sorted(pgg.CODECS) == sorted(jgg.CODECS)
    for name in ("iq1", "iq2_xxs", "iq2_xs", "iq2_s", "iq3_xxs", "iq3_s"):
        assert _bits(pgg._iq_grid(name)) == _bits(jgg._iq_grid(name))
    assert _bits(pgg._KSIGNS) == _bits(jgg._KSIGNS)


QUANT_TYPES = ("f32", "f16", "bf16", "f8_e4m3", "f8_e5m2", "q8", "i8") + jq.SIMULATED_TYPES


@pytest.mark.parametrize("name", QUANT_TYPES)
def test_quant_bit_equal(name):
    x = _inputs(64 * 256, seed=4).reshape(64, 256) * np.float32(0.01)
    with np.errstate(all="ignore"):
        a, b = jq.quantize(x, name), pq.quantize(x, name)
        assert _bits(a.values) == _bits(b.values)
        assert (a.scale is None) == (b.scale is None)
        if a.scale is not None:
            assert _bits(a.scale) == _bits(b.scale)
        assert a.nbytes == b.nbytes
        assert _bits(jq.dequantize(a, name)) == _bits(pq.dequantize(b, name))


@pytest.mark.parametrize("name", ["bf16", "f8_e4m3", "f8_e5m2"])
def test_quant_dequantizes_raw_container_storage(name):
    """A container's raw storage (uint16 for bf16, uint8 for fp8, as the
    port's ``XalmFile.load`` gives it) dequantizes to the JAX values."""
    x = _inputs(4096, seed=5).reshape(16, 256) * np.float32(0.01)
    a, b = jq.quantize(x, name), pq.quantize(x, name)
    raw = np.asarray(a.values).view(np.uint16 if name == "bf16" else np.uint8)
    assert _bits(pq.dequantize(raw, name)) == _bits(jq.dequantize(a, name))
    assert _bits(pq.dequantize(b.values, name)) == _bits(jq.dequantize(a, name))


@pytest.mark.parametrize("name", ["i8", "q8", "f8_e5m2", "qi4", "q4_1", "tq2_0"])
def test_analyze_rows_equal(name):
    x = np.random.default_rng(6).standard_normal((32, 256)).astype(np.float32) * 0.05
    for sc in jq.analyze_scales(x, name):
        assert pq.analyze_scales(x, name) == jq.analyze_scales(x, name)
        with np.errstate(all="ignore"):
            assert pq.analyze(x, name, sc) == jq.analyze(x, name, sc)


@pytest.mark.parametrize("group", [128, 256])
def test_q4_rows_bit_equal(group):
    x = np.random.default_rng(7).standard_normal((3, 48, 1024)).astype(np.float32)
    x[0, 0, :group] = 0.0  # a zero group: scale 1
    (ja, js), (pa, ps) = jq.quantize_q4_rows(x, group), pq.quantize_q4_rows(x, group)
    assert _bits(ja) == _bits(pa) and _bits(js) == _bits(ps)
    assert _bits(jq.dequantize_q4_rows(ja, js)) == _bits(pq.dequantize_q4_rows(pa, ps))
    xb = torch.from_numpy(x).to(torch.bfloat16)  # a bf16 tensor in, as the converter gives it
    assert _bits(pq.quantize_q4_rows(xb, group)[0]) == _bits(
        jq.quantize_q4_rows(xb.float().numpy().astype(ml_dtypes.bfloat16), group)[0])


@pytest.mark.parametrize("bits", range(2, 17))
def test_pack_bits_bit_equal(bits):
    rng = np.random.default_rng(8 + bits)
    v = rng.integers(0, 1 << bits, size=257, dtype=np.uint32).astype(np.uint16)
    a, b = jpk.pack_bits(v, bits), ppk.pack_bits(v, bits)
    assert _bits(a) == _bits(b)
    assert jpk.packed_size(v.size, bits) == ppk.packed_size(v.size, bits)
    assert _bits(jpk.unpack_bits(a, bits, v.size)) == _bits(ppk.unpack_bits(b, bits, v.size))


@pytest.mark.parametrize("name", ["qi8", "qi4", "qi3", "f4_e2m1", "f6_e3m2"])
def test_packers_bit_equal(name):
    x = np.random.default_rng(9).uniform(-1.5, 1.5, size=999).astype(np.float32)
    q, dq = f"quantize_{name}", f"dequantize_{name}"
    a, b = getattr(jpk, q)(x), getattr(ppk, q)(x)
    assert _bits(a) == _bits(b)
    args = () if name == "qi8" else (x.size,)
    assert _bits(getattr(jpk, dq)(a, *args)) == _bits(getattr(ppk, dq)(b, *args))


SPECS = ["F4_E2M1", "F6_E2M3", "F6_E3M2", "F8_E2M5", "F8_E3M4", "F8_E4M3", "F8_E5M2"]


@pytest.mark.parametrize("spec", SPECS)
def test_floatlab_spec_bit_equal(spec):
    js, ps = getattr(jfl, spec), getattr(pfl, spec)
    codes = np.arange(js.n_codes, dtype=np.uint32)
    with np.errstate(all="ignore"):
        assert _bits(js.decode(codes)) == _bits(ps.decode(codes))
    x = np.random.default_rng(10).standard_normal(4096).astype(np.float32) * js.max_value() / 3
    assert _bits(js.encode(x)) == _bits(ps.encode(x))
    assert js.max_value() == ps.max_value()
    assert js.describe() == ps.describe()


@pytest.mark.parametrize("mapping", ["linear", "log", "piecewise"])
@pytest.mark.parametrize("denormals,bias", [(True, None), (False, 5)])
def test_floatlab_mappings_bit_equal(mapping, denormals, bias):
    kw = dict(exp_bits=3, man_bits=3, bias=bias, denormals=denormals, mapping=mapping)
    js, ps = jfl.FloatSpec(**kw), pfl.FloatSpec(**kw)
    x = np.random.default_rng(11).uniform(-20, 20, size=2048).astype(np.float32)
    with np.errstate(all="ignore"):
        assert _bits(js.roundtrip(x)) == _bits(ps.roundtrip(x))
    assert js.describe() == ps.describe()


def test_floatlab_nan_codes_equal():
    x = np.array([1.0, np.nan, -np.inf, 2.0], np.float32)
    assert _bits(jfl.F8_E4M3.encode(x)) == _bits(pfl.F8_E4M3.encode(x))
    with pytest.raises(ValueError):
        pfl.F4_E2M1.encode(x)


def test_torch_casts_round_as_ml_dtypes():
    """torch's f32 -> bf16 and (clipped) f32 -> fp8 casts, which the port's
    quant uses, equal ml_dtypes' on every bf16 pattern and 2e6 random f32
    patterns (finite inputs)."""
    pats = np.concatenate([
        np.arange(65536, dtype=np.uint32) << 16,
        np.random.default_rng(12).integers(0, 2**32, size=2_000_000, dtype=np.uint64)
        .astype(np.uint32)])
    x = pats.view(np.float32)
    x = x[np.isfinite(x)]
    a = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    b = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(a, b)
    for mx, mdt, tdt in ((448.0, ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
                         (57344.0, ml_dtypes.float8_e5m2, torch.float8_e5m2)):
        c = np.clip(x, -mx, mx)
        assert np.array_equal(c.astype(mdt).view(np.uint8),
                              torch.from_numpy(c).to(tdt).view(torch.uint8).numpy())
