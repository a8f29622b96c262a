"""The port's bit planes, block quantizers and BestOfAll selector against
the JAX package, at tolerance 0.

* ``planes.compress`` gives the reference's ``ok``, dictionary (zeros
  past the count), codes, raw hi plane, low planes, ``pad`` and
  ``compressed_bytes()`` for bf16, f32, int16 and int32 at 1, 255, 256
  and 8,209 values, for blocks with exactly 16 and with 17 distinct high
  bytes and for constant blocks; each round trip is exact and each side
  decodes the other's bytes; 1-byte dtypes raise;
* ``quant.compress`` gives the reference's ``q`` and ``scale`` for
  int8, fp8 (e4m3) and int4, and ``decompress`` and
  ``quantization_error`` the same values; an unknown kind raises;
* ``selector.measure_ratios`` gives the reference's ratios (equal floats)
  and ``best_of_all`` its choice, at cost weights 0 and 0.5, on the
  compression tour's five generators at 8,192 values and an int8 plane.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.assist.schemes import planes as j_planes  # noqa: E402
from repro.assist.schemes import quant as j_quant  # noqa: E402
from repro.assist.schemes import selector as j_selector  # noqa: E402
from repro_torch.assist.schemes import planes, quant, selector  # noqa: E402
from repro_torch.convert import leaf_from_numpy  # noqa: E402
from torch_codec_inputs import kv_plane, tour_module  # noqa: E402

PLANE_FIELDS = ("ok", "dict_", "codes", "hi_raw", "lo")
DTYPES = {"bfloat16": jnp.bfloat16, "float32": jnp.float32,
          "int16": jnp.int16, "int32": jnp.int32}


def _both(a: np.ndarray, dtype):
    """numpy values -> (jax array of ``dtype``, torch tensor of its bytes)."""
    j = jnp.asarray(a, dtype)
    return j, leaf_from_numpy(np.asarray(j))


def _values(rng, name: str, n: int) -> np.ndarray:
    if name in ("bfloat16", "float32"):
        return rng.standard_normal(n) * 0.5
    hi = 2 ** 15 if name == "int16" else 2 ** 31
    return rng.integers(-hi, hi, n)


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _check_planes(jx, tx):
    jc, tc = j_planes.compress(jx), planes.compress(tx)
    for f in PLANE_FIELDS:
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    assert (tc.pad, tc.block_values, tc.shape, tc.dtype_name) == \
        (jc.pad, jc.block_values, jc.shape, jc.dtype_name)
    assert tc.compressed_bytes() == jc.compressed_bytes()
    assert tc.ratio() == jc.ratio()
    back = planes.decompress(tc)
    assert back.dtype == tx.dtype and tuple(back.shape) == tuple(tx.shape)
    np.testing.assert_array_equal(_bytes(back), _bytes(tx))
    # the reference decodes the port's bytes
    jback = j_planes.decompress(j_planes.PlanesTensor(
        *(jnp.asarray(getattr(tc, f).numpy()) for f in PLANE_FIELDS),
        shape=tc.shape, dtype_name=tc.dtype_name,
        block_values=tc.block_values, pad=tc.pad))
    np.testing.assert_array_equal(np.asarray(jback).view(np.uint8).reshape(-1),
                                  _bytes(tx))
    return tc


@pytest.mark.parametrize("n", [1, 255, 256, 8209])
@pytest.mark.parametrize("name", list(DTYPES))
def test_planes_fields_identical(name, n):
    rng = np.random.default_rng(n)
    jx, tx = _both(_values(rng, name, n), DTYPES[name])
    _check_planes(jx, tx)


def _hi_blocks(rng, n_distinct: list) -> np.ndarray:
    """int16 values, one 256-value block per entry: the block's high
    bytes take ``n_distinct`` distinct values (all of them appear), low
    bytes random."""
    out = []
    for k in n_distinct:
        his = rng.choice(256, size=k, replace=False)
        hi = np.concatenate([his, rng.choice(his, 256 - k)])
        rng.shuffle(hi)
        lo = rng.integers(0, 256, 256)
        out.append(((hi << 8) | lo).astype(np.uint16).view(np.int16))
    return np.concatenate(out)


@pytest.mark.parametrize("case", ["16_distinct", "17_distinct", "constant",
                                  "mixed"])
def test_planes_dictionary_edges(case):
    rng = np.random.default_rng(len(case))
    if case == "constant":
        a = np.full(3 * 256, -12345, np.int16)
    else:
        k = {"16_distinct": [16, 16], "17_distinct": [17, 17],
             "mixed": [1, 16, 17, 2, 200]}[case]
        a = _hi_blocks(rng, k)
    jx, tx = _both(a, jnp.int16)
    tc = _check_planes(jx, tx)
    want_ok = {"16_distinct": [True, True], "17_distinct": [False, False],
               "constant": [True] * 3,
               "mixed": [True, True, False, True, False]}[case]
    assert tc.ok.tolist() == want_ok


@pytest.mark.parametrize("dtype", [jnp.int8, jnp.uint8])
def test_planes_refuses_one_byte_dtypes(dtype):
    jx, tx = _both(np.arange(300) % 100, dtype)
    with pytest.raises(ValueError):
        j_planes.compress(jx)
    with pytest.raises(ValueError):
        planes.compress(tx)


def _q_bytes(q):
    if isinstance(q, torch.Tensor):
        return q.contiguous().view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


@pytest.mark.parametrize("n", [1, 300, 8209])
@pytest.mark.parametrize("name", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["int8", "fp8", "int4"])
def test_quant_identical(kind, name, n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal(n) * 3
    a[256:512] = 0                      # an all-zero block (scale 1)
    a[::97] *= 40                       # outliers
    jx, tx = _both(a, DTYPES[name])
    jc, tc = j_quant.compress(jx, kind), quant.compress(tx, kind)
    np.testing.assert_array_equal(_q_bytes(tc.q), _q_bytes(jc.q))
    np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))
    assert (tc.kind, tc.shape, tc.dtype_name, tc.pad) == \
        (jc.kind, jc.shape, jc.dtype_name, jc.pad)
    assert tc.compressed_bytes() == jc.compressed_bytes()
    assert tc.ratio() == jc.ratio()
    got = quant.decompress(tc)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(tx.shape)
    np.testing.assert_array_equal(_bytes(got),
                                  np.asarray(j_quant.decompress(jc))
                                  .view(np.uint8).reshape(-1))
    np.testing.assert_array_equal(
        _bytes(quant.quantization_error(tx, kind)),
        np.asarray(j_quant.quantization_error(jx, kind))
        .view(np.uint8).reshape(-1))


def test_quant_unknown_kind_raises():
    jx, tx = _both(np.ones(10), jnp.float32)
    with pytest.raises(ValueError):
        j_quant.compress(jx, "int2")
    with pytest.raises(ValueError):
        quant.compress(tx, "int2")


SELECTOR_INPUTS = ["low-range ints", "mostly zeros", "4-value dict",
                   "bf16 weights", "pure noise", "int8 plane"]


def _selector_input(name: str):
    if name == "int8 plane":
        a = kv_plane(np.random.default_rng(3), (4, 8, 16, 64))
        return jnp.asarray(a), torch.from_numpy(a)
    t = tour_module().generators(8192)[name]
    j = (jnp.asarray(t.view(torch.int16).numpy().view(np.uint16))
         .view(jnp.bfloat16) if t.dtype == torch.bfloat16
         else jnp.asarray(t.numpy()))
    return j, t


@pytest.mark.parametrize("name", SELECTOR_INPUTS)
def test_selector_matches_reference(name):
    jx, tx = _selector_input(name)
    schemes = selector.LOSSLESS + quant.KINDS
    want = j_selector.measure_ratios(jx, schemes)
    got = selector.measure_ratios(tx, schemes)
    assert list(got) == list(want)
    assert {k: c.ratio for k, c in got.items()} == \
        {k: c.ratio for k, c in want.items()}
    for w in (0.0, 0.5):
        for sch in (selector.LOSSLESS, schemes):
            g = selector.best_of_all(tx, sch, cost_weight=w)
            r = j_selector.best_of_all(jx, sch, cost_weight=w)
            assert (g.name, g.ratio) == (r.name, r.ratio), (w, sch)
    assert selector.DECOMP_OPS_PER_BYTE == j_selector.DECOMP_OPS_PER_BYTE
    assert selector.LOSSLESS == j_selector.LOSSLESS
