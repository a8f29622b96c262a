"""The port's int8-weight matmul and weight format against the JAX package.

* Kernel 6's plain form (``ops.matmul_q8`` on CPU tensors) against the
  reference's ``matmul_q8_ref`` and its interpret-mode Pallas kernel
  (``fm_ops.matmul_q8``) at ``gk = 256`` and ``gk = K``.  Inputs are bf16
  and both sides sum in f32, the port per K-group then scaled, the
  reference oracle over the dequantized f32 weight, so each output differs
  by at most one bf16 ulp of its value (2^-7 |y|) plus the f32 summation
  order: ``atol = 2e-2`` on outputs of magnitude ~5 (the reference's own
  bar for its kernels).  A ragged M (the decode batch) against the port's
  own oracle.
* ``make_q8_layout`` and ``quantize_params`` leaf for leaf: int8 codes
  bit-equal, scales equal, ``params_bytes`` and ``max_dequant_error``
  equal; ``convert.params_from_numpy`` carries the quantized tree (int8
  ``q8`` and f32 ``s8`` leaves inside the scan-stacked dicts).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.kernels.fused_matmul import ops as j_fm_ops  # noqa: E402
from repro.kernels.fused_matmul import ref as j_fm_ref  # noqa: E402
from repro.models import quantized as JQ  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.fused_matmul import ops as fm_ops  # noqa: E402
from repro_torch.kernels.fused_matmul import ref as fm_ref  # noqa: E402
from repro_torch.models import quantized as Q  # noqa: E402

ATOL = 2e-2


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(
        torch.bfloat16)
    return j, t


def _layout(rng, K, N, gk):
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    jw8, jsc = j_fm_ref.make_q8_layout(jnp.asarray(w), gk)
    tw8, tsc = fm_ref.make_q8_layout(torch.from_numpy(w), gk)
    return jw8, jsc, tw8, tsc


@pytest.mark.parametrize("gk", [256, 512])
def test_make_q8_layout_bit_equal(gk):
    jw8, jsc, tw8, tsc = _layout(np.random.default_rng(gk), 512, 256, gk)
    np.testing.assert_array_equal(tw8.numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


@pytest.mark.parametrize("gk", [256, 512])
def test_matmul_q8_plain_matches_reference(gk):
    rng = np.random.default_rng(0)
    M, K, N = 128, 512, 256
    jw8, jsc, tw8, tsc = _layout(rng, K, N, gk)
    jx, tx = _bf16(rng.standard_normal((M, K)).astype(np.float32))
    got = fm_ops.matmul_q8(tx, tw8, tsc, gk=gk)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    assert fm_ops.LAUNCHES["matmul_q8"] == 0          # plain: not counted
    g = got.float().numpy()
    for want in (j_fm_ref.matmul_q8_ref(jx, jw8, jsc, gk),
                 j_fm_ops.matmul_q8(jx, jw8, jsc, gk=gk)):
        w = np.asarray(want, np.float32)
        print(f"observed max|d| gk={gk}: {np.abs(g - w).max()} "
              f"(max|y| {np.abs(w).max()})")
        assert np.abs(g - w).max() <= ATOL, np.abs(g - w).max()
    # the port's oracle is the reference's formula
    np.testing.assert_allclose(
        fm_ref.matmul_q8_ref(tx, tw8, tsc, gk).float().numpy(),
        np.asarray(j_fm_ref.matmul_q8_ref(jx, jw8, jsc, gk), np.float32),
        atol=ATOL)


@pytest.mark.parametrize("M", [1, 4, 5, 37])
def test_matmul_q8_plain_takes_any_m(M):
    rng = np.random.default_rng(M)
    _, _, tw8, tsc = _layout(rng, 512, 256, 256)
    _, tx = _bf16(rng.standard_normal((M, 512)).astype(np.float32))
    got = fm_ops.matmul_q8(tx, tw8, tsc, gk=256).float()
    want = fm_ref.matmul_q8_ref(tx, tw8, tsc, 256).float()
    assert (got - want).abs().max().item() <= ATOL


def test_matmul_q8_rejects_bad_shapes():
    x = torch.zeros((4, 96), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="gk"):
        fm_ops.matmul_q8(x, torch.zeros((96, 32), dtype=torch.int8),
                         torch.ones((1, 32)), gk=64)
    with pytest.raises(ValueError, match="w8"):
        fm_ops.matmul_q8(x, torch.zeros((96, 32), dtype=torch.int16),
                         torch.ones((1, 32)), gk=96)


@pytest.fixture(scope="module")
def jparams():
    jm = j_build(j_reduced(J_ARCHS["qwen2-7b"]))
    return jm.init(jax.random.PRNGKey(0))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def test_quantize_params_leaf_for_leaf(jparams):
    jq = JQ.quantize_params(jparams)
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams))
    tq = Q.quantize_params(tp)
    jl, tl = dict(_flat(jq)), dict(_flat(tq))
    assert jl.keys() == tl.keys()
    n_q8 = 0
    for path, ja in jl.items():
        a, t = np.asarray(ja), tl[path]
        assert tuple(t.shape) == a.shape, path
        if path[-1] == "q8":
            n_q8 += 1
            assert t.dtype == torch.int8
            np.testing.assert_array_equal(t.numpy(), a)
        elif path[-1] == "s8":
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a)
    # every projection of the 2-layer stack, none of embed/unembed/norms
    assert n_q8 == 7
    assert Q.params_bytes(tq) == JQ.params_bytes(jq)
    assert Q.params_bytes(tp) == JQ.params_bytes(jparams)
    assert Q.max_dequant_error(tp, tq) == pytest.approx(
        JQ.max_dequant_error(jparams, jq), rel=1e-6)
    assert Q.max_dequant_error(tp, tq) < 0.02
    # small leaves stay raw, as in the reference
    small = Q.quantize_params(tp, min_size=1 << 30)
    assert all(not isinstance(v, dict) or "q8" not in v
               for _, v in _flat(small))


def test_convert_carries_quantized_tree(jparams):
    jq = JQ.quantize_params(jparams)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq))
    wq = tq["scan"][0]["attn"]["wq"]
    assert set(wq) == {"q8", "s8"}
    assert wq["q8"].dtype == torch.int8 and wq["s8"].dtype == torch.float32
    n = len(jax.tree.leaves(jq))
    assert len(list(_flat(tq))) == n
    for (path, t), ja in zip(_flat(tq), jax.tree.leaves(jq)):
        a = np.asarray(ja)
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.uint16).numpy(),
                                          a.view(np.uint16))
        else:
            assert t.dtype == getattr(torch, a.dtype.name), path
            np.testing.assert_array_equal(t.numpy(), a)


def test_qmatmul_routes_q8_leaves_through_matmul_q8(jparams):
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams))
    tq = Q.quantize_params(tp)
    wi_q = tq["scan"][0]["ffn"]["wi"]
    p = {"wi": tp["scan"][0]["ffn"]["wi"][0]}          # layer 0's views
    pq = {"wi": {"q8": wi_q["q8"][0], "s8": wi_q["s8"][0]}}
    rng = np.random.default_rng(1)
    _, x = _bf16(rng.standard_normal((2, 3, 128)).astype(np.float32))
    raw = Q.qmatmul(x, p, "wi")
    torch.testing.assert_close(raw, x @ p["wi"], atol=0, rtol=0)
    got = Q.qmatmul(x, pq, "wi")
    assert got.shape == raw.shape and got.dtype == torch.bfloat16
    want = fm_ops.matmul_q8_plain(x.reshape(6, 128), pq["wi"]["q8"],
                                  pq["wi"]["s8"], 128,
                                  bf16_scale=True).reshape(2, 3, -1)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
