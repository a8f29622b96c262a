"""The port's lossless-BDI weight matmul (kernel 7's plain form) and its
b2d1 layout against the JAX package.

* ``ref.make_bdi_b2d1_layout`` gives the reference's base, mask, deltas
  and ``ok`` byte for byte (tolerance 0) on the reference test's cluster
  weights, the seeded representable generator (``ref.b2d1_weights``),
  N(0, 0.02) weights (mostly not ``ok``), values stored from the zero base
  (``< 128`` and ``>= 0xFF80``) and blocks whose base sits near the top of
  the 16-bit range beside small values (no 16-bit wrap in the encoder), at
  shapes (1, 256), (256, 512) and (128, 768);
* ``ref.dequant_bdi_b2d1`` rebuilds the reference's bf16 bit patterns
  exactly, and the weights themselves where a block is ``ok``;
* ``ops.matmul_bdi`` on CPU tensors (its plain form) against the
  reference's Pallas kernel in interpret mode and ``matmul_bdi_ref``.
  Both sum exact bf16 products in f32 in another order and round once to
  bf16: one bf16 ulp of the element (2^-7 |y|) plus 2^-12 of the largest
  output for the f32 order.  The wrapper refuses bad shapes and dtypes
  and counts no launch on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_matmul import ops as j_fm_ops  # noqa: E402
from repro.kernels.fused_matmul import ref as j_fm_ref  # noqa: E402
from repro_torch.convert import leaf_from_numpy  # noqa: E402
from repro_torch.kernels.fused_matmul import ops as fm_ops  # noqa: E402
from repro_torch.kernels.fused_matmul import ref as fm_ref  # noqa: E402

SHAPES = [(1, 256), (256, 512), (128, 768)]
KINDS = ["cluster", "representable", "normal", "zero_base", "wrap16"]


def _from_bits(bits: np.ndarray):
    """uint16 bit patterns -> (jax bf16, torch bf16) of the same bits."""
    j = jnp.asarray(bits.astype(np.uint16)).view(jnp.bfloat16)
    return j, leaf_from_numpy(np.asarray(j))


def _weights(kind: str, K: int, N: int):
    rng = np.random.default_rng(K * 1000 + N + KINDS.index(kind))
    if kind == "cluster":       # tests/test_kernels.py::test_matmul_bdi_vs_ref
        j = (jnp.full((K, N), 0.5, jnp.bfloat16)
             * jnp.asarray(1 + rng.integers(0, 3, (K, N)) * 0.001,
                           jnp.bfloat16))
        return j, leaf_from_numpy(np.asarray(j))
    if kind == "representable":
        t = fm_ref.b2d1_weights(K, N, seed=K + N)
        return _from_bits(t.view(torch.int16).numpy().view(np.uint16))
    if kind == "normal":
        j = jnp.asarray(rng.standard_normal((K, N)) * 0.02, jnp.bfloat16)
        return j, leaf_from_numpy(np.asarray(j))
    if kind == "zero_base":     # signed-16 immediates, a few from a base
        bits = np.where(rng.random((K, N)) < 0.5, rng.integers(0, 128, (K, N)),
                        rng.integers(0xFF80, 0x10000, (K, N)))
        far = rng.random((K, N)) < 0.1
        bits = np.where(far, 0x4000 + rng.integers(0, 64, (K, N)), bits)
        bits[:, ::256] = 0x4020                  # each block's base
        return _from_bits(bits)
    # wrap16: base 0xFFF0 and values just below it, with small values that
    # would be within a delta of the base only with a 16-bit wrap
    bits = 0xFFF0 + rng.integers(-100, 16, (K, N))
    bits[:, ::7] = rng.integers(0, 10, (K, (N + 6) // 7))
    bits[:, ::256] = 0xFFF0
    return _from_bits(bits)


def _i64(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("K,N", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_b2d1_layout_byte_identical(kind, K, N):
    jw, tw = _weights(kind, K, N)
    jb, jm, jd, jok = j_fm_ref.make_bdi_b2d1_layout(jw)
    base, mask, deltas, ok = fm_ref.make_bdi_b2d1_layout(tw)
    assert (base.dtype, tuple(base.shape)) == (torch.int32, (K, N // 256))
    assert (mask.dtype, tuple(mask.shape)) == (torch.uint8, (K, N // 8))
    assert (deltas.dtype, tuple(deltas.shape)) == (torch.uint8, (K, N))
    assert (ok.dtype, tuple(ok.shape)) == (torch.bool, (K, N // 256))
    np.testing.assert_array_equal(_i64(base.numpy()), _i64(jb))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(deltas.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    if kind in ("cluster", "representable", "zero_base", "wrap16"):
        assert bool(ok.all()), kind
    if kind == "normal":
        assert not bool(ok.any())


@pytest.mark.parametrize("K,N", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_dequant_bit_exact(kind, K, N):
    jw, tw = _weights(kind, K, N)
    layout = fm_ref.make_bdi_b2d1_layout(tw)
    got = fm_ref.dequant_bdi_b2d1(*layout[:3])
    want = j_fm_ref.dequant_bdi_b2d1(*j_fm_ref.make_bdi_b2d1_layout(jw)[:3])
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (K, N)
    bits = got.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(bits, np.asarray(want).view(np.uint16))
    ok = layout[3].repeat_interleave(256, dim=1)
    assert torch.equal(got.view(torch.int16)[ok], tw.view(torch.int16)[ok])


def test_wrap_and_zero_base_traps():
    """Base 0xFFF0 and value 0x0005: 5 - 0xFFF0 is out of range in int32,
    so the value is stored from the zero base (mask bit clear, delta 5);
    0xFF85 from base 0xFFF0 is a delta of -107 (mask bit set)."""
    bits = np.full((1, 256), 0xFFF0)
    bits[0, 1], bits[0, 2], bits[0, 9] = 0x0005, 0xFF85, 0x7F00
    jw, tw = _from_bits(bits)
    base, mask, deltas, ok = fm_ref.make_bdi_b2d1_layout(tw)
    assert int(base[0, 0]) == 0xFFF0
    m = mask[0].numpy()
    assert (m[0] >> 1) & 1 == 0 and (m[0] >> 2) & 1 == 1
    assert int(deltas[0, 1]) == 5 and int(deltas[0, 2]) == (-107) & 0xFF
    assert (m[1] >> 1) & 1 == 0 and not bool(ok[0, 0])   # 0x7F00 is lossy
    np.testing.assert_array_equal(ok.numpy(), np.asarray(
        j_fm_ref.make_bdi_b2d1_layout(jw)[3]))


def _close(got, want, what):
    w = want.float()
    d = (got.float() - w).abs()
    tol = 2.0 ** -7 * w.abs() + 2.0 ** -12 * w.abs().max()
    assert bool(torch.isfinite(got).all()), what
    assert bool((d <= tol).all()), f"{what}: max |d| {d.max().item():.3e}"


def _np(j):
    return torch.from_numpy(np.asarray(j, np.float32))


@pytest.mark.parametrize("kind", ["cluster", "representable"])
@pytest.mark.parametrize("M,K,N,bm", [(128, 256, 512, 128),
                                      (8, 128, 768, 8),
                                      (16, 512, 256, 16)])
def test_matmul_bdi_matches_reference(kind, M, K, N, bm):
    rng = np.random.default_rng(M + K + N)
    jx = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    x = leaf_from_numpy(np.asarray(jx))
    jw, tw = _weights(kind, K, N)
    jl = j_fm_ref.make_bdi_b2d1_layout(jw)
    base, mask, deltas, ok = fm_ref.make_bdi_b2d1_layout(tw)
    assert bool(ok.all())
    fm_ops.reset_launches()
    got = fm_ops.matmul_bdi(x, base, mask, deltas)
    assert fm_ops.LAUNCHES == {"matmul_q8": 0, "matmul_bdi": 0}
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    assert torch.equal(got, fm_ops.matmul_bdi_plain(x, base, mask, deltas))
    kern = j_fm_ops.matmul_bdi(jx, *jl[:3], bm=bm, bn=256, bk=128,
                               interpret=True)
    _close(got, _np(kern), f"{kind} {M}x{K}x{N} vs interpret-mode kernel")
    _close(got, _np(j_fm_ref.matmul_bdi_ref(jx, *jl[:3])),
           f"{kind} {M}x{K}x{N} vs matmul_bdi_ref")
    _close(got, fm_ref.matmul_bdi_ref(x, base, mask, deltas), "port ref")


@pytest.mark.parametrize("M", [1, 37])
def test_matmul_bdi_ragged_m_matches_reference_oracle(M):
    rng = np.random.default_rng(M)
    K, N = 256, 512
    jx = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    jw, tw = _weights("representable", K, N)
    got = fm_ops.matmul_bdi(leaf_from_numpy(np.asarray(jx)),
                            *fm_ref.make_bdi_b2d1_layout(tw)[:3])
    want = j_fm_ref.matmul_bdi_ref(jx, *j_fm_ref.make_bdi_b2d1_layout(jw)[:3])
    _close(got, _np(want), f"M={M}")


def test_matmul_bdi_wrapper_refuses_bad_inputs():
    K, N = 64, 512
    _, tw = _weights("representable", K, N)
    base, mask, deltas, _ = fm_ref.make_bdi_b2d1_layout(tw)
    x = torch.zeros((4, K), dtype=torch.bfloat16)
    fm_ops.reset_launches()
    with pytest.raises(ValueError, match="multiple of 256"):
        fm_ops.matmul_bdi(x, base[:, :1], mask[:, :40], deltas[:, :320])
    with pytest.raises(ValueError, match="x must be torch.bfloat16"):
        fm_ops.matmul_bdi(x.float(), base, mask, deltas)
    with pytest.raises(ValueError, match="base must be torch.int32"):
        fm_ops.matmul_bdi(x, base.long(), mask, deltas)
    with pytest.raises(ValueError, match="mask must be"):       # N/32 bytes
        fm_ops.matmul_bdi(x, base, mask[:, :N // 32], deltas)
    with pytest.raises(ValueError, match="deltas must be torch.uint8"):
        fm_ops.matmul_bdi(x, base, mask, deltas.to(torch.int8))
    with pytest.raises(ValueError, match="contiguous"):
        fm_ops.matmul_bdi(torch.zeros((K, 4), dtype=torch.bfloat16).t(),
                          base, mask, deltas)
    assert fm_ops.LAUNCHES["matmul_bdi"] == 0
