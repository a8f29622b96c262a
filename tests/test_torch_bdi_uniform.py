"""The port's uniform BDI codec and its kernels' plain forms against the
JAX package, at tolerance 0: the codec is lossless and the bytes are the
format.

* ``compress_uniform`` gives the reference's encoding id, base, mask,
  deltas, padding and ``compressed_bytes()`` for each of the nine
  encoding ids (one seeded generator per id, ragged sizes included), and
  each side decodes the other's bytes;
* the plain forms of the decode and encode kernels (the wrappers on CPU
  tensors) equal the reference's Pallas kernels in interpret mode for
  b2d1, b4d1 and b4d2 at 1, 4 and 17 blocks, with an infeasible block and
  words near both ends of the range (the fit tests' wraparound), and
  count no launch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.assist import bytesops as j_bo  # noqa: E402
from repro.assist.schemes import bdi as j_bdi  # noqa: E402
from repro.kernels.bdi import bdi as j_bdi_k  # noqa: E402
from repro.kernels.bdi import ops as j_bdi_ops  # noqa: E402
from repro.kernels.bdi import ref as j_bdi_ref  # noqa: E402
from repro_torch.assist import bytesops as bo  # noqa: E402
from repro_torch.assist.schemes import bdi  # noqa: E402
from repro_torch.convert import leaf_from_numpy  # noqa: E402
from repro_torch.kernels.bdi import ops as bdi_ops  # noqa: E402
from repro_torch.kernels.bdi import ref as bdi_ref  # noqa: E402
from torch_codec_inputs import bdi_uniform_words, wrap_blocks  # noqa: E402


def _around(rng, base, spread, n, dtype):
    w = (base + rng.integers(-spread, spread, n)).astype(dtype)
    w[0] = base
    return w


def _generators() -> dict:
    """name of the encoding id each input takes -> numpy input, each 4000
    B (8 blocks, the last padded: one block shape keeps the reference's
    compiles few).  8-byte words travel as int32 pairs: the JAX package
    runs without 64-bit types."""
    rng = np.random.default_rng(0)
    b8 = 0x1122334455667788

    def words8(spread):
        return _around(rng, b8, spread, 500, np.int64).view(np.int32)

    low = _around(rng, 10 ** 6, 60, 744, np.int32)
    wrap = wrap_blocks(4).view(np.int32).reshape(-1)
    return {
        "zeros": np.zeros(1000, np.int32),
        "rep8": np.full(512, 0x0102030405060708, np.int64).view(np.int32),
        "b8d1": words8(60),
        "b8d2": words8(10000),
        "b8d4": words8(2 ** 30),
        "b4d1": np.concatenate([wrap, low]),
        "b4d2": _around(rng, 10 ** 6, 15000, (25, 40), np.int32),
        "b2d1": _around(rng, 1000, 60, 2000, np.int16),
        "raw": np.asarray(jnp.asarray(rng.standard_normal(2000) * 0.02,
                                      jnp.bfloat16)),
    }


INPUTS = _generators()


def _np(a) -> np.ndarray:
    return np.asarray(a)


def _ref_base(c) -> np.ndarray:
    """The reference's (lo, hi) uint32 base halves as one int64 word."""
    lo = _np(c.base_lo).astype(np.uint64)
    hi = _np(c.base_hi).astype(np.uint64)
    return (lo | (hi << np.uint64(32))).view(np.int64)


@pytest.mark.parametrize("name", list(INPUTS))
def test_uniform_encoder_matches_reference(name):
    x = INPUTS[name]
    want_id = bdi.ENC_BY_NAME[name][0]
    ref = j_bdi.compress_uniform(jnp.asarray(x))     # chooses the id
    t = leaf_from_numpy(x)
    assert bdi.choose_uniform_encoding(t) == want_id
    got = bdi.compress_uniform(t)
    assert got.enc_id == ref.enc_id == want_id
    np.testing.assert_array_equal(got.base.numpy(), _ref_base(ref))
    np.testing.assert_array_equal(got.mask.numpy(), _np(ref.mask))
    np.testing.assert_array_equal(got.deltas.numpy(), _np(ref.deltas))
    assert (got.compressed_bytes(), got.original_bytes(), got.pad,
            got.shape, got.dtype_name, got.block_bytes) == \
        (ref.compressed_bytes(), ref.original_bytes(), ref.pad, ref.shape,
         ref.dtype_name, ref.block_bytes)
    assert got.ratio() == ref.ratio()
    # lossless both ways, and each side decodes the other's bytes
    back = bdi.decompress_uniform(got)
    assert back.dtype == t.dtype and torch.equal(back, t)
    as_ref = j_bdi.BDIUniform(
        base_lo=jnp.asarray((got.base.numpy() & 0xFFFFFFFF).astype(np.uint32)),
        base_hi=jnp.asarray((got.base.numpy() >> 32).astype(np.uint32)),
        mask=jnp.asarray(got.mask.numpy()),
        deltas=jnp.asarray(got.deltas.numpy()), enc_id=got.enc_id,
        shape=got.shape, dtype_name=got.dtype_name,
        block_bytes=got.block_bytes, pad=got.pad)
    np.testing.assert_array_equal(_np(j_bdi.decompress_uniform(as_ref)), x)
    as_port = bdi.BDIUniform(
        base=torch.from_numpy(_ref_base(ref).copy()),
        mask=torch.from_numpy(_np(ref.mask).copy()),
        deltas=torch.from_numpy(_np(ref.deltas).copy()), enc_id=ref.enc_id,
        shape=ref.shape, dtype_name=ref.dtype_name,
        block_bytes=ref.block_bytes, pad=ref.pad)
    assert torch.equal(bdi.decompress_uniform(as_port), t)
    assert torch.equal(bdi.decompress(bdi.compress(t)), t)


@pytest.mark.parametrize("enc_id", range(len(bdi.ENCODINGS)))
def test_forced_encoding_matches_reference(enc_id):
    """Every id forced on one tensor: the reference's bytes where the
    encoding does not fit every block too (``_encode_uniform`` is the same
    function of its input), and a lossless round trip where it does."""
    rng = np.random.default_rng(1)
    x = np.zeros(1000, np.int32)                      # 8 blocks
    x[512:640] = 7                                    # rep8 and b*d1 fit
    x[640:768] = rng.integers(-100, 100, 128)         # b8d*, b4d*, b2d1
    x[768:] = rng.integers(-2 ** 31, 2 ** 31, 232)    # only raw
    ref = j_bdi.compress_uniform(jnp.asarray(x), enc_id=enc_id)
    t = torch.from_numpy(x)
    got = bdi.compress_uniform(t, enc_id=enc_id)
    np.testing.assert_array_equal(got.base.numpy(), _ref_base(ref))
    np.testing.assert_array_equal(got.mask.numpy(), _np(ref.mask))
    np.testing.assert_array_equal(got.deltas.numpy(), _np(ref.deltas))
    assert got.compressed_bytes() == ref.compressed_bytes()
    np.testing.assert_array_equal(bdi.decompress_uniform(got).numpy(),
                                  _np(j_bdi.decompress_uniform(ref)))
    fits = bdi.analyze(bdi.bo.pad_to_blocks(bdi.bo.to_bytes(t), 512)[0])
    for lo, hi in ((0, 4), (4, 5), (5, 6)):     # sub-tensors that fit
        part = t[128 * lo:128 * hi]
        if bool(fits[lo:hi, enc_id].all()):
            c = bdi.compress_uniform(part, enc_id=enc_id)
            assert torch.equal(bdi.decompress_uniform(c), part)


def test_analyze_matches_reference():
    """The fit table of every block of every input (the uniform choice
    and the packed encoder both read it)."""
    for name, x in INPUTS.items():
        blocks = bdi.bo.pad_to_blocks(bdi.bo.to_bytes(x), 512)[0]
        np.testing.assert_array_equal(
            bdi.analyze(torch.from_numpy(blocks)).numpy(),
            _np(j_bdi.analyze(jnp.asarray(blocks))), err_msg=name)


@pytest.mark.parametrize("nb", [1, 4, 17])
@pytest.mark.parametrize("enc", ["b2d1", "b4d1", "b4d2"])
def test_kernel_plain_forms_match_pallas_interpret(enc, nb):
    wb, db = bdi_ref.ENC_PARAMS[enc]
    blocks = bdi_uniform_words(np.random.default_rng(nb), wb, db, nb)
    u_words = blocks.view({2: "<u2", 4: "<u4"}[wb])
    want = j_bdi_k.compress_pallas(jnp.asarray(u_words), enc=enc)
    ref_plain = j_bdi_ref.compress_ref(jnp.asarray(blocks), enc)
    bdi_ops.reset_launches()
    words = torch.from_numpy(blocks.copy()).view(bdi.bo.word_dtype(wb))
    got = bdi_ops.compress(words, enc=enc)
    names = ("base", "mask", "deltas", "ok")
    for n, g, w, r in zip(names, got, want, ref_plain):
        g = g.numpy().view(np.uint32) if n == "base" else g.numpy()
        np.testing.assert_array_equal(g, _np(w), err_msg=n)
        np.testing.assert_array_equal(g.reshape(-1),
                                      _np(r).astype(g.dtype).reshape(-1),
                                      err_msg=n)
    ok = got[3].numpy()[:, 0]
    assert ok[0] == (wb == 4) and ok[min(2, nb - 1)] == (nb == 1 and wb == 4)
    # decode: the reference's bytes through the port's plain form, and the
    # Pallas kernel's words
    base, mask, deltas = got[:3]
    words_back = bdi_ops.decompress_words(base, mask, deltas, enc=enc)
    pallas_words = j_bdi_k.decompress_pallas(*(jnp.asarray(_np(w))
                                               for w in want[:3]), enc=enc)
    np.testing.assert_array_equal(
        words_back.numpy().view(u_words.dtype), _np(pallas_words))
    feasible = ok.astype(bool)
    np.testing.assert_array_equal(words_back.numpy().view(u_words.dtype)
                                  [feasible], u_words[feasible])
    assert set(bdi_ops.LAUNCHES.values()) == {0}


def test_layout_and_kernel_wrappers_round_trip():
    """compress_for_kernel / decompress (the kernels' wrappers) round-trip
    a bf16 tensor of a ragged size under b2d1, as the reference's
    layout_from_uniform / tensor_from_layout do."""
    rng = np.random.default_rng(3)
    x = np.asarray(jnp.asarray(1.0 + rng.integers(0, 8, 999) / 64,
                               jnp.bfloat16))
    t = leaf_from_numpy(x)
    ref = j_bdi_ref.layout_from_uniform(jnp.asarray(x), "b2d1")
    lay = bdi_ops.compress_for_kernel(t, "b2d1")
    plain = bdi_ref.layout_from_uniform(t, "b2d1")
    for k in ("base", "mask", "deltas", "ok"):
        np.testing.assert_array_equal(lay[k].numpy(), plain[k].numpy())
        np.testing.assert_array_equal(
            lay[k].numpy().view(np.uint32) if k == "base" else lay[k].numpy(),
            _np(ref[k]))
    assert bool(lay["ok"].all())
    assert (lay["pad"], lay["shape"], lay["dtype"]) == \
        (ref["pad"], ref["shape"], ref["dtype"])
    back = bdi_ops.decompress(lay["base"], lay["mask"], lay["deltas"],
                              enc="b2d1", block_bytes=512, shape=lay["shape"],
                              dtype=lay["dtype"])
    assert torch.equal(back, t)
    assert torch.equal(bdi_ref.tensor_from_layout(plain), t)


def test_uniform_wrappers_refuse_bad_inputs():
    w = torch.zeros((2, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="no uniform kernel"):
        bdi_ops.compress(w, enc="b8d1")
    with pytest.raises(ValueError, match="words must be torch.int16"):
        bdi_ops.compress(w, enc="b2d1")
    base, mask, deltas, _ = bdi_ops.compress(w, enc="b4d1")
    with pytest.raises(ValueError, match="base must be torch.int32"):
        bdi_ops.decompress_words(base.long(), mask, deltas, enc="b4d1")
    with pytest.raises(ValueError, match="deltas must be"):
        bdi_ops.decompress_words(base, mask, deltas, enc="b4d2")
    with pytest.raises(ValueError, match="block_bytes"):
        bdi_ops.compress(w, enc="b4d1", block_bytes=96)


def test_build_lists_every_kernel_source():
    from repro_torch.kernels import build
    on_disk = {f"{p.parent.parent.name}/{p.stem}"
               for p in (build.REPO_ROOT / "src" / "repro_torch" / "kernels")
               .glob("*/csrc/*.cu")}
    assert set(build.SOURCES) == on_disk
    assert {bdi_ops.KERNEL_SOURCE, bdi_ops.UNIFORM_SOURCE} <= on_disk


@pytest.mark.parametrize("d_bytes", [1, 2, 4])
def test_bytesops_match_reference(d_bytes):
    """The PyTorch helpers keep the reference's bit and byte order and its
    uint32 wraparound: fit checks and sign extension on words near both
    ends of the 32-bit range, bit and low-byte packing, words of 1-8
    bytes."""
    rng = np.random.default_rng(d_bytes)
    u = np.concatenate([np.array([0, 1, 127, 128, 255, 256, 32767, 32768,
                                  0x7FFFFFFF, 0x80000000, 0xFFFFFF80,
                                  0xFFFFFF7F, 0xFFFF8000, 0xFFFFFFFF],
                                 np.uint32),
                        rng.integers(0, 2 ** 32, 50).astype(np.uint32)])
    t = torch.from_numpy(u.astype(np.int64))
    ju = jnp.asarray(u)
    np.testing.assert_array_equal(bo.fits_signed32(t, d_bytes).numpy(),
                                  _np(j_bo.fits_signed32(ju, d_bytes)))
    np.testing.assert_array_equal(bo.sext32(t, d_bytes).numpy(),
                                  _np(j_bo.sext32(ju, d_bytes)))
    lo, hi = u, rng.integers(0, 2 ** 32, u.size).astype(np.uint32)
    hi[::2] = np.where(u[::2] >= 2 ** 31, 0xFFFFFFFF, 0)
    v = torch.from_numpy((lo.astype(np.uint64)
                          | (hi.astype(np.uint64) << np.uint64(32)))
                         .view(np.int64))
    np.testing.assert_array_equal(
        bo.fits_signed64(v, d_bytes).numpy(),
        _np(j_bo.fits_signed64(ju, jnp.asarray(hi), d_bytes)))
    packed = bo.pack_low_bytes(t[None], d_bytes)
    np.testing.assert_array_equal(packed.numpy(), _np(
        j_bo.pack_low_bytes(ju[None], d_bytes)))
    back = bo.unpack_low_bytes(packed, u.size, d_bytes)[0]
    assert torch.equal(back, t & ((1 << (8 * d_bytes)) - 1))
    bits = torch.from_numpy(rng.random((3, 61)) < 0.5)
    np.testing.assert_array_equal(
        bo.pack_bits(bits).numpy(),
        _np(j_bo.pack_bits(jnp.asarray(bits.numpy()))))
    assert torch.equal(bo.unpack_bits(bo.pack_bits(bits), 61), bits)
    blocks = torch.from_numpy(rng.integers(0, 256, (2, 64)).astype(np.uint8))
    for wb in (1, 2, 4, 8):        # little-endian words, as numpy reads them
        w = bo.words_from_block(blocks, wb)
        np.testing.assert_array_equal(w.numpy(),
                                      bo.words_of(blocks.numpy(), wb))
        assert torch.equal(bo.block_from_words(w, wb, 64), blocks)


def test_packed_kernel_subset_matches_reference():
    """The packed encoder restricted to the encodings the reference's
    packed kernel takes, as its ``compress_packed_for_kernel``."""
    x = INPUTS["b4d1"]
    assert bdi_ops.KERNEL_ENCODINGS == j_bdi_ops.KERNEL_ENCODINGS
    got = bdi_ops.compress_packed_for_kernel(x)
    ref = j_bdi_ops.compress_packed_for_kernel(jnp.asarray(x))
    np.testing.assert_array_equal(got.stream, _np(ref.stream))
    np.testing.assert_array_equal(got.enc, _np(ref.enc))
    assert got.ratio() == ref.ratio()
