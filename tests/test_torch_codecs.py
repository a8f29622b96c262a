"""The port's lossless codecs (per-block BDI, FPC) against the JAX package,
at tolerance 0: the codecs are lossless and the bytes are the format.

* ``compress_packed`` and ``fpc.compress`` give the reference's bytes:
  stream (its padding included), offsets, encodings, ``stream_bytes`` and
  ``compressed_bytes()`` -- the last decides the cold scheme and the host
  budget;
* the inputs reach every BDI encoding id 0-8 and every FPC pattern 0-7;
* the plain decoders give back the input, equal the reference's scheme
  decoders and its Pallas kernels in interpret mode, and each side decodes
  the other's bytes;
* the kernel wrappers take their plain forms for CPU tensors, write into a
  given ``out`` and count no launch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.assist.schemes import bdi as j_bdi  # noqa: E402
from repro.assist.schemes import fpc as j_fpc  # noqa: E402
from repro.kernels.bdi import ops as j_bdi_ops  # noqa: E402
from repro.kernels.fpc import ops as j_fpc_ops  # noqa: E402
from repro_torch.assist.schemes import bdi, fpc  # noqa: E402
from repro_torch.cache.tiers import delta_seq  # noqa: E402
from repro_torch.kernels.bdi import ops as bdi_ops  # noqa: E402
from repro_torch.kernels.fpc import ops as fpc_ops  # noqa: E402
from torch_codec_inputs import bdi_blocks, fpc_blocks, kv_plane  # noqa: E402


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    kv = kv_plane(rng)
    return {
        "int32_low": rng.integers(-100, 100, 1024).astype(np.int32),
        "int32_odd": (rng.integers(0, 90, (33, 77)) + 12345).astype(np.int32),
        "zeros": np.zeros(4096, np.int8),
        "f32": (rng.standard_normal(1024) * 0.01).astype(np.float32),
        "bf16": np.asarray(jnp.asarray(rng.standard_normal(2048) * 0.01,
                                       jnp.bfloat16)),
        "noise": rng.integers(-128, 128, 4096).astype(np.int8),
        "kv_int8": kv,
        "kv_int8_delta": delta_seq(kv),
        "bdi_ids": bdi_blocks(rng),
        "fpc_patterns": fpc_blocks(rng),
    }


INPUTS = _inputs()
NAMES = sorted(INPUTS)


def _bytes(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


@pytest.fixture(scope="module")
def packed():
    """name -> (ref BDI, port BDI, ref FPC, port FPC)."""
    out = {}
    for name, x in INPUTS.items():
        out[name] = (j_bdi.compress_packed(jnp.asarray(x)),
                     bdi.compress_packed(x),
                     j_fpc.compress(jnp.asarray(x)), fpc.compress(x))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_bdi_packed_bytes_match_reference(packed, name):
    ref, got, _, _ = packed[name]
    np.testing.assert_array_equal(got.stream, np.asarray(ref.stream))
    np.testing.assert_array_equal(got.offsets, np.asarray(ref.offsets))
    np.testing.assert_array_equal(got.enc, np.asarray(ref.enc))
    assert (got.stream_bytes, got.compressed_bytes(), got.pad, got.shape,
            got.dtype_name, got.block_bytes) == \
        (ref.stream_bytes, ref.compressed_bytes(), ref.pad, ref.shape,
         ref.dtype_name, ref.block_bytes)
    assert got.offsets.dtype == np.int32 and got.enc.dtype == np.uint8


@pytest.mark.parametrize("name", NAMES)
def test_fpc_bytes_match_reference(packed, name):
    _, _, ref, got = packed[name]
    np.testing.assert_array_equal(got.stream, np.asarray(ref.stream))
    np.testing.assert_array_equal(got.offsets, np.asarray(ref.offsets))
    np.testing.assert_array_equal(got.seg_enc, np.asarray(ref.seg_enc))
    assert (got.stream_bytes, got.compressed_bytes(), got.pad, got.shape,
            got.dtype_name) == \
        (ref.stream_bytes, ref.compressed_bytes(), ref.pad, ref.shape,
         ref.dtype_name)


def test_inputs_cover_every_encoding_and_pattern(packed):
    ids = set().union(*(set(p[1].enc.tolist()) for p in packed.values()))
    pats = set().union(*(set(p[3].seg_enc.ravel().tolist())
                         for p in packed.values()))
    assert ids == set(range(len(bdi.ENCODINGS))), ids
    assert pats == set(range(len(fpc.PATTERNS))), pats
    assert packed["bdi_ids"][1].enc.tolist() == list(range(8))


@pytest.mark.parametrize("name", NAMES)
def test_plain_decoders_roundtrip_and_cross_decode(packed, name):
    x = INPUTS[name]
    rb, tb, rf, tf = packed[name]
    for got in (bdi.decompress_packed(tb), fpc.decompress(tf)):
        np.testing.assert_array_equal(_bytes(got), _bytes(x))
    np.testing.assert_array_equal(_bytes(bdi.decompress_packed(tb)),
                                  _bytes(j_bdi.decompress_packed(rb)))
    np.testing.assert_array_equal(_bytes(fpc.decompress(tf)),
                                  _bytes(j_fpc.decompress(rf)))
    # the port decodes the reference's bytes, and the reference the port's
    as_port = bdi.BDIPacked(np.asarray(rb.stream), np.asarray(rb.offsets),
                            np.asarray(rb.enc), rb.shape, rb.dtype_name,
                            rb.block_bytes, rb.pad, rb.stream_bytes)
    np.testing.assert_array_equal(_bytes(bdi.decompress_packed(as_port)),
                                  _bytes(x))
    as_ref = j_bdi.BDIPacked(jnp.asarray(tb.stream), jnp.asarray(tb.offsets),
                             jnp.asarray(tb.enc), tb.shape, tb.dtype_name,
                             tb.block_bytes, tb.pad, tb.stream_bytes)
    np.testing.assert_array_equal(_bytes(j_bdi.decompress_packed(as_ref)),
                                  _bytes(x))
    as_port = fpc.FPCPacked(np.asarray(rf.seg_enc), np.asarray(rf.stream),
                            np.asarray(rf.offsets), rf.shape, rf.dtype_name,
                            rf.block_bytes, rf.pad, rf.stream_bytes)
    np.testing.assert_array_equal(_bytes(fpc.decompress(as_port)), _bytes(x))
    as_ref = j_fpc.FPCPacked(jnp.asarray(tf.seg_enc), jnp.asarray(tf.stream),
                             jnp.asarray(tf.offsets), tf.shape, tf.dtype_name,
                             tf.block_bytes, tf.pad, tf.stream_bytes)
    np.testing.assert_array_equal(_bytes(j_fpc.decompress(as_ref)),
                                  _bytes(x))


def _blocks_of(c) -> int:
    return c.enc.shape[0] if hasattr(c, "enc") else c.seg_enc.shape[0]


@pytest.mark.parametrize("name", ["int32_odd", "bf16", "kv_int8_delta",
                                  "bdi_ids", "fpc_patterns"])
def test_wrappers_match_pallas_kernels_in_interpret_mode(name):
    """The port's decode wrappers on CPU tensors (their plain forms) against
    the TPU kernels run in interpret mode: BDI on the kernel-subset stream
    the Pallas kernel takes, FPC on the full stream."""
    x = INPUTS[name]
    ref = j_bdi_ops.compress_packed_for_kernel(jnp.asarray(x))
    tc = bdi.compress_packed(x, allowed=j_bdi_ops.KERNEL_ENCODINGS)
    np.testing.assert_array_equal(tc.stream, np.asarray(ref.stream))
    want = j_bdi_ops.decompress_packed(
        ref.stream, ref.offsets, ref.enc, block_bytes=ref.block_bytes,
        shape=ref.shape, dtype=ref.dtype_name)
    bdi_ops.reset_launches()
    fpc_ops.reset_launches()
    out = torch.full((tc.nblocks, 512), 7, dtype=torch.uint8)
    got = bdi_ops.decompress_packed_blocks(
        torch.from_numpy(tc.stream), torch.from_numpy(tc.offsets),
        torch.from_numpy(tc.enc), block_bytes=512, out=out)
    assert got.data_ptr() == out.data_ptr()
    n = x.nbytes
    np.testing.assert_array_equal(got.numpy().reshape(-1)[:n], _bytes(want))
    rf = j_fpc.compress(jnp.asarray(x))
    tf = fpc.compress(x)
    want = j_fpc_ops.decompress(rf)
    got = fpc_ops.decompress_blocks(torch.from_numpy(tf.stream),
                                    torch.from_numpy(tf.offsets),
                                    torch.from_numpy(tf.seg_enc))
    assert tuple(got.shape) == (_blocks_of(tf), 512)
    np.testing.assert_array_equal(got.numpy().reshape(-1)[:n], _bytes(want))
    assert set(bdi_ops.LAUNCHES.values()) == {0}
    assert fpc_ops.LAUNCHES == {"fpc_decode": 0}


def test_wrappers_refuse_bad_inputs():
    c = bdi.compress_packed(INPUTS["noise"])
    s, o, e = (torch.from_numpy(a) for a in (c.stream, c.offsets, c.enc))
    with pytest.raises(ValueError, match="offsets must be torch.int32"):
        bdi_ops.decompress_packed_blocks(s, o.long(), e)
    with pytest.raises(ValueError, match="out must be"):
        bdi_ops.decompress_packed_blocks(
            s, o, e, out=torch.empty((1, 512), dtype=torch.uint8))
    f = fpc.compress(INPUTS["noise"])
    with pytest.raises(ValueError, match="seg_enc must be"):
        fpc_ops.decompress_blocks(torch.from_numpy(f.stream),
                                  torch.from_numpy(f.offsets),
                                  torch.from_numpy(f.seg_enc).int())
