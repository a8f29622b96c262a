"""The port's C-Pack codec, its kernel's plain form, the registry and the
compression tour against the JAX package, at tolerance 0.

* ``cpack.compress`` gives the reference's ``ok``, dictionary, codes,
  payload, ``raw`` and ``compressed_bytes()`` for 1, 3 and 4 dictionary
  values, uncompressible, zero and zero-extended words, mixed blocks and
  ragged int32 / bf16 sizes, and each side decodes the other's bytes;
* the plain decode (the kernel wrapper on CPU tensors) equals the
  reference's Pallas kernel in interpret mode, on the codec's output and
  on synthetic blocks that take every 4-bit code and mix ok and raw
  blocks, and counts no launch;
* the registry holds every compress task of the reference (the lossless
  ``bdi``, ``bdi_packed``, ``fpc``, ``cpack`` and ``planes``, the
  quantizers ``int8``, ``fp8`` and ``int4``) with its traits and order,
  and the cold tier's tasks are unchanged;
* ``examples/compression_tour_torch.py --device cpu`` runs with JAX
  blocked and prints the reference codecs' ratios on the same inputs.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.assist import registry as j_registry  # noqa: E402
from repro.assist.schemes import cpack as j_cpack  # noqa: E402
from repro.cache import tiers as j_tiers  # noqa: E402
from repro.kernels.cpack import cpack as j_cpack_k  # noqa: E402
from repro.kernels.cpack import ops as j_cpack_ops  # noqa: E402
from repro_torch.assist import registry  # noqa: E402
from repro_torch.assist.schemes import cpack  # noqa: E402
from repro_torch.cache import tiers  # noqa: E402
from repro_torch.convert import leaf_from_numpy  # noqa: E402
from repro_torch.kernels.cpack import ops as cpack_ops  # noqa: E402
from torch_codec_inputs import TOUR, cpack_blocks, tour_module  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOUR_ELEMENTS = 8192


def _inputs() -> dict:
    """Each 4000 B (8 blocks, the last padded): one block shape keeps the
    reference's compiles few."""
    rng = np.random.default_rng(0)
    n = 1000
    out = {}
    for nd in (1, 3, 4):
        vocab = rng.integers(0, 2 ** 30, nd)
        out[f"ndict{nd}"] = vocab[rng.integers(0, nd, n)].astype(np.int32)
    out["uncompressible"] = rng.integers(0, 2 ** 30, n).astype(np.int32)
    out["zeros"] = np.zeros(n, np.int32)
    out["zext"] = rng.integers(0, 256, n).astype(np.int32)
    # per block: partial matches of 4 entries, zeros + zext + full, five
    # entries (uncompressible), negatives, 0x80000000-ish words
    mixed = np.zeros((8, 128), np.int64)
    mixed[0] = (rng.integers(0, 4, 128) * 0x100 + 0x12345600
                + rng.integers(0, 256, 128))
    mixed[1] = np.where(rng.random(128) < 0.5, 0, 0x7F00FF01)
    mixed[1, ::7] = rng.integers(1, 256, 19)
    mixed[2] = rng.integers(0, 5, 128) * 0x01000000 + 0x00ABCD00
    mixed[3] = -rng.integers(1, 4, 128)
    mixed[4] = 0x80000000 + rng.integers(0, 256, 128)
    mixed[5:] = rng.integers(0, 3, (3, 128)) * 0x11110000
    out["mixed"] = mixed.reshape(-1)[:n].astype(np.uint32).view(np.int32)
    out["bf16"] = np.asarray(jnp.asarray(rng.standard_normal(2 * n) * 0.02,
                                         jnp.bfloat16))
    out["bf16_few"] = np.asarray(jnp.asarray(
        np.array([1.0, 0.5, 0.0])[rng.integers(0, 3, 2 * n)], jnp.bfloat16))
    return out


INPUTS = _inputs()


def _np(a) -> np.ndarray:
    return np.asarray(a)


@pytest.mark.parametrize("name", list(INPUTS))
def test_cpack_encoder_matches_reference(name):
    x = INPUTS[name]
    ref = j_cpack.compress(jnp.asarray(x))
    t = leaf_from_numpy(x)
    got = cpack.compress(t)
    np.testing.assert_array_equal(got.ok.numpy(), _np(ref.ok))
    np.testing.assert_array_equal(got.dict_.numpy().view(np.uint32),
                                  _np(ref.dict_))
    for f in ("codes", "payload", "raw"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(ref, f)), err_msg=f)
    assert (got.compressed_bytes(), got.original_bytes(), got.pad,
            got.shape, got.dtype_name, got.block_bytes) == \
        (ref.compressed_bytes(), ref.original_bytes(), ref.pad, ref.shape,
         ref.dtype_name, ref.block_bytes)
    assert got.ratio() == ref.ratio()
    # lossless, and each side decodes the other's bytes
    assert torch.equal(cpack.decompress(got), t)
    as_ref = j_cpack.CPacked(
        ok=jnp.asarray(got.ok.numpy()),
        dict_=jnp.asarray(got.dict_.numpy().view(np.uint32)),
        codes=jnp.asarray(got.codes.numpy()),
        payload=jnp.asarray(got.payload.numpy()),
        raw=jnp.asarray(got.raw.numpy()), shape=got.shape,
        dtype_name=got.dtype_name, block_bytes=got.block_bytes, pad=got.pad)
    np.testing.assert_array_equal(_np(j_cpack.decompress(as_ref)), x)
    as_port = cpack.CPacked(
        ok=torch.from_numpy(_np(ref.ok).copy()),
        dict_=torch.from_numpy(_np(ref.dict_).view(np.int32).copy()),
        codes=torch.from_numpy(_np(ref.codes).copy()),
        payload=torch.from_numpy(_np(ref.payload).copy()),
        raw=torch.from_numpy(_np(ref.raw).copy()), shape=ref.shape,
        dtype_name=ref.dtype_name, block_bytes=ref.block_bytes, pad=ref.pad)
    assert torch.equal(cpack.decompress(as_port), t)


def test_inputs_reach_every_code_and_both_block_kinds():
    codes = set()
    oks = set()
    for x in INPUTS.values():
        c = cpack.compress(leaf_from_numpy(x))
        nib = c.codes[c.ok]
        codes |= set((nib & 0xF).flatten().tolist())
        codes |= set((nib >> 4).flatten().tolist())
        oks |= set(c.ok.tolist())
    assert codes == set(range(10)), codes
    assert oks == {True, False}


@pytest.mark.parametrize("name", ["ndict3", "mixed", "zext", "bf16"])
def test_plain_decode_matches_pallas_interpret(name):
    x = INPUTS[name]
    ref = j_cpack.compress(jnp.asarray(x))
    want = j_cpack_ops.decompress(ref, interpret=True)
    cpack_ops.reset_launches()
    got = cpack_ops.decompress(cpack.compress(leaf_from_numpy(x)))
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy() if got.dtype == torch.bfloat16
        else got.numpy(), _np(want).view(np.int16) if name == "bf16"
        else _np(want))
    assert cpack_ops.LAUNCHES == {"cpack_decode": 0}


def test_plain_decode_every_code_matches_pallas_interpret():
    """Synthetic blocks: every 4-bit code (10-15 decode to zero), random
    dictionaries and payloads, ok and raw blocks mixed, 17 blocks."""
    ok, dict_, codes, payload, raw = cpack_blocks(np.random.default_rng(5))
    want = j_cpack_k.decompress_pallas(
        jnp.asarray(ok[:, None].astype(np.uint8)),
        jnp.asarray(dict_.view(np.uint32)), jnp.asarray(codes),
        jnp.asarray(payload), jnp.asarray(raw))
    got = cpack_ops.decompress_blocks(*(torch.from_numpy(a) for a in
                                        (ok, dict_, codes, payload, raw)))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert cpack_ops.LAUNCHES == {"cpack_decode": 0}


def test_cpack_wrapper_refuses_bad_inputs():
    c = cpack.compress(leaf_from_numpy(INPUTS["ndict3"]))
    args = [c.ok, c.dict_, c.codes, c.payload, c.raw]
    with pytest.raises(ValueError, match="ok must be torch.bool"):
        cpack_ops.decompress_blocks(c.ok.to(torch.uint8), *args[1:])
    with pytest.raises(ValueError, match="dict_ must be torch.int32"):
        cpack_ops.decompress_blocks(c.ok, c.dict_.long(), *args[2:])
    with pytest.raises(ValueError, match="raw must be"):
        cpack_ops.decompress_blocks(*args[:4], c.raw[:, :256])


def test_registry_matches_reference():
    ref, port = j_registry.REGISTRY, registry.REGISTRY
    ported = port.names("compress")
    assert ported == [n for n in ref.names("compress") if n in ported]
    assert {"bdi", "bdi_packed", "fpc", "cpack", "int8"} <= set(ported)
    assert {"planes", "int8", "fp8", "int4"} <= set(ported)
    assert port.lossless_names() == ref.lossless_names()
    for t in port.tasks("compress"):
        r = ref.get(t.name)
        assert (t.lossless, t.jit_compress, t.decomp_ops_per_byte) == \
            (r.lossless, r.jit_compress, r.decomp_ops_per_byte), t.name
    assert set(port.kinds()) <= set(ref.kinds())
    assert [t.name for t in port.tasks("prefetch")] == ["coldpage"]
    # the cold tier packs with the same two codecs as the reference
    assert {k: t.name for k, t in tiers.COLD_TASKS.items()} == \
        {k: t.name for k, t in j_tiers.COLD_TASKS.items()} == \
        {"bdi": "bdi_packed", "fpc": "fpc"}


TOUR_GUARDED = """
import runpy, sys
sys.modules["jax"] = None
sys.argv = ["compression_tour_torch.py", "--device", "cpu",
            "--elements", "%d"]
try:
    runpy.run_path(%r, run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "repro" or m.startswith("repro.") or m.startswith("jax")))
assert not bad, bad
print("GUARD-OK")
""" % (TOUR_ELEMENTS, str(TOUR))


def test_tour_runs_without_jax_and_matches_reference_ratios():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", TOUR_GUARDED],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "GUARD-OK" in res.stdout and "Tour complete." in res.stdout
    printed = dict(re.findall(r"^   (\S.*?) +((?:\w+=\S+x)(?:  \w+=\S+x)*)$",
                              res.stdout, re.M))
    data = tour_module().generators(TOUR_ELEMENTS)
    assert list(printed) == list(data)
    for name, x in data.items():
        a = (x.view(torch.int16).numpy().view(jnp.bfloat16)
             if x.dtype == torch.bfloat16 else x.numpy())
        ref = j_registry.REGISTRY
        want = "  ".join(f"{c}={ref.get(c).compress(jnp.asarray(a)).ratio():.4f}x"
                         for c in registry.REGISTRY.lossless_names())
        assert printed[name] == want, name
