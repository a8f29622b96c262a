"""Paged decode kernels of the PyTorch port against the JAX reference.

On the CPU each port wrapper runs its plain form; the reference runs its
Pallas kernels in interpret mode.  Inputs are made once with numpy and
handed to both.  Cases: int8 pools with scales, bf16 and f32 pools;
window 0 and 5; H=14 over G=2 (group 7, as Qwen2-7B); a NaN-filled trash
slot; a ``len == 0`` row; a mixed hot/warm/trash encoded table.  Then the
``gather`` / ``pallas`` / ``pallas_int8`` backends against the reference's
``ops.attn_backend_*``.

Tolerances: outputs are bf16; both sides accumulate in f32 in another
order and round once, so they may differ by one bf16 ulp (0.0078 at
|x| ~ 1) -- held to the reference's own 2e-2 (tests/test_paged_backends.py
:183).  f32 outputs are held to 1e-5.

The CUDA kernels themselves are held against these plain forms on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn import ops as jops  # noqa: E402
from repro.kernels.decode_attn import paged as jpg  # noqa: E402
from repro_torch.kernels.decode_attn import ops as tops  # noqa: E402
from repro_torch.kernels.decode_attn import paged as tpg  # noqa: E402

BF16_ATOL = 2e-2
F32_ATOL = 1e-5
B, H, G, D, PS, NP = 3, 14, 2, 32, 4, 5
N_HOT, N_WARM = 9, 7
LENGTHS = (NP * PS, 7, 0)          # full, partial, empty


def _bf16(x):
    return np.array(jnp.asarray(x, jnp.bfloat16))


def _t(x):
    """numpy (incl. ml_dtypes bf16) -> torch, bit for bit."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.float().numpy()


def _inputs(seed=0, q_dtype="bf16"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    q = _bf16(q) if q_dtype == "bf16" else q
    kh = _bf16(rng.standard_normal((1 + N_HOT, G, PS, D)))
    vh = _bf16(rng.standard_normal((1 + N_HOT, G, PS, D)))
    kh[0] = np.nan                        # trash slot: masked, never read
    vh[0] = np.nan
    k8 = rng.integers(-127, 128, (1 + N_WARM, G, PS, D)).astype(np.int8)
    v8 = rng.integers(-127, 128, (1 + N_WARM, G, PS, D)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (1 + N_WARM, G, PS)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (1 + N_WARM, G, PS)).astype(np.float32)
    ks[0] = np.nan
    vs[0] = np.nan
    # mixed encoded table: hot (>0), warm (<0), trash (0) past each length
    bt = np.array([[1, -2, 3, -4, 5], [-1, 6, 0, 0, 0], [0, 0, 0, 0, 0]],
                  np.int32)
    return dict(q=q, kh=kh, vh=vh, k8=k8, v8=v8, ks=ks, vs=vs, bt=bt,
                lengths=np.array(LENGTHS, np.int32))


def _close(got, want, atol, what):
    err = float(np.max(np.abs(got - want)))
    assert np.isfinite(got).all(), f"{what}: non-finite output"
    assert err <= atol, f"{what}: max |d| {err:.3e} > {atol}"


# -- kernel 1: paged_decode_attn over one pool ------------------------------

def _pool_case(x, kind):
    """(k, ks, v, vs, table) for pool dtype ``kind`` through slot numbers
    of the table (the trash entries stay 0 and hold NaN)."""
    bt = np.abs(x["bt"])
    if kind == "int8":
        return x["k8"], x["ks"], x["v8"], x["vs"], np.minimum(bt, N_WARM)
    ones = np.ones(x["kh"].shape[:3], np.float32)
    if kind == "bf16":
        return x["kh"], ones, x["vh"], ones, bt
    return (x["kh"].astype(np.float32), ones, x["vh"].astype(np.float32),
            ones, bt)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("q_dtype", ["bf16", "f32"])
def test_paged_decode_attn_matches_reference(kind, window, q_dtype):
    x = _inputs(q_dtype=q_dtype)
    k, ks, v, vs, bt = _pool_case(x, kind)
    out_dtype = jnp.bfloat16 if q_dtype == "bf16" else jnp.float32
    want = jpg.paged_decode_attn(jnp.asarray(x["q"]), jnp.asarray(k),
                                 jnp.asarray(ks), jnp.asarray(v),
                                 jnp.asarray(vs), jnp.asarray(bt),
                                 jnp.asarray(x["lengths"]),
                                 out_dtype=out_dtype, window=window,
                                 interpret=True)
    got = tpg.paged_decode_attn(_t(x["q"]), _t(k), _t(ks), _t(v), _t(vs),
                                _t(bt), _t(x["lengths"]), window=window)
    assert got.dtype == _t(x["q"]).dtype
    _close(_np(got), np.asarray(want, np.float32),
           BF16_ATOL if q_dtype == "bf16" else F32_ATOL,
           f"paged_decode_attn[{kind}, w={window}, q={q_dtype}]")
    assert np.all(_np(got)[2] == 0.0), "len == 0 row must give 0"


# -- kernel 2: paged_decode_attn_tiered over the encoded table --------------

@pytest.mark.parametrize("window", [0, 5])
def test_tiered_kernel_matches_reference(window):
    x = _inputs()
    args = [x[k] for k in ("q", "kh", "vh", "k8", "ks", "v8", "vs", "bt",
                           "lengths")]
    want = jpg.paged_decode_attn_tiered(*map(jnp.asarray, args),
                                        window=window, interpret=True)
    got = tpg.paged_decode_attn_tiered(*map(_t, args), window=window)
    _close(_np(got), np.asarray(want, np.float32), BF16_ATOL,
           f"paged_decode_attn_tiered[w={window}]")
    assert np.all(_np(got)[2] == 0.0), "len == 0 row must give 0"


def test_plain_forms_count_no_launch():
    tpg.reset_launches()
    x = _inputs()
    tpg.paged_decode_attn_tiered(*[_t(x[k]) for k in (
        "q", "kh", "vh", "k8", "ks", "v8", "vs", "bt", "lengths")])
    assert tpg.LAUNCHES == {"paged_decode_attn": 0,
                            "paged_decode_attn_tiered": 0}


def test_wrapper_rejects_bad_inputs():
    x = _inputs()
    args = [_t(x[k]) for k in ("q", "kh", "vh", "k8", "ks", "v8", "vs",
                               "bt", "lengths")]
    bad = list(args)
    bad[7] = bad[7].long()                       # int64 table
    with pytest.raises(ValueError, match="block_table"):
        tpg.paged_decode_attn_tiered(*bad)
    bad = list(args)
    bad[1] = bad[1].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tpg.paged_decode_attn_tiered(*bad)


# -- backends ---------------------------------------------------------------

def _pools(x):
    return {k: x[k] for k in ("kh", "vh", "k8", "v8", "ks", "vs")}


@pytest.mark.parametrize("has_warm", [True, False])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("backend", ["gather", "pallas", "pallas_int8"])
def test_backend_matches_reference(backend, window, has_warm):
    x = _inputs(seed=1)
    bt = x["bt"] if has_warm else np.abs(x["bt"]) % (N_HOT + 1)
    pools = _pools(x)
    jfn = {"gather": jops.attn_backend_gather,
           "pallas": jops.attn_backend_pallas,
           "pallas_int8": jops.attn_backend_pallas_int8}[backend]
    want = jfn(jnp.asarray(x["q"]), {k: jnp.asarray(v)
                                     for k, v in pools.items()},
               jnp.asarray(bt), jnp.asarray(x["lengths"]), window=window,
               has_warm=has_warm, interpret=True)
    got = tops.get_attn_backend(backend)(
        _t(x["q"]), {k: _t(v) for k, v in pools.items()}, _t(bt),
        _t(x["lengths"]), window=window, has_warm=has_warm)
    # the reference's gather divides by sum(p) (NaN on a len == 0 row);
    # compare the rows that hold tokens
    _close(_np(got)[:2], np.asarray(want, np.float32)[:2], BF16_ATOL,
           f"{backend}[w={window}, warm={has_warm}]")


def test_registry_names_and_unknown():
    assert {"gather", "pallas", "pallas_int8"} <= set(
        tops.attn_backend_names())
    with pytest.raises(KeyError, match="registered"):
        tops.get_attn_backend("nope")
