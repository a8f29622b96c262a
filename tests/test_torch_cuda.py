"""Card-only checks of the port (marker ``gpu``): they skip without a card.

This file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

* each CUDA kernel against its plain PyTorch form on the same CUDA
  tensors, with NaN in the trash slot, a ``len == 0`` row and window 0 / 5.
  Both sum in f32 in another order and round once to bf16, so an element
  may differ by one bf16 ulp of its value: at most 2^-7 |x| (RTOL), plus
  ATOL for elements near 0;
* the launch counters count kernel launches and nothing else;
* the reduced model served end to end on the card through both kernels;
* the BDI and FPC decode kernels against their plain forms on the same
  CUDA tensors, bit for bit, over streams that take every BDI encoding id
  and every FPC pattern, raw and delta'd KV-like planes and noise;
* an asynchronous cold -> warm promotion on the card (side-stream upload
  and decode, commit at the barrier) lands the planes bit-exactly;
* the dense decode-attention kernel (int8 and bf16 KV, NaN beyond the
  length, ``len == 0`` and ``len > S`` rows, split and unsplit rows) and
  the int8-weight matmul kernel (``gk = K`` and 256, ragged M and N, split
  and unsplit K) against their plain forms, each twice (the arrival
  counters reset, the result is the same bit for bit).  The matmul sums
  in f32 in another order and rounds once to bf16: one bf16 ulp of the
  element (RTOL) plus 2^-12 of the largest output for the f32 order;
* the reduced model served by the dense engine through both kernels:
  ``decode_attn`` once per layer and tick, ``matmul_q8`` only with q8
  weights, seven per layer and prefill or tick.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.assist.schemes import bdi, fpc  # noqa: E402
from repro_torch.cache.tiers import (TIER_WARM, TieredKVStore,  # noqa: E402
                                     delta_seq)
from repro_torch.kernels.bdi import ops as bdi_ops  # noqa: E402
from repro_torch.kernels.decode_attn import dense  # noqa: E402
from repro_torch.kernels.decode_attn import paged as pg  # noqa: E402
from repro_torch.kernels.fused_matmul import ops as fm_ops  # noqa: E402
from repro_torch.kernels.fused_matmul.ref import make_q8_layout  # noqa: E402
from repro_torch.models.quantized import quantize_params  # noqa: E402
from repro_torch.kernels.fpc import ops as fpc_ops  # noqa: E402
from repro_torch.models.transformer import paged_geometry  # noqa: E402
from repro_torch.serving.config import ServeConfig  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402
from repro_torch.serving.kv_cache import quantize_token  # noqa: E402
from torch_codec_inputs import bdi_blocks, fpc_blocks, kv_plane  # noqa: E402

ATOL = 1e-4
RTOL = 2.0 ** -7
B, H, G, D, PS, NP = 3, 14, 2, 128, 16, 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def _inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    kh = randn(1 + 8, G, PS, D).to(torch.bfloat16)
    vh = randn(1 + 8, G, PS, D).to(torch.bfloat16)
    kh[0] = float("nan")
    vh[0] = float("nan")
    k8, ks = quantize_token(randn(1 + 8, G, PS, D))
    v8, vs = quantize_token(randn(1 + 8, G, PS, D))
    ks[0] = float("nan")
    vs[0] = float("nan")
    bt = torch.tensor([[1, -2, 3, -4, 5], [-1, 6, 0, 0, 0], [0] * NP],
                      dtype=torch.int32, device=dev)
    lengths = torch.tensor([NP * PS, 19, 0], dtype=torch.int32, device=dev)
    q = randn(B, H, D).to(torch.bfloat16)
    return q, kh, vh, k8, ks, v8, vs, bt, lengths


def _close(got, want, what):
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()), f"{what}: non-finite output"
    d = (got.float() - want.float()).abs()
    excess = (d - ATOL - RTOL * want.float().abs()).max().item()
    assert excess <= 0, f"{what}: max |d| {d.max().item():.3e} over 1 ulp"
    assert bool((got[2] == 0).all()), f"{what}: len == 0 row must give 0"


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 5])
def test_tiered_kernel_matches_plain(cuda, window):
    args = _inputs(cuda)
    pg.reset_launches()
    got = pg.paged_decode_attn_tiered(*args, window=window)
    want = pg.paged_decode_attn_tiered_plain(*args, window=window)
    assert pg.LAUNCHES == {"paged_decode_attn": 0,
                           "paged_decode_attn_tiered": 1}
    _close(got, want, f"tiered w={window}")


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
def test_paged_kernel_matches_plain(cuda, kind, window):
    q, kh, vh, k8, ks, v8, vs, bt, lengths = _inputs(cuda)
    table = bt.abs()
    pools = {"int8": (k8, ks, v8, vs), "bf16": (kh, None, vh, None),
             "f32": (kh.float(), None, vh.float(), None)}[kind]
    pg.reset_launches()
    got = pg.paged_decode_attn(q, *pools, table, lengths, window=window)
    want = pg.paged_decode_attn_plain(q, *pools, table, lengths,
                                      window=window)
    assert pg.LAUNCHES["paged_decode_attn"] == 1
    _close(got, want, f"paged {kind} w={window}")


@pytest.mark.gpu
def test_wrapper_raises_on_mixed_devices(cuda):
    args = list(_inputs(cuda))
    args[7] = args[7].cpu()                     # table left on the host
    with pytest.raises(ValueError, match="block_table"):
        pg.paged_decode_attn_tiered(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("backend,kernel", [
    ("pallas_int8", "paged_decode_attn_tiered"),
    ("pallas", "paged_decode_attn")])
def test_reduced_model_serves_through_kernel(cuda, backend, kernel):
    eng, model, _ = ServeConfig(arch="qwen2-7b", reduced=True, paged=True,
                                slots=2, max_len=64, hbm_budget_mb=0.1,
                                attn_backend=backend, eos_id=-1).build()
    rng = np.random.default_rng(0)
    pg.reset_launches()
    for i in range(4):
        eng.submit(Request(rid=i, prompt=[int(t) for t in rng.integers(
            2, 500, 20 + 5 * i)], max_new=6))
    done = eng.run(max_ticks=200)
    eng.sync()
    assert len(done) == 4 and all(len(r.out) == 6 for r in done)
    assert pg.LAUNCHES[kernel] > 0
    assert pg.LAUNCHES[kernel] % model.cfg.n_layers == 0
    eng.pool.check()


def _codec_inputs():
    rng = np.random.default_rng(0)
    kv = kv_plane(rng, (28, 4, 16, 128))         # one full-width plane
    return {"bdi_ids": bdi_blocks(rng), "fpc_patterns": fpc_blocks(rng),
            "kv": kv, "kv_delta": delta_seq(kv),
            "noise": rng.integers(-128, 128, 4096).astype(np.int8)}


@pytest.mark.gpu
def test_bdi_kernel_matches_plain_every_id(cuda):
    seen = set()
    for name, x in _codec_inputs().items():
        c = bdi.compress_packed(x)
        seen |= set(c.enc.tolist())
        s, o, e = (torch.from_numpy(a).to(cuda)
                   for a in (c.stream, c.offsets, c.enc))
        bdi_ops.reset_launches()
        got = bdi_ops.decompress_packed_blocks(s, o, e)
        assert bdi_ops.LAUNCHES["bdi_packed_decode"] == 1
        want = bdi.decode_packed_blocks(s, o, e)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        flat = got.cpu().numpy().reshape(-1)[:x.nbytes]
        assert np.array_equal(flat, x.reshape(-1).view(np.uint8)), name
    assert seen == set(range(9)), seen


@pytest.mark.gpu
def test_fpc_kernel_matches_plain_every_pattern(cuda):
    seen = set()
    for name, x in _codec_inputs().items():
        c = fpc.compress(x)
        seen |= set(c.seg_enc.ravel().tolist())
        s, o, e = (torch.from_numpy(a).to(cuda)
                   for a in (c.stream, c.offsets, c.seg_enc))
        fpc_ops.reset_launches()
        got = fpc_ops.decompress_blocks(s, o, e)
        assert fpc_ops.LAUNCHES["fpc_decode"] == 1
        want = fpc.decode_blocks(s, o, e)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        flat = got.cpu().numpy().reshape(-1)[:x.nbytes]
        assert np.array_equal(flat, x.reshape(-1).view(np.uint8)), name
    assert seen == set(range(8)), seen


@pytest.mark.gpu
def test_async_cold_promotion_on_card_is_bit_exact(cuda):
    from repro_torch.configs import ARCHS, reduced
    geom = paged_geometry(reduced(ARCHS["qwen2-7b"]), PS)
    store = TieredKVStore(geom, 12, hot_pages=4, warm_pages=4, device=cuda)
    rng = np.random.default_rng(3)
    pools = store.pools[0]
    shp = tuple(pools["k8"][:, 1].shape)
    rows = rng.integers(-127, 128, shp[:2] + (1,) + shp[3:])
    planes = [np.broadcast_to(rows, shp).astype(np.int8),   # fpc+delta
              np.zeros(shp, np.int8),                        # bdi
              rng.integers(-128, 128, shp).astype(np.int8)]  # raw
    before = {}
    for pid in range(3):
        store.place_hot(pid)
        store.demote_to_warm(pid)
        ws = int(store.slot[pid])
        pools["k8"][:, ws] = torch.from_numpy(planes[pid]).to(cuda)
        pools["v8"][:, ws] = torch.from_numpy(planes[2 - pid]).to(cuda)
        before[pid] = {n: pools[n][:, ws].clone()
                       for n in ("k8", "ks", "v8", "vs")}
    for pid in range(3):
        store.demote_to_cold(pid)
    schemes = store.cold_stats()["schemes"]
    bdi_ops.reset_launches()
    fpc_ops.reset_launches()
    for pid in range(3):
        store.promote_to_warm(pid, async_=True)
    assert store.commit_promotions() == 3
    torch.cuda.synchronize()
    for pid in range(3):
        assert store.tier[pid] == TIER_WARM
        ws = int(store.slot[pid])
        for n, t in before[pid].items():
            assert torch.equal(pools[n][:, ws], t), (pid, n)
    uses = {b: sum(v for k, v in schemes.items() if k.startswith(b))
            for b in ("bdi", "fpc")}
    assert bdi_ops.LAUNCHES["bdi_packed_decode"] == uses["bdi"] > 0
    assert fpc_ops.LAUNCHES["fpc_decode"] == uses["fpc"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("S,D", [(200, 128), (48, 32)])
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_dense_decode_kernel_matches_plain(cuda, kind, S, D):
    gen = torch.Generator(device=cuda).manual_seed(S + D)
    Bd, Hd, Gd = 4, 14, 2
    q = torch.randn((Bd, Hd, D), generator=gen, device=cuda).to(
        torch.bfloat16)
    k = torch.randn((Bd, Gd, S, D), generator=gen, device=cuda)
    v = torch.randn((Bd, Gd, S, D), generator=gen, device=cuda)
    lengths = torch.tensor([S, 37, 0, S + 9], dtype=torch.int32,
                           device=cuda)
    if kind == "int8":
        k, ks = quantize_token(k)
        v, vs = quantize_token(v)
        ks[1, :, 37:] = float("nan")
        vs[1, :, 37:] = float("nan")
    else:
        k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
        k[1, :, 37:] = float("nan")
        v[1, :, 37:] = float("nan")
    dense.reset_launches()
    got = dense.decode_attn(q, k, ks, v, vs, lengths)
    again = dense.decode_attn(q, k, ks, v, vs, lengths)
    assert dense.LAUNCHES["decode_attn"] == 2
    want = dense.decode_attn_plain(q, k, ks, v, vs, lengths)
    _close(got, want, f"dense {kind} S={S} D={D}")
    assert torch.equal(got, again)


def _mm_close(got, want, what):
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()), f"{what}: non-finite output"
    w = want.float()
    d = (got.float() - w).abs()
    tol = RTOL * w.abs() + 2.0 ** -12 * w.abs().max()
    assert bool((d <= tol).all()), f"{what}: max |d| {d.max().item():.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,gk", [(4, 512, 512, 512),
                                      (4, 1024, 256, 256),
                                      (37, 512, 336, 256),
                                      (160, 1024, 512, 1024),
                                      (1, 256, 64, 256),
                                      (200, 2048, 2048, 2048)])
@pytest.mark.parametrize("bf16_scale", [False, True])
def test_matmul_q8_kernel_matches_plain(cuda, M, K, N, gk, bf16_scale):
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    w8, scale = make_q8_layout(torch.randn((K, N), generator=gen,
                                           device=cuda) * 0.05, gk)
    x = torch.randn((M, K), generator=gen, device=cuda).to(torch.bfloat16)
    fm_ops.reset_launches()
    got = fm_ops.matmul_q8(x, w8, scale, gk=gk, bf16_scale=bf16_scale)
    again = fm_ops.matmul_q8(x, w8, scale, gk=gk, bf16_scale=bf16_scale)
    assert fm_ops.LAUNCHES["matmul_q8"] == 2
    _mm_close(got, fm_ops.matmul_q8_plain(x, w8, scale, gk, bf16_scale),
              f"matmul_q8 M={M} K={K} N={N} gk={gk} bf16_scale="
              f"{bf16_scale}")
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_mode,weights", [("bf16", "raw"), ("int8", "q8")])
def test_reduced_model_dense_serves_through_kernels(cuda, kv_mode, weights):
    scfg = ServeConfig(arch="qwen2-7b", reduced=True, kv_mode=kv_mode,
                       slots=2, max_len=64, eos_id=-1)
    eng, model, params = scfg.build()
    if weights == "q8":
        eng = scfg.build(model=model, params=quantize_params(params))[0]
    rng = np.random.default_rng(0)
    dense.reset_launches()
    fm_ops.reset_launches()
    for i in range(4):
        eng.submit(Request(rid=i, prompt=[int(t) for t in rng.integers(
            2, 500, 20 + 5 * i)], max_new=6))
    done = eng.run(max_ticks=200)
    eng.sync()
    assert len(done) == 4 and all(len(r.out) == 6 for r in done)
    n_layers = model.cfg.n_layers
    assert dense.LAUNCHES["decode_attn"] == n_layers * eng.stats()["tick"]
    n_mm = fm_ops.LAUNCHES["matmul_q8"]
    if weights == "q8":
        assert n_mm > 0 and n_mm % (7 * n_layers) == 0
    else:
        assert n_mm == 0
