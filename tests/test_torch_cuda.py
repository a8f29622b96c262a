"""Card-only checks of the port (marker ``gpu``): they skip without a card.

This file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

* each CUDA kernel against its plain PyTorch form on the same CUDA
  tensors, with NaN in the trash slot, a ``len == 0`` row and window 0 / 5.
  Both sum in f32 in another order and round once to bf16, so an element
  may differ by one bf16 ulp of its value: at most 2^-7 |x| (RTOL), plus
  ATOL for elements near 0;
* the launch counters count kernel launches and nothing else;
* the reduced model served end to end on the card through both kernels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attn import paged as pg  # noqa: E402
from repro_torch.serving.config import ServeConfig  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402
from repro_torch.serving.kv_cache import quantize_token  # noqa: E402

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
