"""The port's dense serving path against the JAX package, on the CPU.

``reduced(qwen2-7b)`` (2 layers, d=128, GQA 4/2, head dim 32, QKV bias),
initialised by the reference and carried across with
``repro_torch.convert``; quantized weights are the reference's
``quantize_params`` tree carried across the same way.

* Kernel 3's plain form (``ops.decode_attn_q8`` / ``decode_attn_raw`` on
  CPU tensors) and the port's ``ref.py`` against the reference's
  ``decode_attn_ref`` / ``decode_attn_raw_ref`` and its interpret-mode
  Pallas kernel at ``tests/test_kernels.py``'s shapes, ``atol = 2e-2``
  (the reference's own bar: bf16 outputs of magnitude ~1, one bf16 ulp is
  2^-8..2^-7).  Rows beyond the length hold NaN (bf16 K/V, int8 scales):
  the plain form and the Pallas kernel keep them inert.
* ``decode_step`` logits against the reference's ``stack_decode_step``
  from the same prefill state, for bf16 and int8 KV, raw and q8 weights.
  ``LOGIT_ATOL = 0.0625``, two bf16 ulps of logits below 4 (both
  frameworks round the bf16 activations at the same places and
  accumulate in another order).  q8 weights are held to the same bound:
  both round the scale to bf16 (``quantized.getw``: ``bf16(q8) *
  bf16(s8)``); the reference then rounds each dequantized weight to bf16
  where the port applies the scale to the f32 sum.
* The dense ``Engine``'s greedy tokens against the reference's dense
  ``Engine`` for the four settings: equal wherever the reference's
  top-1/top-2 margin (its own prefill + decode steps along its tokens)
  exceeds the measured max |d logit| of the port's steps along the same
  tokens; at the first smaller-margin step where they differ the streams
  may part for good.
* The reference's engine behaviours (``tests/test_serving.py``) on the
  port: every request completes, batch independence, continuous batching;
  ``ServeConfig(paged=False)`` and the CLI build the dense engine.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.kernels.decode_attn import ops as j_da_ops  # noqa: E402
from repro.kernels.decode_attn import ref as j_da_ref  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.models.quantized import quantize_params as j_quantize  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.assist import AssistSpec  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.decode_attn import dense  # noqa: E402
from repro_torch.kernels.decode_attn import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attn import ref as da_ref  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import kv_cache as KV  # noqa: E402
from repro_torch.serving.config import ServeConfig  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ATTN_ATOL = 2e-2
LOGIT_ATOL = 0.0625
SETTINGS = [("bf16", "raw"), ("int8", "raw"), ("bf16", "q8"), ("int8", "q8")]


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _attn_inputs(rng, B, H, G, S, D, nan_tail):
    q = jnp.asarray(rng.standard_normal((B, H, D)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, G, S, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, G, S, D)), jnp.float32)
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    k8, ks = j_da_ref.quantize_kv(k)
    v8, vs = j_da_ref.quantize_kv(v)
    kb, vb = np.array(k.astype(jnp.bfloat16)), np.array(v.astype(jnp.bfloat16))
    ks, vs = np.array(ks), np.array(vs)
    if nan_tail:
        for b, L in enumerate(lengths):
            for a in (kb, vb, ks, vs):
                a[b, :, L:] = np.nan
    return q, np.asarray(k8), ks, np.asarray(v8), vs, kb, vb, lengths


ATTN_SHAPES = [(2, 8, 4, 256, 64), (1, 4, 1, 128, 128), (4, 4, 4, 512, 64)]


@pytest.mark.parametrize("B,H,G,S,D", ATTN_SHAPES)
def test_decode_attn_plain_matches_reference(B, H, G, S, D):
    rng = np.random.default_rng(S + D)
    q, k8, ks, v8, vs, kb, vb, lengths = _attn_inputs(rng, B, H, G, S, D,
                                                      nan_tail=False)
    t = [_to_torch(a) for a in (q, k8, ks, v8, vs, kb, vb, lengths)]
    tq, tk8, tks, tv8, tvs, tkb, tvb, tlen = t
    # the port's ref.py is the reference's, formula for formula
    kf = jnp.asarray(np.random.default_rng(1).standard_normal((B, G, S, D)),
                     jnp.float32)
    jq8, jsc = j_da_ref.quantize_kv(kf)
    pq8, psc = da_ref.quantize_kv(_to_torch(kf))
    np.testing.assert_array_equal(pq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(psc.numpy(), np.asarray(jsc))
    cases = [
        (da_ops.decode_attn_q8(tq, tk8, tks, tv8, tvs, tlen),
         j_da_ref.decode_attn_ref(q, k8, ks, v8, vs, lengths),
         da_ref.decode_attn_ref(tq, tk8, tks, tv8, tvs, tlen)),
        (da_ops.decode_attn_raw(tq, tkb, tvb, tlen),
         j_da_ref.decode_attn_raw_ref(q, kb, vb, lengths),
         da_ref.decode_attn_raw_ref(tq, tkb, tvb, tlen))]
    for got, want, port_ref in cases:
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, H, D)
        w = np.asarray(want, np.float32)
        errs = (np.abs(got.float().numpy() - w).max(),
                np.abs(port_ref.float().numpy() - w).max())
        print(f"observed max|d| plain / port ref vs reference ref: {errs}")
        assert max(errs) <= ATTN_ATOL
    assert dense.LAUNCHES["decode_attn"] == 0       # plain: not counted


@pytest.mark.parametrize("B,H,G,S,D", ATTN_SHAPES)
def test_decode_attn_plain_matches_interpret_kernel_nan_tail(B, H, G, S, D):
    rng = np.random.default_rng(S * D)
    q, k8, ks, v8, vs, kb, vb, lengths = _attn_inputs(rng, B, H, G, S, D,
                                                      nan_tail=True)
    t = [_to_torch(a) for a in (q, k8, ks, v8, vs, kb, vb, lengths)]
    tq, tk8, tks, tv8, tvs, tkb, tvb, tlen = t
    pairs = [(da_ops.decode_attn_q8(tq, tk8, tks, tv8, tvs, tlen),
              j_da_ops.decode_attn_q8(q, k8, ks, v8, vs, lengths)),
             (da_ops.decode_attn_raw(tq, tkb, tvb, tlen),
              j_da_ops.decode_attn_raw(q, kb, vb, lengths))]
    for got, want in pairs:
        assert bool(torch.isfinite(got).all())
        err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
        print(f"observed max|d| plain vs interpret kernel, NaN tail: {err}")
        assert err <= ATTN_ATOL
    # a length beyond S counts as S; a zero length gives 0
    full = torch.full((B,), S, dtype=torch.int32)
    torch.testing.assert_close(
        da_ops.decode_attn_raw(tq, tkb.nan_to_num(), tvb.nan_to_num(),
                               full + 7),
        da_ops.decode_attn_raw(tq, tkb.nan_to_num(), tvb.nan_to_num(), full),
        atol=0, rtol=0)
    zero = da_ops.decode_attn_q8(tq, tk8, tks, tv8, tvs,
                                 torch.zeros((B,), dtype=torch.int32))
    assert bool((zero == 0).all())


def test_kv_int8_update_and_bytes():
    rng = np.random.default_rng(0)
    st = KV.init_kv_int8(2, 4, 16, 8)
    k_new = torch.from_numpy(rng.standard_normal((2, 4, 1, 8)).astype(
        np.float32))
    v_new = torch.from_numpy(rng.standard_normal((2, 4, 1, 8)).astype(
        np.float32))
    before = KV.kv_bytes(st)
    out = KV.update_kv_int8(st, k_new, v_new, torch.tensor([3, 5]))
    assert out is st and KV.kv_bytes(st) == before == 2 * (2 * 4 * 16 * 8
                                                           + 2 * 4 * 16 * 4)
    back = KV.dequantize(st["k8"], st["ks"])
    for b, sl in enumerate([3, 5]):
        np.testing.assert_allclose(back[b, :, sl].numpy(),
                                   k_new[b, :, 0].numpy(), atol=0.03)
    assert bool((st["k8"][0, :, 4] == 0).all())    # other slots untouched


# -- the model and the engine --------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = j_build(j_reduced(J_ARCHS["qwen2-7b"]))
    jparams = jm.init(jax.random.PRNGKey(0))
    jq = j_quantize(jparams)
    tm = build_model(reduced(ARCHS["qwen2-7b"]))
    trees = {"raw": (jparams, params_from_numpy(jax.tree.map(np.asarray,
                                                             jparams))),
             "q8": (jq, params_from_numpy(jax.tree.map(np.asarray, jq)))}
    return jm, tm, trees


@pytest.mark.parametrize("kv_mode,weights", SETTINGS)
def test_decode_step_logits_match(models, kv_mode, weights):
    jm, tm, trees = models
    jp, tp = trees[weights]
    rng = np.random.default_rng(3)
    toks = rng.integers(2, 500, (3, 16)).astype(np.int32)
    true_len = np.array([11, 16, 5], np.int32)
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                              "true_len": jnp.asarray(true_len)}, 32,
                         kv_mode=kv_mode)
    tl, tst = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                              "true_len": torch.from_numpy(true_len)}, 32,
                         kv_mode=kv_mode)
    names = ("k8", "ks", "v8", "vs") if kv_mode == "int8" else ("k", "v")
    assert set(tst["scan"][0]) == set(names)
    assert tst["scan"][0][names[0]].shape == jst["scan"][0][names[0]].shape
    np.testing.assert_array_equal(tst["len"].numpy(), true_len)
    worst = 0.0
    for _ in range(6):
        t = rng.integers(2, 500, (3, 1)).astype(np.int32)
        jl, jst = jm.decode_step(jp, jst, jnp.asarray(t))
        tl, tst2 = tm.decode_step(tp, tst, torch.from_numpy(t))
        assert tst2 is tst                       # updated in place
        worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    print(f"observed max|d logit| {kv_mode}/{weights}: {worst}")
    assert worst <= LOGIT_ATOL, f"max|d logit| {worst}"
    np.testing.assert_array_equal(tst["len"].numpy(), true_len + 6)
    # this step's K rows landed at each row's position in every layer
    # (int8: compared dequantized; a one-ulp change of the row's absmax
    # moves its codes by a few steps of absmax / 127)
    for b, L in enumerate(true_len + 5):
        jk, tk = (_k_row(st["scan"][0], b, L) for st in (
            jax.tree.map(np.asarray, jst),
            jax.tree.map(lambda t: t.float().numpy(), tst)))
        print(f"observed max|d K row| {kv_mode}/{weights}: "
              f"{np.abs(tk - jk).max()}")
        assert np.abs(tk - jk).max() <= 0.125, np.abs(tk - jk).max()


def _k_row(st, b, pos):
    if "k8" in st:
        return st["k8"][:, b, :, pos].astype(np.float32) \
            * st["ks"][:, b, :, pos][..., None]
    return st["k"][:, b, :, pos].astype(np.float32)


def _ref_steps(model, params, prompt, outs, kv_mode, is_jax):
    """Logits of the prefill and of each decode step along ``outs``."""
    toks = np.array([prompt], np.int32)
    if is_jax:
        lg, st = model.prefill(params, {"tokens": jnp.asarray(toks)},
                               48, kv_mode=kv_mode)
        rows = [np.asarray(lg)[0, len(prompt) - 1]]
        for tok in outs[:-1]:
            lg, st = model.decode_step(params, st, jnp.asarray([[tok]],
                                                               jnp.int32))
            rows.append(np.asarray(lg)[0, 0])
    else:
        lg, st = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                               48, kv_mode=kv_mode)
        rows = [lg.numpy()[0, len(prompt) - 1]]
        for tok in outs[:-1]:
            lg, st = model.decode_step(params, st, torch.tensor(
                [[tok]], dtype=torch.int32))
            rows.append(lg.numpy()[0, 0])
    return np.stack(rows)


@pytest.mark.parametrize("kv_mode,weights", SETTINGS)
def test_engine_greedy_matches_reference_engine(models, kv_mode, weights):
    jm, tm, trees = models
    jp, tp = trees[weights]
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(2, 400, 6 + 3 * i)]
               for i in range(4)]
    jeng = JEngine(jm, jp, batch_slots=2, max_len=48, kv_mode=kv_mode,
                   eos_id=-1)
    eng = Engine(tm, tp, batch_slots=2, max_len=48, kv_mode=kv_mode,
                 eos_id=-1, device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=6))
        eng.submit(Request(rid=i, prompt=p, max_new=6))
    want = {r.rid: r.out for r in jeng.run()}
    got = {r.rid: r.out for r in eng.run()}
    assert sorted(got) == sorted(want) == list(range(4))
    checked = 0
    for rid, p in enumerate(prompts):
        ref = _ref_steps(jm, jp, p, want[rid], kv_mode, True)
        port = _ref_steps(tm, tp, p, want[rid], kv_mode, False)
        delta = float(np.abs(port - ref).max())
        print(f"observed rid {rid} max|d logit| {delta:.4f}")
        top2 = np.sort(ref, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        for k, tok in enumerate(want[rid]):
            if margin[k] > delta:
                assert got[rid][k] == tok, (
                    f"rid {rid} step {k}: {got[rid]} vs {want[rid]} "
                    f"(margin {margin[k]:.4f} > max|d logit| {delta:.4f})")
                checked += 1
            elif got[rid][k] != tok:
                break                    # ambiguous step: streams may part
            else:
                checked += 1
    print(f"observed {kv_mode}/{weights}: {checked} of 24 steps held, "
          f"tokens {'equal' if got == want else 'differ'}")
    assert checked >= 18, f"only {checked} of 24 steps comparable"


@pytest.fixture(scope="module")
def port_model():
    tm = build_model(reduced(ARCHS["qwen2-7b"]))
    return tm, tm.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kv_mode", ["bf16", "int8"])
def test_engine_completes_all(port_model, kv_mode):
    tm, params = port_model
    rng = np.random.default_rng(0)
    eng = Engine(tm, params, batch_slots=3, max_len=48, kv_mode=kv_mode,
                 eos_id=0, device="cpu")
    for rid in range(5):
        eng.submit(Request(rid=rid, prompt=[int(t) for t in rng.integers(
            2, 400, 6 + rid)], max_new=4))
    done = eng.run()
    assert len(done) == 5
    assert all(1 <= len(r.out) <= 4 for r in done)
    s = eng.stats()
    assert s["queued"] == 0 and s["active_slots"] == 0
    assert s["tokens_generated"] == sum(len(r.out) - 1 for r in done)


def test_engine_batch_independence(port_model):
    """Same prompt in different slots/batches -> identical greedy output."""
    tm, params = port_model
    p = [int(t) for t in np.random.default_rng(1).integers(2, 400, 9)]
    eng = Engine(tm, params, batch_slots=2, max_len=48, eos_id=0,
                 device="cpu")
    eng.submit(Request(rid=0, prompt=p, max_new=5))
    eng.submit(Request(rid=1, prompt=p, max_new=5))
    a, b = eng.run()
    assert a.out == b.out
    eng2 = Engine(tm, params, batch_slots=1, max_len=48, eos_id=0,
                  device="cpu")
    eng2.submit(Request(rid=2, prompt=p, max_new=5))
    (c,) = eng2.run()
    assert c.out == a.out


def test_engine_continuous_batching(port_model):
    """More requests than slots: later requests reuse freed slots."""
    tm, params = port_model
    rng = np.random.default_rng(2)
    eng = Engine(tm, params, batch_slots=2, max_len=48, eos_id=0,
                 device="cpu")
    for rid in range(6):
        eng.submit(Request(rid=rid, prompt=[int(t) for t in rng.integers(
            2, 400, 5)], max_new=3))
    done = eng.run()
    assert sorted(r.rid for r in done) == list(range(6))


def test_serve_config_builds_dense_engine(port_model):
    tm, params = port_model
    for kv_mode in ("bf16", "int8"):
        eng = ServeConfig(arch="qwen2-7b", reduced=True, kv_mode=kv_mode,
                          device="cpu", slots=2, max_len=64).build(
                              model=tm, params=params)[0]
        assert isinstance(eng, Engine) and eng.kv_mode == kv_mode
        assert eng.device.type == "cpu"
        key = "k8" if kv_mode == "int8" else "k"
        assert eng.state["scan"][0][key].shape == (2, 2, 2, 64, 32)
    # an explicit spec is authoritative and back-fills the flat alias
    scfg = ServeConfig(arch="qwen2-7b", assist=AssistSpec(kv="int8"))
    assert scfg.kv_mode == "int8" and not scfg.paged
    with pytest.raises(ValueError, match="kv must be"):
        AssistSpec(kv="fp8")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeConfig(arch="qwen2-7b", reduced=True).build()


def test_cli_serves_dense_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-7b", "--reduced", "--device", "cpu", "--kv-mode", "int8",
         "--requests", "3", "--max-new", "4", "--slots", "2"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "3 requests" in res.stdout and "dense/int8" in res.stdout
