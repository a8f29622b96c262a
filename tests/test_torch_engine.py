"""The port's serving slice as a whole, on the CPU, against the JAX package.

(a) The port's PagedEngine, hot-only and greedy, gives the tokens of the
    reference's dense ``Engine`` on the same prompts and converted weights.
    The oracle is the dense engine: the reference's own PagedEngine gives
    nondeterministic decode tokens on this JAX version (ROADMAP.md, Faults).
    A step is held to equality wherever the reference's top-1/top-2 logit
    margin (teacher-forced forward over prompt + output) exceeds the
    measured max |d logit| between the two frameworks' forwards over the
    same tokens (0.026 to 0.039 per request on the CPU); at the first
    smaller-margin step where the streams differ, they may diverge for
    good (measured: 15 of 20 steps held; request 3's first token has a
    0.016 margin and goes its own way).
(b) A tiered run with a tight budget and no EOS, so the schedule does not
    depend on the tokens: every request completes, the pool invariants
    hold, warm pages are demoted and read, and the store and engine
    counters equal the reference PagedEngine's for the same workload (cold
    tier off on both sides, the reference's TPU v5e constants passed in).
(c) Backends gather, pallas and pallas_int8 give identical greedy tokens.
(d) The CLI runs with ``--device cpu --reduced`` in a subprocess, and goes
    cold at a budget hot + warm cannot hold.
(e) The reference benchmark's tiers scenario (``serving_micro`` smoke:
    reduced qwen2-7b, page 16, a budget of 12 hot pages, 2 lanes,
    ``max_len`` 48, 24 requests of 18-32 prompt tokens, 4 new tokens, seed
    0, EOS off, JAX-initialised weights) for hot-only, hot+warm and
    hot+warm+cold: the capacity after the first tick and every store and
    prefetch counter equal the live reference PagedEngine's.  The
    capacities are the 157 / 218 / 482 resident tokens that
    ``BENCH_serving.json`` recorded (with EOS 0: the first tick cannot see
    an EOS, so they do not depend on it).
(f) A decode step through a page that went warm -> cold -> warm gives
    bit-identical logits to one through the page left warm.
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

from repro.cache import TierConfig as JTier  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.paged_engine import PagedEngine as JPagedEngine  # noqa: E402
from repro_torch.assist import TPU_V5E  # noqa: E402
from repro_torch.cache import TierConfig, TieredKVStore  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.config import ServeConfig  # noqa: E402
from repro_torch.models.transformer import paged_geometry  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.paged_engine import PagedEngine  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
HOT_ONLY = dict(page_size=16, hbm_budget_bytes=1 << 30, enable_warm=False,
                enable_cold=False)
HOT_PAGE_BYTES = 8192              # reduced qwen2-7b: 2 layers, G=2, dh=32
TIGHT = dict(page_size=16, hbm_budget_bytes=8 * HOT_PAGE_BYTES,
             hot_fraction=0.5, enable_warm=True, enable_cold=False)


@pytest.fixture(scope="module")
def models():
    jm = j_build(j_reduced(J_ARCHS["qwen2-7b"]))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(reduced(ARCHS["qwen2-7b"]))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm, tparams


def _tiered_prompts():
    rng = np.random.default_rng(2)
    return [[int(t) for t in rng.integers(2, 500, int(rng.integers(10, 30)))]
            for _ in range(6)]


def _run_port(tm, tparams, prompts, tier, *, lanes, max_len, max_new,
              eos_id, backend="gather", **kw):
    eng = PagedEngine(tm, tparams, lanes=lanes, max_len=max_len, tier=tier,
                      eos_id=eos_id, backend=backend, device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=max_new))
    done = eng.run(max_ticks=400)
    eng.pool.check()
    return {r.rid: r.out for r in done}, eng


def test_hot_only_greedy_matches_dense_engine(models):
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(2, 400, 6 + i)]
               for i in range(4)]
    dense = JEngine(jm, jparams, batch_slots=4, max_len=48, eos_id=0)
    for i, p in enumerate(prompts):
        dense.submit(JRequest(rid=i, prompt=p, max_new=5))
    want = {r.rid: r.out for r in dense.run()}
    got, eng = _run_port(tm, tparams, prompts, TierConfig(**HOT_ONLY),
                         lanes=4, max_len=48, max_new=5, eos_id=0,
                         use_roofline_trigger=False)
    assert sorted(got) == sorted(want)
    checked = 0
    for rid, p in enumerate(prompts):
        seq = p + want[rid]
        jl = np.asarray(jm.fwd_train(jparams, {"tokens": jnp.asarray([seq])})[0])
        tl, _ = tm.prefill(tparams, {"tokens": torch.tensor([seq])}, len(seq))
        lo = len(p) - 1
        ref = jl[0, lo:lo + len(want[rid])]
        delta = float(np.abs(tl.numpy()[0, lo:lo + len(want[rid])]
                             - ref).max())
        top2 = np.sort(ref, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        assert np.all(np.argmax(ref, axis=-1) == want[rid]), \
            "dense engine disagrees with its teacher-forced forward"
        for k, tok in enumerate(want[rid]):
            if margin[k] > delta:
                assert k < len(got[rid]) and got[rid][k] == tok, \
                    (f"rid {rid} step {k}: {got[rid]} vs {want[rid]} "
                     f"(margin {margin[k]:.4f} > max|d logit| {delta:.4f})")
                checked += 1
            elif k >= len(got[rid]) or got[rid][k] != tok:
                break                  # ambiguous step: streams may split
            else:
                checked += 1
    assert checked >= 15, f"only {checked} of 20 steps comparable"
    assert eng.stats()["warm_page_reads"] == 0


def test_tiered_counters_match_reference_paged_engine(models):
    jm, jparams, tm, tparams = models
    prompts = _tiered_prompts()
    jeng = JPagedEngine(jm, jparams, lanes=1, max_len=64,
                        tier=JTier(**TIGHT), eos_id=-1)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=8))
    jdone = jeng.run(max_ticks=400)
    got, eng = _run_port(tm, tparams, prompts, TierConfig(**TIGHT), lanes=1,
                         max_len=64, max_new=8, eos_id=-1, hw=TPU_V5E)
    assert sorted(got) == list(range(len(prompts)))
    assert all(len(out) == 8 for out in got.values())
    assert len(jdone) == len(prompts)
    s, js = eng.stats(), jeng.stats()
    assert s["store"]["demote_warm"] > 0 and s["warm_page_reads"] > 0
    assert s["trigger"]["reason"] == js["trigger"]["reason"]
    for key in ("demote_warm", "promote_hot", "mover_dispatches"):
        assert s["store"][key] == js["store"][key], key
    for key in ("peak_resident_tokens", "preemptions", "admissions", "tick"):
        assert s[key] == js[key], key
    assert eng.store.hbm_bytes_used() == 0 and not eng.resident


def test_backends_give_identical_tokens(models):
    _, _, tm, tparams = models
    prompts = _tiered_prompts()
    outs = {}
    for backend in ("gather", "pallas", "pallas_int8"):
        outs[backend], eng = _run_port(
            tm, tparams, prompts, TierConfig(**TIGHT), lanes=1, max_len=64,
            max_new=8, eos_id=-1, backend=backend, hw=TPU_V5E)
        assert eng.stats()["warm_page_reads"] > 0, backend
    assert outs["pallas"] == outs["gather"]
    assert outs["pallas_int8"] == outs["gather"]


def test_serve_config_entry_points():
    scfg = ServeConfig(arch="qwen2-7b", reduced=True, paged=True,
                       device="cpu", slots=2, max_len=64)
    eng, model, params = scfg.build()
    assert isinstance(eng, PagedEngine) and eng.device.type == "cpu"
    # the cold tier is on by default, as in the reference: 8x the device
    # pages of cold page ids on top of them (no host budget given)
    resident = eng.store.hot_pages + eng.store.warm_pages
    assert eng.pool.num_pages == 9 * resident and eng.policy.cold_enabled
    assert eng.policy.prefetch.async_promote and eng.store.cold_delta
    capped = ServeConfig(arch="qwen2-7b", reduced=True, paged=True,
                         device="cpu", slots=2, max_len=64,
                         max_cold_pages=5).build(model=model, params=params)[0]
    assert capped.pool.num_pages == resident + 5
    # paged=False builds the dense engine
    dense, _, _ = ServeConfig(arch="qwen2-7b", reduced=True,
                              device="cpu").build(model=model, params=params)
    assert isinstance(dense, Engine) and dense.kv_mode == "bf16"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeConfig(arch="qwen2-7b", reduced=True, paged=True).build()


def test_cli_serves_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-7b", "--reduced", "--paged", "--device", "cpu",
         "--requests", "3", "--max-new", "4", "--hbm-budget-mb", "0.4",
         "--attn-backend", "pallas_int8"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "3 requests" in res.stdout


def test_cli_goes_cold_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-7b", "--reduced", "--paged", "--device", "cpu",
         "--requests", "12", "--max-new", "4", "--max-len", "48",
         "--slots", "2", "--hbm-budget-mb", "0.09375",
         "--attn-backend", "pallas_int8", "--eos-id", "-1"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "12 requests" in res.stdout
    cold = [ln for ln in res.stdout.splitlines() if ln.startswith("cold tier")]
    assert cold and "demote_cold 0," not in cold[0], res.stdout[-2000:]


BENCH_BUDGET_PAGES = 12
TIER_SPECS = {
    "hot-only": (dict(enable_warm=False, enable_cold=False), 157),
    "hot+warm": (dict(hot_fraction=0.5, enable_warm=True,
                      enable_cold=False), 218),
    "hot+warm+cold": (dict(hot_fraction=0.5, enable_warm=True,
                           enable_cold=True,
                           host_budget_bytes=BENCH_BUDGET_PAGES
                           * HOT_PAGE_BYTES), 482),
}


def _tiers_run(eng, make_req, vocab):
    rng = np.random.default_rng(0)
    for rid in range(24):
        plen = int(rng.integers(18, 33))
        eng.submit(make_req(rid=rid, prompt=list(rng.integers(2, vocab,
                                                              plen)),
                            max_new=4))
    eng.step()
    capacity = eng.resident_tokens()
    eng.run(max_ticks=5000)
    s = eng.stats()
    return {"capacity": capacity, "store": s["store"], "policy": s["policy"],
            "finished": len(eng.finished), "cold_bytes": s["cold_bytes"],
            **{k: s[k] for k in ("tick", "preemptions", "admissions",
                                 "peak_resident_tokens")}}


@pytest.mark.parametrize("config", sorted(TIER_SPECS))
def test_tiers_scenario_matches_reference_paged_engine(models, config):
    jm, jparams, tm, tparams = models
    kw, capacity = TIER_SPECS[config]
    tier = dict(page_size=16, hbm_budget_bytes=BENCH_BUDGET_PAGES
                * HOT_PAGE_BYTES, **kw)
    want = _tiers_run(JPagedEngine(jm, jparams, lanes=2, max_len=48,
                                   tier=JTier(**tier), eos_id=-1),
                      JRequest, tm.cfg.vocab_size)
    eng = PagedEngine(tm, tparams, lanes=2, max_len=48,
                      tier=TierConfig(**tier), eos_id=-1, hw=TPU_V5E,
                      device="cpu")
    got = _tiers_run(eng, Request, tm.cfg.vocab_size)
    eng.pool.check()
    assert got == want
    assert got["capacity"] == capacity and got["finished"] == 24
    if config == "hot+warm+cold":
        assert got["store"]["demote_cold"] > 0
        assert got["store"]["promote_warm_async"] > 0
        c = got["policy"]
        assert c["prefetch_hits"] > 0
        assert c["prefetch_issued"] == (c["prefetch_hits"]
                                        + c["prefetch_late"]
                                        + c["prefetch_wasted"]
                                        + c["prefetch_outstanding"])


@pytest.mark.parametrize("backend", ["gather", "pallas_int8"])
def test_decode_through_cold_round_trip_is_bit_identical(models, backend):
    """Page A is read warm by a decode step; then A goes cold, another page
    takes its warm slot, A comes back asynchronously into another slot,
    and the same step gives the same logits bit for bit."""
    _, _, tm, tparams = models
    geom = paged_geometry(tm.cfg, 16)
    store = TieredKVStore(geom, 8, hot_pages=3, warm_pages=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    pools = store.pools[0]
    pools["kh"].copy_(torch.randn(pools["kh"].shape, generator=gen))
    pools["vh"].copy_(torch.randn(pools["vh"].shape, generator=gen))
    for pid in range(3):                     # A = 0, B = 1 (write), C = 2
        store.place_hot(pid)
    store.demote_to_warm(0)
    lengths = torch.tensor([16 + 5], dtype=torch.int32)
    tokens = torch.tensor([[17]], dtype=torch.int32)

    def step():
        bt = torch.tensor([[store.encoded_loc(0), store.encoded_loc(1)]],
                          dtype=torch.int32)
        copy = ({k: v.clone() for k, v in pools.items()},)
        out, _ = tm.paged_decode_step(tparams, copy, tokens, bt, lengths,
                                      has_warm=True, backend=backend)
        return out

    before, slot = step(), int(store.slot[0])
    store.demote_to_cold(0)
    store.demote_to_warm(2)                  # C takes A's old warm slot
    assert int(store.slot[2]) == slot
    store.promote_to_warm(0, async_=True)
    assert store.commit_promotions() == 1
    assert int(store.slot[0]) != slot
    assert torch.equal(step(), before)
