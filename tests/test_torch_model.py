"""The port's model functions against the JAX reference on converted weights.

``reduced(qwen2-7b)`` (2 layers, d=128, GQA 4/2, QKV bias) is initialised
by the reference and carried across with ``repro_torch.convert``.  Compared:
prefill logits (with bucket padding marked by ``true_len``) and one
``paged_decode_step`` on identical pools and tables for every backend,
with and without warm pages.

Tolerance: logits are f32 casts of a bf16 product, and both frameworks
round the bf16 activations at the same places but accumulate in another
order, so a rounding may flip by one bf16 ulp and travel on through the
stack.  The logits here are at most ~4 in magnitude (bf16 ulp 0.03125 at
4); ``LOGIT_ATOL = 0.0625`` allows two such ulps.  Measured max |d logit|
on the CPU: prefill 0.0430, decode step 0.0391.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch.configs import ARCHS, get_arch, reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import (build_model, n_prompt_buckets,  # noqa: E402
                                      prompt_bucket)

BACKENDS = ("gather", "pallas", "pallas_int8")


LOGIT_ATOL = 0.0625


@pytest.fixture(scope="module")
def models():
    jcfg = j_reduced(J_ARCHS["qwen2-7b"])
    jm = j_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(reduced(ARCHS["qwen2-7b"]))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm, tparams


def test_configs_are_the_reference_configs():
    for name, cfg in ARCHS.items():
        ref = J_ARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), name
        assert cfg.param_count() == ref.param_count()
        assert dataclasses.asdict(reduced(cfg)) == \
            dataclasses.asdict(j_reduced(ref))
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("nope")


def test_params_convert_leaf_for_leaf(models):
    jm, jparams, tm, tparams = models
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            tl.append((path, node))

    walk(tparams, ())
    assert len(jl) == len(tl)
    for (jp, ja), (_, ta) in zip(jl, tl):
        a = np.asarray(ja)
        assert tuple(ta.shape) == a.shape, jp
        if a.dtype.name == "bfloat16":
            assert ta.dtype == torch.bfloat16
            np.testing.assert_array_equal(ta.view(torch.uint16).numpy(),
                                          a.view(np.uint16))
        else:
            np.testing.assert_array_equal(ta.numpy(), a)


@pytest.mark.parametrize("plen,bucket", [(23, 32), (16, 16), (9, 16)])
def test_prefill_logits_match(models, plen, bucket):
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(plen)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :plen] = rng.integers(2, 500, plen)
    tl = np.array([plen], np.int32)
    max_len = -(-bucket // 16) * 16 + 16
    jl, jst = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                   "true_len": jnp.asarray(tl)}, max_len,
                         paged_layout=True)
    tl_, tst = tm.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                    "true_len": torch.from_numpy(tl)},
                          max_len)
    ref = np.asarray(jl)[:, :plen]
    got = tl_.numpy()[:, :plen]
    err = np.abs(got - ref).max()
    assert err <= LOGIT_ATOL, f"prefill max|d logit| {err}"
    # the padded run's real positions equal the unpadded run's
    un, _ = tm.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :plen])},
                       max_len)
    np.testing.assert_array_equal(un.numpy(), tl_.numpy()[:, :plen])
    # KV state: [n_scan, B, G, max_len, dh], padded past the bucket
    jk = np.asarray(jst["scan"][0]["k"], np.float32)
    tk = tst["scan"][0]["k"].float().numpy()
    assert tk.shape == jk.shape
    assert np.abs(tk[..., :plen, :] - jk[..., :plen, :]).max() <= 0.0625
    assert int(tst["len"][0]) == plen


def _pools(cfg, rng, n_hot=6, n_warm=5, ps=16):
    """One segment's pools [n_scan, 1+N, G, ps, dh], NaN in the trash."""
    n, G, dh = T.stack_plan(cfg).n_scan, cfg.n_kv_heads, cfg.head_dim
    kh = np.array(jnp.asarray(rng.standard_normal((n, 1 + n_hot, G, ps, dh)),
                              jnp.bfloat16))
    vh = np.array(jnp.asarray(rng.standard_normal((n, 1 + n_hot, G, ps, dh)),
                              jnp.bfloat16))
    kh[:, 0] = np.nan
    vh[:, 0] = np.nan
    k8 = rng.integers(-127, 128, (n, 1 + n_warm, G, ps, dh)).astype(np.int8)
    v8 = rng.integers(-127, 128, (n, 1 + n_warm, G, ps, dh)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (n, 1 + n_warm, G, ps)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (n, 1 + n_warm, G, ps)).astype(np.float32)
    return {"kh": kh, "vh": vh, "k8": k8, "v8": v8, "ks": ks, "vs": vs}


@pytest.mark.parametrize("has_warm", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_paged_decode_step_matches(models, backend, has_warm):
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(7)
    pools = _pools(tm.cfg, rng)
    # lanes: 3 pages (write page 2 hot), 2 pages, idle (trash)
    if has_warm:
        bt = np.array([[-1, 2, 3, 0], [4, -2, 0, 0], [0, 0, 0, 0]], np.int32)
    else:
        bt = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    bt[1, 1] = 5                       # lane 1 writes page 1: must be hot
    lengths = np.array([37, 20, 0], np.int32)
    tokens = rng.integers(2, 500, (3, 1)).astype(np.int32)
    jl, jpools = jm.paged_decode_step(
        jparams, ({k: jnp.asarray(v) for k, v in pools.items()},),
        jnp.asarray(tokens), jnp.asarray(bt), jnp.asarray(lengths),
        has_warm=has_warm, backend=backend, interpret=True)
    tpools = ({k: torch.from_numpy(v.view(np.uint16).copy()).view(
        torch.bfloat16) if v.dtype.name == "bfloat16"
        else torch.from_numpy(v.copy()) for k, v in pools.items()},)
    tl, tp = tm.paged_decode_step(tparams, tpools, torch.from_numpy(tokens),
                                  torch.from_numpy(bt),
                                  torch.from_numpy(lengths),
                                  has_warm=has_warm, backend=backend)
    assert tp is tpools                              # updated in place
    ref = np.asarray(jl)[:2, 0]
    got = tl.numpy()[:2, 0]
    err = np.abs(got - ref).max()
    assert err <= LOGIT_ATOL, f"{backend}: max|d logit| {err}"
    # this tick's K/V rows landed at (write slot, offset) in every layer
    for b in range(2):
        slot, off = bt[b, lengths[b] // 16], lengths[b] % 16
        jk = np.asarray(jpools[0]["kh"][:, slot, :, off], np.float32)
        tk = tp[0]["kh"][:, slot, :, off].float().numpy()
        assert np.abs(tk - jk).max() <= 0.0625


def test_prompt_buckets_match_reference():
    from repro.models.model import n_prompt_buckets as j_nb
    from repro.models.model import prompt_bucket as j_pb
    for max_len in (48, 64, 512):
        assert n_prompt_buckets(max_len) == j_nb(max_len)
        for plen in range(1, max_len + 1):
            assert prompt_bucket(plen, max_len) == j_pb(plen, max_len)
    with pytest.raises(ValueError):
        prompt_bucket(65, 64)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_unported_layers_raise_by_name(name):
    """Only plain GQA ``attn`` layers are ported; every other layer kind
    raises NotImplementedError naming its position."""
    cfg = reduced(ARCHS[name])
    bad = T.paged_unsupported_layers(cfg)
    if not bad:
        build_model(cfg)
        return
    with pytest.raises(NotImplementedError) as e:
        build_model(cfg)
    for tag in bad:
        assert tag in str(e.value)
