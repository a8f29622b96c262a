"""Decoder stack over the repeating ``block_pattern``, attention only.

Counterpart of ``repro.models.transformer`` for stacks of plain ``attn``
layers (GQA attention + dense MLP).  The params dict mirrors the JAX
pytree leaf for leaf: ``params["scan"]`` is a tuple with one dict per
pattern position whose leaves carry a leading ``n_scan`` axis; the
reference's ``lax.scan`` is a Python loop over that axis that indexes
views and copies nothing.

Every other layer kind (MLA, MoE, SSM/RWKV, local windows, shared
attention, the audio encoder) raises ``NotImplementedError`` naming the
layers, in the form ``paged_unsupported_layers`` reports them.

Dense decode: each layer keeps a [B, G, max_len, dh] cache per slot,
bf16 or int8 with per-token scales (``kv_mode``), written in place at
each row's position; the attention is kernel 3 (``decode_attn_q8`` /
``decode_attn_raw`` in ``kernels/decode_attn/ops.py``), where the
reference leaves the same function to XLA.

Paged decode: the KV cache is a pool of fixed-size pages named by an
int32 block table whose entries encode the page's tier (loc > 0 hot slot,
loc < 0 warm slot -loc, 0 trash); the attention math is a pluggable
backend (``kernels/decode_attn/ops.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import quantized as Q
from repro_torch.serving import kv_cache as KV


# ---------------------------------------------------------------------------
# stack structure
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackPlan:
    head: tuple        # unstacked leading layer kinds
    pattern: tuple     # scanned repeating kinds
    n_scan: int
    tail: tuple        # unstacked trailing kinds


def stack_plan(cfg: ArchConfig) -> StackPlan:
    head = ()
    if cfg.moe is not None and cfg.moe.first_dense:
        head = ("attn_dense",) * cfg.moe.first_dense
    remaining = cfg.n_layers - len(head)
    pat = cfg.block_pattern
    tail = tuple(pat[: remaining % len(pat)])
    return StackPlan(head, pat, remaining // len(pat), tail)


def paged_unsupported_layers(cfg: ArchConfig) -> list:
    """Layers this port cannot run, as "position:kind" tags (an empty list
    means the stack is supported).  Only plain ``attn`` layers with GQA
    attention and a dense MLP are ported; MLA and MoE variants of ``attn``
    are tagged ``attn+mla`` / ``attn+moe``."""
    if cfg.frontend == "audio":
        return ["*:audio-encoder"]
    plan = stack_plan(cfg)
    bad = []
    for where, kinds in (("head", plan.head), ("pattern", plan.pattern),
                         ("tail", plan.tail)):
        for i, kind in enumerate(kinds):
            if kind != "attn":
                bad.append(f"{where}[{i}]:{kind}")
            elif cfg.mla is not None:
                bad.append(f"{where}[{i}]:attn+mla")
            elif cfg.moe is not None:
                bad.append(f"{where}[{i}]:attn+moe")
    if cfg.frontend != "none":
        bad.append(f"*:{cfg.frontend}-frontend")
    return bad


def check_supported(cfg: ArchConfig):
    """Raise NotImplementedError naming every layer the port cannot run."""
    bad = paged_unsupported_layers(cfg)
    if bad:
        raise NotImplementedError(f"{cfg.name}: layers {bad} not yet ported "
                                  f"(only plain GQA 'attn' layers are)")


def _layer(tree, i: int):
    """Views of layer ``i`` of a scan-stacked params/pools subtree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ArchConfig, lead: tuple = ()):
    return {"norm1": L.norm_init(cfg, gen.device, lead),
            "attn": L.gqa_init(gen, cfg, lead),
            "norm2": L.norm_init(cfg, gen.device, lead),
            "ffn": L.mlp_init(gen, cfg, lead)}


def block_apply_seq(cfg: ArchConfig, p, x, *, positions=None):
    """Full-sequence forward of one attn block -> (x_out, (k, v))."""
    h = L.norm_apply(cfg, p["norm1"], x)
    out, kv = L.gqa_apply(cfg, p["attn"], h, positions=positions)
    x = x + out
    h = L.norm_apply(cfg, p["norm2"], x)
    return x + L.mlp_apply(cfg, p["ffn"], h), kv


# ---------------------------------------------------------------------------
# full stack
# ---------------------------------------------------------------------------

def stack_init(gen: torch.Generator, cfg: ArchConfig):
    """Random bf16 weights from ``gen`` on ``gen.device``, in the JAX
    pytree layout (weights differ from the reference's: the generators
    differ)."""
    check_supported(cfg)
    plan = stack_plan(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    params: dict = {"final_norm": L.norm_init(cfg, gen.device)}
    params["embed"] = (torch.randn((V, D), generator=gen, device=gen.device)
                       * 0.02).to(torch.bfloat16)
    if not cfg.tie_embeddings:
        params["unembed"] = L._dense_init(gen, (D, V))
    params["scan"] = tuple(block_init(gen, cfg, (plan.n_scan,))
                           for _ in plan.pattern)
    return params


def _logits(cfg: ArchConfig, params, x):
    x = L.norm_apply(cfg, params["final_norm"], x)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (x @ w).float()


def stack_apply_seq(cfg: ArchConfig, params, batch, *, want_state: bool,
                    max_len: int | None = None, kv_mode: str = "bf16"):
    """Full-sequence forward (prefill).

    Returns (logits f32[B, S, V], state_or_None).  With ``want_state`` the
    KV of each layer is padded to ``max_len`` (>= S): ``state["scan"][j]``
    holds k/v [n_scan, B, G, max_len, dh] (``kv_mode="int8"``: k8/v8 and
    their f32 scales ks/vs, padded then quantized per token) and
    ``state["len"]`` the true lengths.  ``batch["true_len"]`` marks
    right-padding from bucketing; causal attention keeps pads out of real
    positions, so attention layers need nothing more.
    """
    check_supported(cfg)
    plan = stack_plan(cfg)
    x = params["embed"][batch["tokens"].long()]
    B, S, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    max_len = max_len or S
    per_pos = [([], []) for _ in plan.pattern]
    for i in range(plan.n_scan):
        for j, _ in enumerate(plan.pattern):
            x, (k, v) = block_apply_seq(cfg, _layer(params["scan"][j], i), x,
                                        positions=positions)
            if want_state:
                per_pos[j][0].append(k)
                per_pos[j][1].append(v)
    logits = _logits(cfg, params, x)
    if not want_state:
        return logits, None

    def stacked(xs):                     # -> [n_scan, B, G, max_len, dh]
        out = torch.stack(xs)
        return torch.nn.functional.pad(out, (0, 0, 0, max_len - S))

    def layer_state(ks, vs):
        k, v = stacked(ks), stacked(vs)
        if kv_mode == "int8":
            k8, k_sc = KV.quantize_token(k)
            v8, v_sc = KV.quantize_token(v)
            return {"k8": k8, "ks": k_sc, "v8": v8, "vs": v_sc}
        return {"k": k, "v": v}

    true_len = batch.get("true_len")
    state = {"scan": tuple(layer_state(ks, vs) for ks, vs in per_pos),
             "len": (true_len.to(torch.int32).expand(B).clone()
                     if true_len is not None
                     else torch.full((B,), S, dtype=torch.int32,
                                     device=x.device))}
    return logits, state


# ---------------------------------------------------------------------------
# dense decode (slot-batched cache, continuous-batching engine)
# ---------------------------------------------------------------------------

def block_init_state(cfg: ArchConfig, batch: int, max_len: int,
                     kv_mode: str = "bf16", device=None):
    """Fresh cache of one attn layer: bf16 k/v [B, G, max_len, dh] zeros,
    or int8 k8/v8 zeros with unit scales."""
    G, dh = cfg.n_kv_heads, cfg.head_dim
    if kv_mode == "int8":
        return KV.init_kv_int8(batch, G, max_len, dh, device=device)
    return {n: torch.zeros((batch, G, max_len, dh), dtype=torch.bfloat16,
                           device=device) for n in ("k", "v")}


def stack_init_state(cfg: ArchConfig, batch: int, max_len: int,
                     kv_mode: str = "bf16", device=None):
    """Fresh decode state of a batch: per-row lengths ``len`` int32[B] and
    one stacked cache per pattern position ([n_scan, B, ...] leaves)."""
    check_supported(cfg)
    if kv_mode not in KV.KV_MODES:
        raise ValueError(f"kv_mode must be one of {KV.KV_MODES}, got "
                         f"{kv_mode!r}")
    plan = stack_plan(cfg)

    def stacked(st):
        return {k: v[None].repeat((plan.n_scan,) + (1,) * v.dim())
                for k, v in st.items()}

    return {"len": torch.zeros((batch,), dtype=torch.int32, device=device),
            "scan": tuple(stacked(block_init_state(cfg, batch, max_len,
                                                   kv_mode, device))
                          for _ in plan.pattern)}


def _gqa_cached_decode(cfg, p, x, state, pos):
    """One layer's GQA decode against its dense cache (bf16 or int8).

    x: [B, 1, D]; pos: int32[B] per-row lengths.  This token's K/V is
    written IN PLACE at slot ``pos % W`` of each row, then attention runs
    over positions ``<= pos`` (lengths ``pos + 1``) through kernel 3."""
    from repro_torch.kernels.decode_attn import ops as attn_ops
    B = x.shape[0]
    compressed = "k8" in state
    W = (state["k8"] if compressed else state["k"]).shape[2]
    q, k_new, v_new = L.gqa_qkv(cfg, p, x, pos[:, None])
    slot = pos % W
    lengths = pos + 1
    q = q[:, :, 0].contiguous()
    if compressed:
        KV.update_kv_int8(state, k_new, v_new, slot)
        out = attn_ops.decode_attn_q8(q, state["k8"], state["ks"],
                                      state["v8"], state["vs"], lengths)
    else:
        rows = torch.arange(B, device=x.device)
        state["k"][rows, :, slot.long()] = k_new[:, :, 0]
        state["v"][rows, :, slot.long()] = v_new[:, :, 0]
        out = attn_ops.decode_attn_raw(q, state["k"], state["v"], lengths)
    return Q.qmatmul(out.reshape(B, 1, -1), p, "wo")


def block_apply_decode(cfg: ArchConfig, p, x, state, pos):
    """One-token decode of one attn block (its cache written in place).
    x: [B, 1, D]; pos: int32[B] lengths."""
    h = L.norm_apply(cfg, p["norm1"], x)
    x = x + _gqa_cached_decode(cfg, p["attn"], h, state, pos)
    h = L.norm_apply(cfg, p["norm2"], x)
    return x + L.mlp_apply(cfg, p["ffn"], h)


def stack_decode_step(cfg: ArchConfig, params, state, tokens):
    """One decode step.  tokens: int32[B, 1] -> (f32 logits [B, 1, V],
    state): the state is the same object, its caches and ``len`` updated
    in place."""
    check_supported(cfg)
    plan = stack_plan(cfg)
    pos = state["len"]
    x = params["embed"][tokens.long()]
    for i in range(plan.n_scan):
        for j, _ in enumerate(plan.pattern):
            x = block_apply_decode(cfg, _layer(params["scan"][j], i), x,
                                   _layer(state["scan"][j], i), pos)
    state["len"] += 1
    return _logits(cfg, params, x), state


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagedSegment:
    """One pool-owning slice of the stack: a scanned pattern position."""
    name: str          # "pat_0"
    kind: str
    n_stack: int


def paged_segments(cfg: ArchConfig) -> tuple:
    """Pool-tuple layout of a supported stack: one segment per pattern
    position."""
    check_supported(cfg)
    plan = stack_plan(cfg)
    return tuple(PagedSegment(f"pat_{j}", kind, plan.n_scan)
                 for j, kind in enumerate(plan.pattern))


def paged_geometry(cfg: ArchConfig, page_size: int):
    """Per-segment page shapes wrapped in a PageGeometry -- the single
    source of page shapes for the engine and the tiered store."""
    from repro_torch.cache.tiers import PageGeometry, SegmentGeometry
    plan = stack_plan(cfg)
    geoms = tuple(SegmentGeometry("attn_kv", s.n_stack, cfg.n_kv_heads,
                                  page_size, cfg.head_dim, cfg.head_dim)
                  for s in paged_segments(cfg))
    return PageGeometry(n_pat=len(plan.pattern), n_scan=plan.n_scan,
                        n_kv_heads=cfg.n_kv_heads, page_size=page_size,
                        head_dim=cfg.head_dim, segments=geoms)


def _gqa_paged_decode(cfg, p, x, pools_j, bt, lengths, *, has_warm: bool,
                      backend: str = "gather", window: int = 0):
    """One layer's paged GQA decode.

    x: [B, 1, D]; pools_j: one layer's views of the tier pools (kh/vh
    [1+hot, G, ps, dh], k8/v8 [1+warm, G, ps, dh], ks/vs [1+warm, G, ps]);
    bt: int32[B, max_pages] encoded locations; lengths: int32[B].  The new
    token's K/V is written IN PLACE into its page (lengths // ps), which
    must be hot; idle lanes write into the trash slot.
    """
    from repro_torch.kernels.decode_attn import ops as attn_ops
    B = x.shape[0]
    kh, vh = pools_j["kh"], pools_j["vh"]
    ps = kh.shape[2]
    q, k_new, v_new = L.gqa_qkv(cfg, p, x, lengths[:, None])
    wp, offs = (lengths // ps).long(), (lengths % ps).long()
    locs_w = bt.gather(1, wp[:, None])[:, 0].long()
    kh[locs_w, :, offs] = k_new[:, :, 0, :].to(kh.dtype)
    vh[locs_w, :, offs] = v_new[:, :, 0, :].to(vh.dtype)
    out = attn_ops.get_attn_backend(backend)(
        q[:, :, 0].contiguous(), pools_j, bt, lengths + 1, window=window,
        has_warm=has_warm)                                  # [B, H, dh]
    return Q.qmatmul(out.reshape(B, 1, -1), p, "wo")


def block_apply_paged_decode(cfg: ArchConfig, p, x, pools_j, bt, lengths, *,
                             has_warm: bool = True, backend: str = "gather"):
    """One attn layer's paged decode (pools written in place)."""
    h = L.norm_apply(cfg, p["norm1"], x)
    x = x + _gqa_paged_decode(cfg, p["attn"], h, pools_j, bt, lengths,
                              has_warm=has_warm, backend=backend)
    h = L.norm_apply(cfg, p["norm2"], x)
    return x + L.mlp_apply(cfg, p["ffn"], h)


def stack_paged_decode_step(cfg: ArchConfig, params, pools, tokens, bt,
                            lengths, *, has_warm: bool = True,
                            backend: str = "gather"):
    """One paged decode step over the stack.

    pools: tuple of tier pool dicts, one per :func:`paged_segments` entry
    (leading axis = the segment's layers); tokens: int32[B, 1]; bt:
    int32[B, max_pages]; lengths: int32[B].  Returns (f32 logits
    [B, 1, V], pools): the pools are the same objects, updated in place
    with this tick's K/V rows.
    """
    check_supported(cfg)
    plan = stack_plan(cfg)
    x = params["embed"][tokens.long()]
    for i in range(plan.n_scan):
        for j, _ in enumerate(plan.pattern):
            x = block_apply_paged_decode(
                cfg, _layer(params["scan"][j], i), x, _layer(pools[j], i),
                bt, lengths, has_warm=has_warm, backend=backend)
    return _logits(cfg, params, x), pools
