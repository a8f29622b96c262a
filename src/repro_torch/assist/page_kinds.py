"""Page-kind taxonomy for the paged decode path (DESIGN.md 10.6).

The paged/tiered machinery originally knew exactly one shape of page:
``page_size`` tokens of per-head attention K/V.  The CABA framing says the
same trigger/throttle/priority machinery should host *many* kinds of
assist work over the same idle resources; for the cache that means many
kinds of *page*:

  attn_kv      per-head K/V of ``page_size`` tokens (GQA / local-window /
               weight-shared attention) -- the original kind
  mla_latent   the absorbed-decode MLA latent: ``kv_lora_rank`` floats of
               compressed KV plus ``rope_head_dim`` floats of shared rope
               key per token, ONE head -- the architecture's own KV
               compression, which the tier ladder's int8/cold packing
               then compounds
  state_slab   the fixed-size recurrence state of an SSM/RWKV layer
               ([H, K, V] + conv / token-shift planes), flattened to one
               NON-GROWING slab per request: allocated once at admission,
               demotable/promotable like any page, int8 when parked

A ``PageKind`` records the three facts the tiered store and the sharing
machinery dispatch on: whether the kind grows with tokens
(page-per-``page_size``-tokens vs one slab per request -- this decides
which slot space and which pool segments a page of that kind occupies),
whether parking it may be lossy (``TieredKVStore.demote_to_warm``
refuses to int8-quantize a kind that declares ``lossy_park=False``), and
whether pages of the kind may be SHARED read-only across requests
(``shareable``).  Token pages are shareable because causal attention
makes a shared token prefix yield identical K/V (or MLA latents)
regardless of suffix; state slabs are NOT -- a recurrence state at
position i summarizes the whole sequence so far and is cheap to park
but meaningless to alias between requests that will diverge.  The
geometry itself (heads,
widths, rows) is per-model and lives in ``repro_torch.cache.tiers.
SegmentGeometry``; this module is the kind registry those descriptors
reference.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PageKind:
    """One kind of page the tiered store can host."""
    name: str
    grows: bool        # True: one page per page_size tokens; False: one
    #                    fixed slab per request
    lossy_park: bool   # demotion to the warm tier quantizes (bounded err);
    #                    False = must park through a lossless path only
    shareable: bool = False  # may one physical page back several
    #                    requests' block tables (refcounted read-only
    #                    prefix sharing + COW)?  Token pages yes; state
    #                    slabs never.


ATTN_KV = PageKind("attn_kv", grows=True, lossy_park=True, shareable=True)
MLA_LATENT = PageKind("mla_latent", grows=True, lossy_park=True,
                      shareable=True)
STATE_SLAB = PageKind("state_slab", grows=False, lossy_park=True,
                      shareable=False)

PAGE_KINDS: dict = {k.name: k for k in (ATTN_KV, MLA_LATENT, STATE_SLAB)}


def page_kind(name: str) -> PageKind:
    try:
        return PAGE_KINDS[name]
    except KeyError:
        raise KeyError(f"unknown page kind {name!r}; "
                       f"registered: {sorted(PAGE_KINDS)}") from None
