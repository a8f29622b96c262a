"""End-to-end serving entry point of the port.

    # the dense engine: one [slots, max_len] cache, bf16 or int8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --kv-mode int8

    # the paged, tiered KV cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --paged --attn-backend pallas_int8

    # on the CPU, at the reduced test size (kernels run their plain forms)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --reduced --paged --device cpu --requests 4 --max-new 6

Without ``--paged`` the dense ``Engine`` serves, its decode attention
through the dense decode kernel (``--kv-mode``: bf16 or int8 cache).

``--attn-backend`` names the paged decode attention (kernels/decode_attn/
ops.py): gather (plain PyTorch), pallas (the paged CUDA kernel), pallas_int8
(the tiered CUDA kernel, warm pages dequantized after the load).  The cold
tier is on: at a budget that hot + warm pages cannot hold (for example
``--hbm-budget-mb 0.2`` at the reduced size), pages spill to packed host
records and ``cold tier:`` shows the demotions, promotions and schemes.  Engine
construction goes through ``ServeConfig.build()``.  Weights are random,
drawn on the device from ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs.base import DEFAULT_EOS_ID
from repro_torch.kernels.decode_attn.ops import attn_backend_names
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=DEFAULT_EOS_ID,
                    help="end-of-sequence token id (stops a request)")
    ap.add_argument("--kv-mode", default="bf16", choices=("bf16", "int8"),
                    help="dense engine cache mode")
    ap.add_argument("--paged", action="store_true",
                    help="use the paged, tiered KV cache")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--hbm-budget-mb", type=float, default=64.0)
    ap.add_argument("--max-cold-pages", type=int, default=None,
                    help="cap on cold (host-offloaded) page ids; default "
                         "derives from the host budget / device pools")
    ap.add_argument("--attn-backend", default="gather",
                    choices=attn_backend_names(),
                    help="paged decode attention backend")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the card; 'cpu' "
                         "runs the plain forms of the kernels)")
    args = ap.parse_args(argv)
    fields = {f.name for f in dataclasses.fields(ServeConfig)}
    scfg = ServeConfig(**{k: v for k, v in vars(args).items()
                          if k in fields})
    eng, model, _ = scfg.build()
    cfg = model.cfg
    rng = np.random.default_rng(scfg.seed)
    t0 = time.time()
    for rid in range(scfg.requests):
        plen = int(rng.integers(4, scfg.max_len - scfg.max_new - 1))
        eng.submit(Request(rid=rid,
                           prompt=list(rng.integers(2, cfg.vocab_size,
                                                    plen)),
                           max_new=scfg.max_new))
    done = eng.run()
    eng.sync()
    dt = time.time() - t0
    n_tok = sum(len(r.out) for r in done)
    for r in sorted(done, key=lambda r: r.rid)[:8]:
        print(f"req {r.rid:3d}: prompt={len(r.prompt):3d} tok "
              f"-> {r.out[:8]}{'...' if len(r.out) > 8 else ''}")
    mode = (f"paged/{scfg.attn_backend}" if scfg.paged
            else f"dense/{scfg.kv_mode}")
    print(f"\n{len(done)} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / dt:.1f} tok/s, {mode} on {eng.device})")
    s = eng.stats()
    if not scfg.paged:
        print(f"engine stats: {s}")
        return done
    cold = s["cold"]
    print(f"cache stats: {s}")
    print(f"cold tier: demote_cold {s['store']['demote_cold']}, "
          f"promote_warm {s['store']['promote_warm']} (async "
          f"{s['store']['promote_warm_async']}), prefetch {s['policy']}, "
          f"packed {cold['packed_bytes_total']} of "
          f"{cold['raw_bytes_total']} raw bytes, schemes "
          f"{cold['schemes']}")
    return done


if __name__ == "__main__":
    main()
