#!/usr/bin/env python3
"""A tour of the port's compression stack, bottom to top.

    PYTHONPATH=src python examples/compression_tour_torch.py        # the card
    PYTHONPATH=src python examples/compression_tour_torch.py --device cpu \
        --elements 8192

The PyTorch counterpart of sections 1-3 of ``examples/compression_tour.py``:

1. scheme level: every lossless codec of the port's registry on five
   generators of ``--elements`` values each (default 12,845,056, one
   full-width Qwen2-7B q_proj), each round trip checked byte for byte,
   each ratio printed.  On the card uniform BDI encodes and decodes
   through its CUDA kernels where the tensor takes b2d1, b4d1 or b4d2, and
   C-Pack decodes through its kernel; bit planes run as PyTorch ops on
   the card; the packed BDI and FPC codecs run on the host, as the cold
   tier runs them;
2. kernel level: the int8-weight fused matmul and the lossless-BDI-weight
   fused matmul (b2d1-representable weights);
3. controller level: trigger/throttle on roofline terms.

Section 4 (BDI checkpoints) waits for the training slice.  The tour runs
on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.assist import (REGISTRY, AssistController,  # noqa: E402
                                RooflineTerms, SiteDescriptor)
from repro_torch.assist import bytesops as bo  # noqa: E402
from repro_torch.assist.schemes import bdi  # noqa: E402
from repro_torch.kernels.fused_matmul import ops as fm_ops  # noqa: E402
from repro_torch.kernels.fused_matmul.ref import (  # noqa: E402
    b2d1_weights, make_bdi_b2d1_layout, make_q8_layout, matmul_bdi_ref,
    matmul_q8_ref)

#: one full-width Qwen2-7B q_proj (3584 x 3584)
FULL_ELEMENTS = 3584 * 3584


def generators(n: int, seed: int = 0) -> dict:
    """The reference tour's five inputs of ``n`` values, drawn in its order
    from one seeded numpy generator (CPU tensors)."""
    rng = np.random.default_rng(seed)
    i32 = {}
    i32["low-range ints"] = rng.integers(0, 90, n) + 500_000
    i32["mostly zeros"] = rng.integers(0, 99, n) * (rng.random(n) < 0.05)
    i32["4-value dict"] = rng.integers(0, 2**30, 4)[rng.integers(0, 4, n)]
    bf16 = (rng.standard_normal(n) * 0.02).astype(np.float32)
    noise = rng.integers(0, 2**31, n)
    out = {k: torch.from_numpy(v.astype(np.int32)) for k, v in i32.items()}
    out["bf16 weights"] = torch.from_numpy(bf16).to(torch.bfloat16)
    out["pure noise"] = torch.from_numpy(noise.astype(np.int32))
    return out


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def round_trip(name: str, x: torch.Tensor) -> dict:
    """Compress and decompress ``x`` with registry codec ``name``; raise
    unless the bytes come back exactly.  Host ms of each half (ending in
    a device synchronize)."""
    task = REGISTRY.get(name)
    inp = bo.host_array(x) if task.host else x
    _sync(x.device)
    t0 = time.perf_counter()
    c = task.compress(inp)
    _sync(x.device)
    t1 = time.perf_counter()
    y = task.decompress(c)
    _sync(x.device)
    t2 = time.perf_counter()
    if task.host:
        exact = y.shape == inp.shape and np.array_equal(
            bo.to_bytes(y), bo.to_bytes(inp))
    else:
        exact = (y.shape == x.shape and y.dtype == x.dtype
                 and torch.equal(bo.to_bytes(y), bo.to_bytes(x)))
    if not exact:
        raise RuntimeError(f"{name}: the round trip changed the bytes")
    detail = ""
    if isinstance(c, bdi.BDIUniform):
        detail = bdi.ENCODINGS[c.enc_id][1]
    elif name == "cpack":
        detail = f"{int(c.ok.sum())}/{c.nblocks} blocks packed"
    elif name == "planes":
        detail = f"{int(c.ok.sum())}/{c.nblocks} hi planes in dict"
    return {"codec": name, "ratio": c.ratio(),
            "compressed_bytes": c.compressed_bytes(),
            "original_bytes": c.original_bytes(), "detail": detail,
            "compress_ms": 1e3 * (t1 - t0), "decompress_ms": 1e3 * (t2 - t1)}


def section_schemes(data: dict, label: str = "") -> dict:
    """Every lossless codec on every input -> {input: [row per codec]}."""
    rows = {}
    for name, x in data.items():
        rows[name] = [round_trip(codec, x)
                      for codec in REGISTRY.lossless_names()]
        cols = [f"{r['codec']}={r['ratio']:.4f}x" for r in rows[name]]
        print(f"   {label}{name:16s} " + "  ".join(cols))
        for r in rows[name]:
            print(f"      {r['codec']:10s} {r['compressed_bytes']:>12d} of "
                  f"{r['original_bytes']} B  compress "
                  f"{r['compress_ms']:9.2f} ms  decompress "
                  f"{r['decompress_ms']:8.2f} ms  {r['detail']}")
    return rows


def section_matmul(dev: torch.device, seed: int = 0) -> dict:
    """Both fused matmuls at 128 x 256 x 512 -> max |kernel - oracle| of
    each (on the CPU the wrappers run their plain forms)."""
    rng = np.random.default_rng(seed)
    K, N = 256, 512
    x = torch.from_numpy(rng.standard_normal((128, K)).astype(
        np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.05).astype(
        np.float32)).to(dev, torch.bfloat16)
    w8, scale = make_q8_layout(w, gk=256)
    y = fm_ops.matmul_q8(x, w8, scale, gk=256)
    err = float((y.float() - matmul_q8_ref(x, w8, scale, 256).float())
                .abs().max())
    print(f"   y = x @ dequant(w8): kernel-vs-oracle max err {err:.2e}; "
          f"weight bytes {w8.numel() + scale.numel() * 4:,} vs bf16 "
          f"{K * N * 2:,}")
    wb = b2d1_weights(K, N, seed).to(dev)
    base, mask, deltas, ok = make_bdi_b2d1_layout(wb)
    if not bool(ok.all()):
        raise RuntimeError("b2d1 layout of representable weights is lossy")
    yb = fm_ops.matmul_bdi(x, base, mask, deltas)
    err_bdi = float((yb.float() - matmul_bdi_ref(x, base, mask, deltas)
                     .float()).abs().max())
    nbytes = deltas.numel() + mask.numel() + base.numel() * 4
    print(f"   y = x @ bdi(base, mask, deltas): kernel-vs-oracle max err "
          f"{err_bdi:.2e}; weight bytes {nbytes:,} vs bf16 {K * N * 2:,} "
          f"(lossless: all {ok.numel()} blocks fit b2d1)")
    return {"matmul_q8": err, "matmul_bdi": err_bdi}


def section_controller():
    ctl = AssistController()
    for label, terms in [
            ("decode (memory-bound)", RooflineTerms(2e-4, 7e-3, 1e-3)),
            ("train (compute-bound)", RooflineTerms(9e-3, 3e-3, 1e-3))]:
        d = ctl.decide(terms, SiteDescriptor("weights", 4e9, "memory", True),
                       measured_ratio=1.9, scheme="bdi")
        print(f"   {label:24s} -> {'ENABLE' if d.enabled else 'reject'}: "
              f"{d.reason[:60]}")


def _banner(title: str):
    print("=" * 64)
    print(title)
    print("=" * 64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--elements", type=int, default=FULL_ELEMENTS,
                    help="values per generator")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to tour on the "
                         "CPU")
    _banner("1. Schemes on adversarial data (all lossless, checked)")
    data = {k: v.to(dev) for k, v in generators(args.elements,
                                                args.seed).items()}
    section_schemes(data)
    print()
    _banner("2. Fused decompress-matmul kernels (HBM moves compressed "
            "bytes)")
    section_matmul(dev, args.seed)
    print()
    _banner("3. Controller trigger/throttle (paper 4.4)")
    section_controller()
    print("\nTour complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
