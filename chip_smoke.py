#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py                  # every phase, one card

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device   the card's name and power limit (nvidia-smi); no card -> fail
2. build    compile the CUDA sources with nvcc into build/kernels/, one nvcc
            per source, all at once, and print what ptxas says about each
            kernel (registers, smem, spills)
3. kernels  each paged-decode kernel against its plain PyTorch form at the
            main path's shapes (B=4, H=28, G=4, D=128, page 16, 32 pages, a
            mixed hot/warm/trash table with NaN in the trash slot, window 0
            and 64), then timed with CUDA events beside the plain form, one
            PyTorch call as yardstick and the byte/operation bound; then the
            cold tier's BDI and FPC decode kernels, bit for bit against their
            plain forms, on streams packed from a promotion batch of
            full-width warm planes (int8[28, 4, 16, 128], 448 blocks each),
            raw and delta'd, and on synthetic streams that take every BDI
            encoding id and every FPC pattern, then timed on one plane;
            then the dense decode-attention kernel, int8 and bf16 KV, at
            B=4, H=28, G=4, S=512, D=128 with lengths 512, 301, 77 and 1
            and NaN beyond them, and the int8-weight matmul at Qwen2-7B's
            projection shapes (K x N 3584x3584, 3584x512, 3584x18944,
            18944x3584; M = the dense phase's 4 slots and its prompt
            buckets, and a ragged 160; gk = K with the scale rounded to
            bf16, as served, and gk = 256), each against its plain form
            and timed beside it, one PyTorch call and the bound, and one
            layer's projections at each K-split target
4. serve    full-width Qwen2-7B (28 layers, random weights from a seed)
            through ServeConfig(...).build() with backends pallas_int8 and
            pallas: 24 requests, 4 lanes, a 64 MiB page budget (36 hot + 72
            warm pages, 1,728 tokens) against 3,360 tokens of load, so pages
            go warm and cold and come back.  (At 32 MiB the controller
            throttles compression -- the KV it would save is too small
            beside the weights -- and nothing is demoted; with 16 requests
            the four lanes' protected pages keep admission from filling the
            warm tier, and nothing goes cold.); after a warm-up on a throwaway
            engine, launch counters are zeroed before and read after each
            run (the cold tier's counters and host costs are printed), then
            a few profiled ticks show where the device time goes.  Then one
            decode step on identical pools with pallas_int8 and gather, and
            a teacher-forced prefill over every served request
5. dense   the same full-width weights through the dense Engine
            (ServeConfig(paged=False)): 4 slots, max_len 512, 8 requests of
            64-160 seeded prompt tokens and 32 new tokens, no EOS, with raw
            weights + bf16 KV, raw weights + int8 KV and quantize_params'd
            weights (quantized on the card) + int8 KV; per setting the
            launch counts of that run (decode_attn once per layer and
            tick; matmul_q8 only with q8 weights, 7 per layer and prefill
            or tick), tokens/s, ms/tick, params and KV bytes, a few
            profiled ticks and the teacher-forced-prefill margin check

Before its last line it prints one JSON object with every kernel's
numbers; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))     # the seeded codec inputs

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.assist.schemes import bdi, fpc  # noqa: E402
from repro_torch.cache.tiers import delta_seq  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bdi import ops as bdi_ops  # noqa: E402
from repro_torch.kernels.decode_attn import dense  # noqa: E402
from repro_torch.kernels.decode_attn import paged as pg  # noqa: E402
from repro_torch.kernels.fpc import ops as fpc_ops  # noqa: E402
from repro_torch.kernels.fused_matmul import ops as fm_ops  # noqa: E402
from repro_torch.kernels.fused_matmul.ref import make_q8_layout  # noqa: E402
from repro_torch.models.model import prompt_bucket  # noqa: E402
from repro_torch.models.quantized import (params_bytes,  # noqa: E402
                                          quantize_params)
from repro_torch.serving.kv_cache import kv_bytes  # noqa: E402
from repro_torch.serving.config import ServeConfig  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.kv_cache import quantize_token  # noqa: E402
from torch_codec_inputs import bdi_blocks, fpc_blocks, kv_plane  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet), the denominators of bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12           # CUDA-core fp32: the attention kernels
BF16_MMA_OPS_PER_S = 989e12     # dense bf16 tensor cores: matmul_q8

# kernel phase shapes: the main path's (full-width Qwen2-7B, 4 lanes)
B, H, G, D, PS, NP = 4, 28, 4, 128, 16, 32
LENGTHS = (512, 301, 77, 0)
WINDOWS = (0, 64)
# kernel vs plain form, bf16 output: both accumulate in f32 in another
# order, then round once to bf16, so an element may differ by one bf16 ulp
# of its value, at most 2^-7 |x| (KERNEL_RTOL), plus KERNEL_ATOL for
# elements near 0.  Outputs here reach |x| 1.29; the largest difference
# measured on an H100 80GB HBM3 was 9.8e-4.
KERNEL_ATOL = 1e-4
KERNEL_RTOL = 2.0 ** -7
# pallas_int8 vs gather decode step (28 layers, identical pools): the two
# scale q before/after the dot and sum in another order; bf16 roundings
# that flip propagate through the 28 layers.  Random-weight logits are
# ~N(0, 1) with max |logit| ~ 5; measured 0.176 on an H100 80GB HBM3.
LOGIT_ATOL = 0.25
# served tokens vs a teacher-forced prefill over the served context: the
# decode reads warm pages as int8 (and sums in another order), so the two
# may pick different tokens only where the prefill's top-1/top-2 margin is
# small; measured largest such margin 0.0625 on an H100 80GB HBM3.
TEACHER_MARGIN = 0.125
TIMING_ITERS = 50
SPIN_CYCLES = 2_000_000         # about 1.1 ms at the H100's 1.755 GHz boost
# dense kernels (phase 3): the dense serve path's shapes
DENSE_S = 512
DENSE_LENGTHS = (512, 301, 77, 1)
# Qwen2-7B's seven projections of one layer, (K, N): wq, wk, wv, wo, wi,
# wg, ffn wo
PROJ = ((3584, 3584), (3584, 512), (3584, 512), (3584, 3584),
        (3584, 18944), (3584, 18944), (18944, 3584))
# matmul_q8 runs at M = the dense phase's slots (decode) and its prompts'
# buckets (prefill: dense_matmul_m); 160 rows, 2.5 tiles of 64, is checked
# as the ragged edge
RAGGED_M = 160
SPLIT_TARGETS = (1, 2, 4, 8)    # matmul_q8 blocks per SM, swept when timed
# matmul_q8 vs its plain form: both sum in f32 in another order and round
# once to bf16 -- one bf16 ulp of the element (KERNEL_RTOL) plus 2^-12 of
# the largest output for the order of the f32 sums
MATMUL_ATOL_SHARE = 2.0 ** -12

SERVE = dict(arch="qwen2-7b", paged=True, slots=4, max_len=512,
             page_size=16, hbm_budget_mb=64.0, max_new=32, seed=0,
             eos_id=-1)          # no EOS: every request decodes max_new
N_REQUESTS = 24
LAYERS = 28
DENSE_SERVE = dict(arch="qwen2-7b", paged=False, slots=4, max_len=512,
                   max_new=32, seed=0, eos_id=-1)
N_DENSE_REQUESTS = 8
WARM_PROMPTS = (64, 100, 160)   # prompt lengths of the warm-up engines
DENSE_SETTINGS = (("raw", "bf16"), ("raw", "int8"), ("q8", "int8"))
# one warm plane of full-width Qwen2-7B: 28 layers x 4 KV heads x 16
# tokens x 128 = 229,376 B = 448 blocks of 512 B; a promotion batch of
# COLD_PAGES pages has a k8 and a v8 plane each
COLD_PLANE = (28, 4, 16, 128)
COLD_PAGES = 4
SOURCES = {
    "paged_decode_attn": "decode_attn/paged_decode_attn",
    "paged_decode_attn_tiered": "decode_attn/paged_decode_attn",
    "bdi_packed_decode": "bdi/bdi_packed_decode",
    "fpc_decode": "fpc/fpc_decode",
    "decode_attn": "decode_attn/decode_attn",
    "matmul_q8": "fused_matmul/matmul_q8"}
REPLACES = {"paged_decode_attn": "src/repro/kernels/decode_attn/paged.py:99",
            "paged_decode_attn_tiered":
                "src/repro/kernels/decode_attn/paged.py:175",
            "bdi_packed_decode": "src/repro/kernels/bdi/bdi.py:244",
            "fpc_decode": "src/repro/kernels/fpc/fpc.py:103",
            "decode_attn": "src/repro/kernels/decode_attn/decode_attn.py:81",
            "matmul_q8": "src/repro/kernels/fused_matmul/fused_matmul.py:62"}
COUNTERS = (pg.LAUNCHES, bdi_ops.LAUNCHES, fpc_ops.LAUNCHES, dense.LAUNCHES,
            fm_ops.LAUNCHES)


def source_file(name: str) -> str:
    return str(build.source_path(SOURCES[name]).relative_to(ROOT))


def reset_launches():
    pg.reset_launches()
    bdi_ops.reset_launches()
    fpc_ops.reset_launches()
    dense.reset_launches()
    fm_ops.reset_launches()


def launches() -> dict:
    return {k: v for c in COUNTERS for k, v in c.items()}


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"FAIL: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


# -- phase 1 / 2 ---------------------------------------------------------------

def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = nvidia_smi()
    print(smi)
    print(f"[device] {torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    built = build.load_all(sorted(set(SOURCES.values())))
    print(f"[build] {', '.join(str(b.path.relative_to(ROOT)) for b in built)}"
          f" ({time.perf_counter() - t0:.1f} s, one nvcc per source in "
          f"parallel)")
    for b in built:
        for line in b.ptxas_log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "Function properties")):
                print(f"[ptxas] {line.strip()}")


# -- phase 3 -------------------------------------------------------------------

def kernel_inputs(dev):
    """Pools, a mixed encoded table, lengths and queries at the main
    path's shapes; the trash slot 0 holds NaN (hot) / NaN scales (warm)."""
    rng = np.random.default_rng(0)
    n_slots = B * NP

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, torch.bfloat16)

    q = bf16((B, H, D))
    kh, vh = bf16((1 + n_slots, G, PS, D)), bf16((1 + n_slots, G, PS, D))
    kh[0] = float("nan")
    vh[0] = float("nan")
    k8, ks = quantize_token(bf16((1 + n_slots, G, PS, D)))
    v8, vs = quantize_token(bf16((1 + n_slots, G, PS, D)))
    ks[0] = float("nan")
    vs[0] = float("nan")
    bt = np.zeros((B, NP), np.int32)
    hot_slots = rng.permutation(n_slots) + 1
    warm_slots = rng.permutation(n_slots) + 1
    for b, L in enumerate(LENGTHS):
        for s in range(-(-L // PS)):
            j = b * NP + s
            bt[b, s] = hot_slots[j] if rng.random() < 0.5 else -warm_slots[j]
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    return dict(q=q, kh=kh, vh=vh, k8=k8, ks=ks, v8=v8, vs=vs,
                bt=torch.from_numpy(bt).to(dev), lengths=lengths)


def pages_needed(window: int):
    """(lane, page) pairs holding at least one valid position, and the
    valid position count: what this data makes the kernels read."""
    pages, n_valid = [], 0
    for b, L in enumerate(LENGTHS):
        lo = max(L - window, 0) if window else 0
        pages += [(b, s) for s in range(lo // PS, -(-L // PS))]
        n_valid += L - lo
    return pages, n_valid


def bound(bt_host, kv_page_bytes, window: int):
    """(bound_ms, bound_by): each needed byte read once / each output byte
    written once over the memory rate, against the fp32 operations over the
    CUDA-core rate."""
    pages, n_valid = pages_needed(window)
    kv = sum(kv_page_bytes(int(bt_host[b, s])) for b, s in pages) * G
    nbytes = (2 * B * H * D * 2          # q read + out written (bf16)
              + 4 * len(pages) + 4 * B + kv)
    ops_ = 4 * H * D * n_valid           # q.k and p.v multiply-adds
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, flush) -> float:
    """Mean device time of ``fn`` over TIMING_ITERS launches, CUDA events
    around each, L2 flushed between (decode finds a layer's KV cold).  A
    spin of about 1 ms on the card before each start event keeps the
    launches of ``fn`` queued ahead of the card, so a call whose host work
    (the wrapper's checks, allocation, the ctypes call) takes less than
    the spin is timed without it; a plain form issuing more than 1 ms of
    launches is still timed with its host cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(TIMING_ITERS)]
    for start, end in ev:
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / TIMING_ITERS


def sdpa_ms(x, flush) -> float:
    """Yardstick: one scaled_dot_product_attention over the same pages
    gathered into a dense bf16 KV beforehand, with the same length mask
    (timed here only; the port never calls it)."""
    bt, lengths = x["bt"], x["lengths"]
    is_warm = (bt < 0).repeat_interleave(PS, dim=1)[:, None, :, None]
    hot_bt, warm_bt = bt.clamp(min=0), (-bt).clamp(min=0)

    def dense(hot, q8, sc):
        warm = (pg.gather_pool(x[q8], warm_bt).float()
                * pg.gather_scales(x[sc], warm_bt)[..., None])
        return torch.where(is_warm, warm, pg.gather_pool(x[hot], hot_bt))

    pos = torch.arange(NP * PS, device=bt.device)[None, :]
    valid = (pos < lengths[:, None])[:, None, :, None]
    k = torch.where(valid, dense("kh", "k8", "ks"), 0).to(torch.bfloat16)
    v = torch.where(valid, dense("vh", "v8", "vs"), 0).to(torch.bfloat16)
    q4, mask = x["q"][:, :, None, :], valid[:, :, :, 0][:, :, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask, enable_gqa=True), flush)


def phase_kernels(dev) -> dict:
    x = kernel_inputs(dev)
    q, bt, lengths = x["q"], x["bt"], x["lengths"]
    bt_host = bt.cpu().numpy()
    # the pallas backend's inputs with warm pages: one f32 pool, warm slot
    # w remapped to n_hot + w (ops.attn_backend_pallas)
    n_hot = x["kh"].shape[0]
    k32 = torch.cat([x["kh"].float(), x["k8"].float() * x["ks"][..., None]])
    v32 = torch.cat([x["vh"].float(), x["v8"].float() * x["vs"][..., None]])
    bt32 = torch.where(bt < 0, n_hot - bt, bt)
    # bf16 pools and int8 pools each through the table's slot numbers
    bt_abs = bt.abs()

    def tiered(fn, w):
        return fn(q, x["kh"], x["vh"], x["k8"], x["ks"], x["v8"], x["vs"],
                  bt, lengths, window=w)

    cases = {
        "paged_decode_attn_tiered": [
            (f"mixed w={w}", lambda w=w: tiered(pg.paged_decode_attn_tiered,
                                                w),
             lambda w=w: tiered(pg.paged_decode_attn_tiered_plain, w))
            for w in WINDOWS],
        "paged_decode_attn": [
            (f"{name} w={w}",
             lambda a=a, w=w: pg.paged_decode_attn(*a, window=w),
             lambda a=a, w=w: pg.paged_decode_attn_plain(*a, window=w))
            for w in WINDOWS
            for name, a in (
                ("f32", (q, k32, None, v32, None, bt32, lengths)),
                ("bf16", (q, x["kh"], None, x["vh"], None, bt_abs, lengths)),
                ("int8", (q, x["k8"], x["ks"], x["v8"], x["vs"], bt_abs,
                          lengths)))],
    }
    errs = {}
    for name, runs in cases.items():
        worst = 0.0
        for label, kern, plain in runs:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{name} [{label}]: non-finite output")
            d = (got.float() - want.float()).abs()
            err = d.max().item()
            # largest difference as a share of its element's tolerance
            used = (d / (KERNEL_ATOL + KERNEL_RTOL * want.float().abs())
                    ).max().item()
            print(f"[kernels] {name} [{label}] max|d| vs plain {err:.3e} "
                  f"= {used:.2f} of the tolerance (atol {KERNEL_ATOL} + "
                  f"2^-7 |out|; max|out| {want.float().abs().max().item():.3f})")
            check(used <= 1.0, f"{name} [{label}] disagrees: {err}")
            worst = max(worst, err)
        errs[name] = worst

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    lib_ms = sdpa_ms(x, flush)
    cold_rows = phase_cold_kernels(dev, flush)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def tiered_page_bytes(e):
        return 2 * PS * D * 2 if e >= 0 else 2 * (PS * D + PS * 4)

    timed = {
        "paged_decode_attn_tiered": (
            lambda: tiered(pg.paged_decode_attn_tiered, 0),
            lambda: tiered(pg.paged_decode_attn_tiered_plain, 0),
            bound(bt_host, tiered_page_bytes, 0)),
        "paged_decode_attn": (
            lambda: pg.paged_decode_attn(q, k32, None, v32, None, bt32,
                                         lengths),
            lambda: pg.paged_decode_attn_plain(q, k32, None, v32, None, bt32,
                                               lengths),
            bound(bt_host, lambda e: 2 * PS * D * 4, 0)),
    }
    rows = {}
    for name, (kern, plain, (b_ms, b_by)) in timed.items():
        ms, plain_ms = time_ms(kern, flush), time_ms(plain, flush)
        print(f"[kernels] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by}; "
              f"{B * G} blocks on {n_sm} SMs)")
        rows[name] = {"name": name, "route": "cuda",
                      "source": source_file(name),
                      "replaces": REPLACES[name], "launches": None,
                      "max_abs_err": errs[name], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib_ms}
    rows.update(cold_rows)
    rows.update(phase_dense_kernels(dev, flush))
    return rows


def cold_inputs() -> dict:
    """name -> array to pack: a promotion batch's KV-like warm planes, raw
    and delta'd (what the cold packer tries), blocks that take every BDI
    encoding id and every FPC pattern, and noise (raw blocks)."""
    rng = np.random.default_rng(0)
    out = {}
    for p in range(COLD_PAGES):
        for plane in ("k8", "v8"):
            x = kv_plane(rng, COLD_PLANE)
            out[f"page{p}.{plane}"] = x
            out[f"page{p}.{plane}+delta"] = delta_seq(x)
    out["bdi_ids"] = bdi_blocks(rng)
    out["fpc_patterns"] = fpc_blocks(rng)
    out["noise"] = rng.integers(-128, 128, 1 << 16).astype(np.int8)
    return out


def cold_kernel_bound(c, meta_bytes: int):
    """(bound_ms, "bytes"): the packed stream, offsets and encodings read
    once and the decoded blocks written once, over the memory rate (a few
    integer operations per byte are far below the operation bound)."""
    nbytes = c.stream_bytes + 4 * c.offsets.size + meta_bytes \
        + c.offsets.size * 512
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def phase_cold_kernels(dev, flush) -> dict:
    """The BDI and FPC decode kernels against their plain forms, tolerance
    0, then timed on one full-width delta'd KV plane (448 blocks)."""
    codecs = {
        "bdi_packed_decode": (bdi.compress_packed,
                              lambda c: (c.stream, c.offsets, c.enc),
                              lambda s, o, m: bdi_ops.decompress_packed_blocks(
                                  s, o, m),
                              bdi.decode_packed_blocks,
                              lambda c: c.enc.tolist(), 9),
        "fpc_decode": (fpc.compress,
                       lambda c: (c.stream, c.offsets, c.seg_enc),
                       fpc_ops.decompress_blocks, fpc.decode_blocks,
                       lambda c: c.seg_enc.ravel().tolist(), 8),
    }
    rows = {}
    inputs = cold_inputs()
    for name, (pack, arrays, kernel, plain, ids, n_ids) in codecs.items():
        seen, worst, packed = set(), 0, {}
        for label, x in inputs.items():
            c = pack(x)
            packed[label] = c
            seen |= set(ids(c))
            args = [torch.from_numpy(a).to(dev) for a in arrays(c)]
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max().item())
            back = got.cpu().numpy().reshape(-1)[:x.nbytes]
            check(err == 0 and np.array_equal(back, x.reshape(-1).view(
                np.uint8)), f"{name} [{label}]: decode differs by {err}")
            worst = max(worst, err)
        check(seen == set(range(n_ids)),
              f"{name}: inputs reached ids {sorted(seen)}, not all {n_ids}")
        print(f"[cold-kernels] {name}: {len(inputs)} streams bit-exact vs "
              f"plain (tolerance 0), ids {sorted(seen)} all decoded")
        timed = {}
        for label in ("page0.k8+delta", "page0.k8"):
            c = packed[label]
            args = [torch.from_numpy(a).to(dev) for a in arrays(c)]
            meta = args[2].numel()
            b_ms, b_by = cold_kernel_bound(c, meta)
            timed[label] = (time_ms(lambda: kernel(*args), flush),
                            time_ms(lambda: plain(*args), flush), b_ms, b_by,
                            c.compressed_bytes())
            ms, plain_ms, _, _, cb = timed[label]
            print(f"[cold-kernels] {name} [{label}, {c.offsets.size} "
                  f"blocks, {cb} of {inputs[label].nbytes} B packed]: "
                  f"{ms:.4f} ms "
                  f"(plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms by "
                  f"{b_by}; no single PyTorch call decodes it)")
        ms, plain_ms, b_ms, b_by, _ = timed["page0.k8+delta"]
        rows[name] = {"name": name, "route": "cuda",
                      "source": source_file(name),
                      "replaces": REPLACES[name], "launches": None,
                      "max_abs_err": float(worst), "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None}
    return rows


def dense_attn_inputs(dev):
    """q, int8 and bf16 KV [B, G, S, D] with NaN beyond each length (bf16
    rows, int8 scales), and the lengths: the dense path's shapes."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, G, DENSE_S, D), generator=gen, device=dev)
    v = torch.randn((B, G, DENSE_S, D), generator=gen, device=dev)
    k8, ks = quantize_token(k)
    v8, vs = quantize_token(v)
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    for b, L in enumerate(DENSE_LENGTHS):
        for t in (ks, vs, kb, vb):
            t[b, :, L:] = float("nan")
    lengths = torch.tensor(DENSE_LENGTHS, dtype=torch.int32, device=dev)
    return {"int8": (q, k8, ks, v8, vs, lengths),
            "bf16": (q, kb, None, vb, None, lengths)}


def dense_attn_bound(kv_row_bytes: int):
    """(bound_ms, bound_by) of one dense decode-attention call: the valid
    K/V rows (and scales) read once, q read and out written once, against
    the f32 multiply-adds of q.k and p.v."""
    n_valid = sum(DENSE_LENGTHS)
    nbytes = 2 * B * H * D * 2 + 4 * B + n_valid * G * kv_row_bytes
    ops_ = 4 * H * D * n_valid
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_dense_ms(args, flush) -> float:
    """Yardstick: one scaled_dot_product_attention over the dequantized
    dense bf16 KV (NaN tail zeroed beforehand), with the length mask."""
    q, k, ks, v, vs, lengths = args
    valid = (torch.arange(DENSE_S, device=q.device)[None, :]
             < lengths[:, None])[:, None, :, None]
    kf = k.float() * ks[..., None] if ks is not None else k.float()
    vf = v.float() * vs[..., None] if vs is not None else v.float()
    kd = torch.where(valid, kf, 0).to(torch.bfloat16)
    vd = torch.where(valid, vf, 0).to(torch.bfloat16)
    mask = valid[:, :, :, 0][:, :, None, :]
    q4 = q[:, :, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask, enable_gqa=True), flush)


def matmul_inputs(dev, K: int, N: int, gk: int):
    gen = torch.Generator(device=dev).manual_seed(K + N + gk)
    w8, scale = make_q8_layout(torch.randn((K, N), generator=gen,
                                           device=dev) * 0.02, gk)
    return w8, scale


def matmul_bound(shapes, M: int, gks):
    """(bound_ms, bound_by): weight bytes (int8 + f32 scales), x read and
    y written once, against 2 M K N operations at the bf16 tensor rate."""
    nbytes = sum(K * N + (K // gk) * N * 4 + M * K * 2 + M * N * 2
                 for (K, N), gk in zip(shapes, gks))
    ops_ = sum(2 * M * K * N for K, N in shapes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / BF16_MMA_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def dense_matmul_m() -> tuple:
    """The M the dense phase gives matmul_q8: its slots at decode, then the
    buckets of its prompts (the warm-up's too) at prefill, as the Engine
    pads them."""
    reqs = make_requests(ARCHS[DENSE_SERVE["arch"]].vocab_size)
    plens = [len(r.prompt) for r in reqs[:N_DENSE_REQUESTS]]
    buckets = {prompt_bucket(n, DENSE_SERVE["max_len"],
                             Engine.PREFILL_QUANTUM)
               for n in plens + list(WARM_PROMPTS)}
    return (DENSE_SERVE["slots"],) + tuple(sorted(buckets))


def phase_dense_kernels(dev, flush) -> dict:
    """The dense decode-attention and int8-weight matmul kernels against
    their plain forms, then timed beside them, one PyTorch call and the
    bound."""
    rows = {}
    attn = dense_attn_inputs(dev)
    worst = 0.0
    for kind, args in attn.items():
        got, want = dense.decode_attn(*args), dense.decode_attn_plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"decode_attn [{kind}]: non-finite output")
        d = (got.float() - want.float()).abs()
        err = d.max().item()
        used = (d / (KERNEL_ATOL + KERNEL_RTOL * want.float().abs())
                ).max().item()
        print(f"[dense-kernels] decode_attn [{kind}, S={DENSE_S}, lengths "
              f"{DENSE_LENGTHS}, NaN beyond] max|d| vs plain {err:.3e} = "
              f"{used:.2f} of the tolerance (atol {KERNEL_ATOL} + 2^-7 "
              f"|out|; max|out| {want.float().abs().max().item():.3f})")
        check(used <= 1.0, f"decode_attn [{kind}] disagrees: {err}")
        worst = max(worst, err)
    n_split = -(-DENSE_S // dense.CHUNK)
    timed = {}
    for kind, row_bytes in (("int8", 2 * (D + 4)), ("bf16", 2 * D * 2)):
        args = attn[kind]
        ms = time_ms(lambda: dense.decode_attn(*args), flush)
        plain_ms = time_ms(lambda: dense.decode_attn_plain(*args), flush)
        lib_ms = sdpa_dense_ms(args, flush)
        b_ms, b_by = dense_attn_bound(row_bytes)
        timed[kind] = (ms, plain_ms, lib_ms, b_ms, b_by)
        print(f"[dense-kernels] decode_attn [{kind}]: {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} "
              f"ms by {b_by}; {B * G * n_split} blocks)")
    ms, plain_ms, lib_ms, b_ms, b_by = timed["int8"]
    rows["decode_attn"] = {
        "name": "decode_attn", "route": "cuda",
        "source": source_file("decode_attn"),
        "replaces": REPLACES["decode_attn"], "launches": None,
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}

    worst = worst_used = 0.0
    layouts = {}
    gen = torch.Generator(device=dev).manual_seed(4)
    path_m = dense_matmul_m()
    all_m = tuple(sorted(set(path_m) | {RAGGED_M}))

    def x_of(M, K):
        return torch.randn((M, K), generator=gen, device=dev).to(
            torch.bfloat16)

    for K, N in sorted(set(PROJ)):
        for gk in (K, 256):
            bf = gk == K                # as qmatmul calls it on a q8 leaf
            w8, scale = layouts[(K, N, gk)] = matmul_inputs(dev, K, N, gk)
            for M in all_m:
                x = x_of(M, K)
                got = fm_ops.matmul_q8(x, w8, scale, gk=gk, bf16_scale=bf)
                want = fm_ops.matmul_q8_plain(x, w8, scale, gk, bf)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()),
                      f"matmul_q8 {M}x{K}x{N} gk={gk}: non-finite output")
                w = want.float()
                d = (got.float() - w).abs()
                used = (d / (KERNEL_RTOL * w.abs() + MATMUL_ATOL_SHARE
                             * w.abs().max())).max().item()
                err = d.max().item()
                check(used <= 1.0, f"matmul_q8 {M}x{K}x{N} gk={gk} "
                      f"disagrees: {err}")
                worst, worst_used = max(worst, err), max(worst_used, used)
    print(f"[dense-kernels] matmul_q8: {len(layouts) * len(all_m)} cases "
          f"(K x N {sorted(set(PROJ))}; M {all_m}: the dense phase's "
          f"{path_m} and the ragged {RAGGED_M}; gk = K with the scale "
          f"rounded to bf16, as served, and gk = 256) within tolerance: "
          f"max|d| {worst:.3e}, worst {worst_used:.2f} of the tolerance "
          f"(2^-7 |y| + 2^-12 max|y|)")
    # one layer's seven projections (gk = K), as served, at every M
    per_call = {}
    layer = {}
    for M in all_m:
        xs = {K: x_of(M, K) for K in sorted({K for K, _ in PROJ})}
        layer[M] = [(xs[K],) + layouts[(K, N, K)] + (K,) for K, N in PROJ]
    for M in all_m:
        ws = layer[M]
        deq = [(x, (w8.float() * sc.to(torch.bfloat16).float()).to(
            torch.bfloat16)) for x, w8, sc, _ in ws]
        kern = time_ms(lambda: [fm_ops.matmul_q8(x, w8, sc, gk=gk,
                                                 bf16_scale=True)
                                for x, w8, sc, gk in ws], flush)
        plain = time_ms(lambda: [fm_ops.matmul_q8_plain(x, w8, sc, gk, True)
                                 for x, w8, sc, gk in ws], flush)
        lib = time_ms(lambda: [torch.matmul(x, w) for x, w in deq], flush)
        b_ms, b_by = matmul_bound(PROJ, M, [K for K, _ in PROJ])
        per_call[M] = (kern, plain, lib, b_ms, b_by)
        print(f"[dense-kernels] matmul_q8 one layer's 7 projections, M={M}, "
              f"gk=K: {kern:.4f} ms (plain {plain:.4f} ms, torch.matmul "
              f"over bf16 weights {lib:.4f} ms, bound {b_ms:.5f} ms by "
              f"{b_by}; {b_ms / kern:.3f} of the bound)")
        del deq
    # the K-split target (blocks per SM) against M; the module's own is
    # restored after
    chosen = fm_ops.BLOCKS_PER_SM
    try:
        for bps in SPLIT_TARGETS:
            fm_ops.BLOCKS_PER_SM = bps
            cells = []
            for M in all_m:
                ws = layer[M]
                t = time_ms(lambda: [fm_ops.matmul_q8(x, w8, sc, gk=gk,
                                                      bf16_scale=True)
                                     for x, w8, sc, gk in ws], flush)
                cells.append(f"M={M} {t:.4f}")
            print(f"[dense-kernels] matmul_q8 split target {bps} blocks/SM"
                  f"{' (the tree)' if bps == chosen else ''}, one layer's 7 "
                  f"projections, ms: {', '.join(cells)}")
    finally:
        fm_ops.BLOCKS_PER_SM = chosen
    del layer
    for (K, N) in sorted(set(PROJ)):
        x = x_of(4, K)
        w8, sc = layouts[(K, N, K)]
        one = time_ms(lambda: fm_ops.matmul_q8(x, w8, sc, gk=K,
                                               bf16_scale=True), flush)
        b_ms, _ = matmul_bound([(K, N)], 4, [K])
        m_tiles, kt_per, splits = fm_ops._split_plan(4, N, K, dev)
        print(f"[dense-kernels] matmul_q8 M=4 {K}x{N}: {one:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_ms / one:.3f}), {splits} K splits")
    kern, plain, lib, b_ms, b_by = per_call[4]
    rows["matmul_q8"] = {
        "name": "matmul_q8", "route": "cuda",
        "source": source_file("matmul_q8"),
        "replaces": REPLACES["matmul_q8"], "launches": None,
        "max_abs_err": worst, "ms": kern, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    return rows


# -- phase 4 -------------------------------------------------------------------

def make_requests(vocab: int):
    rng = np.random.default_rng(SERVE["seed"])
    return [Request(rid=i,
                    prompt=[int(t) for t in rng.integers(
                        2, vocab, int(rng.integers(64, 161)))],
                    max_new=SERVE["max_new"]) for i in range(N_REQUESTS)]


def serve_once(eng, backend: str, kernel: str) -> dict:
    reqs = make_requests(eng.cfg.vocab_size)
    torch.cuda.synchronize()
    reset_launches()                    # counts of THIS run only
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    eng.sync()
    dt = time.perf_counter() - t0
    counts = launches()
    s = eng.stats()
    vocab = eng.cfg.vocab_size
    n_tok = sum(len(r.out) for r in done)
    print(f"[serve:{backend}] {len(done)}/{N_REQUESTS} requests, {n_tok} "
          f"tokens in {dt:.2f} s = {n_tok / dt:.1f} tok/s, "
          f"{1e3 * dt / s['tick']:.2f} ms/tick over {s['tick']} ticks, of "
          f"which the host waited {1e3 * s['harvest_wait_s'] / s['tick']:.2f}"
          f" ms/tick for the harvest; "
          f"hot {s['hot_pages']} / warm {s['warm_pages']} pages; "
          f"store {s['store']}; preemptions {s['preemptions']}; warm table "
          f"entries read {s['warm_page_reads']}; launches {counts}; "
          f"peak resident tokens {s['peak_resident_tokens']}")
    st, cold, pf = s["store"], s["cold"], s["policy"]
    n_async = st["promote_warm_async"]
    ratio = cold["raw_bytes_total"] / max(cold["packed_bytes_total"], 1)
    print(f"[serve:{backend}] cold tier: demote_cold {st['demote_cold']}, "
          f"promote_warm {st['promote_warm']} (sync "
          f"{st['promote_warm'] - n_async}, async {n_async}); prefetch "
          f"issued {pf['prefetch_issued']}, hit {pf['prefetch_hits']}, late "
          f"{pf['prefetch_late']}, wasted {pf['prefetch_wasted']}, "
          f"outstanding {pf['prefetch_outstanding']}; packed "
          f"{cold['packed_bytes_total']} B of {cold['raw_bytes_total']} B "
          f"raw (ratio {ratio:.4f}); "
          f"schemes packed {cold['schemes']}, decoded {cold['decoded']}; "
          f"host {cold['pack_ms_per_page']:.2f} ms per demotion (device "
          f"read-back + packing), {cold['promote_ms_per_page']:.2f} ms per "
          f"promotion (launch + checksum wait), "
          f"{cold['checked_bytes'] // max(st['promote_warm'], 1)} B copied "
          f"back per promotion for the CRC")
    check(len(done) == N_REQUESTS, f"{backend}: requests did not complete")
    check(all(len(r.out) == SERVE["max_new"] for r in done),
          f"{backend}: a request stopped short")
    check(all(0 <= t < vocab for r in done for t in r.out),
          f"{backend}: token outside the vocabulary")
    check(st["demote_warm"] > 0, f"{backend}: no warm demotion")
    check(s["warm_page_reads"] > 0,
          f"{backend}: no warm page entered a decode table")
    check(st["demote_cold"] > 0 and st["promote_warm"] > 0,
          f"{backend}: no page went cold and came back")
    check(counts[kernel] > 0, f"{backend}: {kernel} never launched")
    check(counts[kernel] % LAYERS == 0,
          f"{backend}: {counts[kernel]} launches is not one per layer")
    # every packed plane promoted went through its decode kernel once
    decoded = {b: sum(v for k, v in cold["decoded"].items()
                      if k.startswith(b)) for b in ("bdi", "fpc")}
    for base, cold_kernel in (("bdi", "bdi_packed_decode"),
                              ("fpc", "fpc_decode")):
        check(counts[cold_kernel] == decoded[base],
              f"{backend}: {counts[cold_kernel]} {cold_kernel} launches for "
              f"{decoded[base]} {base} planes decoded")
        if not decoded[base]:
            print(f"[serve:{backend}] the packer chose no {base} plane in "
                  f"this run: {cold_kernel} had nothing to decode here (the "
                  f"kernel phase holds it against its plain form)")
    c = pf
    check(c["prefetch_issued"] == c["prefetch_hits"] + c["prefetch_late"]
          + c["prefetch_wasted"] + c["prefetch_outstanding"],
          f"{backend}: prefetch outcomes do not add up: {c}")
    eng.pool.check()
    return {"outs": {r.rid: list(r.out) for r in done}, "prompts":
            {r.rid: list(r.prompt) for r in done}, "launches": counts,
            "ms_per_tick": 1e3 * dt / s["tick"]}


def decode_step_delta(model, params, dev):
    """One full-width paged decode step on identical pools with pallas_int8
    and gather -> (max |d logit|, max |logit|)."""
    from repro_torch.cache.tiers import TieredKVStore
    from repro_torch.models.transformer import paged_geometry
    rng = np.random.default_rng(1)
    geom = paged_geometry(model.cfg, PS)
    store = TieredKVStore(geom, 64, hot_pages=32, warm_pages=32, device=dev)
    pools = store.pools[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    for name in ("kh", "vh"):
        pools[name].copy_(torch.randn(pools[name].shape, generator=gen,
                                      device=dev))
        pools[name][:, 0] = float("nan")
    for q8_name, s_name in (("k8", "ks"), ("v8", "vs")):
        q8, sc = quantize_token(torch.randn(pools[q8_name].shape,
                                            generator=gen, device=dev))
        pools[q8_name].copy_(q8)
        pools[s_name].copy_(sc)
    lengths = np.array([200, 130, 63, 0], np.int32)
    bt = np.zeros((B, NP), np.int32)
    hot = iter(rng.permutation(32) + 1)
    warm = iter(rng.permutation(32) + 1)
    for b, L in enumerate(lengths):
        for s in range(L // PS + 1 if L else 0):
            # the write page (L // PS) must be hot
            bt[b, s] = next(hot) if (s == L // PS or rng.random() < 0.5) \
                else -next(warm)
    tokens = torch.from_numpy(rng.integers(2, model.cfg.vocab_size, (B, 1))
                              .astype(np.int32)).to(dev)
    logits = {}
    for backend in ("pallas_int8", "gather"):
        copy = ({k: v.clone() for k, v in pools.items()},)
        out, _ = model.paged_decode_step(
            params, copy, tokens, torch.from_numpy(bt).to(dev),
            torch.from_numpy(lengths).to(dev), has_warm=True,
            backend=backend)
        logits[backend] = out[:, 0]
    torch.cuda.synchronize()
    for v in logits.values():
        check(bool(torch.isfinite(v).all()), "decode step: non-finite logit")
    return ((logits["pallas_int8"] - logits["gather"]).abs().max().item(),
            logits["gather"].abs().max().item())


def teacher_forced(model, params, prompt, out, dev):
    """Prefill over prompt + out[:-1], i.e. the served context at every
    step -> (argmax agreement with the served tokens, largest top-1/top-2
    margin of the prefill where the two disagree)."""
    toks = torch.tensor([prompt + out[:-1]], dtype=torch.int32, device=dev)
    logits, _ = model.prefill(params, {"tokens": toks}, toks.shape[1])
    lg = logits[0, len(prompt) - 1:]
    top2 = lg.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    agree = lg.argmax(dim=-1).cpu().numpy() == np.array(out)
    worst = float(margin[~agree].max()) if (~agree).any() else 0.0
    return int(agree.sum()), len(out), worst


def profile_ticks(eng, ms_per_tick: float, label: str, n_ticks: int = 8):
    """Device time by kernel over a few steady decode ticks (torch.profiler
    with CUDA activity), and its share of the unprofiled run's ms/tick (the
    profiler's own host cost makes the profiled wall time meaningless)."""
    from torch.profiler import ProfilerActivity, profile
    for r in make_requests(eng.cfg.vocab_size)[:4]:
        eng.submit(r)
    for _ in range(3):                    # admission and prefill
        eng.step()
    eng.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            eng.step()
        eng.sync()
    events = prof.key_averages()
    rows = [(e.key, e.device_time_total, e.count) for e in events
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy_ms = sum(t for _, t, _ in rows) / n_ticks / 1e3
    print(f"[profile:{label}] {n_ticks} ticks: device kernels "
          f"{busy_ms:.2f} ms/tick = busy share {busy_ms / ms_per_tick:.2f} "
          f"of the measured {ms_per_tick:.2f} ms/tick")
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"[profile:{label}]   {t / n_ticks / 1e3:8.3f} ms/tick "
              f"{n // n_ticks:5d} calls/tick  {key[:90]}")
    # host side: CUDA runtime/driver calls (launches, copies, waits), whose
    # self time shows whether the host blocks on the device
    api = [(e.key, e.self_cpu_time_total, e.count) for e in events
           if e.device_type.name == "CPU" and e.key.startswith("cu")]
    print(f"[profile:{label}] host CUDA API calls: "
          f"{sum(n for _, _, n in api) // n_ticks} per tick, "
          f"{sum(t for _, t, _ in api) / n_ticks / 1e3:.2f} ms/tick (profiled)")
    for key, t, n in sorted(api, key=lambda r: -r[1])[:6]:
        print(f"[profile:{label}]   host {t / n_ticks / 1e3:8.3f} "
              f"ms/tick {n // n_ticks:5d} calls/tick  {key}")
    eng.run()


def phase_serve(dev, kernel_rows: dict):
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    warm_eng, model, params = ServeConfig(attn_backend="pallas_int8",
                                          **SERVE).build()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] qwen2-7b full width: {n_params / 1e9:.3f} B parameters "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    runs = {}
    for backend, kernel in (("pallas_int8", "paged_decode_attn_tiered"),
                            ("pallas", "paged_decode_attn")):
        # warm-up on a throwaway engine: library handles, prefill buckets
        if warm_eng is None:
            warm_eng = ServeConfig(attn_backend=backend, **SERVE).build(
                model=model, params=params)[0]
        for plen in WARM_PROMPTS:
            warm_eng.submit(Request(rid=plen, prompt=[7] * plen, max_new=4))
        warm_eng.run()
        warm_eng = None
        eng = ServeConfig(attn_backend=backend, **SERVE).build(
            model=model, params=params)[0]
        runs[backend] = serve_once(eng, backend, kernel)
        kernel_rows[kernel]["launches"] = runs[backend]["launches"][kernel]
        if backend == "pallas_int8":          # the main path's cold tier
            for name in ("bdi_packed_decode", "fpc_decode"):
                kernel_rows[name]["launches"] = \
                    runs[backend]["launches"][name]
        profile_ticks(ServeConfig(attn_backend=backend, **SERVE).build(
            model=model, params=params)[0], runs[backend]["ms_per_tick"],
            backend)
    same = runs["pallas"]["outs"] == runs["pallas_int8"]["outs"]
    print(f"[serve] pallas and pallas_int8 tokens identical: {same}")
    check(same, "pallas and pallas_int8 served different tokens")
    print(f"[serve] max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on "
          f"{torch.cuda.get_device_name(0)}")
    delta, scale = decode_step_delta(model, params, dev)
    print(f"[serve] decode step pallas_int8 vs gather: max|d logit| "
          f"{delta:.4e} (bound {LOGIT_ATOL}; max|logit| {scale:.3f})")
    check(delta <= LOGIT_ATOL, f"decode step logits differ by {delta}")
    r = runs["pallas_int8"]
    agree = total = 0
    worst = 0.0
    for rid in sorted(r["outs"]):
        a, n, w = teacher_forced(model, params, r["prompts"][rid],
                                 r["outs"][rid], dev)
        agree, total, worst = agree + a, total + n, max(worst, w)
    print(f"[serve] served tokens vs teacher-forced prefill: {agree}/{total} "
          f"argmax agree; largest prefill top-1/top-2 margin where they "
          f"differ {worst:.4f} (bound {TEACHER_MARGIN})")
    check(worst <= TEACHER_MARGIN,
          f"a served token contradicts a clear prefill argmax ({worst})")
    return model, params


# -- phase 5 -------------------------------------------------------------------

def serve_dense_once(eng, label: str, q8: bool) -> dict:
    reqs = make_requests(eng.cfg.vocab_size)[:N_DENSE_REQUESTS]
    torch.cuda.synchronize()
    reset_launches()                    # counts of THIS run only
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    eng.sync()
    dt = time.perf_counter() - t0
    counts = launches()
    s = eng.stats()
    vocab = eng.cfg.vocab_size
    n_tok = sum(len(r.out) for r in done)
    print(f"[dense:{label}] {len(done)}/{N_DENSE_REQUESTS} requests, {n_tok} "
          f"tokens in {dt:.2f} s = {n_tok / dt:.1f} tok/s, "
          f"{1e3 * dt / s['tick']:.2f} ms/tick over {s['tick']} ticks, of "
          f"which the host waited {1e3 * s['harvest_wait_s'] / s['tick']:.2f}"
          f" ms/tick for the harvest; KV cache {kv_bytes(eng.state)} B; "
          f"launches {counts}")
    check(len(done) == N_DENSE_REQUESTS, f"{label}: requests did not "
          f"complete")
    check(all(len(r.out) == DENSE_SERVE["max_new"] for r in done),
          f"{label}: a request stopped short")
    check(all(0 <= t < vocab for r in done for t in r.out),
          f"{label}: token outside the vocabulary")
    check(counts["decode_attn"] == LAYERS * s["tick"],
          f"{label}: {counts['decode_attn']} decode_attn launches for "
          f"{s['tick']} ticks of {LAYERS} layers")
    n_mm = counts["matmul_q8"]
    if q8:
        check(n_mm > 0 and n_mm % (7 * LAYERS) == 0,
              f"{label}: {n_mm} matmul_q8 launches, not 7 per layer")
    else:
        check(n_mm == 0, f"{label}: raw weights launched matmul_q8")
    return {"outs": {r.rid: list(r.out) for r in done},
            "prompts": {r.rid: list(r.prompt) for r in done},
            "launches": counts, "ms_per_tick": 1e3 * dt / s["tick"]}


def phase_dense_serve(dev, model, params, kernel_rows: dict):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = quantize_params(params)
    torch.cuda.synchronize()
    print(f"[dense] quantize_params on the card in "
          f"{time.perf_counter() - t0:.1f} s: params_bytes raw "
          f"{params_bytes(params)} B, q8 {params_bytes(qparams)} B "
          f"(embeddings bf16)")
    trees = {"raw": params, "q8": qparams}
    for weights, kv_mode in DENSE_SETTINGS:
        label = f"{weights}+{kv_mode}"
        cfg = ServeConfig(kv_mode=kv_mode, **DENSE_SERVE)
        warm = cfg.build(model=model, params=trees[weights])[0]
        for plen in WARM_PROMPTS:
            warm.submit(Request(rid=plen, prompt=[7] * plen, max_new=4))
        warm.run()
        del warm
        eng = cfg.build(model=model, params=trees[weights])[0]
        r = serve_dense_once(eng, label, weights == "q8")
        if (weights, kv_mode) == DENSE_SETTINGS[-1]:   # the main dense path
            for name in ("decode_attn", "matmul_q8"):
                kernel_rows[name]["launches"] = r["launches"][name]
        profile_ticks(cfg.build(model=model, params=trees[weights])[0],
                      r["ms_per_tick"], f"dense {label}")
        agree = total = 0
        worst = 0.0
        for rid in sorted(r["outs"]):
            a, n, w = teacher_forced(model, trees[weights], r["prompts"][rid],
                                     r["outs"][rid], dev)
            agree, total, worst = agree + a, total + n, max(worst, w)
        print(f"[dense:{label}] served tokens vs teacher-forced prefill: "
              f"{agree}/{total} argmax agree; largest prefill top-1/top-2 "
              f"margin where they differ {worst:.4f} (bound "
              f"{TEACHER_MARGIN})")
        check(worst <= TEACHER_MARGIN, f"{label}: a served token "
              f"contradicts a clear prefill argmax ({worst})")
    print(f"[dense] max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (raw and q8 "
          f"weights both resident) on {torch.cuda.get_device_name(0)}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    rows = phase_kernels(dev)
    model, params = phase_serve(dev, rows)
    phase_dense_serve(dev, model, params, rows)
    check(all(r["launches"] is not None for r in rows.values()),
          "a kernel has no launch count from the serve run")
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
