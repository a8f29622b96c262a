"""Seeded codec inputs shared by the port's CPU and card tests and by
``chip_smoke.py``: blocks that take every BDI encoding id and every FPC
pattern, int8 KV-like planes, and word blocks for the uniform BDI kernels
(wraparound and infeasible blocks included).  Numpy only (no JAX, no
torch); :func:`tour_module` loads the compression tour for its
generators."""
import importlib.util
import sys
from pathlib import Path

import numpy as np

TOUR = Path(__file__).resolve().parents[1] / "examples" / \
    "compression_tour_torch.py"


def tour_module():
    """The compression tour's module, loaded without registering it or
    keeping the ``sys.path`` entry its import adds."""
    spec = importlib.util.spec_from_file_location("compression_tour_torch",
                                                  TOUR)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def bdi_blocks(rng) -> np.ndarray:
    """Eight 512 B blocks, block i made to take BDI encoding id i: words
    around a base (the block's first word) in the widths of each id."""
    def around(base, spread, n, dtype):
        w = (base + rng.integers(-spread, spread, n)).astype(dtype)
        w[0] = base
        return w.view(np.uint8)

    b8 = 0x1122334455667788
    blocks = [np.zeros(512, np.uint8),
              np.full(64, 0x0102030405060708, np.int64).view(np.uint8),
              around(b8, 100, 64, np.int64),
              around(b8, 30000, 64, np.int64),
              around(b8, 2 ** 30, 64, np.int64),
              around(10 ** 6, 100, 128, np.int32),
              around(10 ** 6, 20000, 128, np.int32),
              around(1000, 100, 256, np.int16)]
    return np.concatenate(blocks).view(np.int32)


def fpc_blocks(rng) -> np.ndarray:
    """Eight 512 B blocks whose segments take every FPC pattern."""
    segs = [np.zeros(8, np.int64),                                   # zero
            rng.integers(-8, 8, 8),                                  # se4
            rng.integers(-128, 128, 8),                              # se8
            rng.integers(-30000, 30000, 8),                          # se16
            rng.integers(1, 0x7FFF, 8) << 16,                        # hi_half
            (rng.integers(-128, 0, 8) & 0xFFFF) << 16
            | (rng.integers(0, 128, 8) & 0xFFFF),                    # two_se8
            np.full(8, 0xAB, np.int64) * 0x01010101,                 # rep_byte
            rng.integers(0, 2 ** 32, 8)]                             # raw
    words = np.concatenate([segs[(i + j) % 8] for j in range(8)
                            for i in range(16)])
    return (words & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def kv_plane(rng, shape=(4, 2, 16, 32)) -> np.ndarray:
    """int8 KV-like plane: a random walk along the token axis, so the
    delta'd plane has small values (as temporally correlated decode KV)."""
    steps = rng.integers(-3, 4, shape)
    steps[:, :, 0] = rng.integers(-60, 60, shape[:2] + shape[3:])
    return np.clip(np.cumsum(steps, axis=2), -127, 127).astype(np.int8)


def wrap_blocks(word_bytes: int) -> np.ndarray:
    """Two 512 B blocks of words near both ends of the word range, as
    uint8[2, 512]: block 0 has the base 3 and words just below 2^(8 wb),
    block 1 the base 2^(8 wb) - 16 and words just above 0.  With 4-byte
    words their deltas fit only when taken mod 2^32 (the fit tests'
    wraparound); 2-byte words do not wrap at 16 bits, so there they fit
    from the zero base or not at all."""
    top = (1 << (8 * word_bytes)) - 1
    W = 512 // word_bytes
    blocks = [np.resize(np.array(v, np.int64), W) for v in
              ([3, top - 1, top - 4, 0, 120, top - 100, top],
               [top - 15, 5, 3, top, top - 100, 64, 0])]
    dtype = {2: "<u2", 4: "<u4"}[word_bytes]
    return np.stack(blocks).astype(dtype).view(np.uint8)


def bdi_uniform_words(rng, word_bytes: int, delta_bytes: int,
                      nb: int) -> np.ndarray:
    """``nb`` blocks of words for the uniform kernels, as uint8[nb, 512]:
    the wraparound blocks first, then one block no encoding of this width
    fits (words over the whole range), then blocks whose words sit within
    the delta range of their first word."""
    W = 512 // word_bytes
    top = (1 << (8 * word_bytes)) - 1
    spread = 60 * (1 << (8 * (delta_bytes - 1)))
    base = rng.integers(200, 1000, (nb, 1)) * (1 << (8 * (delta_bytes - 1)))
    words = np.clip(base + rng.integers(-spread, spread, (nb, W)), 0, top)
    words[:, 0] = base[:, 0]
    words[min(2, nb - 1)] = rng.integers(0, top + 1, W)
    dtype = {2: "<u2", 4: "<u4"}[word_bytes]
    out = words.astype(dtype).view(np.uint8).reshape(nb, 512).copy()
    wrap = wrap_blocks(word_bytes)[:nb]
    out[:len(wrap)] = wrap
    return out


def cpack_blocks(rng, nb: int = 17, W: int = 128):
    """Synthetic C-Pack layout of ``nb`` blocks -- every 4-bit code (10-15
    decode to zero), random dictionaries, payloads and raw bytes, ok and
    raw blocks mixed (block 0 ok, block 1 raw) -- as numpy (ok bool[nb],
    dict int32[nb, 4] of uint32 bits, codes uint8[nb, W/2], payload
    uint8[nb, W], raw uint8[nb, 4W])."""
    ok = rng.random(nb) < 0.7
    ok[:2] = True, False
    return (ok,
            rng.integers(0, 2 ** 32, (nb, 4)).astype(np.uint32).view(np.int32),
            rng.integers(0, 256, (nb, W // 2)).astype(np.uint8),
            rng.integers(0, 256, (nb, W)).astype(np.uint8),
            rng.integers(0, 256, (nb, 4 * W)).astype(np.uint8))
