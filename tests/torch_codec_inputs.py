"""Seeded codec inputs shared by the port's CPU and card tests and by
``chip_smoke.py``: blocks that take every BDI encoding id and every FPC
pattern, and int8 KV-like planes.  Numpy only (no JAX, no torch)."""
import numpy as np


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
