"""Fixed-rate block-scaled quantization: the lossy compress schemes.

Counterpart of ``repro.assist.schemes.quant``, byte-identical to it: a
per-block absmax scale over blocks of ``BLOCK_VALUES`` values (the last
block zero-padded), then

* int8 : symmetric round-to-nearest-even to [-127, 127];
* fp8  : the scaled values cast to ``float8_e4m3fn`` (scale absmax / 448);
* int4 : [-7, 7] offset by 8, two values per byte (low nibble first).

Plain PyTorch on the tensor's device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.assist.schemes.bdi import dtype_name, original_bytes

BLOCK_VALUES = 256  # quantization block, in elements (not bytes)
KINDS = ("int8", "fp8", "int4")


@dataclasses.dataclass(frozen=True)
class QuantTensor:
    q: torch.Tensor       # int8 / float8_e4m3fn[nblocks, BLOCK] | uint8[nblocks, BLOCK//2] (int4)
    scale: torch.Tensor   # f32[nblocks, 1]
    kind: str             # "int8" | "fp8" | "int4"
    shape: tuple
    dtype_name: str
    pad: int

    def compressed_bytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * 2

    def original_bytes(self) -> int:
        return original_bytes(self.shape, self.dtype_name)

    def ratio(self) -> float:
        return self.original_bytes() / max(self.compressed_bytes(), 1)


def _to_blocks(x: torch.Tensor):
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    nblocks = -(-n // BLOCK_VALUES)
    pad = nblocks * BLOCK_VALUES - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(nblocks, BLOCK_VALUES), pad


def compress(x: torch.Tensor, kind: str = "int8") -> QuantTensor:
    if kind not in KINDS:
        raise ValueError(kind)
    blocks, pad = _to_blocks(x)
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds differently from the reference
    qmax = torch.full_like(absmax, {"int8": 127.0, "fp8": 448.0,
                                    "int4": 7.0}[kind])
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    if kind == "int8":
        q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    elif kind == "fp8":
        q = (blocks / scale).to(torch.float8_e4m3fn)
    else:
        qi = torch.clamp(torch.round(blocks / scale), -7, 7).to(
            torch.int32) + 8
        q = (qi[:, 0::2] | (qi[:, 1::2] << 4)).to(torch.uint8)
    return QuantTensor(q=q, scale=scale, kind=kind, shape=tuple(x.shape),
                       dtype_name=dtype_name(x.dtype), pad=pad)


def decompress(c: QuantTensor) -> torch.Tensor:
    if c.kind == "int4":
        u = c.q.to(torch.int32)
        vals = torch.stack([u & 0xF, (u >> 4) & 0xF], dim=-1)
        vals = vals.reshape(c.q.shape[0], -1) - 8
        blocks = vals.float() * c.scale
    else:
        blocks = c.q.float() * c.scale
    n = blocks.numel() - c.pad
    return blocks.reshape(-1)[:n].reshape(c.shape).to(
        getattr(torch, c.dtype_name))


def quantization_error(x: torch.Tensor, kind: str = "int8") -> torch.Tensor:
    """Residual (x - dequant(quant(x))) for error-feedback accumulators."""
    return x - decompress(compress(x, kind))
