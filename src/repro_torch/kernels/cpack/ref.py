"""Oracle of the C-Pack decode kernel: the scheme-level codec.

Counterpart of ``repro.kernels.cpack.ref``; the kernel's plain form is
:func:`~repro_torch.assist.schemes.cpack.decode_blocks`."""
from repro_torch.assist.schemes.cpack import (CODE_FULL0, CODE_PART0,
                                              CODE_ZERO, CODE_ZEXT, NDICT,
                                              CPacked, compress,
                                              compressed_block_bytes,
                                              decode_blocks, decompress)

__all__ = ["compress", "decompress", "decode_blocks", "CPacked",
           "compressed_block_bytes", "NDICT", "CODE_ZERO", "CODE_FULL0",
           "CODE_PART0", "CODE_ZEXT"]
