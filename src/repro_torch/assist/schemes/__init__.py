"""Lossless codecs of the cold tier: per-block BDI and FPC."""
