"""BDI kernels (packed decode, uniform decode and encode) and their plain
forms."""
