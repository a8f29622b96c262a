"""Model functions of the port: layers, the decoder stack, build_model."""
