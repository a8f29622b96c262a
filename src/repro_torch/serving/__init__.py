"""Serving layer of the port: requests, ServeConfig and the paged engine."""
