"""Serving runtime: sector predictor and sectored KV-cache decode."""
