"""Inference API and serving daemon."""
