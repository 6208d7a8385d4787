"""Encode pipelines (text query path)."""
