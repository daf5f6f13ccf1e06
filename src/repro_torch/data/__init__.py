"""Deterministic data: the synthetic LM stream, token-file shards, prefetch."""
