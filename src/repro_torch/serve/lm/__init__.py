"""Aggregated-KV LM decode serving: ``DecodeEngine`` and its bucket-level
failure domains."""
