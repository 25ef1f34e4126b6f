"""Serving of the port: the aggregated-KV decode engine (``serve.lm``)."""
