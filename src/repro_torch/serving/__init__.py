"""Serving: KV-cache prefill and decode (``sampler``)."""
