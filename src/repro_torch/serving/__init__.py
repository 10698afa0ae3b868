"""Serving: paged KV pool, sampler and the prefix-shared decode engine."""
