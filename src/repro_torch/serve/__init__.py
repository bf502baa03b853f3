"""Serving: the continuous batcher over the facet-layout KV cache."""
