"""Serving layers of the port: ``dedup_kv.DedupKVServer``, HPDedup over the
KV pages of a model's prefixes."""
