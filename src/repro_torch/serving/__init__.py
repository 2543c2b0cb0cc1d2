"""Serving layers of the port: ``dedup_kv.DedupKVServer``, HPDedup over the
KV pages of a model's prefixes, and ``frontend.AsyncDedupFrontend``, which
batches many asyncio client connections into one engine's ``write_batch``
calls, with per-tenant QoS (``TenantQoS``), admission control and
backpressure."""
