"""Data front ends of the port.

* ``pipeline``: the multi-tenant training-data ingest pipeline
  (``DedupIngestPipeline``, ``TenantSpec``, ``TenantStream``,
  ``PipelineMetrics``): tenant token streams become blocks, the fingerprint
  kernel hashes them in batches, the dedup engine admits the survivors, and
  they become training batches, with crash-exact checkpoints.
* ``byte_workloads``: bytes (not fingerprints) with known duplication
  structure for the content-defined chunking front end:
  ``vm_image_workload`` (snapshot re-ingestion with shifting edits),
  ``log_append_workload``, ``analytic_bounds`` on the byte dup ratio, and
  ``byte_trace``, which chunks a workload into a replayable trace
  (``batches_trace`` joins the batches of several ingest calls into one).
"""

from .byte_workloads import (
    ByteWorkload,
    analytic_bounds,
    batches_trace,
    byte_trace,
    log_append_workload,
    vm_image_workload,
)
from .pipeline import DedupIngestPipeline, PipelineMetrics, TenantSpec, TenantStream

__all__ = [
    "ByteWorkload",
    "DedupIngestPipeline",
    "PipelineMetrics",
    "TenantSpec",
    "TenantStream",
    "analytic_bounds",
    "batches_trace",
    "byte_trace",
    "log_append_workload",
    "vm_image_workload",
]
