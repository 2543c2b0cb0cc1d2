"""Byte-backed workloads for the content-defined chunking front end.

``byte_workloads`` draws bytes (not fingerprints) with known duplication
structure: ``vm_image_workload`` (snapshot re-ingestion with shifting
edits), ``log_append_workload``, ``analytic_bounds`` on the byte dup ratio,
and ``byte_trace``, which chunks a workload into a replayable trace
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

__all__ = [
    "ByteWorkload",
    "analytic_bounds",
    "batches_trace",
    "byte_trace",
    "log_append_workload",
    "vm_image_workload",
]
