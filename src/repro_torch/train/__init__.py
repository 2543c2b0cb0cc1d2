"""Training stack of the port: AdamW, the train and serve steps, and the
fault-tolerant trainer fed by the dedup ingest pipeline."""
