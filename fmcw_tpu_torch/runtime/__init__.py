"""The surveillance runtime: scan batching with the tracker, logs and
checkpoints (``surveillance``); streamed ingest on CUDA streams
(``stream``)."""
