"""The surveillance runtime: scan batching with the tracker, logs and
checkpoints, and the hw-compat streaming runner (``surveillance``); streamed
ingest on CUDA streams (``stream``); the native file streamer and parsers
(``native``)."""
