"""Command-line tools of the port, run as ``python -m
fmcw_tpu_torch.tools.<name>``: ``detection_eval`` (the Pd/Pfa sweep) and
``visualize`` (the end-to-end demo)."""
