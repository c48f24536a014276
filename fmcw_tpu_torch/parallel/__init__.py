"""The sharded frame processor: a (dp, sp) mesh on torch.distributed
(``mesh.py``) and the processor that runs on it (``sharded.py``)."""
