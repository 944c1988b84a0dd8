"""Sharded training: the mesh of torch.distributed ranks, the sharded
train step and the launcher of a one-host job (port of ``parallel/``)."""
