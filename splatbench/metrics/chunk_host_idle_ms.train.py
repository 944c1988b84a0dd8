"""Milliseconds a traced chunk in which the device stood idle while the
trainer did its host work between chunks (the ``qed.chunk.host`` ranges:
the metrics read, K's adaptation, the refine, the eval image;
``splatbench.stages``)."""

from splatbench import stages


def read(run):
    return stages.layer_ms("chunk_host_idle_ms", run)
