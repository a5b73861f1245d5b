"""Multi-process data parallelism over torch.distributed (port of
yogo_tpu/parallel/)."""
