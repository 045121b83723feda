"""Multi-device scaling on torch.distributed (counterpart of
scaloam_tpu/parallel): sharded ScanContext retrieval, grid k-NN and
pose-graph solves over the `kf` axis of a DeviceMesh, and the
multi-sequence front end over its `seq` axis, one process per device.
"""
