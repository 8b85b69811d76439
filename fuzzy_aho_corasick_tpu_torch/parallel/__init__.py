"""Multi-device and multi-process parallelism: halo-overlapped corpus shards
over a mesh of devices (``shard_search``) and host shards whose match rows
are gathered over ``torch.distributed`` (``multihost``)."""
