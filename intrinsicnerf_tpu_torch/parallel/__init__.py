"""Data parallelism over GPUs, one process per GPU: the twin of
``intrinsicnerf_tpu/parallel``.  ``distributed`` starts the process group
and shards the image ids, ``mesh`` holds the group, its collectives and
the pool sharding, ``sharded_step`` the data-parallel train step and
``sharded_render`` the split full-image render."""
