"""Distributed substrate (``repro.dist``): the stacked mesh, logical-axis
resolution, explicit collectives, wire codecs, and the generic
sharded-index layer.

Modules:
    mesh.py         the port's mesh: S logical devices stacked on one torch
                    device (``Mesh``, ``device_count``,
                    ``force_device_count``); port-only
    sharding.py     logical -> physical mesh-axis resolution
                    (``partition_spec``, ``rows_sharding``)
    collectives.py  ``tree_merge_topk`` -- the compressed hierarchical top-k
                    merge behind every sharded ANN search, on the stacked
                    mesh or a ``torch.distributed`` group -- and the
                    row-sharded embedding lookup
    wire.py         merge-tree distance codecs (f32/bf16/u16/int8) and the
                    wire-byte models the sharded bench gates on
    shard_state.py  shard any registered ``IndexState`` over a mesh recipe
                    (``ShardPlan`` registry, ``shard_index`` / ``reshard``
                    / ``ensure_servable``, ``sharded_search``)
    grad_compression.py  error-feedback gradient quantisation + all-mean;
                    ``compression.py`` is its deprecated import shim
"""
