"""Assigned input-shape sets, one per architecture family (verbatim from
the assignment).  Each entry gives the global shape; sharding over the mesh
is applied by the dry-run harness."""

LM_SHAPES = {
    "train_4k":   {"kind": "train",   "seq_len": 4_096,   "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32_768, "global_batch": 32},
    "decode_32k": {"kind": "decode",  "seq_len": 32_768,  "global_batch": 128},
    "long_500k":  {"kind": "decode",  "seq_len": 524_288, "global_batch": 1},
}

GNN_SHAPES = {
    "full_graph_sm": {"kind": "full", "n_nodes": 2_708, "n_edges": 10_556,
                      "d_feat": 1_433},
    "minibatch_lg":  {"kind": "minibatch", "n_nodes": 232_965,
                      "n_edges": 114_615_892, "batch_nodes": 1_024,
                      "fanout": (15, 10)},
    "ogb_products":  {"kind": "full", "n_nodes": 2_449_029,
                      "n_edges": 61_859_140, "d_feat": 100},
    "molecule":      {"kind": "molecule", "n_nodes": 30, "n_edges": 64,
                      "batch": 128},
}

RECSYS_SHAPES = {
    "train_batch":    {"kind": "train", "batch": 65_536},
    "serve_p99":      {"kind": "serve", "batch": 512},
    "serve_bulk":     {"kind": "serve", "batch": 262_144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}


def subgraph_budget(batch_nodes: int, fanout) -> tuple[int, int]:
    """Padded (n_nodes, n_edges) for a fanout-sampled subgraph."""
    nodes, edges, frontier = batch_nodes, 0, batch_nodes
    for f in fanout:
        frontier = frontier * f
        edges += frontier
        nodes += frontier
    return nodes, edges
