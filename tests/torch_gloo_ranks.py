"""Process-group workers for ``tests/test_torch_dist.py``: each rank of a
``torch.distributed`` gloo group runs the port's merge tree and gradient
all-mean on its own lane of the cases, and writes what it got.

Kept apart from the test file so that the spawned ranks import torch and
the port only, not the JAX package.
"""

import numpy as np
import torch
import torch.distributed as dist


def run(rank: int, world: int, store: str, cases: list, out_dir: str):
    """One rank: ``cases`` is a list of ``(name, n_ranks, inputs_npz,
    kwargs)``; a case on fewer ranks than the world runs on a subgroup of
    the first ``n_ranks`` (every rank creates it, as ``new_group``
    requires).  Writes ``<out_dir>/<name>.<rank>.npz``."""
    from repro_torch.dist.collectives import tree_merge_topk
    from repro_torch.dist.grad_compression import compress_gradients

    dist.init_process_group("gloo", init_method=store, rank=rank,
                            world_size=world)
    try:
        groups = {}
        for n in sorted({c[1] for c in cases}):
            groups[n] = (dist.group.WORLD if n == world
                         else dist.new_group(list(range(n))))
        for name, n, path, kw in cases:
            if rank >= n:
                continue
            group = groups[n]
            z = np.load(path)
            if kw.get("kind") == "grads":
                g = {"w": torch.as_tensor(z["g"])}
                e = {"w": torch.as_tensor(z["e"])}
                out, err = compress_gradients(g, e, group=group)
                np.savez(f"{out_dir}/{name}.{rank}.npz",
                         out=out["w"].numpy(), err=err["w"].numpy())
                continue
            vals = torch.as_tensor(z["vals"][rank])
            ids = torch.as_tensor(z["ids"][rank])
            d, i = tree_merge_topk(
                vals, ids, axes=tuple(kw["axes"]),
                axis_sizes=tuple(kw["sizes"]), k=kw["k"],
                codec=kw["codec"], carry=kw["carry"], fan_in=kw["fan_in"],
                exact_vals=kw["exact_vals"], group=group)
            np.savez(f"{out_dir}/{name}.{rank}.npz", vals=d.numpy(),
                     ids=i.numpy())
    finally:
        dist.destroy_process_group()
