#!/usr/bin/env python3
"""Which collectives DTensor issues for the port's Llama under ``fsdp``.

    python3 tools/dtensor_fsdp_comms.py

Two gloo ranks on the CPU.  ``kernel_in`` is sharded over ``fsdp`` while
the batch is too (``parallel.sharding.DEFAULT_RULES``), so each matmul
of a batch-sharded activation by a weight sharded on its contraction
dimension needs one side moved: DTensor gathers the weight (ZeRO-3) or
reshards the activation onto the contraction dimension and leaves a
partial sum, whichever its cost model finds cheaper.  Prints, on rank 0:

- for three single matmuls (x (128, k) sharded on rows, w (k, n) sharded
  on k), the collectives and the output's placement;
- the collectives of one no-grad loss of ``LlamaConfig.tiny`` (1 layer,
  flash attention on its plain path) under ``MeshConfig(dp=1, fsdp=2)``,
  after a warm-up call.
"""

import pathlib
import socket
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _rank(rank, port):
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from ray_tpu_torch.models import (
        LlamaConfig, init_params, loss_fn, param_logical_axes)
    from ray_tpu_torch.parallel import MeshConfig, make_mesh, shard_pytree

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        mesh = make_mesh(MeshConfig(dp=1, fsdp=2), "cpu")
        dm = mesh.device_mesh

        def counts(mode):
            return {str(op).split(".")[-1]: n
                    for op, n in mode.get_comm_counts().items()}

        for k, n in ((64, 64), (64, 256), (256, 64)):
            x = distribute_tensor(torch.randn(128, k), dm, [Shard(0)],
                                  src_data_rank=None)
            w = distribute_tensor(torch.randn(k, n), dm, [Shard(0)],
                                  src_data_rank=None)
            with CommDebugMode() as mode:
                y = x @ w
            if rank == 0:
                print(f"x (128, {k}) @ w ({k}, {n}): {counts(mode)}, output "
                      f"{y.placements}", flush=True)
        cfg = LlamaConfig.tiny(attn_impl="flash", num_layers=1)
        params = shard_pytree(init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"),
            param_logical_axes(cfg), mesh)
        batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(4, 33)))}
        with torch.no_grad():
            loss_fn(params, batch, cfg, mesh=mesh)
            with CommDebugMode() as mode:
                loss_fn(params, batch, cfg, mesh=mesh)
        if rank == 0:
            print(f"tiny 1-layer loss under fsdp=2: {counts(mode)}",
                  flush=True)
    finally:
        dist.destroy_process_group()


def main():
    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.spawn(_rank, args=(port,), nprocs=2)


if __name__ == "__main__":
    main()
