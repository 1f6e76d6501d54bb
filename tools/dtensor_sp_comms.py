#!/usr/bin/env python3
"""Which collectives the port's Llama issues with the sequence sharded
over ``sp``.

    python3 tools/dtensor_sp_comms.py

Two gloo ranks on the CPU, ``MeshConfig(sp=2)``: the rules put ``seq`` on
``sp`` (``parallel.sharding.DEFAULT_RULES``), so every activation of the
mesh forward is sharded on its sequence dimension while RoPE's tables
are replicated.  Prints, on rank 0:

- for ``apply_rope`` of a q sharded on its sequence by replicated
  tables, the collectives and the output's placements (whether DTensor
  gathers the sequence or slices the tables);
- the collectives of one no-grad loss of ``LlamaConfig.tiny`` (1 layer)
  with ring and with Ulysses attention, after a warm-up call: DTensor's
  own and ``parallel.collectives``' all-to-alls.  ``CommDebugMode`` does
  not count point-to-point operations, so the ring's ppermutes (one
  exchange of k and v per ring step after the first) are not listed.
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
    from ray_tpu_torch.ops import apply_rope, rope
    from ray_tpu_torch.parallel import MeshConfig, make_mesh, shard_pytree

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        mesh = make_mesh(MeshConfig(sp=2), "cpu")

        def counts(mode):
            return {str(op).split(".")[-1]: n
                    for op, n in mode.get_comm_counts().items()}

        q = distribute_tensor(torch.randn(2, 32, 4, 16), mesh.device_mesh,
                              [Shard(1)], src_data_rank=None)
        cos, sin = (shard_pytree(t, (None, None), mesh) for t in rope(32, 16))
        with CommDebugMode() as mode:
            out = apply_rope(q, cos, sin)
        if rank == 0:
            print(f"apply_rope, q (2, 32, 4, 16) sharded on seq over sp=2: "
                  f"{counts(mode)}, output {out.placements}", flush=True)
        for impl in ("ring", "ulysses"):
            cfg = LlamaConfig.tiny(attn_impl=impl, num_layers=1)
            params = shard_pytree(init_params(
                cfg, torch.Generator().manual_seed(0), "cpu"),
                param_logical_axes(cfg), mesh)
            batch = {"tokens": torch.from_numpy(
                np.random.default_rng(0).integers(
                    0, cfg.vocab_size, size=(4, 33)))}
            with torch.no_grad():
                loss_fn(params, batch, cfg, mesh=mesh)
                with CommDebugMode() as mode:
                    loss_fn(params, batch, cfg, mesh=mesh)
            if rank == 0:
                print(f"tiny 1-layer loss, {impl} attention, sp=2: "
                      f"{counts(mode)}", flush=True)
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
