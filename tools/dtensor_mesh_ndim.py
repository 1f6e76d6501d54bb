#!/usr/bin/env python3
"""Host time of DTensor's sharding propagation against the number of
``DeviceMesh`` dimensions.

    python3 tools/dtensor_mesh_ndim.py [max_ndim]

One process, a gloo group of world size 1, and for n = 1 .. max_ndim
(default 5) a mesh of n dimensions of size 1.  For each, an (8, 8)
matmul and a pointwise expression with one input replicated and one
sharded on dimension 0 over the first mesh dimension: the first call
(propagation, then cached) and the second.  Every operator's first call
enumerates placements over the product of the mesh dimensions, so its
time grows with each dimension even of size 1: the reason
``parallel.mesh.make_mesh`` gives its ``DeviceMesh`` a dimension only
for each axis of size above 1.  Prints one line per n; the numbers are
host seconds on whatever CPU runs it.
"""

import socket
import sys
import time


def main(max_ndim: int) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        print(f"torch {torch.__version__}, host CPU, gloo world size 1")
        for n in range(1, max_ndim + 1):
            mesh = init_device_mesh("cpu", (1,) * n, mesh_dim_names=tuple(
                f"d{i}" for i in range(n)))
            rep = [Replicate()] * n
            a = distribute_tensor(torch.randn(8, 8), mesh,
                                  [Shard(0)] + rep[1:], src_data_rank=None)
            b = distribute_tensor(torch.randn(8, 8), mesh, rep,
                                  src_data_rank=None)
            t0 = time.perf_counter()
            a @ b
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            a @ b
            again = time.perf_counter() - t0
            t0 = time.perf_counter()
            (a * b + 1).sum()
            pointwise = time.perf_counter() - t0
            print(f"ndim {n}: matmul first call {first} s, second {again} "
                  f"s; mul+add+sum first calls {pointwise} s", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5)
