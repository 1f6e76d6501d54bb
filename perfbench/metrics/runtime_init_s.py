"""The runtime's start: ``ray_tpu_torch.init()``'s call to its return in
the run's main process, as the program records it (its lifecycle phase
``runtime.init``, host clock).  None from a program that records no
such phase."""


def read(r):
    from ray_tpu_torch.util import tracing

    lifecycle = getattr(tracing, "lifecycle", None)
    if lifecycle is None:
        return None
    inits = [p["end"] - p["start"] for p in lifecycle()
             if p["name"] == "runtime.init"]
    return inits[-1] if inits else None
