"""The train step's optimizer kernels (``rtt_optim_sumsq`` for the global
norm, ``rtt_optim_adamw`` for the clipped update): one step's least time
over their measured time a step, in percent.

The least time is the bytes the arithmetic needs over the card's memory
rate: 32 a parameter (the norm reads each f32 grad once; the update reads
the param, the grad and both moments once and writes the param and both
moments once).  The measured time is the device seconds of every kernel
whose name holds ``rtt_optim_`` in the traced window over the launches of
``rtt_optim_adamw`` there, one a step for a tree whose pointer table fits
one launch.  A program without these kernels reads nothing."""

import math

PREFIX = "rtt_optim_"
UPDATE = "rtt_optim_adamw"
BYTES_PER_PARAM = 32


def read(r):
    if r.trace is None:
        return None
    _, steps = r.trace.kernel(UPDATE)
    if not steps:
        return None
    seconds, _ = r.trace.kernel(PREFIX)
    params = sum(math.prod(shape) for _, shape in r.arch.weight_shapes(
        r.model))
    least = BYTES_PER_PARAM * params / r.peaks["hbm_bytes_per_s"]
    return 100.0 * least * steps / seconds
