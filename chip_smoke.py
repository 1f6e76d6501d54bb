#!/usr/bin/env python3
"""Build and drive the PyTorch port (``ray_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. The card: name, count, ``nvidia-smi`` name and power limit; TF32 off.
2. Build every CUDA kernel from ``ray_tpu_torch/ops/csrc`` (one ``nvcc``
   per source, in parallel); print ptxas' register and spill lines.
3. K1 (flash-attention forward) against its plain PyTorch version at the
   flagship shape, one non-causal, one ragged GQA shape and the long
   shape (b=2, s=2048, h=32, d=128: the heads of ``llama2_7b`` at its
   max_seq_len): o within 2e-2 (bf16 output, f32 accumulation), lse
   within 1e-3 (f32).  At the flagship and the long shape: the times of
   the kernel, the plain version and ``scaled_dot_product_attention``
   beside the bound, and at the flagship the wrapper's host time per call.
4. K3 (dq, and delta = rowsum(o * do) in its prologue) then K2 (dk/dv),
   as the backward launches them, at the same four shapes against the
   plain backward on the same inputs: delta within 1e-5 * max|delta| of
   the PyTorch rowsum, each of dq, dk, dv within 2e-2 * max|plain| (a few
   bf16 ulps at the largest magnitude), and no further from an f32
   ``mha_reference`` autograd gradient than 2x the plain version's
   distance + 1e-3.  At the flagship and the long shape: the times of K3,
   K2, the plain versions and the SDPA backward (which covers K2 + K3 +
   delta together), and the bounds from ``k23_work``.
5. K4 (paged decode attention) against its plain version: exact at the
   serving shape (f32, h=1, d=32, block 8, window=1), with the wrapper's
   time per call there; at a general bf16 shape (B=8, h=6, d=128, block
   16, ctx 1-1024, windows 0 and 64) and at two long shapes (llama2_7b's
   heads, h=32, d=128, block 16, 2048 positions, for 4 and for 32
   sequences) each element within 1e-3 + 1e-2 * |plain| (one bf16 ulp
   passes, a lost page does not); at the 32-sequence shape window=1 is
   bitwise plain and the stored rows.  Times from the profiler's kernel
   records, the bound from the bytes and flop these inputs need.
   Then K5 (the optimizer: ``rtt_optim_sumsq``, the global norm, and
   ``rtt_optim_adamw``, the clipped update) over the trees of the two
   benchmark configurations (``perfbench/configs``: Mixtral-8x7B at one
   layer, 1.71 B parameters; Mistral-7B-v0.3 at eight, 2.01 B): the norm
   within 1e-6 relative of the plain version and bitwise across two
   calls, one update through ``optim.adamw_`` against the plain
   version's on each tree (p, m and v within 1e-6 of each leaf's largest
   magnitude, compared leaf by leaf); the device
   times of each kernel beside its bound (4 and 28 bytes a parameter),
   of the plain version, and of ``clip_grad_norm_(foreach=True)`` with
   ``torch.optim.AdamW(fused=True)`` as a yardstick only (the port
   never calls them).  On each main path that trains (phases 8, 11-14,
   15 (a), 16's fixed-batch learner updates, 18, 19's trainer, 21 (a)'s
   resumed trainer and 22's holder) K5's launches are counted over the
   path's own run, zeroed just before it, and checked: one
   ``rtt_optim_adamw`` an update, and one ``rtt_optim_sumsq`` an update
   except under a mesh, whose DTensor grads take the plain norm.  The
   kernels line gives them as K5's ``launches`` (phase 8) and
   ``launches_<path>``.
   Then K6 (the MoE layer's row movers: ``rtt_moe_gather``, the
   dispatch and the combine's backward, and ``rtt_moe_combine``, the
   combine and the dispatch's backward) at the Mixtral cell's shape (T
   16384, d 4096, 8 experts, top 2, capacity 5120, bf16, 40% of the
   slots filled): each launch bitwise its plain version and across two
   calls (the dots within 1e-5 of the largest), its device time beside
   its byte bound and the plain version's, and the forward pair beside
   ``index_select`` + ``index_add_`` (a yardstick) and the dense one-hot
   formulation it replaced.  Phase 12 checks K6's launches on its
   forward and its step (the kernels line: ``launches_<path>``).
6. Main path 1: the flagship Llama forward through
   ``ray_tpu_torch.entry.entry()`` at full width (12 layers, 4 x 512,
   bf16): finite logits, K1 launched 12 times per forward, the loss of the
   K1 path within 2e-2 of the plain-attention path; ms per forward,
   tokens/s, peak memory; K1's device time per launch inside the forward
   and the forward's device busy time, from its profile.
7. Main path 2: 16 requests from threads through the paged decoder under
   the continuous batcher (paged_kv, prefix caching, speculative_k=3):
   every chain bitwise ``reference_decode``, K4 launched, prefix hits.
8. Main path 3: the flagship train step (``ray_tpu_torch.train``, remat
   on, batch 4 x 513 tokens, AdamW with a short warmup): K1/K2/K3
   launched 24/12/12 times per step; the first step's loss within 1e-3
   of ``loss_fn`` under no_grad; its grads against the plain-attention
   step's (grad_norm within 2e-2 relative, each leaf's relative L2 error
   within 5e-2); a falling, finite loss over the steps on one batch; ms
   per step, tokens/s, peak memory, the plain-attention step's time, and
   a profile of one step (K1's, K2's and K3's time per launch inside it,
   busy time).
9. Main path 4, the serving path through the port's runtime:
   ``ray_tpu_torch.init`` with no ``num_tpus`` must count the card (the
   accelerator pool equals ``torch.cuda.device_count()``); a
   ``num_tpus=1`` task runs in another process with
   ``CUDA_VISIBLE_DEVICES`` naming the card and sees its name, a CPU task
   sees ``""`` and no CUDA.  ``serve.run`` deploys the decoder of phase 7
   (a subclass with a ``probe`` method) with ``num_tpus=1`` and its knobs
   from ``_system_config``; phase 7's 16 requests go through the handle
   from 16 threads: every chain bitwise ``reference_decode``, the
   replica's ``kv_debug`` paged with ``used + available`` its pool, and
   the probe shows the replica in its own process, on ``cuda``, with K4
   launched there.  Logs the deploy time (worker spawn + replica start),
   the first request's latency and the 16 requests' wall time.

10. Main path 5, disaggregated serving.  In this process: a prefill and
   a decode replica on the card; ``prefill_export`` (an inline
   descriptor), ``_open_chain`` and the decode of the adopted chain give
   16 chains over 4 shared 20-token prefixes, every one bitwise
   ``reference_decode``, all 16 imported, K4 launched on the imported
   pages.  Through the runtime (``disaggregated_serving`` on): the decode
   pool (``role="decode"``, ``num_tpus=1``) in a worker granted the card,
   the prefill pool (``role="prefill"``, ``num_tpus=0``, ``device="cpu"``:
   one card cannot hold two granted replicas); the same 16 requests
   through the handle, request 0 with the ``_timing`` probe: every chain
   bitwise, the decode replica's ``kv_debug`` with 16 chains imported and
   its blocks whole, the prefill replica with no export outstanding and
   chains streamed over the node store, K4 launched in the decode
   replica's process.  Logs the deploy time, the first request's latency,
   the wall time and the TTFT.
11. Main path 6, the trainer through the runtime:
   ``DataParallelTrainer(..., TorchConfig(), ScalingConfig(num_workers=1,
   tpu_chips_per_worker=1))``; the loop takes phase 8's flagship state
   and batch for 4 steps and reports each; the worker sees the card, its
   process group is NCCL of world size 1, the first loss is within 1e-3
   of phase 8's, the loss falls, K1/K2/K3 launched 96/48/48 times in the
   worker (and a profile of one step there shows 24/12/12), and the last
   report's checkpoint (params and their bf16 head) reaches the driver
   with every leaf's digest equal.  Logs ms per step (median of steps
   2-4), the worker's start and fit()'s wall time.

12. Main path 7, the MoE flagship without a mesh: the flagship with 8
   experts in every layer, top-2 routing, capacity factor 1.25, aux
   coefficient 0.01 (757M params), weights from seed 0.  Its forward at
   4 x 512: finite logits, K1 launched 12 times a forward, the K1 path's
   loss within 2e-2 of the plain-attention path's; ms per forward,
   tokens/s, peak memory, the aux loss, the share of (token, choice)
   assignments dropped over capacity and a profile.  Its train step at
   4 x 513 (``default_optimizer(lr=1e-3, warmup=2, decay_steps=100)``):
   K1/K2/K3 launched 24/12/12 times a step, the first loss within 1e-3
   of ``loss_fn``'s under no_grad, a finite falling loss over 9 steps on
   one batch; ms per step, tokens/s, peak memory and a profiled step;
   K6 launched once of each kernel a layer's forward, three times a
   layer's step (forward, recompute, backward).
   Its grads against the plain-attention step: each path routing for
   itself, grad_norm within 2e-2 relative (the share of top-2 choices
   that differ and the per-leaf errors logged); on the K1 step's routing
   replayed, phase 8's limits (grad_norm within 2e-2 relative, each
   leaf's relative L2 error within 5e-2).
13. Main path 8, the sharded path: an NCCL process group of world size
   1 in this process on loopback, ``make_mesh(MeshConfig())`` on the
   card, ``init_train_state(..., mesh=...)`` with phase 12's seed (params
   and AdamW moments DTensors); the MoE loss under the mesh within 1e-3
   of phase 12's (bitwise logged), K1 launched 12 times inside the
   manual region; 3 train steps under the mesh: the first loss within
   1e-3 of phase 12's first, grad_norm within 2e-2 relative, K1/K2/K3
   24/12/12 a step; ms per step beside phase 12's.  The group is
   destroyed before the phase ends.
14. Main path 9, sequence and pipeline parallelism: again an NCCL group
   of world size 1 and ``make_mesh(MeshConfig())``, the dense flagship of
   phase 8 (its seeds, 4 x 513).  Ulysses attention: the mesh loss within
   1e-3 of phase 8's first loss (bitwise logged), K1 launched 12 times a
   forward, 3 train steps with phase 8's limits (first loss within 1e-3,
   grad_norm within 2e-2 relative) and K1/K2/K3 24/12/12 a step.  Ring
   attention (plain torch, the reference's XLA path): the loss within
   1e-3, K1 launched 0 times.  ``forward_pipelined`` with 4 microbatches
   and flash attention (at pp=1 the one-stage shortcut): the logits
   against the mesh forward's (bitwise logged), the loss within 1e-3 of
   it, K1 12 a forward, and 3 steps of ``make_train_step(pipelined=True,
   num_microbatches=4)`` with the limits and launches above.  ms per
   forward and per step (median of steps 2-3) beside phases 6, 8 and
   13, and profiles of the Ulysses forward and step, the ring forward and
   the pipelined step.  The group is destroyed before the phase ends.
15. Main path 10, the 1F1B pipeline trainer (``train.pipeline_actors``).
   (a) Its single-host path on the card (the default device): phase 8's
   dense flagship and batch cut by ``pipeline_stage_params(params, 2)``,
   ``make_pipeline_stage_fn``/``make_pipeline_loss_fn``, 4 microbatches,
   phase 8's optimizer, 4 steps: the first loss within 1e-3 of phase 8's
   first (bitwise logged), grad_norm within 2e-2 relative, a falling
   loss, K1/K2/K3 96/48/48 a step (remat: each microbatch's layers
   recompute K1); ms per step beside phases 8 and 14, and a profile.
   (b) Through the port's runtime: the reference's integer toy (D = 4,
   B = 8, 4 layers, ``sgd(1.0)``, M = 4) in 2 CPU stage actors named by
   ``device="cpu"``: a 1F1B and a fill/drain step, losses and params
   bitwise the single-host steps, at least 16 microbatch pushes, no
   stage restart; a card-bound 2-stage trainer must raise (one card:
   stages on cards need one each).
16. Main path 11, rllib on the card.  One ``Learner.update`` (PPO loss,
   256 rows) on the card against the same update on the CPU: every param
   within 1e-4; V-trace on the card against the CPU within 1e-5.  PPO on
   a numpy CartPole-v1 (gymnasium's dynamics, thresholds and 500-step
   truncation; the chip machine has no gymnasium) with the reference
   test's settings, its learner in an actor granted the card, 2 CPU
   rollout workers: ``episode_reward_mean >= 120`` within 12
   ``train()`` calls.  IMPALA with 2 aggregators and its learner on the
   card behind the H2D queue (pinned host copies, non-blocking on a side
   stream): finite losses, batches delivered through pinned copies.
   APPO with its learner on the card: finite losses, target syncs.
17. Main path 12, rllib's off-policy, offline and multi-agent half and
   tune on the card; no TPU kernel lies on it, so it adds no launch
   count.  (a) One update of DQN, SAC (the same two normal draws), CQL
   and BC on the card against the CPU from the same weights and batch:
   every param within 1e-4; ms per update.  (b) DQN on the numpy
   CartPole-v1 with the reference slow test's settings (2 CPU rollout
   workers x 2 envs, fragment 64, 500 steps before learning, epsilon over
   4000 steps, target sync every 500), its learner on the card:
   ``episode_reward_mean >= 100`` within 30 ``train()`` calls, finite
   losses, epsilon falling, a target sync.  (c) Two-policy PPO on a numpy
   copy of the reference test's ``TwoAgentMatch``, learners on the card:
   ``episode_reward_mean > 9.0`` after 12 calls, agent steps twice the
   env steps.  (d) BC and CQL from logged data written by the port's
   ``JsonWriter``: BC's ``bc_loss < 0.9`` after 10 calls and its actions
   matching the cue on >= 75% of obs, CQL's losses finite.  (e) SAC on a
   numpy Pendulum-v1 (gymnasium's dynamics, limits and 200-step
   truncation): 3 calls past warm-up with finite losses, alpha moved.
   (f) ``tune.run(PPO)`` over a 2-point lr grid, each trial granted the
   card (``resources_per_trial={"CPU": 1, "TPU": 1}``), one at a time: 2
   trials, no error, each trial's learner on ``cuda`` as read inside it.
18. Main path 13, data -> trainer: ``ray_tpu_torch.data`` feeding the
   data-parallel trainer.  1,024 rows of 513 int32 tokens in [0, 32000)
   (Zipf-distributed, seed 0), ``from_numpy(parallelism=16)``, a task
   ``map_batches`` to int64 ``{"tokens": (n, 513)}`` blocks, an actor-pool
   ``map_batches`` (2 actors) turning token 13 into EOS 2,
   ``random_shuffle(seed=0)``; ``DataParallelTrainer(datasets={"train":
   ds}, TorchConfig(), ScalingConfig(num_workers=1,
   tpu_chips_per_worker=1))``.  The worker granted the card iterates its
   shard for one epoch (``iter_batches(batch_size=4, drop_last=True)``:
   256 steps), each batch pinned and copied to the card, then phase 8's
   flagship state and train step.  Checks: the worker is not the driver
   and holds the card; the multiset of the epoch's row digests equals the
   transformed source rows' (every row seen once); the first loss within
   1e-3 of this process's step on the batch the worker reported, from
   phase 8's seed-0 state; a finite loss that falls (the last 16 steps'
   mean under the first 16's); K1/K2/K3 launched 6144/3072/3072 (2 L, L,
   L a step) in the worker.  Logs ms per step against phase 11's, the
   data wait's median, p99 and share of the loop's wall, the H2D ms, the
   worker start, fit()'s wall and the shard's stats in the worker.
19. Main path 14, the autoscaler brings a card node up on demand.
   ``cluster_utils.Cluster(head_num_cpus=2)``: the head's pool holds no
   card.  ``FakeSliceProvider`` with one node type, ``h100-1`` (``{"CPU":
   2, "TPU": 1}``, at most one; each node a real node agent), and
   ``StandardAutoscaler(idle_timeout_s=5, update_interval_s=0.5)`` on
   its own loop (``start()``).  Phase 11's trainer (4 steps): its
   worker's one-card placement group is the demand the loop meets by
   launching the node.  Checks: one launch; the worker on that node, its
   ``CUDA_VISIBLE_DEVICES`` the card, the card's name this process's; the
   first loss within 1e-3 of phase 8's, finite losses, K1/K2/K3 24/12/12
   a step in the worker.  While the worker holds the node, through
   ``python -m ray_tpu_torch.scripts`` against the head's address and
   authkey: ``status`` lists 2 alive nodes and ``TPU`` 1; ``submit`` runs
   a job whose driver runs one ``num_tpus=1`` task, the flagship forward
   of ``entry()`` (finite logits of the flagship's shape, K1 launched 12
   times, counted in the task) on the same node's card; the task is
   queued before the trainer's last report and starts after it (the
   pool's release); the job ends ``SUCCEEDED``; ``logs`` returns the
   task's line; ``timeline --out`` writes a trace holding the trainer's
   and the job's task events on the node's lane.  Then the idle node is
   drained and terminated: the head alone within 30 s of the job's end,
   the agent's process gone, no pid of the node's workers in
   ``nvidia-smi --query-compute-apps``, no autoscaler error.  Logs demand
   -> launch, launch -> node alive, the worker's start, ms per step
   against phase 11's, the job's submit -> ``SUCCEEDED`` and idle ->
   terminated.  Then the launcher: ``scripts up`` of a
   ``subprocess``-provider config with one ``h100-1`` worker type (its
   head under ``RAY_TPU_FORCE_NUM_TPUS=0``, so only the node owns the
   card; the launcher's state under a temporary ``HOME``), a
   ``num_tpus=1`` probe through ``scripts exec`` (on the card, in the
   node's worker), the dashboard's ``/api/nodes`` from the probe's
   process showing 2 alive nodes and the node's ``TPU`` 1/1 and no other
   card, ``scripts down``, and the head's and the agent's processes
   gone.
20. Main path 15, the sharded decoder, at vocab 32000 (the flagship's)
   and embed 256 (the widest row K4 takes), integer f32 weights, paged
   KV, prefix caching, speculative_k=3.  K4 at that shape (B=8, h=1,
   block 8, window 1) bitwise its plain version, with its time and
   bound.  A device list naming a card that is not there raises.  (a)
   In this process: the projection in 4 column blocks on the one card
   (``device=["cuda:0"] * 4``) and a 1-shard decoder on the same
   weights, each warmed by one request on another prompt, then phase
   7's 16 requests (the first alone, then 15 threads): every chain of
   both bitwise ``reference_decode``, K4 launched, prefix hits; the
   wall, steps and ms per step of each, and the device time of the 4
   block products and their merge against the one whole product, at
   the verify shape (8 x 4 rows).  (b) Through the runtime:
   ``serve.run`` of phase 9's probed decoder with
   ``ray_actor_options={"num_tpus": 1}``, ``device=None`` and the same
   weights: the granted worker resolves one shard per visible card (1
   here), the 16 requests bitwise, K4 launched in the replica's
   process, ``serve.serving_stats`` with mode ``continuous+paged`` and
   16 retired.
21. Main path 16, recovery on the card.  (a) Phase 11's trainer with
   ``FailureConfig(max_failures=1)``: at step 2 the worker reports its
   whole state (f32 params, both AdamW moments, the step count: about
   1.95 GB) as a checkpoint, and once the report has returned the
   worker kills itself with SIGKILL.  ``fit()`` must restart the
   group from that checkpoint: the new worker, granted the same card,
   restores the state and runs steps 3-4, K1/K2/K3 launched 24/12/12 a
   step in its process, losses within 1e-3 of phase 11's steps 3-4
   (whether they are bitwise is printed).  (b) Phase 20's decoder
   (one shard) through ``serve.run`` on a worker granted the card
   answers 8 of the 16 requests; the replica's worker is killed with
   SIGKILL; the controller's replacement, granted the card the dead
   worker released, answers the other 8, K4 launched in its process.
   All 16 chains bitwise ``reference_decode``, no request failed.
   Both print the seconds from the kill to the death being seen, the
   card free and granted again, and the new worker's first step or
   answer; (a) also splits the death: the kill, the worker a zombie (a
   poller process reading ``/proc``), the head's reader at its EOF and
   the death processed.  (c) The same replica, whose paged step waits on
   a gate: 8 requests in flight in it (the handle counts 8, none ready),
   SIGKILL of its worker, then the gate opens.  Each caller gets a chain
   bitwise ``reference_decode`` or an actor error, none waits past 60 s;
   the test sends every failed request again and the replacement, on
   the card, answers each bitwise, K4 launched in its process.  Prints
   the seconds from the kill to each caller's outcome, the card free and
   granted again, and the replacement's first answer.
22. Main path 17, a head failover under a card holder.  An external
   head (``Cluster(external_head=True, head_num_tpus=1)``) and this
   process as its client.  A client starts no trainer (it creates no
   placement group, in the reference too), so a named actor granted the
   card runs phase 11's loop one step a call: the flagship at full
   width, phase 11's state, batch and optimizer, an NCCL group of world
   size 1.  After step 2 the head is killed (SIGKILL) and restarted from
   its snapshot.  The holder keeps its pid and ``CUDA_VISIBLE_DEVICES``
   over all 4 steps; steps 3-4 are within 1e-3 of phase 11's (bitwise
   printed), K1/K2/K3 24/12/12 a step in its process; a second
   ``num_tpus=1`` task sent after the restart is not ready 10 s later,
   and runs under the same card once the holder is killed.  Prints the
   head's downtime, the restart to the holder's re-registration, and the
   holder's end to the second grant.

Launch counts are set to 0 just before each main path and read just after
it (in paths 4-6, 13, 14, 15 b, 16 and 17, in the replica's, the
trainer's, the holder's or the job task's process).
Prints the kernels line, then as its last line ``{"ok": true, "device":
{...}}``.
Exits non-zero, with no result, when there is no card or the port is not
beside this script.
"""

import dataclasses
import json
import math
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOPS = 989e12           # dense tensor-core peak, bf16
F32_FLOPS = 67e12             # f32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters):
    """Mean ms per call by CUDA events over ``iters`` calls after 3 warm-up
    calls (warm L2)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _profile(torch, run, reps):
    """Run ``run`` ``reps`` times under torch.profiler: ({CUDA kernel or
    copy name: device us per run}, host wall us per run, {name: records
    of it in the ``reps`` runs})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = {e.key: e.self_device_time_total / reps for e in events}
    return busy, wall_us, {e.key: e.count for e in events}


def device_ms(torch, run, reps, kernel=None, tries=5, floor_ms=0.0,
              top=0):
    """Device time per call: the profiler's kernel times.  With
    ``kernel`` (a kernel launched once a call), the mean of the records
    of the kernels whose name holds it: the profiler now and then keeps
    only some of a run's records (19 of 20, 7 of 50), and a mean over
    those kept is still a call's time.  Without it, every kernel's time
    over ``reps``.  A profiled run now and then records no kernel at all,
    or less than the call's whole time (logged); raises when ``tries``
    runs in a row record no such kernel, or less than ``floor_ms``, the
    least time the card could take for the call's work: a host-clock
    time or a partial record is no device time.  ``top`` logs that many
    of the kernels taking it."""
    for i in range(tries):
        busy, _, counts = _profile(torch, run, reps)
        if kernel is None:
            ms = sum(busy.values()) / 1e3
        else:
            n = sum(c for k, c in counts.items() if kernel in k)
            ms = sum(t for k, t in busy.items()
                     if kernel in k) * reps / max(n, 1) / 1e3
        if ms and ms >= floor_ms:
            for name, us in sorted(busy.items(), key=lambda kv: -kv[1])[:top]:
                log(f"  {us} us ({counts[name]} records in {reps} runs)  "
                    f"{name[:100]}")
            return ms
        log(f"profiled run {i + 1} of {tries} recorded {ms} ms of device "
            f"time for {kernel or 'the call'} (bound {floor_ms} ms; "
            f"{len(busy)} device records: {sorted(counts.items())})")
    raise RuntimeError(f"the profiler recorded no whole device time for "
                       f"{kernel or 'the call'}")


def bound(nbytes, flops, peak_flops, f32_flops=0):
    """Least ms for the work: bytes over the memory rate or operations
    over their peak rates (``f32_flops`` outside the tensor cores),
    whichever is longer, and which."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops + f32_flops / F32_FLOPS
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def k1_work(b, s, h, causal, d=128):
    """Bytes K1 must move (q, k, v read once, o and lse written once) and
    its flop (4 d per (q, k) pair that the causal mask keeps)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * b * s * h * d * 2 + b * h * s * 4, 4 * d * pairs * b * h


def host_ms(torch, fn, iters=200):
    """Host time per call: the enqueue alone (no synchronize inside the
    clock), after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return dt


def k1_phase(torch, dev):
    """K1 against its plain version at four shapes (the flagship, one
    non-causal, one ragged GQA, and the long shape: the heads of
    LlamaConfig.llama2_7b at its max_seq_len); at the flagship and the
    long shape also the times of the kernel, the plain version and SDPA
    beside the bound."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.ops.layers import repeat_kv_heads

    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"name": "K1_flash_fwd", "route": "cuda",
              "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
              "replaces": "ray_tpu/ops/attention.py:100"}
    for b, s, h, h_kv, causal, what in (
            (4, 512, 6, 6, True, "flagship"), (2, 256, 6, 6, False, None),
            (2, 500, 6, 2, True, None), (2, 2048, 32, 32, True, "long")):
        q, k, v = (torch.randn((b, s, hh, 128), generator=gen, device=dev)
                   .to(torch.bfloat16) for hh in (h, h_kv, h_kv))
        o, lse = attention.flash_attention_fwd(q, k, v, causal=causal)
        qs = attention._prescale(q, 128 ** -0.5)
        k2, v2 = repeat_kv_heads(q, k, v)
        o_p, lse_p = attention._flash_fwd_plain(qs, k2, v2, causal)
        torch.cuda.synchronize()
        err_o = float((o.float() - o_p.float()).abs().max())
        err_l = float((lse - lse_p).abs().max())
        log(f"K1 b={b} s={s} h={h}->{h_kv} causal={causal}: "
            f"o max_abs_err={err_o} (<=2e-2) lse max_abs_err={err_l} "
            f"(<=1e-3)")
        check(err_o <= 2e-2 and err_l <= 1e-3, "K1 disagrees with plain")
        if what is None:
            continue
        sfx = "" if what == "flagship" else "_long"

        def run():
            return attention.flash_attention_fwd(q, k, v, causal=causal)

        nbytes, flops = k1_work(b, s, h, causal)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        ms = device_ms(torch, run, 20, kernel="flash_fwd_kernel",
                       floor_ms=b_ms)
        plain_ms = device_ms(torch, lambda: attention._flash_fwd_plain(
            qs, k2, v2, causal), 3, floor_ms=b_ms)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = device_ms(torch, lambda: sdpa(qt, kt, vt,
                                               is_causal=causal), 20,
                           floor_ms=b_ms)
        log(f"K1 {what} shape b={b} s={s} h={h} (device time per call): "
            f"kernel {ms} ms ({flops / ms / 1e9} TFLOP/s), plain "
            f"{plain_ms} ms, sdpa {lib_ms} ms, bound {b_ms} ms ({b_by}: "
            f"{nbytes} B, {flops} flop)")
        result.update({"max_abs_err" + sfx: err_o,
                       "lse_max_abs_err" + sfx: err_l, "ms" + sfx: ms,
                       "plain_ms" + sfx: plain_ms, "bound_ms" + sfx: b_ms,
                       "bound_by" + sfx: b_by, "library_ms" + sfx: lib_ms})
        if what == "flagship":
            result["call_ms"] = cuda_ms(run, 50)
            result["wrapper_host_ms"] = host_ms(torch, run)
            result["kernel_wrapper_host_ms"] = host_ms(
                torch, lambda: attention._flash_fwd_cuda(qs, k, v, causal))
            log(f"K1 wrapper at the flagship shape: call {result['call_ms']}"
                f" ms (CUDA events, back to back); host time per call "
                f"{result['wrapper_host_ms']} ms (flash_attention_fwd), "
                f"{result['kernel_wrapper_host_ms']} ms (_flash_fwd_cuda)")
    return result


def k23_work(b, s, h, causal, d=128):
    """Bytes and flop of the backward's kernels at a (b, s, h, d) shape
    with as many kv heads as q heads.  K2 reads q, k, v, do, lse and delta
    once and writes dk and dv, 8 d flop per (q, k) pair the causal mask
    keeps (four products); K3 reads q, k, v, do and lse, writes dq and
    delta, 6 d flop per pair (three products); its delta prologue adds
    one read of o and 2 d f32 flop per row."""
    pairs = s * (s + 1) // 2 if causal else s * s
    t_b = b * s * h * d * 2          # each of q, k, v, o, do, dq, dk, dv
    row_b = b * h * s * 4            # each of lse, delta
    return {"K2": (6 * t_b + 2 * row_b, 8 * d * pairs * b * h),
            "K3": (5 * t_b + 2 * row_b, 6 * d * pairs * b * h),
            "delta": (t_b, 2 * d * b * h * s)}


def k23_phase(torch, dev):
    """K3 (dq, with delta in its prologue) then K2 (dk, dv), as the
    backward launches them, against the plain backward at K1's four
    shapes; at the flagship and the long shape the times of K3, K2, the
    plain versions and the SDPA backward (which covers K2 + K3 + delta
    together) beside the bounds."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.ops.layers import repeat_kv_heads

    gen = torch.Generator(device=dev).manual_seed(2)
    scale = 128 ** -0.5
    k2 = {"name": "K2_flash_dkdv", "route": "cuda",
          "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
          "replaces": "ray_tpu/ops/attention.py:181"}
    k3 = {"name": "K3_flash_dq", "route": "cuda",
          "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
          "replaces": "ray_tpu/ops/attention.py:227"}
    for b, s, h, h_kv, causal, what in (
            (4, 512, 6, 6, True, "flagship"), (2, 256, 6, 6, False, None),
            (2, 500, 6, 2, True, None), (2, 2048, 32, 32, True, "long")):
        q, k, v, do = (torch.randn((b, s, hh, 128), generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for hh in (h, h_kv, h_kv, h))
        qs = attention._prescale(q, scale)
        o, lse = attention._flash_fwd_cuda(qs, k, v, causal)
        dq, delta = attention._flash_dq_cuda(qs, k, v, o, do, lse, causal,
                                             scale)
        dk, dv = attention._flash_dkdv_cuda(qs, k, v, do, lse, delta, causal)
        delta_p = attention._delta(o, do)
        k2r, v2r = repeat_kv_heads(q, k, v)
        dk_p, dv_p = (attention._sum_kv_groups(x, h_kv) for x in
                      attention._flash_dkdv_plain(qs, k2r, v2r, do, lse,
                                                  delta_p, causal))
        dq_p = attention._flash_dq_plain(qs, k2r, v2r, do, lse, delta_p,
                                         causal, scale)
        # The f32 gradient of the same function, by autograd.
        qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
        of = attention.mha_reference(qf, *repeat_kv_heads(qf, kf, vf),
                                     causal=causal)
        ref = torch.autograd.grad(of, (qf, kf, vf), do.float())
        del of
        torch.cuda.synchronize()
        err_d = float((delta - delta_p).abs().max())
        lim_d = 1e-5 * float(delta_p.abs().max())
        log(f"K3 delta b={b} s={s} h={h}->{h_kv} causal={causal}: "
            f"max_abs_err to rowsum(o*do) {err_d} (<= {lim_d})")
        check(err_d <= lim_d, "K3's delta disagrees with rowsum(o*do)")
        errs = {}
        for name, got, plain, r in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                       (dq_p, dk_p, dv_p), ref):
            diff = float((got.float() - plain.float()).abs().max())
            lim = 2e-2 * float(plain.float().abs().max())
            e_k = float((got.float() - r).abs().max())
            e_p = float((plain.float() - r).abs().max())
            log(f"K2/K3 b={b} s={s} h={h}->{h_kv} causal={causal} {name}: "
                f"max_abs_err to plain {diff} (<= {lim}, 2e-2*max|plain|); "
                f"to f32 reference: kernel {e_k}, plain {e_p} (kernel <= "
                f"{2 * e_p + 1e-3})")
            check(diff <= lim, f"{name} disagrees with the plain backward")
            check(e_k <= 2 * e_p + 1e-3, f"{name} is further from the f32 "
                  f"gradient than the plain backward allows")
            errs[name] = diff
        del ref, qf, kf, vf
        if what is None:
            continue
        sfx = "" if what == "flagship" else "_long"
        work = k23_work(b, s, h, causal)
        b2 = bound(*work["K2"], BF16_FLOPS)
        n3 = work["K3"][0] + work["delta"][0]
        b3 = bound(n3, work["K3"][1], BF16_FLOPS, f32_flops=work["delta"][1])
        # The plain dq takes delta as an input; the SDPA backward does at
        # least K2's work (dk and dv).
        b3_plain = bound(*work["K3"], BF16_FLOPS)[0]
        ms3 = device_ms(torch, lambda: attention._flash_dq_cuda(
            qs, k, v, o, do, lse, causal, scale), 20,
            kernel="flash_dq_kernel", floor_ms=b3[0])
        ms2 = device_ms(torch, lambda: attention._flash_dkdv_cuda(
            qs, k, v, do, lse, delta, causal), 20, kernel="flash_dkdv_kernel",
            floor_ms=b2[0])
        plain2 = device_ms(torch, lambda: attention._flash_dkdv_plain(
            qs, k2r, v2r, do, lse, delta_p, causal), 3, floor_ms=b2[0])
        plain3 = device_ms(torch, lambda: attention._flash_dq_plain(
            qs, k2r, v2r, do, lse, delta_p, causal, scale), 3,
            floor_ms=b3_plain)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        ot = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2)
        lib_ms = device_ms(torch, lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), 20, floor_ms=b2[0])
        del ot
        port_ms = ms2 + ms3
        log(f"K2/K3 {what} shape b={b} s={s} h={h} (device time per call): "
            f"K3 (with delta) {ms3} ms, K2 {ms2} ms, K2+K3 {port_ms} ms "
            f"({port_ms / lib_ms} x the SDPA backward); plain K2 {plain2} "
            f"ms, plain K3 {plain3} ms; SDPA backward (K2+K3+delta "
            f"together) {lib_ms} ms; bound K2 {b2[0]} ms ({b2[1]}: "
            f"{work['K2'][0]} B, {work['K2'][1]} flop), K3 {b3[0]} ms "
            f"({b3[1]}: {n3} B, {work['K3'][1]} flop + {work['delta'][1]} "
            f"f32 flop)")
        joint = {"library_covers" + sfx: "K2+K3+delta (SDPA backward)",
                 "port_bwd_ms" + sfx: port_ms, "library_ms" + sfx: lib_ms}
        k2.update({"max_abs_err" + sfx: max(errs["dk"], errs["dv"]),
                   "ms" + sfx: ms2, "plain_ms" + sfx: plain2,
                   "bound_ms" + sfx: b2[0], "bound_by" + sfx: b2[1]},
                  **joint)
        k3.update({"max_abs_err" + sfx: errs["dq"],
                   "delta_max_abs_err" + sfx: err_d, "ms" + sfx: ms3,
                   "plain_ms" + sfx: plain3, "bound_ms" + sfx: b3[0],
                   "bound_by" + sfx: b3[1]}, **joint)
    return k2, k3


def _paged_inputs(torch, dev, seed, B, h, d, bs, max_ctx, dtype):
    import numpy as np

    rng = np.random.default_rng(seed)
    width = -(-max_ctx // bs)
    nb = B * width
    q = torch.from_numpy(rng.normal(size=(B, h, d))).to(dev, dtype)
    kc = torch.from_numpy(rng.normal(size=(nb, bs, h, d))).to(dev, dtype)
    vc = torch.from_numpy(rng.normal(size=(nb, bs, h, d))).to(dev, dtype)
    bt = torch.from_numpy(rng.permutation(nb).reshape(B, width)
                          .astype(np.int32)).to(dev)
    cl = rng.integers(1, max_ctx + 1, size=B).astype(np.int32)
    return q, kc, vc, bt, torch.from_numpy(cl).to(dev), cl


def k4_work(q, cl_np, window, bs):
    """Bytes K4 must move and the flop it does on these inputs: q and o
    once, and per sequence the k and v rows of ``[max(ctx - window, 0),
    ctx)``, the block-table entries of the pages that hold them, and its
    context length."""
    B, h, d = q.shape
    rows = pages = 0
    for c in (int(c) for c in cl_np):
        lo = max(c - window, 0) if window else 0
        rows += c - lo
        pages += (c - 1) // bs - lo // bs + 1
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * rows * h * d * q.element_size() + 4 * pages + 4 * B)
    return nbytes, 4 * h * d * rows


def k4_plain(q, kc, vc, bt, cl, window):
    """K4's plain PyTorch version, pre-scaled as the wrapper scales."""
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.ops.paged_attention import _paged_attention_plain

    qs = attention._prescale(q, q.shape[-1] ** -0.5)
    return _paged_attention_plain(qs, kc, vc, bt, cl, window)


def k4_phase(torch, dev):
    from ray_tpu_torch.ops.paged_attention import paged_attention

    # The serving shape (what the decoder's _read_last launches).
    q, kc, vc, bt, cl, cl_np = _paged_inputs(torch, dev, 0, 8, 1, 32, 8, 40,
                                             torch.float32)
    out = paged_attention(q, kc, vc, bt, cl, window=1)
    ref = k4_plain(q, kc, vc, bt, cl, 1)
    torch.cuda.synchronize()
    exact = torch.equal(out, ref)
    err = float((out - ref).abs().max())
    log(f"K4 serving shape (f32, B=8, h=1, d=32, bs=8, window=1): "
        f"exact={exact} max_abs_err={err}")
    check(exact, "K4 is not exact at window=1")
    def run():
        return paged_attention(q, kc, vc, bt, cl, window=1)

    nbytes, flops = k4_work(q, cl_np, 1, 8)
    b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
    ms = device_ms(torch, run, 50, kernel="paged_decode_kernel",
                   floor_ms=b_ms)
    call_ms = cuda_ms(run, 200)
    wrapper_host_ms = host_ms(torch, run)
    plain_ms = device_ms(torch, lambda: k4_plain(q, kc, vc, bt, cl, 1), 20,
                         floor_ms=b_ms)
    log(f"K4 serving shape (device time per call): kernel {ms} ms, plain "
        f"{plain_ms} ms, bound {b_ms} ms ({b_by}: {nbytes} B, {flops} "
        f"flop); wrapper call {call_ms} ms (CUDA events, back to back), "
        f"host time per call {wrapper_host_ms} ms")
    result = {"name": "K4_paged_decode", "route": "cuda",
              "source": "ray_tpu_torch/ops/csrc/paged_decode.cu",
              "replaces": "ray_tpu/ops/paged_attention.py:85",
              "max_abs_err": err, "ms": ms, "call_ms": call_ms,
              "wrapper_host_ms": wrapper_host_ms,
              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": None}
    # A general shape: bf16, long ragged contexts, two windows.  Each
    # element within 1e-3 + 1e-2 * |plain|: a one-ulp bf16 rounding
    # difference passes, a dropped or repeated page of 16 rows does not.
    q, kc, vc, bt, cl, cl_np = _paged_inputs(torch, dev, 1, 8, 6, 128, 16,
                                             1024, torch.bfloat16)
    for window in (0, 64):
        out = paged_attention(q, kc, vc, bt, cl, window=window)
        ref = k4_plain(q, kc, vc, bt, cl, window).float()
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        n_out = int((diff > 1e-3 + 1e-2 * ref.abs()).sum())
        nbytes, flops = k4_work(q, cl_np, window, 16)
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        ms = device_ms(torch, lambda: paged_attention(
            q, kc, vc, bt, cl, window=window), 20, kernel="paged_decode",
            floor_ms=b_ms)
        plain_ms = device_ms(torch, lambda: k4_plain(
            q, kc, vc, bt, cl, window), 5, floor_ms=b_ms)
        log(f"K4 general shape (bf16, B=8, h=6, d=128, bs=16, ctx "
            f"{int(cl_np.min())}-{int(cl_np.max())}, window={window}): "
            f"max_abs_err={err}, {n_out} elements outside 1e-3 + "
            f"1e-2*|plain|; kernel {ms} ms, plain {plain_ms} ms, bound "
            f"{b_ms} ms ({b_by}: {nbytes} B, {flops} flop)")
        check(n_out == 0, f"K4 disagrees with plain at window={window}")
        sfx = f"_general_w{window}"
        result.update({"max_abs_err" + sfx: err, "ms" + sfx: ms,
                       "plain_ms" + sfx: plain_ms, "bound_ms" + sfx: b_ms})
    # The long shapes: llama2_7b's heads (h=32, d=128, bf16, vLLM's block
    # of 16) at its max_seq_len of 2048, for 4 and for 32 sequences, made
    # on the card (the batch shape's pool is 1 GB of bf16).
    for B, what in ((4, "long_few"), (32, "long_batch")):
        q, kc, vc, bt, cl = _paged_long_inputs(torch, dev, 3 + B, B)
        cl_np = cl.cpu().numpy()
        out = paged_attention(q, kc, vc, bt, cl)
        ref = k4_plain(q, kc, vc, bt, cl, 0).float()
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        n_out = int((diff > 1e-3 + 1e-2 * ref.abs()).sum())
        del ref, diff
        nbytes, flops = k4_work(q, cl_np, 0, 16)
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        ms = device_ms(torch, lambda: paged_attention(q, kc, vc, bt, cl), 20,
                       kernel="paged_decode", floor_ms=b_ms)
        plain_ms = device_ms(torch, lambda: k4_plain(q, kc, vc, bt, cl, 0), 3,
                             floor_ms=b_ms)
        log(f"K4 {what} shape (bf16, B={B}, h=32, d=128, bs=16, ctx 2048, "
            f"window=0): max_abs_err={err}, {n_out} elements outside 1e-3 + "
            f"1e-2*|plain|; kernel {ms} ms (bound / kernel {b_ms / ms}), "
            f"plain {plain_ms} ms, bound {b_ms} ms ({b_by}: {nbytes} B, "
            f"{flops} flop)")
        check(n_out == 0, f"K4 disagrees with plain at the {what} shape")
        result.update({"max_abs_err_" + what: err, "ms_" + what: ms,
                       "plain_ms_" + what: plain_ms,
                       "bound_ms_" + what: b_ms, "bound_by_" + what: b_by})
        if what == "long_batch":
            out = paged_attention(q, kc, vc, bt, cl, window=1)
            ref = k4_plain(q, kc, vc, bt, cl, 1)
            rows = vc[bt[:, -1].long(), 15]
            torch.cuda.synchronize()
            exact = torch.equal(out, ref) and torch.equal(out, rows)
            log(f"K4 {what} shape, window=1: bitwise plain and the stored "
                f"rows: {exact}")
            check(exact, f"K4 is not exact at window=1 at the {what} shape")
        del q, kc, vc, out
        torch.cuda.empty_cache()
    return result


def k5_trees():
    """{configuration: [leaf shapes]} of the benchmark's two cells."""
    from perfbench.arch.decoder_lm import weight_shapes

    out = {}
    for name in ("mixtral-8x7b-1l", "mistral-7b-v0.3-8l"):
        with open(f"perfbench/configs/{name}.json") as f:
            out[name] = [shape for _, shape in weight_shapes(json.load(f))]
    return out


def k5_phase(torch, dev):
    """K5 over the benchmark cells' trees: the kernels against the plain
    version, then each pass's device time beside its bound, the plain
    version's and the library's."""
    from ray_tpu_torch.ops import optim

    sched = dict(grad_clip=1.0, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 lr=3e-6, bc1=1 - 0.9 ** 5, bc2=1 - 0.95 ** 5)
    result = {"name": "K5_optimizer", "route": "cuda",
              "source": "ray_tpu_torch/ops/csrc/optim.cu",
              "replaces": None}
    for cell, shapes in k5_trees().items():
        gen = torch.Generator(device=dev).manual_seed(0)
        n = sum(math.prod(s) for s in shapes)
        ps = [torch.randn(s, generator=gen, device=dev).mul_(0.02)
              for s in shapes]
        gs = [torch.randn(s, generator=gen, device=dev).mul_(1e-4)
              for s in shapes]
        ms = [torch.randn(s, generator=gen, device=dev).mul_(1e-5)
              for s in shapes]
        vs = [torch.rand(s, generator=gen, device=dev).mul_(1e-9)
              for s in shapes]
        norm = optim.global_norm(gs)
        again = optim.global_norm(gs)
        plain = optim._global_norm_plain(gs)
        torch.cuda.synchronize()
        rel = abs(norm.item() - plain.item()) / plain.item()
        log(f"K5 {cell} ({len(shapes)} leaves, {n} parameters): norm "
            f"{norm.item()} against plain {plain.item()}, relative "
            f"{rel}; bitwise across two calls: {torch.equal(norm, again)}")
        check(rel <= 1e-6, f"K5 norm off the plain version's for {cell}")
        check(torch.equal(norm, again), f"K5 norm not repeatable, {cell}")
        # One update through the port's wrapper against the plain version,
        # leaf by leaf from copies of p, m and v, each freed once compared.
        rp, rm, rv = ([t.clone() for t in ts] for ts in (ps, ms, vs))
        optim.adamw_(ps, gs, ms, vs, norm, **sched)
        worst = 0.0
        for i, g in enumerate(gs):
            optim._adamw_plain_([rp[i]], [g], [rm[i]], [rv[i]], plain,
                                **sched)
            for got, want in ((ps[i], rp[i]), (ms[i], rm[i]),
                              (vs[i], rv[i])):
                worst = max(worst, float((got - want).abs().max()
                                         / want.abs().max()))
            rp[i] = rm[i] = rv[i] = None
        torch.cuda.synchronize()
        del rp, rm, rv
        torch.cuda.empty_cache()
        log(f"K5 {cell} update through optim.adamw_ against plain: worst "
            f"leaf max|diff| / max|plain| {worst}")
        check(worst <= 1e-6, f"K5 update off the plain version's, {cell}")

        def update():
            optim.adamw_(ps, gs, ms, vs, norm, **sched)

        def plain_step():
            nrm = optim._global_norm_plain(gs)
            optim._adamw_plain_(ps, gs, ms, vs, nrm, **sched)

        sq_b, _ = bound(4 * n, 0, BF16_FLOPS)
        up_b, _ = bound(28 * n, 0, BF16_FLOPS)
        sq_ms = device_ms(torch, lambda: optim.global_norm(gs), 10,
                          kernel="rtt_optim_sumsq", floor_ms=sq_b)
        up_ms = device_ms(torch, update, 10, kernel="rtt_optim_adamw",
                          floor_ms=up_b)
        plain_ms = device_ms(torch, plain_step, 3, floor_ms=sq_b + up_b)
        del ms, vs
        torch.cuda.empty_cache()
        params = [torch.nn.Parameter(p) for p in ps]
        for p, g in zip(params, gs):
            p.grad = g
        lib = torch.optim.AdamW(params, lr=3e-6, betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=0.1, fused=True)

        def library():
            torch.nn.utils.clip_grad_norm_(params, 1.0, foreach=True)
            lib.step()

        lib_ms = device_ms(torch, library, 3, floor_ms=sq_b + up_b)
        log(f"K5 {cell} (device time per step): norm {sq_ms} ms (bound "
            f"{sq_b} ms, {4 * n} B: {sq_b / sq_ms}), update {up_ms} ms "
            f"(bound {up_b} ms, {28 * n} B: {up_b / up_ms}); both "
            f"{sq_ms + up_ms} ms against {sq_b + up_b} ms ("
            f"{(sq_b + up_b) / (sq_ms + up_ms)}, "
            f"{32 * n / (sq_ms + up_ms) / 1e9} TB/s); plain {plain_ms} ms; "
            f"clip_grad_norm_(foreach) + AdamW(fused) {lib_ms} ms")
        sfx = "" if cell.startswith("mixtral") else "_" + cell
        result.update({k + sfx: v for k, v in (
            ("params", n), ("update_err", worst), ("sumsq_ms", sq_ms),
            ("adamw_ms", up_ms), ("ms", sq_ms + up_ms),
            ("bound_ms", sq_b + up_b), ("plain_ms", plain_ms),
            ("library_ms", lib_ms))})
        del params, lib, ps, gs
        torch.cuda.empty_cache()
    return result


FLASH = ("rtt_flash_fwd_bf16", "rtt_flash_dkdv_bf16", "rtt_flash_dq_bf16")
K5 = ("rtt_optim_sumsq", "rtt_optim_adamw")
K5_PATHS = {}   # {main path: [rtt_optim_sumsq, rtt_optim_adamw] launches}


def k5_path(path, launches, updates, norms=None):
    """Checks and records K5's launches on a main path that made
    ``updates`` optimizer updates (``launches``: {kernel: launches} of
    the path's own run, zeroed just before it): one ``rtt_optim_adamw``
    an update, and one ``rtt_optim_sumsq`` for each of ``norms`` (every
    update by default; 0 under a mesh, whose DTensor grads take the plain
    norm)."""
    got = [launches.get(k, 0) for k in K5]
    want = [updates if norms is None else norms, updates]
    log(f"K5 launches on {path}: {got} in {updates} updates (expected "
        f"{want})")
    check(got == want, f"K5 launched {got} times on {path}, expected {want}")
    K5_PATHS[path] = got


K6 = ("rtt_moe_gather", "rtt_moe_combine")
K6_PATHS = {}   # {main path: [rtt_moe_gather, rtt_moe_combine] launches}


def k6_path(path, launches, want):
    """Checks and records K6's launches on a MoE path: ``want`` of each
    kernel (one gather and one combine a layer's forward, the same again
    in its recompute, and one of each in its backward)."""
    got = [launches.get(k, 0) for k in K6]
    log(f"K6 launches on {path}: {got} (expected {[want, want]})")
    check(got == [want, want], f"K6 launched {got} times on {path}, "
          f"expected {[want, want]}")
    K6_PATHS[path] = got


def k6_phase(torch, dev):
    """K6 at the Mixtral cell's shape (T 16384, d 4096, 8 experts, top 2,
    capacity 5120, bf16), on a routing that leaves experts over and under
    their capacity: each of the layer's four launches (the dispatch and
    the combine, and their backwards) against its plain version, then
    its device time beside its byte bound and the plain version's; the
    forward pair against ``index_select`` + ``index_add_`` (a yardstick;
    the port never calls it) and against the dense one-hot formulation
    it replaced (``moe.dense``, the casts and the two einsums)."""
    from ray_tpu_torch.ops import moe

    t, d, e, k = 16384, 4096, 8, 2
    cap = int(1.25 * t * k / e)
    s = e * cap
    gen = torch.Generator(device=dev).manual_seed(0)
    # Uneven expert load: 40% of the slots filled (the Mixtral cell: 34-39%).
    bias = torch.linspace(6.0, 0.0, e, device=dev)
    r = moe.route(torch.randn(t, e, generator=gen, device=dev) + bias, k,
                  cap)
    bf = torch.bfloat16
    x, g = (torch.randn(t, d, generator=gen, device=dev).to(bf)
            for _ in range(2))
    y = torch.randn(s, d, generator=gen, device=dev).to(bf)
    w = (r.keep * r.gates).to(bf)
    kept = int(r.keep.sum())
    rows_in = int(r.keep.any(-1).sum())  # tokens with a kept choice
    row = 2 * d
    gather, combine = K6
    # what: (kernel, the K6 call, its plain version, bytes); each call
    # returns (rows, the gates' dots or None).
    runs = {
        "dispatch": (gather, lambda: moe.gather(x, r.source, k),
                     lambda: moe._gather_plain(x, r.source, k, None, None),
                     rows_in * row + s * row + 4 * s),
        "combine": (combine, lambda: (moe.combine(y, r.slot, w), None),
                    lambda: (moe._combine_plain(y, r.slot, w), None),
                    kept * row + t * row + 6 * t * k),
        "combine_grad": (gather, lambda: moe.gather(g, r.source, k, w=w, b=y),
                         lambda: moe._gather_plain(g, r.source, k, w, y),
                         (rows_in + kept + s) * row + 8 * s + 2 * t * k),
        "dispatch_grad": (combine, lambda: (moe.combine(y, r.slot), None),
                          lambda: (moe._combine_plain(y, r.slot, None), None),
                          kept * row + t * row + 4 * t * k),
    }
    result = {"name": "K6_moe", "route": "cuda",
              "source": "ray_tpu_torch/ops/csrc/moe.cu", "replaces": None,
              "kept": kept, "slots": s}
    for what, (name, kernel, plain, nbytes) in runs.items():
        got, want, again = kernel(), plain(), kernel()
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]), f"K6 {what} off its plain "
              f"version")
        check(all(a is None or torch.equal(a, b)
                  for a, b in zip(got, again)), f"K6 {what} not repeatable")
        if got[1] is not None:
            rel = float(((got[1] - want[1]).abs()).max()
                        / want[1].abs().max())
            log(f"K6 {what}: dot max|diff| / max|plain| {rel}")
            check(rel <= 1e-5, f"K6 {what}'s dots off the plain version")
        b_ms, _ = bound(nbytes, 0, BF16_FLOPS)
        ms = device_ms(torch, kernel, 10, kernel=name, floor_ms=b_ms)
        p_ms = device_ms(torch, plain, 3, floor_ms=b_ms)
        log(f"K6 {what} ({name}; {kept} of {t * k} assignments kept in "
            f"{s} slots): {ms} ms (bound {b_ms} ms, {nbytes} B: "
            f"{b_ms / ms}, {nbytes / ms / 1e9} TB/s); plain {p_ms} ms")
        result.update({f"{what}_ms": ms, f"{what}_bound_ms": b_ms,
                       f"{what}_plain_ms": p_ms})
        del got, want, again
    keep_tok = torch.nonzero(r.keep)[:, 0]
    keep_slot = r.slot[r.keep].long()
    w_kept = w[r.keep][:, None]
    src_tok = (r.source.long().clamp(min=0) // k)

    def library():
        x.index_select(0, src_tok)
        torch.zeros(t, d, dtype=bf, device=dev).index_add_(
            0, keep_tok, y.index_select(0, keep_slot) * w_kept)

    def dense():
        disp, comb = moe.dense(r)
        torch.einsum("tec,td->ecd", disp.to(bf), x)
        torch.einsum("tec,ecd->td", comb.to(bf), y.view(e, cap, d))

    fwd_b = result["dispatch_bound_ms"] + result["combine_bound_ms"]
    lib_ms = device_ms(torch, library, 3, floor_ms=fwd_b)
    dense_ms = device_ms(torch, dense, 2, floor_ms=fwd_b)
    fwd_ms = result["dispatch_ms"] + result["combine_ms"]
    four = sum(result[f"{what}_ms"] for what in runs)
    four_b = sum(result[f"{what}_bound_ms"] for what in runs)
    log(f"K6 at the Mixtral shape: the four launches {four} ms against "
        f"{four_b} ms ({four_b / four}); forward pair {fwd_ms} ms, "
        f"index_select + index_add_ {lib_ms} ms, the dense one-hot "
        f"dispatch and combine (tables to (T, E, C), casts, two einsums) "
        f"{dense_ms} ms")
    result.update({"ms": four, "bound_ms": four_b, "library_ms": lib_ms,
                   "forward_ms": fwd_ms, "dense_forward_ms": dense_ms})
    del r, x, g, y
    torch.cuda.empty_cache()
    return result


def _paged_long_inputs(torch, dev, seed, B, h=32, d=128, bs=16, ctx=2048):
    """q, a pool of B * ctx / bs pages with tables permuted over it, and
    every context at ``ctx``, from a seeded generator on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    width = ctx // bs
    q, kc, vc = (torch.randn(shape, generator=gen, device=dev)
                 .to(torch.bfloat16)
                 for shape in ((B, h, d), (B * width, bs, h, d),
                               (B * width, bs, h, d)))
    bt = torch.randperm(B * width, generator=gen, device=dev).view(
        B, width).int()
    cl = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    return q, kc, vc, bt, cl


def llama_phase(torch):
    from ray_tpu_torch.entry import _flagship_cfg, entry
    from ray_tpu_torch.models import forward, loss_fn
    from ray_tpu_torch.ops import _build

    fn, (params, tokens) = entry()
    cfg = _flagship_cfg()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()                       # main path 1 starts
    with torch.no_grad():
        logits = fn(params, tokens)
        torch.cuda.synchronize()
        first = _build.launches["rtt_flash_fwd_bf16"]
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            fn(params, tokens)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n
    launches = _build.launches["rtt_flash_fwd_bf16"]       # main path 1 ends
    peak = torch.cuda.max_memory_allocated()
    check(first == cfg.num_layers, f"K1 launched {first} times in one "
          f"forward, expected {cfg.num_layers}")
    check(launches == cfg.num_layers * (n + 1), "K1 launches per forward")
    check(tuple(logits.shape) == (4, 512, cfg.vocab_size)
          and logits.dtype == torch.float32, "logits shape")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    with torch.no_grad():
        loss_k1, _ = loss_fn(params, {"tokens": tokens}, cfg)
        loss_ref, _ = loss_fn(params, {"tokens": tokens},
                              dataclasses.replace(cfg,
                                                  attn_impl="reference"))
    d_loss = abs(float(loss_k1) - float(loss_ref))
    log(f"flagship forward (12 layers, 4 x 512, bf16): {dt * 1e3} ms per "
        f"forward, {4 * 512 / dt} tokens/s, peak memory {peak} B, "
        f"K1 launches {launches} ({first} per forward)")
    log(f"flagship loss: K1 path {float(loss_k1)}, plain-attention path "
        f"{float(loss_ref)}, |diff| {d_loss} (<=2e-2)")
    check(math.isfinite(float(loss_k1)) and d_loss <= 2e-2,
          "flash and reference losses disagree")
    # End to end with the plain attention in K1's place, for comparison.
    cfg_ref = dataclasses.replace(cfg, attn_impl="reference")

    def ref_fn():
        return forward(params, tokens, cfg_ref)

    with torch.no_grad():
        ref_fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            ref_fn()
        torch.cuda.synchronize()
        dt_ref = (time.perf_counter() - t0) / n
    log(f"flagship forward with plain mha_reference attention: "
        f"{dt_ref * 1e3} ms per forward")
    with torch.no_grad():
        busy = profile_run(torch, lambda: fn(params, tokens), "forward")
    return launches, kernels_in_path(busy, {"flash_fwd_kernel": first},
                                     "forward"), dt * 1e3


def kernels_in_path(busy, per_run, what):
    """Device ms per launch inside a profiled main path of each kernel in
    ``per_run`` ({kernel name: launches per run}), as {kernel name:
    {"ms_in_<what>": ms}}, and the path's device busy ms per run."""
    out = {}
    for kernel, n in per_run.items():
        us = sum(t for name, t in busy.items() if kernel in name)
        out[kernel] = {f"ms_in_{what}": us / n / 1e3}
        log(f"{kernel} inside the {what}: {us / n / 1e3} ms per launch "
            f"({n} launches per {what})")
    busy_ms = sum(busy.values()) / 1e3
    log(f"{what} device busy {busy_ms} ms")
    return out, busy_ms


def profile_run(torch, run, what, reps=3, top=10):
    """Device busy time per ``what`` (a forward, a step) and the kernels
    that take it, under torch.profiler; the rest of the wall time is the
    device's idle share (the profiler's own host cost included)."""
    busy, wall_us, _ = _profile(torch, run, reps)
    total = sum(busy.values())
    check(total > 0, f"{what} profile: the profiler recorded no device time")
    log(f"{what} profile (per {what}, {reps} runs): device busy "
        f"{total} us of {wall_us} us wall, idle share "
        f"{1 - total / wall_us}, {len(busy)} kernel names")
    for name, us in sorted(busy.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {us} us ({us / total:.3f} of busy)  {name[:100]}")
    return busy


def train_phase(torch, n=8):
    from ray_tpu_torch.entry import _flagship_cfg
    from ray_tpu_torch.models import loss_fn
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.train import (
        default_optimizer, init_train_state, loss_and_grads, make_train_step)
    from ray_tpu_torch.train.core import global_norm, tree_leaves

    dev = torch.device("cuda:0")
    cfg = _flagship_cfg()
    cfg_ref = dataclasses.replace(cfg, attn_impl="reference")
    check(cfg.remat, "the flagship trains with remat")
    opt = default_optimizer(lr=1e-3, warmup=2, decay_steps=100)
    state = init_train_state(cfg, opt, torch.Generator(device=dev)
                             .manual_seed(0), dev)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (4, 513), dtype=torch.int64, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))}
    # Grads of the K1-K3 step against the plain-attention step on the same
    # params; each leaf's relative L2 error within 5e-2 (bf16 rounding
    # points differ between the two attentions).
    _, _, g = loss_and_grads(state.params, batch, cfg)
    _, _, g_ref = loss_and_grads(state.params, batch, cfg_ref)
    norm = float(global_norm(tree_leaves(g)))
    norm_ref = float(global_norm(tree_leaves(g_ref)))
    rel = [float((a - r).norm() / r.norm())
           for a, r in zip(tree_leaves(g), tree_leaves(g_ref))]
    del g, g_ref
    log(f"flagship grads, K1-K3 step vs plain-attention step: grad_norm "
        f"{norm} vs {norm_ref} (relative {abs(norm - norm_ref) / norm_ref}, "
        f"<= 2e-2); per-leaf relative L2 error max {max(rel)} (<= 5e-2), "
        f"all {rel}")
    check(abs(norm - norm_ref) <= 2e-2 * norm_ref, "grad_norm disagrees")
    check(max(rel) <= 5e-2, "a leaf's grads disagree")
    with torch.no_grad():
        loss0, _ = loss_fn(state.params, batch, cfg)
    step = make_train_step(cfg, opt)
    keys = FLASH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()                       # main path 3 starts
    state, m0 = step(state, batch)
    first = [_build.launches[k] for k in keys]
    metrics = [m0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    launches = [_build.launches[k] for k in keys]  # main path 3 ends
    k5_path("train_step", _build.launches, n + 1)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    L = cfg.num_layers
    log(f"flagship train step (12 layers, 4 x 512 tokens, remat, bf16): "
        f"{dt * 1e3} ms per step, {4 * 512 / dt} tokens/s, peak memory "
        f"{peak} B; launches K1/K2/K3 {launches} in {n + 1} steps ({first} "
        f"in the first)")
    log(f"train losses {losses}; first step's loss {losses[0]} vs loss_fn "
        f"under no_grad {float(loss0)} (<= 1e-3); its grad_norm "
        f"{float(m0['grad_norm'])}")
    check(first == [2 * L, L, L], f"K1/K2/K3 launched {first} times in one "
          f"step, expected {[2 * L, L, L]}")
    check(launches == [x * (n + 1) for x in first], "launches per step")
    check(abs(losses[0] - float(loss0)) <= 1e-3, "step loss != loss_fn")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(losses[-1] < losses[0], "the loss did not fall")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(
        state.params)), "non-finite params")
    # The same step with the plain mha_reference attention, for comparison.
    step_ref = make_train_step(cfg_ref, opt)
    step_ref(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step_ref(state, batch)
    torch.cuda.synchronize()
    log(f"flagship train step with plain mha_reference attention: "
        f"{(time.perf_counter() - t0) / n * 1e3} ms per step")
    busy = profile_run(torch, lambda: step(state, batch), "step", top=12)
    return dict(zip(keys, launches)), kernels_in_path(
        busy, {"flash_fwd_kernel": 2 * L, "flash_dkdv_kernel": L,
               "flash_dq_kernel": L}, "step"), {
        "loss0": losses[0], "grad_norm0": float(m0["grad_norm"]),
        "step_ms": dt * 1e3}


def serve_phase(torch):
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    GLOBAL_CONFIG.paged_kv = True
    GLOBAL_CONFIG.prefix_caching = True
    GLOBAL_CONFIG.speculative_k = 3
    dec = MeshShardedDecoder(kv_blocks=128)
    system = list(range(20))
    reqs = [{"prompt": system + [32 + i % 32, i], "tokens": 3 + i % 10}
            for i in range(16)]
    out = [None] * len(reqs)

    def client(i):
        out[i] = dec(reqs[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    _build.reset_launches()                       # main path 2 starts
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    launches = _build.launches["rtt_paged_decode"]    # main path 2 ends
    check(not any(t.is_alive() for t in threads), "requests hung")
    for r, got in zip(reqs, out):
        check(got == dec.reference_decode(r["prompt"], r["tokens"]),
              f"chain differs from reference_decode for {r}")
    stats = dec.__dict__["__serve_batcher__decode"].stats()
    log(f"served {len(reqs)} requests, {sum(len(o) for o in out)} tokens, "
        f"tokens_per_step {stats['tokens_per_step']}, steps "
        f"{stats['steps']}, prefix_hits {stats['prefix_hits']}, "
        f"spec accepted {stats['spec_accepted']}/{stats['spec_proposed']}, "
        f"K4 launches {launches}, wall {wall} s; every chain bitwise "
        f"reference_decode")
    check(launches > 0, "K4 never launched while serving")
    check(stats["prefix_hits"] > 0, "no prefix hits")
    return launches


def probed_decoder():
    """The port's decoder with a ``probe`` method: the replica's process,
    card and K4 launch count (``reset`` sets the count to 0)."""
    import os

    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    class ProbedDecoder(MeshShardedDecoder):
        def probe(self, reset=False):
            import torch

            from ray_tpu_torch.ops import _build

            out = {"pid": os.getpid(),
                   "cvd": os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "device": self._kv_cache.device.type,
                   "shards": len(self._devices),
                   "cards": torch.cuda.device_count(),
                   "launches": _build.launches["rtt_paged_decode"]}
            if reset:
                _build.reset_launches()
            return out

    return ProbedDecoder


def first_visible_card():
    """The card a one-card grant names: this process's first visible
    card."""
    import os

    visible = os.environ.get("CUDA_VISIBLE_DEVICES") or "0"
    return visible.split(",")[0].strip()


def runtime_serve_phase(torch, smi):
    """Main path 4: phase 7's decoder served by the port's runtime from a
    worker granted the card."""
    import os

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    ProbedDecoder = probed_decoder()

    def grant_probe():
        import torch as t
        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                t.cuda.get_device_name(0), os.getpid())

    def cpu_probe():
        import torch as t
        return os.environ.get("CUDA_VISIBLE_DEVICES"), t.cuda.is_available()

    card = first_visible_card()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4, _system_config={
        "paged_kv": True, "prefix_caching": True, "speculative_k": 3})
    try:
        cards = ray_tpu_torch.cluster_resources().get("TPU", 0)
        log(f"runtime: head up in {time.perf_counter() - t0} s, "
            f"accelerator pool {cards}")
        check(cards == torch.cuda.device_count(),
              f"the head counted {cards} cards, torch sees "
              f"{torch.cuda.device_count()}")
        t0 = time.perf_counter()
        cvd, name, pid = ray_tpu_torch.get(
            ray_tpu_torch.remote(num_tpus=1)(grant_probe).remote(),
            timeout=300)
        log(f"runtime: granted task in pid {pid} saw CUDA_VISIBLE_DEVICES="
            f"{cvd!r}, {name} ({time.perf_counter() - t0} s)")
        check(cvd == card and name == torch.cuda.get_device_name(0)
              and pid != os.getpid(), "granted task did not see the card")
        cvd, avail = ray_tpu_torch.get(
            ray_tpu_torch.remote(cpu_probe).remote(), timeout=300)
        check(cvd == "" and not avail, f"a CPU task saw CUDA_VISIBLE_DEVICES"
              f"={cvd!r}, cuda available {avail}")

        t0 = time.perf_counter()
        dep = serve.deployment(ProbedDecoder, name="decoder", num_tpus=1,
                               max_concurrency=16)
        handle = serve.run(dep.bind(kv_blocks=128), name="decoder")
        before = ray_tpu_torch.get(handle.method("probe").remote(reset=True),
                                   timeout=300)
        deploy_s = time.perf_counter() - t0
        system = list(range(20))
        reqs = [{"prompt": system + [32 + i % 32, i], "tokens": 3 + i % 10}
                for i in range(16)]
        out, lat = [None] * len(reqs), [None] * len(reqs)

        def client(i):
            c0 = time.perf_counter()
            out[i] = ray_tpu_torch.get(handle.remote(reqs[i]), timeout=300)
            lat[i] = time.perf_counter() - c0

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        t0 = time.perf_counter()                  # main path 4 starts
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
        after = ray_tpu_torch.get(handle.method("probe").remote(),
                                  timeout=300)    # main path 4 ends
        check(not any(t.is_alive() for t in threads), "requests hung")
        ref = MeshShardedDecoder(device="cpu")
        for r, got in zip(reqs, out):
            check(got == ref.reference_decode(r["prompt"], r["tokens"]),
                  f"served chain differs from reference_decode for {r}")
        dbg = ray_tpu_torch.get(handle.method("kv_debug").remote(),
                                timeout=300)
        check(dbg["paged"] is True and dbg["used"] + dbg["available"]
              == dbg["kv_blocks_total"] == 128,
              f"replica's kv_debug: {dbg}")
        log(f"runtime: replica pid {after['pid']} (driver {os.getpid()}), "
            f"CUDA_VISIBLE_DEVICES={after['cvd']!r}, tensors on "
            f"{after['device']}, K4 launches {after['launches']} (reset "
            f"from {before['launches']}); kv_debug used {dbg['used']} + "
            f"available {dbg['available']} of {dbg['kv_blocks_total']}, "
            f"prefix_hits {dbg['prefix_hits']}, spec accepted "
            f"{dbg['spec_accepted']}/{dbg['spec_proposed']}; every chain "
            f"bitwise reference_decode")
        check(after["pid"] != os.getpid() and after["cvd"] == card
              and after["device"] == "cuda",
              f"the replica is not in a worker granted the card: {after}")
        check(after["launches"] > 0, "K4 never launched in the replica")
        log(f"runtime serve on {smi}: deploy (worker spawn + replica "
            f"start) {deploy_s} s; first request's latency {lat[0]} s "
            f"(min {min(lat)}, max {max(lat)}); 16 requests, "
            f"{sum(len(o) for o in out)} tokens, wall {wall} s")
        return after["launches"]
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def disagg_requests():
    """Phase 10's 16 requests: 4 shared 20-token prefixes, each request
    its own two last tokens (so every chain is imported, past the prefix
    cache's hit on the shared blocks)."""
    systems = [[(20 * j + t) % 64 for t in range(20)] for j in range(4)]
    return [{"prompt": systems[i % 4] + [32 + i % 32, i],
             "tokens": 3 + i % 10} for i in range(16)]


def run_threads(fn, n, timeout=300):
    """``fn(i)`` for i < n, each in its own thread; raises the first
    error any of them raised, or if one hung."""
    errors = []

    def body(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    check(not any(t.is_alive() for t in threads), "requests hung")
    if errors:
        raise errors[0]


def disagg_inprocess_phase(torch):
    """Main path 5a: the disaggregated handoff in this process, a prefill
    and a decode replica on the card: ``prefill_export`` (inline
    descriptor), ``_open_chain`` and the decode of the adopted chain."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    GLOBAL_CONFIG.paged_kv = True
    GLOBAL_CONFIG.prefix_caching = True
    GLOBAL_CONFIG.speculative_k = 3
    pre = MeshShardedDecoder(kv_blocks=128)
    dec = MeshShardedDecoder(kv_blocks=128)
    reqs = disagg_requests()
    out, kinds = [None] * len(reqs), [None] * len(reqs)

    def client(i):
        descr, _ = pre.prefill_export(reqs[i])
        kinds[i] = descr[0]
        out[i] = dec._decode({**reqs[i], "_import": dec._open_chain(descr)})

    _build.reset_launches()                       # main path 5a starts
    t0 = time.perf_counter()
    run_threads(client, len(reqs))
    wall = time.perf_counter() - t0
    launches = _build.launches["rtt_paged_decode"]    # main path 5a ends
    for r, got in zip(reqs, out):
        check(got == dec.reference_decode(r["prompt"], r["tokens"]),
              f"adopted chain differs from reference_decode for {r}")
    dbg, pdbg = dec.kv_debug(), pre.kv_debug()
    log(f"disaggregated in-process: 16 chains over 4 shared prefixes "
        f"({set(kinds)} descriptors), wall {wall} s; decode replica "
        f"kv_chains_imported {dbg['kv_chains_imported']}, used "
        f"{dbg['used']} + available {dbg['available']}, prefix_hits "
        f"{dbg['prefix_hits']}; prefill replica exports_outstanding "
        f"{pdbg['exports_outstanding']}; K4 launches {launches}; every "
        f"chain bitwise reference_decode")
    check(kinds == ["inline"] * len(reqs), f"descriptors {kinds}")
    check(dbg["kv_chains_imported"] == len(reqs), "chains not imported")
    check(dbg["used"] + dbg["available"] == 128, f"decode blocks: {dbg}")
    check(pdbg["exports_outstanding"] == 0, f"exports left: {pdbg}")
    check(launches > 0, "K4 never launched on the imported pages")
    return launches


def disagg_runtime_phase(torch, smi):
    """Main path 5b: disaggregated serving through the port's runtime.
    The decode pool (``role="decode"``) is granted the card; the prefill
    pool (``role="prefill"``, ``num_tpus=0``) asks for the CPU by name, as
    one card cannot hold two granted replicas.  The chains cross the
    node store between the two workers."""
    import os

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.api import CONTROLLER_NAME, PREFILL_SUFFIX
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    ProbedDecoder = probed_decoder()
    card = first_visible_card()
    torch.cuda.empty_cache()
    ray_tpu_torch.init(num_cpus=4, _system_config={
        "paged_kv": True, "prefix_caching": True, "speculative_k": 3,
        "disaggregated_serving": True})
    try:
        t0 = time.perf_counter()
        serve.run(serve.deployment(
            ProbedDecoder, name="disagg", role="prefill", num_tpus=0,
            max_concurrency=16).bind(kv_blocks=128, device="cpu"),
            name="disagg")
        run_s = [time.perf_counter() - t0]
        handle = serve.run(serve.deployment(
            ProbedDecoder, name="disagg", role="decode", num_tpus=1,
            max_concurrency=16).bind(kv_blocks=128), name="disagg")
        run_s.append(time.perf_counter() - t0 - run_s[0])
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        _, reps, _ = ray_tpu_torch.get(ctrl.handle_snapshot.remote(
            "disagg" + PREFILL_SUFFIX), timeout=60)
        check(len(reps) == 1, f"prefill pool {reps}")
        prefill_rep = reps[0]

        def on_prefill(method, *args):
            return ray_tpu_torch.get(prefill_rep.call_method.remote(
                method, args, {}), timeout=300)

        pre_probe = on_prefill("probe")
        before = ray_tpu_torch.get(handle.method("probe").remote(reset=True),
                                   timeout=300)
        deploy_s = time.perf_counter() - t0
        reqs = disagg_requests()
        # Request 0 also carries the time-to-first-token probe.
        reqs[0] = dict(reqs[0], _timing=True)
        out, lat = [None] * len(reqs), [None] * len(reqs)

        def client(i):
            c0 = time.perf_counter()
            body = dict(reqs[i], _t0=time.time()) if i == 0 else reqs[i]
            out[i] = ray_tpu_torch.get(handle.remote(body), timeout=300)
            lat[i] = time.perf_counter() - c0

        t0 = time.perf_counter()                  # main path 5b starts
        run_threads(client, len(reqs))
        wall = time.perf_counter() - t0
        after = ray_tpu_torch.get(handle.method("probe").remote(),
                                  timeout=300)    # main path 5b ends
        check(isinstance(out[0], dict) and set(out[0]) == {"tokens", "ttft"},
              f"the _timing request returned {out[0]!r}")
        ttft = out[0]["ttft"]
        out[0] = out[0]["tokens"]
        ref = MeshShardedDecoder(device="cpu")
        for r, got in zip(reqs, out):
            check(got == ref.reference_decode(r["prompt"], r["tokens"]),
                  f"disaggregated chain differs from reference_decode "
                  f"for {r}")
        dbg = ray_tpu_torch.get(handle.method("kv_debug").remote(),
                                timeout=300)
        pdbg = on_prefill("kv_debug")
        log(f"disaggregated runtime: decode replica pid {after['pid']} "
            f"(driver {os.getpid()}), CUDA_VISIBLE_DEVICES={after['cvd']!r}, "
            f"tensors on {after['device']}, K4 launches {after['launches']} "
            f"(reset from {before['launches']}); kv_chains_imported "
            f"{dbg['kv_chains_imported']}, used {dbg['used']} + available "
            f"{dbg['available']} of {dbg['kv_blocks_total']}, role "
            f"{dbg['role']}; prefill replica pid {pre_probe['pid']}, "
            f"CUDA_VISIBLE_DEVICES={pre_probe['cvd']!r}, tensors on "
            f"{pre_probe['device']}, role {pdbg['role']}, "
            f"kv_chains_exported {pdbg['kv_chains_exported']}, bytes "
            f"streamed {pdbg['kv_chain_bytes_streamed']}, inline "
            f"fallbacks {pdbg['chain']['inline_fallbacks']}, "
            f"exports_outstanding {pdbg['exports_outstanding']}; every "
            f"chain bitwise reference_decode")
        check(dbg["role"] == "decode" and pdbg["role"] == "prefill",
              "pool roles")
        check(dbg["kv_chains_imported"] == len(reqs),
              f"decode replica imported {dbg['kv_chains_imported']} chains")
        check(dbg["used"] + dbg["available"] == dbg["kv_blocks_total"]
              == 128, f"decode replica's kv_debug: {dbg}")
        check(pdbg["exports_outstanding"] == 0, f"exports left: {pdbg}")
        check(pdbg["chain"]["inline_fallbacks"] < len(reqs)
              and pdbg["kv_chain_bytes_streamed"] > 0,
              "no chain crossed the node store")
        check(after["pid"] != os.getpid() and after["cvd"] == card
              and after["device"] == "cuda",
              f"the decode replica is not in a worker granted the card: "
              f"{after}")
        check(pre_probe["pid"] not in (os.getpid(), after["pid"])
              and pre_probe["device"] == "cpu",
              f"the prefill replica: {pre_probe}")
        check(after["launches"] > 0, "K4 never launched in the decode "
              "replica")
        log(f"disaggregated runtime serve on {smi}: deploy (two workers "
            f"spawned + replicas started) {deploy_s} s (serve.run of the "
            f"prefill pool {run_s[0]} s, of the decode pool {run_s[1]} s, "
            f"then both replicas' first answers); first request's "
            f"latency {lat[0]} s (min {min(lat)}, max {max(lat)}); 16 "
            f"requests, {sum(len(o) for o in out)} tokens, wall {wall} s; "
            f"_timing TTFT of request 0 {ttft} s")
        return after["launches"]
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


TRAINER_STEPS = 4


def leaf_digest(t):
    """sha256 of a CPU tensor's bytes (bf16 by its 16-bit pattern)."""
    import hashlib

    import torch

    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def process_start():
    """When this process started, on ``time.time()``'s clock, to about 10
    ms (Linux: its start in clock ticks since boot, and the uptime)."""
    import os

    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))


def flagship_training(torch, dev):
    """Phase 11's training of the flagship on ``dev``: a function that
    builds its state from seed 0 (AdamW, lr 1e-3, warmup 2, 100 decay
    steps), the 4 x 513 token batch from seed 1, and the step."""
    from ray_tpu_torch.entry import _flagship_cfg
    from ray_tpu_torch.train import (
        default_optimizer, init_train_state, make_train_step)

    cfg = _flagship_cfg()
    opt = default_optimizer(lr=1e-3, warmup=2, decay_steps=100)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (4, 513), dtype=torch.int64, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))}
    return (lambda: init_train_state(
        cfg, opt, torch.Generator(device=dev).manual_seed(0), dev),
        batch, make_train_step(cfg, opt))


def trainer_loop(config):
    """Runs in the trainer's worker: phase 8's flagship state and batch,
    ``TRAINER_STEPS`` steps of the port's train step, each reported; the
    last report carries the params' checkpoint and a digest of each
    leaf.  Counts K1-K3 launches in this process and profiles the first
    step (or the next, if a profile records no device time).

    Phase 21's keys: with ``ckpt_at`` the report of that step carries the
    whole state (the f32 params, both AdamW moments, the step count) and
    no step is profiled or closes with the params' checkpoint; a first
    attempt (no checkpoint to start from) then writes its pid, the
    checkpoint's bytes, the report's seconds and the time of its death to
    the file ``hold`` and kills itself with SIGKILL.  An attempt that
    starts from a checkpoint restores that state and runs the steps after
    it."""
    import json as _json
    import os
    import signal
    import time as _time

    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import ray_tpu_torch
    from ray_tpu_torch.air import Checkpoint, session
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.train.core import TrainState, tree_leaves, tree_map

    t_start = _time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    ckpt_at = config.get("ckpt_at")
    start = session.get_checkpoint()
    restored = None
    fresh, batch, step = flagship_training(torch, dev)
    if start is None:
        state = fresh()
    else:
        t0 = _time.perf_counter()
        d = start.to_dict()
        state = TrainState(
            step=d["step"], params=tree_map(lambda t: t.to(dev), d["params"]),
            opt_state={"count": d["count"],
                       "mu": tree_map(lambda t: t.to(dev), d["mu"]),
                       "nu": tree_map(lambda t: t.to(dev), d["nu"])})
        torch.cuda.synchronize()
        restored = {"step": d["step"], "writer_pid": d["pid"],
                    "restore_s": _time.perf_counter() - t0}
        del d
    keys = FLASH + K5
    names = ("flash_fwd_kernel", "flash_dkdv_kernel", "flash_dq_kernel")
    profiled = None if ckpt_at is None else False
    _build.reset_launches()                       # the trainer's path starts
    for i in range(state.step, config["steps"]):
        torch.cuda.synchronize()
        t0 = _time.perf_counter()
        prof_s = 0.0
        if profiled is None:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, m = step(state, batch)
                torch.cuda.synchronize()
                step_s = _time.perf_counter() - t0
            recs = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            prof_s = _time.perf_counter() - t0 - step_s
            if recs:
                profiled = {"step": i + 1, "busy_ms": sum(
                    e.self_device_time_total for e in recs) / 1e3}
                for n in names + ("nccl",):
                    hit = [e for e in recs if n in e.key.lower()]
                    profiled[n] = {
                        "count": sum(e.count for e in hit),
                        "ms": sum(e.self_device_time_total
                                  for e in hit) / 1e3}
        else:
            state, m = step(state, batch)
            torch.cuda.synchronize()
            step_s = _time.perf_counter() - t0
        report = {"step": i + 1, "loss": float(m["loss"]),
                  "grad_norm": float(m["grad_norm"]), "step_s": step_s,
                  "profile_s": prof_s, "pid": os.getpid(),
                  "cvd": os.environ.get("CUDA_VISIBLE_DEVICES"),
                  "backend": dist.get_backend(),
                  "world": dist.get_world_size(),
                  "launches": {k: _build.launches[k] for k in keys},
                  "loop_start": t_start, "t_report": _time.time(),
                  "node": ray_tpu_torch.get_runtime_context().node_id,
                  "device_name": torch.cuda.get_device_name(0),
                  "restored": restored, "process_start": process_start()}
        ckpt = None
        if i + 1 == ckpt_at:
            t0 = _time.perf_counter()
            tree = tree_map(lambda t: t.detach().cpu(), {
                "params": state.params, "mu": state.opt_state["mu"],
                "nu": state.opt_state["nu"]})
            ckpt = Checkpoint.from_dict({
                "step": state.step, "count": state.opt_state["count"],
                "pid": os.getpid(), **tree})
            nbytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(tree))
            session.report(report, checkpoint=ckpt)
            report_s = _time.perf_counter() - t0
            if start is None:
                # The report has returned: the checkpoint has landed.
                with open(config["hold"] + ".tmp", "w") as f:
                    _json.dump({"pid": os.getpid(), "report_s": report_s,
                                "nbytes": nbytes, "t_kill": _time.time()},
                               f)
                os.replace(config["hold"] + ".tmp", config["hold"])
                os.kill(os.getpid(), signal.SIGKILL)
            continue
        # The trainer's path ends with the last step's report.
        if i + 1 == config["steps"] and ckpt_at is None:
            # The params, and the bf16 head weights the forward multiplies
            # by, as CPU tensors.
            tree = {"params": tree_map(lambda t: t.detach().cpu(),
                                       state.params)}
            tree["lm_head_bf16"] = tree["params"]["lm_head"].to(
                torch.bfloat16)
            report["digests"] = tree_map(leaf_digest, tree)
            report["profiled"] = profiled
            ckpt = Checkpoint.from_dict({"step": i + 1, **tree})
        session.report(report, checkpoint=ckpt)


def trainer_phase(torch, smi, loss0_phase8):
    """Main path 6: the data-parallel trainer through the port's runtime:
    one worker granted the card, ``TorchConfig()`` (an NCCL group of
    world size 1), the flagship at full width for ``TRAINER_STEPS``
    steps."""
    import os
    import statistics

    import ray_tpu_torch
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.entry import _flagship_cfg
    from ray_tpu_torch.train import DataParallelTrainer, TorchConfig
    from ray_tpu_torch.train.core import tree_leaves, tree_map

    card = first_visible_card()
    L = _flagship_cfg().num_layers
    torch.cuda.empty_cache()
    ray_tpu_torch.init(num_cpus=4)
    try:
        trainer = DataParallelTrainer(
            trainer_loop, train_loop_config={"steps": TRAINER_STEPS},
            backend_config=TorchConfig(),
            scaling_config=ScalingConfig(num_workers=1,
                                         tpu_chips_per_worker=1))
        t_fit = time.time()
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
    finally:
        ray_tpu_torch.shutdown()
    check(result.error is None, f"fit() failed: {result.error!r}")
    hist = result.metrics_history
    check(len(hist) == TRAINER_STEPS, f"{len(hist)} reports")
    last = hist[-1]
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["step_s"] for h in hist[1:]) * 1e3
    launches = last["launches"]
    k5_path("trainer", launches, TRAINER_STEPS)
    prof = last["profiled"]
    got = result.checkpoint.to_dict()
    digests = tree_map(leaf_digest, {k: got[k] for k in ("params",
                                                          "lm_head_bf16")})
    log(f"trainer worker pid {last['pid']} (driver {os.getpid()}), "
        f"CUDA_VISIBLE_DEVICES={last['cvd']!r}, process group "
        f"{last['backend']} world size {last['world']}; losses {losses} "
        f"(phase 8's first {loss0_phase8}); K1/K2/K3 launches "
        f"{[launches[k] for k in FLASH]} "
        f"in {TRAINER_STEPS} steps; profile of step {prof and prof['step']}"
        f": {prof}")
    leaves = tree_leaves({k: got[k] for k in ("params", "lm_head_bf16")})
    log(f"trainer checkpoint: {len(leaves)} leaves "
        f"({sorted({str(t.dtype) for t in leaves})}, "
        f"{sum(t.numel() * t.element_size() for t in leaves)} B), every "
        f"leaf's digest equal to the worker's: {digests == last['digests']}")
    check(last["pid"] != os.getpid() and last["cvd"] == card,
          f"the trainer worker is not granted the card: {last}")
    check(last["backend"] == "nccl" and last["world"] == 1,
          f"process group {last['backend']} world {last['world']}")
    check(abs(losses[0] - loss0_phase8) <= 1e-3,
          f"first trainer loss {losses[0]} vs phase 8's {loss0_phase8}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          "the trainer's loss did not fall")
    want = [2 * L * TRAINER_STEPS, L * TRAINER_STEPS, L * TRAINER_STEPS]
    check([launches[k] for k in FLASH]
          == want, f"K1/K2/K3 launches in the worker {launches}, expected "
          f"{want}")
    check(prof is not None and [prof[n]["count"] for n in (
        "flash_fwd_kernel", "flash_dkdv_kernel", "flash_dq_kernel")]
        == [2 * L, L, L], f"the worker's profile: {prof}")
    check(got["step"] == TRAINER_STEPS and digests == last["digests"]
          and got["lm_head_bf16"].dtype == torch.bfloat16,
          "the checkpoint did not round-trip")
    log(f"trainer through the runtime on {smi}: {step_ms} ms per step "
        f"(median of steps 2-{TRAINER_STEPS}; all "
        f"{[h['step_s'] * 1e3 for h in hist]} ms, the profiler's own "
        f"{[h['profile_s'] * 1e3 for h in hist]} ms beside them), worker "
        f"start (fit() to the loop's first line: placement group, spawn, "
        f"torch, NCCL group) {last['loop_start'] - t_fit} s, fit() wall "
        f"{fit_s} s")
    return {**{k: launches[k] for k in FLASH}, "step_ms": step_ms,
            "losses": losses, "grad_norms": [h["grad_norm"] for h in hist]}


MOE_EXPERTS = 8          # Mixtral-8x7B's routing: 8 experts, top 2
MOE_STEPS = 8


def moe_flagship_cfg():
    """The flagship with 8 experts in every layer; the reference's MoE
    defaults (top 2, capacity factor 1.25, aux coefficient 0.01)."""
    from ray_tpu_torch.entry import _flagship_cfg

    return dataclasses.replace(_flagship_cfg(), num_experts=MOE_EXPERTS)


class RoutingProbe:
    """Wraps ``moe.route`` (the routing of both the local and the mesh
    path) for the ``with`` block and records, per call, the (token,
    choice) assignments kept under the capacity and the top-k experts.
    With ``replay`` (another probe's record of the same path), each call
    routes to the experts the other run chose, in the same order, with
    gate values from this run's probabilities.  It synchronises, so it
    stays out of timed and counted runs."""

    def __init__(self, torch, replay=None):
        self.torch, self.calls, self.replay = torch, [], replay

    def __enter__(self):
        from ray_tpu_torch.ops import moe

        self._orig = orig = moe.route

        def probe(logits, k, capacity):
            if self.replay is None:
                out = orig(logits, k, capacity)
            else:
                idx = self.replay.calls[len(self.calls)][2]
                probs = self.torch.softmax(logits.float(), dim=-1)
                out = moe.assign(probs, probs.gather(-1, idx), idx,
                                 capacity)
            self.calls.append((float(out.keep.sum()), logits.shape[0] * k,
                               out.experts.detach()))
            return out

        moe.route = probe
        return self

    def __exit__(self, *exc):
        from ray_tpu_torch.ops import moe

        moe.route = self._orig

    def dropped_share(self):
        return 1.0 - sum(c[0] for c in self.calls) / sum(
            c[1] for c in self.calls)

    def choices_differ(self, other):
        """The share of (token, choice) experts of these calls absent
        from the same token's top-k in ``other``'s calls."""
        check(len(self.calls) == len(other.calls), "routing calls differ")
        miss = n = 0
        for (_, _, a), (_, _, b) in zip(self.calls, other.calls):
            hit = (a.unsqueeze(-1) == b.unsqueeze(-2)).any(-1)
            miss += int((~hit).sum())
            n += hit.numel()
        return miss / n


def moe_phase(torch, dev, n=MOE_STEPS):
    """Main path 7: the MoE flagship, no mesh: its forward at 4 x 512 and
    its train step at 4 x 513 (K1 in the forward, K1-K3 in the step)."""
    from ray_tpu_torch.models import forward, loss_fn
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.train import (
        default_optimizer, init_train_state, loss_and_grads, make_train_step)
    from ray_tpu_torch.train.core import global_norm, tree_leaves

    cfg = moe_flagship_cfg()
    cfg_ref = dataclasses.replace(cfg, attn_impl="reference")
    L = cfg.num_layers
    opt = default_optimizer(lr=1e-3, warmup=2, decay_steps=100)
    state = init_train_state(cfg, opt, torch.Generator(device=dev)
                             .manual_seed(0), dev)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 513),
                                     dtype=torch.int64, device=dev,
                                     generator=gen)}
    tokens = batch["tokens"][:, :-1]
    params = state.params

    # The forward at 4 x 512.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()                       # main path 7a starts
    with torch.no_grad():
        logits, aux = forward(params, tokens, cfg)
        torch.cuda.synchronize()
        first = _build.launches["rtt_flash_fwd_bf16"]
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            forward(params, tokens, cfg)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
    fwd_launches = _build.launches["rtt_flash_fwd_bf16"]   # main path 7a ends
    k6_path("moe_forward", _build.launches, L * (reps + 1))
    peak = torch.cuda.max_memory_allocated()
    check(first == L, f"K1 launched {first} times in one MoE forward, "
          f"expected {L}")
    check(fwd_launches == L * (reps + 1), "K1 launches per MoE forward")
    check(tuple(logits.shape) == (4, 512, cfg.vocab_size)
          and logits.dtype == torch.float32, "MoE logits shape")
    check(bool(torch.isfinite(logits).all()) and math.isfinite(float(aux)),
          "non-finite MoE logits or aux loss")
    with torch.no_grad(), RoutingProbe(torch) as probe:
        loss_k1, m_k1 = loss_fn(params, {"tokens": batch["tokens"]}, cfg)
        loss_ref, _ = loss_fn(params, {"tokens": batch["tokens"]}, cfg_ref)
    d_loss = abs(float(loss_k1) - float(loss_ref))
    log(f"MoE flagship ({n_params} params: {L} layers, {MOE_EXPERTS} "
        f"experts top-{cfg.num_selected}, capacity factor "
        f"{cfg.capacity_factor}, 4 x 512, bf16) forward: {dt * 1e3} ms per "
        f"forward, {4 * 512 / dt} tokens/s, peak memory {peak} B, K1 "
        f"launches {fwd_launches} ({first} per forward); aux loss "
        f"{float(aux)}; (token, choice) assignments dropped over capacity: "
        f"{probe.dropped_share()} (K1 path, {len(probe.calls) // 2} "
        f"layers)")
    log(f"MoE flagship loss: K1 path {float(loss_k1)}, plain-attention "
        f"path {float(loss_ref)}, |diff| {d_loss} (<=2e-2); aux "
        f"{float(m_k1['aux_loss'])}")
    check(math.isfinite(float(loss_k1)) and d_loss <= 2e-2,
          "MoE flash and reference losses disagree")
    with torch.no_grad():
        busy = profile_run(torch, lambda: forward(params, tokens, cfg),
                           "MoE forward", top=12)
    fwd = kernels_in_path(busy, {"flash_fwd_kernel": L}, "moe_forward")

    # Grads of the K1-K3 step against the plain-attention step, each
    # routing for itself: a token whose 2nd and 3rd router probabilities
    # are within bf16 noise may flip experts, which moves its whole
    # contribution between expert slices.  So the kernels are held to
    # phase 8's limits against the plain-attention step that replays the
    # K1 step's expert choices, and the free comparison is logged.
    def compare(g_ref, what):
        norm_ref = float(global_norm(tree_leaves(g_ref)))
        rel = [float((a - r).norm() / r.norm())
               for a, r in zip(tree_leaves(g), tree_leaves(g_ref))]
        log(f"MoE flagship grads, K1-K3 step vs plain-attention step "
            f"({what}): grad_norm {norm} vs {norm_ref} (relative "
            f"{abs(norm - norm_ref) / norm_ref}, <= 2e-2); per-leaf "
            f"relative L2 error max {max(rel)}, all {rel}")
        check(abs(norm - norm_ref) <= 2e-2 * norm_ref,
              f"MoE grad_norm disagrees ({what})")
        return max(rel)

    with RoutingProbe(torch) as r_k1:
        _, _, g = loss_and_grads(params, batch, cfg)
    norm = float(global_norm(tree_leaves(g)))
    with RoutingProbe(torch) as r_ref:
        _, _, g_ref = loss_and_grads(params, batch, cfg_ref)
    compare(g_ref, "each routing for itself")
    log(f"top-{cfg.num_selected} choices that differ between the two "
        f"paths: {r_k1.choices_differ(r_ref)}; dropped "
        f"{r_k1.dropped_share()} vs {r_ref.dropped_share()}")
    del g_ref
    with RoutingProbe(torch, replay=r_k1) as r_same:
        _, _, g_ref = loss_and_grads(params, batch, cfg_ref)
    check(r_same.dropped_share() == r_k1.dropped_share(),
          "the replayed routing dropped other assignments")
    worst = compare(g_ref, "the K1 step's routing replayed")
    check(worst <= 5e-2, "a leaf's MoE grads disagree on the same routing")
    del g, g_ref
    with torch.no_grad():
        loss0 = loss_fn(params, batch, cfg)[1]["loss"]

    # The train step at 4 x 513.
    step = make_train_step(cfg, opt)
    keys = FLASH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()                       # main path 7b starts
    state, m0 = step(state, batch)
    first = [_build.launches[k] for k in keys]
    metrics = [m0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    dt_step = (time.perf_counter() - t0) / n
    launches = [_build.launches[k] for k in keys]  # main path 7b ends
    k5_path("moe_step", _build.launches, n + 1)
    k6_path("moe_step", _build.launches, (3 if cfg.remat else 2) * L
            * (n + 1))
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    log(f"MoE flagship train step (4 x 512 tokens, remat, bf16): "
        f"{dt_step * 1e3} ms per step, {4 * 512 / dt_step} tokens/s, peak "
        f"memory {peak} B; launches K1/K2/K3 {launches} in {n + 1} steps "
        f"({first} in the first)")
    log(f"MoE train losses {losses}; aux losses "
        f"{[float(m['aux_loss']) for m in metrics]}; first step's loss "
        f"{losses[0]} vs loss_fn's under no_grad {float(loss0)} (<= 1e-3); "
        f"its grad_norm {float(m0['grad_norm'])}")
    check(first == [2 * L, L, L], f"K1/K2/K3 launched {first} times in one "
          f"MoE step, expected {[2 * L, L, L]}")
    check(launches == [x * (n + 1) for x in first], "MoE launches per step")
    check(abs(losses[0] - float(loss0)) <= 1e-3, "MoE step loss != loss_fn")
    check(all(math.isfinite(x) for x in losses), "non-finite MoE loss")
    check(losses[-1] < losses[0], "the MoE loss did not fall")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(
        state.params)), "non-finite MoE params")
    busy = profile_run(torch, lambda: step(state, batch), "MoE step", top=12)
    in_step = kernels_in_path(
        busy, {"flash_fwd_kernel": 2 * L, "flash_dkdv_kernel": L,
               "flash_dq_kernel": L}, "moe_step")
    del state
    return {"forward": fwd_launches, "step": dict(zip(keys, launches)),
            "fwd_profile": fwd, "step_profile": in_step,
            "loss_forward": float(loss_k1), "loss0": losses[0],
            "grad_norm0": float(m0["grad_norm"]), "step_ms": dt_step * 1e3}


def mesh_phase(torch, dev, moe, steps=3):
    """Main path 8: the MoE flagship on a mesh: a process group of world
    size 1 in this process (NCCL on the card), ``make_mesh`` and the
    sharded state, forward and train step, held against phase 12."""
    import socket
    import statistics

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import loss_fn
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.train import (
        default_optimizer, init_train_state, make_train_step)
    from ray_tpu_torch.train.core import tree_leaves

    cfg = moe_flagship_cfg()
    L = cfg.num_layers
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(MeshConfig(), dev.type)
        opt = default_optimizer(lr=1e-3, warmup=2, decay_steps=100)
        state = init_train_state(cfg, opt, torch.Generator(device=dev)
                                 .manual_seed(0), mesh=mesh)
        check(all(isinstance(p, DTensor) for p in tree_leaves(state.params))
              and all(isinstance(m, DTensor) for m in tree_leaves(
                  state.opt_state["mu"])), "the sharded state is not DTensor")
        gen = torch.Generator(device=dev).manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 513),
                                         dtype=torch.int64, device=dev,
                                         generator=gen)}
        torch.cuda.synchronize()
        _build.reset_launches()                   # main path 8a starts
        with torch.no_grad():
            loss, _ = loss_fn(state.params, batch, cfg, mesh=mesh)
        torch.cuda.synchronize()
        # main path 8a ends
        fwd_launches = _build.launches["rtt_flash_fwd_bf16"]
        d = abs(float(loss) - moe["loss_forward"])
        log(f"mesh {mesh} ({backend}, world size 1): MoE loss {float(loss)} "
            f"vs phase 12's {moe['loss_forward']}, |diff| {d} (<= 1e-3), "
            f"bitwise {float(loss) == moe['loss_forward']}; K1 launches "
            f"{fwd_launches} in the manual region")
        check(d <= 1e-3, "the mesh loss differs from phase 12's")
        check(fwd_launches == L, f"K1 launched {fwd_launches} times under "
              f"the mesh, expected {L}")
        step = make_train_step(cfg, opt, mesh=mesh)
        keys = FLASH
        torch.cuda.synchronize()
        _build.reset_launches()                   # main path 8b starts
        times, metrics = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
        launches = [_build.launches[k] for k in keys]  # main path 8b ends
        k5_path("mesh_step", _build.launches, steps, norms=0)
        m0 = metrics[0]
        rel = abs(float(m0["grad_norm"]) - moe["grad_norm0"]) / \
            moe["grad_norm0"]
        ms = statistics.median(times[1:])
        log(f"mesh train step: first loss {float(m0['loss'])} vs phase 12's "
            f"{moe['loss0']} (<= 1e-3), grad_norm {float(m0['grad_norm'])} "
            f"vs {moe['grad_norm0']} (relative {rel}, <= 2e-2); losses "
            f"{[float(x['loss']) for x in metrics]}; K1/K2/K3 launches "
            f"{launches} in {steps} steps; {ms} ms per step (median of "
            f"steps 2-{steps}; all {times}) against phase 12's "
            f"{moe['step_ms']} ms without a mesh")
        check(abs(float(m0["loss"]) - moe["loss0"]) <= 1e-3,
              "the mesh step's loss differs from phase 12's")
        check(rel <= 2e-2, "the mesh step's grad_norm differs")
        check(launches == [2 * L * steps, L * steps, L * steps],
              f"K1/K2/K3 launched {launches} times in {steps} mesh steps")
        del state
        return {"forward": fwd_launches, "step_ms": ms,
                **dict(zip(keys, launches))}
    finally:
        dist.destroy_process_group()


def sp_pp_phase(torch, dev, dense, mesh_step_ms, steps=3):
    """Main path 9: sequence and pipeline parallelism, the dense flagship
    of phase 8 on a mesh over a process group of world size 1 in this
    process (NCCL on the card): Ulysses attention (K1 per head group),
    ring attention (plain torch, as the reference's XLA path), and the
    GPipe pipeline (the one-stage shortcut at pp=1), each forward and
    train step held against phase 8.  Returns {path: [K1, K2, K3]
    launches in it} and, under "step_ms", {path: ms per step}."""
    import socket
    import statistics

    import torch.distributed as dist

    from ray_tpu_torch.entry import _flagship_cfg
    from ray_tpu_torch.models import forward, loss_fn
    from ray_tpu_torch.models.llama import forward_pipelined
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.train import (
        default_optimizer, init_train_state, make_train_step)

    base = _flagship_cfg()
    L, M = base.num_layers, 4
    keys = FLASH
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(MeshConfig(), dev.type)
        opt = default_optimizer(lr=1e-3, warmup=2, decay_steps=100)

        def fresh_state():
            return init_train_state(base, opt, torch.Generator(device=dev)
                                    .manual_seed(0), mesh=mesh)

        gen = torch.Generator(device=dev).manual_seed(1)
        batch = {"tokens": torch.randint(0, base.vocab_size, (4, 513),
                                         dtype=torch.int64, device=dev,
                                         generator=gen)}
        params = fresh_state().params
        out = {"step_ms": {}}

        def forward_path(name, cfg, forward_fn=None, n=3):
            """The loss under no_grad once with the launches counted, then
            ``n`` timed: (loss, launches, ms per forward)."""
            def run():
                return loss_fn(params, batch, cfg, mesh=mesh,
                               forward_fn=forward_fn)[0]

            with torch.no_grad():
                torch.cuda.synchronize()
                _build.reset_launches()           # the forward starts
                loss = float(run())
                torch.cuda.synchronize()
                out[name] = [_build.launches[k] for k in keys]
                t0 = time.perf_counter()
                for _ in range(n):
                    run()
                torch.cuda.synchronize()
            return loss, out[name][0], (time.perf_counter() - t0) / n * 1e3

        def step_path(name, cfg, **kw):
            """``steps`` train steps from a fresh state, launches counted:
            (first metrics, losses, ms per step, the step)."""
            state = fresh_state()
            step = make_train_step(cfg, opt, mesh=mesh, **kw)
            torch.cuda.synchronize()
            _build.reset_launches()               # the steps start
            times, metrics = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                metrics.append(m)
            out[name] = [_build.launches[k] for k in keys]
            k5_path(name, _build.launches, steps, norms=0)
            m0 = metrics[0]
            rel = abs(float(m0["grad_norm"]) - dense["grad_norm0"]) / \
                dense["grad_norm0"]
            ms = statistics.median(times[1:])
            out["step_ms"][name] = ms
            log(f"{name}: first loss {float(m0['loss'])} vs phase 8's "
                f"{dense['loss0']} (<= 1e-3, bitwise "
                f"{float(m0['loss']) == dense['loss0']}), grad_norm "
                f"{float(m0['grad_norm'])} vs {dense['grad_norm0']} "
                f"(relative {rel}, <= 2e-2); losses "
                f"{[float(x['loss']) for x in metrics]}; K1/K2/K3 launches "
                f"{out[name]} in {steps} steps; {ms} ms per step (median of "
                f"steps 2-{steps}; all {times}) against phase 8's "
                f"{dense['step_ms']} (no mesh) and phase 13's {mesh_step_ms} "
                f"(MoE on the mesh)")
            check(abs(float(m0["loss"]) - dense["loss0"]) <= 1e-3,
                  f"{name}: the first loss differs from phase 8's")
            check(rel <= 2e-2, f"{name}: grad_norm differs from phase 8's")
            check(out[name] == [2 * L * steps, L * steps, L * steps],
                  f"{name}: K1/K2/K3 launched {out[name]} times in {steps} "
                  f"steps")
            check(all(math.isfinite(float(x["loss"])) for x in metrics),
                  f"{name}: a non-finite loss")
            return lambda: step(state, batch)

        def log_forward(name, loss, ref, what_ref, k1, ms):
            d = abs(loss - ref)
            log(f"{name} forward ({mesh}, {backend}, world size 1): loss "
                f"{loss} vs {what_ref} {ref}, |diff| {d} (<= 1e-3), bitwise "
                f"{loss == ref}; K1 launches {k1}; {ms} ms per forward "
                f"against phase 6's {dense['forward_ms']} (no mesh, logits "
                f"only)")
            check(d <= 1e-3, f"{name}: the loss differs from {what_ref}")

        # (a) Ulysses: K1 per head group (the all-to-alls are the identity
        # at sp=1).
        cfg_u = dataclasses.replace(base, attn_impl="ulysses")
        loss, k1, ms = forward_path("ulysses_forward", cfg_u)
        log_forward("ulysses", loss, dense["loss0"], "phase 8's first loss",
                    k1, ms)
        check(k1 == L, f"ulysses: K1 launched {k1} times, expected {L}")
        step_u = step_path("ulysses_step", cfg_u)
        with torch.no_grad():
            profile_run(torch, lambda: loss_fn(params, batch, cfg_u,
                                               mesh=mesh), "ulysses forward")
        profile_run(torch, step_u, "ulysses step", top=12)
        del step_u
        # (b) ring: the reference's XLA path in plain torch, no kernel.
        cfg_r = dataclasses.replace(base, attn_impl="ring")
        loss, k1, ms = forward_path("ring_forward", cfg_r)
        log_forward("ring (plain torch, the reference's XLA path)", loss,
                    dense["loss0"], "phase 8's first loss", k1, ms)
        check(k1 == 0, f"ring: K1 launched {k1} times, expected 0")
        with torch.no_grad():
            profile_run(torch, lambda: loss_fn(params, batch, cfg_r,
                                               mesh=mesh), "ring forward")
        # (c) the pipeline with flash attention (pp=1: the one-stage
        # shortcut runs the same layers as the mesh forward).
        inputs = batch["tokens"][:, :-1]
        with torch.no_grad():
            mesh_loss = float(loss_fn(params, batch, base, mesh=mesh)[0])
            want = forward(params, inputs, base, mesh=mesh)[0].full_tensor()
            got = forward_pipelined(params, inputs, base, mesh=mesh,
                                    num_microbatches=M)[0].full_tensor()
        check(tuple(got.shape) == (4, 512, base.vocab_size)
              and bool(torch.isfinite(got).all()), "pipelined logits")
        log(f"pipelined logits bitwise the mesh forward's: "
            f"{bool(torch.equal(got, want))} (max |diff| "
            f"{float((got - want).abs().max())})")
        del want, got

        def pipelined(p, t):
            return forward_pipelined(p, t, base, mesh=mesh,
                                     num_microbatches=M)

        loss, k1, ms = forward_path("pipelined_forward", base, pipelined)
        log_forward(f"pipelined ({M} microbatches)", loss, mesh_loss,
                    "the mesh forward's loss", k1, ms)
        check(k1 == L, f"pipelined: K1 launched {k1} times, expected {L}")
        step_p = step_path("pipelined_step", base, pipelined=True,
                           num_microbatches=M)
        profile_run(torch, step_p, "pipelined step", top=12)
        del step_p, params
        return out
    finally:
        dist.destroy_process_group()


PIPE_M = 4               # microbatches of the actor pipeline (phase 15)
PIPE_STEPS = 4


def _toy_stage_fn(sp, x):
    """The reference's integer toy stage (``tests/test_pipeline_actors.py``):
    x through the stage's stacked (D, D) matrices."""
    for w in sp["w"].unbind(0):
        x = x @ w
    return x


def _toy_loss_fn(y, t):
    import torch

    return torch.sum(y - t) / y.numel()


def pipeline_actors_phase(torch, dev, dense, pipelined_ms):
    """Main path 10: the 1F1B pipeline trainer.  (a) On the card, the
    single-host path: phase 8's dense flagship and batch in 2 llama
    stages, 4 microbatches, phase 8's optimizer, ``PIPE_STEPS`` steps,
    held against phase 8.  (b) Through the port's runtime: the
    reference's integer toy in 2 CPU stage actors, one 1F1B and one
    fill/drain step bitwise the single-host step.  Returns the [K1, K2,
    K3] launches of (a)."""
    import statistics

    import ray_tpu_torch
    from ray_tpu_torch.entry import _flagship_cfg
    from ray_tpu_torch.models import (
        make_pipeline_loss_fn, make_pipeline_stage_fn, pipeline_stage_params)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.train import default_optimizer, init_train_state, sgd
    from ray_tpu_torch.train.pipeline_actors import PipelineTrainer

    cfg = _flagship_cfg()
    L, M = cfg.num_layers, PIPE_M
    keys = FLASH
    opt = default_optimizer(lr=1e-3, warmup=2, decay_steps=100)
    params = init_train_state(cfg, opt, torch.Generator(device=dev)
                              .manual_seed(0), dev).params
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 513), dtype=torch.int64,
                           device=dev, generator=gen)
    # The card is the default: the caller names nothing.
    trainer = PipelineTrainer(
        make_pipeline_stage_fn(cfg), make_pipeline_loss_fn(cfg),
        pipeline_stage_params(params, 2), optimizer=opt,
        num_microbatches=M, distributed=False,
        device=None if dev.type == "cuda" else dev)
    del params
    check(not trainer.distributed, "the single-host path was not taken")
    x, t = tokens[:, :-1], tokens[:, 1:]
    torch.cuda.synchronize()
    _build.reset_launches()                       # main path 10 starts
    times, metrics = [], []
    for _ in range(PIPE_STEPS):
        t0 = time.perf_counter()
        metrics.append(trainer.step(x, t))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = [_build.launches[k] for k in keys]  # main path 10 ends
    k5_path("pipeline_trainer_step", _build.launches, PIPE_STEPS)
    losses = [m["loss"] for m in metrics]
    rel = abs(metrics[0]["grad_norm"] - dense["grad_norm0"]) / \
        dense["grad_norm0"]
    ms = statistics.median(times[1:])
    per_step = [2 * L * M, L * M, L * M]
    log(f"pipeline trainer, single-host path (2 stages, {M} microbatches, "
        f"{dev}): first loss {losses[0]} vs phase 8's {dense['loss0']} "
        f"(<= 1e-3, bitwise {losses[0] == dense['loss0']}), grad_norm "
        f"{metrics[0]['grad_norm']} vs {dense['grad_norm0']} (relative "
        f"{rel}, <= 2e-2); losses {losses}; K1/K2/K3 launches {launches} in "
        f"{PIPE_STEPS} steps ({per_step} a step expected); {ms} ms per step "
        f"(median of steps 2-{PIPE_STEPS}; all {times}) against phase 8's "
        f"{dense['step_ms']} and phase 14's pipelined step {pipelined_ms}")
    check(abs(losses[0] - dense["loss0"]) <= 1e-3,
          "pipeline trainer: the first loss differs from phase 8's")
    check(rel <= 2e-2, "pipeline trainer: grad_norm differs from phase 8's")
    check(all(math.isfinite(v) for v in losses), "a non-finite loss")
    check(losses[-1] < losses[0], "pipeline trainer: the loss did not fall")
    check(launches == [n * PIPE_STEPS for n in per_step],
          f"pipeline trainer: K1/K2/K3 launched {launches} times in "
          f"{PIPE_STEPS} steps")
    profile_run(torch, lambda: trainer.step(x, t), "pipeline-trainer step",
                top=12)
    del trainer

    # (b) The object-plane data path: CPU stage actors, named by the caller.
    rng = np.random.default_rng(0)
    w = rng.integers(-2, 3, size=(4, 4, 4)).astype(np.float32)
    xi = rng.integers(-2, 3, size=(8, 4)).astype(np.float32)
    ti = rng.integers(-2, 3, size=(8, 4)).astype(np.float32)

    def toy(**kw):
        return PipelineTrainer(_toy_stage_fn, _toy_loss_fn,
                               [{"w": w[:2]}, {"w": w[2:]}],
                               optimizer=sgd(1.0), num_microbatches=M, **kw)

    local = toy(distributed=False, device="cpu")
    want = [local.step(xi, ti)["loss"] for _ in range(2)]
    want_params = local.get_stage_params()
    rt = ray_tpu_torch.init(num_cpus=4)
    try:
        cards = int(ray_tpu_torch.cluster_resources().get("TPU", 0))
        try:
            toy()
            raised = None
        except RuntimeError as e:
            raised = str(e)
        log(f"card-granted stage actors: the runtime counts {cards} card(s); "
            f"a card-bound 2-stage trainer raised: {raised!r} (stages on "
            f"cards need one card each: ROADMAP.md Queue 1 item 10)")
        check(cards >= 2 or raised is not None,
              "a card-bound trainer with too few cards did not raise")
        t0 = time.perf_counter()
        tr = toy(device="cpu")
        check(tr.distributed, "the actor path was not taken")
        start_s = time.perf_counter() - t0
        step_ms, got = [], []
        for schedule in ("1f1b", "fill_drain"):
            t0 = time.perf_counter()
            got.append(tr.step(xi, ti, schedule=schedule)["loss"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
        got_params = tr.get_stage_params()
        stats = tr.stage_stats()
        tr.shutdown()
        time.sleep(1.5)     # the workers' counter flush
        st = rt.transfer_stats()
        same = got == want and all(
            np.array_equal(a["w"], b["w"])
            for a, b in zip(got_params, want_params))
        log(f"pipeline trainer, 2 CPU stage actors: start {start_s} s; 1F1B "
            f"then fill/drain step {step_ms} ms; losses {got} vs the "
            f"single-host {want} (bitwise, params too: {same}); "
            f"microbatch_pushes {st['microbatch_pushes']} (>= {4 * M}), "
            f"stage_restarts {st['stage_restarts']}; stage stats {stats}")
        check(same, "the actor steps differ from the single-host steps")
        check(st["microbatch_pushes"] >= 4 * M, "too few microbatch pushes")
        check(st["stage_restarts"] == 0, "a stage restarted")
    finally:
        ray_tpu_torch.shutdown()
    return launches


class CartPole:
    """CartPole-v1 in numpy: gymnasium's ``classic_control/cartpole.py``
    dynamics (Euler), thresholds (12 degrees, 2.4) and reward, with the
    500-step truncation of its registration.  ``reset(seed=)`` seeds the
    start state's U(-0.05, 0.05) draw."""

    GRAVITY, MASSCART, MASSPOLE, LENGTH = 9.8, 1.0, 0.1, 0.5
    FORCE_MAG, TAU, MAX_STEPS = 10.0, 0.02, 500
    THETA_LIMIT, X_LIMIT = 12 * 2 * math.pi / 360, 2.4

    def __init__(self):
        import types

        self.observation_space = types.SimpleNamespace(shape=(4,))
        self.action_space = types.SimpleNamespace(n=2)
        self._rng = np.random.default_rng()
        self._state = None
        self._steps = 0

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=(4,))
        self._steps = 0
        return np.array(self._state, np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self._state
        total = self.MASSPOLE + self.MASSCART
        pml = self.MASSPOLE * self.LENGTH
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        cos, sin = math.cos(theta), math.sin(theta)
        temp = (force + pml * theta_dot ** 2 * sin) / total
        theta_acc = (self.GRAVITY * sin - cos * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * cos ** 2 / total))
        x_acc = temp - pml * theta_acc * cos / total
        x, x_dot = x + self.TAU * x_dot, x_dot + self.TAU * x_acc
        theta, theta_dot = (theta + self.TAU * theta_dot,
                            theta_dot + self.TAU * theta_acc)
        self._state = (x, x_dot, theta, theta_dot)
        self._steps += 1
        terminated = bool(abs(x) > self.X_LIMIT
                          or abs(theta) > self.THETA_LIMIT)
        truncated = self._steps >= self.MAX_STEPS
        return (np.array(self._state, np.float32), 1.0, terminated,
                truncated, {})


def rllib_phase(torch, dev):
    """Main path 11: rllib on the card.  PPO with the learner in an actor
    granted the card and CPU rollout workers learns CartPole; one update
    on the card against the same update on the CPU; IMPALA with its
    learner on the card behind the pinned H2D queue; APPO."""
    import statistics

    import ray_tpu_torch
    from ray_tpu_torch.rllib import (
        ActorCriticMLP, APPOConfig, ImpalaConfig, Learner, PPOConfig)
    from ray_tpu_torch.rllib.ppo import ppo_loss
    from ray_tpu_torch.rllib.sample_batch import (
        ACTIONS, ADVANTAGES, LOGP, OBS, VALUE_TARGETS, SampleBatch)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.rllib.vtrace import vtrace
    from ray_tpu_torch.train import adam

    card = None if dev.type == "cuda" else "cpu"
    # One update from fixed weights and a fixed batch, card against CPU.
    rng = np.random.default_rng(0)
    n = 256
    batch = SampleBatch({
        OBS: rng.normal(size=(n, 4)).astype(np.float32),
        ACTIONS: rng.integers(2, size=n).astype(np.int32),
        LOGP: (rng.normal(scale=0.1, size=n) - 0.7).astype(np.float32),
        ADVANTAGES: rng.normal(size=n).astype(np.float32),
        VALUE_TARGETS: rng.normal(size=n).astype(np.float32)})
    learners = [Learner(ActorCriticMLP(4, 2), ppo_loss,
                        optimizer=adam(3e-3, grad_clip=0.5), device=d)
                for d in (card, "cpu")]
    _build.reset_launches()                       # the updates start
    metrics = [lr.update(batch) for lr in learners]
    diff = max(float(np.abs(a - b).max()) for a, b in zip(
        *(_np_leaves(lr.get_weights()) for lr in learners)))
    t0 = time.perf_counter()
    for _ in range(20):
        learners[0].update(batch)
    update_ms = (time.perf_counter() - t0) / 20 * 1e3
    k5_path("rllib_learner_update", _build.launches, 21)
    log(f"rllib learner update ({n} rows) on {learners[0].device} vs cpu: "
        f"total_loss {metrics[0]['total_loss']} vs "
        f"{metrics[1]['total_loss']}, max |param diff| {diff} (<= 1e-4); "
        f"{update_ms} ms per update on the card (host clock, 20 updates)")
    check(diff <= 1e-4, "the learner update on the card differs from the "
          "CPU's")
    # V-trace on the card against the CPU on fixed arrays.
    T, B = 50, 4
    arrs = [rng.normal(scale=0.5, size=(T, B)) - 1.0,
            rng.normal(scale=0.5, size=(T, B)) - 1.0,
            rng.normal(size=(T, B)), rng.normal(size=(T, B)),
            rng.normal(size=(B,)), 0.99 * (rng.random((T, B)) > 0.1)]
    arrs = [torch.from_numpy(a.astype(np.float32)) for a in arrs]
    on_card = vtrace(*(a.to(dev) for a in arrs))
    on_cpu = vtrace(*arrs)
    vdiff = max(float((a.cpu() - b).abs().max())
                for a, b in zip(on_card, on_cpu))
    log(f"V-trace (T={T}, B={B}) on {dev} vs cpu: max |diff| {vdiff} "
        f"(<= 1e-5)")
    check(vdiff <= 1e-5, "V-trace on the card differs from the CPU's")

    ray_tpu_torch.init(num_cpus=6)
    try:
        # PPO: the reference test's settings, the learner granted the card.
        config = (PPOConfig()
                  .environment(CartPole)
                  .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                            rollout_fragment_length=256)
                  .training(lr=3e-3, num_sgd_iter=8, sgd_minibatch_size=256,
                            entropy_coeff=0.01)
                  .resources(remote_learner=True, learner_num_tpus=1,
                             learner_device=card))
        t0 = time.perf_counter()
        algo = config.build()
        build_s = time.perf_counter() - t0
        learner_dev = algo.learner_group.device()
        best, rewards, train_ms = 0.0, [], []
        for _ in range(12):
            t0 = time.perf_counter()
            result = algo.train()
            train_ms.append((time.perf_counter() - t0) * 1e3)
            rewards.append(result.get("episode_reward_mean", 0.0))
            best = max(best, rewards[-1])
            if best >= 120.0:
                break
        algo.stop()
        log(f"PPO on CartPole (numpy CartPole-v1), learner in an actor on "
            f"{learner_dev}, 2 CPU rollout workers x 2 envs: build "
            f"{build_s} s; episode_reward_mean {rewards} (best {best}, >= "
            f"120); ms per train() {train_ms} (median "
            f"{statistics.median(train_ms)}; 32 updates each)")
        check(learner_dev.startswith(dev.type), "the PPO learner is not on "
              "the card")
        check(best >= 120.0, f"PPO did not learn CartPole: best {best}")

        # IMPALA: learner in this process on the card, behind the H2D queue.
        algo = (ImpalaConfig().environment(CartPole)
                .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                          rollout_fragment_length=64)
                .training(lr=4e-3, entropy_coeff=0.01, num_aggregators=2,
                          max_batches_per_step=4)
                .resources(learner_device=card)).build()
        check(algo._h2d is not None, "IMPALA's H2D queue is off")
        losses, rewards, train_ms = [], [], []
        for _ in range(6):
            t0 = time.perf_counter()
            result = algo.train()
            train_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(result.get("total_loss", float("nan")))
            rewards.append(result.get("episode_reward_mean"))
        qs = algo._h2d.queue_stats()
        algo.stop()
        log(f"IMPALA (2 aggregators, impala_queue_depth 2, learner on "
            f"{dev}): losses {losses}; episode_reward_mean {rewards}; ms per "
            f"train() {train_ms}; queue_stats {qs}")
        check(all(math.isfinite(v) for v in losses), "IMPALA: a non-finite "
              "loss")
        check(qs["gets"] > 0, "IMPALA: the H2D queue delivered nothing")
        check(dev.type != "cuda" or qs["pinned_copies"] > 0,
              "IMPALA: no pinned copy reached the card")

        # APPO: IMPALA's pipeline, PPO's surrogate, a target network.
        algo = (APPOConfig().environment(CartPole)
                .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                          rollout_fragment_length=64)
                .training(lr=4e-3, max_batches_per_step=4)
                .resources(learner_device=card)).build()
        losses, rewards = [], []
        for _ in range(6):
            result = algo.train()
            losses.append(result.get("total_loss", float("nan")))
            rewards.append(result.get("episode_reward_mean"))
        syncs = algo.target_updates
        algo.stop()
        log(f"APPO (learner on {dev}): losses {losses}; episode_reward_mean "
            f"{rewards}; target-network syncs {syncs}")
        check(all(math.isfinite(v) for v in losses), "APPO: a non-finite "
              "loss")
        check(syncs >= 1, "APPO: the target network was never synced")
    finally:
        ray_tpu_torch.shutdown()


class Pendulum:
    """Pendulum-v1 in numpy: gymnasium's ``classic_control/pendulum.py``
    dynamics (g = 10, m = l = 1, dt = 0.05), limits (speed 8, torque 2),
    cost and start state, with the 200-step truncation of its
    registration."""

    MAX_SPEED, MAX_TORQUE, DT, G, M, L, MAX_STEPS = \
        8.0, 2.0, 0.05, 10.0, 1.0, 1.0, 200

    def __init__(self):
        import types

        self.observation_space = types.SimpleNamespace(shape=(3,))
        self.action_space = types.SimpleNamespace(
            shape=(1,), low=np.array([-2.0], np.float32),
            high=np.array([2.0], np.float32))
        self._rng = np.random.default_rng()
        self._state = None
        self._steps = 0

    def _obs(self):
        th, thdot = self._state
        return np.array([math.cos(th), math.sin(th), thdot], np.float32)

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-np.array([math.pi, 1.0]),
                                        np.array([math.pi, 1.0]))
        self._steps = 0
        return self._obs(), {}

    def step(self, action):
        th, thdot = self._state
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        norm_th = ((th + math.pi) % (2 * math.pi)) - math.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (3 * self.G / (2 * self.L) * math.sin(th)
                         + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        thdot = float(np.clip(thdot, -self.MAX_SPEED, self.MAX_SPEED))
        self._state = (th + thdot * self.DT, thdot)
        self._steps += 1
        return self._obs(), -cost, False, self._steps >= self.MAX_STEPS, {}


class TwoAgentMatch:
    """The reference test's cooperative two-agent env
    (``tests/test_rllib_ma_offline.py``): each agent sees a one-hot cue
    and must answer with the matching action, 8 steps an episode (16.0 at
    most, ~4 at random).  A ``MultiAgentEnv`` by its interface."""

    N, HORIZON = 4, 8
    agent_ids = ["a0", "a1"]

    def __init__(self):
        import types

        self.observation_space = types.SimpleNamespace(shape=(4,))
        self.action_space = types.SimpleNamespace(n=4)
        self._rng = np.random.default_rng(0)
        self._t = 0
        self._cues = {}

    def _obs(self):
        out = {}
        for a in self.agent_ids:
            cue = int(self._rng.integers(self.N))
            self._cues[a] = cue
            out[a] = np.eye(self.N, dtype=np.float32)[cue]
        return out

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, action_dict):
        self._t += 1
        rews = {a: float(action_dict[a] == self._cues[a])
                for a in self.agent_ids}
        done = self._t >= self.HORIZON
        terms = {a: done for a in self.agent_ids}
        terms["__all__"] = done
        return self._obs(), rews, terms, {"__all__": False}, {}


def logged_batches(path, n_batches=24, steps=64, good=0.8, seed=0):
    """The reference test's logged data (``_logged_batches``): the
    behavior policy answers the cue with probability ``good``, else
    uniformly, its action probabilities logged; 8-step episodes.  Written
    by the port's ``JsonWriter``."""
    from ray_tpu_torch.rllib import JsonWriter, SampleBatch
    from ray_tpu_torch.rllib.sample_batch import (
        ACTIONS, DONES, LOGP, NEXT_OBS, OBS, REWARDS)

    rng = np.random.default_rng(seed)
    w = JsonWriter(path)
    n = 4
    for _ in range(n_batches):
        cues = rng.integers(n, size=steps)
        greedy = rng.random(steps) < good
        acts = np.where(greedy, cues, rng.integers(n, size=steps))
        p = good * (acts == cues) + (1 - good) / n
        dones = np.zeros(steps, bool)
        dones[7::8] = True
        w.write(SampleBatch({
            OBS: np.eye(n, dtype=np.float32)[cues],
            ACTIONS: acts.astype(np.int32),
            REWARDS: (acts == cues).astype(np.float32), DONES: dones,
            LOGP: np.log(p).astype(np.float32),
            NEXT_OBS: np.eye(n, dtype=np.float32)[rng.integers(n,
                                                               size=steps)],
        }))
    w.close()
    return path


def _tree_diff(a, b):
    from ray_tpu_torch.train.pipeline_actors import to_numpy_tree

    return max(float(np.abs(x - y).max()) for x, y in zip(
        _np_leaves(to_numpy_tree(a)), _np_leaves(to_numpy_tree(b))))


def _host_ms(torch, fn, n=20):
    """Host ms per call of ``fn`` over ``n`` calls, ending in a
    synchronise (the update's whole cost as its caller sees it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def offpolicy_updates(torch, card, data_path):
    """Phase 17 (a): one update of DQN, SAC, CQL and BC on the card
    against the same update on the CPU, from the same weights and batch
    (and for SAC the same two normal draws): every param (and
    ``log_alpha``) within 1e-4; ms per update on the card."""
    from ray_tpu_torch.rllib import BCConfig, CQLConfig, DQNConfig, SACConfig
    from ray_tpu_torch.rllib.sample_batch import (
        ACTIONS, DONES, NEXT_OBS, OBS, REWARDS)
    from ray_tpu_torch.train.pipeline_actors import (
        to_device_tree, to_numpy_tree)

    rng = np.random.default_rng(0)
    n = 256
    out = {}

    def pair(config):
        algos = [config.copy().resources(learner_device=d).build()
                 for d in (card, "cpu")]
        return algos

    def on(dev, batch):
        return {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in batch.items()}

    # DQN: prioritized-replay weights, double-Q, the clip of 10.
    algos = pair(DQNConfig().environment(CartPole)
                 .rollouts(num_rollout_workers=0))
    algos[1].params = to_device_tree(to_numpy_tree(algos[0].params), "cpu")
    algos[1].target_params = to_device_tree(
        to_numpy_tree(algos[0].target_params), "cpu")
    batch = {OBS: rng.normal(size=(n, 4)).astype(np.float32),
             ACTIONS: rng.integers(2, size=n).astype(np.int32),
             REWARDS: np.ones(n, np.float32),
             NEXT_OBS: rng.normal(size=(n, 4)).astype(np.float32),
             DONES: rng.random(n) < 0.05,
             "weights": rng.uniform(0.3, 1.0, n).astype(np.float32)}
    (_, a0), (_, a1) = (a._update(on(a._dev, batch)) for a in algos)
    diff = _tree_diff(algos[0].params, algos[1].params)
    td = float((a0["td_errors"].cpu() - a1["td_errors"]).abs().max())
    out["dqn"] = _host_ms(torch, lambda: algos[0]._update(
        on(algos[0]._dev, batch)))
    log(f"DQN update ({n} rows) on {algos[0]._dev} vs cpu: max |param "
        f"diff| {diff}, max |td diff| {td} (<= 1e-4); {out['dqn']} ms per "
        f"update on the card (host clock, 20 updates)")
    check(diff <= 1e-4 and td <= 1e-4, "DQN: the update on the card "
          "differs from the CPU's")
    for a in algos:
        a.stop()

    # SAC: one whole update on the same two draws.
    algos = pair(SACConfig().environment(Pendulum)
                 .rollouts(num_rollout_workers=0))
    for k in ("pi_params", "q_params", "q_target", "log_alpha"):
        setattr(algos[1], k, to_device_tree(
            to_numpy_tree(getattr(algos[0], k)), "cpu"))
    batch = {OBS: rng.normal(size=(n, 3)).astype(np.float32),
             ACTIONS: rng.uniform(-2, 2, size=(n, 1)).astype(np.float32),
             REWARDS: rng.normal(size=n).astype(np.float32),
             NEXT_OBS: rng.normal(size=(n, 3)).astype(np.float32),
             DONES: np.zeros(n, np.float32)}
    eps = [rng.normal(size=(n, 1)).astype(np.float32) for _ in range(2)]
    metrics = [a._update(on(a._dev, batch),
                         *(torch.from_numpy(e).to(a._dev) for e in eps))
               for a in algos]
    diff = max(_tree_diff(getattr(algos[0], k), getattr(algos[1], k))
               for k in ("pi_params", "q_params", "q_target", "log_alpha"))
    out["sac"] = _host_ms(torch, lambda: algos[0]._update(
        on(algos[0]._dev, batch),
        *(torch.from_numpy(e).to(algos[0]._dev) for e in eps)))
    log(f"SAC update ({n} rows) on {algos[0]._dev} vs cpu: critic_loss "
        f"{float(metrics[0]['critic_loss'])} vs "
        f"{float(metrics[1]['critic_loss'])}, max |param diff| (pi, q, "
        f"target, log_alpha) {diff} (<= 1e-4); {out['sac']} ms per update "
        f"on the card (host clock, 20 updates)")
    check(diff <= 1e-4, "SAC: the update on the card differs from the "
          "CPU's")
    for a in algos:
        a.stop()

    # CQL and BC on a logged batch.
    algos = pair(CQLConfig().offline_data(input_path=data_path))
    algos[1].params = to_device_tree(to_numpy_tree(algos[0].params), "cpu")
    algos[1].target_params = to_device_tree(
        to_numpy_tree(algos[0].target_params), "cpu")
    batch = algos[0].reader.next()
    for a in algos:
        a._update(on(a._dev, batch))
    diff = _tree_diff(algos[0].params, algos[1].params)
    out["cql"] = _host_ms(torch, lambda: algos[0]._update(
        on(algos[0]._dev, batch)))
    log(f"CQL update ({len(batch)} rows) on {algos[0]._dev} vs cpu: max "
        f"|param diff| {diff} (<= 1e-4); {out['cql']} ms per update on the "
        f"card (host clock, 20 updates)")
    check(diff <= 1e-4, "CQL: the update on the card differs from the "
          "CPU's")
    algos = pair(BCConfig().offline_data(input_path=data_path))
    algos[1].learner.set_weights(algos[0].learner.get_weights())
    for a in algos:
        a.learner.update(batch)
    diff = _tree_diff(algos[0].learner.params, algos[1].learner.params)
    out["bc"] = _host_ms(torch, lambda: algos[0].learner.update(batch))
    log(f"BC update ({len(batch)} rows) on {algos[0].learner.device} vs "
        f"cpu: max |param diff| {diff} (<= 1e-4); {out['bc']} ms per "
        f"update on the card (host clock, 20 updates)")
    check(diff <= 1e-4, "BC: the update on the card differs from the CPU's")
    return out


def offpolicy_phase(torch, dev):
    """Main path 12: rllib's off-policy, offline and multi-agent half and
    tune on the card.  No TPU kernel lies on this path (the networks are
    small MLPs whose products the reference leaves to XLA, plain
    ``torch.matmul`` here), so the phase adds no launch count."""
    import statistics
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib import (
        BCConfig, CQLConfig, DQNConfig, PPO, PPOConfig, SACConfig)

    card = None if dev.type == "cuda" else "cpu"
    t_phase = time.perf_counter()
    ray_tpu_torch.init(num_cpus=6)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data = logged_batches(f"{tmp}/data.json")
            update_ms = offpolicy_updates(torch, card, data)

            # (d) BC and CQL from the logged data, learners on the card.
            algo = (BCConfig().offline_data(input_path=data,
                                            num_batches_per_step=12)
                    .training(lr=1e-2).resources(learner_device=card)
                    ).build()
            bc = [algo.train()["bc_loss"] for _ in range(10)]
            acts = algo.compute_actions(np.eye(4, dtype=np.float32))
            algo.stop()
            match = float((acts == np.arange(4)).mean())
            log(f"BC from logged data (learner on {dev}): bc_loss {bc} (last "
                f"< 0.9); compute_actions {acts.tolist()} match the cue on "
                f"{match} of obs (>= 0.75)")
            check(bc[-1] < 0.9, f"BC: bc_loss {bc[-1]}")
            check(match >= 0.75, f"BC: actions {acts}")
            algo = (CQLConfig().offline_data(input_path=data,
                                             num_batches_per_step=12)
                    .training(lr=1e-2, min_q_weight=1.0)
                    .resources(learner_device=card)).build()
            cql = [algo.train() for _ in range(12)]
            acts = algo.compute_actions(np.eye(4, dtype=np.float32))
            algo.stop()
            log(f"CQL from logged data (learner on {dev}): total_loss "
                f"{[r['total_loss'] for r in cql]}; compute_actions "
                f"{acts.tolist()}")
            check(all(math.isfinite(r[k]) for r in cql
                      for k in ("total_loss", "td_loss", "cql_loss")),
                  "CQL: a non-finite loss")

        # (b) DQN on CartPole: the reference slow test's settings.
        algo = (DQNConfig().environment(CartPole)
                .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                          rollout_fragment_length=64)
                .training(lr=1e-3, num_steps_sampled_before_learning=500,
                          epsilon_timesteps=4000,
                          target_network_update_freq=500)
                .resources(learner_device=card)).build()
        best, rewards, losses, epsilons, train_ms = 0.0, [], [], [], []
        for _ in range(30):
            t0 = time.perf_counter()
            result = algo.train()
            train_ms.append((time.perf_counter() - t0) * 1e3)
            rewards.append(result.get("episode_reward_mean", 0.0))
            epsilons.append(result["epsilon"])
            if "loss" in result:
                losses.append(result["loss"])
            best = max(best, rewards[-1])
            if best >= 100.0:
                break
        syncs = algo.target_syncs
        algo.stop()
        log(f"DQN on CartPole (numpy CartPole-v1), learner on {dev}, 2 CPU "
            f"rollout workers x 2 envs: episode_reward_mean {rewards} (best "
            f"{best}, >= 100, at train() {len(rewards)}); epsilon "
            f"{epsilons}; losses {losses}; target syncs {syncs}; ms per "
            f"train() {train_ms} (median {statistics.median(train_ms)})")
        check(best >= 100.0, f"DQN did not learn CartPole: best {best}")
        check(losses and all(math.isfinite(v) for v in losses),
              "DQN: no loss, or a non-finite one")
        check(epsilons[-1] < epsilons[0], "DQN: epsilon did not fall")
        check(syncs >= 1, "DQN: the target network was never synced")

        # (c) Two-policy PPO on TwoAgentMatch, learners on the card.
        algo = (PPOConfig().environment(TwoAgentMatch)
                .rollouts(num_rollout_workers=2, rollout_fragment_length=128)
                .training(lr=3e-3, num_sgd_iter=4, sgd_minibatch_size=64)
                .multi_agent(policies={"p0": None, "p1": None},
                             policy_mapping_fn=lambda aid: "p" + aid[-1])
                .resources(learner_device=card)).build()
        devices = {pid: str(lr.device) for pid, lr in algo.learners.items()}
        rewards, train_ms = [], []
        for _ in range(12):
            t0 = time.perf_counter()
            last = algo.train()
            train_ms.append((time.perf_counter() - t0) * 1e3)
            rewards.append(last.get("episode_reward_mean"))
        algo.stop()
        log(f"two-policy PPO on TwoAgentMatch, learners on {devices}: "
            f"episode_reward_mean {rewards} (last > 9.0); agent steps "
            f"{last['num_agent_steps_sampled']}, env steps "
            f"{last['num_env_steps_sampled']}; ms per train() {train_ms} "
            f"(median {statistics.median(train_ms)})")
        check(all(d.startswith(dev.type) for d in devices.values()),
              "two-policy PPO: a learner is not on the card")
        check((rewards[-1] or 0.0) > 9.0, f"two-policy PPO: {rewards[-1]}")
        check(last["num_agent_steps_sampled"]
              == 2 * last["num_env_steps_sampled"],
              "two-policy PPO: agent steps are not twice the env steps")

        # (e) SAC on Pendulum, learner on the card.
        algo = (SACConfig().environment(Pendulum)
                .rollouts(num_rollout_workers=1, rollout_fragment_length=200)
                .training(num_steps_sampled_before_learning=400,
                          warmup_uniform_steps=400)
                .resources(learner_device=card)).build()
        results, train_ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            results.append(algo.train())
            train_ms.append((time.perf_counter() - t0) * 1e3)
        algo.stop()
        learned = [r for r in results if "critic_loss" in r]
        log(f"SAC on Pendulum (numpy Pendulum-v1), learner on {dev}: "
            f"{len(learned)} train() calls past warm-up; critic_loss "
            f"{[r['critic_loss'] for r in learned]}; actor_loss "
            f"{[r['actor_loss'] for r in learned]}; alpha "
            f"{[r['alpha'] for r in learned]}; ms per train() {train_ms}")
        check(len(learned) >= 3, "SAC: fewer than 3 updates past warm-up")
        check(all(math.isfinite(r[k]) for r in learned
                  for k in ("critic_loss", "actor_loss", "alpha")),
              "SAC: a non-finite loss")
        check(learned[-1]["alpha"] != 1.0, "SAC: alpha did not move")

        # (f) Tune: PPO trials granted the card, one at a time.
        class DevicePPO(PPO):
            def step(self):
                return dict(super().step(),
                            learner_device=self.learner_group.device())

        t0 = time.perf_counter()
        grid = tune.run(
            DevicePPO,
            config={"env_maker": CartPole, "num_rollout_workers": 1,
                    "rollout_fragment_length": 64, "learner_device": card,
                    "lr": tune.grid_search([1e-3, 3e-3])},
            stop={"training_iteration": 2}, metric="num_env_steps_sampled",
            mode="max", max_concurrent_trials=1,
            resources_per_trial={"CPU": 1, "TPU": 1})
        tune_s = time.perf_counter() - t0
        trial_devs = [t.last_result.get("learner_device")
                      for t in grid.trials]
        log(f"tune.run(PPO) over a 2-point lr grid, 1 card a trial: "
            f"{len(grid)} trials, {grid.num_errors} errors, learner devices "
            f"{trial_devs}, iterations "
            f"{[t.last_result.get('training_iteration') for t in grid.trials]}"
            f"; wall {tune_s} s")
        check(len(grid) == 2 and grid.num_errors == 0,
              f"tune: {len(grid)} trials, {grid.num_errors} errors")
        check(all(d and d.startswith(dev.type) for d in trial_devs),
              f"tune: trial learners on {trial_devs}")
    finally:
        ray_tpu_torch.shutdown()
    log(f"phase 17 took {time.perf_counter() - t_phase} s; ms per update "
        f"on the card {update_ms}")



DATA_ROWS = 1024         # token rows of phase 18's data set, 513 tokens each
DATA_SEP = 13            # the token id the actor stage turns into ...
DATA_EOS = 2             # ... Llama's EOS id


def row_digests(rows):
    """A 64-bit digest of each row of a (n, 513) int64 array."""
    import hashlib

    return [int.from_bytes(hashlib.blake2b(
        np.ascontiguousarray(r).tobytes(), digest_size=8).digest(), "little")
        for r in rows]


def data_tokens(cfg):
    """Phase 18's source rows: ``DATA_ROWS`` x 513 int32 tokens in
    [0, vocab_size) from seed 0, Zipf-distributed as a text's tokens are
    (uniform tokens would leave the loss nothing to learn)."""
    z = np.random.default_rng(0).zipf(1.2, size=(DATA_ROWS, 513))
    return ((z - 1) % cfg.vocab_size).astype(np.int32)


def to_int64_tokens(batch):
    """Phase 18's task stage: (n, 513) int32 rows to the dict-of-numpy
    block ``{"tokens": (n, 513) int64}``."""
    return {"tokens": batch.astype(np.int64)}


class SepToEos:
    """Phase 18's actor stage: every ``DATA_SEP`` token becomes
    ``DATA_EOS`` (one instance per pool actor)."""

    def __init__(self):
        self.sep, self.eos = DATA_SEP, DATA_EOS

    def __call__(self, batch):
        t = batch["tokens"]
        return {"tokens": np.where(t == self.sep, self.eos, t)}


def data_trainer_loop(config):
    """Runs in the trainer's worker: the worker's shard of the Dataset,
    one epoch of ``iter_batches(batch_size=4)``, each batch pinned, copied
    to the card and put through phase 8's flagship state and train step;
    each step reported with its data wait, H2D and step ms and the digest
    of each row.  The first report carries the first batch, the last the
    K1-K3 launches of this process, its pid, ``CUDA_VISIBLE_DEVICES`` and
    the shard's stats."""
    import os
    import time as _time

    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.entry import _flagship_cfg
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.train import (
        default_optimizer, init_train_state, make_train_step)

    t_start = _time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    cfg = _flagship_cfg()
    opt = default_optimizer(lr=1e-3, warmup=2, decay_steps=100)
    state = init_train_state(cfg, opt, torch.Generator(device=dev)
                             .manual_seed(0), dev)
    step = make_train_step(cfg, opt)
    shard = config["__datasets__"]["train"][session.get_world_rank()]
    keys = FLASH + K5
    torch.cuda.synchronize()
    _build.reset_launches()                       # the data path starts
    batches = iter(shard.iter_batches(batch_size=4, batch_format="numpy",
                                      drop_last=True))
    t_loop = _time.perf_counter()
    i = 0
    while True:
        t0 = _time.perf_counter()
        batch = next(batches, None)
        t1 = _time.perf_counter()
        if batch is None:
            break
        tokens = torch.from_numpy(batch["tokens"]).pin_memory().to(
            dev, non_blocking=True)
        torch.cuda.synchronize()
        t2 = _time.perf_counter()
        state, m = step(state, {"tokens": tokens})
        loss = float(m["loss"])
        torch.cuda.synchronize()
        t3 = _time.perf_counter()
        i += 1
        report = {"step": i, "loss": loss, "wait_ms": (t1 - t0) * 1e3,
                  "h2d_ms": (t2 - t1) * 1e3, "step_ms": (t3 - t2) * 1e3,
                  "digests": row_digests(batch["tokens"])}
        if i == 1:
            report["batch"] = np.array(batch["tokens"])
            report["loop_start"] = t_start
        session.report(report)
    launches = {k: _build.launches[k] for k in keys}  # the data path ends
    session.report({"step": i, "end": True, "launches": launches,
                    "loop_s": t1 - t_loop, "pid": os.getpid(),
                    "cvd": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "stats": shard.stats()})


def data_trainer_phase(torch, smi, trainer_step_ms):
    """Main path 13: a ``ray_tpu_torch.data`` Dataset feeding the
    data-parallel trainer.  ``DATA_ROWS`` token rows through a task
    ``map_batches`` (int64 dict-of-numpy blocks), an actor-pool
    ``map_batches`` (``SepToEos``, 2 actors) and ``random_shuffle(seed=0)``;
    ``DataParallelTrainer(datasets={"train": ds})`` with one worker granted
    the card iterates its shard for one epoch of 4-row batches, each a
    flagship train step on the card.  Returns [K1, K2, K3] launches in the
    worker."""
    import os
    import statistics
    from collections import Counter

    import ray_tpu_torch
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.entry import _flagship_cfg
    from ray_tpu_torch.train import (
        DataParallelTrainer, TorchConfig, default_optimizer,
        init_train_state, make_train_step)

    card = first_visible_card()
    cfg = _flagship_cfg()
    L = cfg.num_layers
    rows = data_tokens(cfg)
    want = np.where(rows == DATA_SEP, DATA_EOS, rows).astype(np.int64)
    n_sep = int((rows == DATA_SEP).sum())
    check(n_sep > 0, "the data set holds no separator token to replace")
    steps = DATA_ROWS // 4
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4)
    try:
        t0 = time.perf_counter()
        ds = (rd.from_numpy(rows, parallelism=16)
              .map_batches(to_int64_tokens)
              .map_batches(SepToEos, compute="actors", concurrency=2)
              .random_shuffle(seed=0))
        plan_s = time.perf_counter() - t0
        driver_stats = ds.stats()
        trainer = DataParallelTrainer(
            data_trainer_loop, datasets={"train": ds},
            backend_config=TorchConfig(),
            scaling_config=ScalingConfig(num_workers=1,
                                         tpu_chips_per_worker=1))
        t_fit = time.time()
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
    finally:
        ray_tpu_torch.shutdown()
    check(result.error is None, f"fit() failed: {result.error!r}")
    hist = result.metrics_history
    last, hist = hist[-1], hist[:-1]
    check(last.get("end") and len(hist) == steps,
          f"{len(hist)} step reports, expected {steps}")
    losses = [h["loss"] for h in hist]
    launches = [last["launches"][k] for k in FLASH]
    k5_path("data_trainer", last["launches"], steps)
    seen = Counter(d for h in hist for d in h["digests"])
    # The driver's step on the first batch the worker reported, from phase
    # 8's seed-0 state, in this process on the card.
    dev = torch.device("cuda:0")
    opt = default_optimizer(lr=1e-3, warmup=2, decay_steps=100)
    state = init_train_state(cfg, opt, torch.Generator(device=dev)
                             .manual_seed(0), dev)
    first = hist[0]["batch"]
    _, m = make_train_step(cfg, opt)(
        state, {"tokens": torch.from_numpy(first).to(dev)})
    loss_driver = float(m["loss"])
    del state
    torch.cuda.empty_cache()
    wait = [h["wait_ms"] for h in hist]
    step_ms = statistics.median(h["step_ms"] for h in hist[1:])
    wait_share = sum(wait) / (last["loop_s"] * 1e3)
    log(f"data -> trainer: {DATA_ROWS} rows x 513 tokens "
        f"({rows.nbytes} B int32), {n_sep} separator tokens; plan (task "
        f"map_batches, actor map_batches x 2, random_shuffle) executed in "
        f"{plan_s} s; driver stats: {driver_stats}")
    log(f"data trainer worker pid {last['pid']} (driver {os.getpid()}), "
        f"CUDA_VISIBLE_DEVICES={last['cvd']!r}; {len(hist)} steps, losses "
        f"first {losses[0]} (driver's in-process step on the reported "
        f"batch {loss_driver}, <= 1e-3) last {losses[-1]}; K1/K2/K3 "
        f"launches {launches}; rows seen {sum(seen.values())}, distinct "
        f"digests {len(seen)}")
    log(f"data trainer stats in the worker: {last['stats']}")
    check(last["pid"] != os.getpid() and last["cvd"] == card,
          f"the data trainer worker is not granted the card: {last}")
    check(first.shape == (4, 513) and first.dtype == np.int64,
          f"the first batch is {first.shape} {first.dtype}")
    check(seen == Counter(row_digests(want)),
          "the epoch's rows are not the transformed source rows, each once")
    check(abs(losses[0] - loss_driver) <= 1e-3,
          f"first data trainer loss {losses[0]} vs the driver's "
          f"{loss_driver}")
    check(all(math.isfinite(x) for x in losses)
          and statistics.mean(losses[-16:]) < statistics.mean(losses[:16]),
          "the data trainer's loss did not fall")
    check(launches == [2 * L * steps, L * steps, L * steps],
          f"K1/K2/K3 launches in the worker {launches}, expected "
          f"{[2 * L * steps, L * steps, L * steps]}")
    log(f"data -> trainer on {smi}: {step_ms} ms per step (median of steps "
        f"2-{steps}) against phase 11's {trainer_step_ms}; data wait median "
        f"{statistics.median(wait)} ms, p99 "
        f"{float(np.percentile(wait, 99))} ms, max {max(wait)} ms, first "
        f"{wait[0]} ms; wait share of the loop's wall "
        f"{wait_share} ({last['loop_s']} s); H2D median "
        f"{statistics.median(h['h2d_ms'] for h in hist)} ms; worker start "
        f"(fit() to the loop's first line) "
        f"{hist[0]['loop_start'] - t_fit} s, fit() wall {fit_s} s, phase "
        f"{time.perf_counter() - t_phase} s")
    return launches


AUTOSCALE_IDLE_S = 5.0   # phase 19: the autoscaler's idle timeout
AUTOSCALE_TICK_S = 0.5   # ... and its loop's interval

# Phase 19's job: its driver (a client of the cluster) runs one
# ``num_tpus=1`` task, the flagship forward on the card it is granted.
AUTOSCALED_JOB = """
import json
import time

import ray_tpu_torch as ray

ray.init()


def forward():
    import os
    import time

    import torch

    import ray_tpu_torch
    from ray_tpu_torch.entry import entry
    from ray_tpu_torch.ops import _build

    start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn, (params, tokens) = entry()
    with torch.no_grad():
        _build.reset_launches()                   # the job's path starts
        logits = fn(params, tokens)
        torch.cuda.synchronize()
        k1 = _build.launches["rtt_flash_fwd_bf16"]  # the job's path ends
    return {"start": start, "pid": os.getpid(),
            "cvd": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_name": torch.cuda.get_device_name(0),
            "node": ray_tpu_torch.get_runtime_context().node_id, "k1": k1,
            "shape": list(logits.shape),
            "finite": bool(torch.isfinite(logits).all()),
            "mean": float(logits.float().mean())}


queued = time.time()
out = ray.get(ray.remote(num_tpus=1)(forward).remote(), timeout=600)
out["queued"] = queued
print("JOB_TASK " + json.dumps(out), flush=True)
ray.shutdown()
"""


def cli(*args, timeout=300, env=None):
    """``python -m ray_tpu_torch.scripts <args>`` from the repo's root,
    with ``env`` over this process's environment; fails the phase on a
    non-zero exit.  Returns its standard output."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    # Files, not pipes: ``up`` leaves a head process holding its output.
    with tempfile.TemporaryFile("w+") as out, \
            tempfile.TemporaryFile("w+") as err:
        p = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts",
                            *args], cwd=repo, env=env, stdout=out,
                           stderr=err, text=True, timeout=timeout)
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    check(p.returncode == 0, f"scripts {args[0]} exited {p.returncode}: "
          f"{stderr[-2000:]}")
    return stdout


# Phase 19 b's probe, run through the launcher's ``exec``: a client of the
# launched cluster runs one ``num_tpus=1`` task on the card, then reads
# the node table through the dashboard's ``/api/nodes``.
LAUNCHED_PROBE = """
import json
import os
import socket
import time
import urllib.request

import ray_tpu_torch as ray
from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

ray.init(address=os.environ["RAY_TPU_ADDRESS"])


def probe():
    import os

    import torch

    import ray_tpu_torch

    total = torch.arange(4.0, device="cuda:0").sum()
    return {"pid": os.getpid(),
            "cvd": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_name": torch.cuda.get_device_name(0),
            "sum": float(total),
            "node": ray_tpu_torch.get_runtime_context().node_id}


t0 = time.time()
out = ray.get(ray.remote(num_tpus=1)(probe).remote(), timeout=300)
out["task_s"] = time.time() - t0
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
url = start_dashboard(port=port)
deadline = time.time() + 60
while True:
    with urllib.request.urlopen(url + "/api/nodes", timeout=10) as r:
        nodes = json.loads(r.read())
    row = [n for n in nodes if n["node_id"] == out["node"]]
    if time.time() > deadline or (row and row[0]["available"].get("TPU")
                                  == row[0]["resources"].get("TPU")):
        break
    time.sleep(0.2)
stop_dashboard()
out["nodes"] = [{k: n[k] for k in ("node_id", "alive", "resources",
                                   "available")} for n in nodes]
print("EXEC_PROBE " + json.dumps(out), flush=True)
ray.shutdown()
"""


def _pid_gone(pid):
    """No such process, or a zombie nobody has reaped yet."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] == "Z"
    except OSError:
        return True


def launcher_phase(torch, smi):
    """Main path 14 b: the cluster launcher on the card.  ``up`` of a
    ``subprocess``-provider config with one ``h100-1`` worker type (a
    head process that counts no card, ``RAY_TPU_FORCE_NUM_TPUS=0``, and a
    node agent offering the card), a ``num_tpus=1`` probe through
    ``exec``, the node table through the dashboard, then ``down``.  The
    launcher's state lives under a temporary ``HOME``."""
    import os
    import re
    import shutil
    import tempfile

    card = first_visible_card()
    tmp = tempfile.mkdtemp(prefix="rtpu-launcher-")
    cfg = os.path.join(tmp, "cluster.yaml")
    with open(cfg, "w", encoding="utf-8") as f:
        f.write(f"cluster_name: chip-smoke-{os.getpid()}\n"
                "provider: {type: subprocess}\n"
                "head: {num_cpus: 2}\n"
                "worker_types:\n"
                "  h100-1:\n"
                "    resources: {CPU: 2, TPU: 1}\n"
                "    min_workers: 1\n"
                "    max_workers: 1\n")
    env = {"HOME": tmp, "RAY_TPU_FORCE_NUM_TPUS": "0"}
    state_file = os.path.join(tmp, ".ray_tpu_torch", "clusters",
                              f"chip-smoke-{os.getpid()}.json")
    t0 = time.perf_counter()
    try:
        up = cli("up", cfg, env=env)
        up_s = time.perf_counter() - t0
        with open(state_file, encoding="utf-8") as f:
            state = json.load(f)
        t0 = time.perf_counter()
        out = cli("exec", cfg, "--", sys.executable, "-c", LAUNCHED_PROBE,
                  env=env)
        exec_s = time.perf_counter() - t0
    finally:
        t0 = time.perf_counter()
        down = cli("down", cfg, env=env)
        down_s = time.perf_counter() - t0
        shutil.rmtree(tmp, ignore_errors=True)
    pids = [state["head_pid"], *state["agent_pids"].values()]
    deadline = time.time() + 15
    while time.time() < deadline and not all(map(_pid_gone, pids)):
        time.sleep(0.1)
    m = re.search(r"EXEC_PROBE (\{.*\})", out)
    check(m is not None, f"exec printed no probe line: {out[-2000:]}")
    probe = json.loads(m.group(1))
    nodes = {n["node_id"]: n for n in probe["nodes"] if n["alive"]}
    row = nodes.get(probe["node"], {})
    log(f"launcher: {up.strip()}; exec'd probe pid {probe['pid']} on node "
        f"{probe['node']}, CUDA_VISIBLE_DEVICES={probe['cvd']!r}, "
        f"{probe['device_name']}; /api/nodes {probe['nodes']}; "
        f"{down.strip()}")
    check(len(state["nodes"]) == 1 and state["nodes"][0]["type"] ==
          "h100-1", f"up launched {state['nodes']}")
    check(probe["cvd"] == card and probe["device_name"] ==
          torch.cuda.get_device_name(0) and probe["sum"] == 6.0,
          f"the exec'd probe did not run on the node's card: {probe}")
    check(len(nodes) == 2 and row.get("resources", {}).get("TPU") == 1.0
          and row.get("available", {}).get("TPU") == 1.0
          and sum(n["resources"].get("TPU", 0.0)
                  for n in nodes.values()) == 1.0,
          f"/api/nodes does not show the node's TPU 1/1 alone: "
          f"{probe['nodes']}")
    check(all(map(_pid_gone, pids)), f"down left a process of {pids}")
    log(f"launcher on {smi}: up {up_s} s (head and one node), exec'd probe "
        f"{exec_s} s (its task {probe['task_s']} s), down {down_s} s")


def compute_app_pids():
    """Pids of the processes ``nvidia-smi`` lists on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return {int(t) for t in out.split() if t.strip().isdigit()}


def autoscaled_phase(torch, smi, loss0_phase8, trainer_step_ms):
    """Main path 14: the autoscaler brings a card node up on demand.  The
    head's pool holds no card; ``StandardAutoscaler``'s own loop meets
    the trainer's one-card placement group by launching the ``h100-1``
    node type through ``FakeSliceProvider`` (a real node agent), phase
    11's trainer runs there, the CLI inspects the cluster and submits a
    job whose ``num_tpus=1`` task waits for the trainer to release the
    card, and the idle node is drained and terminated.  Returns
    ([K1, K2, K3] launches in the trainer's worker, K1 in the job's
    task)."""
    import os
    import re
    import statistics
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import ray_tpu_torch
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.autoscaler import FakeSliceProvider, StandardAutoscaler
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.entry import _flagship_cfg
    from ray_tpu_torch.job_submission import JobSubmissionClient
    from ray_tpu_torch.train import DataParallelTrainer, TorchConfig

    class TimedProvider(FakeSliceProvider):
        """Records when each launch was asked for and when its agent
        registered (``create_node`` returns once it has)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.launches = []

        def create_node(self, node_type):
            t_call = time.time()
            nid = super().create_node(node_type)
            self.launches.append({
                "node": nid, "type": node_type, "t_call": t_call,
                "t_alive": time.time(),
                "agent": self._cluster._agents[nid]})
            return nid

    card = first_visible_card()
    cfg = _flagship_cfg()
    L = cfg.num_layers
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cluster = Cluster(head_num_cpus=2)
    scaler = None
    pool = ThreadPoolExecutor(1)
    marks = {}
    try:
        rt = cluster.rt
        check(rt.cluster_resources().get("TPU", 0.0) == 0.0,
              f"the head's pool holds cards: {rt.cluster_resources()}")
        provider = TimedProvider(cluster, {
            "h100-1": {"resources": {"CPU": 2, "TPU": 1},
                       "max_workers": 1}})
        scaler = StandardAutoscaler(rt, provider,
                                    idle_timeout_s=AUTOSCALE_IDLE_S,
                                    update_interval_s=AUTOSCALE_TICK_S)
        scaler.start()
        trainer = DataParallelTrainer(
            trainer_loop, train_loop_config={"steps": TRAINER_STEPS},
            backend_config=TorchConfig(),
            scaling_config=ScalingConfig(num_workers=1,
                                         tpu_chips_per_worker=1))
        t_fit = time.time()
        fit = pool.submit(trainer.fit)
        fit.add_done_callback(lambda _: marks.setdefault("fit_done",
                                                         time.time()))
        # The CLI while the node is up and the trainer's worker holds it.
        deadline = time.time() + 300
        nid = None
        while time.time() < deadline and not fit.done():
            if provider.launches:
                nid = provider.launches[0]["node"]
                if any(a["node_id"] == nid and a["busy"]
                       for a in rt.node_activity()):
                    break
            time.sleep(0.1)
        check(nid is not None and not fit.done(),
              f"no node launched for the trainer ({provider.launches}, "
              f"fit done: {fit.done()})")
        address, key = rt.tcp_address, rt._authkey.hex()
        status = cli("status", "--address", address, "--authkey", key)
        t_submit = time.time()
        submitted = cli("submit", "--address", address, "--authkey", key,
                        "--", sys.executable, "-c", AUTOSCALED_JOB)
        job_id = re.search(r"submitted: (\S+)", submitted).group(1)
        result = fit.result(timeout=900)
        jobs = JobSubmissionClient()
        deadline = time.time() + 600
        while time.time() < deadline and jobs.get_job_status(job_id) in (
                "PENDING", "RUNNING"):
            time.sleep(0.1)
        t_done = time.time()
        job_status = jobs.get_job_status(job_id)

        def watch_scale_down():
            """Scale-down, watched from the job's end: the idle clock
            starts when node_activity first shows the node idle; the node
            must be gone within 30 s."""
            t_idle = None
            deadline = time.time() + 30
            while time.time() < deadline:
                acts = {a["node_id"]: a for a in rt.node_activity()}
                if t_idle is None and nid in acts and not acts[nid]["busy"]:
                    t_idle = time.time()
                if [a["is_head"] for a in acts.values() if a["alive"]] \
                        == [True]:
                    return t_idle, time.time()
                time.sleep(0.05)
            return t_idle, None

        watch = pool.submit(watch_scale_down)
        logs = cli("logs", "--address", address, "--authkey", key, job_id)
        trace_dir = tempfile.mkdtemp(prefix="rtpu-timeline-")
        trace_path = os.path.join(trace_dir, "timeline.json")
        cli("timeline", "--address", address, "--authkey", key, "--out",
            trace_path)
        with open(trace_path, encoding="utf-8") as f:
            trace = json.load(f)
        os.unlink(trace_path)
        os.rmdir(trace_dir)
        t_idle, t_gone = watch.result(timeout=60)
        agent = provider.launches[0]["agent"]
        deadline = time.time() + 15      # the drain's terminate follows
        while time.time() < deadline and agent.poll() is None:
            time.sleep(0.05)
        stats = scaler.stats()
    finally:
        pool.shutdown(wait=False)
        if scaler is not None:
            scaler.stop()
        cluster.shutdown()
    check(result.error is None, f"fit() failed: {result.error!r}")
    hist = result.metrics_history
    check(len(hist) == TRAINER_STEPS, f"{len(hist)} reports")
    last = hist[-1]
    losses = [h["loss"] for h in hist]
    launches = [last["launches"][k] for k in FLASH]
    k5_path("autoscaled_trainer", last["launches"], TRAINER_STEPS)
    step_ms = statistics.median(h["step_s"] for h in hist[1:]) * 1e3
    launch = provider.launches[0]
    m = re.search(r"JOB_TASK (\{.*\})", logs)
    check(m is not None, f"the job's logs hold no task line: {logs[-2000:]}")
    job = json.loads(m.group(1))
    apps = compute_app_pids()
    node_lane = f"node {nid[:12]}"
    lanes = {e["pid"]: e["args"]["name"] for e in trace
             if e.get("name") == "process_name"}
    on_node = sorted({e["name"] for e in trace if e.get("ph") == "X"
                      and lanes.get(e["pid"]) == node_lane})
    log(f"autoscaled node: {launch['type']} {nid} launched by the "
        f"autoscaler's loop ({len(provider.launches)} launch(es)); fit() "
        f"wall {marks['fit_done'] - t_fit} s, the trainer's last report -> "
        f"fit() returned {marks['fit_done'] - last['t_report']} s; status "
        f"through the CLI:\n{status.rstrip()}")
    log(f"autoscaled trainer: worker pid {last['pid']} on node "
        f"{last['node']}, CUDA_VISIBLE_DEVICES={last['cvd']!r}, "
        f"{last['device_name']}, process group {last['backend']} world "
        f"{last['world']}; losses {losses} (phase 8's first "
        f"{loss0_phase8}); K1/K2/K3 launches {launches} in "
        f"{TRAINER_STEPS} steps; ms per step "
        f"{[h['step_s'] * 1e3 for h in hist]}")
    log(f"autoscaled job {job_id}: {job_status}; its task pid "
        f"{job['pid']} on node {job['node']}, "
        f"CUDA_VISIBLE_DEVICES={job['cvd']!r}, {job['device_name']}, logits "
        f"{job['shape']} finite {job['finite']} mean {job['mean']}, K1 "
        f"launches {job['k1']}; queued {job['queued'] - last['t_report']} "
        f"s after the trainer's last report, started "
        f"{job['start'] - last['t_report']} s after it and "
        f"{job['start'] - marks['fit_done']} s after fit() returned")
    log(f"timeline: {len(trace)} events, on the node's lane {on_node}; "
        f"scale-down: node gone {t_gone and t_gone - t_done} s after the "
        f"job ended, agent pid {agent.pid} exit {agent.poll()}; "
        f"nvidia-smi compute apps {sorted(apps)}; autoscaler {stats}")
    check(status.count("ALIVE") == 2 and re.search(
        r"resources: .*'TPU': 1\.0", status) is not None,
          f"status lists not 2 alive nodes and TPU 1: {status}")
    check(len(provider.launches) == 1 and launch["type"] == "h100-1",
          f"launches {provider.launches}")
    check(last["node"] == nid and last["pid"] != os.getpid()
          and last["cvd"] == card
          and last["device_name"] == torch.cuda.get_device_name(0),
          f"the trainer's worker is not on the launched node's card: "
          f"{last}")
    check(abs(losses[0] - loss0_phase8) <= 1e-3,
          f"first autoscaled trainer loss {losses[0]} vs phase 8's "
          f"{loss0_phase8}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    want = [2 * L * TRAINER_STEPS, L * TRAINER_STEPS, L * TRAINER_STEPS]
    check(launches == want, f"K1/K2/K3 launches in the autoscaled "
          f"trainer's worker {launches}, expected {want}")
    check(job_status == "SUCCEEDED", f"the job ended {job_status}: "
          f"{logs[-2000:]}")
    check(job["node"] == nid and job["cvd"] == card
          and job["device_name"] == torch.cuda.get_device_name(0)
          and job["pid"] != last["pid"],
          f"the job's task is not on the launched node's card: {job}")
    check(job["finite"] and job["shape"] == [4, 512, cfg.vocab_size]
          and job["k1"] == L, f"the job's forward: {job}")
    check(job["queued"] < last["t_report"] <= job["start"],
          "the job's task did not wait for the trainer to release the card")
    check("forward" in on_node and len(on_node) >= 2,
          f"the timeline lacks the trainer's and the job's tasks on the "
          f"node: {on_node}")
    check(t_idle is not None and t_gone is not None,
          "the idle node was not terminated within 30 s")
    check(agent.poll() is not None and not os.path.exists(
        f"/proc/{agent.pid}"), f"the node's agent {agent.pid} lives")
    check(not apps & {last["pid"], job["pid"]},
          f"the node's workers still hold the card: {sorted(apps)}")
    check(stats["autoscaler_errors"] == 0, f"autoscaler {stats}")
    log(f"autoscaled card node on {smi}: demand -> launch "
        f"{launch['t_call'] - t_fit} s, launch -> node alive "
        f"{launch['t_alive'] - launch['t_call']} s, the worker's start "
        f"(node alive to the loop's first line) "
        f"{last['loop_start'] - launch['t_alive']} s; {step_ms} ms per step "
        f"(median of steps 2-{TRAINER_STEPS}) against phase 11's "
        f"{trainer_step_ms}; the job's submit -> SUCCEEDED "
        f"{t_done - t_submit} s; idle -> terminated {t_gone - t_idle} s "
        f"(idle timeout {AUTOSCALE_IDLE_S} s); phase "
        f"{time.perf_counter() - t_phase} s")
    return launches, job["k1"]


SHARDED_EMBED = 256      # phase 20: the widest row K4 takes (head_dim <= 256)
SHARDED_VOCAB = 32000    # the flagship's vocab
SHARDS = 4               # column blocks of the projection on the one card


def sharded_requests():
    """Phase 7's 16 requests: one shared 20-token prompt, each request its
    own two last tokens."""
    system = list(range(20))
    return [{"prompt": system + [32 + i % 32, i], "tokens": 3 + i % 10}
            for i in range(16)]


def serve_in_process(torch, dec, reqs):
    """``reqs`` through ``dec``, K4's launches counted around them alone:
    the first request alone (it registers the shared prompt, so that the
    prefix cache is hit whatever the threads' timing), then the others
    from one thread each.  Returns (chains, K4 launches, wall s, batcher
    stats, the steps these requests took)."""
    from ray_tpu_torch.ops import _build

    out = [None] * len(reqs)
    batcher = dec.__dict__["__serve_batcher__decode"]
    steps0 = batcher.stats()["steps"]

    def client(i):
        out[i] = dec(reqs[i])

    torch.cuda.synchronize()
    _build.reset_launches()                       # the main path starts
    t0 = time.perf_counter()
    client(0)
    run_threads(lambda i: client(i + 1), len(reqs) - 1)
    wall = time.perf_counter() - t0
    launches = _build.launches["rtt_paged_decode"]    # the main path ends
    stats = batcher.stats()
    return out, launches, wall, stats, stats["steps"] - steps0


def sharded_kernel_at_d256(torch, dev):
    """K4 at phase 20's shape (f32, B=8, h=1, d=256, block 8, window=1):
    bitwise its plain version, its device time, the plain version's and
    the bound from ``k4_work``."""
    from ray_tpu_torch.ops.paged_attention import paged_attention

    q, kc, vc, bt, cl, cl_np = _paged_inputs(
        torch, dev, 7, 8, 1, SHARDED_EMBED, 8, 40, torch.float32)

    def plain():
        return k4_plain(q, kc, vc, bt, cl, 1)

    def run():
        return paged_attention(q, kc, vc, bt, cl, window=1)

    out, ref = run(), plain()
    torch.cuda.synchronize()
    exact = torch.equal(out, ref)
    err = float((out - ref).abs().max())
    nbytes, flops = k4_work(q, cl_np, 1, 8)
    b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
    ms = device_ms(torch, run, 50, kernel="paged_decode_kernel",
                   floor_ms=b_ms)
    call_ms = cuda_ms(run, 200)
    plain_ms = device_ms(torch, plain, 20, floor_ms=b_ms)
    log(f"K4 at phase 20's shape (f32, B=8, h=1, d={SHARDED_EMBED}, bs=8, "
        f"window=1): exact={exact} max_abs_err={err}; kernel {ms} ms, "
        f"wrapper call {call_ms} ms (CUDA events, back to back), plain "
        f"{plain_ms} ms, bound {b_ms} ms ({b_by}: {nbytes} B, {flops} "
        f"flop)")
    check(exact, "K4 is not exact at window=1 at d=256")
    return {"max_abs_err_d256": err, "ms_d256": ms, "call_ms_d256": call_ms,
            "plain_ms_d256": plain_ms, "bound_ms_d256": b_ms,
            "bound_by_d256": b_by}


def sharded_decoder_phase(torch, smi):
    """Phase 20, the sharded decoder.  (a) In this process: the decoder at
    vocab 32000, embed 256 with its projection in 4 column blocks on the
    one card, phase 7's 16 requests bitwise ``reference_decode`` and a
    1-shard decoder's chains on the same weights.  (b) Through the
    runtime: a replica granted the card with ``device=None`` resolves one
    shard per visible card and serves the same chains.  Returns K4's
    launches in (a) and (b) and K4 at d=256."""
    import os

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    t_phase = time.perf_counter()
    dev = torch.device("cuda:0")
    k4 = sharded_kernel_at_d256(torch, dev)
    missing = f"cuda:{torch.cuda.device_count()}"
    try:
        MeshShardedDecoder(device=["cuda:0", missing])
    except RuntimeError as e:
        log(f"a device list naming {missing} raises: {e}")
    else:
        raise AssertionError(f"a device list naming {missing} was taken")
    GLOBAL_CONFIG.paged_kv = True
    GLOBAL_CONFIG.prefix_caching = True
    GLOBAL_CONFIG.speculative_k = 3
    kw = dict(embed=SHARDED_EMBED, kv_blocks=128)
    sharded = MeshShardedDecoder(vocab=SHARDED_VOCAB,
                                 device=["cuda:0"] * SHARDS, **kw)
    check(len(sharded._devices) == SHARDS and sharded._vocab == SHARDED_VOCAB
          and all(w.device == dev and w.shape == (SHARDED_EMBED,
                                                  SHARDED_VOCAB // SHARDS)
                  for w in sharded._w),
          f"the 4-shard decoder: {sharded._devices}, vocab {sharded._vocab}")
    weights = {"w": sharded._w_host, "emb": sharded._emb_host,
               "wd": sharded._wd_host}
    whole = MeshShardedDecoder(weights=weights, device="cuda:0", **kw)
    check(len(whole._devices) == 1, "the 1-shard decoder")
    reqs = sharded_requests()
    t0 = time.perf_counter()
    want = [sharded.reference_decode(r["prompt"], r["tokens"]) for r in reqs]
    ref_s = time.perf_counter() - t0
    # One request on another prompt warms each decoder (the card's
    # libraries load on the first call), so that neither timed run pays
    # for the other.
    for dec in (sharded, whole):
        check(len(dec({"prompt": list(range(100, 120)), "tokens": 2})) == 2,
              "warm-up request")
    runs = {}
    for what, dec in (("4-shard", sharded), ("1-shard", whole)):
        out, launches, wall, st, steps = serve_in_process(torch, dec, reqs)
        runs[what] = (launches, wall, steps)
        log(f"phase 20 (a) {what} decoder (vocab {SHARDED_VOCAB}, embed "
            f"{SHARDED_EMBED}, on {smi}): 16 requests, "
            f"{sum(len(o) for o in out)} tokens, wall {wall} s, steps "
            f"{steps}, {wall / steps * 1e3} ms per step, "
            f"{sum(len(o) for o in out) / steps} tokens per step, "
            f"prefix_hits "
            f"{st['prefix_hits']}, spec accepted "
            f"{st['spec_accepted']}/{st['spec_proposed']}, K4 launches "
            f"{launches}")
        for r, got, w in zip(reqs, out, want):
            check(got == w, f"{what} chain differs from reference_decode "
                  f"for {r}")
        check(launches > 0, f"K4 never launched in the {what} decoder")
        check(st["prefix_hits"] > 0, f"no prefix hits in the {what} decoder")
    step_ms = {k: v[1] / v[2] * 1e3 for k, v in runs.items()}
    log(f"phase 20 (a): every chain of both decoders bitwise "
        f"reference_decode ({ref_s} s of host reference at vocab "
        f"{SHARDED_VOCAB}); the 4-shard step takes "
        f"{step_ms['4-shard'] - step_ms['1-shard']} ms more than the "
        f"1-shard step ({step_ms['4-shard']} against {step_ms['1-shard']})")
    # The projection alone, at the verify forward's shape (8 requests, k+1
    # = 4 rows each): four block products and their merge against one.
    x = torch.from_numpy(sharded._emb_host[np.arange(32).reshape(8, 4)]).to(
        dev)
    check(torch.equal(sharded._project(x), whole._project(x)),
          "the 4-block projection picks other tokens than the whole one")
    # Its bound: w and x read once and the int64 picks written once, or
    # its f32 flop (TF32 is off).
    p_ms, p_by = bound(4 * SHARDED_EMBED * SHARDED_VOCAB + 4 * x.numel()
                       + 8 * 32, 0, F32_FLOPS, 2 * x.numel() * SHARDED_VOCAB)
    proj = {}
    for what, d in (("4-block", sharded), ("whole", whole)):
        log(f"{what} projection, its kernels:")
        proj[what] = device_ms(torch, lambda d=d: d._project(x), 20,
                               floor_ms=p_ms, top=8)
    log(f"phase 20 (a): device time of the projection at (8, 4, "
        f"{SHARDED_EMBED}) x ({SHARDED_EMBED}, {SHARDED_VOCAB}), f32: 4 "
        f"blocks and their merge {proj['4-block']} ms, one whole product "
        f"{proj['whole']} ms, bound {p_ms} ms ({p_by})")
    del sharded, whole
    torch.cuda.empty_cache()

    # (b) Through the runtime: device=None in a worker granted the card.
    ProbedDecoder = probed_decoder()
    card = first_visible_card()
    ray_tpu_torch.init(num_cpus=4, _system_config={
        "paged_kv": True, "prefix_caching": True, "speculative_k": 3})
    try:
        t0 = time.perf_counter()
        dep = serve.deployment(ProbedDecoder, name="sharded",
                               ray_actor_options={"num_tpus": 1},
                               max_concurrency=16)
        handle = serve.run(dep.bind(weights=weights, device=None, **kw),
                           name="sharded")
        before = ray_tpu_torch.get(handle.method("probe").remote(reset=True),
                                   timeout=300)
        deploy_s = time.perf_counter() - t0
        out = [None] * len(reqs)

        def client(i):
            out[i] = ray_tpu_torch.get(handle.remote(reqs[i]), timeout=300)

        t0 = time.perf_counter()                  # main path 20b starts
        run_threads(client, len(reqs))
        wall = time.perf_counter() - t0
        after = ray_tpu_torch.get(handle.method("probe").remote(),
                                  timeout=300)    # main path 20b ends
        stats = serve.serving_stats("sharded")
        for r, got, w in zip(reqs, out, want):
            check(got == w, f"served sharded chain differs from "
                  f"reference_decode for {r}")
        log(f"phase 20 (b): replica pid {after['pid']} (driver "
            f"{os.getpid()}), CUDA_VISIBLE_DEVICES={after['cvd']!r}, "
            f"{after['shards']} shard(s) on {after['cards']} visible "
            f"card(s), tensors on {after['device']}, K4 launches "
            f"{after['launches']} (reset from {before['launches']}); "
            f"serving_stats mode {stats.get('mode')}, retired "
            f"{stats.get('retired')}, steps {stats.get('steps')}; deploy "
            f"{deploy_s} s, 16 requests wall {wall} s; every chain bitwise "
            f"reference_decode")
        check(after["pid"] != os.getpid() and after["cvd"] == card
              and after["device"] == "cuda",
              f"the replica is not in a worker granted the card: {after}")
        check(after["shards"] == after["cards"] == 1,
              f"device=None in a worker granted one card: {after}")
        check(after["launches"] > 0, "K4 never launched in the replica")
        check(stats.get("mode") == "continuous+paged"
              and stats.get("retired") == len(reqs),
              f"serving_stats: {stats}")
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    log(f"phase 20 took {time.perf_counter() - t_phase} s")
    return runs["4-shard"][0], after["launches"], k4


RECOVERY_CKPT_AT = 2     # phase 21: the trainer's full-state checkpoint step
INFLIGHT = 8             # phase 21 (c): requests in flight at the kill
FAILOVER_AFTER = 2       # phase 22: the head fails over after this step
SECOND_WAIT_S = 10.0     # ... and a second one-card task waits this long

# Phase 21 (a): waits for the hold file, then reads the killed worker's
# state in /proc every half millisecond; prints when it turned into a
# zombie and when it was reaped, on time.time()'s clock.
ZOMBIE_POLLER = r"""
import json, os, sys, time
hold, out = sys.argv[1], {}
deadline = time.time() + 900
while not os.path.exists(hold) and time.time() < deadline:
    time.sleep(0.0005)
if os.path.exists(hold):
    pid = json.load(open(hold))["pid"]
    while time.time() < deadline:
        try:
            with open("/proc/%d/stat" % pid) as f:
                st = f.read().rsplit(")", 1)[1].split()[0]
        except FileNotFoundError:
            out["gone"] = time.time()
            break
        if st in "ZX":
            out.setdefault("zombie", time.time())
        time.sleep(0.0005)
print(json.dumps(out))
"""


class CardWatch(threading.Thread):
    """Reads the in-process head's tables every millisecond: when each
    worker holding one of the head node's cards was last seen alive, and
    each change of whether the card of pool index 0 is free; and stamps
    each worker death the head handles, at its reader's EOF and once
    processed.  Phase 21 times a death, the card's release and its next
    grant from them."""

    def __init__(self):
        super().__init__(daemon=True, name="card-watch")
        from ray_tpu_torch._private import api_internal

        rt = api_internal.require_runtime()
        self._node = rt.head_node
        self.seen = {}           # pid -> (first seen, last seen), time.time
        self.free = []           # (time.time, card 0 free?) at each change
        self.deaths = {}         # pid -> (the reader's EOF, death processed)
        self.stop = threading.Event()
        on_death = rt._on_worker_death

        def stamped(worker):
            t_eof = time.time()
            on_death(worker)
            if worker.proc is not None:
                self.deaths.setdefault(worker.proc.pid,
                                       (t_eof, time.time()))

        # The head's reader thread calls this at a worker's EOF.
        rt._on_worker_death = stamped

    def run(self):
        last = None
        while not self.stop.is_set():
            now = time.time()
            for w in list(self._node.all_workers.values()):
                if w.tpu_chips and not w.dead and w.proc is not None:
                    first = self.seen.get(w.proc.pid, (now, now))[0]
                    self.seen[w.proc.pid] = (first, now)
            free = 0 in self._node.tpu_free
            if free != last:
                self.free.append((now, free))
                last = free
            time.sleep(0.001)

    def after(self, t, free):
        """The first time after ``t`` the card became free (or taken)."""
        return next((u for u, f in self.free if u > t and f == free), None)


def recovery_trainer_phase(torch, smi, phase11):
    """Phase 21 (a): phase 11's trainer (the flagship at full width, one
    worker granted the card, an NCCL group of world size 1) with
    ``FailureConfig(max_failures=1)``.  At step 2 the worker reports the
    whole state as a checkpoint; once the report has returned, the worker
    kills itself with SIGKILL.  ``fit()`` restarts the group, and the
    new worker, granted the same card, restores the state and runs steps
    3-4.  Returns the new worker's K1/K2/K3 launches."""
    import os
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.air import FailureConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.entry import _flagship_cfg
    from ray_tpu_torch.train import DataParallelTrainer, TorchConfig

    t_phase = time.perf_counter()
    card = first_visible_card()
    L = _flagship_cfg().num_layers
    torch.cuda.empty_cache()
    hold = os.path.join(tempfile.mkdtemp(prefix="chip-smoke-"), "held")
    ray_tpu_torch.init(num_cpus=4)
    watch = CardWatch()
    watch.start()
    zombie = subprocess.Popen([sys.executable, "-c", ZOMBIE_POLLER, hold],
                              stdout=subprocess.PIPE, text=True)
    try:
        trainer = DataParallelTrainer(
            trainer_loop, train_loop_config={
                "steps": TRAINER_STEPS, "ckpt_at": RECOVERY_CKPT_AT,
                "hold": hold},
            backend_config=TorchConfig(),
            scaling_config=ScalingConfig(num_workers=1,
                                         tpu_chips_per_worker=1),
            run_config=RunConfig(
                failure_config=FailureConfig(max_failures=1)))
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
    finally:
        watch.stop.set()
        ray_tpu_torch.shutdown()
        try:
            gone = json.loads(zombie.communicate(timeout=30)[0] or "{}")
        except subprocess.TimeoutExpired:
            zombie.kill()
            zombie.communicate()
            gone = {}
    check(result.error is None, f"fit() failed: {result.error!r}")
    check(os.path.exists(hold), "the trainer's worker was never killed")
    with open(hold) as f:
        killed = json.load(f)
    eof, processed = watch.deaths.get(killed["pid"], (None, None))
    hist = result.metrics_history
    steps = [h["step"] for h in hist]
    check(steps == list(range(RECOVERY_CKPT_AT + 1, TRAINER_STEPS + 1)),
          f"the restarted group ran steps {steps}: it did not resume from "
          f"step {RECOVERY_CKPT_AT}'s checkpoint")
    first = hist[0]
    restored = first["restored"]
    t_kill = killed["t_kill"]
    t_dead = watch.seen.get(killed["pid"], (None, None))[1]
    t_free = watch.after(t_kill, True)
    t_grant = watch.after(t_free, False) if t_free else None
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    want = phase11["losses"][RECOVERY_CKPT_AT:]
    launches = hist[-1]["launches"]
    got = [launches[k] for k in FLASH]
    n = TRAINER_STEPS - RECOVERY_CKPT_AT
    k5_path("recovered_trainer", launches, n)
    log(f"phase 21 (a) on {smi}: step {RECOVERY_CKPT_AT}'s checkpoint "
        f"(f32 params and both AdamW moments) {killed['nbytes']} B, its "
        f"report {killed['report_s']} s; worker {killed['pid']} killed "
        f"(SIGKILL) once the report returned; from the kill: death seen "
        f"{t_dead and t_dead - t_kill} s (the head's last sight of it "
        f"alive), card free {t_free and t_free - t_kill} s, granted again "
        f"{t_grant and t_grant - t_kill} s, the new worker's process "
        f"start {first['process_start'] - t_kill} s, its loop start "
        f"{first['loop_start'] - t_kill} s, its state restored in "
        f"{restored and restored['restore_s']} s, its first step done "
        f"{first['t_report'] - t_kill} s; fit() {fit_s} s")
    log(f"phase 21 (a) on {smi}, the death from the kill: the worker a "
        f"zombie {gone.get('zombie') and gone['zombie'] - t_kill} s (a "
        f"poller process reading /proc), the head's reader at its EOF "
        f"{eof and eof - t_kill} s, the death processed "
        f"{processed and processed - t_kill} s, the zombie reaped "
        f"{gone.get('gone') and gone['gone'] - t_kill} s")
    log(f"phase 21 (a): resumed worker pid {first['pid']} "
        f"CUDA_VISIBLE_DEVICES={first['cvd']!r} (restored from step "
        f"{restored and restored['step']} written by pid "
        f"{restored and restored['writer_pid']}); steps {steps}: losses "
        f"{losses}, grad norms {norms}; phase 11's steps "
        f"{RECOVERY_CKPT_AT + 1}-{TRAINER_STEPS}: losses {want}, grad norms "
        f"{phase11['grad_norms'][RECOVERY_CKPT_AT:]}; bitwise "
        f"{losses == want and norms == phase11['grad_norms'][RECOVERY_CKPT_AT:]}"
        f"; K1/K2/K3 launches in the resumed worker {got} in {n} steps; "
        f"step times {[h['step_s'] * 1e3 for h in hist]} ms")
    check(restored is not None and restored["step"] == RECOVERY_CKPT_AT
          and restored["writer_pid"] == killed["pid"] != first["pid"],
          f"the resumed worker's restore: {restored}, killed {killed}")
    check(first["cvd"] == card and first["pid"] != os.getpid(),
          f"the resumed worker is not granted the card: {first}")
    check(t_dead is not None and t_free is not None and t_grant is not None,
          f"the card's release and grant were not seen: {watch.free}")
    check(all(abs(a - b) <= 1e-3 for a, b in zip(losses, want)),
          f"resumed losses {losses} vs phase 11's {want}")
    check(got == [2 * L * n, L * n, L * n],
          f"K1/K2/K3 launches in the resumed worker {got}")
    log(f"phase 21 (a) took {time.perf_counter() - t_phase} s")
    return got


def recovery_replica_phase(torch, smi):
    """Phase 21 (b): phase 20's decoder (vocab 32000, embed 256, paged KV,
    prefix caching, speculative_k=3, one shard) deployed through
    ``serve.run`` on a worker granted the card answers 8 of phase 20's 16
    requests; the replica's worker is then killed with SIGKILL, the
    controller replaces it on the card the dead worker released, and the
    replacement answers the other 8.  Returns K4's launches in the
    replacement's process."""
    import os
    import signal

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    t_phase = time.perf_counter()
    card = first_visible_card()
    kw = dict(embed=SHARDED_EMBED, kv_blocks=128)
    host = MeshShardedDecoder(vocab=SHARDED_VOCAB, device="cpu", **kw)
    weights = {"w": host._w_host, "emb": host._emb_host,
               "wd": host._wd_host}
    reqs = sharded_requests()
    want = [host.reference_decode(r["prompt"], r["tokens"]) for r in reqs]
    del host
    ProbedDecoder = probed_decoder()
    ray_tpu_torch.init(num_cpus=4, _system_config={
        "paged_kv": True, "prefix_caching": True, "speculative_k": 3})
    watch = CardWatch()
    watch.start()
    failed = []
    out = [None] * len(reqs)
    answered = [None] * len(reqs)

    def client(i):
        try:
            out[i] = ray_tpu_torch.get(handle.remote(reqs[i]), timeout=300)
            answered[i] = time.time()
        except Exception as e:  # noqa: BLE001 -- every failure is printed
            failed.append((i, repr(e)))

    try:
        dep = serve.deployment(ProbedDecoder, name="recovery",
                               ray_actor_options={"num_tpus": 1},
                               max_concurrency=16)
        handle = serve.run(dep.bind(weights=weights, device=None, **kw),
                           name="recovery")
        old = ray_tpu_torch.get(handle.method("probe").remote(reset=True),
                                timeout=300)
        run_threads(client, 8)
        mid = ray_tpu_torch.get(handle.method("probe").remote(),
                                timeout=300)
        (old_rep,) = handle._replicas
        t_kill = time.time()
        os.kill(old["pid"], signal.SIGKILL)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and [
                r._actor_id for r in handle._replicas] in (
                [old_rep._actor_id], []):
            time.sleep(0.01)
        t_switch = time.time()
        (new_rep,) = handle._replicas
        started = ray_tpu_torch.get(
            handle.method("probe").remote(reset=True), timeout=300)
        t_ready = time.time()
        run_threads(lambda i: client(i + 8), 8)  # main path 21b
        new = ray_tpu_torch.get(handle.method("probe").remote(),
                                timeout=300)
    finally:
        watch.stop.set()
        serve.shutdown()
        ray_tpu_torch.shutdown()
    t_dead = watch.seen.get(old["pid"], (None, None))[1]
    t_free = watch.after(t_kill, True)
    t_grant = watch.after(t_free, False) if t_free else None
    first_answer = min((t for t in answered[8:] if t), default=None)
    log(f"phase 21 (b) on {smi}: replica {old_rep._actor_id.hex()} pid "
        f"{old['pid']} CUDA_VISIBLE_DEVICES={old['cvd']!r} killed "
        f"(SIGKILL) after the first 8 requests; from the kill: death seen "
        f"{t_dead and t_dead - t_kill} s, card free "
        f"{t_free and t_free - t_kill} s, granted again "
        f"{t_grant and t_grant - t_kill} s, the handle on the replacement "
        f"{t_switch - t_kill} s, its first answer (a probe, once its "
        f"constructor returned) {t_ready - t_kill} s, its first chain "
        f"{first_answer and first_answer - t_kill} s; replacement "
        f"{new_rep._actor_id.hex()} pid {new['pid']} "
        f"CUDA_VISIBLE_DEVICES={new['cvd']!r}, tensors on "
        f"{new['device']}, K4 launches {new['launches']} in its process "
        f"over the second 8 requests (reset from {started['launches']}); "
        f"the killed replica's over the first 8: {mid['launches']}; "
        f"failed requests {failed}")
    check(failed == [], f"requests failed: {failed}")
    for r, got, w in zip(reqs, out, want):
        check(got == w, f"recovered chain differs from reference_decode "
              f"for {r}")
    check(new_rep._actor_id != old_rep._actor_id and new["pid"] != old["pid"]
          and new["cvd"] == card == old["cvd"] and new["device"] == "cuda",
          f"the replacement is not a new replica on the card: {new}")
    check(new["launches"] > 0 and mid["launches"] > 0,
          f"K4 never launched in a replica: {mid}, {new}")
    check(t_free is not None and t_grant is not None,
          f"the card's release and grant were not seen: {watch.free}")
    log(f"phase 21 (b): all 16 chains bitwise reference_decode; phase 21 "
        f"(b) took {time.perf_counter() - t_phase} s")
    return new["launches"]


def gated_decoder(gate):
    """Phase 9's probed decoder whose paged step waits for the file
    ``gate`` to exist: requests sent before it opens stay in flight in
    the replica."""

    class GatedDecoder(probed_decoder()):
        def _paged_step(self, slots):
            import os

            while not os.path.exists(gate):
                time.sleep(0.005)
            return super()._paged_step(slots)

    return GatedDecoder


def inflight_replica_phase(torch, smi):
    """Phase 21 (c): phase 21 (b)'s replica, its paged step held by a
    gate, with ``INFLIGHT`` of phase 20's requests in flight in it when
    its worker is killed with SIGKILL; the gate opens after the kill.
    Each caller's outcome is a chain or an actor error; every failed
    request is sent again and answered by the controller's replacement
    on the card.  Returns K4's launches in the replacement's process."""
    import os
    import signal
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.gpu_replica import MeshShardedDecoder

    t_phase = time.perf_counter()
    card = first_visible_card()
    kw = dict(embed=SHARDED_EMBED, kv_blocks=128)
    host = MeshShardedDecoder(vocab=SHARDED_VOCAB, device="cpu", **kw)
    weights = {"w": host._w_host, "emb": host._emb_host,
               "wd": host._wd_host}
    reqs = sharded_requests()[:INFLIGHT]
    want = [host.reference_decode(r["prompt"], r["tokens"]) for r in reqs]
    del host
    gate = os.path.join(tempfile.mkdtemp(prefix="chip-smoke-"), "gate")
    ray_tpu_torch.init(num_cpus=4, _system_config={
        "paged_kv": True, "prefix_caching": True, "speculative_k": 3})
    watch = CardWatch()
    watch.start()
    outcome = [None] * INFLIGHT
    after = [None] * INFLIGHT
    again = {}
    answered = {}
    try:
        dep = serve.deployment(gated_decoder(gate), name="inflight",
                               ray_actor_options={"num_tpus": 1},
                               max_concurrency=16)
        handle = serve.run(dep.bind(weights=weights, device=None, **kw),
                           name="inflight")
        old = ray_tpu_torch.get(handle.method("probe").remote(reset=True),
                                timeout=300)
        (old_rep,) = handle._replicas
        refs = [handle.remote(r) for r in reqs]
        deadline = time.monotonic() + 60
        while True:
            with handle._lock:
                ongoing = handle._reconcile_outstanding_locked()
            if ongoing == INFLIGHT or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        time.sleep(0.5)       # the replica's batcher has them all
        ready, _ = ray_tpu_torch.wait(refs, num_returns=INFLIGHT, timeout=0)
        t_kill = time.time()
        os.kill(old["pid"], signal.SIGKILL)
        open(gate, "w").close()

        def caller(i):
            try:
                outcome[i] = ray_tpu_torch.get(refs[i], timeout=60)
            except Exception as e:  # noqa: BLE001 -- the class is checked
                outcome[i] = type(e).__name__
            after[i] = time.time() - t_kill

        run_threads(caller, INFLIGHT)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and [
                r._actor_id for r in handle._replicas] in (
                [old_rep._actor_id], []):
            time.sleep(0.01)
        (new_rep,) = handle._replicas
        started = ray_tpu_torch.get(
            handle.method("probe").remote(reset=True), timeout=300)
        failed = [i for i, o in enumerate(outcome) if isinstance(o, str)]

        def resend(j):                            # main path 21c
            i = failed[j]
            again[i] = ray_tpu_torch.get(handle.remote(reqs[i]),
                                         timeout=300)
            answered[i] = time.time()

        run_threads(resend, len(failed))
        new = ray_tpu_torch.get(handle.method("probe").remote(),
                                timeout=300)
    finally:
        watch.stop.set()
        serve.shutdown()
        ray_tpu_torch.shutdown()
    t_free = watch.after(t_kill, True)
    t_grant = watch.after(t_free, False) if t_free else None
    first_answer = min(answered.values(), default=None)
    kinds = [o if isinstance(o, str) else "chain" for o in outcome]
    log(f"phase 21 (c) on {smi}: replica pid {old['pid']} "
        f"CUDA_VISIBLE_DEVICES={old['cvd']!r} killed (SIGKILL) with "
        f"{ongoing} requests in flight in its gated step ({len(ready)} "
        f"ready); the callers' outcomes {kinds}, seconds from the kill "
        f"{after}; card free {t_free and t_free - t_kill} s, granted "
        f"again {t_grant and t_grant - t_kill} s, the replacement's first "
        f"answer to a request sent again "
        f"{first_answer and first_answer - t_kill} s; replacement pid "
        f"{new['pid']} CUDA_VISIBLE_DEVICES={new['cvd']!r}, tensors on "
        f"{new['device']}, K4 launches {new['launches']} in its process "
        f"over the {len(failed)} requests sent again (reset from "
        f"{started['launches']})")
    check(ongoing == INFLIGHT and not ready,
          f"{ongoing} requests in flight, {len(ready)} ready at the kill")
    check(all(a is not None and a < 60 for a in after),
          f"a caller waited past 60 s: {after}")
    for r, o, w in zip(reqs, outcome, want):
        check(o == w or o in ("ActorDiedError", "RayActorError"),
              f"in-flight request {r}: {o}")
    for i in failed:
        check(again.get(i) == want[i], f"the request sent again differs "
              f"from reference_decode for {reqs[i]}")
    check(new_rep._actor_id != old_rep._actor_id and new["pid"] != old["pid"]
          and new["cvd"] == card == old["cvd"] and new["device"] == "cuda",
          f"the replacement is not a new replica on the card: {new}")
    check(not failed or new["launches"] > 0,
          f"K4 never launched in the replacement: {new}")
    log(f"phase 21 (c): every chain answered or sent again bitwise "
        f"reference_decode; phase 21 (c) took "
        f"{time.perf_counter() - t_phase} s")
    return new["launches"]


class FlagshipHolder:
    """Phase 22's holder of the card: phase 11's training in an NCCL group
    of world size 1, one step a call."""

    def __init__(self):
        import socket

        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                f"{port}", world_size=1, rank=0)
        fresh, self._batch, self._step = flagship_training(
            torch, torch.device("cuda:0"))
        self._state = fresh()

    def step(self):
        import os

        import torch

        from ray_tpu_torch.ops import _build

        t0 = time.perf_counter()
        self._state, m = self._step(self._state, self._batch)
        torch.cuda.synchronize()
        return {"step": self._state.step, "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "step_s": time.perf_counter() - t0, "pid": os.getpid(),
                "cvd": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "launches": dict(_build.launches)}

    def reset_launches(self):
        from ray_tpu_torch.ops import _build

        _build.reset_launches()


def granted_card():
    """A one-card task: its card, pid and start time."""
    import os

    return {"cvd": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "pid": os.getpid(), "t": time.time()}


def failover_phase(torch, smi, phase11):
    """Phase 22: phase 11's training in a named actor granted the card
    of an external head's node; the head is killed and restarted after
    step 2, the holder re-registers and runs steps 3-4; a second
    one-card task waits until the holder is killed.  Returns K1/K2/K3's
    launches in the holder over steps 3-4."""
    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.entry import _flagship_cfg
    from ray_tpu_torch.util import state

    t_phase = time.perf_counter()
    card = first_visible_card()
    L = _flagship_cfg().num_layers
    torch.cuda.empty_cache()
    c = Cluster(external_head=True, head_num_cpus=4, head_num_tpus=1)
    try:
        h = ray_tpu_torch.remote(num_tpus=1)(FlagshipHolder).options(
            name="holder").remote()
        steps = [ray_tpu_torch.get(h.step.remote(), timeout=600)
                 for _ in range(FAILOVER_AFTER)]
        t_kill = time.time()
        c.kill_head()
        time.sleep(0.8)
        t_restart = time.time()
        c.restart_head()
        t_up = time.time()
        deadline = time.time() + 120
        while time.time() < deadline and not any(
                a["name"] == "holder" and a["state"] == "ALIVE"
                for a in state.list_actors()):
            time.sleep(0.05)
        t_alive = time.time()
        ray_tpu_torch.get(h.reset_launches.remote(), timeout=60)
        steps += [ray_tpu_torch.get(h.step.remote(), timeout=600)   # 22
                  for _ in range(TRAINER_STEPS - FAILOVER_AFTER)]
        second = ray_tpu_torch.remote(num_tpus=1)(granted_card).remote()
        ready, _ = ray_tpu_torch.wait([second], timeout=SECOND_WAIT_S)
        t_end = time.time()
        ray_tpu_torch.kill(h)
        got = ray_tpu_torch.get(second, timeout=300)
    finally:
        c.shutdown()
    losses = [s["loss"] for s in steps]
    norms = [s["grad_norm"] for s in steps]
    launches = steps[-1]["launches"]
    n = TRAINER_STEPS - FAILOVER_AFTER
    k = [launches.get(key, 0) for key in FLASH]
    k5_path("failover_holder", launches, n)
    want = phase11["losses"]
    bitwise = (losses[FAILOVER_AFTER:] == want[FAILOVER_AFTER:] and
               norms[FAILOVER_AFTER:] == phase11["grad_norms"][
                   FAILOVER_AFTER:])
    log(f"phase 22 on {smi}: holder pids {[s['pid'] for s in steps]}, "
        f"CUDA_VISIBLE_DEVICES {[s['cvd'] for s in steps]}; the head "
        f"killed after step {FAILOVER_AFTER}, down {t_up - t_kill} s "
        f"(killed to restarted and ready), its restart to the holder's "
        f"re-registration {t_alive - t_up} s; losses {losses}, grad norms "
        f"{norms}; phase 11's losses {want}, grad norms "
        f"{phase11['grad_norms']}; steps {FAILOVER_AFTER + 1}-"
        f"{TRAINER_STEPS} bitwise {bitwise}; K1/K2/K3 launches in the "
        f"holder {k} over steps "
        f"{FAILOVER_AFTER + 1}-{TRAINER_STEPS}; step times "
        f"{[s['step_s'] * 1e3 for s in steps]} ms; a second num_tpus=1 "
        f"task ready {SECOND_WAIT_S} s after it was sent: {bool(ready)}, "
        f"granted {got['t'] - t_end} s after the holder's kill, "
        f"CUDA_VISIBLE_DEVICES={got['cvd']!r}")
    check(len({s["pid"] for s in steps}) == 1
          and {s["cvd"] for s in steps} == {card},
          f"the holder changed across the failover: {steps}")
    check([s["step"] for s in steps] == list(range(1, TRAINER_STEPS + 1)),
          f"the holder's steps {[s['step'] for s in steps]}")
    check(all(abs(a - b) <= 1e-3 for a, b in zip(losses, want)),
          f"the holder's losses {losses} vs phase 11's {want}")
    check(k == [2 * L * n, L * n, L * n],
          f"K1/K2/K3 launches in the holder {k}")
    check(not ready, f"a second one-card task ran while the holder held "
          f"the card: {got}")
    check(got["cvd"] == card and got["pid"] != steps[0]["pid"],
          f"the second one-card task: {got}")
    log(f"phase 22 took {time.perf_counter() - t_phase} s")
    return k


def _np_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _np_leaves(v)]
    return [np.asarray(tree)]


def main():
    import torch

    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build   # the port must sit beside us

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"device: {name}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("allow_tf32: matmul=False cudnn=False")
    dev = torch.device("cuda:0")

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0} s")
    for lib in libs.values():
        report = lib.with_suffix(".so.log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "entry function" in line or "registers" in line or \
                        "spill" in line or "wgmma" in line:
                    log(f"  ptxas {lib.stem}: {line.strip()}")

    k1 = k1_phase(torch, dev)
    k2, k3 = k23_phase(torch, dev)
    k4 = k4_phase(torch, dev)
    k5 = k5_phase(torch, dev)
    torch.cuda.empty_cache()
    k6 = k6_phase(torch, dev)
    k1["launches"], (in_forward, k1["forward_busy_ms"]), fwd_ms = \
        llama_phase(torch)
    k4["launches"] = serve_phase(torch)
    train, (in_step, step_busy), dense = train_phase(torch)
    runtime_serve_phase(torch, smi)
    k4["launches_disagg_in_process"] = disagg_inprocess_phase(torch)
    k4["launches_disagg"] = disagg_runtime_phase(torch, smi)
    trainer = trainer_phase(torch, smi, dense["loss0"])
    torch.cuda.empty_cache()
    moe = moe_phase(torch, dev)
    mesh = mesh_phase(torch, dev, moe)
    torch.cuda.empty_cache()
    seq = sp_pp_phase(torch, dev, dict(dense, forward_ms=fwd_ms),
                      mesh["step_ms"])
    k1.update(launches_ulysses_forward=seq["ulysses_forward"][0],
              launches_ulysses_step=seq["ulysses_step"][0],
              launches_ring_forward=seq["ring_forward"][0],
              launches_pipelined_forward=seq["pipelined_forward"][0],
              launches_pipelined_step=seq["pipelined_step"][0])
    for k, i in ((k2, 1), (k3, 2)):
        k.update(launches_ulysses_step=seq["ulysses_step"][i],
                 launches_pipelined_step=seq["pipelined_step"][i])
    torch.cuda.empty_cache()
    pipe = pipeline_actors_phase(torch, dev, dense,
                                 seq["step_ms"]["pipelined_step"])
    for k, n in zip((k1, k2, k3), pipe):
        k["launches_pipeline_actors_step"] = n
    torch.cuda.empty_cache()
    rllib_phase(torch, dev)
    offpolicy_phase(torch, dev)
    torch.cuda.empty_cache()
    for k, n in zip((k1, k2, k3), data_trainer_phase(
            torch, smi, trainer["step_ms"])):
        k["launches_data_trainer"] = n
    torch.cuda.empty_cache()
    scaled, k1["launches_autoscaled_job"] = autoscaled_phase(
        torch, smi, dense["loss0"], trainer["step_ms"])
    for k, n in zip((k1, k2, k3), scaled):
        k["launches_autoscaled_trainer"] = n
    launcher_phase(torch, smi)
    torch.cuda.empty_cache()
    (k4["launches_sharded_in_process"], k4["launches_sharded_runtime"],
     k4_d256) = sharded_decoder_phase(torch, smi)
    k4.update(k4_d256)
    torch.cuda.empty_cache()
    for k, n in zip((k1, k2, k3), recovery_trainer_phase(torch, smi,
                                                         trainer)):
        k["launches_recovered_trainer"] = n
    k4["launches_recovered_replica"] = recovery_replica_phase(torch, smi)
    k4["launches_inflight_replacement"] = inflight_replica_phase(torch, smi)
    torch.cuda.empty_cache()
    for k, n in zip((k1, k2, k3), failover_phase(torch, smi, trainer)):
        k["launches_failover_holder"] = n
    k1.update(moe["fwd_profile"][0]["flash_fwd_kernel"],
              **moe["step_profile"][0]["flash_fwd_kernel"],
              launches_moe_forward=moe["forward"],
              launches_moe_step=moe["step"]["rtt_flash_fwd_bf16"],
              launches_mesh_forward=mesh["forward"],
              launches_mesh_step=mesh["rtt_flash_fwd_bf16"])
    k2.update(moe["step_profile"][0]["flash_dkdv_kernel"],
              launches_moe_step=moe["step"]["rtt_flash_dkdv_bf16"],
              launches_mesh_step=mesh["rtt_flash_dkdv_bf16"])
    k3.update(moe["step_profile"][0]["flash_dq_kernel"],
              launches_moe_step=moe["step"]["rtt_flash_dq_bf16"],
              launches_mesh_step=mesh["rtt_flash_dq_bf16"])
    k1.update(in_forward["flash_fwd_kernel"],
              **in_step["flash_fwd_kernel"], step_busy_ms=step_busy,
              launches_trainer=trainer["rtt_flash_fwd_bf16"])
    k2.update(in_step["flash_dkdv_kernel"],
              launches=train["rtt_flash_dkdv_bf16"],
              launches_trainer=trainer["rtt_flash_dkdv_bf16"])
    k3.update(in_step["flash_dq_kernel"], launches=train["rtt_flash_dq_bf16"],
              launches_trainer=trainer["rtt_flash_dq_bf16"])
    k5["launches"] = K5_PATHS.pop("train_step")
    k5.update({f"launches_{path}": n for path, n in K5_PATHS.items()})
    log(f"chip_smoke took {time.perf_counter() - t_main} s")
    k6.update({f"launches_{path}": n for path, n in K6_PATHS.items()})
    log(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
