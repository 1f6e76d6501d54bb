"""Runtime configuration flags.

TPU-native equivalent of the reference's macro-generated config struct
(reference: ``src/ray/common/ray_config_def.h:22`` — ``RAY_CONFIG(type, name,
default)``, 780 lines of flags, overridable via ``RAY_<name>`` env vars).

We keep the same two properties — one flat flag namespace, env-var override —
but as a plain dataclass: every field can be overridden with
``RAY_TPU_<FIELD_NAME>`` in the environment, and programmatically via
``ray_tpu_torch.init(_system_config={...})``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


def _env_override(name: str, default: Any) -> Any:
    raw = os.environ.get("RAY_TPU_" + name.upper())
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


@dataclasses.dataclass
class Config:
    # Objects whose serialized size is below this are carried inline inside
    # protocol messages; larger ones go to the shared-memory store.  The
    # reference cutoff is 100KB (``max_direct_call_object_size``,
    # ray_config_def.h:212); we default higher because host pipes on a TPU VM
    # comfortably move 1MB messages and shm setup has fixed cost.
    # protocheck: env-alias RAY_TPU_MAX_INLINE -- legacy spelling read directly by worker_entry
    max_inline_object_size: int = 1024 * 1024

    # Shared-memory store capacity (bytes).  0 = unlimited (bounded by
    # /dev/shm).  Mirrors plasma's store size (object_manager/plasma/).
    # protocheck: head-only -- workers get their per-node slice as RAY_TPU_STORE_BYTES (head spawn env / agent-computed cap), not this knob
    object_store_memory: int = 0

    # Directory for shared-memory segments.
    # protocheck: head-only -- workers inherit the session store path via RAY_TPU_SHM_DIR_OVERRIDE from their node's store owner
    shm_dir: str = "/dev/shm"

    # Bytes of freed-but-still-mapped shm segments kept pooled for in-place
    # reuse (plasma-arena analog: fresh tmpfs pages fault+zero at ~1 GB/s,
    # pooled pages take writes at memcpy speed).  0 disables pooling.
    # protocheck: env-alias RAY_TPU_POOL_BYTES -- legacy spelling read directly by worker_entry/node_agent
    shm_pool_bytes: int = 1 << 30

    # --- Cross-node object transfer (the data-plane fast path;
    # reference: object_manager.h:206 chunked push/pull with multiple
    # transfers in flight, object_buffer_pool.h). ---
    # Connections kept per peer object server: concurrent fetches of
    # different segments ride separate pooled connections, and one large
    # segment stripes across them.
    object_pool_size: int = 4
    # Segments at least this big are fetched as concurrent byte-range
    # stripes of this length over multiple pooled connections (needs the
    # peer's "fetch_range" capability).  0 disables striping.
    object_stripe_threshold: int = 32 * 1024 * 1024
    # Host the HEAD advertises for its object server when binding
    # 0.0.0.0 (the hostname lookup fallback can resolve to 127.0.1.1 or
    # a NAT-internal address on some distros; node agents have the same
    # escape hatch via RAY_TPU_AGENT_ADVERTISE_HOST).  "" = derive from
    # listen_host.
    # protocheck: head-only -- names the HEAD's advertised object-server host; agents have RAY_TPU_AGENT_ADVERTISE_HOST
    object_advertise_host: str = ""

    # --- Direct puts (the WRITE-direction twin of the pooled/striped
    # pull path; reference: plasma CreateObject/Seal on a dedicated
    # store socket — writes never ride a GCS RPC).  Master switch: a
    # client/worker put of a value destined for another store pushes
    # the payload over the data plane (reserve_put/put_range/commit_put
    # on the destination's object server) and sends only an O(1)
    # ("put_commit", ...) control message.  Off = the legacy whole-value
    # ("put_parts", ...) control message, byte-identical, with every
    # direct-put counter zero. ---
    direct_puts: bool = True
    # A pushed value at least this big is streamed as concurrent
    # byte-range stripes of this length over multiple pooled
    # connections (needs the peer's "put_range" capability); smaller
    # direct puts stream whole on one pooled connection.  0 disables
    # striping (whole-value streams only).
    object_put_stripe_threshold: int = 32 * 1024 * 1024
    # Connections kept per destination object server for pushes.  0 =
    # inherit object_pool_size (one sizing knob for both directions).
    object_put_pool_size: int = 0

    # --- Locality-aware scheduling (reference:
    # scheduling/policy/hybrid_scheduling_policy.cc — lease selection
    # prefers the node holding the task's argument bytes).  The default
    # policy scores candidate nodes by argument bytes homed in their
    # object store and prefers the top-locality node that fits; it never
    # stalls a class (a preferred-but-full node just falls back to the
    # head-first order, counted in ``locality_misses``).
    # protocheck: head-only -- placement scoring runs in the head scheduler only
    locality_scheduling: bool = True
    # Minimum bytes of node-homed argument data before locality overrides
    # the head-first placement order (below it, transfer is cheaper than
    # disturbing the packing).
    # protocheck: head-only -- placement scoring runs in the head scheduler only
    locality_min_bytes: int = 1024 * 1024

    # --- Pipelined argument prefetch (reference: raylets pull task
    # dependencies before the worker starts so transfer overlaps
    # compute).  While a worker computes, up to this many concurrent
    # pulls materialize the REMOTE shm args of tasks queued behind it;
    # ``_load_args`` then consumes the prefetched segments.  Also caps
    # the concurrent pulls _load_args itself issues for a multi-arg
    # task.  0 disables prefetching (args materialize serially on the
    # task's critical path, the pre-PR behavior).
    arg_prefetch_depth: int = 2

    # --- ray_tpu_torch.data streaming execution (reference:
    # python/ray/data/_internal/execution/streaming_executor.py — operator
    # graph with resource-budgeted admission). ---
    # Master switch for the backpressured operator-graph executor behind
    # Dataset._stream_refs.  Off = the pre-PR windowed chain-submission
    # path, byte-identical, with every streaming counter zero.
    streaming_executor: bool = True
    # Global in-flight byte budget for a streaming execution: queued
    # intermediate blocks + estimated in-flight task output.  0 = auto,
    # data_memory_budget_fraction of the object-store capacity (the
    # store's configured cap, else the shm filesystem size).
    data_memory_budget: int = 0
    data_memory_budget_fraction: float = 0.25
    # Cap on concurrently in-flight streaming tasks across all operators
    # (admission is primarily byte-budgeted; this bounds task/worker
    # fan-out for tiny-block datasets).  0 = auto: the cluster's total
    # CPU count (min 1, fallback 8 when it cannot be read).
    data_max_inflight_tasks: int = 0

    # --- Push-based distributed shuffle (reference: Exoshuffle
    # (SIGCOMM'23) push-based map output + Ownership (NSDI'21)
    # pipelined operators).  Master switch for the push-based
    # all-to-all shuffle behind Dataset.sort/random_shuffle and
    # GroupedDataset.aggregate/map_groups: map tasks partition rows
    # and push each partition straight into its reducer's node store
    # over the striped put verbs (reserve_put/put_range/commit_put),
    # reducers merge on arrival.  Off = the pre-PR map/reduce fan-out,
    # byte-identical, with every shuffle counter zero.  Read in the
    # WORKER process (map tasks + reducer actors), so it rides
    # _worker_config_env. ---
    push_shuffle: bool = True
    # Target bytes per shuffle partition for sort/groupby: the planner
    # picks the reducer count R ~ total_bytes / target (clamped to
    # [1, 4 * n_blocks]).  0 = one reducer per input block (R =
    # n_blocks), which random_shuffle always uses so its seeded
    # permutation is reproducible across the switch.
    shuffle_partition_bytes_target: int = 0
    # Streaming-merge fan-in for sort reducers: once at least this many
    # sorted runs have arrived, the reducer k-way merges them into one
    # (heapq.merge, stable on (map_idx, pos) ties) so memory tracks the
    # run count, not the input count.  Also bounds the merge at
    # finalize.  Minimum 2.
    shuffle_merge_fanin: int = 8

    # --- Distributed training (reference: PipeDream SOSP'19 1F1B +
    # IMPALA ICML'18 decoupled actor/learner).  Master switch for the
    # distributed training planes: pipeline stages as long-lived
    # restartable actors exchanging micro-batch activations/grads over
    # the striped put verbs with the 1F1B schedule driven by the actor
    # call pipeline (train/pipeline_actors.py), and IMPALA's aggregator
    # actors + host->TPU double-buffered learner queue (rllib/impala.py).
    # Off = the byte-identical single-host paths (pipeline_apply in one
    # process, the per-batch direct learner update) with every new
    # counter (microbatch_pushes / stage_restarts / learner_queue_stalls)
    # zero.  Read in WORKER processes too (stage actors push; a trainer
    # built inside a Trainable must see the driver's switch), so it
    # rides _worker_config_env. ---
    distributed_training: bool = True
    # Default micro-batch count for PipelineTrainer when the caller does
    # not pass one: 0 = 2 * num_stages (the 1F1B sweet spot — enough
    # in-flight microbatches to hide the pp-1 fill, bounded stash).
    pipeline_microbatches: int = 0
    # Host->device queue depth for IMPALA's learner loader thread (the
    # MultiGPULearnerThread analog): batch t+1's h2d transfer is issued
    # while step t computes, up to this many device-resident batches
    # buffered ahead.  0 disables the loader thread (each update pays
    # its own h2d on the critical path — the measured A/B baseline).
    impala_queue_depth: int = 2

    # --- Decentralized dispatch (reference: the raylet's lease-based
    # hybrid scheduling, RequestWorkerLease + spillback in
    # local_task_manager.h:58, with task metadata owned by the submitting
    # worker — Ownership, NSDI'21).  Master switch for the lease-grant
    # scheduling plane: bulk lease grants piggybacked on head-brokered
    # submit bursts, holder-side renewal batching, executor spillback,
    # lease revocation on node death, and the head's sharded/deferred
    # dispatch passes.  Off = the pre-existing head-brokered path,
    # byte-identical, with every decentralized-dispatch counter zero. ---
    decentralized_dispatch: bool = True
    # Execution slots per granted lease: the holder pipelines at most this
    # many unacked pushes onto one leased worker (capped by
    # max_tasks_in_flight_per_worker at grant time).
    lease_slots: int = 8
    # Lease time-to-live: the head revokes (and retires) a client-leased
    # worker whose holder has not renewed within this window — the
    # holder's liveness signal, since pushed tasks never touch the head.
    # 0 disables TTL expiry (leases then end only via return/death).
    lease_ttl_s: float = 15.0
    # Holder-side renewal cadence: one ("lease_renew", ...) message per
    # this many leased pushes (plus a periodic renew for long tasks) —
    # the "one message per N tasks" amortization.
    lease_renew_tasks: int = 64
    # Executor-side spillback: a pushed (spill-eligible) task arriving
    # while the worker's local queue is at least this deep bounces back
    # to the holder with a next-best-node hint instead of queueing
    # (reference: hybrid policy spillback).  0 disables spillback.
    lease_spillback_depth: int = 32

    # --- Serving (ray_tpu_torch.serve; reference: Orca OSDI'22 iteration-level
    # scheduling + serve autoscaling_policy.py). ---
    # Master switch for the continuous-batching engine behind
    # @serve.batch(mode="continuous"): on, queued requests are admitted
    # into the RUNNING batch at step boundaries and finished requests'
    # slots refill the same step.  Off = the same step function driven
    # one-shot (fixed batch admitted only when the previous one fully
    # finished — the legacy window semantics), the measured A/B
    # baseline.  Read in the REPLICA process (rides _worker_config_env).
    continuous_batching: bool = True
    # --- Serving memory plane (reference: vLLM PagedAttention SOSP'23 +
    # Leviathan et al. ICML'23 speculative decoding). ---
    # Master switch for the paged KV cache: a deployment that attaches a
    # kv_cache.PagedKVEngine gets block-granular admission (a request is
    # admitted when its KV BLOCKS fit, not a max-length slot) and the
    # paged decode mode in replicas that support it
    # (serve/tpu_replica.py).  Off = the byte-identical dense
    # engine: the attached engine is ignored, every serving-memory
    # counter (kv_blocks_* / prefix_* / spec_* / cow_copies) stays zero.
    # Read in the REPLICA process (rides _worker_config_env).
    paged_kv: bool = False
    # Shared-prefix reuse on the paged cache: prompt-prefix-hash keyed
    # block chains with refcounts and copy-on-write divergence; requests
    # sharing a system prompt map the same physical blocks.  Only
    # meaningful with paged_kv on.
    prefix_caching: bool = True
    # Speculative decoding: a draft model proposes this many tokens per
    # step and the target verifies them in one batched forward
    # (exact-match acceptance keeps greedy output bitwise-unchanged).
    # 0 disables.  Only meaningful with paged_kv on, read by replicas
    # that implement a draft path.
    speculative_k: int = 0
    # Autoscale smoothing: the controller scales on each handle's PEAK
    # ongoing-request count inside this look-back window.
    serve_metric_lookback_s: float = 3.0
    # Default quiet period before a deployment downscales (an explicit
    # autoscaling_config downscale_delay_s overrides it per deployment).
    serve_downscale_delay_s: float = 5.0
    # --- Disaggregated serving (reference: DistServe OSDI'24 /
    # Splitwise ISCA'24). ---
    # Master switch for the prefill/decode pool split: a capable
    # deployment (replicas exporting prefill_export / disagg_generate)
    # is deployed as two pools behind one logical name — prefill
    # replicas run prompt-only steps and hand the finished KV block
    # chain to a decode replica as a segment image streamed over the
    # reserve_put/put_range data plane.  Off = the byte-identical
    # monolithic engine: one pool, prefill interleaved with decode,
    # every disaggregation counter (kv_chains_* /
    # kv_chain_bytes_streamed / router_prefix_*) stays zero.  Read in
    # the REPLICA and PROXY processes (rides _worker_config_env).
    disaggregated_serving: bool = False
    # Stripe threshold for streamed KV chains: a chain segment larger
    # than this is striped across put-pool connections (put_range),
    # smaller ones go single-stream.  Chains are typically much larger
    # than generic task args, so this defaults lower than
    # object_put_stripe_threshold.  Read wherever a prefill replica
    # pushes (rides _worker_config_env).
    kv_stream_stripe_threshold: int = 1 << 18
    # Prefix-affinity routing on top of power-of-two-choices: handles
    # score prefill replicas by the longest prompt-chunk chain they
    # recently served (route to where the PrefixCache already holds the
    # blocks; p2c on miss).  Only meaningful with
    # disaggregated_serving on — all router_prefix_* counters stay
    # zero when the split is off.
    prefix_affinity: bool = True

    # Seconds a worker may sit idle before the pool reaps it (reference:
    # idle worker killing in worker_pool.cc).
    # protocheck: head-only -- the idle-worker reaper runs in the head's pool
    idle_worker_timeout_s: float = 300.0

    # Soft cap on extra workers spawned when existing workers block in
    # ``ray.get`` (reference: worker cap w/ backoff, ray_config_def.h:174-187).
    # protocheck: head-only -- blocked-worker cap enforced by the head's spawn path
    max_extra_blocked_workers: int = 16

    # Task retry default (reference: max_retries=3 for normal tasks).
    # protocheck: head-only -- retry budgets are seeded at head registration (direct-path specs carry explicit max_retries)
    default_max_retries: int = 3

    # Tasks pipelined onto one leased worker before a new worker is leased
    # (reference: max_tasks_in_flight_per_worker in
    # direct_task_transport.h:75 — kills the per-task result round trip).
    # protocheck: head-only -- the pipeline bound is applied at grant time; holders receive it as the grant's slots field
    max_tasks_in_flight_per_worker: int = 10

    # --- Failure detection (gray failures: alive-but-hung peers;
    # reference: per-RPC gRPC deadlines + GcsHealthCheckManager with
    # health_check_initial_delay_ms / timeout / period /
    # failure_threshold in ray_config_def.h; "Gray Failure: The
    # Achilles' Heel of Cloud-Scale Systems", HotOS'17 — differential
    # observation, peer-observed stalls rather than process liveness).
    # Master switch for the whole plane: deadlines on every wire
    # operation (connect timeouts + SO_KEEPALIVE on every dial,
    # zero-progress stall deadlines on transfers with
    # progress-resets-the-clock semantics, transport retries with
    # backoff+jitter), worker/agent heartbeat floors, the head's
    # suspicion state machine (SUSPECT -> probe -> DEAD), and the
    # direct-channel liveness probes.  Off = the legacy fully-blocking
    # behavior, byte-identical, with every new counter
    # (stall_timeouts / net_retries / hedged_fetches / suspected_nodes)
    # zero. ---
    failure_detection: bool = True
    # Zero-progress deadline for one wire operation: a transfer that
    # moves no bytes for this long is declared stalled (each received/
    # sent chunk resets the clock, so a slow-but-moving stripe is never
    # killed while a fully stalled one dies right here).  Also bounds
    # reply waits on request/reply exchanges and the direct-channel
    # liveness probe window.
    net_stall_timeout_s: float = 15.0
    # Connect timeout for every dial (object-transfer pools, direct
    # channels, client/agent/worker head dials).  Without it a dial to
    # a black-holed address blocks for the kernel default (~2 min).
    net_connect_timeout_s: float = 5.0
    # Transport-level retry budget for one stalled/broken pull or push:
    # the broken pooled connection is evicted and the transfer retried
    # up to this many times before the loss surfaces as a structured
    # (reconstructable) ObjectLostError(phase="stalled") and the caller
    # hedges to the relay/reconstruction fallbacks.
    net_retry_count: int = 2
    # Base backoff between transport retries; attempt k sleeps
    # base * 2^k plus up to 50% random jitter.
    net_retry_backoff_base_ms: float = 50.0
    # Health-check cadence (reference: GCS pull-based health checks,
    # gcs_health_check_manager.h:39): the head's suspicion loop ticks at
    # this period, and it is the worker/agent heartbeat floor — a peer
    # with no other head traffic sends one ("heartbeat", ...) per
    # period, so silence is a signal, not an idle link.
    health_check_period_s: float = 5.0
    # Silence (no message from a node's agent / a worker) longer than
    # this marks the peer SUSPECT and starts probing it.
    health_check_timeout_s: float = 15.0
    # A SUSPECT peer that misses this many consecutive probe windows is
    # declared DEAD and fed to the existing node/worker-death path —
    # a stalled node becomes indistinguishable from a killed one within
    # one suspicion window.
    health_check_failure_threshold: int = 3
    # Grace added to a freshly registered peer's first deadline (boot,
    # env build, and JIT warmup all legitimately delay the first
    # heartbeat).
    health_check_initial_delay_s: float = 10.0

    # Wait this long for a worker process to start before declaring failure.
    # protocheck: head-only -- spawn timeout enforced by the head
    worker_start_timeout_s: float = 60.0

    # Number of workers prestarted at init when num_cpus not yet demanded
    # (reference: prestart in worker_pool.cc).
    # protocheck: head-only -- prestart happens at head init
    prestart_workers: int = 0

    # Multiprocessing start method: "forkserver" is fastest that is still
    # safe with JAX in the driver ("fork" is not — XLA runtime threads).
    # protocheck: head-only -- consumed by the head's process spawner
    worker_start_method: str = "forkserver"

    # --- Fault tolerance (reference: object_recovery_manager.h:41 +
    # task_manager.h:174 lineage pinning; Ownership, NSDI'21). ---
    # Master switch for the recovery subsystem: lineage recording +
    # object reconstruction (head-owned AND worker-owned), actor
    # state-checkpoint hooks, and the recovery counters.  Off = a lost
    # object surfaces ObjectLostError exactly as the legacy path did,
    # with reconstructions / reconstruction_failures / actor_restarts /
    # chaos_kills all zero.
    recovery: bool = True
    # Lineage-based object reconstruction: keep creating-task specs for
    # owned task returns; a lost object is rebuilt by re-executing its
    # task.  (Legacy escape hatch; ``recovery`` is the master switch.)
    lineage_enabled: bool = True
    # Byte budget for each owner's retained lineage (the head's table
    # and every worker's DirectCaller table independently): entries
    # evict oldest-first past it, mirroring the reference's
    # lineage-pinning cap (max_lineage_bytes).  Evicted lineage makes
    # the objects unrecoverable — recovery then refuses, it never
    # guesses.  0 = unbounded.
    lineage_bytes_budget: int = 64 * 1024 * 1024
    # Restartable actors: minimum seconds between automatic
    # __ray_save__ checkpoints of an actor that defines the hooks
    # (checkpoint bytes go through the object store, spill-aware).
    # 0 = checkpoint after every method call.
    actor_checkpoint_interval_s: float = 0.0

    # Where over-capacity shm objects spill (reference:
    # local_object_manager.h:41 spill to external storage).  Empty =
    # /tmp/ray_tpu_spill_<session>.
    # protocheck: head-only -- workers/agents get the session-resolved path via RAY_TPU_SPILL_DIR_OVERRIDE
    spill_dir: str = ""

    # Host the head's TCP listener binds (node agents + their workers dial
    # in here).  Use "0.0.0.0" for real multi-host clusters.
    # protocheck: head-only -- the head's own listener bind address
    listen_host: str = "127.0.0.1"

    # --- GCS-analog fault tolerance (reference: GCS table persistence via
    # redis, src/ray/gcs/store_client/redis_store_client.h:28, and the
    # GcsInitData load-on-restart path, gcs_server.h:77). ---
    # Snapshot file for head metadata (KV, functions, named actors, jobs).
    # "" disables snapshotting.
    # protocheck: head-only -- head snapshot machinery
    gcs_snapshot_path: str = ""
    # Snapshot cadence; dirty state is written at most this often.
    # protocheck: head-only -- head snapshot machinery
    gcs_snapshot_interval_s: float = 2.0
    # Load the snapshot at init (head restart): restores KV/functions and
    # re-creates named actors per their creation specs.
    # protocheck: head-only -- head restart restore switch
    gcs_restore: bool = False
    # Fixed TCP listener port (0 = ephemeral).  A restarting head must
    # rebind the old port so agents and clients can re-dial it.
    # protocheck: head-only -- the head's own listener port
    listen_port: int = 0
    # Fixed cluster authkey (hex; "" = random per session).  Needed across
    # head restarts so agents/clients can re-authenticate.
    # protocheck: head-only -- session authkey reaches workers as RAY_TPU_AUTHKEY in the spawn env
    authkey_hex: str = ""

    # --- Head failover (reference: workers reconnecting across a GCS
    # restart — gcs_rpc_server_reconnect_timeout_s /
    # gcs_failover_worker_reconnect_timeout, ray_config_def.h:62 — plus
    # per-owner metadata surviving the metadata server, Ownership
    # NSDI'21). ---
    # Master switch: on head-connection EOF, workers and clients PARK
    # in-flight head calls, re-dial with backoff, and re-register
    # (re-advertising owned objects, held leases, queued/running tasks,
    # and actor incarnations); node agents keep their workers ALIVE and
    # re-dial.  Off = today's behavior: a worker exits on head EOF and
    # an agent tears its workers down, so a head death is an outage.
    head_failover: bool = True
    # How long a disconnected peer (worker/client/agent) keeps re-dialing
    # the head before giving up — the failover grace window.  A peer that
    # exhausts it behaves as with the switch off (worker exit / agent
    # teardown); the head revokes whatever it was holding.
    head_reconnect_grace_s: float = 20.0
    # How long a RESTARTED head waits for restored nodes, leases, and
    # actor incarnations to be re-claimed by reconnecting peers before
    # reconciling the remainder: unclaimed leases are revoked (the
    # revocation path), unclaimed restored actors are re-created from their last
    # __ray_save__ checkpoint, and unresolved blip-window objects fail
    # as reconstruction candidates.
    head_reregister_timeout_s: float = 10.0
    # Node agents re-dial a restarted head instead of exiting ("0"
    # disables — the previously-undocumented escape hatch, now paired
    # with head_failover: with failover on a reconnecting agent keeps
    # its workers; with it off it kills them first, the legacy
    # behavior).
    # protocheck: head-only -- agent-process knob, read from the agent's own environment (launcher/operator-set)
    agent_reconnect: bool = True

    # --- Elastic pods (preemption-aware drain + spot slice pools;
    # reference: the GCS DrainNode RPC + raylet drain,
    # gcs_node_manager.h / node_manager.cc HandleDrainRaylet — node
    # removal as a first-class protocol rather than a death). ---
    # Master switch for the drain protocol: scale-down and preemption
    # notices route through ``Runtime.drain_node`` (stop placements,
    # revoke leases, force-checkpoint restartable actors to a surviving
    # store, migrate small sole-copy objects) before the node goes
    # away.  Off = the legacy hard-remove path, byte-identical, with
    # every elastic counter (preemptions / drains_completed /
    # drain_timeouts / objects_migrated) zero.
    elastic_drain: bool = True
    # Wall-clock budget for one node drain (the spot warning window —
    # e.g. ~30s on GCE preemptible TPUs).  Past it the drain falls
    # through to the existing hard-kill recovery: lineage reconstructs
    # what migration did not cover.
    drain_deadline_s: float = 10.0
    # Sole-copy objects homed on a draining node at most this big are
    # migrated (pulled and re-homed on the head's surviving store);
    # larger ones stay behind as lineage-reconstruction candidates —
    # re-executing the producer beats moving a multi-GB value through
    # a closing warning window.
    drain_migrate_max_bytes: int = 64 * 1024 * 1024
    # Spot pool fallback: after this many observed preemptions of one
    # spot node type, the autoscaler stops preferring that type and
    # launches its on-demand fallback instead (per-type accounting in
    # StandardAutoscaler).
    spot_fallback_threshold: int = 2

    # --- OOM memory monitor (reference: src/ray/common/memory_monitor.h
    # + worker_killing_policy_group_by_owner.cc: kill the newest
    # retriable task's worker before the kernel OOM-killer takes the
    # node). ---
    # Node memory usage fraction above which the monitor kills one task
    # worker per interval.  0 disables.
    # protocheck: head-only -- monitor knobs reach node agents in the agent_ack config dict
    memory_monitor_threshold: float = 0.95
    # protocheck: head-only -- monitor knobs reach node agents in the agent_ack config dict
    memory_monitor_interval_s: float = 1.0
    # Test hook: read the usage fraction from this file instead of
    # /proc/meminfo (reference tests inject usage the same way).
    # protocheck: head-only -- monitor knobs reach node agents in the agent_ack config dict
    memory_monitor_test_file: str = ""

    # Stream worker stdout/stderr to the driver with a worker prefix
    # (reference: log_monitor.py + log_to_driver in ray.init).  Worker
    # output always lands in per-worker files under the session dir;
    # this flag controls the re-print at the driver.
    # protocheck: head-only -- the re-print of worker logs happens in the head's monitor thread
    log_to_driver: bool = True

    @classmethod
    def from_env(cls, overrides: dict | None = None) -> "Config":
        kwargs = {}
        for f in dataclasses.fields(cls):
            kwargs[f.name] = _env_override(f.name, f.default)
        if overrides:
            for k, v in overrides.items():
                if k not in kwargs:
                    raise ValueError(f"Unknown config flag: {k}")
                kwargs[k] = v
        return cls(**kwargs)


GLOBAL_CONFIG = Config.from_env()
