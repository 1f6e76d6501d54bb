"""Autoscaler tests against the in-process slice provider: the
reference's ``tests/test_autoscaler.py`` cases run against the port's
copy of ``autoscaler`` (its agents are the port's), unchanged but for the
package and ``CUDA_VISIBLE_DEVICES`` in place of ``TPU_VISIBLE_CHIPS``;
plus a CPU rehearsal of chip_smoke's phase 19 (the autoscaler's own loop
brings a card node up for a trainer's worker and drains it when idle).

Reference pattern: ``python/ray/tests/test_autoscaler_fake_multinode.py``
— scale-up from queued infeasible demand and idle scale-down run with no
cloud, against FakeMultiNodeProvider (node_provider.py:237); here each
launched node is a REAL node_agent subprocess.
"""

import time

import pytest

import ray_tpu_torch as ray
from ray_tpu_torch.autoscaler import FakeSliceProvider, StandardAutoscaler
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture
def cluster():
    c = Cluster(head_num_cpus=2)
    yield c
    c.shutdown()


def test_scale_up_for_infeasible_tpu_tasks_and_scale_down(cluster):
    provider = FakeSliceProvider(cluster, {
        "v5e-4": {"resources": {"CPU": 4, "TPU": 4}, "max_workers": 2},
    })
    scaler = StandardAutoscaler(cluster.rt, provider, idle_timeout_s=3.0)

    @ray.remote(num_tpus=4)
    def on_slice():
        import os

        return os.environ.get("CUDA_VISIBLE_DEVICES", "")

    # Infeasible now: the head has no TPU resource at all.
    refs = [on_slice.remote() for _ in range(2)]
    time.sleep(0.2)
    report = scaler.update()
    # slice-atomic: both 4-chip tasks fit one v5e-4 node sequentially, but
    # the packer sees 2 concurrent shapes of TPU:4 -> 2 slices (cap 2)
    assert len(report["launched"]) == 2, report
    chips = ray.get(refs, timeout=120)
    assert all(c == "0,1,2,3" for c in chips)

    # idle: after the timeout both slices terminate (never the head)
    deadline = time.monotonic() + 30
    gone = []
    while time.monotonic() < deadline:
        gone += scaler.update()["terminated"]
        if len(gone) == 2:
            break
        time.sleep(0.5)
    assert len(gone) == 2, f"idle slices not terminated: {gone}"
    # Scale-down drains off-thread (elastic pods): the agents exit at
    # the drain's conclusion, moments after the report.
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        alive = [n for n in cluster.rt.list_nodes() if n["alive"]]
        if len(alive) == 1:  # the head
            break
        time.sleep(0.2)
    assert len(alive) == 1, alive


def test_no_scale_up_when_demand_fits(cluster):
    provider = FakeSliceProvider(cluster, {
        "cpu-2": {"resources": {"CPU": 2}, "max_workers": 4},
    })
    scaler = StandardAutoscaler(cluster.rt, provider)

    @ray.remote
    def f():
        return 1

    # Head has 2 CPUs: a couple of 1-CPU tasks fit; no launch.
    refs = [f.remote() for _ in range(2)]
    report = scaler.update()
    assert report["launched"] == []
    assert ray.get(refs, timeout=60) == [1, 1]


def test_launch_capped_by_max_workers(cluster):
    provider = FakeSliceProvider(cluster, {
        "cpu-1": {"resources": {"CPU": 1}, "max_workers": 1},
    })
    scaler = StandardAutoscaler(cluster.rt, provider)

    @ray.remote(resources={"special": 1})
    def g():
        return "ok"

    # "special" exists nowhere and on no node type: never launches.
    ref = g.remote()
    report = scaler.update()
    assert report["launched"] == []
    ray.cancel(ref)


class _StubRuntime:
    """Just the surface StandardAutoscaler programs against, with
    scripted demand/activity — the pending-launch and spot-fallback
    logic needs no real agents."""

    def __init__(self):
        self.demand = []
        self.nodes = [{"node_id": "head", "alive": True, "is_head": True,
                       "busy": False, "draining": False,
                       "resources": {"CPU": 1}, "available": {"CPU": 1}}]

    def pending_resource_demand(self):
        return [dict(s) for s in self.demand]

    def node_activity(self):
        return [dict(n) for n in self.nodes]

    def add_alive(self, nid, resources):
        self.nodes.append({"node_id": nid, "alive": True, "is_head": False,
                           "busy": False, "draining": False,
                           "resources": dict(resources),
                           "available": dict(resources)})

    def kill(self, nid):
        self.nodes = [n for n in self.nodes if n["node_id"] != nid]


class _StubProvider:
    """Provider whose nodes never register on their own: launches stay
    pending until the test 'boots' them against the stub runtime."""

    def __init__(self, node_types):
        self.node_types = node_types
        self._seq = 0
        self._nodes = {}
        self.created = []

    def create_node(self, node_type):
        self._seq += 1
        nid = f"{node_type}-{self._seq}"
        self._nodes[nid] = node_type
        self.created.append(nid)
        return nid

    def terminate_node(self, node_id):
        self._nodes.pop(node_id, None)

    def non_terminated_nodes(self):
        return list(self._nodes)

    def node_type_of(self, node_id):
        return self._nodes.get(node_id)

    def node_resources(self, t):
        return dict(self.node_types[t]["resources"])

    def max_workers(self, t):
        return int(self.node_types[t].get("max_workers", 10))

    def is_spot(self, t):
        return bool(self.node_types[t].get("spot", False))


def test_pending_launch_timeout_reissues_without_double_count():
    """A launch that never registers is re-issued after
    _launch_timeout_s — and while pending it counts against caps and
    capacity, so the same demand is never double-launched meanwhile."""
    rt = _StubRuntime()
    provider = _StubProvider({
        "cpu-2": {"resources": {"CPU": 2}, "max_workers": 1},
    })
    scaler = StandardAutoscaler(rt, provider)
    scaler._launch_timeout_s = 0.3
    rt.demand = [{"CPU": 2}]
    report = scaler.update()
    assert len(report["launched"]) == 1
    # Pending (not yet registered, not yet timed out): the launch holds
    # the demand AND the max_workers=1 cap — no second node.
    assert scaler.update()["launched"] == []
    assert scaler.update()["launched"] == []
    assert len(provider.created) == 1
    time.sleep(0.35)
    # Timed out: the phantom stops counting and the demand is re-planned
    # — exactly one replacement launch (the cap still binds).
    report = scaler.update()
    assert len(report["launched"]) == 1
    assert len(provider.created) == 2
    # The replacement is itself pending now: still no third.
    assert scaler.update()["launched"] == []


def test_spot_preferred_then_fallback_after_preemptions():
    """Spot node types win ties while healthy; after
    spot_fallback_threshold observed preemptions of the type the
    planner launches the on-demand peer instead (per-type
    accounting)."""
    rt = _StubRuntime()
    provider = _StubProvider({
        # dict order puts spot first anyway — the ranking, not luck, is
        # what the fallback half of the test pins.
        "ondemand-2": {"resources": {"CPU": 2}, "max_workers": 8},
        "spot-2": {"resources": {"CPU": 2}, "max_workers": 8,
                   "spot": True},
    })
    scaler = StandardAutoscaler(rt, provider, spot_fallback_threshold=2)
    for round_no in range(2):
        rt.demand = [{"CPU": 2}]
        (nid,) = scaler.update()["launched"]
        assert nid.startswith("spot-2"), (round_no, nid)
        # Register it, then yank it without terminate: a preemption.
        rt.add_alive(nid, {"CPU": 2})
        rt.demand = []
        scaler.update()  # sees it alive; pending clears
        rt.kill(nid)
        scaler.update()  # sees it gone: counted + cleaned up
    assert scaler.stats()["preemptions_by_type"] == {"spot-2": 2}
    # Threshold reached: same demand now lands on-demand.
    rt.demand = [{"CPU": 2}]
    (nid,) = scaler.update()["launched"]
    assert nid.startswith("ondemand-2"), nid


def test_monitor_loop_counts_errors_instead_of_swallowing():
    """The background loop's failure path: errors are counted and
    rate-limit-logged (autoscaler_errors), never silently dropped, and
    the loop survives to keep reconciling."""
    rt = _StubRuntime()

    class _BrokenProvider(_StubProvider):
        def non_terminated_nodes(self):
            raise RuntimeError("cloud API down")

    scaler = StandardAutoscaler(
        rt, _BrokenProvider({"cpu-2": {"resources": {"CPU": 2}}}),
        update_interval_s=0.05)
    rt.demand = [{"CPU": 2}]
    scaler.start()
    try:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline \
                and scaler.stats()["autoscaler_errors"] < 2:
            time.sleep(0.05)
        # >= 2: the loop survived its own error and kept ticking.
        assert scaler.stats()["autoscaler_errors"] >= 2
    finally:
        scaler.stop()


def test_loop_brings_a_card_node_up_for_a_trainer_and_drains_it(
        monkeypatch):
    """CPU rehearsal of chip_smoke's phase 19: the head holds no card; a
    ``tpu_chips_per_worker=1`` trainer's placement group is demand the
    autoscaler's own loop (``start()``, not stepped by hand) meets by
    launching the one-card node type; the worker runs there with the
    node's card and a tiny model on ``device="cpu"``; idle past the
    timeout the node is drained and terminated, its agent gone."""
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import DataParallelTrainer, TorchConfig

    class Recording(FakeSliceProvider):
        launched = []

        def create_node(self, node_type):
            nid = super().create_node(node_type)
            self.launched.append((nid, self._cluster._agents[nid]))
            return nid

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    c = Cluster(head_num_cpus=2)
    scaler = None
    try:
        provider = Recording(c, {
            "h100-1": {"resources": {"CPU": 2, "TPU": 1},
                       "max_workers": 1}})
        scaler = StandardAutoscaler(c.rt, provider, idle_timeout_s=1.0,
                                    update_interval_s=0.2)
        scaler.start()

        def loop(config):  # by value: the node's workers cannot import tests/
            import os

            import torch

            import ray_tpu_torch
            from ray_tpu_torch.air import session
            from ray_tpu_torch.models import LlamaConfig
            from ray_tpu_torch.train import (
                default_optimizer, init_train_state, make_train_step)

            cfg = LlamaConfig.tiny()
            opt = default_optimizer(lr=1e-3, warmup=2, decay_steps=100)
            dev = torch.device("cpu")
            state = init_train_state(
                cfg, opt, torch.Generator().manual_seed(0), dev)
            batch = {"tokens": torch.randint(
                0, cfg.vocab_size, (2, 17),
                generator=torch.Generator().manual_seed(1))}
            step = make_train_step(cfg, opt)
            for _ in range(2):
                state, m = step(state, batch)
                session.report({
                    "loss": float(m["loss"]),
                    "cvd": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "node": ray_tpu_torch.get_runtime_context().node_id})

        result = DataParallelTrainer(
            loop, backend_config=TorchConfig(distributed=False),
            scaling_config=ScalingConfig(
                num_workers=1, tpu_chips_per_worker=1)).fit()
        assert result.error is None, result.error
        ((nid, agent),) = provider.launched
        hist = result.metrics_history
        assert len(hist) == 2 and all(h["node"] == nid and h["cvd"] == "0"
                                      for h in hist), hist
        assert all(h["loss"] == h["loss"] for h in hist)  # finite, not NaN
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and sum(
                n["alive"] for n in c.rt.list_nodes()) > 1:
            time.sleep(0.2)
        assert [n["is_head"] for n in c.rt.node_activity()
                if n["alive"]] == [True]
        # The node leaves non_terminated_nodes() once the head marks it
        # dead, before terminate_node's Cluster.remove_node has seen its
        # agent exit (it waits up to 5 s, then kills it): wait for both.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (
                provider.non_terminated_nodes() or agent.poll() is None):
            time.sleep(0.1)
        assert provider.non_terminated_nodes() == []
        assert agent.poll() is not None
        assert scaler.stats()["autoscaler_errors"] == 0
    finally:
        if scaler is not None:
            scaler.stop()
        c.shutdown()
