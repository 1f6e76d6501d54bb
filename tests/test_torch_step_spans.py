"""The port's in-process tracer (``ray_tpu_torch.util.tracing``): spans,
counters and lifecycle phases, and where the train step, the MoE layer and
the runtime record them.  On the CPU: device seconds are None here."""

import socket
import time

import pytest
import torch

from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.ops import _build, moe
from ray_tpu_torch.train import (
    default_optimizer, init_train_state, make_train_step)
from ray_tpu_torch.util import tracing

TRAIN = ("train.forward", "train.backward", "train.grad_sync",
         "train.optimizer")
MOE = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _steps(cfg, n, rows=2):
    opt = default_optimizer()
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                             "cpu")
    step = make_train_step(cfg, opt)
    tokens = torch.randint(0, cfg.vocab_size, (rows, 17),
                           generator=torch.Generator().manual_seed(1))
    for _ in range(n):
        state, _ = step(state, {"tokens": tokens})
    return rows * 16


def test_off_records_nothing_and_returns_the_shared_noop():
    assert tracing.span("a") is tracing.span("b")
    assert tracing.remat_kwargs() == {}
    assert not tracing.counting()
    _steps(LlamaConfig.tiny(num_experts=4, remat=True), 1)
    tracing.count("c", 3)
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}


def test_spans_nest_on_the_host_and_in_the_profiler():
    tracing.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                time.sleep(0.01)
            time.sleep(0.01)
    spans = tracing.snapshot()["spans"]
    assert spans["outer"]["count"] == spans["inner"]["count"] == 1
    assert spans["outer"]["host_s"] >= spans["inner"]["host_s"] + 0.01
    assert spans["inner"]["host_s"] >= 0.01
    assert spans["outer"]["device_s"] is None
    assert spans["outer"]["first_start"] <= spans["inner"]["first_start"]
    assert spans["inner"]["last_end"] <= spans["outer"]["last_end"]
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name in ("outer", "inner")}
    assert ranges["outer"].start <= ranges["inner"].start
    assert ranges["inner"].end <= ranges["outer"].end


@pytest.mark.parametrize("profiled", [False, True])
def test_a_span_closes_on_an_exception(profiled):
    tracing.enable()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    if profiled:
        prof.__enter__()
    with pytest.raises(ValueError):
        with tracing.span("boom"):
            raise ValueError("stop")
    with tracing.span("after"):
        pass
    if profiled:
        prof.__exit__(None, None, None)
        names = [e.name for e in prof.events()]
        assert names.count("boom") == names.count("after") == 1
    spans = tracing.snapshot()["spans"]
    assert spans["boom"]["count"] == spans["after"]["count"] == 1


def test_counters_add_tensors_where_they_live_without_a_sync(monkeypatch):
    tracing.enable()

    def no_sync(self):
        raise AssertionError("count() read a tensor")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "item", no_sync)
        for v in (torch.tensor(2), torch.tensor(3), 4):
            tracing.count("mixed", v)
        tracing.count("plain", 1.5)
        tracing.count("plain", 2)
    counters = tracing.snapshot()["counters"]
    assert counters == {"mixed": 9, "plain": 3.5}


@pytest.mark.parametrize("group", [False, True])
def test_each_train_span_once_a_step(group):
    if group:
        import torch.distributed as dist

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0)
    try:
        tracing.enable()
        _steps(LlamaConfig.tiny(num_experts=4), 3)
    finally:
        if group:
            dist.destroy_process_group()
    spans = tracing.snapshot()["spans"]
    assert {n: spans[n]["count"] for n in TRAIN} == dict.fromkeys(TRAIN, 3)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_spans_per_layer_and_counters_once_a_batch(remat):
    cfg = LlamaConfig.tiny(num_experts=4, remat=remat)
    _build.reset_launches()
    tracing.enable()
    tokens = _steps(cfg, 2)
    snap = tracing.snapshot()
    passes = 2 if remat else 1      # the forward, and its recompute
    assert {n: snap["spans"][n]["count"] for n in MOE} == dict.fromkeys(
        MOE, 2 * cfg.num_layers * passes)
    capacity = max(1, int(cfg.capacity_factor * tokens * cfg.num_selected
                          / cfg.num_experts))
    c = snap["counters"]
    assert c["moe.assignments"] == 2 * cfg.num_layers * tokens \
        * cfg.num_selected
    assert c["moe.slots"] == 2 * cfg.num_layers * cfg.num_experts * capacity
    assert 0 < c["moe.kept"] <= min(c["moe.assignments"], c["moe.slots"])
    # The CPU takes the plain gathers: nothing went through K6.
    assert not _build.launches["rtt_moe_gather"]
    assert not _build.launches["rtt_moe_combine"]


@pytest.mark.gpu
def test_every_assignment_goes_through_k6_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest -m gpu "
                    "tests/test_torch_step_spans.py on the H100)")
    cfg = LlamaConfig.tiny(num_experts=4, remat=True)
    opt = default_optimizer()
    state = init_train_state(cfg, opt, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
    step = make_train_step(cfg, opt)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17), device="cuda")
    _build.reset_launches()
    tracing.enable()
    state, _ = step(state, {"tokens": tokens})
    c = tracing.snapshot()["counters"]
    assert c["moe.assignments"] == cfg.num_layers * 2 * 16 * cfg.num_selected
    # A layer's forward and its recompute dispatch and combine, and the
    # backward runs each one's gather once.
    assert _build.launches["rtt_moe_gather"] == 3 * cfg.num_layers
    assert _build.launches["rtt_moe_combine"] == 3 * cfg.num_layers


def test_dense_model_records_no_moe_span_or_counter():
    cfg = LlamaConfig.tiny(remat=True)
    _build.reset_launches()
    tracing.enable()
    _steps(cfg, 1)
    snap = tracing.snapshot()
    assert not [n for n in snap["spans"] if n.startswith("moe.")]
    assert snap["counters"] == {}
    # The CPU takes the plain optimizer: nothing went through K5.
    assert not _build.launches["rtt_optim_sumsq"]
    assert not _build.launches["rtt_optim_adamw"]
    assert all(snap["spans"][n]["count"] == 1 for n in TRAIN)


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 5), (2, 64)])
def test_kept_is_what_assign_slots_keeps(k, capacity):
    logits = torch.randn(32, 4, generator=torch.Generator().manual_seed(k))
    tracing.enable()
    disp, _, _ = moe.route_topk(logits, k, capacity)
    c = tracing.snapshot()["counters"]
    # The dispatch holds a 1 at each assignment within capacity.
    assert c["moe.kept"] == int(disp.sum())
    assert c["moe.assignments"] == 32 * k and c["moe.slots"] == 4 * capacity


def test_lifecycle_phases_reach_the_head_and_the_timeline():
    import ray_tpu_torch as ray
    from ray_tpu_torch.train.backend import (
        _destroy_process_group, _init_process_group)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    ray.init(num_cpus=1, num_tpus=0)
    try:
        info = ray.get(ray.remote(_init_process_group).remote(
            addr, 1, 0, "gloo"), timeout=120)
        assert info["ranks_seen"] == 1
        ray.get(ray.remote(_destroy_process_group).remote(), timeout=60)
        want = {"runtime.init", "worker.boot", "train.process_group"}
        deadline = time.time() + 30
        while True:
            phases = [s for s in tracing.get_task_spans()
                      if s["kind"] == "phase"]
            if want <= {s["name"] for s in phases} or time.time() > deadline:
                break
            time.sleep(0.1)
        assert want <= {s["name"] for s in phases}
        assert all(s["end"] >= s["start"] for s in phases)
        events = [e for e in ray.timeline() if e.get("cat") == "phase"]
        assert want <= {e["name"] for e in events}
    finally:
        ray.shutdown()
    mine = {p["name"] for p in tracing.lifecycle()}
    assert "runtime.init" in mine
