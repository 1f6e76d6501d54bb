"""The port's runtime with the card as its accelerator, on CPU.

``RAY_TPU_FORCE_NUM_TPUS=1`` grants one "card" without one: a granted
worker sees ``CUDA_VISIBLE_DEVICES`` naming it, ``num_tpus`` and
``num_gpus`` draw from the one pool, and a CPU worker sees no card and
never imports torch.  Also: the accelerator count, the copied wire
protocol's verb set, torch-tensor checkpoints, the card an agent node's
worker gets, and the port's own lint and protocheck over
``ray_tpu_torch/``.

This module imports neither torch nor the reference at its top: workers
import it to unpickle its task functions, and a CPU worker must stay free
of torch.
"""

import os
import sys
import time

import pytest

import ray_tpu_torch as ray

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "ray_tpu_torch")


@pytest.fixture
def one_card(monkeypatch):
    """The port's runtime with 2 CPUs and one granted "card"."""
    monkeypatch.setenv("RAY_TPU_FORCE_NUM_TPUS", "1")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    rt = ray.init(num_cpus=2)
    yield rt
    ray.shutdown()


def _probe(hold_s=0.0):
    start = time.time()
    time.sleep(hold_s)
    return {"cvd": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "chips": ray.get_runtime_context().tpu_chips,
            "torch": "torch" in sys.modules, "pid": os.getpid(),
            "start": start, "end": time.time()}


def test_card_is_counted_and_granted(one_card):
    assert ray.cluster_resources()["TPU"] == 1.0
    got = ray.get(ray.remote(num_tpus=1)(_probe).remote(), timeout=60)
    assert got["cvd"] == "0" and got["chips"] == ["0"]
    assert got["pid"] != os.getpid()


def test_num_gpus_draws_from_the_same_pool(one_card):
    """With one card, a num_gpus=1 task waits while a num_tpus=1 task
    holds it, then sees the same card."""
    first = ray.remote(num_tpus=1)(_probe).remote(1.5)
    time.sleep(0.3)
    second = ray.remote(num_gpus=1)(_probe).remote()
    ready, _ = ray.wait([second], timeout=0.5)
    assert ready == []
    a, b = ray.get([first, second], timeout=60)
    assert a["cvd"] == b["cvd"] == "0"
    assert b["start"] >= a["end"]


def test_cpu_worker_sees_no_card_and_no_torch(one_card):
    import torch  # noqa: F401 -- the driver holds torch; workers must not

    got = ray.get(ray.remote(_probe).remote(), timeout=60)
    assert got["cvd"] == "" and got["chips"] == []
    assert got["torch"] is False


def test_accelerator_count_honours_cuda_visible_devices(monkeypatch):
    from ray_tpu_torch._private import api, runtime

    vis = api._visible_cards
    assert vis(4, None) == 4 and vis(4, "") == 0
    assert vis(4, "1,3") == 2 and vis(4, "3") == 1
    assert vis(4, "0,7,1") == 1          # stops at the first bad entry
    assert vis(4, "2,2") == 1 and vis(4, "-1") == 0
    assert vis(2, "GPU-8f2a,GPU-9c1d") == 2 and vis(0, "0") == 0
    monkeypatch.delenv("RAY_TPU_FORCE_NUM_TPUS", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert api._detect_tpu_chips() == 0
    monkeypatch.setenv("RAY_TPU_FORCE_NUM_TPUS", "3")
    assert api._detect_tpu_chips() == 3
    # A grant names the driver's own visible cards, in their order.
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    assert runtime._cuda_visible_devices([1]) == "3"
    assert runtime._cuda_visible_devices([0, 1]) == "2,3"
    assert runtime._cuda_visible_devices([]) == ""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert runtime._cuda_visible_devices([0]) == "0"


def test_agent_node_maps_its_grant_through_its_own_cards(monkeypatch):
    """A worker on an agent node gets the cards the AGENT's own
    ``CUDA_VISIBLE_DEVICES`` names at the granted places (the head sends
    pool indices), never the head's reading of them."""
    from ray_tpu_torch.cluster_utils import Cluster

    monkeypatch.setenv("RAY_TPU_FORCE_NUM_TPUS", "0")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    c = Cluster(head_num_cpus=1)
    try:
        nid = c.add_node(num_cpus=2, num_tpus=2, external=True,
                         env_overrides={"CUDA_VISIBLE_DEVICES": "3,5"})

        def where():  # by value: the agent's workers cannot import tests/
            import os

            import ray_tpu_torch

            ctx = ray_tpu_torch.get_runtime_context()
            return {"cvd": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "chips": ctx.tpu_chips, "node": ctx.node_id}

        both = ray.get(ray.remote(num_tpus=2)(where).remote(), timeout=60)
        one = ray.get(ray.remote(num_tpus=1)(where).remote(), timeout=60)
        cpu = ray.get(ray.remote(num_cpus=2)(where).remote(), timeout=60)
    finally:
        c.shutdown()
    assert both["cvd"] == "3,5" and both["chips"] == ["3", "5"], both
    assert one["cvd"] in ("3", "5"), one
    assert both["node"] == one["node"] == nid
    assert cpu["cvd"] == "" and cpu["node"] == nid


def test_killed_actor_on_agent_node_frees_its_card():
    """``ray.kill`` of an actor on an agent node kills its process (the
    head holds no process handle there: the agent forks and kills it),
    so its card goes to the next grant."""
    from ray_tpu_torch.cluster_utils import Cluster

    c = Cluster(head_num_cpus=1)
    try:
        c.add_node(num_cpus=2, num_tpus=1, external=True)

        class Holder:  # by value: the agent's workers cannot import tests/
            def pid(self):
                import os

                return os.getpid()

        def pid():
            import os

            return os.getpid()

        holder = ray.remote(num_tpus=1)(Holder).remote()
        held = ray.get(holder.pid.remote(), timeout=60)
        ray.kill(holder)
        after = ray.get(ray.remote(num_tpus=1)(pid).remote(), timeout=30)
        deadline = time.time() + 10
        while time.time() < deadline and os.path.exists(f"/proc/{held}"):
            time.sleep(0.1)
        gone = not os.path.exists(f"/proc/{held}")
    finally:
        c.shutdown()
    assert after != held and gone


def test_killed_actor_on_agent_node_is_reaped():
    """The agent reaps the worker it kills: with no later spawn on the
    node to reap it by the way, the killed process is gone, not left a
    zombie that still holds its pid."""
    from ray_tpu_torch.cluster_utils import Cluster

    c = Cluster(head_num_cpus=1)
    try:
        c.add_node(num_cpus=2, num_tpus=1, external=True)

        class Holder:  # by value: the agent's workers cannot import tests/
            def pid(self):
                import os

                return os.getpid()

        holder = ray.remote(num_tpus=1)(Holder).remote()
        held = ray.get(holder.pid.remote(), timeout=60)
        ray.kill(holder)
        deadline = time.time() + 10
        while time.time() < deadline and os.path.exists(f"/proc/{held}"):
            time.sleep(0.1)
        gone = not os.path.exists(f"/proc/{held}")
    finally:
        c.shutdown()
    assert gone


def test_protocol_verbs_equal_the_reference():
    from ray_tpu._private import protocol as ref
    from ray_tpu_torch._private import protocol as port

    assert set(port.VERBS) == set(ref.VERBS)
    for name, verb in ref.VERBS.items():
        assert tuple(port.VERBS[name]) == tuple(verb), name


def test_checkpoint_round_trips_torch_tensors(tmp_path):
    import numpy as np
    import torch

    from ray_tpu_torch.air import Checkpoint

    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(3, 5, generator=gen),
            "layers": [{"b": torch.randn(7, generator=gen).bfloat16()}],
            "step": 4, "host": np.arange(6, dtype=np.int32)}
    path = Checkpoint.from_dict(tree).to_directory(str(tmp_path / "c"))
    back = Checkpoint.from_directory(path).to_dict()
    for got, want in ((back["w"], tree["w"]),
                      (back["layers"][0]["b"], tree["layers"][0]["b"])):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert got.shape == want.shape
        assert torch.equal(got.view(torch.int16 if want.dtype ==
                                    torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if want.dtype ==
                                     torch.bfloat16 else torch.int32))
    assert back["step"] == 4 and np.array_equal(back["host"], tree["host"])


def test_port_tree_is_lint_and_protocheck_clean():
    from ray_tpu_torch.devtools import lint, protocheck

    findings = lint.lint_paths([PORT_DIR])
    assert findings == [], "\n".join(repr(f) for f in findings)
    findings = protocheck.check_paths([PORT_DIR])
    assert findings == [], "\n".join(repr(f) for f in findings)
