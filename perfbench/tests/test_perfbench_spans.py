"""The per-layer metric read from the program's own lifecycle phases:
``runtime_init_s``, in a traced CPU rehearsal of the tiny cell and from
a program that records no such phase."""

from types import SimpleNamespace

import checkout

from perfbench import harness
from ray_tpu_torch.util import tracing

# Kernel and device metrics that a CPU rehearsal cannot give.
DEVICE_ONLY = ("k1_roofline", "k23_roofline", "peak_mem_gib")


def test_traced_rehearsal_reports_runtime_init_s(tmp_path):
    root = checkout.make(tmp_path / "co")
    rc, result, forbidden, err = checkout.rehearse(root, 2 ** 31 + 17,
                                                   trace=1)
    assert rc == 0, err[-4000:]
    assert forbidden == []
    metrics = result["metrics"]
    assert 0 < metrics["runtime_init_s"]["value"] < 60
    assert metrics["runtime_init_s"]["unit"] == "s"
    assert not [m for m in DEVICE_ONLY if m in metrics]


def test_runtime_init_s_is_none_without_the_phase(monkeypatch):
    read = harness.reader("runtime_init_s")
    r = SimpleNamespace(host={})
    monkeypatch.setattr(tracing, "_phases", [])
    assert read(r) is None
    tracing.record_phase("runtime.init", 10.0, 12.5)
    assert read(r) == 2.5
    monkeypatch.delattr(tracing, "lifecycle")
    assert read(r) is None
