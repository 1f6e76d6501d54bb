"""Trainable: the unit of Tune execution (a copy of
``ray_tpu/tune/trainable.py`` on the port's ``air.checkpoint``).

Reference: ``python/ray/tune/trainable/trainable.py:343`` (class API with
``train()`` per iteration + ``save_checkpoint``/``load_checkpoint``) and
``function_trainable.py`` (function API).  Both run as one actor per trial.

The class API is the iterative path every scheduler interacts with (ASHA
stops trials between iterations; PBT exploits/explores between iterations);
the function API wraps a generator or plain function into the same shape.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


class Trainable:
    """Subclass: implement setup/step (+ save/load for PBT & resume)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = config or {}
        self.iteration = 0
        self.setup(self.config)

    # -- overridable -------------------------------------------------------
    def setup(self, config: Dict[str, Any]):
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Dict[str, Any]:
        return {}

    def load_checkpoint(self, state: Dict[str, Any]):
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """Reuse the actor for a new config (PBT explore). Return True if
        handled (reference: trainable.py reset_config)."""
        return False

    def cleanup(self):
        pass

    # -- driver-called (actor methods) ------------------------------------
    def train(self) -> Dict[str, Any]:
        result = self.step()
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        return result

    def save(self) -> bytes:
        state = {"iteration": self.iteration,
                 "state": self.save_checkpoint(),
                 "config": self.config}
        return Checkpoint.from_dict(state).to_bytes()

    def restore(self, blob: bytes):
        state = Checkpoint.from_bytes(blob).to_dict()
        self.iteration = state["iteration"]
        self.load_checkpoint(state["state"])
        return True

    def reset(self, new_config: Dict[str, Any]) -> bool:
        ok = self.reset_config(new_config)
        if ok:
            self.config = new_config
            self.iteration = 0
        return ok

    def stop(self):
        self.cleanup()
        return True


def wrap_function(fn: Callable) -> type:
    """Function API -> class API.

    Generator functions yield per-iteration metric dicts (the idiomatic
    iterative form here — the reference's session.report inside a running
    function is its streaming equivalent); plain functions run once and
    their return dict is the single result.
    """

    if inspect.isgeneratorfunction(fn):
        class GenTrainable(Trainable):
            def setup(self, config):
                self._gen = fn(config)

            def step(self):
                try:
                    return dict(next(self._gen))
                except StopIteration:
                    return {"done": True}
        GenTrainable.__name__ = f"Gen({fn.__name__})"
        return GenTrainable

    class FuncTrainable(Trainable):
        def step(self):
            out = fn(self.config) or {}
            out["done"] = True
            return dict(out)
    FuncTrainable.__name__ = f"Func({fn.__name__})"
    return FuncTrainable
