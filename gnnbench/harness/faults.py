"""Faults planted under the timed path, for the test that sees ``correct``
come out false and for the readings that set the limits' upper ends
(``calibrate.py``). The benchmark's own runs never use them.

- ``unchanged_state``: the step returns its state unchanged (no update);
- ``half_batch``: the loss is the mean over the first half of the nodes;
- ``altered_answer``: one node's logits are altered where the model
  produces them.

A single card has no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib

from gnnbench.harness.training import Trainer

FAULTS = ("unchanged_state", "half_batch", "altered_answer")


@contextlib.contextmanager
def planted(fault: str):
    saved = {k: getattr(Trainer, k) for k in ("forward", "loss", "optimizer_step")}

    def no_update(self):
        self.opt.zero_grad(set_to_none=True)

    def half_loss(self, logits, y):
        half = logits.shape[0] // 2
        return saved["loss"](self, logits[:half], y[:half])

    def altered_forward(self, masks):
        logits = saved["forward"](self, masks)
        bump = logits.new_zeros(logits.shape)
        bump[0] = logits.detach().abs().max() + 1.0
        return logits + bump

    patch = {"unchanged_state": ("optimizer_step", no_update),
             "half_batch": ("loss", half_loss),
             "altered_answer": ("forward", altered_forward)}[fault]
    setattr(Trainer, *patch)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(Trainer, k, v)
