"""Recording runs of the JAX demo scripts (``demo/``) for the demo-twin
tests (``tests/test_torch_demo_twins_*.py``).

``record_jax(monkeypatch)`` wraps, for the rest of the test (inside
``jax.jit`` through ordered ``jax.debug.callback``s, so a script's jitted
step compiles once and still reports every draw in call order):

- ``jax.value_and_grad``: each call's loss and gradients, in call order;
- ``jax.random.bernoulli``: each dropout / DropEdge keep mask;
- ``jax.random.randint``: each draw's random integers (the device sampler);
- ``jax.random.permutation``: each permutation (DGI's shuffles);
- ``optax.adam``: each optimizer's learning rate and the parameters its
  ``init`` is given (the script's initial weights).

A test then runs the JAX script's ``main`` (with ``TFG_DEMO_SMOKE_STEPS``
capping its loop) and replays the records in the port's twin.
"""
import types

import jax
import numpy as np
import optax


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _report(append, *values):
    """``append(*values as numpy)`` now, or when the traced computation
    runs."""
    jax.debug.callback(lambda *v: append(*_to_numpy(v)), *values, ordered=True)


def record_jax(monkeypatch):
    rec = types.SimpleNamespace(losses=[], grads=[], bernoulli=[], randint=[], permutation=[],
                                adam_lr=[], init_params=[])
    real_vg, real_bernoulli = jax.value_and_grad, jax.random.bernoulli
    real_randint, real_permutation, real_adam = (jax.random.randint, jax.random.permutation,
                                                 optax.adam)

    def value_and_grad(fn, *args, **kwargs):
        inner = real_vg(fn, *args, **kwargs)

        def run(*a, **k):
            loss, grads = inner(*a, **k)

            def keep(value, g):
                rec.losses.append(float(value))
                rec.grads.append(g)
            _report(keep, loss, grads)
            return loss, grads
        return run

    def bernoulli(key, p=0.5, shape=None):
        mask = real_bernoulli(key, p, shape)
        _report(rec.bernoulli.append, mask)
        return mask

    def randint(key, shape, minval, maxval, dtype=None):
        kwargs = {} if dtype is None else {"dtype": dtype}
        ints = real_randint(key, shape, minval, maxval, **kwargs)
        _report(rec.randint.append, ints)
        return ints

    def permutation(key, x, *args, **kwargs):
        perm = real_permutation(key, x, *args, **kwargs)
        _report(rec.permutation.append, perm)
        return perm

    def adam(learning_rate, *args, **kwargs):
        tx = real_adam(learning_rate, *args, **kwargs)
        rec.adam_lr.append(learning_rate)

        def init(params):
            rec.init_params.append(_to_numpy(params))
            return tx.init(params)
        return optax.GradientTransformation(init, tx.update)

    monkeypatch.setattr(jax, "value_and_grad", value_and_grad)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(jax.random, "randint", randint)
    monkeypatch.setattr(jax.random, "permutation", permutation)
    monkeypatch.setattr(optax, "adam", adam)
    return rec


def record_port_adam(monkeypatch):
    """``torch.optim.Adam`` replaced, for the rest of the test, by a subclass
    that keeps the gradients of its first ``step`` (one tensor a parameter,
    in the optimizer's parameter order; zeros for a parameter the loss does
    not reach, as JAX reports it) and its parameters: ``rec.grads``,
    ``rec.params``."""
    import torch
    rec = types.SimpleNamespace(grads=None, params=None)

    class RecordingAdam(torch.optim.Adam):
        def step(self, closure=None):
            if rec.grads is None:
                rec.params = [p for g in self.param_groups for p in g["params"]]
                rec.grads = [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                             for p in rec.params]
            return super().step(closure)

    monkeypatch.setattr(torch.optim, "Adam", RecordingAdam)
    return rec


def named_grads(module, adam_rec):
    """``{name: step-1 gradient}`` of ``module``'s parameters from a
    ``record_port_adam`` record."""
    by_id = {id(p): g for p, g in zip(adam_rec.params, adam_rec.grads)}
    return {k: by_id[id(p)] for k, p in module.named_parameters()}
