"""The plain reference of a training step: next-token cross-entropy over
the non-PAD targets of the step's rows (their mean), its gradient by
autograd through ``gpt_plain.forward`` in float32, and AdamW as optax
writes it (mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, u =
mu_hat / (sqrt(nu_hat) + eps) + wd p, p -= lr u, on every leaf), without
clipping. ``tf32=True`` is the control: the same steps with every matmul
on TF32 operands (``gpt_plain.tf32_matmul``).

It imports nothing of the program. From the start, the rows and the first
weights are the benchmark's, made again from the seed; steps taken later
start from a state handed to it (weights, Adam's moments and count).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import gpt_plain


def leaves(tree, path=()) -> list:
    """[(path, tensor)] with dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    return [(path, tree)]


def rebuild(tree, it):
    """A tree shaped like ``tree`` with the leaves of ``it`` in
    :func:`leaves` order."""
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, it) for v in tree]
    return next(it)


def run(w0: dict, batches: list, m: dict, hp: dict, tf32: bool = False,
        state: dict | None = None, pad_id: int = 0) -> dict:
    """Train a copy of ``w0`` over ``batches`` ([(x, y)] of [B, T] ids on
    the device), one step each, from Adam's ``state`` ({"count", "mu",
    "nu"}, moments in :func:`leaves` order) or from a fresh one -> {"loss":
    [per step], "grad1": {path: norm of the first step's gradient},
    "delta": {path: norm of the change of the weights after the last
    step}}."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(w0, batches, m, hp, tf32, state, pad_id)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _run(w0, batches, m, hp, tf32, state, pad_id):
    named = leaves(w0)
    paths = [p for p, _ in named]
    start = [t.detach().float().clone() for _, t in named]
    params = [t.clone() for t in start]
    if state is None:
        state = {"count": 0, "mu": [torch.zeros_like(t) for t in params],
                 "nu": [torch.zeros_like(t) for t in params]}
    mu = [t.float().clone() for t in state["mu"]]
    nu = [t.float().clone() for t in state["nu"]]
    b1, b2, eps, wd, lr = (hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"],
                           hp["lr"])
    out = {"loss": [], "grad1": {}, "delta": {}}
    for step, (x, y) in enumerate(batches, 1):
        count = state["count"] + step
        live = [p.detach().requires_grad_() for p in params]
        w = rebuild(w0, iter(live))
        logits = gpt_plain.forward(w, x, m, tf32=tf32)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y.reshape(-1), ignore_index=pad_id)
        grads = torch.autograd.grad(loss, live)
        out["loss"].append(float(loss.detach()))
        del logits, loss, w
        with torch.no_grad():
            if step == 1:
                out["grad1"] = {p: float(g.norm()) for p, g in
                                zip(paths, grads)}
            for i, g in enumerate(grads):
                mu[i] = b1 * mu[i] + (1 - b1) * g
                nu[i] = b2 * nu[i] + (1 - b2) * g * g
                mh = mu[i] / (1 - b1 ** count)
                nh = nu[i] / (1 - b2 ** count)
                u = mh / (nh.sqrt() + eps) + wd * params[i]
                params[i] = params[i] - lr * u
    out["delta"] = {p: float((a - b).norm())
                    for p, a, b in zip(paths, params, start)}
    return out


def gaps(prog: dict, ref: dict, grad_floor: float = 1e-3) -> dict:
    """The compared numbers of a program's readings against the
    reference's: the widest relative gap of a step's loss; of a leaf's
    first-gradient norm and of a leaf's change after the last step, each
    against the larger of the reference's norm of that leaf and of the
    median leaf. Leaves whose reference gradient is under ``grad_floor``
    of the median leaf's (their moves are Adam's round-off) are left out
    of the change."""
    def median(v):
        v = sorted(v)
        return v[len(v) // 2]

    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"]))
    gm = median(ref["grad1"].values())
    grad = max(abs(prog["grad1"][p] - g) / max(g, gm)
               for p, g in ref["grad1"].items())
    kept = [p for p, g in ref["grad1"].items() if g >= grad_floor * gm]
    dm = median(ref["delta"][p] for p in kept)
    delta = max(abs(prog["delta"][p] - ref["delta"][p])
                / max(ref["delta"][p], dm) for p in kept)
    return {"loss_gap": loss, "grad_gap": grad, "delta_gap": delta,
            "left_out": len(ref["grad1"]) - len(kept)}
