"""Training steps back to back, as ``cli train --preset large2`` runs them.

The program is ``train/trainer.py::Trainer`` with ``reference_preset``
of the mix's ``preset``, the mix's ``loss_chunk`` (``train/run.py``'s for
a vocabulary of 4096 or more), on the configuration's weights drawn from
the seed in the mix's dtype; batches reach it through
``train/prefetch.py::PrefetchIterator`` (depth 2) and each step is issued
with ``train_step(sync=False)``, as ``train/run.py`` issues them. Every
row is a ``width``-token window cut from its own synthetic Scheme-B2 song
of ``song_min``..``song_max`` tokens (``perfbench/gen/b2_songs.py``), all
drawn from the seed: x its first ``width - 1`` tokens, y its last.

Set-up builds the one trainer and drives it through its first
``first_steps`` steps on the stream's first batches; the window goes on
from there with the same trainer and the same feed. The rate is the
non-PAD targets of all the steps issued in the window over the time until
the last of them has finished on the card. When the window has closed,
the same trainer takes ``late_steps`` more steps through the same call
and feed, from the state the window left.

The check: the reference (``perfbench/reference/train_plain.py``) trains
the same first weights on the same first batches, made again from the
seed, and follows the late steps from the program's state before them
(its weights, Adam's moments and count) on the host batches they were
fed. Compared, for each of the two stretches: each step's loss, each
leaf's first gradient (the program's, worked out from its Adam state
after that step: (mu - b1 mu_before) / (1 - b1)) and each leaf's change
over the stretch, by the widest relative gap (``train_plain.gaps``;
``late_`` names the late stretch's).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from perfbench import inputs, work
from perfbench.gen import b2_songs
from perfbench.reference import train_plain


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


class Runner:
    def __init__(self, cell):
        self.cell, self.mix, self.m = cell, cell.mix, cell.model()
        # a planted fault (perfbench/tests, calibrate.py --fault): None,
        # "unchanged" (the step leaves the weights as they were),
        # "half_batch" (the step sees half of its rows) or "control" (the
        # reference with TF32 matmuls in the program's place)
        self.fault = cell.fault
        self.g = work.geometry({"model": self.m})
        self.dtype = torch.float32 if self.m["dtype"] == "float32" \
            else torch.bfloat16
        self.made, self.fed = {}, 0

    def _batches(self, seed: int, keep: bool = False):
        """The stream of host batches ([1, B, T] x and y) of a seed; with
        ``keep`` each is also kept in ``made`` by its index until fed."""
        mix = self.mix
        rng = np.random.default_rng(seed)
        i = 0
        while True:
            w = b2_songs.windows(rng, mix["micro_batch"], mix["width"],
                                 mix["song_min"], mix["song_max"])
            x, y = w[None, :, :-1], w[None, :, 1:]
            if keep:
                self.made[i] = (x, y)
                i += 1
            yield x, y

    def _next(self):
        """The feed's next batch; its host batch is ``made[fed - 1]``."""
        x, y = next(self.feed)
        self.fed += 1
        self.made.pop(self.fed - 8, None)
        return x, y

    def _hp(self) -> dict:
        t = self.tcfg
        return {"lr": t.lr, "b1": t.b1, "b2": t.b2, "eps": 1e-8,
                "weight_decay": t.weight_decay}

    def _step(self, x, y):
        if self.fault == "half_batch":
            x, y = x[:, :x.shape[1] // 2], y[:, :y.shape[1] // 2]
        if self.fault == "unchanged":
            before = [p.clone() for p in self._leaves()]
            out = self.trainer.train_step(x, y, sync=False)
            for p, b in zip(self._leaves(), before):
                p.copy_(b)
            return out
        return self.trainer.train_step(x, y, sync=False)

    def _leaves(self) -> list:
        return [t for _, t in train_plain.leaves(self.trainer.params)]

    def _stretch(self, steps: int) -> dict:
        """``steps`` steps through the window's call and feed from the
        trainer's state now -> the program's readings, the state they
        started from and the host batches fed."""
        st = self.trainer.opt_state
        start = [t.detach().clone() for t in self._leaves()]
        before = {"count": st["count"],
                  "mu": [t.clone() for t in st["mu"]],
                  "nu": [t.clone() for t in st["nu"]]}
        losses, fed, b1 = [], [], self.tcfg.b1
        for step in range(steps):
            x, y = self._next()
            fed.append(self.made[self.fed - 1])
            losses.append(self._step(x, y)["loss"])
            if step == 0:
                grad1 = [((mu - b1 * m0) / (1 - b1)).norm()
                         for mu, m0 in zip(st["mu"], before["mu"])]
        delta = [(p - s).norm() for p, s in zip(self._leaves(), start)]
        paths = [p for p, _ in train_plain.leaves(self.trainer.params)]
        got = {"loss": [float(v) for v in losses],
               "grad1": {p: float(g) for p, g in zip(paths, grad1)},
               "delta": {p: float(d) for p, d in zip(paths, delta)}}
        return {"got": got, "params": start, "state": before, "fed": fed}

    def setup(self):
        from eamg_tpu_torch.train.prefetch import PrefetchIterator
        from eamg_tpu_torch.train.trainer import Trainer, reference_preset

        cell, mix = self.cell, self.mix
        self.tcfg = dataclasses.replace(reference_preset(mix["preset"]),
                                        micro_batch=mix["micro_batch"],
                                        loss_chunk=mix["loss_chunk"])
        w = inputs.weights(cell, cell.device, self.dtype)
        self.trainer = Trainer(inputs.gpt_config(self.m), self.tcfg, w,
                               device=cell.device)
        del w
        self.feed = PrefetchIterator(self._batches(cell.seed, keep=True),
                                     depth=2, device=cell.device)
        self.first = self._stretch(mix["first_steps"])["got"]

    def _targets(self) -> int:
        return self.mix["micro_batch"] * (self.mix["width"] - 1)

    def window(self, seconds: float) -> dict:
        steps = 0
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            x, y = self._next()
            self._step(x, y)
            steps += 1
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - start
        tokens = steps * self._targets()
        _log(f"[train_steps] {steps} steps in {wall:.3f} s")
        self.late = self._stretch(self.mix["late_steps"])
        flops = steps * self.mix["micro_batch"] * work.train_row_flops(
            self.g, self.mix["width"] - 1)
        return {"attempted": steps, "failed": 0,
                "e2e": {"train_tokens_per_s": tokens / wall},
                "units": steps, "wall_s": wall, "flops": flops,
                "dtype": self.m["dtype"]}

    def traced(self) -> dict:
        n = self.mix["trace_steps"]
        for _ in range(n):
            x, y = self._next()
            self._step(x, y)
        return {"units": n}

    def release(self):
        params = self.trainer.params
        self.late["w0"] = train_plain.rebuild(params,
                                              iter(self.late["params"]))
        del self.trainer, self.feed, params
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, tf32: bool) -> tuple:
        """The reference's readings of the first stretch and the late one
        (TF32 matmuls: the control)."""
        dev = self.cell.device
        w0 = inputs.weights(self.cell, dev, self.dtype)
        feed = self._batches(self.cell.seed)

        def on(dev_batches):
            return [(torch.from_numpy(x[0]).to(dev),
                     torch.from_numpy(y[0]).to(dev)) for x, y in dev_batches]

        first = train_plain.run(
            w0, on(next(feed) for _ in range(self.mix["first_steps"])),
            self.m, self._hp(), tf32=tf32)
        del w0
        late = self.late
        later = train_plain.run(late["w0"], on(late["fed"]), self.m,
                                self._hp(), tf32=tf32, state=late["state"])
        return first, later

    def check(self, window: dict) -> list:
        first, late = self._reference(tf32=False)
        prog = (self._reference(tf32=True) if self.fault == "control"
                else (self.first, self.late["got"]))
        got = train_plain.gaps(prog[0], first)
        got_late = train_plain.gaps(prog[1], late)
        _log(f"[train_steps] reference over the first "
             f"{self.mix['first_steps']} steps and the "
             f"{self.mix['late_steps']} after the window; "
             f"{got['left_out']} and {got_late['left_out']} leaves with a "
             "gradient under a thousandth of the median leaf's left out of "
             "the change")
        limits = self.mix["limits"]
        out = [{"name": k, "value": got[k], "limit": limits[k]}
               for k in ("loss_gap", "grad_gap", "delta_gap")]
        return out + [{"name": "late_" + k, "value": got_late[k],
                       "limit": limits["late_" + k]}
                      for k in ("loss_gap", "grad_gap", "delta_gap")]
