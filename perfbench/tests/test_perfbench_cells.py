"""A cell defined by data files alone is found and run, end to end, on the
CPU; a metric reader added as a file is found by its name; and a run with
its timed path broken underneath, or with the control in the program's
place, comes out not correct."""

from __future__ import annotations

import math
import time

import pytest
import torch

from perfbench import core

from . import tiny

SEED = 2**31 + 4242


def _run(tmp_path, name: str, trace: bool = False, fault=None) -> dict:
    bench = tiny.write(str(tmp_path))
    cell = core.Cell(bench, name, SEED, 1.0, trace, tiny.ROOT,
                     device=torch.device("cpu"), base=str(tmp_path))
    cell.fault = fault
    return core.run_cell(cell, time.perf_counter(), log=lambda m: None)


@pytest.mark.parametrize("name,metric", [
    ("t-batch", "gen_tokens_per_s"),
    ("t-train", "train_tokens_per_s"),
    ("t-open", "request_ms_p95")])
def test_data_only_cell_runs(tmp_path, name, metric):
    out = _run(tmp_path, name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) >= {metric, "setup_s"}
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", ["t-batch", "t-open"])
def test_traced_run_reads_its_metrics(tmp_path, name):
    out = _run(tmp_path, name, trace=True)
    assert out["correct"], out["checks"]
    # only this cell's per-layer metrics, and no end-to-end one
    assert set(out["metrics"]) <= {"mfu." + name}
    assert out["device"]["window_s"] > 0


def test_new_reader_found_by_name(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "rows_seen.py").write_text(
        "def read(cell, window, traced, trace):\n"
        "    return float(traced['units'])\n")
    mod = core.plugin("metrics", core.metric_family("rows_seen.batch"),
                      str(tmp_path))
    assert mod.read(None, {}, {"units": 7}, None) == 7.0
    # the shipped readers are found from any base
    assert hasattr(core.plugin("metrics", "mfu", str(tmp_path)), "read")


def _alter_tokens(monkeypatch):
    """Break the served path where its tokens come out: one token of every
    row moved by one."""
    from eamg_tpu_torch.decode import loop
    from eamg_tpu_torch.serve import continuous

    real_kv = loop.generate_kv

    def generate_kv(*args, **kw):
        buf, pos = real_kv(*args, **kw)
        buf = buf.clone()
        buf[:, pos - 2] = (buf[:, pos - 2] + 1) % 8324
        return buf, pos

    monkeypatch.setattr(loop, "generate_kv", generate_kv)
    real_submit = continuous.ContinuousBatcher.submit

    def submit(self, prompt_ids, **kw):
        ids = list(real_submit(self, prompt_ids, **kw))
        if len(ids) > len(prompt_ids) + 1:
            ids[-1] = (ids[-1] + 1) % 8892
        return ids

    monkeypatch.setattr(continuous.ContinuousBatcher, "submit", submit)


@pytest.mark.parametrize("name", ["t-batch", "t-open"])
def test_altered_token_is_not_correct(tmp_path, monkeypatch, name):
    _alter_tokens(monkeypatch)
    out = _run(tmp_path, name)
    assert not out["correct"], out["checks"]
    assert out["checks"]["served_gap"]["value"] \
        > out["checks"]["served_gap"]["limit"]


def _failed(out: dict) -> set:
    return {k for k, c in out["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("name,kind", [
    ("t-batch", "k_plus_one"), ("t-batch", "no_mask"),
    ("t-open", "no_mask")])
def test_top_k_mask_fault_is_not_correct(tmp_path, monkeypatch, name,
                                         kind):
    """K4 broken under the sampler: one token past the k-th let in, or no
    mask at all. The sampled rows' tokens then fall outside the
    reference's top k. (The engine's tiny cell draws its rank-51 token
    too seldom for the first fault.)"""
    from eamg_tpu_torch.decode import sampling
    from eamg_tpu_torch.ops.topk import top_k_mask_plain

    def k_plus_one(logits, k, mask_value=-1e10):
        return top_k_mask_plain(logits, k + 1, mask_value)

    def no_mask(logits, k, mask_value=-1e10):
        return logits

    monkeypatch.setattr(sampling, "top_k_mask",
                        {"k_plus_one": k_plus_one, "no_mask": no_mask}[kind])
    out = _run(tmp_path, name)
    assert not out["correct"]
    assert _failed(out) == {"topk_gap"}, out["checks"]


@pytest.mark.parametrize("fault,check", [("unchanged", "delta_gap"),
                                         ("unchanged", "late_delta_gap"),
                                         ("half_batch", "grad_gap"),
                                         ("half_batch", "late_grad_gap")])
def test_training_fault_is_not_correct(tmp_path, fault, check):
    out = _run(tmp_path, "t-train", fault=fault)
    assert not out["correct"]
    assert check in _failed(out), out["checks"]


@pytest.mark.parametrize("name,checks", [
    ("t-batch", {"served_gap", "topk_gap"}),
    ("t-open", {"served_gap", "topk_gap"}),
    ("t-train", {"loss_gap", "grad_gap", "delta_gap", "late_loss_gap",
                 "late_grad_gap", "late_delta_gap"})])
def test_control_is_not_correct(tmp_path, name, checks):
    """The control (the float8 reference for a served cell, TF32 matmuls
    for training) in the program's place, judged by the cell's own check
    and limits, comes out not correct on every number it was set against."""
    out = _run(tmp_path, name, fault="control")
    assert not out["correct"]
    assert _failed(out) == checks, out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", ["a-engine-open", "large2-batch32",
                                  "large2-train"])
def test_control_at_cell_size_is_not_correct(name):
    """The shipped cell at its own size with the control in the program's
    place, against the shipped limits (a short window)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = core.load_json(tiny.ROOT + "/BENCHMARK.json")
    cell = core.Cell(bench, name, SEED, 4.0, False, tiny.ROOT,
                     device=torch.device("cuda", 0))
    cell.fault = "control"
    out = core.run_cell(cell, time.perf_counter(), log=lambda m: None)
    assert not out["correct"], out["checks"]
