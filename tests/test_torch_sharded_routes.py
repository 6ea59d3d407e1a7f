"""Every decode route of the port on tensor-parallel params against the JAX
package, on the CPU: prompt lookup, Medusa, the Medusa tree, draft
speculation (the draft whole on every rank and on the target's group),
the uncached loop, beams, the continuous engine's Medusa rows and the
window batcher, on a model group.

JAX runs each route with ``shard_params(tp=True)`` on a (4 data x 2
model) mesh of virtual devices (GSPMD: no mesh code in the routes) and
unsharded; the port runs in one subprocess (tests/torch_port_worker.py,
task ``sharded_routes``): unsharded and on a model group of 1 in the
subprocess itself, then on spawned gloo groups of 2 and 4 ranks, each
rank holding its heads (a K/V head shared by 2 ranks in the GQA-2 model
at 4), its FF columns and its vocabulary rows, and making the same calls.

Checked, in f32, on every rank of groups of 1, 2 and 4, MHA and GQA-2:
- lookup and Medusa (greedy and seeded sampled), the tree (with its
  verify steps), the draft at both placements and the uncached loop give
  JAX's sharded stream, and so does the port unsharded; on the routes
  JAX also runs unsharded (:data:`UNSHARDED`) its sharded stream is its
  unsharded one (no JAX-side fault);
- beams: rows and gen_lens exactly, scores within 1e-5 relative;
- the engine built with Medusa heads (Medusa and plain rows mixed, the
  second request submitted mid-decode) gives JAX's sharded engine's rows,
  its first Medusa row is the route's solo Medusa stream, and every
  follower's engine state equals the leader's;
- the window batcher decodes three requests as one group, gives JAX's
  rows, and every follower's decodes equal the leader's;
- window batcher faults on a group of 2 (the leader's own plan, and a
  poisoned plan that raises on every rank) end every rank well inside
  the collective timeout;
- int8 weights under ``tp`` and a draft on another group raise
  ``ValueError``; a graph key holds the model group; the heads'
  proposals are both accepted and rejected.

The file takes about 80 s (JAX compiles each route a case in a pool of
threads while the port runs its groups, a world a case at once).
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.decode import Generator
from eamg_tpu.decode.medusa_tree import generate_medusa_tree
from eamg_tpu.models import GPTConfig
from eamg_tpu.parallel import make_mesh, shard_params
from eamg_tpu.serve.batcher import RequestBatcher
from eamg_tpu.serve.continuous import ContinuousBatcher
from eamg_tpu.tokenizer import Vocab

from port_harness import cfg_json, flatten, perturbed_params, start_worker

V = 96
BASE = dict(vocab_size=V, seq_len=32, d_model=32, n_head=4, n_layer=2,
            pos_rows=32, ln_placement="pre", activation="gelu", causal=True)
CASES = {"mha": {}, "gqa2": {"n_kv_heads": 2}}
WORLDS = (1, 2, 4)
N_HEADS = 4
# the engine: a Medusa row, a plain row submitted mid-decode, a Medusa row
REQUESTS = [([1, 2, 3], 100, 1.0), ([4, 5, 6, 7], 101, 0.9),
            ([8, 9], 102, 1.1)]
ROW_KINDS = ["med", "plain", "med"]
SPEC = {"prompt": [1, 2, 3, 1, 2, 3, 1], "max_len": 24, "gamma": 4,
        "ngram": 2, "top_k": 40, "seed": 3, "beams": 4, "uncached_len": 16,
        "slots": 2, "chunk": 4, "requests": REQUESTS,
        "opts": {"med": {"medusa": True}, "plain": {}},
        "engines": {"medusa": [{}, ROW_KINDS]},
        "window": {"max_batch": 4, "window_ms": 500.0, "temperature": 1.0,
                   "requests": [([1, 2, 3], 200), ([4, 5, 6, 7], 201),
                                ([8, 9], 202)]},
        "poison": [13, 13, 13], "fail_timeout": 60}
SPEC["engine_cases"] = [[c, "medusa"] for c in CASES]
SPEC["cases"] = list(CASES)
ROUTES = ["lookup/greedy", "lookup/sampled", "medusa/greedy",
          "medusa/sampled", "tree", "draft_whole", "draft_group",
          "uncached"]
# the routes JAX also runs unsharded, its sharded stream held to them
# (each JAX route is a compiled program a placement: running every route
# both ways would double the file's time)
UNSHARDED = ("lookup/greedy", "medusa/greedy", "tree", "beams")
STATE_KEYS = ("buf", "pos", "done", "last", "rngs", "h_last", "med_on")


def _models(name: str, i: int):
    """(cfg, params, draft cfg, draft params) of a case, as numpy trees:
    the draft has one layer of the target's widths."""
    rng = np.random.default_rng(20 + i)
    cfg = GPTConfig(**BASE, **CASES[name])
    cfg_d = GPTConfig(**{**BASE, "n_layer": 1}, **CASES[name])
    return (cfg, perturbed_params(cfg, rng, 10 + i), cfg_d,
            perturbed_params(cfg_d, rng, 30 + i))


def _heads() -> list:
    """Medusa heads drawn non-zero from a seed: near the base head, so
    their proposals are accepted and rejected."""
    rng = np.random.default_rng(7)
    D = BASE["d_model"]
    return [{"w": (0.3 * rng.standard_normal((D, D))).astype(np.float32),
             "b": (0.1 * rng.standard_normal(D)).astype(np.float32)}
            for _ in range(N_HEADS)]


def _solo(gen, draft, heads, modes) -> dict:
    """JAX's solo routes (the port's ``_solo_routes``; lookup and Medusa
    in ``modes``, the draft on the target's placement)."""
    s = SPEC
    ids, L = s["prompt"], s["max_len"]
    kw = dict(max_len=L, gamma=s["gamma"], top_k=s["top_k"], seed=s["seed"])
    jobs = {}
    for mode in modes:
        greedy = mode == "greedy"
        jobs[f"lookup/{mode}"] = lambda g=greedy: gen.generate_ids_lookup(
            ids, ngram=s["ngram"], greedy=g, **kw)
        jobs[f"medusa/{mode}"] = lambda g=greedy: gen.generate_ids_medusa(
            heads, ids, greedy=g, **kw)
    jobs["draft"] = lambda: gen.generate_ids_speculative(
        draft, ids, greedy=True, **kw)
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :len(ids)] = ids

    def tree():
        buf, pos, steps = generate_medusa_tree(
            gen.params, heads, jnp.asarray(prompt), len(ids), gen.cfg, L,
            eos_id=-1, pad_id=0)
        return np.asarray(buf)[0, :int(pos)], int(steps)

    jobs["tree"] = tree
    jobs["uncached"] = lambda: gen.generate_ids(
        ids, max_len=s["uncached_len"], top_k=s["top_k"], seed=s["seed"],
        use_cache=False)
    jobs["beams"] = lambda: gen.generate_ids_beam(
        ids, max_len=L, n_beams=s["beams"], return_all=True)
    if "sampled" in modes:
        jobs["medusa/row0"] = lambda: gen.generate_ids_medusa(
            heads, REQUESTS[0][0], max_len=L, gamma=s["gamma"],
            top_k=s["top_k"], seed=REQUESTS[0][1],
            temperature=REQUESTS[0][2])
    return jobs


def _engine(gen, heads) -> list:
    """JAX's engine with Medusa heads: request 0, then 1 and 2 a little
    later (the port's ``_engine_run`` waits for its first chunk)."""
    eng = ContinuousBatcher(gen, slots=SPEC["slots"], chunk=SPEC["chunk"],
                            max_len=SPEC["max_len"], top_k=SPEC["top_k"],
                            medusa_heads=heads)
    rows = {}

    def hit(i):
        ids, seed, temp = REQUESTS[i]
        time.sleep(0.05 * i)
        rows[i] = eng.submit(ids, temperature=temp, seed=seed, timeout=600,
                             medusa=ROW_KINDS[i] == "med")

    try:
        threads = [threading.Thread(target=hit, args=(i,), daemon=True)
                   for i in range(len(REQUESTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert len(rows) == len(REQUESTS), "a JAX engine request timed out"
    finally:
        eng.close()
    return [rows[i] for i in range(len(REQUESTS))]


def _window(gen) -> list:
    w = SPEC["window"]
    bat = RequestBatcher(gen, max_batch=w["max_batch"],
                         window_ms=w["window_ms"], max_len=SPEC["max_len"])
    rows = {}

    def hit(i, ids, seed):
        rows[i] = bat.submit(ids, temperature=w["temperature"],
                             top_k=SPEC["top_k"], seed=seed, timeout=600)

    try:
        threads = [threading.Thread(target=hit, args=(i, ids, seed),
                                    daemon=True)
                   for i, (ids, seed) in enumerate(w["requests"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert len(rows) == len(threads), "a JAX window request timed out"
    finally:
        bat.close()
    return [rows[i] for i in range(len(rows))]


def _jax_jobs(models: dict, heads_np: list) -> dict:
    """Every JAX run, keyed "<case>/<sh|un>/<route>": every route sharded
    (the target and the draft on the mesh), and unsharded those of
    :data:`UNSHARDED`."""
    vocab = Vocab({f"t{i}": i for i in range(V)})
    heads = {"blocks": [{k: jnp.asarray(v) for k, v in h.items()}
                        for h in heads_np]}
    mesh = make_mesh(data=4, model=2)

    def gen(p, c, sharded):
        return Generator(shard_params(p, mesh, tp=True) if sharded else p,
                         c, vocab, eos_token="none", pad_token="t0")

    jobs = {}
    for name, (cfg, p, cfg_d, pd) in models.items():
        for where in ("sh", "un"):
            sh = where == "sh"
            target = gen(p, cfg, sh)
            routes = _solo(target, gen(pd, cfg_d, sh), heads,
                           ("greedy", "sampled") if sh else ("greedy",))
            routes["engine"] = lambda t=target: _engine(t, heads)
            routes["window"] = lambda t=target: _window(t)
            for route, job in routes.items():
                if sh or route in UNSHARDED:
                    jobs[f"{name}/{where}/{route}"] = job
    return jobs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_routes")
    heads = _heads()
    inp = {"rt/spec": np.asarray(json.dumps(SPEC)),
           "rt/vocab": np.asarray(json.dumps({f"t{i}": i
                                              for i in range(V)})),
           "rt/n_heads": np.asarray(N_HEADS)}
    for i, h in enumerate(heads):
        inp[f"rt/heads/{i}/w"], inp[f"rt/heads/{i}/b"] = h["w"], h["b"]
    models = {name: _models(name, i) for i, name in enumerate(CASES)}
    for name, (cfg, p, cfg_d, pd) in models.items():
        inp.update(flatten(p, f"rt/{name}/p"))
        inp.update(flatten(pd, f"rt/{name}/d"))
        inp[f"rt/{name}/cfg"] = cfg_json(cfg)
        inp[f"rt/{name}/dcfg"] = cfg_json(cfg_d)
    worker = start_worker("sharded_routes", inp, tmp, timeout=900)
    jobs = _jax_jobs(models, heads)
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(job) for k, job in jobs.items()}
        ref = {k: f.result() for k, f in futures.items()}
    return worker(), ref


def _tokens(v):
    """A route's JAX result -> its token row (the tree's without its
    verify steps)."""
    return np.asarray(v[0] if isinstance(v, tuple) else v).reshape(-1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("route", ROUTES)
def test_route_on_a_group_equals_jax_sharded(results, route, case, world):
    """Every rank's stream is JAX's sharded one, and so is the port's
    unsharded stream (the draft at both placements against JAX's draft on
    the mesh: the placement changes no stream)."""
    got, ref = results
    want = _tokens(ref[f"{case}/sh/{route.split('_')[0]}"])
    for r in range(world):
        np.testing.assert_array_equal(
            got[f"w{world}/r{r}/{case}/{route}"].reshape(-1), want)
    one = "draft_whole" if route == "draft_group" else route
    np.testing.assert_array_equal(got[f"one/{case}/{one}"].reshape(-1),
                                  want)
    if route == "tree":
        for r in range(world):
            assert int(got[f"w{world}/r{r}/{case}/tree/steps"]) == \
                ref[f"{case}/sh/tree"][1]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("route", UNSHARDED)
def test_jax_sharded_route_equals_its_unsharded(results, route, case):
    """JAX's sharded stream is its unsharded one (beams: rows and lengths
    exactly, scores within 1e-5): no JAX-side fault, so the port is held
    to both."""
    _, ref = results
    sh, want = ref[f"{case}/sh/{route}"], ref[f"{case}/un/{route}"]
    if route == "beams":
        for a, b in zip(sh[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(sh[2:], want[2:]):
            np.testing.assert_allclose(a, b, rtol=1e-5)
    else:
        np.testing.assert_array_equal(_tokens(sh), _tokens(want))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_beams_on_a_group_equal_jax_sharded(results, case, world):
    got, ref = results
    rows, lens, scores, norm = ref[f"{case}/sh/beams"]
    for pre in [f"w{world}/r{r}" for r in range(world)] + ["one"]:
        np.testing.assert_array_equal(got[f"{pre}/{case}/beams/rows"], rows)
        np.testing.assert_array_equal(got[f"{pre}/{case}/beams/gen_lens"],
                                      lens)
        np.testing.assert_allclose(got[f"{pre}/{case}/beams/scores"],
                                   scores, rtol=1e-5)
        np.testing.assert_allclose(got[f"{pre}/{case}/beams/norm"], norm,
                                   rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_engine_medusa_rows_equal_jax_sharded(results, case, world):
    """Medusa and plain rows in one engine give JAX's sharded engine's
    rows; the first Medusa row is the route's solo Medusa stream."""
    got, ref = results
    for i, want in enumerate(ref[f"{case}/sh/engine"]):
        assert got[f"w{world}/r0/{case}/medusa/{i}"].tolist() == want
        assert got[f"one/{case}/medusa/{i}"].tolist() == want
    assert got[f"w{world}/r0/{case}/medusa/0"].tolist() == \
        _tokens(ref[f"{case}/sh/medusa/row0"]).tolist()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_engine_second_request_joins_mid_decode(results, case, world):
    got, _ = results
    at, total = got[f"w{world}/r0/{case}/medusa/joined_at"]
    assert 1 <= at < total


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("case", list(CASES))
def test_engine_follower_state_equals_the_leaders(results, case, world):
    got, _ = results
    pre = f"w{world}/r{{}}/{case}/medusa/state/{{}}"
    assert got[pre.format(0, "med_on")].any()
    for r in range(1, world):
        for key in STATE_KEYS:
            np.testing.assert_array_equal(got[pre.format(r, key)],
                                          got[pre.format(0, key)])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_window_batcher_on_a_group_equals_jax_sharded(results, case, world):
    """Three requests decoded as one group give JAX's rows."""
    got, ref = results
    assert int(got[f"w{world}/r0/{case}/window/largest"]) == 3
    for i, want in enumerate(ref[f"{case}/sh/window"]):
        assert got[f"w{world}/r0/{case}/window/{i}"].tolist() == want
        assert got[f"one/{case}/window/{i}"].tolist() == want


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("case", list(CASES))
def test_window_followers_decode_as_the_leader(results, case, world):
    got, _ = results
    pre = f"w{world}/r{{}}/{case}/window"
    n = int(got[pre.format(0) + "/decodes"])
    assert n >= 1
    for r in range(1, world):
        assert int(got[pre.format(r) + "/decodes"]) == n
        for i in range(n):
            for part in ("buf", "pos"):
                key = f"/decode/{i}/{part}"
                np.testing.assert_array_equal(got[pre.format(r) + key],
                                              got[pre.format(0) + key])


@pytest.mark.parametrize("fault,leader,follower", [
    ("leader", ["RuntimeError: poisoned plan", "RuntimeError"], "none"),
    ("plan", ["none", "RuntimeError: poisoned decode"],
     "RuntimeError: poisoned decode")])
def test_a_window_fault_on_a_group_ends_it_at_once(results, fault, leader,
                                                   follower):
    """The leader's own fault sends the follower "stop" (its loop
    returns); a poisoned plan raises on both ranks. The leader's requests
    fail from the fault on (a request after it finds the worker gone),
    its worker ends, and each rank is done in under a third of the
    group's timeout."""
    got, _ = results
    pre = f"w2/r{{}}/fail/{fault}"
    errors = [str(e) for e in got[f"{pre.format(0)}/errors"]]
    for e, want in zip(errors, leader):
        assert e.startswith(want), errors
    assert str(got[f"{pre.format(1)}/follower"]) == follower
    assert bool(got[f"{pre.format(0)}/closed"])
    for r in range(2):
        assert float(got[f"{pre.format(r)}/seconds"]) < \
            SPEC["fail_timeout"] / 3


def test_int8_weights_under_tp_raise(results):
    got, _ = results
    msg = str(got["w1/r0/int8_under_tp"])
    assert msg.startswith("ValueError") and "int8" in msg, msg


@pytest.mark.parametrize("which", ["draft_other_group",
                                   "draft_on_group_target_whole"])
def test_a_draft_on_another_group_raises(results, which):
    got, _ = results
    msg = str(got[f"w1/r0/{which}"])
    assert msg.startswith("ValueError") and "group" in msg, msg


def test_a_graph_key_holds_the_model_group(results):
    got, _ = results
    assert got["w1/r0/graph_keys_differ"].all()


@pytest.mark.parametrize("case", list(CASES))
def test_medusa_heads_are_accepted_and_rejected(results, case):
    """The tokens the sampled Medusa run's verify steps made, against the
    steps: more than one a step (proposals accepted), fewer than gamma + 1
    (proposals rejected)."""
    got, _ = results
    made, steps = (int(v) for v in got[f"one/{case}/medusa/steps"])
    assert steps < made < (SPEC["gamma"] + 1) * steps
