"""``repro_torch.obs`` against ``repro.obs``: the contracts of
docs/OBSERVABILITY.md, held on the port.

1. **Bit-identity** — obs-on and obs-off runs of one op stream give
   byte-identical tables and answers, in both modes, on one shard and on
   four.
2. **Shard-invariance** — the abstract counters are equal across
   ``n_shards ∈ {1, 2, 4}``, and equal to ``repro``'s registry for the same
   stream; so is the canonical directory's probe histogram.
3. **The same metrics as the reference** — the counters, histograms and
   span names of a sharded run, the delta fold's decisions, the physical
   probe histograms, and ``ServingEngine``'s ``serving.*`` metrics equal
   ``repro``'s for the same traffic; the ``REPRO_OBS`` switch and the
   ``repro-obs/1`` dump schema are the reference's.

JAX is imported inside the fixture ``j``, so the ``cuda`` test at the end
runs where there is no JAX.
"""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, state_columns, to_np  # noqa: F401
from repro_torch.configs import get_smoke_config
from repro_torch.core import WaitFreeGraph, maintenance
from repro_torch.core.types import OP_ADD_VERTEX, OP_REMOVE_VERTEX, state_from_numpy
from repro_torch.core.workloads import sample_batch, sample_query_pairs, sample_update_batch
from repro_torch.models import LM
from repro_torch.obs import metrics as obsm
from repro_torch.obs import probes
from repro_torch.serving import Request, ServingEngine

KEY_SPACE = 24

# tests/test_obs.py's abstract counters, which do not depend on how the
# tables are partitioned
SHARD_INVARIANT_COUNTERS = (
    "apply.batches",
    "apply.ops",
    "engine.vops",
    "engine.eops",
    "engine.inserted",
    "fastpath.eops",
    "fastpath.edge_dup",
)


@pytest.fixture
def j():
    """``repro``'s side, imported inside the fixture so that the card test at
    the end runs where there is no JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import WaitFreeGraph as JGraph
    from repro.core import maintenance as j_maint
    from repro.core.types import GraphState
    from repro.obs import metrics as j_obsm
    from repro.obs import probes as j_probes

    return SimpleNamespace(Graph=JGraph, maint=j_maint, obsm=j_obsm, probes=j_probes,
                           state=lambda st: GraphState(**{
                               k: jnp.asarray(v) for k, v in state_columns(st).items()}))


def _churn_stream(seed: int):
    """tests/test_obs.py's stream: bulk traversal traffic, a deletion wave,
    incarnation revivals, fresh edges, and a query batch."""
    rng = np.random.default_rng(seed)
    batches = [sample_batch(rng, 192, "traversal", key_space=KEY_SPACE) for _ in range(2)]
    kill = rng.choice(KEY_SPACE, size=8, replace=False).astype(np.int32)
    batches.append((np.full(8, OP_REMOVE_VERTEX, np.int32), kill, np.zeros(8, np.int32)))
    batches.append((np.full(4, OP_ADD_VERTEX, np.int32), kill[:4], np.zeros(4, np.int32)))
    batches.append(sample_batch(rng, 96, "traversal", key_space=KEY_SPACE))
    return batches, sample_query_pairs(rng, 32, KEY_SPACE)


def _run(seed, mode, *, obs, n_shards=1, graph=None, caps=(256, 1024), **kwargs):
    """The stream through a new port graph (or ``graph``, a class taking the
    reference's arguments), then one reachability query."""
    batches, (qu, qv) = _churn_stream(seed)
    if graph is None:
        g = WaitFreeGraph(*caps, mode=mode, n_shards=n_shards, obs=obs, device="cpu", **kwargs)
    else:
        g = graph(*caps, mode=mode, n_shards=n_shards, obs=obs, **kwargs)
    for ops, us, vs in batches:
        g.apply(ops, us, vs)
    return g, np.asarray(g.reachable(qu, qv))


def _states(g):
    return list(g.shards) if g.n_shards > 1 else [g.state]


def _state_bytes(g):
    return [tuple(to_np(a).tobytes() for a in st) for st in _states(g)]


def _hists(reg):
    return {name: reg.hist_counts(name) for name in reg.dump()["histograms"]}


# ---------------------------------------------------------------------------
# 1. obs on and off: byte-identical
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("mode", ["waitfree", "fpsp"])
def test_obs_on_off_bit_identical(mode, n_shards, seed):
    g_off, ans_off = _run(seed, mode, obs=False, n_shards=n_shards)
    g_on, ans_on = _run(seed, mode, obs=True, n_shards=n_shards)
    assert _state_bytes(g_on) == _state_bytes(g_off)
    assert ans_on.tolist() == ans_off.tolist()
    c = g_on.obs.counters()
    assert c["apply.batches"] == 5
    assert c["apply.ops"] == 192 + 192 + 8 + 4 + 96
    assert c["engine.vops"] + c["engine.eops"] == c["apply.ops"]
    assert g_on.obs.hist_counts("engine.claim_rounds")
    if mode == "fpsp":
        assert obsm.fastpath_frac(g_on.obs) is not None
        if n_shards == 1:
            assert c["fastpath.ops"] == c["apply.ops"]
    assert not g_off.obs.enabled and g_off.obs.counters() == {}


# ---------------------------------------------------------------------------
# 2. shard-invariance, and the reference's registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_shard_invariant_counters_match_repro(j, seed):
    runs = {n: _run(seed, "fpsp", obs=True, n_shards=n) for n in (1, 2, 4)}
    jg, j_ans = _run(seed, "fpsp", obs=True, n_shards=4, graph=j.Graph)
    want = jg.obs.counters()
    want_dir = j.probes.directory_probe_histogram(jg)
    for n, (g, ans) in runs.items():
        assert ans.tolist() == j_ans.tolist(), n
        c = g.obs.counters()
        for name in SHARD_INVARIANT_COUNTERS:
            assert c.get(name) == want.get(name), (n, name, c.get(name), want.get(name))
        for impl in ("device", "host"):
            assert probes.directory_probe_histogram(g, impl=impl) == want_dir, (n, impl)
    # the four-shard run's whole registry is the reference's, but the
    # reference's directory placement files host claim rounds
    c4 = runs[4][0].obs.counters()
    assert c4 == want
    h4, j_h4 = _hists(runs[4][0].obs), _hists(jg.obs)
    j_h4.pop("maintenance.claim_rounds", None)
    assert h4 == j_h4


@pytest.mark.parametrize("n_shards", [1, 2])
def test_registry_matches_repro_through_growth(j, n_shards):
    """Small tables: growth events and escalation counters, the rehash span,
    and the host placement's claim rounds (both on the host route), every
    counter, gauge, histogram and event equal to the reference's; the span
    names too (their times are the host's)."""
    kw = dict(caps=(32 * n_shards, 64 * n_shards), maintenance_impl="host")
    g, ans = _run(5, "fpsp", obs=True, n_shards=n_shards, **kw)
    jg, j_ans = _run(5, "fpsp", obs=True, n_shards=n_shards, graph=j.Graph, **kw)
    assert ans.tolist() == j_ans.tolist()
    g.probe_health()
    jg.probe_health()
    got, want = g.obs.dump(), jg.obs.dump()
    assert got["counters"]["growth.events"] > 0
    for key in ("schema", "counters", "gauges", "histograms", "events"):
        assert got[key] == want[key], key
    assert sorted(got["spans"]) == sorted(want["spans"])
    assert {s: v["count"] for s, v in got["spans"].items()} == {
        s: v["count"] for s, v in want["spans"].items()}
    if n_shards > 1:
        assert {"graph.apply_sharded", "phase.route", "phase.settle_vertices",
                "phase.answer_stabs", "phase.gather", "phase.settle_edges",
                "phase.compact", "csr.fuse", "maintenance.rehash.host"} <= set(got["spans"])


def test_delta_counters_match_repro(j):
    """A one-shard graph queried between update batches: the delta fold's
    decisions (folded, read-only, too large, capacity changed) and its
    touched-key histogram are the reference's.  On the host route, as the
    reference runs on the CPU: a device growth hands its snapshot to the
    queue, so the last batch would be folded (and found too large) where
    the host route rebuilds."""
    rng = np.random.default_rng(4)
    stream = [sample_batch(rng, 96, "traversal", key_space=KEY_SPACE)]
    stream += [sample_update_batch(rng, 8, key_space=KEY_SPACE) for _ in range(3)]
    stream += [(np.full(3, 3, np.int32), np.arange(3, dtype=np.int32), np.zeros(3, np.int32))]
    stream += [sample_batch(rng, 300, "traversal", key_space=160)]  # past a quarter: rebuild
    g = WaitFreeGraph(64, 256, obs=True, maintenance_impl="host", device="cpu")
    jg = j.Graph(64, 256, obs=True)
    for ops, us, vs in stream:
        for graph in (g, jg):
            graph.apply(ops, us, vs)
            graph.reachable([0, 1], [2, 3])
    c, want = g.obs.counters(), jg.obs.counters()
    assert {k: v for k, v in c.items() if k.startswith("csr.")} == {
        k: v for k, v in want.items() if k.startswith("csr.")}
    assert c["csr.delta.folded"] > 0
    assert g.obs.hist_counts("csr.delta.touched") == jg.obs.hist_counts("csr.delta.touched")


def test_probe_histograms_match_repro(j):
    """Physical histograms (per table, summed over shards) and the mean
    probe length of the same tables, carried across."""
    jg, _ = _run(2, "waitfree", obs=False, n_shards=4, graph=j.Graph, caps=(64, 256))
    states = [state_from_numpy(state_columns(st)) for st in jg.shards]
    assert probes.table_probe_histogram(states) == j.probes.table_probe_histogram(jg.shards)
    assert probes.mean_probe_len(states) == j.probes.mean_probe_len(jg.shards)
    assert probes.table_probe_histogram(states[0]) == j.probes.table_probe_histogram(jg.shards[0])
    reg = obsm.Registry()
    h = probes.record(reg, states)
    assert reg.hist_counts("probe.vertex") == h["vertex"]
    assert sum(h["vertex"].values()) == sum(int((to_np(st.v_key) != -1).sum()) for st in states)


def test_rehash_records_its_span_and_claim_rounds(j):
    g, _ = _run(1, "waitfree", obs=True)
    for impl in ("host", "device"):
        reg = obsm.Registry()
        with obsm.use(reg):
            st, _, ok = maintenance.rehash(g.state, 2 * g.state.v_capacity,
                                           2 * g.state.e_capacity, impl=impl)
        assert ok and reg.counters()["maintenance.rehash"] == 1
        assert f"maintenance.rehash.{impl}" in reg.dump()["spans"]
        # only the host placement counts its rounds on the host
        assert bool(reg.hist_counts("maintenance.claim_rounds")) == (impl == "host")
    h = probes.table_probe_histogram(st)
    assert h["vertex"] and max(h["vertex"]) <= 32
    jreg = j.obsm.Registry()
    with j.obsm.use(jreg):
        j.maint.rehash(j.state(g.state), 2 * g.state.v_capacity, 2 * g.state.e_capacity,
                       impl="host")
    reg = obsm.Registry()
    with obsm.use(reg):
        maintenance.rehash(g.state, 2 * g.state.v_capacity, 2 * g.state.e_capacity, impl="host")
    assert reg.hist_counts("maintenance.claim_rounds") == jreg.hist_counts(
        "maintenance.claim_rounds")


# ---------------------------------------------------------------------------
# the registry itself, the switch, the schema
# ---------------------------------------------------------------------------


def _exercise(m):
    """The same calls on a registry of either package's metrics module."""
    reg = m.Registry()
    reg.counter("a")
    reg.counter("a", 4)
    reg.gauge("g", 1.5)
    reg.hist("h", [1, 2, 2, 9])
    reg.hist("h", 3)
    reg.observe("lat", 2.0)
    reg.observe("lat", 4.0)
    for i in range(1030):
        reg.event("e", i=i)
    with m.use(reg):
        m.counter("ambient", 2)
        m.hist("ambient.h", [5, 5])
        with m.span("s"):
            pass
    reg.counter("fastpath.ops", 10)
    reg.counter("fastpath.conflicted", 3)
    return reg


def test_registry_api_matches_repro(j):
    reg, jreg = _exercise(obsm), _exercise(j.obsm)
    got, want = reg.dump(), jreg.dump()
    assert got.pop("spans").keys() == want.pop("spans").keys()
    assert got == want
    assert got["dropped_events"] == 6 and len(got["events"]) == 1024
    for name, q in (("h", 50), ("h", 99), ("lat", 50), ("nothing", 50)):
        assert reg.percentile(name, q) == jreg.percentile(name, q)
    assert obsm.fastpath_frac(reg) == j.obsm.fastpath_frac(jreg) == 0.7
    assert obsm.NOOP.dump() == j.obsm.NOOP.dump()
    assert obsm.active() is obsm.NOOP and obsm.resolve(False) is obsm.NOOP
    assert obsm.resolve(reg) is reg and obsm.resolve(True).enabled


def test_repro_obs_env_switch(monkeypatch):
    cfg = get_smoke_config("qwen2-7b")
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    monkeypatch.delenv("REPRO_OBS", raising=False)
    assert not WaitFreeGraph(64, 256, device="cpu").obs.enabled
    monkeypatch.setenv("REPRO_OBS", "1")
    assert WaitFreeGraph(64, 256, device="cpu").obs.enabled
    assert ServingEngine(cfg, params, device="cpu").obs.enabled
    monkeypatch.setenv("REPRO_OBS", "off")
    assert not WaitFreeGraph(64, 256, n_shards=2, device="cpu").obs.enabled
    assert not ServingEngine(cfg, params, device="cpu").obs.enabled
    # the flag beats the environment
    monkeypatch.setenv("REPRO_OBS", "yes")
    assert not WaitFreeGraph(64, 256, obs=False, device="cpu").obs.enabled
    shared = obsm.Registry()
    assert WaitFreeGraph(64, 256, obs=shared, device="cpu").obs is shared


def _load_tool(name: str):
    path = Path(__file__).resolve().parent.parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_registry_dump_schema_roundtrips(tmp_path, capsys):
    g, _ = _run(2, "fpsp", obs=True, n_shards=2)
    g.probe_health()
    dump = json.loads(json.dumps(g.obs.dump()))  # JSON-serializable
    assert dump["schema"] == "repro-obs/1"
    assert dump["counters"]["apply.batches"] == 5
    hist = dump["histograms"]["engine.claim_rounds"]
    assert hist["count"] == sum(hist["counts"].values())
    assert set(dump["spans"]) >= {"graph.apply_sharded", "phase.route", "csr.fuse"}
    assert set(dump["spans"]["phase.route"]) == {"count", "total_ms", "mean_ms", "p50_ms",
                                                 "p99_ms", "max_ms"}
    # the reference's report tool renders the port's dump
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(dump))
    assert _load_tool("obs_report").main([str(path)]) == 0
    assert "engine.claim_rounds" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_serving_metrics_match_repro():
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import LM as JLM
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JEngine
    from repro_torch.models import params_from_numpy

    jcfg = j_smoke("qwen2-7b")
    jp = JLM(jcfg).init(jax.random.key(0))
    cfg = get_smoke_config("qwen2-7b")
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(2)
    reqs = [dict(id=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(3, 12))).astype(np.int32),
                 max_new_tokens=4, temperature=0.8 if i % 2 else 0.0) for i in range(6)]
    jeng = JEngine(jcfg, jp, max_batch=2, max_len=48, page_size=8, seed=1, obs=True)
    teng = ServingEngine(cfg, tp, max_batch=2, max_len=48, page_size=8, seed=1, obs=True,
                         device="cpu")
    off = ServingEngine(cfg, tp, max_batch=2, max_len=48, page_size=8, seed=1, obs=False,
                        device="cpu")
    for r in reqs:
        for eng, cls in ((jeng, JRequest), (teng, Request), (off, Request)):
            eng.submit(cls(**r))
    jdone, tdone, odone = jeng.run(), teng.run(), off.run()
    assert {i: r.generated for i, r in tdone.items()} == {i: r.generated for i, r in jdone.items()}
    assert {i: r.generated for i, r in odone.items()} == {i: r.generated for i, r in tdone.items()}
    got, want = teng.obs.dump(), jeng.obs.dump()
    for key in ("counters", "gauges", "histograms"):
        assert got[key] == want[key], key
    assert got["counters"]["serving.finished"] == 6
    assert set(got["spans"]) == set(want["spans"]) == {"serving.tick"}
    assert got["spans"]["serving.tick"]["count"] == want["spans"]["serving.tick"]["count"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 4])
def test_cuda_obs_on_off_identical_and_counters_match_cpu(cuda_device, n_shards):
    batches, (qu, qv) = _churn_stream(3)
    graphs = {}
    for name, dev, obs in (("cpu", "cpu", True), ("on", cuda_device, True),
                           ("off", cuda_device, False)):
        g = WaitFreeGraph(64, 256, mode="fpsp", n_shards=n_shards, obs=obs, device=dev)
        for ops, us, vs in batches:
            g.apply(ops, us, vs)
        graphs[name] = (g, g.reachable(qu, qv))
    assert _state_bytes(graphs["on"][0]) == _state_bytes(graphs["off"][0])
    assert _state_bytes(graphs["on"][0]) == _state_bytes(graphs["cpu"][0])
    assert graphs["on"][1].tolist() == graphs["off"][1].tolist() == graphs["cpu"][1].tolist()
    on, cpu = graphs["on"][0].obs, graphs["cpu"][0].obs
    assert on.counters() == cpu.counters()
    assert _hists(on) == _hists(cpu)
    assert (probes.directory_probe_histogram(graphs["on"][0])
            == probes.directory_probe_histogram(graphs["cpu"][0]))
