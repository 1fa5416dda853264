"""The port's serving path against ``repro``'s, and the reference's own
serving checks ported.

* ``PagedKVManager``: page tables, free list, op log and graph state equal
  the reference's for the same op stream, and ``replay`` rebuilds them.
* ``ServingEngine``: the same requests (greedy and sampled) on the same
  parameters generate the same tokens, in the same number of ticks, with
  the same page tables, as the reference's engine; for qwen2-7b, and for
  rwkv6-3b and zamba2-1.2b with more requests than slots, so that slot
  reuse resets the recurrent states and the shared block's KV rows.
* The checks of ``tests/test_serving.py`` for the dense family: the engine
  equals free-running decode, slot reuse is isolated, batching equals
  decoding alone, pages do not leak, failover replays exactly, and
  ``ContainsEdge`` validates ownership.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_states_equal
from repro_torch.configs import get_smoke_config
from repro_torch.models import LM, params_from_numpy
from repro_torch.serving import PagedKVManager, Request, ServingEngine


@pytest.fixture(scope="module")
def qwen():
    cfg = get_smoke_config("qwen2-7b")
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    return cfg, params


@pytest.fixture(scope="module")
def both():
    """The reference's smoke qwen2-7b parameters, in both packages."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import LM as JLM

    jcfg = j_smoke("qwen2-7b")
    jp = JLM(jcfg).init(jax.random.key(0))
    cfg = get_smoke_config("qwen2-7b")
    return jcfg, jp, cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _requests(seed, n, vocab, max_new=4):
    rng = np.random.default_rng(seed)
    return [dict(id=i, prompt=rng.integers(0, vocab, int(rng.integers(3, 10))).astype(np.int32),
                 max_new_tokens=max_new, temperature=0.8 if i % 2 else 0.0)
            for i in range(n)]


def test_paged_manager_matches_repro_op_for_op():
    pytest.importorskip("jax")
    from repro.serving import PagedKVManager as JManager

    jm = JManager(24, 4)
    tm = PagedKVManager(24, 4, device="cpu")
    rng = np.random.default_rng(0)
    live, next_id = {}, 0
    for step in range(30):
        admit, extend, finish = {}, [], []
        if len(live) < 4 and len(tm.free) >= 4:
            admit[next_id] = int(rng.integers(1, 9))
            next_id += 1
        for seq in list(live):
            if rng.random() < 0.2:
                finish.append(seq)
            elif tm.seq_len[seq] < 12 and len(tm.free) > 1:
                extend.append(seq)
        want = jm.step_ops(admit, extend, finish)
        got = tm.step_ops(admit, extend, finish)
        assert got == want, step
        for seq in finish:
            live.pop(seq)
        live.update(admit)
        assert tm.seq_pages == jm.seq_pages and tm.free == jm.free
        assert tm.seq_len == jm.seq_len and tm.op_log == jm.op_log
        assert_states_equal(tm.graph.state, jm.graph.state, f"step {step}")
    assert tm.owns(min(live), tm.seq_pages[min(live)][0])
    twin = tm.replay()
    assert twin.seq_pages == tm.seq_pages and sorted(twin.free) == sorted(tm.free)
    assert_states_equal(twin.graph.state, jm.replay().graph.state, "replay")


def test_engine_matches_repro(both):
    jcfg, jp, cfg, tp = both
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JEngine

    reqs = _requests(9, 6, cfg.vocab, max_new=5)
    jeng = JEngine(jcfg, jp, max_batch=3, max_len=64, page_size=8, seed=3)
    teng = ServingEngine(cfg, tp, max_batch=3, max_len=64, page_size=8, seed=3, device="cpu")
    for r in reqs:
        jeng.submit(JRequest(**r))
        teng.submit(Request(**r))
    # step both a few ticks, comparing the page tables mid-flight
    for _ in range(5):
        jeng.tick()
        teng.tick()
        assert teng.pages.seq_pages == jeng.pages.seq_pages
        assert_states_equal(teng.pages.graph.state, jeng.pages.graph.state)
    jdone, tdone = jeng.run(), teng.run()
    assert sorted(tdone) == sorted(jdone)
    for i in jdone:
        assert tdone[i].generated == jdone[i].generated, f"request {i}"
    assert teng.ticks == jeng.ticks
    assert teng.pages.op_log == jeng.pages.op_log
    assert_states_equal(teng.pages.graph.state, jeng.pages.graph.state)


# leaves the reference initialises to constants, given numpy noise (as in
# tests/test_torch_models.py) so that the token shift and bonus take part
NOISY = {"rwkv6-3b": ("mu", "cmu", "bonus", "w0"),
         "zamba2-1.2b": ("A_log", "dt_bias", "conv_b", "D")}


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_recurrent_engine_matches_repro(arch):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import LM as JLM
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JEngine

    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    tree = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.key(0)))
    rng = np.random.default_rng(8)
    for name in NOISY[arch]:
        leaf = tree["blocks"][name]
        tree["blocks"][name] = (leaf + 0.3 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(cfg, tree, device="cpu")

    reqs = _requests(10, 5, cfg.vocab, max_new=4)
    jeng = JEngine(jcfg, jp, max_batch=2, max_len=64, page_size=8, seed=2)
    teng = ServingEngine(cfg, tp, max_batch=2, max_len=64, page_size=8, seed=2, device="cpu")
    for r in reqs:
        jeng.submit(JRequest(**r))
        teng.submit(Request(**r))
    reused = 0
    while jeng.queue or any(s is not None for s in jeng.slots):
        before = [s is None for s in teng.slots]
        jeng.tick()
        teng.tick()
        reused += sum(b and s is not None for b, s in zip(before, teng.slots)) if teng.ticks > 1 \
            else 0
        assert teng.pages.seq_pages == jeng.pages.seq_pages
        assert [r and r.id for r in teng.slots] == [r and r.id for r in jeng.slots]
    assert reused >= 2  # slots were handed to a second request while the cache lived on
    assert sorted(teng.finished) == sorted(jeng.finished) == list(range(5))
    for i in jeng.finished:
        assert teng.finished[i].generated == jeng.finished[i].generated, f"request {i}"
    assert teng.ticks == jeng.ticks
    assert teng.pages.op_log == jeng.pages.op_log
    assert_states_equal(teng.pages.graph.state, jeng.pages.graph.state)


def _free_running(cfg, params, prompt, n_new):
    """Single-sequence incremental decode, greedy."""
    model = LM(cfg, device="cpu")
    cache = model.decode_init(1, 64)
    toks, gen = list(prompt), []
    for t in range(len(prompt) + n_new - 1):
        cur = toks[t] if t < len(toks) else gen[-1]
        logits, cache = model.decode_step(params, torch.tensor([[cur]]), cache)
        if t >= len(prompt) - 1:
            gen.append(int(torch.argmax(logits[0, -1, : cfg.vocab])))
    return gen


def test_engine_matches_free_running_decode(qwen):
    cfg, params = qwen
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, 7).astype(np.int32)
    eng = ServingEngine(cfg, params, max_batch=2, max_len=64, page_size=8, device="cpu")
    eng.submit(Request(id=0, prompt=prompt, max_new_tokens=5))
    assert eng.run()[0].generated == _free_running(cfg, params, prompt, 5)


def test_slot_reuse_is_isolated(qwen):
    """Two waves through the same slots: wave-2 results equal a fresh
    engine's (no leakage from the previous occupant's KV rows)."""
    cfg, params = qwen
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(4, 9))).astype(np.int32)
               for _ in range(6)]
    eng = ServingEngine(cfg, params, max_batch=2, max_len=64, page_size=8, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(id=i, prompt=p, max_new_tokens=4))
    done = eng.run()
    for i, p in enumerate(prompts):
        fresh = ServingEngine(cfg, params, max_batch=2, max_len=64, page_size=8, device="cpu")
        fresh.submit(Request(id=0, prompt=p, max_new_tokens=4))
        assert done[i].generated == fresh.run()[0].generated, f"req {i} leaked"


def test_batching_matches_single(qwen):
    cfg, params = qwen
    rng = np.random.default_rng(5)
    p1 = rng.integers(0, cfg.vocab, 6).astype(np.int32)
    p2 = rng.integers(0, cfg.vocab, 9).astype(np.int32)
    eng = ServingEngine(cfg, params, max_batch=2, max_len=64, page_size=8, device="cpu")
    eng.submit(Request(id=0, prompt=p1, max_new_tokens=4))
    eng.submit(Request(id=1, prompt=p2, max_new_tokens=4))
    done = eng.run()
    assert done[0].generated == _free_running(cfg, params, p1, 4)
    assert done[1].generated == _free_running(cfg, params, p2, 4)


def test_page_accounting_no_leaks(qwen):
    cfg, params = qwen
    eng = ServingEngine(cfg, params, max_batch=2, max_len=64, page_size=8, device="cpu")
    for r in _requests(6, 8, cfg.vocab):
        eng.submit(Request(**r))
    eng.run()
    assert len(eng.pages.free) == eng.pages.num_pages
    assert eng.pages.seq_pages == {}


def test_failover_replay_identical(qwen):
    cfg, params = qwen
    eng = ServingEngine(cfg, params, max_batch=2, max_len=64, page_size=8, device="cpu")
    for r in _requests(7, 5, cfg.vocab, max_new=3):
        eng.submit(Request(**r))
    for _ in range(4):  # fail over mid-flight, with live sequences
        eng.tick()
    assert eng.pages.seq_pages
    twin = eng.failover()
    assert twin.seq_pages == eng.pages.seq_pages
    assert sorted(twin.free) == sorted(eng.pages.free)
    assert twin.graph.snapshot() == eng.pages.graph.snapshot()
    assert twin.graph.mode == "fpsp"


def test_page_ownership_via_graph(qwen):
    cfg, params = qwen
    eng = ServingEngine(cfg, params, max_batch=1, max_len=64, page_size=8, device="cpu")
    eng.submit(Request(id=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=3))
    eng.tick()
    pages = eng.pages.seq_pages[0]
    assert pages and all(eng.pages.owns(0, p) for p in pages)
    eng.run()
    assert not eng.pages.owns(0, pages[0])  # released on completion


def test_obs_and_the_cpu_default_are_refused(qwen, monkeypatch):
    """``obs`` is accepted since the telemetry slice (its counters are held
    in tests/test_torch_obs.py); a card is still required by default."""
    cfg, params = qwen
    assert ServingEngine(cfg, params, obs=True, device="cpu").obs.enabled
    assert not ServingEngine(cfg, params, obs=False, device="cpu").obs.enabled
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVManager(8, 4)
