"""The recurrent stacks on a mesh: the d-sharded layout.

A gloo world of 4 CPU ranks (once a session), the f32 smoke configs of
rwkv6-3b (ssm) and zamba2-1.2b (hybrid), every per-channel constant of
their layers (the lerps, the bonus, the decay base, the norms' scales, and
mamba2's ``A_log``, ``D``, ``dt_bias``, ``conv_b``) drawn off its init so
that a rank reading another head's share would show, on (2, 2), (1, 4) and
(4, 1) ("data", "model") meshes of that world, with ``run["sp"]`` (the
default on a mesh), each rank holding only its blocks; and an uneven deal:
rwkv6 at d_model 80 (5 heads of 16) on (1, 4), dealt 1, 1, 1, 2.  Against
the port's one device on the global batch, within 2e-5 (relative L2):

* the prefill's last-token logits and its final states (whole on every
  model rank), the f32 loss, and every gradient leaf (each rank's blocks,
  under remat).  zamba2's gradients are held in f32.  rwkv6's random stack
  amplifies f32 rounding layer by layer, so two f32 orderings of the same
  sums (the mesh's partial sums over "model" against one device's) give
  gradient leaves further apart than 2e-5: its gradients are held within
  2e-5 in float64, mesh and one device alike (``_float64``, in the world's
  processes only), and its f32 gradients within ``F32_GRAD_TOL`` of one
  device's f32 ones.  That limit is set from the readings of
  ``tools/torch_mesh_readings.py --part rwkv6`` (three seeds of parameters
  and batch, every rwkv6 case here, each rank's blocks): the mesh's f32
  leaves lay at most 1.02e-3 from one device's f32 ones, and one device's
  f32 leaves themselves up to 1.07e-3 from its float64 ones, so f32 alone
  moves a leaf of this stack by as much;
* between layers a rank holds its (B/D, S, d/M) block of the residual: the
  d columns [m d/M, (m+1) d/M) of the one-device residual at each layer;
* each rank's scans run its dealt heads, [⌊H m/M⌋, ⌊H (m+1)/M⌋);
* no layer reads the parameters gathered whole (``LM._gathered``): each
  gathers its own weights inside its checkpoint, with no other layer's
  gathered weights alive; ``sp=False`` still runs gathered whole and
  matches one device.

The one-device oracles run in the world's processes too, dealt over its
ranks.  The mesh's f32 loss on (2, 2) is also held to ``repro``'s one-device loss
of the same parameters and batch (JAX imported in a fixture).
"""

import functools
import sys
import weakref
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from _torch_dist import spawn_once
from _torch_parity import one_thread  # noqa: F401
from repro_torch.configs import get_smoke_config
from repro_torch.models import LM
from repro_torch.models import blocks as TB
from repro_torch.models.lm import params_to_numpy
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.parallel.mesh import MeshDescription
from repro_torch.parallel.spec import dealt, local_shard

ARCHS = ["rwkv6-3b", "zamba2-1.2b"]
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
UNEVEN = "rwkv6-3b@80"          # rwkv6 at d_model 80: 5 heads of 16
CASES = [(a, m) for m in MESHES for a in ARCHS] + [(UNEVEN, "1x4")]
IDS = [f"{a}|{m}" for a, m in CASES]
CONTINUED = [(a, m) for a, m in CASES if m == "1x4"]  # prefills from a drawn state
B, SEQ, TOL = 4, 32, 2e-5
F32_GRAD_TOL = 2e-3  # rwkv6's f32 gradients, mesh against one device (the docstring)
VIEW_MESH = "2x2"


def _cfg(arch):
    if arch == UNEVEN:
        return get_smoke_config("rwkv6-3b").scaled(d_model=80)
    return get_smoke_config(arch)


def _params(cfg):
    """Parameters from a seed, every block leaf that inits to a constant
    drawn around it."""
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    meta = model.meta()["blocks"]
    for name in sorted(meta):
        for key, m in (meta[name].items() if isinstance(meta[name], dict) else [(None, meta[name])]):
            if m.init not in ("zeros", "ones"):
                continue
            tree = params["blocks"] if key is None else params["blocks"][name]
            k = name if key is None else key
            tree[k] = tree[k] + 0.5 * torch.rand(tree[k].shape, generator=g)
    return params


def _batch(cfg):
    rng = np.random.default_rng(1)
    mask = np.ones((B, SEQ), np.float32)
    mask[1, ::3] = 0.0
    mask[2, :5] = 0.0
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, SEQ)).astype(np.int32)),
            "targets": torch.as_tensor(rng.integers(0, cfg.vocab, (B, SEQ)).astype(np.int32)),
            "mask": torch.as_tensor(mask)}


def _states(model, cfg):
    """Every layer's state for the global batch, drawn from a seed (each
    leaf of ``init_recurrent_states``' shapes, standard normal times 0.5)."""
    rng = np.random.default_rng(2)
    like = model.init_recurrent_states(B, cfg.param_dtype)
    return {k: torch.as_tensor((0.5 * rng.standard_normal(tuple(like[k].shape))).astype(np.float32))
            for k in sorted(like)}


def _rows(shape, d):
    per = B // shape[0]
    return slice(d * per, (d + 1) * per)


@contextmanager
def _float64():
    """The port's arithmetic in float64 in this process: its f32 casts (the
    ``F32`` of the recurrent blocks, the layers and the plain scan), its
    parameter dtype and torch's default dtype widened, and restored after."""
    from repro_torch.kernels.ssd_scan import ref as scan_ref
    from repro_torch.models import layers as TLy
    from repro_torch.models.config import ArchConfig

    mods = (TB, TLy, scan_ref)
    saved = [m.F32 for m in mods], ArchConfig.param_dtype, torch.get_default_dtype()
    for m in mods:
        m.F32 = torch.float64
    ArchConfig.param_dtype = property(lambda self: torch.float64)
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        for m, f in zip(mods, saved[0]):
            m.F32 = f
        ArchConfig.param_dtype = saved[1]
        torch.set_default_dtype(saved[2])


@contextmanager
def _watch_layers(seen: list):
    """Records each recurrent layer's input residual (shape and values) and
    the head count of each scan."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    real = TB.rwkv6_block_apply, TB.mamba2_block_apply, ssd_ops.ssd_scan

    def spy(fn):
        def apply(p, cfg, x, *a, **kw):
            seen.append(("x", x.detach().clone()))
            return fn(p, cfg, x, *a, **kw)
        return apply

    def scan(q, *a, **kw):
        seen.append(("heads", q.shape[1]))
        return real[2](q, *a, **kw)

    TB.rwkv6_block_apply, TB.mamba2_block_apply, ssd_ops.ssd_scan = \
        spy(real[0]), spy(real[1]), scan
    try:
        yield
    finally:
        TB.rwkv6_block_apply, TB.mamba2_block_apply, ssd_ops.ssd_scan = real


def _loss_grads(model, blocks, mine, run):
    leaves = [t.detach().requires_grad_() for t in tree_leaves(blocks)]
    it = iter(leaves)
    loss = model.loss(tree_map(lambda _: next(it), blocks), mine, run=run)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [None if g is None else g.numpy() for g in grads]


def _case(arch, mesh, name, sp=True, f64=False):
    """One rank's prefill (logits, states, hidden, the layers' inputs and
    scans' heads, and a prefill from a drawn state where the case is
    CONTINUED), loss and gradients on the mesh ``MESHES[name]``; with ``f64``
    the loss and gradients alone, in float64."""
    shape = MESHES[name]
    cfg = _cfg(arch)
    model = LM(cfg, device="cpu")
    specs = model.pspecs(multi_pod=False)
    params = _params(cfg)
    batch = _batch(cfg)
    if f64:
        params = tree_map(lambda t: t.double(), params)
        batch["mask"] = batch["mask"].double()
    blocks = tree_map(lambda t, s: local_shard(t, s, mesh), params, specs)
    mine = {k: v[_rows(shape, mesh.get_local_rank("data"))] for k, v in batch.items()}
    run = {"mesh": mesh, "sp": sp}
    out = {}
    if f64:
        with _float64():
            out["loss"], out["grads"] = _loss_grads(model, blocks, mine, run)
        return out
    seen = []
    with torch.no_grad(), _watch_layers(seen):
        states = model.init_recurrent_states(mine["tokens"].shape[0], cfg.param_dtype)
        logits, _, new = model.prefill(blocks, mine["tokens"], run=run, states=states)
    out.update(logits=logits.numpy(), states={k: v.numpy() for k, v in new.items()},
               inputs=[t.numpy() for kind, t in seen if kind == "x"],
               heads=[h for kind, h in seen if kind == "heads"])
    if sp and (arch, name) in CONTINUED:
        r = _rows(shape, mesh.get_local_rank("data"))
        drawn = {k: v[:, r] for k, v in _states(model, cfg).items()}
        with torch.no_grad():
            logits, _, new = model.prefill(blocks, mine["tokens"], run=run, states=drawn)
        out["continued"] = {"logits": logits.numpy(),
                            "states": {k: v.numpy() for k, v in new.items()}}
    with torch.no_grad():
        out["hidden"] = model.hidden_states(blocks, mine["tokens"], run=run)[0].numpy()
    out["loss"], out["grads"] = _loss_grads(model, blocks, mine, run)
    return out


def _oracle64(arch):
    """One device's f64 loss and gradients on the global batch."""
    cfg = _cfg(arch)
    params = tree_map(lambda t: t.double(), _params(cfg))
    batch = _batch(cfg)
    batch["mask"] = batch["mask"].double()
    with _float64():
        loss, grads = _loss_grads(LM(cfg, device="cpu"), params, batch, {})
    return {"loss": loss, "grads": grads}


def _views_case(arch, mesh):
    """The loss and backward on ``mesh`` with every layer's parameter views
    (``collectives.param_view`` inside a block) recorded: for each layer,
    the bytes of earlier layers' gathered views still alive when it
    gathers; whether ``LM._gathered`` ran."""
    from repro_torch.parallel import collectives as C

    cfg = _cfg(arch)
    model = LM(cfg, device="cpu")
    blocks = tree_map(lambda t, s: local_shard(t, s, mesh), _params(cfg),
                      model.pspecs(multi_pod=False))
    mine = {k: v[_rows(MESHES[VIEW_MESH], mesh.get_local_rank("data"))]
            for k, v in _batch(cfg).items()}
    layers, alive, called = [], [], []
    real_view, real_gathered = C.param_view, LM._gathered
    real_apply = TB.rwkv6_block_apply, TB.mamba2_block_apply

    def param_view(t, spec, mesh_, *, model):
        out = real_view(t, spec, mesh_, model=model)
        if out.untyped_storage().data_ptr() != t.untyped_storage().data_ptr():
            alive.append(weakref.ref(out))
        return out

    def spy(fn):
        def apply(*a, **kw):
            layers.append(sum(r() is not None for r in alive))
            return fn(*a, **kw)
        return apply

    def gathered(self, *a, **kw):
        called.append(1)
        return real_gathered(self, *a, **kw)

    C.param_view, LM._gathered = param_view, gathered
    TB.rwkv6_block_apply, TB.mamba2_block_apply = spy(real_apply[0]), spy(real_apply[1])
    try:
        loss, grads = _loss_grads(model, blocks, mine, {"mesh": mesh, "sp": True})
    finally:
        C.param_view, LM._gathered = real_view, real_gathered
        TB.rwkv6_block_apply, TB.mamba2_block_apply = real_apply
    return {"held": layers, "gathered_whole": bool(called), "loss": loss}


def _rank(rank, world):
    from repro_torch.parallel.mesh import make_host_mesh

    meshes = {name: make_host_mesh(shape, device_type="cpu") for name, shape in MESHES.items()}
    out = {}
    for arch, name in CASES:
        out[f"{arch}|{name}"] = _case(arch, meshes[name], name)
    for arch in ARCHS:
        out[f"{arch}|whole"] = _case(arch, meshes[VIEW_MESH], VIEW_MESH, sp=False)
        out[f"{arch}|views"] = _views_case(arch, meshes[VIEW_MESH])
    # rwkv6's gradients in float64; the one-device oracles dealt over the ranks
    f64 = [(a, m) for a, m in CASES if a != "zamba2-1.2b"]
    for arch, name in f64:
        out[f"{arch}|{name}|f64"] = _case(arch, meshes[name], name, f64=True)
    jobs = [(a, "oracle", _one_device) for a in sorted({a for a, _ in CASES})]
    jobs += [(a, "oracle64", _oracle64) for a in sorted({a for a, _ in f64})]
    for i, (arch, kind, fn) in enumerate(jobs):
        if i % world == rank:
            out[f"{arch}|{kind}"] = fn(arch)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_once("recurrent_tp", _rank, 4, tmp_path_factory)


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """The tests' own comparisons on one torch thread
    (``_torch_parity.one_thread``)."""


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Drops JAX's compiled executables when the module ends (see
    ``test_torch_dryrun.py``)."""
    yield
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()


# ---------------------------------------------------------------------------
# the one-device oracles
# ---------------------------------------------------------------------------

def _oracle(ranks, arch, kind="oracle"):
    """The one-device oracle of ``arch`` that a rank of the world ran."""
    return next(r[f"{arch}|{kind}"] for r in ranks if f"{arch}|{kind}" in r)


def _one_device(arch):
    """One device on the global batch: the prefill's logits and states (and
    from a drawn state), the layers' input residuals, the hidden states, the
    loss and gradients."""
    cfg = _cfg(arch)
    model = LM(cfg, device="cpu")
    params = _params(cfg)
    batch = _batch(cfg)
    seen = []
    with torch.no_grad(), _watch_layers(seen):
        states = model.init_recurrent_states(B, cfg.param_dtype)
        logits, _, new = model.prefill(params, batch["tokens"], states=states)
    with torch.no_grad():
        hidden = model.hidden_states(params, batch["tokens"])[0]
    loss, grads = _loss_grads(model, params, batch, {})
    with torch.no_grad():
        logits2, _, new2 = model.prefill(params, batch["tokens"], states=_states(model, cfg))
    return {"logits": logits.numpy(), "states": {k: v.numpy() for k, v in new.items()},
            "continued": {"logits": logits2.numpy(),
                          "states": {k: v.numpy() for k, v in new2.items()}},
            "inputs": [t.numpy() for kind, t in seen if kind == "x"],
            "hidden": hidden.numpy(), "loss": loss,
            "grads": [np.zeros(t.shape, t.numpy().dtype) if g is None else g
                      for t, g in zip(tree_leaves(params), grads)]}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _close_leaves(got, want, what, tol=TOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = np.zeros(w.shape, w.dtype) if g is None else g
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        if np.linalg.norm(w) < 1e-6:
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{what} leaf {i}")
        else:
            assert _rel_l2(g, w) <= tol, (what, i, _rel_l2(g, w))


@functools.lru_cache(maxsize=None)
def _leaf_specs(arch):
    return tuple(tree_leaves(LM(_cfg(arch), device="meta").pspecs(multi_pod=False)))


def _blocks(leaves, arch, rank, shape):
    specs = _leaf_specs(arch)
    desc = MeshDescription(shape, ("data", "model"))
    coord = {"data": rank // shape[1], "model": rank % shape[1]}
    return [local_shard(torch.from_numpy(np.array(w, order="C")), s, desc, coord=coord).numpy()
            for w, s in zip(leaves, specs)]


# ---------------------------------------------------------------------------
# the mesh against one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prefill_logits_and_hidden_match_one_device(ranks, case):
    """The last token's logits and the hidden states of the rank's rows,
    alike on every model rank."""
    arch, name = case
    shape = MESHES[name]
    want = _oracle(ranks, arch)
    for rank in range(4):
        got = ranks[rank][f"{arch}|{name}"]
        r = _rows(shape, rank // shape[1])
        for key in ("logits", "hidden"):
            assert got[key].shape == want[key][r].shape
            assert _rel_l2(got[key], want[key][r]) <= TOL, (rank, key)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_final_states_match_one_device(ranks, case):
    """The prefill's new states, whole on every model rank: rwkv6's token
    shifts and h, mamba2's conv window and h."""
    arch, name = case
    shape = MESHES[name]
    want = _oracle(ranks, arch)["states"]
    for rank in range(4):
        got = ranks[rank][f"{arch}|{name}"]["states"]
        assert sorted(got) == sorted(want)
        r = _rows(shape, rank // shape[1])
        for k in want:
            assert got[k].shape == want[k][:, r].shape, k
            assert _rel_l2(got[k], want[k][:, r]) <= TOL, (rank, k, _rel_l2(got[k], want[k][:, r]))


@pytest.mark.parametrize("case", CONTINUED, ids=[f"{a}|{m}" for a, m in CONTINUED])
def test_prefill_from_a_state_matches_one_device(ranks, case):
    """A prefill that continues a drawn nonzero state (rwkv6's token shifts
    and h, mamba2's conv window and h), of which each rank reads its heads'
    and channels' share: the last token's logits and the new states."""
    arch, name = case
    shape = MESHES[name]
    want = _oracle(ranks, arch)["continued"]
    for rank in range(4):
        got = ranks[rank][f"{arch}|{name}"]["continued"]
        r = _rows(shape, rank // shape[1])
        assert _rel_l2(got["logits"], want["logits"][r]) <= TOL, rank
        assert sorted(got["states"]) == sorted(want["states"])
        for k, w in want["states"].items():
            assert got["states"][k].shape == w[:, r].shape, k
            assert _rel_l2(got["states"][k], w[:, r]) <= TOL, (rank, k)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_loss_matches_one_device(ranks, case):
    arch, name = case
    want = _oracle(ranks, arch)["loss"]
    for rank in range(4):
        np.testing.assert_allclose(ranks[rank][f"{arch}|{name}"]["loss"], want, rtol=TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gradients_match_one_device(ranks, case):
    """Each rank's blocks of every gradient leaf against one device's: in
    f32 for zamba2, in float64 for rwkv6 (the module docstring), whose f64
    loss is held too, and whose f32 leaves are held within F32_GRAD_TOL."""
    arch, name = case
    shape = MESHES[name]
    if arch == "zamba2-1.2b":
        key, want = f"{arch}|{name}", _oracle(ranks, arch)
    else:
        key, want = f"{arch}|{name}|f64", _oracle(ranks, arch, "oracle64")
    for rank in range(4):
        got = ranks[rank][key]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
        _close_leaves(got["grads"], _blocks(want["grads"], arch, rank, shape),
                      f"{key}, rank {rank}")
        if arch != "zamba2-1.2b":
            _close_leaves(ranks[rank][f"{arch}|{name}"]["grads"],
                          _blocks(_oracle(ranks, arch)["grads"], arch, rank, shape),
                          f"{arch}|{name} in f32, rank {rank}", tol=F32_GRAD_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_residual_is_the_ranks_d_block(ranks, case):
    """Every layer's input on a rank: its (B/D, S, d/M) block, the d
    columns [m d/M, (m+1) d/M) of the one-device residual there."""
    arch, name = case
    shape = MESHES[name]
    cfg = _cfg(arch)
    want = _oracle(ranks, arch)["inputs"]
    n = cfg.d_model // shape[1]
    for rank in range(4):
        got = ranks[rank][f"{arch}|{name}"]["inputs"]
        assert len(got) == len(want) == cfg.n_layers
        r, m = _rows(shape, rank // shape[1]), rank % shape[1]
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == (B // shape[0], SEQ, n), (rank, i)
            assert _rel_l2(g, w[r, :, m * n:(m + 1) * n]) <= TOL, (rank, i)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scans_run_the_dealt_heads(ranks, case):
    arch, name = case
    cfg = _cfg(arch)
    n_heads = (2 * cfg.d_model if arch == "zamba2-1.2b" else cfg.d_model) // cfg.ssm.head_dim
    deal = dealt(n_heads, MESHES[name][1])
    for rank in range(4):
        lo, hi = deal[rank % MESHES[name][1]]
        assert ranks[rank][f"{arch}|{name}"]["heads"] == [hi - lo] * cfg.n_layers


def test_heads_are_dealt_in_contiguous_ranges():
    assert dealt(5, 4) == [(0, 1), (1, 2), (2, 3), (3, 5)]
    rwkv6_3b = dealt(40, 16)  # rwkv6-3b's heads on the production mesh
    assert [hi - lo for lo, hi in rwkv6_3b] == [2, 3] * 8
    assert rwkv6_3b[-1][1] == 40 and dealt(64, 16)[3] == (12, 16)


# ---------------------------------------------------------------------------
# the gathers, and the layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_each_layer_gathers_alone_inside_its_checkpoint(ranks, arch):
    """Nothing is gathered whole for the step: under remat every layer runs
    twice (the forward and the backward's recompute), and in the forward
    finds no other layer's gathered weights alive; in the backward neither
    does an rwkv6 layer, whose checkpoint is one layer (a hybrid group's
    backward keeps its own layers' weights, as its checkpoint spans them)."""
    cfg = _cfg(arch)
    for rank in range(4):
        v = ranks[rank][f"{arch}|views"]
        assert not v["gathered_whole"]
        assert len(v["held"]) == 2 * cfg.n_layers
        forward, backward = v["held"][:cfg.n_layers], v["held"][cfg.n_layers:]
        assert max(forward) == 0, v["held"]
        if arch == "rwkv6-3b":
            assert max(backward) == 0, v["held"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sp_off_runs_gathered_whole_and_matches_one_device(ranks, arch):
    """``sp=False`` keeps the gathered-whole layout: its logits, loss and
    gradients against one device within 2e-5."""
    shape = MESHES[VIEW_MESH]
    want = _oracle(ranks, arch)
    for rank in range(4):
        got = ranks[rank][f"{arch}|whole"]
        r = _rows(shape, rank // shape[1])
        assert _rel_l2(got["logits"], want["logits"][r]) <= TOL
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
        _close_leaves(got["grads"], _blocks(want["grads"], arch, rank, shape),
                      f"{arch} gathered whole, rank {rank}")
        # each layer's input there is the whole residual of the rank's rows
        assert got["inputs"][0].shape == (B // shape[0], SEQ, _cfg(arch).d_model)


def test_layout_predicate():
    desc = MeshDescription((2, 2), ("data", "model"))
    for arch, layout in (("rwkv6-3b", "d-sharded"), ("zamba2-1.2b", "d-sharded"),
                         ("qwen2-7b", "sequence-parallel")):
        model = LM(get_smoke_config(arch), device="meta")
        assert model.layout({"mesh": desc, "sp": True}) == layout
        assert model.layout({"mesh": desc, "sp": False}) == "gathered-whole"
        assert model.layout({}) is None


# ---------------------------------------------------------------------------
# against repro
# ---------------------------------------------------------------------------

@pytest.fixture
def j():
    """``repro``'s side, imported inside the fixture."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import LM as JLM

    return jax, jnp, j_smoke, JLM


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_loss_matches_repro_one_device(ranks, j, arch):
    """The f32 loss on (2, 2), every rank's, against ``repro``'s one-device
    ``LM.loss`` (jitted, ``sp`` off) of the same parameters and batch."""
    jax, jnp, j_smoke, JLM = j
    cfg = _cfg(arch)
    params = jax.tree.map(jnp.asarray, params_to_numpy(_params(cfg)))
    batch = {k: jnp.asarray(v.numpy()) for k, v in _batch(cfg).items()}
    jm = JLM(j_smoke(arch))
    want = float(jax.jit(lambda p, b: jm.loss(p, b, run={"sp": False}))(params, batch))
    for rank in range(4):
        np.testing.assert_allclose(ranks[rank][f"{arch}|2x2"]["loss"], want, rtol=TOL)
