"""Helpers shared by the port's training tests: flattening a parameter tree
by path, and holding parameters after Adam steps against the reference's.

Adam divides each gradient element by its own size (early on an element's
update is about ``lr * g / |g|``), so it turns a gradient element's
*relative* error into an absolute error of up to ``2 * lr`` in its
parameter. The two packages' gradients agree to GRAD_AGREE of each
leaf's largest element (what the gradient tests hold them to), so an
element ``g_i`` of a leaf whose largest is ``G`` carries a relative
error of up to ``rho_i = GRAD_AGREE * G / |g_i|``: nothing for the large
elements, a whole sign for those within float32 noise of zero. Each
parameter element is held to ``tol`` of its leaf's largest value plus
``2 * sum(lr) * min(1, rho_i)`` (``rho_i`` the worst over the steps). With
int8 compression an element whose quantizer input sits within TIE_WINDOW
of a .5 tie, on any rank in any step, may round either way: its
``rho_i`` is 1."""

import contextlib

import numpy as np
import pytest

# the gradient tests' tolerance: each leaf's gradient within this share of
# its largest element
GRAD_AGREE = 1e-5
# a quantizer input within this many quanta of a .5 tie may round either way:
# the gradients' disagreement, GRAD_AGREE of the largest, in quanta of 1/127 of it
TIE_WINDOW = 127 * GRAD_AGREE


def flat(tree, prefix=""):
    """``{"/a/b": leaf}`` of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def leaf_names(tree, prefix=""):
    """The :func:`flat` names of a tree's leaves in ``adamw.leaves`` order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for key in sorted(tree) for n in leaf_names(tree[key], f"{prefix}/{key}")]
    return [prefix]


def _union(trees, fn, combine):
    out = {}
    for tree in trees:
        for name, v in tree.items():
            m = fn(np.abs(np.asarray(v, np.float64)))
            out[name] = combine(out[name], m) if name in out else m
    return out


def grad_noise(grads) -> dict:
    """Per leaf, ``rho_i`` of the flat gradient trees ``grads`` (one a
    step): the worst over the steps of GRAD_AGREE * G / |g_i|. An element
    whose gradient is exactly zero (an embedding row no token looks up)
    has none: Adam leaves it where weight decay puts it in both
    packages."""
    with np.errstate(divide="ignore"):
        return _union(grads, lambda g: np.where(g > 0, GRAD_AGREE * g.max() / g, 0.0), np.maximum)


def near_tie(xs) -> dict:
    """Per leaf, the elements of the flat quantizer inputs ``xs`` (one tree
    a rank and step) within TIE_WINDOW quanta of a .5 tie in any of them;
    the quantum is ``max|x| / 127``, as ``quantize_int8`` takes it."""

    def tie(x):
        t = x / (x.max() / 127.0 + 1e-12)
        return np.abs(t - np.floor(t) - 0.5) < TIE_WINDOW

    return _union(xs, tie, np.logical_or)


def assert_params_match(got, exp, tol, lrs, rho, ties=None):
    """Every element of ``got``'s leaves (torch) within ``tol`` of the
    largest value of ``exp``'s (numpy) plus ``2 * sum(lrs) * min(1,
    rho)`` (``rho`` a leaf name's array of ``grad_noise``; 1 where
    ``ties`` marks the element)."""
    assert_flat_params_match({k: v.detach().numpy() for k, v in flat(got).items()}, flat(exp), tol, lrs, rho, ties)


def assert_flat_params_match(got, exp, tol, lrs, rho, ties=None):
    """:func:`assert_params_match` on flat dicts of numpy arrays."""
    for name, e in exp.items():
        d = np.abs(got[name] - e)
        r = np.minimum(rho[name], 1.0)
        if ties is not None:
            r = np.where(ties[name], 1.0, r)
        bound = tol * np.abs(e).max() + 2 * sum(lrs) * r
        worst = np.unravel_index(np.argmax(d - bound), d.shape)
        assert (d <= bound).all(), (name, int((d > bound).sum()), float(d[worst]), float(bound[worst]))


# ---------------------------------------------------------------------------
# tensor-parallel training: the split step held to the one-rank step
# ---------------------------------------------------------------------------

#: the archs the split step is held on, and what each exercises over a
#: model axis of 2 (reduced widths, float32): Megatron sequence
#: parallelism (the dense and MoE archs, 16 positions); the einsum MoE
#: dispatch with the experts split (capacity E / k: nothing drops, so the
#: split routes as one rank); hymba's context partition (5 / 1 heads: 2
#: divides neither, as it divides neither of the full config's 25 / 5)
#: beside Mamba's channel split
SPLIT_ARCHS = {
    "qwen2.5-32b": {},
    "mixtral-8x22b": {},
    "hymba-1.5b": dict(num_heads=5, num_kv_heads=1, head_dim=16),
}
SPLIT_SEQ, SPLIT_BATCH, SPLIT_STEPS = 16, 4, 2


@pytest.fixture(scope="module", autouse=True)
def on_one_thread():
    """:func:`one_thread` over a whole test module, autouse: a module of
    small-op tests imports it (``from torch_train_common import
    on_one_thread``). Under six xdist workers the default thread pool
    ran such modules 30-130 x slower and starved the other workers."""
    with one_thread():
        yield


@contextlib.contextmanager
def one_thread():
    """Torch on one intra-op thread inside the block: the split runs are
    thousands of small ops, which a pool of threads per xdist worker
    slows by tens of times when the workers share the cores (in a 6-worker
    run the split cases took 161 s with the default pool, 2 s on one
    thread)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def split_cfg(arch: str):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32", **SPLIT_ARCHS.get(arch, {}))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.num_experts
                                                               / cfg.moe.top_k))
    return cfg


def split_tcfg(**kw):
    from repro_torch.configs import TrainConfig

    return TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10, **kw)


def split_batches(cfg, steps: int = SPLIT_STEPS):
    from repro_torch.data import DataConfig, SyntheticLM, make_batch_arrays

    ds = SyntheticLM(DataConfig(cfg.vocab_size, SPLIT_SEQ, SPLIT_BATCH, seed=1))
    return [make_batch_arrays(ds.batch_at(s), device="cpu") for s in range(steps)]


def numpy_state(state):
    """A port ``TrainState`` as numpy leaves (what ``train_state_from_numpy``
    takes, as it takes the reference's)."""
    from repro_torch.optim import adamw
    from repro_torch.train import TrainState

    tree = lambda t: adamw.tree_map(lambda a: a.detach().numpy().copy(), t)  # noqa: E731
    return TrainState(tree(state.params), adamw.AdamWState(state.opt.count.numpy().copy(), tree(state.opt.mu),
                                                           tree(state.opt.nu)), state.step.numpy().copy())


def split_init(arch: str, seed: int = 0):
    """The one-rank initial state of ``arch`` (``split_cfg``), as numpy,
    and its specs."""
    import torch

    from repro_torch.models.model import Model
    from repro_torch.train import init_train_state

    cfg = split_cfg(arch)
    state, specs = init_train_state(Model(cfg, device="cpu"), torch.Generator().manual_seed(seed), split_tcfg())
    return numpy_state(state), specs


def split_run(model, state_np, batches, tcfg, **place):
    """``len(batches)`` steps of ``make_train_step(model, tcfg, model.mesh)``
    from the numpy ``TrainState`` ``state_np`` (``place``: ``mesh=, specs=,
    cfg=`` -- each leaf cut to the rank's block), and before each step
    every leaf's gradient at its parameters. Returns (the gradients, one
    flat numpy dict a step; the metrics, floats a step; the parameters
    after the last step, flat numpy)."""
    import torch

    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step, train_state_from_numpy

    state = train_state_from_numpy(state_np, "cpu", **place)
    step = make_train_step(model, tcfg, model.mesh)
    grads, metrics = [], []
    names = leaf_names(state.params)
    for batch in batches:
        leaves = [p.detach().requires_grad_(True) for p in adamw.leaves(state.params)]
        loss, _ = model.loss(adamw.unflatten(state.params, leaves), batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads.append({n: (torch.zeros_like(p) if g is None else g).numpy() for n, g, p in zip(names, gs, leaves)})
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return grads, metrics, {k: v.detach().numpy().copy() for k, v in flat(state.params).items()}


def assert_split_matches(got, exp, lrs, tol: float = GRAD_AGREE, metric_tol: float = 1e-6):
    """``split_run``'s results ``got`` against ``exp`` (the one-rank run's,
    or its blocks): every leaf's gradient within ``tol`` of that leaf's
    largest entry of ``exp`` -- so none is all zeros where ``exp``'s is not
    -- at every step; the loss and gradient norm within ``metric_tol``
    relative; the parameters after the steps within ``tol`` of the leaf's
    largest value plus Adam's amplification of the gradients' disagreement
    (``assert_flat_params_match``)."""
    (ggot, mgot, pgot), (gexp, mexp, pexp) = got, exp
    for s, (gg, ge) in enumerate(zip(ggot, gexp)):
        for name, e in ge.items():
            top = np.abs(e).max()
            err = np.abs(gg[name] - e).max()
            assert err <= tol * top if top > 0 else err == 0, (s, name, float(err), float(top))
    for s, (a, b) in enumerate(zip(mgot, mexp)):
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= metric_tol * abs(b[k]), (s, k, a[k], b[k])
    assert_flat_params_match(pgot, pexp, tol, lrs, grad_noise(gexp))


def nest(flat_tree: dict) -> dict:
    """The nested dict of a :func:`flat` one."""
    out: dict = {}
    for name, v in flat_tree.items():
        *keys, last = name.strip("/").split("/")
        node = out
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def blocks_of(run, **place):
    """``split_run``'s results with every tree cut to a process-group
    rank's blocks (``place``: ``mesh=, specs=, cfg=``), the metrics as
    they are."""
    from repro_torch.models.model import rank_blocks

    def cut(t):
        return flat(rank_blocks(nest(t), **place))

    grads, metrics, params = run
    return [cut(g) for g in grads], metrics, cut(params)


# ---------------------------------------------------------------------------
# FSDP x TP over a data x model grid: the step held to the reference's
# jit_train_step on a host mesh of the same shape
# ---------------------------------------------------------------------------

#: the archs the placed step is held on over a grid, and what each adds:
#: qwen the dense FSDP x TP layer; mixtral the MoE capacity groups (the
#: stock capacity factor: tokens drop per data group); hymba the meta
#: tokens and Mamba (5 / 1 heads, as SPLIT_ARCHS); deepseek-v3 MLA, MTP
#: and the ring dispatch's aux under a data axis (2 layers: its dense
#: prefix and one MoE layer)
FSDP_ARCHS = {
    "qwen2.5-32b": {},
    "mixtral-8x22b": {},
    "hymba-1.5b": dict(num_heads=5, num_kv_heads=1, head_dim=16, num_layers=2),
    "deepseek-v3-671b": dict(num_layers=2),
}
#: grid shape -> axis names, the meshes the step runs on
FSDP_GRIDS = {(2, 2): ("data", "model"), (4, 1): ("data", "model")}
#: the three-axis grid, held to (2, 2): the same data groups over (pod, data)
POD_GRID = ((2, 1, 2), ("pod", "data", "model"))
FSDP_SEQ, FSDP_BATCH, FSDP_MICRO = 16, 8, 2


def fsdp_cfg(arch: str):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch, reduced=True), dtype="float32", **FSDP_ARCHS[arch])


def fsdp_tcfg():
    from repro_torch.configs import TrainConfig

    return TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10, microbatch=FSDP_MICRO)


def fsdp_batches(cfg):
    """Two numpy batches of FSDP_BATCH x FSDP_SEQ: a plain one, and the
    same with labels -1 in the first half of every position of the rows
    the first of 2 data ranks trains on (in each microbatch): the global
    masked mean counts them on one rank only."""
    from repro_torch.data import DataConfig, SyntheticLM

    plain = {k: np.asarray(v) for k, v in SyntheticLM(DataConfig(cfg.vocab_size, FSDP_SEQ, FSDP_BATCH, seed=1))
             .batch_at(0).items()}
    masked = {k: v.copy() for k, v in plain.items()}
    rows = FSDP_BATCH // FSDP_MICRO
    for m in range(FSDP_MICRO):
        masked["labels"][m * rows:m * rows + rows // 2, : FSDP_SEQ // 2] = -1
    return {"plain": plain, "masked": masked}


def fsdp_init(arch: str):
    """The port's initial state of ``arch`` (``fsdp_cfg``) as numpy, at
    step 1 (the warmup's lr is 0 at step 0), and its specs."""
    import torch

    from repro_torch.models.model import Model
    from repro_torch.train import init_train_state

    state, specs = init_train_state(Model(fsdp_cfg(arch), device="cpu"), torch.Generator().manual_seed(0),
                                    fsdp_tcfg())
    out = numpy_state(state)
    return out._replace(step=np.array(1, np.int32)), specs


#: the reference's side, run in the training tests' one subprocess over 4
#: host devices: for each arch and grid, the placed state's shardings
#: (``state_shardings(mesh, specs, abstract_state)``: every leaf's spec and
#: each device's index of it) and one ``jit_train_step`` from ``fsdp_init``'s state on
#: each of ``fsdp_batches``; the new state's weights and first moments
#: (``mu = (1 - b1) * the clipped gradient``: the moments start at 0) and
#: the metrics
FSDP_REF_CODE = r"""
def _fsdp_oracle():
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as Pspec
    from repro.core.compat import make_mesh
    from repro.configs import TrainConfig as RTrainConfig
    from repro.models import Model as RModel
    from repro.optim import adamw as radamw
    from repro.train import TrainState as RTrainState
    from repro.train.step import jit_train_step, state_shardings
    import torch_train_common as ttc

    def rtcfg():
        t = ttc.fsdp_tcfg()
        return RTrainConfig(learning_rate=t.learning_rate, warmup_steps=t.warmup_steps, total_steps=t.total_steps,
                            microbatch=t.microbatch)

    def rcfg(arch):
        import dataclasses
        from repro.configs import get_config as rget
        return dataclasses.replace(rget(arch, reduced=True), dtype="float32", **ttc.FSDP_ARCHS[arch])

    def index(idx, shape):
        return tuple((s.start or 0, n if s.stop is None else s.stop) for s, n in zip(idx, shape))

    res = {}
    grids = dict(ttc.FSDP_GRIDS)
    grids[ttc.POD_GRID[0]] = ttc.POD_GRID[1]
    for arch in ttc.FSDP_ARCHS:
        state_np, specs = ttc.fsdp_init(arch)
        rstate = RTrainState(state_np.params, radamw.AdamWState(state_np.opt.count, state_np.opt.mu, state_np.opt.nu),
                             state_np.step)
        for grid, names in grids.items():
            mesh = make_mesh(grid, names)
            sh = state_shardings(mesh, specs, rstate)
            coords = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
            res[("specs", arch, grid)] = {name: tuple(s.spec) for name, s in ttc.flat(sh.params).items()}
            res[("blocks", arch, grid)] = {
                name: {coords[d.id]: index(i, np.shape(a)) for d, i in s.devices_indices_map(np.shape(a)).items()}
                for name, (s, a) in ttc.flat(jax.tree.map(lambda s, a: (s, a), sh.params, rstate.params,
                                                          is_leaf=lambda x: isinstance(x, NamedSharding))).items()}
            if grid not in ttc.FSDP_GRIDS:  # the (2, 1, 2) grid's step is held to (2, 2)'s
                continue
            model = RModel(rcfg(arch), mesh)
            step = jit_train_step(model, rtcfg(), mesh, specs)
            for kind, batch in ttc.fsdp_batches(model.cfg).items():
                new, m = step(jax.tree.map(np.array, rstate), batch)
                res[("step", arch, grid, kind)] = (ttc.flat(jax.tree.map(np.asarray, new.params)),
                                                   ttc.flat(jax.tree.map(np.asarray, new.opt.mu)),
                                                   {k: float(v) for k, v in m.items()})
    return res
"""


# ---------------------------------------------------------------------------
# the training tests' one reference subprocess
# ---------------------------------------------------------------------------

#: the compressed DDP step's cell (tests/test_torch_train_ddp.py): the
#: reference's own DDP test's arch (tests/test_elastic.py), 4 host devices
DDP_ARCH = "phi3-medium-14b"
DDP_P = 4
DDP_N_STEPS = 3
DDP_BATCH, DDP_SEQ = 8, 16
DDP_MODES = ("none", "int8")

#: the reference's DDP step (``make_ddp_compressed_step`` under
#: ``shard_map`` on 4 host devices): each step's mean gradient and with
#: int8 each rank's quantizer input, the metrics and the final states
DDP_REF_CODE = r"""
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.core.compat import make_mesh
from repro.configs import TrainConfig, get_config
from repro.data import DataConfig, SyntheticLM
from repro.models import Model
from repro.optim import compress
from repro.train import init_ddp_state, make_ddp_compressed_step


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


mesh = make_mesh((P,), ("data",))
cfg = dataclasses.replace(get_config(ARCH, reduced=True), dtype="float32")
model = Model(cfg)
ds = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=0))
grad = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))
requant = jax.jit(lambda x: jax.tree.map(lambda v: v - compress.dequantize_int8(*compress.quantize_int8(v)), x))
out = {}
for comp in MODES:
    tcfg = TrainConfig(learning_rate=2e-3, warmup_steps=2, total_steps=12, grad_compression=comp)
    state = jax.jit(lambda k: init_ddp_state(model, k, tcfg))(jax.random.PRNGKey(0))
    if comp == MODES[0]:
        out["init"] = jax.tree.map(np.asarray, state)
    step = make_ddp_compressed_step(model, tcfg, mesh)
    err = [state.err] * P
    for s in range(N_STEPS):
        batch = {k: jnp.asarray(v) for k, v in ds.batch_at(s).items()}
        # each rank's gradient of its block, as the shard_map step takes them:
        # their mean, and with int8 each rank's quantizer input g + err
        n = BATCH // P
        gs = [grad(state.params, {k: v[r * n:(r + 1) * n] for k, v in batch.items()}) for r in range(P)]
        out[("grad", comp, s)] = flat(jax.tree.map(lambda *g: sum(g) / P, *gs))
        if comp == "int8":
            xs = [jax.tree.map(jnp.add, g, e) for g, e in zip(gs, err)]
            out[("x", s)] = [flat(x) for x in xs]
            err = [requant(x) for x in xs]
        state, m = step(state, batch)
        out[(comp, s)] = {k: float(v) for k, v in m.items()}
    out[comp] = jax.tree.map(np.asarray, state)
"""


_REFERENCE: dict = {}


def train_reference(tmp_path_factory) -> dict:
    """The reference's side of both training-over-a-mesh test files, from
    one subprocess over 4 host devices a test run: DDP_REF_CODE's
    results, and under ``"fsdp"`` FSDP_REF_CODE's. The first file to ask
    runs it and leaves its results beside the workers' temporary
    directories (under xdist every worker of the run finds them there; a
    lock makes a second worker wait for the first's run instead of
    starting its own)."""
    import fcntl
    import os
    import pickle

    from conftest import run_subprocess

    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    path = (base.parent if run else base) / f"torch_train_reference_{run or 'local'}.pkl"
    if str(path) not in _REFERENCE:
        with open(f"{path}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                part = f"{path}.part"
                head = (f"import sys\nsys.path.insert(0, 'tests')\nOUT = {part!r}\nARCH = {DDP_ARCH!r}\nP = {DDP_P}\n"
                        f"N_STEPS = {DDP_N_STEPS}\nBATCH, SEQ = {DDP_BATCH}, {DDP_SEQ}\nMODES = {DDP_MODES!r}\n")
                tail = ("\nout['fsdp'] = _fsdp_oracle()\nimport pickle\nwith open(OUT, 'wb') as fh:\n"
                        "    pickle.dump(out, fh)\nprint('PASS')\n")
                assert "PASS" in run_subprocess(head + DDP_REF_CODE + FSDP_REF_CODE + tail, devices=DDP_P)
                os.replace(part, path)
        with open(path, "rb") as fh:
            _REFERENCE[str(path)] = pickle.load(fh)
    return _REFERENCE[str(path)]
