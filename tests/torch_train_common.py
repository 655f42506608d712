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
